"""Share of the scoring window in which the card idled while the scoring thread waited on host ingest (``ingest.wait``).

The consumer's wait for the prefetch thread's next pinned batch, counted
only while the card had nothing to do: the part of
``host_wait_share.score`` (every wait, including those behind queued
launches) that holds the card back. Attribution as ``idle_fold.score``.
"""

from perfbench.lib.program_spans import idle_share_under


def read(run):
    return idle_share_under(run, "ingest.wait")
