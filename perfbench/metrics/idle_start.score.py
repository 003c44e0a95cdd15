"""Share of the scoring window in which the card idled while the scoring thread started the prefetch thread (``ingest.start``).

Each call into ``predict_scores_fast`` starts a thread to prepare its
batches, between the fold and the first wait. Attribution as
``idle_fold.score``.
"""

from perfbench.lib.program_spans import idle_share_under


def read(run):
    return idle_share_under(run, "ingest.start")
