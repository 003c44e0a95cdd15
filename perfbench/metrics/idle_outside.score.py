"""Share of the scoring window in which the card idled under no program span.

The caller's time between calls into ``predict_scores_fast`` (the
benchmark's request loop, its shard views and bookkeeping). Attribution as
``idle_fold.score``.
"""

from perfbench.lib.program_spans import OUTSIDE, idle_share_under


def read(run):
    return idle_share_under(run, OUTSIDE)
