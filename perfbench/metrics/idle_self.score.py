"""Share of the scoring window in which the card idled inside a call but under none of its inner spans (``score``'s self time).

What the program's spans do not name: each batch's launches (a span
around them lengthened the idle it would read), the hand-offs from the
prefetch thread to the next launch, the set-up between the spans and the
bookkeeping after the fetch. With ``idle_fold``, ``idle_start``,
``idle_ingest``, ``idle_fetch`` and ``idle_outside`` it sums to
``idle_share.score``. Attribution as ``idle_fold.score``.
"""

from perfbench.lib.program_spans import idle_share_under


def read(run):
    return idle_share_under(run, "score")
