"""Share of the scoring window in which the card idled under the final fetch (``score.fetch``).

The concatenation of a call's device scores, their copy to the host and
the pad rows dropped, after the last launch. Attribution as
``idle_fold.score``.
"""

from perfbench.lib.program_spans import idle_share_under


def read(run):
    return idle_share_under(run, "score.fetch")
