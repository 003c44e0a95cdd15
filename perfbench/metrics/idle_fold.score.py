"""Share of the scoring window in which the card idled under the fold (``score.fold``).

The fold of BatchNorm into the weights and their upload, which
``predict_scores_fast`` repeats at the start of every call, before its first
launch. Each device-idle nanosecond of the window goes to the innermost
program span open on the scoring thread at that moment
(``lib/program_spans.py``); this is the fold's, over the window.
"""

from perfbench.lib.program_spans import idle_share_under


def read(run):
    return idle_share_under(run, "score.fold")
