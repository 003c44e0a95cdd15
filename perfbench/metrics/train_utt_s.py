"""Training utterances over the whole window, divided by its seconds (host clock).

The window is whole epochs, each followed by the dev evaluation, as
``fit``'s epoch loop runs them.
"""


def read(run):
    rows = run.counter("rows")
    return rows / run.window_s if rows and run.window_s > 0 else None
