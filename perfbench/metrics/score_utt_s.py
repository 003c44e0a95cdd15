"""Utterances scored over the whole window, divided by its seconds (host clock).

Counts the rows the requests asked for; the padding of a request's tail
batch does not count.
"""


def read(run):
    rows = run.counter("rows")
    return rows / run.window_s if rows and run.window_s > 0 else None
