"""Share of the window the CNN2D leg's consumer waited on host ingest.

``io/prefetch.PrefetchStats.host_wait_s`` of ``predict_scores_fast``'s
calls in the window (the time its device feed blocked on the prefetch
thread's batches; the first upload of each request is never hidden), over
the window's seconds.
"""


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * run.counter("host_wait_s") / run.window_s
