"""Share of the training window in which no kernel, copy or set ran on the device.

1 - (the union of the device intervals inside the window) / (the window),
both from ``torch.profiler``'s trace of the window.
"""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
