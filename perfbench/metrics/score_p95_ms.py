"""The 95th percentile of request latency over every request in the window (host clock).

A request's latency runs from the call into the program to its scores as
host arrays; the percentile interpolates linearly between order statistics.
"""

import numpy as np


def read(run):
    lat = run.record.durations("request")
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
