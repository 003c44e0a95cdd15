"""Profiler traces and the throughput meter.

Counterpart of :mod:`dfac_tpu.obs.profiling`:

* :func:`trace` — a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a GPU is present) that writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard) into
  ``log_dir``; the training CLIs' ``--profile-dir`` wraps their fit in it;
* :class:`ThroughputMeter` — rolling utterances/sec, total and windowed.

The standalone profile of the serving and extraction paths is
:mod:`dfac_tpu_torch.profiling`.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is set, and write ``log_dir/trace_<pid>.json`` at its end; without
    ``log_dir``, do nothing."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class ThroughputMeter:
    """Rolling utterances/sec with total + windowed views."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []  # (t, n_utts)
        self._t0 = time.perf_counter()
        self._total = 0

    def update(self, n_utts: int) -> None:
        now = time.perf_counter()
        self._total += n_utts
        self._events.append((now, n_utts))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def total_utt_s(self) -> float:
        elapsed = time.perf_counter() - self._t0
        return self._total / elapsed if elapsed > 0 else 0.0

    @property
    def window_utt_s(self) -> float:
        if len(self._events) < 2:
            return self.total_utt_s
        span = self._events[-1][0] - self._events[0][0]
        n = sum(e[1] for e in self._events[1:])
        return n / span if span > 0 else 0.0
