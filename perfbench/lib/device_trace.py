"""The device trace of a measured window (``--trace 1``), from ``torch.profiler``.

The profiler records the card's activity alone (CUDA activity: kernels,
copies and sets through CUPTI, with no record of each host op, which would
cost more to record and to parse than the window lasts at small batches).
Its timestamps are on the host's real-time clock, as the benchmark's own
spans' are (``Record`` keeps both clocks), so the two line up. From them:

* ``window_s``: the window's length;
* ``busy_s``: the union of the device intervals inside it (not their
  summed durations, which count overlap twice);
* ``op_seconds``, ``top_ops``: device time by operation name;
* ``idle_gaps``: the gaps between the merged device intervals, each named
  by the innermost benchmark span open at its middle.
"""

from __future__ import annotations

import bisect
import re


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.ops: list[tuple[str, int, int]] = []  # (name, start ns, end ns): the device's work
        self.spans: list[tuple[str, int, int]] = []  # the benchmark's spans but the window
        self.window: tuple[int, int] | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.__enter__()

    def stop(self, spans) -> None:
        """Stop; keep the device's work, the ``window`` span and the others of ``spans`` (``Record.spans``)."""
        import torch
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        for evt in self.prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA and not evt.is_user_annotation():
                t0 = evt.start_ns()
                self.ops.append((evt.name(), t0, t0 + evt.duration_ns()))
        self.prof = None
        self.ops.sort(key=lambda o: o[1])
        for s in spans:
            if s.name == "window":
                self.window = (s.t0_ns, s.t1_ns)
            else:
                self.spans.append((s.name, s.t0_ns, s.t1_ns))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9 if self.window else 0.0

    def _clipped(self):
        if self.window is None:
            return []
        w0, w1 = self.window
        return [(n, max(t0, w0), min(t1, w1)) for n, t0, t1 in self.ops if t1 > w0 and t0 < w1]

    def merged(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, t0, t1 in self._clipped():
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e9

    def op_seconds(self, pattern: str | None = None) -> tuple[float, int]:
        """(summed device seconds, count) of the operations inside the
        window whose name matches ``pattern`` (a regular expression; None:
        every operation)."""
        rx = re.compile(pattern) if pattern else None
        found = [(t1 - t0) for n, t0, t1 in self._clipped() if rx is None or rx.search(n)]
        return sum(found) / 1e9, len(found)

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for n, t0, t1 in self._clipped():
            by[n] = by.get(n, 0) + (t1 - t0)
        return [[n[:200], s / 1e9] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps with no device work in the window, each named
        by the innermost benchmark span open at its middle, else ``window``."""
        if self.window is None:
            return []
        w0, w1 = self.window
        edges = [w0]
        for a, b in self.merged():
            edges += [a, b]
        edges.append(w1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) // 2
            open_ = [s for s in spans[: bisect.bisect_right(starts, mid)] if s[2] >= mid]
            name = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "window"
            out.append([name, (b - a) / 1e9])
        return out
