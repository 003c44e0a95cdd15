"""The program's own spans (``dfac_tpu_torch.obs.profiling``) inside a traced run's window, laid against its device trace.

The program records spans only while a ``torch.profiler`` session
collects, so a ``--trace 1`` run holds them and a ``--trace 0`` run none.
Their ends lie on the host's real-time clock, as the device trace's
timestamps and the window's do. A program that records no spans (an older
commit) gives every reader here None.
"""

from __future__ import annotations

import heapq

OUTSIDE = "outside"  # the device idle under no program span


def window_spans(run) -> list | None:
    """The program's spans that start and end inside the window, else None."""
    t = run.trace
    if t is None or t.window is None:
        return None
    try:
        from dfac_tpu_torch.obs import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    w0, w1 = t.window
    inside = [s for s in recorded() if w0 <= s.t0_ns and s.t1_ns <= w1]
    return inside or None


def idle_intervals(trace) -> list[tuple[int, int]]:
    """The window's stretches with no device work (ns): the window less the trace's merged intervals."""
    w0, w1 = trace.window
    edges = [w0]
    for a, b in trace.merged():
        edges += [a, b]
    edges.append(w1)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_by_span(idle: list[tuple[int, int]], spans: list[tuple[str, int, int]]) -> dict[str, int]:
    """Each idle nanosecond of ``idle`` (sorted, disjoint) under the innermost
    of ``spans`` (name, start, end) open at that moment, the one that opened
    last (the shorter of two that opened together), or :data:`OUTSIDE`;
    {name: ns}, summing to the idle time."""
    cuts = sorted({t for a, b in idle for t in (a, b)} | {t for _, a, b in spans for t in (a, b)})
    spans = sorted(spans, key=lambda s: s[1])
    heap: list = []
    out: dict[str, int] = {}
    g = k = 0
    for a, b in zip(cuts, cuts[1:]):
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        if g == len(idle) or idle[g][0] > a:
            continue  # the device is busy over [a, b)
        while k < len(spans) and spans[k][1] <= a:
            heapq.heappush(heap, (-spans[k][1], spans[k][2], k))
            k += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        name = spans[heap[0][2]][0] if heap else OUTSIDE
        out[name] = out.get(name, 0) + (b - a)
    return out


def score_idle(run) -> dict[str, int] | None:
    """The window's device idle (ns) by the innermost program span open on the
    thread that opened the ``score`` spans; None without a trace, device
    work or ``score`` spans."""
    spans = window_spans(run)
    t = run.trace
    if not spans or not t.ops:
        return None
    threads = {s.thread for s in spans if s.name == "score"}
    if len(threads) != 1:
        return None
    (thread,) = threads
    return idle_by_span(idle_intervals(t), [(s.name, s.t0_ns, s.t1_ns) for s in spans if s.thread == thread])


def idle_share_under(run, name: str) -> float | None:
    """The window's device idle under span ``name`` (or :data:`OUTSIDE`), % of the window."""
    split = score_idle(run)
    if split is None:
        return None
    w0, w1 = run.trace.window
    return 100.0 * split.get(name, 0) / (w1 - w0)
