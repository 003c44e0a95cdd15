"""Profiler traces and the program's spans.

* :func:`trace` — a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a GPU is present) that writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard) into
  ``log_dir``, the session's program spans on a track of their own; the
  training CLIs' ``--profile-dir`` wraps their fit in it (counterpart of
  :func:`dfac_tpu.obs.profiling.trace`);
* program spans — named intervals with small integer counts inside the
  scoring and training paths (``score``, ``score.fold``, ``ingest.start``,
  ``ingest.wait``, ``score.fetch``, ``train.epoch``,
  ``train.step``, ``train.fetch``, ``eval``, ``eval.fetch``), kept in a
  bounded in-memory list.

A span records only while a ``torch.profiler`` session collects in the
process: :func:`maybe_open` reads torch's process-wide flag
``torch.autograd.profiler._is_profiler_enabled``, which every thread sees;
torch's own ``torch._C._autograd._profiler_enabled()`` is per thread and
reads False in the prefetch thread. With no profiler a site costs a call
and that one attribute read, and allocates no span::

    sp = maybe_open("score", root=True)
    ...
    close_span(sp, rows=n)  # nothing for None

A span keeps both host clocks: its ends on the real-time clock
(``time.time_ns()``, on which the profiler's CPU and CUDA activity lie)
and its length on the monotonic one (``time.perf_counter_ns()``). Spans
that one thread opens nest; each names its parent and the call it belongs
to (the id of the entry point's span, one per call). A span that an
exception leaves open is not recorded.

The standalone profile of the serving and extraction paths is
:mod:`dfac_tpu_torch.profiling`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

from torch.autograd import profiler as torch_profiler

MAX_SPANS = 1 << 18  # spans kept; the rest are counted in dropped()
SPANS_PID = 1 << 30  # the Chrome trace's process row of the program spans


class Span:
    """One program span; ``counts`` maps a count's name to an int."""

    __slots__ = ("name", "thread", "id", "parent", "call", "t0_ns", "t1_ns", "ns", "counts", "_depth", "_pc0")

    def __init__(self, name: str, parent: Span | None, depth: int):
        self.name = name
        self.thread = threading.get_native_id()
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        self.counts: dict[str, int] = {}
        self._depth = depth
        self.t1_ns = self.ns = 0
        self.t0_ns = time.time_ns()
        self._pc0 = time.perf_counter_ns()


_IDS = itertools.count(1)
_LOCAL = threading.local()
_LOCK = threading.Lock()
_SPANS: list[Span] = []
_dropped = 0


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def open_span(name: str, root: bool = False) -> Span:
    """Open a span on this thread, under the thread's innermost open span.
    ``root`` marks an entry point's span: it starts a new call and the
    thread's nesting afresh. Sites call it through :func:`maybe_open`."""
    stack = _stack()
    if root:
        stack.clear()
    span = Span(name, stack[-1] if stack else None, len(stack))
    stack.append(span)
    return span


def maybe_open(name: str, root: bool = False) -> Span | None:
    """:func:`open_span` while a ``torch.profiler`` session collects, else None."""
    return open_span(name, root) if torch_profiler._is_profiler_enabled else None


def close_span(span: Span | None, **counts: int) -> Span | None:
    """Close ``span`` (and any span opened inside it and left open), add
    ``counts`` to it and keep it, or count it as dropped past
    :data:`MAX_SPANS`; None (a site with no profiler) is left alone."""
    global _dropped
    if span is None:
        return None
    span.ns = time.perf_counter_ns() - span._pc0
    span.t1_ns = time.time_ns()
    span.counts.update(counts)
    del _stack()[span._depth :]
    with _LOCK:
        if len(_SPANS) < MAX_SPANS:
            _SPANS.append(span)
        else:
            _dropped += 1
    return span


def drop_span(span: Span | None) -> None:
    """Close ``span`` without keeping it: the work it was opened for did not happen."""
    if span is not None:
        del _stack()[span._depth :]


def spans() -> list[Span]:
    """The spans kept so far, in the order they closed."""
    with _LOCK:
        return list(_SPANS)


def dropped() -> int:
    """Spans closed past :data:`MAX_SPANS` since the last :func:`clear_spans`."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _LOCK:
        _SPANS.clear()
        _dropped = 0


def chrome_events(kept: list[Span], base_ns: int = 0) -> list[dict]:
    """``kept`` as Chrome trace events on a process row of their own
    (:data:`SPANS_PID`), one thread row per thread, microseconds after
    ``base_ns`` on the real-time clock."""
    events = [{"ph": "M", "name": "process_name", "pid": SPANS_PID, "tid": 0,
               "args": {"name": "dfac_tpu_torch program spans"}}]
    for s in kept:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPANS_PID, "tid": s.thread,
                       "ts": (s.t0_ns - base_ns) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "call": s.call, **s.counts}})
    return events


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is set, and write ``log_dir/trace_<pid>.json`` at its end with the
    session's program spans added; without ``log_dir``, do nothing."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the profiler writes its timestamps after baseTimeNanoseconds where it gives one
    doc["traceEvents"] += chrome_events(spans(), int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
