"""Background-thread batch prefetch for the ingest pipelines.

Counterpart of :mod:`dfac_tpu.io.prefetch` (pure Python, carried over).
The disk -> scores serving loop alternates host work (row pull, dtype
cast, pinned staging) with device work (async launches of the folded
chain). Run serially, the host stage adds its full latency to every batch;
with a one-thread pipeline the host assembles batch k+1 while the device
scores batch k — the reference gets this from torch DataLoader's worker
processes (reference ``src/predict.py:60-75``, num_workers); here a single
thread suffices because the heavy stages (tensor casts, numpy row copies)
release the GIL.

Used by ``train.evaluate.collect_masked_scores`` (prepare stage).

Observability: pass a :class:`PrefetchStats` to record where the pipeline
waits — ``host_wait_s`` (consumer blocked on the producer: ingest-bound)
vs ``device_wait_s`` (producer blocked on a full queue: device-bound).
The sustained rate of an overlapped pipeline is ``min(host, device)``;
these two counters make which side binds observable without a profiler
trace. While a ``torch.profiler`` session collects, the producer's start
is an ``ingest.start`` span and each consumer wait an ``ingest.wait`` span
(:mod:`dfac_tpu_torch.obs.profiling`), and ``host_wait_s`` adds the wait
span's own length.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, Iterator, TypeVar

from dfac_tpu_torch.obs.profiling import close_span, maybe_open

T = TypeVar("T")

_SENTINEL = object()


@dataclasses.dataclass
class PrefetchStats:
    """Where an overlapped ingest pipeline spent its waiting time.

    ``host_wait_s``: total time the CONSUMER (device feed loop) blocked
    waiting for the producer — large values mean host assembly (disk,
    gather, cast) is the bottleneck. ``device_wait_s``: total time the
    PRODUCER blocked on a full prefetch queue — the healthy state (the
    device is the bottleneck, ingest keeps up). ``items``: batches through
    the pipeline."""

    host_wait_s: float = 0.0
    device_wait_s: float = 0.0
    items: int = 0

    def host_bound(self, min_wait_s: float = 0.5) -> bool:
        """True when the consumer out-waited the producer by 2x and the
        wait is non-trivial — the 'warn: ingest-limited' predicate."""
        return (
            self.host_wait_s > min_wait_s
            and self.host_wait_s > 2.0 * self.device_wait_s
        )


def prefetched(
    it: Iterable[T], depth: int = 2, stats: PrefetchStats | None = None
) -> Iterator[T]:
    """Yield from ``it`` with up to ``depth`` items materialized ahead by
    a background thread. ``depth <= 0`` degrades to plain iteration.
    Exceptions raised by the producer re-raise at the consumer; closing
    the consumer early unblocks and stops the producer. ``stats``
    (optional) accumulates host-wait/device-wait seconds (see
    :class:`PrefetchStats`).
    """
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                t0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stats is not None:
                    # time blocked behind a full queue = the device side
                    # was still busy — ingest is NOT the bottleneck here
                    # (an uncontended put costs microseconds; noise)
                    stats.device_wait_s += time.perf_counter() - t0
                if stop.is_set():
                    return
            item = _SENTINEL
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            item = _Raised(e)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    start = maybe_open("ingest.start")
    t = threading.Thread(target=worker, daemon=True, name="dfac-prefetch")
    t.start()
    close_span(start)
    try:
        while True:
            wait = maybe_open("ingest.wait")
            if wait is not None:  # one clock for the span and the counter
                item = q.get()
                close_span(wait)
                if stats is not None:
                    stats.host_wait_s += wait.ns / 1e9
            elif stats is not None:
                t0 = time.perf_counter()
                item = q.get()
                stats.host_wait_s += time.perf_counter() - t0
            else:
                item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _Raised):
                raise item.exc
            if stats is not None:
                stats.items += 1
            yield item
    finally:
        stop.set()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc
