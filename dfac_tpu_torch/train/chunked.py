"""Chunked streaming training (corpora larger than the card's memory).

Counterpart of :mod:`dfac_tpu.train.chunked` on one device,
data-parallel and multi-host. All three trainers (``train/loop.py``,
``train/cae_loop.py``, ``train/detector_loop.py``) stream a corpus the
same way:

* **order**: the epoch's row order (the host loop's shuffle, or the
  detector's weighted draw) is cut into chunks of ``G`` batches; the one
  partial tail batch runs at its true size, in f32;
* **gather and compression**: a prefetch thread
  (:func:`dfac_tpu_torch.io.prefetch.prefetched`, ``depth=1``) gathers each
  chunk on the host (:func:`~dfac_tpu_torch.io.fastcast.gather_f32`'s
  rows); ``bf16`` ingest rounds it with ``cast_bf16``, ``int8`` ingest
  quantizes it with ``quant_i8`` (per-(row, feature-dim) scales);
* **upload**: on a CUDA device the thread gathers the chunk's rows
  straight into pinned memory (:class:`PinnedRing`), blocks of rows in
  parallel (:func:`parallel_gather`; ``torch.index_select`` copies a row
  gather on one core), and the consumer copies it with ``non_blocking`` on
  a copy stream, overlapped with the previous chunk's steps; the card holds
  at most two chunks, the corpus never goes up whole;
* **steps**: :func:`chunk_batches` hands the trainer one batch at a time,
  dequantized on the device before the step (``q.float() * scales[...,
  None]``, the JAX package's bits; bf16 ingest: the rounded features in
  f32), so a chunked epoch runs the trainer's own per-batch step on the
  host loop's batches and its generator draws. On the CPU (no upload) a
  chunked f32 epoch is the host-fed epoch bit for bit.

Data-parallel (:mod:`~dfac_tpu_torch.parallel.data_parallel`), each rank
streams only its rows of every batch of the shared order (its
``batch_size / N`` share, the tail's included, with weights of ones of its
share: ``tail_ones``), after :func:`check_dp_tail`. Multi-host
(:mod:`~dfac_tpu_torch.parallel.multihost`) is the same walk: each rank is a
process of some host, so a host gathers, compresses and uploads only its
ranks' rows (``stream_chunks``' multi-host branch), and the tail check
names the mode "multihost ... training".

The JAX package scans each chunk as one program (``lax.scan``); here the
trainer's step is launched per batch, as in its other epochs.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

INGEST_MODES = ("f32", "bf16", "int8")
PINNED_SLOTS = 3  # chunks staged on the host: the one uploading, the one queued, the one being gathered
GATHER_BLOCK = 256  # rows a gathering thread copies at a time (parallel_gather)
_gather_pool: ThreadPoolExecutor | None = None


def check_ingest(ingest: str) -> None:
    if ingest not in INGEST_MODES:
        raise ValueError(f"ingest must be one of {INGEST_MODES}, got {ingest!r}")


def check_config(cfg, ingest_note: str = "") -> None:
    """The JAX trainers' checks of ``resident_chunk_batches``, ``chunk_ingest``
    and ``bn_freeze_after_frac``, with their messages (``ingest_note``: the
    supervised trainer's longer one)."""
    if not (0.0 <= cfg.bn_freeze_after_frac <= 1.0):
        raise ValueError("bn_freeze_after_frac must be in [0, 1]")
    if cfg.resident_chunk_batches < 0:
        raise ValueError("resident_chunk_batches must be >= 0")
    if cfg.resident_chunk_batches and cfg.device_resident:
        raise ValueError(
            "resident_chunk_batches streams the corpus in chunks; it is "
            "the larger-than-HBM alternative to device_resident — set one"
        )
    if cfg.chunk_ingest not in INGEST_MODES:
        raise ValueError(f"chunk_ingest must be one of {INGEST_MODES}")
    if cfg.chunk_ingest != "f32" and not cfg.resident_chunk_batches:
        raise ValueError(
            "chunk_ingest compresses the chunked-streaming upload — it "
            "needs resident_chunk_batches > 0" + ingest_note
        )


def check_dp_tail(n: int, batch_size: int, dp: int, what: str) -> None:
    """Every batch, the epoch's tail included, must divide over the ranks
    (``dfac_tpu/train/chunked.py:23-33``, its message): ``what`` names
    the caller's mode."""
    if dp > 1 and (n % batch_size) % dp != 0:
        raise ValueError(
            f"data-parallel {what} needs every batch (including the "
            f"{n % batch_size}-row tail of the {n}-sample epoch) to divide "
            f"over {dp} shards — pick a batch_size with tail % data_parallel == 0"
        )


def rank_order(order: np.ndarray, batch_size: int, ranks, what: str) -> tuple[np.ndarray, int]:
    """``(rows, batch size)`` a trainer feeds from an epoch's global
    ``order``: ``order`` and ``batch_size`` on one device (``ranks`` None);
    data-parallel, this rank's rows
    (:meth:`~dfac_tpu_torch.parallel.data_parallel.Ranks.rows`) and its
    share of the batch, after :func:`check_dp_tail` (``what`` names the
    mode in its message)."""
    if ranks is None:
        return order, batch_size
    check_dp_tail(len(order), batch_size, ranks.world, what)
    return ranks.rows(order, batch_size), batch_size // ranks.world


def chunk_rows(order: np.ndarray, batch_size: int, chunk_batches: int):
    """``(ci, full rows, g, tail rows)`` over ``order``: chunks of
    ``chunk_batches`` whole batches (``g`` of them; the rows None where the
    last chunk holds only the tail), then the one partial batch's rows (or
    None) with the last chunk."""
    B, G, n = batch_size, chunk_batches, len(order)
    for ci, c0 in enumerate(range(0, n, G * B)):
        rows = order[c0 : c0 + G * B]
        g = len(rows) // B
        tail = rows[g * B :]  # only ever the epoch's final partial batch
        yield ci, (rows[: g * B] if g else None), g, (tail if len(tail) else None)


def parallel_gather(src, idx, out: torch.Tensor) -> torch.Tensor:
    """``out[:] = src[idx]`` (f32, bit for bit :func:`~dfac_tpu_torch.io.fastcast.gather_f32`),
    blocks of :data:`GATHER_BLOCK` rows copied by a pool of
    ``torch.get_num_threads()`` threads (``torch.index_select`` releases
    the GIL). A source of another dtype goes through ``gather_f32``."""
    from dfac_tpu_torch.io.fastcast import _checked_idx, _tensor, gather_f32

    global _gather_pool
    t = _tensor(np.asarray(src) if not isinstance(src, torch.Tensor) else src)
    if t.dtype != torch.float32:
        return out.copy_(gather_f32(src, idx))
    rows = torch.from_numpy(_checked_idx(idx, len(t)))
    if _gather_pool is None:
        _gather_pool = ThreadPoolExecutor(max(1, torch.get_num_threads()), thread_name_prefix="dfac-gather")
    blocks = [(a, min(a + GATHER_BLOCK, len(rows))) for a in range(0, len(rows), GATHER_BLOCK)]
    for f in [_gather_pool.submit(torch.index_select, t, 0, rows[a:b], out=out[a:b]) for a, b in blocks]:
        f.result()
    return out


def host_chunks(
    feats_src,
    row_arrays: Sequence[np.ndarray],
    order: np.ndarray,
    batch_size: int,
    chunk_batches: int,
    ingest: str = "f32",
):
    """The host stage of :func:`stream_chunks`: yield ``(ci, full, tail)``
    CPU tensors over ``order``. ``full`` is ``(*features, *rows)`` with a
    leading ``(g, B)`` (``g <= chunk_batches`` whole batches; None when the
    last chunk holds only the tail): features ``(f32,)``, ``(bf16,)`` or
    ``(q int8, scales f32)`` by ``ingest``; ``tail`` is ``(f32 features,
    *rows)`` of the epoch's one partial batch, or None."""
    from dfac_tpu_torch.io.fastcast import gather_f32

    check_ingest(ingest)
    B = batch_size
    for ci, fr, g, trows in chunk_rows(order, batch_size, chunk_batches):
        full = tail = None
        if fr is not None:
            feats = compress(gather_f32(feats_src, fr), ingest)
            full = (*(a.reshape(g, B, *a.shape[1:]) for a in feats),
                    *(_rows_of(r, fr).reshape(g, B) for r in row_arrays))
        if trows is not None:
            tail = (gather_f32(feats_src, trows), *(_rows_of(r, trows) for r in row_arrays))
        yield ci, full, tail


def compress(f: torch.Tensor, ingest: str) -> tuple[torch.Tensor, ...]:
    """Gathered f32 rows as ``ingest`` sends them: ``(f,)``, ``(bf16,)`` or ``(q, scales)``."""
    from dfac_tpu_torch.io.fastcast import cast_bf16, quant_i8

    if ingest == "int8":
        return quant_i8(f)
    return (cast_bf16(f),) if ingest == "bf16" else (f,)


def _rows_of(r, idx) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(r)[idx]))


def staged_chunks(
    feats_src,
    row_arrays: Sequence[np.ndarray],
    order: np.ndarray,
    batch_size: int,
    chunk_batches: int,
    ring: "PinnedRing",
    ingest: str = "f32",
):
    """:func:`host_chunks`' arrays, bit for bit, written into ``ring``'s
    pinned slots: ``(ci, slot, views, n_full)`` with ``views`` the chunk's
    ``full`` arrays then its ``tail``'s. f32 rows are gathered straight into
    the slot by :func:`parallel_gather`; compressed ingest gathers into a
    reused f32 scratch buffer first."""
    B = batch_size
    for ci, fr, g, trows in chunk_rows(order, batch_size, chunk_batches):
        k = ring.acquire()
        views: list[torch.Tensor] = []

        def put(a: torch.Tensor) -> None:
            views.append(ring.view(k, len(views), a.shape, a.dtype).copy_(a))

        if fr is not None:
            shape = (len(fr), *np.shape(feats_src)[1:])
            if ingest == "f32":
                views.append(parallel_gather(feats_src, fr, ring.view(k, 0, shape, torch.float32)))
            else:
                for a in compress(parallel_gather(feats_src, fr, ring.scratch(shape)), ingest):
                    put(a)
            views = [v.view(g, B, *v.shape[1:]) for v in views]
            for r in row_arrays:
                put(_rows_of(r, fr).reshape(g, B))
        n_full = len(views)
        if trows is not None:
            views.append(parallel_gather(feats_src, trows, ring.view(
                k, len(views), (len(trows), *np.shape(feats_src)[1:]), torch.float32)))
            for r in row_arrays:
                put(_rows_of(r, trows))
        yield ci, k, views, n_full


class PinnedRing:
    """Pinned host buffers for the chunk uploads, reused round robin.

    The gathering thread takes a slot (:meth:`acquire`) and writes a chunk
    into its buffers (:meth:`view`); the consumer enqueues the slot's copies
    to the card, records a CUDA event after them and releases the slot
    (:meth:`upload`). A slot is refilled
    only after its release and after its event completed, so no buffer is
    overwritten while a copy still reads it. A slot's buffers grow to the
    largest chunk they held and are kept across epochs."""

    def __init__(self, slots: int = PINNED_SLOTS, pin: bool = True):
        """``pin=False`` keeps the buffers in pageable memory (a CPU-only build has no pinned memory)."""
        self._pin = pin
        self._bufs: list[list[torch.Tensor]] = [[] for _ in range(slots)]
        self._events: list = [None] * slots
        self._released = [threading.Event() for _ in range(slots)]
        for e in self._released:
            e.set()
        self._next = 0
        self._scratch = torch.empty(0)  # the gathering thread's f32 rows before compression

    def acquire(self) -> int:
        """The next slot, once its last copy has completed (gathering thread)."""
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        self._released[k].wait()
        self._released[k].clear()
        if self._events[k] is not None:
            self._events[k].synchronize()
        return k

    def view(self, k: int, i: int, shape, dtype: torch.dtype) -> torch.Tensor:
        """Slot ``k``'s ``i``-th pinned buffer as ``shape``, grown to fit."""
        bufs, numel = self._bufs[k], int(np.prod(shape))
        while len(bufs) <= i:
            bufs.append(torch.empty(0, dtype=dtype))
        if bufs[i].dtype != dtype or bufs[i].numel() < numel:
            bufs[i] = torch.empty(numel, dtype=dtype, pin_memory=self._pin)
        return bufs[i][:numel].view(shape)

    def scratch(self, shape) -> torch.Tensor:
        """An f32 host buffer of ``shape``, reused from chunk to chunk."""
        numel = int(np.prod(shape))
        if self._scratch.numel() < numel:
            self._scratch = torch.empty(numel, dtype=torch.float32)
        return self._scratch[:numel].view(shape)

    def upload(self, k: int, views: Sequence[torch.Tensor], device: torch.device, stream) -> list[torch.Tensor]:
        """Enqueue slot ``k``'s copies on ``stream``, record its event, release it (consumer)."""
        with torch.cuda.stream(stream):
            out = [v.to(device, non_blocking=True) for v in views]
            event = torch.cuda.Event()
            event.record(stream)
        self._events[k] = event
        self._released[k].set()
        return out

    def release_all(self) -> None:
        """Unblock a gathering thread left waiting by an epoch that ended early."""
        for e in self._released:
            e.set()


def stream_chunks(
    feats_src,
    row_arrays: Sequence[np.ndarray],
    order: np.ndarray,
    batch_size: int,
    chunk_batches: int,
    device: torch.device,
    stats=None,
    ingest: str = "f32",
    ring: PinnedRing | None = None,
):
    """Yield ``(ci, full, tail)`` of :func:`host_chunks` on ``device``.

    The host stage runs in a prefetch thread (``depth=1``; ``stats``, a
    :class:`~dfac_tpu_torch.io.prefetch.PrefetchStats`, records whether the
    epoch waited on it). On a CUDA device that thread writes each chunk
    into ``ring``'s pinned memory (:func:`staged_chunks`; a ring of its own
    when None), and the upload happens here, at the consumer: ``non_blocking`` copies on a copy
    stream that the current stream waits for, each tensor recorded on the
    current stream for the allocator. The caller holds at most the chunk it
    steps through while the next one uploads: two chunks on the card. On
    the CPU the host tensors are yielded as they are."""
    from dfac_tpu_torch.io.prefetch import prefetched

    check_ingest(ingest)
    if device.type != "cuda":
        yield from prefetched(host_chunks(feats_src, row_arrays, order, batch_size, chunk_batches, ingest=ingest),
                              depth=1, stats=stats)
        return
    ring = ring if ring is not None else PinnedRing()
    staged = staged_chunks(feats_src, row_arrays, order, batch_size, chunk_batches, ring, ingest=ingest)
    copy_stream = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    try:
        for ci, k, views, n_full in prefetched(staged, depth=1, stats=stats):
            out = ring.upload(k, views, device, copy_stream)
            compute.wait_stream(copy_stream)
            for t in out:
                t.record_stream(compute)
            yield ci, tuple(out[:n_full]) or None, tuple(out[n_full:]) or None
    finally:
        ring.release_all()


def dequantize(feats: Sequence[torch.Tensor], i: int, ingest: str) -> torch.Tensor:
    """Batch ``i`` of a chunk's feature arrays as f32 on their device:
    ``q.float() * scales[..., None]`` (int8, the JAX package's
    ``q.astype(f32) * scales[..., None]`` bit for bit), the bf16 values in
    f32, or the f32 batch itself."""
    if ingest == "int8":
        q, scales = feats
        return q[i].float() * scales[i][..., None]
    return feats[0][i].float() if ingest == "bf16" else feats[0][i]


def chunk_batches(chunks, ingest: str = "f32"):
    """``(features f32, *rows)`` per batch of :func:`stream_chunks`'
    chunks, in order: each full chunk's batches (dequantized one at a
    time, just before its step), then the tail."""
    n_feat = 2 if ingest == "int8" else 1
    for _ci, full, tail in chunks:
        if full is not None:
            feats, rows = full[:n_feat], full[n_feat:]
            for i in range(feats[0].shape[0]):
                yield (dequantize(feats, i, ingest), *(r[i] for r in rows))
        if tail is not None:
            yield tail


class ChunkFeed:
    """A trainer's chunked feed: :func:`chunk_batches` of
    :func:`stream_chunks` with ``cfg``'s batch size,
    ``resident_chunk_batches`` and ``chunk_ingest`` on ``device``. It keeps
    the pinned ring across epochs, the last epoch's
    :class:`~dfac_tpu_torch.io.prefetch.PrefetchStats` (:attr:`stats`), and
    logs the JAX package's warning (``dfac_tpu/train/loop.py:876-888``) to
    ``logger_name``'s logger the first time an epoch waited on the host's
    chunk gathers (:meth:`~dfac_tpu_torch.io.prefetch.PrefetchStats.host_bound`)."""

    def __init__(self, cfg, device: torch.device, logger_name: str, ranks=None):
        """``ranks``: a data-parallel trainer's; its batches are the rank's share of each global batch."""
        self.batch_size = cfg.batch_size // (ranks.world if ranks is not None else 1)
        self.chunk_batches, self.ingest = cfg.resident_chunk_batches, cfg.chunk_ingest
        self.device = device
        self.ring = PinnedRing()  # its buffers are allocated by the first chunk
        self.stats = None
        self._log = logging.getLogger(logger_name)
        self._warned = False

    def batches(self, feats_src, row_arrays: Sequence[np.ndarray], order: np.ndarray):
        """The epoch's ``(features f32, *rows)`` batches over ``order`` (a
        data-parallel rank's: its rows of the global order)."""
        from dfac_tpu_torch.io.prefetch import PrefetchStats

        self.stats = PrefetchStats()
        chunks = stream_chunks(feats_src, row_arrays, order, self.batch_size, self.chunk_batches, self.device,
                               stats=self.stats, ingest=self.ingest, ring=self.ring)
        yield from chunk_batches(chunks, self.ingest)
        if self.stats.host_bound() and not self._warned:
            self._log.warning(
                "chunked training is ingest-bound: the device waited %.1fs on host chunk gathers (vs %.1fs "
                "gather-behind-steps). Raise torch's intra-op threads (OMP_NUM_THREADS), store the corpus as "
                "memory-mapped .npy (python -m dfac_tpu_torch.cli.data_tools convert-to-npy), compress the upload "
                "with --chunk-ingest bf16|int8, or grow --resident-chunk-batches.",
                self.stats.host_wait_s, self.stats.device_wait_s,
            )
            self._warned = True
