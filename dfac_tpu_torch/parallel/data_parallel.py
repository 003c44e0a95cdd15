"""Data-parallel training: one process per device, BatchNorm and gradients summed across ranks.

Counterpart of :mod:`dfac_tpu.parallel.data_parallel` (the shard_map train
step) and of :func:`dfac_tpu.parallel.mesh.make_mesh`'s checks. The JAX
package runs one program over a ``'data'`` mesh axis; here each device is
a process of its own (a rank of one ``torch.distributed`` process group:
NCCL on the card, gloo on the CPU) and the trainers take a :class:`Ranks`:

* **rows**: rank ``r`` of ``N`` takes the contiguous rows ``[r * b / N,
  (r + 1) * b / N)`` of each global batch of ``b`` rows, as ``P('data')``
  shards it (:meth:`Ranks.rows`); every rank walks the same epoch order;
* **BatchNorm** (:func:`~dfac_tpu_torch.models.common.synced_batch_norm`,
  set on a model by :func:`~dfac_tpu_torch.models.common.set_batchnorm_group`):
  the f32 mean and E[x²] of the rank's rows, summed across ranks by an
  autograd all-reduce (its backward sums the gradient across ranks too)
  and divided by ``N``; var = E[x²] - mean² clamped at 0, and the running
  variance takes the unbiased factor of the global count ``n_local * N``
  (the JAX ``TorchBatchNorm`` under ``axis_name``);
* **the step**: backward on the rank's weighted loss *sum*, one flat
  all-reduce of every gradient with that sum appended
  (:meth:`Ranks.reduce_grads_`), then one division by the global count, so
  each rank holds the gradient of the global-batch mean and runs the same
  optimizer update (the JAX step's psum'd cotangents and ``g / count``).
  Every training batch counts each of its rows once, so the global count
  is the global batch's length and needs no collective;
* **draws**: each rank's dropout and augmentation generator is seeded from
  ``(seed, rank)`` (:func:`rank_seed`), rank 0 keeping ``seed`` (the JAX
  step folds the shard index into its keys);
* **decisions**: evaluation runs on rank 0, which broadcasts the metrics
  the best rule, the plateau scheduler and early stopping read
  (:func:`on_rank_zero`); only rank 0 writes files and prints.

:class:`RankPool` starts the ranks (``spawn`` processes meeting at
``tcp://127.0.0.1:<free port>``, the group created with a timeout so a
hung rank fails the others) and runs functions on all of them;
:func:`launch` is the training CLIs' ``--data-parallel N``.
"""

from __future__ import annotations

import dataclasses
import datetime
import mmap
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0  # a collective that waits longer than this fails its rank
JOIN_TIMEOUT_S = 30.0  # a rank that has not ended this long after its pool closed is terminated


def rank_devices(n: int, device: str) -> list[str]:
    """The device of each of ``n`` ranks for ``--device``: ``cuda:r`` for
    rank ``r`` on the card (JAX's ``jax.devices()[:n]``), refused with
    ``make_mesh``'s message (``dfac_tpu/parallel/mesh.py:33-39``) beyond the
    card count; the CPU for every rank with ``cpu``."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > available:
        raise ValueError(f"mesh {n}x1 needs {n} devices, only {available} available")
    return [f"cuda:{r}" for r in range(n)]


def rank_device(device: str) -> torch.device:
    """This rank's device for ``--device``: the CPU, or the card
    :class:`RankPool` made current for the rank."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout and augmentation generator:
    ``seed`` on rank 0 (a one-rank run draws as the single-device trainer),
    another value of ``np.random.SeedSequence((seed, rank))`` on each
    other rank, so ranks draw pairwise-different masks."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint32)[0])


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a data-parallel group."""

    group: Any
    rank: int
    world: int

    @classmethod
    def of(cls, group=None) -> "Ranks":
        """The ranks of ``group`` (the default process group when None)."""
        if not dist.is_initialized():
            raise RuntimeError("data-parallel training needs a torch.distributed process group "
                               "(dfac_tpu_torch.parallel.launch starts one per device)")
        group = group if group is not None else dist.group.WORLD
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, order: np.ndarray, batch_size: int) -> np.ndarray:
        """This rank's rows of each global batch of ``order``, in order:
        batching the result by ``batch_size // world`` gives this rank's
        share of each batch, the tail's included."""
        k = batch_size // self.world
        n_full = len(order) // batch_size * batch_size
        full = order[:n_full].reshape(-1, self.world, k)[:, self.rank].reshape(-1)
        tail = order[n_full:]
        t = len(tail) // self.world
        return np.concatenate([full, tail[self.rank * t : (self.rank + 1) * t]])

    def reduce_grads_(self, params, local_sum: torch.Tensor, count: float) -> torch.Tensor:
        """Sum every gradient of ``params`` and ``local_sum`` across the
        ranks in one flat all-reduce, divide the gradients by
        ``max(count, 1)`` in place; returns the summed loss."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([*(g.reshape(-1) for g in grads), local_sum.detach().reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat, group=self.group)
        scale = 1.0 / max(count, 1.0)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g)).mul_(scale)
            offset += g.numel()
        return flat[-1]

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (a picklable value)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def on_rank_zero(ranks: Ranks | None, fn: Callable):
    """``fn()``: on one device here; data-parallel, run on rank 0 and its
    value broadcast to every rank (the metrics a fit's decisions read)."""
    if ranks is None:
        return fn()
    return ranks.broadcast(fn() if ranks.is_main else None)


def maybe_ranks(data_parallel: int, group=None) -> Ranks | None:
    """A trainer's :class:`Ranks`: those of ``group`` where one is given
    (a one-rank group runs the data-parallel path too), else of the
    default group for ``data_parallel > 1``, else None. The group's size
    must be ``data_parallel`` (1 where it is 0 or 1)."""
    if group is None and data_parallel <= 1:
        return None
    ranks = Ranks.of(group)
    if ranks.world != max(data_parallel, 1):
        raise ValueError(f"data_parallel={data_parallel} but the process group has {ranks.world} ranks")
    return ranks


# -- the ranks' processes ----------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now, below Linux's
    ephemeral range (32768-60999): a port the OS hands out could be taken by
    another process's outgoing connection in the seconds before the ranks
    listen there."""
    import random

    for port in random.Random().sample(range(20000, 32000), 200):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free TCP port in 20000-31999")


def _rank_main(rank: int, world: int, device: str, backend: str, port: int, timeout_s: float,
               threads: int | None, tasks, results, rendezvous=None) -> None:
    """A rank's process: join the group (its own at ``127.0.0.1:port``, or
    as global rank ``rendezvous.first_rank + rank`` at a multi-host
    coordinator's store), then run each task ``(fn, args)`` it is sent and
    put ``(rank, ok, value or traceback)``; None ends it."""
    if threads:
        torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device).index or 0)
    timeout = datetime.timedelta(seconds=timeout_s)
    if rendezvous is None:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=rendezvous.store(), world_size=rendezvous.world,
                                rank=rendezvous.first_rank + rank, timeout=timeout)
    try:
        while (task := tasks.get()) is not None:
            fn, args = task
            try:
                value = fn(*args)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
            else:
                results.put((rank, True, value))
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank failed: its traceback, or how its process ended."""


class RankPool:
    """``len(devices)`` processes, rank ``r`` on ``devices[r]``, one process
    group (``backend``: NCCL where every device is a card of its own, else
    gloo), each running the functions :meth:`run` sends. A failed rank ends
    the pool: the others are stopped and :meth:`run` raises
    :class:`RankError` with its traceback."""

    def __init__(self, devices: list[str], backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: int | None = None, rendezvous=None):
        """``threads``: each rank's intra-op threads (torch's default when
        None). ``rendezvous`` (a multi-host
        :class:`~dfac_tpu_torch.parallel.multihost.Rendezvous`): the ranks
        join the cluster's group as its global ranks ``first_rank + r``
        instead of a group of their own."""
        import torch.multiprocessing as mp

        if backend is None:
            backend = "nccl" if all(d.startswith("cuda") for d in devices) and len(set(devices)) == len(devices) \
                else "gloo"
        ctx = mp.get_context("spawn")  # CUDA needs a fresh process
        self.world = len(devices)
        # queues with a feeder thread: a task larger than a pipe's buffer does not block the sender on a dead rank
        self._tasks = [ctx.Queue() for _ in devices]
        self._results = ctx.Queue()
        port = free_port()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"dfac-rank{r}",
                        args=(r, self.world, d, backend, port, timeout_s, threads, self._tasks[r], self._results,
                              rendezvous))
            for r, d in enumerate(devices)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, timeout_s: float | None = None) -> list:
        """``fn(*args)`` on every rank (``fn`` importable by name, ``args``
        picklable); the ranks' return values in rank order."""
        if not self._procs:
            raise RankError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))  # the tensors of args go through shared memory, the rest by pickle
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        values: dict[int, Any] = {}
        while len(values) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [(p.name, p.exitcode) for p in self._procs if not p.is_alive()]
                if dead or (deadline is not None and time.monotonic() > deadline):
                    self.close(graceful=False)
                    raise RankError(f"ranks exited {dead}" if dead else f"no result within {timeout_s} s") from None
                continue
            if not ok:
                self.close(graceful=False)
                raise RankError(f"rank {rank} failed:\n{value}")
            values[rank] = value
        return [values[r] for r in range(self.world)]

    def close(self, graceful: bool = True) -> None:
        """End every rank: after its current task where ``graceful``, else at once."""
        if not self._procs:
            return
        if graceful:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            if graceful:
                p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_TIMEOUT_S)
        for q in self._tasks:  # a task no rank read must not hold this process at exit
            q.cancel_join_thread()
            q.close()
        self._procs = []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(graceful=exc[0] is None)


@dataclasses.dataclass
class _Memmap:
    """A memory-mapped array sent to a rank by its file (the rank maps it again)."""

    filename: str
    dtype: str
    shape: tuple
    offset: int

    def open(self) -> np.ndarray:
        return np.memmap(self.filename, dtype=self.dtype, mode="r", shape=self.shape, offset=self.offset)


def share_dataset(ds):
    """``ds`` (an ``ArrayDataset``) as the ranks receive it: features in
    shared memory (one copy for every rank), or a memory-mapped store by its
    file; :func:`local_dataset` turns it back on the rank."""
    f = ds.features
    if isinstance(f, np.memmap) and isinstance(f.base, mmap.mmap):  # a whole mapped file
        shared = _Memmap(f.filename, f.dtype.str, f.shape, f.offset)
    else:
        shared = torch.from_numpy(np.ascontiguousarray(f)).share_memory_()
    return dataclasses.replace(ds, features=shared)


def local_dataset(ds):
    """A dataset of :func:`share_dataset` as numpy features on this rank."""
    f = ds.features
    return dataclasses.replace(ds, features=f.open() if isinstance(f, _Memmap) else f.numpy())


def _with_local_datasets(fn: Callable, *args):
    return fn(*(local_dataset(a) if _is_dataset(a) else a for a in args))


def _is_dataset(a) -> bool:
    from dfac_tpu_torch.data.pipeline import ArrayDataset

    return isinstance(a, ArrayDataset)


def launch(fn: Callable, n: int, device: str, *args):
    """``--data-parallel n``: ``fn(*args)`` on ``n`` ranks (the devices of
    :func:`rank_devices`), rank 0's return value."""
    return launch_on(rank_devices(n, device), fn, *args)


def launch_on(devices: list[str], fn: Callable, *args, backend: str | None = None, rendezvous=None):
    """``fn(*args)`` on a :class:`RankPool` over ``devices``, its first
    rank's return value. Each ``ArrayDataset`` of ``args`` goes to the
    ranks through :func:`share_dataset`. On the CPU each rank takes an
    ``n``-th of torch's intra-op threads."""
    threads = max(1, torch.get_num_threads() // len(devices)) if devices[0] == "cpu" else None
    shared = [share_dataset(a) if _is_dataset(a) else a for a in args]
    with RankPool(devices, backend=backend, threads=threads, rendezvous=rendezvous) as pool:
        return pool.run(_with_local_datasets, fn, *shared)[0]


def main_process() -> bool:
    """True outside a data-parallel group and on its rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0
