"""Multi-host execution: the processes of a cluster joined into one process group.

Counterpart of :mod:`dfac_tpu.parallel.multihost`. The JAX package joins
``jax.distributed`` and runs one global program over every host's devices;
here each ``--multihost`` process is one host, and it runs one rank of a
``torch.distributed`` process group per device it owns (one per card of
``torch.cuda.device_count()`` on the card, one with ``--device cpu``):

* **ranks**: process ``p`` of ``P``, owning ``local`` devices, runs the
  global ranks ``p * local + i``; the world is ``P * local`` ranks (JAX's
  data parallelism over every global device). A process with one device is
  its rank itself; more devices go through
  :class:`~dfac_tpu_torch.parallel.data_parallel.RankPool`, its ranks
  joining the same group;
* **rendezvous**: the processes meet at ``--coordinator-address`` through
  a ``TCPStore`` that process 0 hosts. Over it they exchange their local
  counts (every host must own the same number) and their devices'
  identities; the backend is NCCL where every rank has a card of its own,
  else gloo (two processes sharing one card run over gloo);
* **rows**: every process walks the same order; a rank reads only its
  rows ``[r * b / N, (r + 1) * b / N)`` of each global batch of ``b``
  (:func:`local_row_range`), and :func:`gather_rows` puts the ranks'
  results back in corpus order on every rank;
* **roles**: rank 0, in process 0, is the coordinator: it alone prints and
  writes, and reads a checkpoint to resume, which :func:`broadcast_pyobj`
  hands to every rank.

Every collective and the rendezvous wait at most
:data:`~dfac_tpu_torch.parallel.data_parallel.DEFAULT_TIMEOUT_S`, so a
peer that never arrives or dies fails the others.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import socket
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from dfac_tpu_torch.parallel.data_parallel import DEFAULT_TIMEOUT_S, Ranks, launch_on
from dfac_tpu_torch.parallel.data_parallel import main_process as is_coordinator  # rank 0 (or no group) writes

PG_PREFIX = "dfac/pg"  # the process group's keys in the coordinator's store
MISSING_FLAGS = ("--multihost joins a cluster through its coordinator: pass --coordinator-address HOST:PORT "
                 "(process 0 listens there), --num-processes N and --process-id I on every process "
                 "(auto-detection exists only on TPU pods)")
SPAN_MESSAGE = ("in multihost mode the mesh must span every host's chips (e.g. leave --data-parallel at its "
                "global default)")


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """Where a rank finds the coordinator's store, and its place in the group (picklable)."""

    host: str
    port: int
    world: int
    first_rank: int  # the global rank of the process's first local rank

    def store(self) -> dist.Store:
        """A client of the coordinator's store, under the process group's prefix."""
        client = dist.TCPStore(self.host, self.port, is_master=False,
                               timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        return dist.PrefixStore(PG_PREFIX, client)


def local_devices(device: str) -> list[str]:
    """The devices this process's ranks run on: every card (``cuda``), or one CPU rank."""
    if torch.device(device).type == "cpu":
        return ["cpu"]
    from dfac_tpu_torch.device import resolve_device

    resolve_device(device)  # no card: the port's error, never a CPU fallback
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def device_identity(device: str) -> str:
    """What tells two ranks' devices apart across hosts: the host and the
    card's UUID (two processes on one card share it); "cpu" for a CPU rank."""
    if not device.startswith("cuda"):
        return "cpu"
    props = torch.cuda.get_device_properties(torch.device(device))
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device)}"


def backend_for(identities: list[str]) -> str:
    """NCCL where every rank has a card of its own, else gloo (``RankPool``'s rule)."""
    cards = [i for i in identities if i != "cpu"]
    return "nccl" if len(cards) == len(identities) and len(set(cards)) == len(cards) else "gloo"


class Cluster:
    """This process's part of a multi-host run (:func:`initialize`).

    ``local`` lists the devices of its ranks, ``world`` counts every rank,
    ``rendezvous`` is how a rank joins. With one local device the process
    group is created here, and this process is its rank; :meth:`run` runs a
    function on the process's ranks. :meth:`close` ends the group and the
    store."""

    def __init__(self, store: dist.TCPStore, rendezvous: Rendezvous, process_id: int, local: list[str],
                 backend: str):
        self._store = store
        self.rendezvous = rendezvous
        self.process_id = process_id
        self.local = local
        self.backend = backend
        self.world = rendezvous.world
        if len(local) == 1:
            if local[0].startswith("cuda"):
                torch.cuda.set_device(torch.device(local[0]))
            dist.init_process_group(backend, store=dist.PrefixStore(PG_PREFIX, store), world_size=self.world,
                                    rank=rendezvous.first_rank, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))

    @property
    def is_coordinator(self) -> bool:
        """True in process 0, which holds global rank 0: it alone writes."""
        return self.process_id == 0

    def run(self, fn: Callable, *args):
        """``fn(*args)`` on this process's ranks; the first local rank's return value."""
        if len(self.local) == 1:
            return fn(*args)
        return launch_on(self.local, fn, *args, backend=self.backend, rendezvous=self.rendezvous)

    def close(self) -> None:
        if len(self.local) == 1 and dist.is_initialized():
            dist.destroy_process_group()
        self._store = None


def initialize(coordinator_address: str | None, num_processes: int | None, process_id: int | None,
               device: str = "cuda") -> Cluster:
    """Join the cluster as process ``process_id`` of ``num_processes``; the
    counterpart of ``jax.distributed.initialize`` for the CLIs' flags.
    Blocks until every process has arrived (or ``DEFAULT_TIMEOUT_S`` passed)."""
    if coordinator_address is None or num_processes is None or process_id is None:
        raise SystemExit(MISSING_FLAGS)
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--process-id {process_id} is outside 0..{num_processes - 1} (--num-processes "
                         f"{num_processes})")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--coordinator-address {coordinator_address!r}: expected HOST:PORT")
    local = local_devices(device)
    store = dist.TCPStore(host, int(port), is_master=process_id == 0, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    store.set(f"dfac/process/{process_id}", json.dumps([device_identity(d) for d in local]))
    hosts = [json.loads(store.get(f"dfac/process/{p}")) for p in range(num_processes)]
    for p, ids in enumerate(hosts):
        if len(ids) != len(local):
            raise SystemExit(f"process {p} runs {len(ids)} ranks but process {process_id} runs {len(local)}: "
                             "every host must own the same number of devices")
    rendezvous = Rendezvous(host, int(port), num_processes * len(local), process_id * len(local))
    return Cluster(store, rendezvous, process_id, local, backend_for([i for ids in hosts for i in ids]))


def local_row_range(world: int, rank: int, n_rows: int, n_ranks: int = 1) -> tuple[int, int]:
    """``[lo, hi)``: the rows of a global batch of ``n_rows`` that ranks
    ``rank .. rank + n_ranks - 1`` of ``world`` own together (one
    contiguous block: ``n_rows / world`` a rank)."""
    if not 0 <= rank < rank + n_ranks <= world:
        raise ValueError(f"ranks {rank}..{rank + n_ranks - 1} own no devices of a {world}-rank group — "
                         + SPAN_MESSAGE)
    if n_rows % world:
        raise ValueError(f"batch_size must divide over the mesh data axis ({n_rows} rows over {world} ranks)")
    k = n_rows // world
    return rank * k, (rank + n_ranks) * k


def gather_rows(x: torch.Tensor, ranks: Ranks, rows: int | None = None) -> np.ndarray:
    """Every rank's ``x`` in corpus order, as numpy on every rank (an
    all-gather): ``x`` is this rank's rows of one global batch, or with
    ``rows`` its ``rows`` rows of each of several global batches in turn."""
    rows = len(x) if rows is None else rows
    if dist.get_backend(ranks.group) == "gloo":
        x = x.cpu()  # gloo gathers host memory; the result goes to the host anyway
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ranks.world)]
    dist.all_gather(parts, x, group=ranks.group)
    tail = x.shape[1:]
    batches = torch.stack([p.reshape(-1, rows, *tail) for p in parts], dim=1)  # (n_batches, world, rows, ...)
    return batches.reshape(-1, *tail).cpu().numpy()


def broadcast_pyobj(obj: Any) -> Any:
    """The coordinator's ``obj`` (any picklable value) on every rank;
    other ranks' ``obj`` is ignored. Resume uses it: checkpoints live on the
    coordinator's filesystem only."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sync() -> None:
    """A barrier across every rank (e.g. before the coordinator reads a file
    another rank wrote)."""
    if dist.is_initialized():
        dist.barrier()
