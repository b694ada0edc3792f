"""Device meshes — the port of ``tpu_scheduler/parallel/mesh.py``.

A :class:`Mesh` is a [dp, tp] grid of ``torch.device``s:

  dp — data parallelism over the *pods* axis (each row scores a pod shard)
  tp — tensor parallelism over the *nodes* axis (each column owns a node
       slice)

The grid may repeat a device.  ``make_mesh([torch.device("cpu")] * 8)`` is
the counterpart of the JAX package's 8 virtual CPU devices (what the tests
use), and ``make_mesh([torch.device("cuda:0")] * 4, tp=2)`` runs a (2, 2)
mesh of virtual shards on one card.

Multi-process meshes extend the same grid over ``torch.distributed`` via
:func:`init_distributed`: afterwards :func:`make_mesh` lays the global mesh
out **process-major**.  Every rank holds the same number of local devices;
each tp row stays inside one process (the chatty axis: the per-round tp
merge is in-process), and rank ``r`` owns the contiguous block of dp rows
``[r * rows, (r + 1) * rows)``, so the per-round claim gather over dp
concatenates in rank order, which is global priority order
(``parallel/multihost.py``).  A :class:`Mesh` holds only this process's
rows; ``shape["dp"]`` counts every rank's.

The process-group backend follows one rule: ``nccl`` when every rank has
CUDA devices of its own, ``gloo`` for CPU meshes and for ranks that share a
card (NCCL does not put two ranks on one device).

The fleet's mesh-per-replica unit (:class:`MeshBinding`, :func:`mesh_binding`,
:func:`node_sharding`) binds one owned shard to its contiguous slice of the
device list, as in the JAX package.  Two fields of the ``/debug/shards``
``mesh_bindings`` block therefore read differently from the JAX package's:
``devices`` lists ``torch.device`` strings (``"cuda:0"``, ``"cpu"``; a torch
CPU device has no index, where JAX reports its CPU device ids), and
``node_sharding`` is :class:`NodeSharding`'s plain description of the layout
(the node axis split over the binding's ``tp`` column) where JAX prints a
``NamedSharding``.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from dataclasses import dataclass

import torch

from ..errors import BackendUnavailable

__all__ = [
    "Mesh",
    "make_mesh",
    "process_mesh",
    "mesh_shape_for",
    "init_distributed",
    "distributed_config",
    "distributed_runtime",
    "choose_backend",
    "DistributedRuntime",
    "MeshBinding",
    "NodeSharding",
    "mesh_binding",
    "node_sharding",
]

logger = logging.getLogger("tpu_scheduler_torch.parallel")


class Mesh:
    """``devices[i][j]`` holds the shard of this process's pod row ``i`` and
    node column ``j``; ``shape`` is ``{"dp": rows of every process, "tp":
    columns}``.  A multi-process mesh (``process_count`` > 1) is
    process-major: this process's rows are the global dp rows from
    ``row_offset`` on."""

    def __init__(self, devices, process_index: int = 0, process_count: int = 1):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(row) != len(rows[0]) for row in rows):
            raise ValueError("mesh: need a non-empty rectangular [dp][tp] grid of devices")
        if not 0 <= process_index < process_count:
            raise ValueError(f"mesh: process {process_index} of {process_count}")
        self.devices = rows
        self.process_index = process_index
        self.process_count = process_count
        self.row_offset = process_index * len(rows)
        self.shape = {"dp": len(rows) * process_count, "tp": len(rows[0])}

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in row-major order of first use."""
        seen: list[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen

    def __repr__(self) -> str:
        procs = f", process={self.process_index}/{self.process_count}" if self.process_count > 1 else ""
        return f"Mesh(shape={self.shape}, devices={self.devices}{procs})"


@dataclass(frozen=True)
class DistributedRuntime:
    """What :func:`init_distributed` set up: this process's rank and the
    world size, the backend of the cycle's collectives and their process
    group (None: the default group), and the local devices
    ``local_device_ids`` named (None: every visible CUDA device)."""

    rank: int
    world: int
    backend: str
    group: object
    local_devices: tuple | None


_RUNTIME: DistributedRuntime | None = None


def distributed_runtime() -> DistributedRuntime | None:
    """The multi-process runtime of this process, or None when
    :func:`init_distributed` did not start one with more than one rank."""
    return _RUNTIME


def distributed_config(coordinator_address=None, num_processes=None, process_id=None) -> tuple:
    """(coordinator, process count, process id): the arguments, else the
    ``SCHED_COORDINATOR`` / ``SCHED_NUM_PROCESSES`` / ``SCHED_PROCESS_ID``
    environment, else (None, 1, 0)."""
    coordinator_address = coordinator_address or os.environ.get("SCHED_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SCHED_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("SCHED_PROCESS_ID", "0"))
    return coordinator_address, num_processes, process_id


def _device_identity(d: torch.device) -> str:
    """A card's identity across processes (its UUID), or "cpu"."""
    if d.type != "cuda":
        return d.type
    props = torch.cuda.get_device_properties(d.index if d.index is not None else torch.cuda.current_device())
    return str(getattr(props, "uuid", d))


def choose_backend(identities: list, requested: str | None = None) -> tuple[str, str]:
    """(backend, reason) for the cycle's collectives.  ``identities[r]`` is
    rank ``r``'s (host, [device identity, ...]).  The rule: ``nccl`` when
    every rank has CUDA devices and no card serves two ranks, else
    ``gloo``.  A requested backend the rule cannot hold raises ValueError."""
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"init_distributed: unknown backend {requested!r} (gloo or nccl)")
    owners: dict = {}
    for rank, (host, ids) in enumerate(identities):
        for i in set(ids):
            owners.setdefault((host, i), set()).add(rank)
    if not all(ids and all(i != "cpu" for i in ids) for _, ids in identities):
        backend, reason = "gloo", "a rank has no CUDA devices of its own (a CPU mesh)"
    elif any(len(ranks) > 1 for ranks in owners.values()):
        backend, reason = "gloo", "ranks share a card"
    else:
        backend, reason = "nccl", "every rank has CUDA devices of its own"
    if requested is None or requested == backend:
        return backend, reason
    if requested == "gloo":
        return "gloo", "requested"
    raise ValueError(f"init_distributed: backend {requested!r} cannot hold: {reason}")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    auto: bool = False,
    backend: str | None = None,
    timeout: float = 300.0,
) -> bool:
    """Start ``torch.distributed`` for multi-process meshes.

    Arguments default from the ``SCHED_COORDINATOR`` /
    ``SCHED_NUM_PROCESSES`` / ``SCHED_PROCESS_ID`` environment
    (``init_method="tcp://<coordinator>"``).  With ``auto=True`` and no such
    configuration it uses ``init_method="env://"``: torch's own cluster
    launch (torchrun's ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).
    ``local_device_ids`` names this process's devices: CUDA ordinals or
    devices (``[torch.device("cpu")] * 4``); default every visible CUDA
    device.  ``backend`` (None: the rule of :func:`choose_backend`, logged)
    and ``timeout`` (seconds; every collective of the group fails after it,
    so a rank whose peer died ends instead of hanging).  Returns True when
    a runtime of more than one process is up, False for the
    single-process no-op — callers can invoke it unconditionally."""
    global _RUNTIME
    import torch.distributed as dist

    coordinator_address, num_processes, process_id = distributed_config(
        coordinator_address, num_processes, process_id
    )
    wait = datetime.timedelta(seconds=timeout)
    if num_processes > 1 and coordinator_address is not None:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
            timeout=wait,
        )
    elif auto:
        dist.init_process_group("gloo", init_method="env://", timeout=wait)
    else:
        return False
    rank, world = dist.get_rank(), dist.get_world_size()
    if world == 1:
        return False
    local = None
    if local_device_ids is not None:
        local = tuple(torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in local_device_ids)
    visible = local or (
        tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())) if torch.cuda.is_available() else ()
    )
    identities: list = [None] * world
    dist.all_gather_object(identities, (socket.gethostname(), [_device_identity(d) for d in visible]))
    try:
        chosen, reason = choose_backend(identities, backend)
    except ValueError:
        dist.destroy_process_group()
        raise
    group = None
    if chosen == "nccl":
        torch.cuda.set_device(visible[0])
        group = dist.new_group(backend="nccl")
    logger.info("init_distributed: rank %d of %d, collectives on %s (%s)", rank, world, chosen, reason)
    _RUNTIME = DistributedRuntime(rank=rank, world=world, backend=chosen, group=group, local_devices=local)
    return True


def mesh_shape_for(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) factorisation: the requested tp (default 2 when it divides
    evenly, else 1) — pods are the long axis, so dp gets the bulk of the
    devices."""
    if tp is None:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n_devices}")
    return n_devices // tp, tp


def _grid(devices: list, tp: int | None) -> list:
    dp, tp_ = mesh_shape_for(len(devices), tp)
    return [devices[i * tp_ : (i + 1) * tp_] for i in range(dp)]


def process_mesh(devices, tp: int | None, process_index: int, process_count: int) -> Mesh:
    """The process-major mesh of one rank: ``devices`` are this rank's (every
    rank holds as many), tp rows of them in order.  A tp row that would
    cross ranks raises ValueError."""
    devices = [torch.device(d) for d in devices]
    if tp is not None and (tp > len(devices) or len(devices) % tp):
        raise ValueError(
            f"make_mesh: a tp row of {tp} would cross ranks: each rank holds {len(devices)} devices"
        )
    return Mesh(_grid(devices, tp), process_index, process_count)


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A (dp, tp) Mesh over ``devices`` in the given order (default: the
    devices :func:`init_distributed` named, else every visible CUDA device).
    After :func:`init_distributed` the devices are this rank's and the mesh
    is process-major (:func:`process_mesh`).  Without a CUDA device and no
    explicit list it raises BackendUnavailable: it never falls back to the
    CPU."""
    if devices is None and _RUNTIME is not None and _RUNTIME.local_devices is not None:
        devices = _RUNTIME.local_devices
    if devices is None:
        if not torch.cuda.is_available():
            raise BackendUnavailable("make_mesh: torch.cuda.is_available() is False")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if _RUNTIME is not None:
        return process_mesh(devices, tp, _RUNTIME.rank, _RUNTIME.world)
    return Mesh(_grid([torch.device(d) for d in devices], tp))


@dataclass(frozen=True)
class MeshBinding:
    """One shard bound to one replica's device mesh (the fleet layer's
    mesh-per-replica unit): the shard id, the (dp, tp) Mesh over the
    shard's device slice, and the devices for the /debug/shards view."""

    shard: int
    num_shards: int
    mesh: Mesh
    device_ids: tuple
    dedicated: bool  # False = fewer devices than shards; the slice is the whole set


def _device_order(d: torch.device) -> tuple:
    return (d.type, -1 if d.index is None else d.index)


def mesh_binding(shard: int, num_shards: int, devices=None, tp: int | None = None) -> MeshBinding:
    """Bind one shard to its contiguous slice of the device list.

    Devices sort by (type, index) and split into ``num_shards`` contiguous
    chunks; shard *i* gets chunk *i*, so peer shards' solves run on disjoint
    cards and a takeover rebinds the absorbed shard onto the survivor's own
    chunk.  With fewer devices than shards (one H100 with K = 4, the CPU
    tests) every shard binds the WHOLE device set — correct, just not
    parallel across replicas.  Without a list it takes every visible CUDA
    device, and raises BackendUnavailable when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise BackendUnavailable("mesh_binding: torch.cuda.is_available() is False")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = sorted((torch.device(d) for d in devices), key=_device_order)
    n = len(devices)
    per = n // int(num_shards)
    if per < 1:
        chunk = devices
        dedicated = False
    else:
        lo = int(shard) * per
        # The last shard absorbs the remainder chunk.
        hi = n if int(shard) == int(num_shards) - 1 else lo + per
        chunk = devices[lo:hi]
        dedicated = True
    return MeshBinding(
        shard=int(shard),
        num_shards=int(num_shards),
        mesh=Mesh(_grid(chunk, tp if tp is not None and len(chunk) % tp == 0 else 1)),
        device_ids=tuple(str(d) for d in chunk),
        dedicated=dedicated,
    )


@dataclass(frozen=True)
class NodeSharding:
    """The layout of a shard's [..., N] node operands: the node axis split
    into ``tp`` contiguous column blocks, block ``j`` on the binding's
    column-``j`` devices (the port's counterpart of JAX's
    ``NamedSharding(mesh, P("tp"))``)."""

    mesh_shape: tuple
    axis: str
    devices: tuple

    def __str__(self) -> str:
        return f"NodeSharding(mesh_shape={self.mesh_shape}, axis={self.axis!r}, devices={self.devices})"


def node_sharding(binding: MeshBinding) -> NodeSharding:
    """The node-axis layout over the binding's ``tp`` mesh column."""
    mesh = binding.mesh
    return NodeSharding(
        mesh_shape=(mesh.shape["dp"], mesh.shape["tp"]),
        axis="tp",
        devices=tuple(tuple(str(d) for d in row) for row in mesh.devices),
    )
