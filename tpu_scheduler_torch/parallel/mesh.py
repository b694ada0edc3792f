"""Device meshes — the port of ``tpu_scheduler/parallel/mesh.py``'s
single-process part.

A :class:`Mesh` is a [dp, tp] grid of ``torch.device``s:

  dp — data parallelism over the *pods* axis (each row scores a pod shard)
  tp — tensor parallelism over the *nodes* axis (each column owns a node
       slice)

The grid may repeat a device.  ``make_mesh([torch.device("cpu")] * 8)`` is
the counterpart of the JAX package's 8 virtual CPU devices (what the tests
use), and ``make_mesh([torch.device("cuda:0")] * 4, tp=2)`` runs a (2, 2)
mesh of virtual shards on one card.  Multi-host meshes are not ported yet
(ROADMAP Queue 1 item 7).

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

from dataclasses import dataclass

import torch

from ..errors import BackendUnavailable

__all__ = ["Mesh", "make_mesh", "mesh_shape_for", "MeshBinding", "NodeSharding", "mesh_binding", "node_sharding"]


class Mesh:
    """``devices[i][j]`` holds the shard of pod row ``i`` and node column
    ``j``; ``shape`` is ``{"dp": rows, "tp": columns}``."""

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(row) != len(rows[0]) for row in rows):
            raise ValueError("mesh: need a non-empty rectangular [dp][tp] grid of devices")
        self.devices = rows
        self.shape = {"dp": len(rows), "tp": len(rows[0])}

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in row-major order of first use."""
        seen: list[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def mesh_shape_for(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) factorisation: the requested tp (default 2 when it divides
    evenly, else 1) — pods are the long axis, so dp gets the bulk of the
    devices."""
    if tp is None:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n_devices}")
    return n_devices // tp, tp


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A (dp, tp) Mesh over ``devices`` in the given order (default: every
    visible CUDA device).  Without a CUDA device and no explicit list it
    raises BackendUnavailable: it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise BackendUnavailable("make_mesh: torch.cuda.is_available() is False")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp, tp_ = mesh_shape_for(len(devices), tp)
    return Mesh([devices[i * tp_ : (i + 1) * tp_] for i in range(dp)])


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
        mesh=make_mesh(chunk, tp=tp if tp is not None and len(chunk) % tp == 0 else 1),
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
