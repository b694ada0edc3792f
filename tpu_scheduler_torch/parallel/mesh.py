"""Device meshes — the port of ``tpu_scheduler/parallel/mesh.py``'s
single-process part.

A :class:`Mesh` is a [dp, tp] grid of ``torch.device``s:

  dp — data parallelism over the *pods* axis (each row scores a pod shard)
  tp — tensor parallelism over the *nodes* axis (each column owns a node
       slice)

The grid may repeat a device.  ``make_mesh([torch.device("cpu")] * 8)`` is
the counterpart of the JAX package's 8 virtual CPU devices (what the tests
use), and ``make_mesh([torch.device("cuda:0")] * 4, tp=2)`` runs a (2, 2)
mesh of virtual shards on one card.  Multi-host meshes and the fleet's
mesh bindings are not ported yet.
"""

from __future__ import annotations

import torch

from ..errors import BackendUnavailable

__all__ = ["Mesh", "make_mesh", "mesh_shape_for"]


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
