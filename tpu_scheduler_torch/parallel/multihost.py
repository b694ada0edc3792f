"""Multi-process execution of the sharded scheduling cycle — the port of
``tpu_scheduler/parallel/multihost.py`` over ``torch.distributed``.

Every process runs the single-process cycle's body
(``parallel/sharded.sharded_rounds``) over its own dp rows of a
process-major mesh (``parallel/mesh.make_mesh`` after
``mesh.init_distributed``): it uploads only its rows' pod slices and its
node columns, runs the choose, the in-process tp merge, the accept and the
commit for its shards, and keeps the constraint engine replicated once per
distinct device.  Three values cross processes, the JAX collectives of
``tpu_scheduler/parallel/sharded.py:279-346``:

  1. the dp claim gather — each process's rows' claims, one
     ``[rows × p_local, 1 + R]`` int32 buffer (claimed node, request), go
     through ``all_gather`` and concatenate in rank order, which is global
     priority order because each rank owns a contiguous block of dp rows;
  2. the round's stop decision — the active count and the accepted count in
     one ``all_reduce``, so every process reads the same ``go`` and stall
     rule and takes the same number of rounds (local values would
     deadlock);
  3. the final re-replication of ``assigned`` (``process_allgather``).

On gloo with CUDA tensors each of them goes through host memory (gloo's
``all_gather`` takes CPU tensors only): the sent rows through a pinned
buffer kept for the cycle, the gathered ones back to the device; on NCCL
the CUDA tensors go as they are.  Every process must call
:func:`sharded_assign_multihost` with the same arrays (each packs the same
snapshot — packing is deterministic), as every host of a TPU pod slice
feeds the same program.

``COLLECTIVES``, ``COLLECTIVE_SECONDS`` and ``COLLECTIVE_BYTES`` count the
exchanges since they were last set to 0: calls, host-clock seconds inside
them (staging included) and bytes this process sent.
"""

from __future__ import annotations

import time

import torch

from .mesh import Mesh, distributed_runtime
from .sharded import pad_node_axis, sharded_rounds

__all__ = ["sharded_assign_multihost", "ProcessExchange", "COLLECTIVES", "COLLECTIVE_SECONDS", "COLLECTIVE_BYTES"]

COLLECTIVES = 0
COLLECTIVE_SECONDS = 0.0
COLLECTIVE_BYTES = 0


class ProcessExchange:
    """The cycle's cross-row exchange over a process group:
    ``parallel/sharded.InProcessExchange``'s two methods as collectives.
    ``stage``: copy CUDA tensors through pinned host buffers (gloo)."""

    def __init__(self, group, world: int, stage: bool):
        self.group = group
        self.world = world
        self.stage = stage
        self._pinned: dict = {}

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape, kept for the cycle."""
        key = (slot, tuple(t.shape), t.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf = self._pinned[key]
        buf.copy_(t)
        return buf

    def gather_rows(self, parts: list, home: torch.device) -> torch.Tensor:
        """Every process's rows, concatenated in rank order on ``home``."""
        global COLLECTIVES, COLLECTIVE_SECONDS, COLLECTIVE_BYTES
        import torch.distributed as dist

        t0 = time.perf_counter()
        local = torch.cat([t.to(home) for t in parts])
        send = self._host(local, "send") if self.stage else local
        outs = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(outs, send, group=self.group)
        out = torch.cat(outs).to(home)
        COLLECTIVES += 1
        COLLECTIVE_BYTES += local.numel() * local.element_size()
        COLLECTIVE_SECONDS += time.perf_counter() - t0
        return out

    def reduce_sum(self, counts: torch.Tensor) -> list:
        """The element-wise sum over every process, on the host."""
        global COLLECTIVES, COLLECTIVE_SECONDS, COLLECTIVE_BYTES
        import torch.distributed as dist

        t0 = time.perf_counter()
        t = counts.cpu() if self.stage else counts.clone()
        dist.all_reduce(t, group=self.group)
        out = t.tolist()
        COLLECTIVES += 1
        COLLECTIVE_BYTES += t.numel() * t.element_size()
        COLLECTIVE_SECONDS += time.perf_counter() - t0
        return out


def sharded_assign_multihost(
    mesh: Mesh, arrays: dict, weights, max_rounds: int = 32, constraints: dict | None = None,
    soft_spread: bool = False, soft_pa: bool = False, hard_pa: bool = True,
):
    """Run one scheduling cycle over a multi-process mesh.

    ``arrays`` is the PackedCluster ``device_arrays()`` dict (NumPy, the
    same in every process); ``constraints`` the
    ``sharded.constraint_operands`` dict (node axes already padded to this
    mesh's tp multiple) for constrained cycles — replicated, exactly as in
    the single-process path.  Node padding to the tp multiple and the
    stable priority permutation come first, the pod padding to the global
    dp multiple after them.  Returns (assigned [P] np.int32, rounds), the
    same in every process."""
    import torch.distributed as dist

    runtime = distributed_runtime()
    if runtime is None or not dist.is_initialized():
        raise RuntimeError("sharded_assign_multihost: no multi-process runtime (mesh.init_distributed)")
    if mesh.process_count != runtime.world or mesh.process_index != runtime.rank:
        raise ValueError(
            f"sharded_assign_multihost: the mesh is process {mesh.process_index} of {mesh.process_count}, the "
            f"runtime rank {runtime.rank} of {runtime.world}: build the mesh after init_distributed"
        )
    a = pad_node_axis(arrays, mesh.shape["tp"])
    stage = runtime.backend == "gloo" and any(d.type == "cuda" for d in mesh.distinct_devices())
    exchange = ProcessExchange(runtime.group, runtime.world, stage)
    assigned, rounds, _shards = sharded_rounds(
        mesh, a, weights, max_rounds, constraints, soft_spread, soft_pa, hard_pa, exchange
    )
    return assigned.numpy(), rounds
