"""CUDA (PyTorch) batched backend — the port of ``tpu_scheduler/backends/tpu.py``.

Uploads the packed tensors — with the inter-pod constraint tensors and the
topology (gang-locality) tensors when the cluster carries them — runs the
auction (ops/assign.py, with the hand-written choose kernels on the card)
and brings the result home as ONE stacked [5, P] int32 tensor.  Runs on
the card unless the caller asks for the CPU (``device="cpu"``, the plain
torch versions — what the tests use).  There is no fallback: without CUDA
the constructor raises, and a CUDA runtime failure during a cycle raises
:class:`BackendUnavailable` for the caller to handle.

Uploads are cached by host-array identity (``_put``, the JAX backend's
``_dev_cache``): a cycle over an unchanged array reuses its device copy.
Per-cycle state (the constraint domain state, the gang placement counts)
is never cached.  ``UPLOAD_BYTES`` counts the bytes of cache misses, which
also go to the profiler's transfer counter (``utils/profiler.
record_transfer``, the controller's ``scheduler_device_transfer_bytes_total``).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..convert import constraints_to_device, to_device, topology_to_device
from ..errors import BackendUnavailable
from ..models.profiles import SchedulingProfile
from ..ops.assign import assign_cycle, split_device_arrays
from ..ops.choose import KernelError
from ..ops.pack import PackedCluster
from ..utils.profiler import record_transfer
from .base import SchedulingBackend

__all__ = ["CudaBackend", "make_backend", "UPLOAD_BYTES"]

# Host→device bytes of upload-cache misses since the counter was last set
# to 0, over every CudaBackend of the process (a routed cycle uploads from
# several threads and shard backends at once).
UPLOAD_BYTES = 0  # guarded-by: _UPLOAD_LOCK
_UPLOAD_LOCK = threading.Lock()


def _is_device_failure(e: RuntimeError) -> bool:
    """A CUDA runtime failure (launch refused, device fault, out of memory)
    rather than a programming error."""
    accel = getattr(torch, "AcceleratorError", None)
    return (
        isinstance(e, (KernelError, torch.cuda.OutOfMemoryError))
        or (accel is not None and isinstance(e, accel))
        or "CUDA" in str(e)
    )


class CudaBackend(SchedulingBackend):
    name = "cuda"
    supports_topology = True

    def __init__(self, device: str | torch.device | None = None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise BackendUnavailable("cuda backend: torch.cuda.is_available() is False")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"cuda backend: unsupported device {dev}")
        self.device = dev
        # Upload cache, keyed by host-array identity: id(arr) -> (weakref,
        # device tensor, finalizer).  Safe because the packers never mutate
        # an array they have handed out, and no op of the cycle writes into
        # an uploaded tensor (the auction permutes the pod rows into fresh
        # tensors and replaces avail out of place).  A finalizer evicts the
        # entry when its host array dies; the stored weakref tells an entry
        # from a later array that reuses the id.  Most-recently-used order
        # with a cap: hot node tensors outlive churned pod tensors.  Locked:
        # one backend may serve cycles from several threads.  Reentrant: the
        # cyclic garbage collector can run a finalizer (``_evict``) on any
        # allocation, also inside ``_put``'s locked section on the same
        # thread, so every locked section tolerates an entry vanishing.
        self._dev_cache: dict[int, tuple[weakref.ref, torch.Tensor, weakref.finalize]] = {}
        self._dev_cache_cap = 512
        self._put_lock = threading.RLock()
        self._shards: dict[int, CudaBackend] = {}  # device index -> routed-shard backend
        # Fleet mesh-per-replica bindings (parallel/mesh.MeshBinding), keyed
        # by shard id.  Main-thread state: bound and released from the
        # controller's shard-refresh path only.
        self._mesh_bindings: dict[int, object] = {}

    # -- fleet mesh bindings (fleet/) ---------------------------------------

    def bind_shard_mesh(self, shard: int, num_shards: int):
        """Bind one owned shard to this backend's device-slice mesh
        (parallel/mesh.mesh_binding over this backend's device).  Idempotent
        per (shard, K); a resize (new K) rebuilds the binding — the old
        slice geometry is meaningless under the new shard map.  The solve's
        device never changes: a binding describes where the shard's
        tensors live, and this backend has one device."""
        ent = self._mesh_bindings.get(int(shard))
        if ent is not None and ent.num_shards == int(num_shards):
            return ent
        from ..parallel.mesh import mesh_binding

        ent = mesh_binding(int(shard), int(num_shards), devices=[self.device])
        self._mesh_bindings[int(shard)] = ent
        return ent

    def release_shard_mesh(self, shard: int) -> bool:
        """Forget a lost shard's binding (the new owner builds its own)."""
        return self._mesh_bindings.pop(int(shard), None) is not None

    def mesh_bindings_info(self) -> dict:
        """/debug/shards payload: per-shard devices + mesh shape + the
        node-axis layout the slice's tensors follow (parallel/mesh.
        node_sharding; ``devices`` and ``node_sharding`` read as the
        parallel/mesh docstring says)."""
        from ..parallel.mesh import node_sharding

        return {
            str(s): {
                "devices": list(b.device_ids),
                "mesh_shape": [int(b.mesh.shape["dp"]), int(b.mesh.shape["tp"])],
                "dedicated": bool(b.dedicated),
                "node_sharding": str(node_sharding(b)),
            }
            for s, b in sorted(self._mesh_bindings.items())
        }

    def shard_for(self, index: int) -> "CudaBackend":
        """Per-pool shard backend of a routed cycle: round-robin the shards
        over the visible cards so their solves overlap (the JAX backend's
        ``shard_for``).  On one card, or on the CPU, every shard is this
        backend.  Called from the cycle's main thread only."""
        if self.device.type != "cuda" or torch.cuda.device_count() <= 1:
            return self
        idx = index % torch.cuda.device_count()
        if idx == (self.device.index if self.device.index is not None else torch.cuda.current_device()):
            return self
        if idx not in self._shards:
            self._shards[idx] = CudaBackend(device=torch.device("cuda", idx))
        return self._shards[idx]

    def _drop_dev_cache(self) -> None:
        """Forget every cached upload (after a device failure the buffers
        may belong to a dead context)."""
        with self._put_lock:
            for ent in list(self._dev_cache.values()):
                ent[2].detach()
            self._dev_cache.clear()

    def _evict(self, key: int, wr: weakref.ref) -> None:
        with self._put_lock:
            ent = self._dev_cache.get(key)
            if ent is not None and ent[0] is wr:  # only OUR entry: ids are reused
                del self._dev_cache[key]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """The device copy of host array ``arr``, uploaded once per array
        object.  Always a copy, on the CPU too, so a cached tensor never
        keeps its host array alive."""
        global UPLOAD_BYTES
        key = id(arr)
        with self._put_lock:
            ent = self._dev_cache.get(key)
            if ent is not None and ent[0]() is arr:
                del self._dev_cache[key]  # refresh recency
                self._dev_cache[key] = ent
                return ent[1]
        with _UPLOAD_LOCK:
            UPLOAD_BYTES += int(arr.nbytes)
        record_transfer(int(arr.nbytes))
        buf = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)
        wr = weakref.ref(arr)
        fin = weakref.finalize(arr, self._evict, key, wr)
        fin.atexit = False
        with self._put_lock:
            old = self._dev_cache.pop(key, None)  # the fresh entry lands at the MRU end
            if old is not None and old[0] is not wr:
                old[2].detach()
            self._dev_cache[key] = (wr, buf, fin)
            while len(self._dev_cache) > self._dev_cache_cap:
                oldest = next(iter(self._dev_cache))
                if oldest == key:
                    break
                ent = self._dev_cache.pop(oldest, None)
                if ent is not None:
                    ent[2].detach()
        return buf

    def assign(self, packed: PackedCluster, profile: SchedulingProfile):
        try:
            nodes, pods = split_device_arrays(to_device(packed, self.device, put=self._put))
            kw = {}
            cons = packed.constraints
            if cons is not None:
                cpods, cmeta, cstate = constraints_to_device(cons, self.device, put=self._put)
                pods.update(cpods)
                kw.update(
                    cmeta=cmeta, cstate=cstate, soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0,
                    hard_pa=cons.n_pa_terms > 0, spread_fill=cons.spread_fill, fill_bout_above=cons.fill_bout_above,
                )
            if packed.topology is not None:
                tpods, tmeta, tstate = topology_to_device(packed.topology, self.device, put=self._put)
                pods.update(tpods)
                kw.update(tmeta=tmeta, tstate=tstate)
            assigned, rounds, _avail, acc_round, rank_of, cut_off = assign_cycle(
                nodes, pods, profile.weights(), max_rounds=profile.max_rounds, block=profile.pod_block, **kw
            )
            # ONE device→host fetch for the whole result.
            combined = torch.stack(
                [assigned, acc_round, rank_of, torch.full_like(assigned, rounds), cut_off]
            ).cpu().numpy()
        except RuntimeError as e:
            if self.device.type == "cuda" and _is_device_failure(e):
                self._drop_dev_cache()
                raise BackendUnavailable(f"cuda backend runtime failure: {e}") from e
            raise
        return combined[0], int(combined[3, 0]), {"acc_round": combined[1], "rank": combined[2], "cut_off": combined[4]}


def make_backend(name: str, **kw) -> SchedulingBackend:
    """The port's backend factory (the JAX package's factory knows neither
    name): "cuda" (``CudaBackend(device=...)``) or "cuda-sharded"
    (``parallel.sharded.ShardedBackend(mesh=..., tp=...)``)."""
    if name == "cuda":
        return CudaBackend(**kw)
    if name == "cuda-sharded":
        from ..parallel.sharded import ShardedBackend

        return ShardedBackend(**kw)
    raise ValueError(f"unknown backend {name!r} (expected 'cuda' or 'cuda-sharded')")
