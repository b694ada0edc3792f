"""CUDA (PyTorch) batched backend — the port of ``tpu_scheduler/backends/tpu.py``.

Uploads the packed tensors — with the inter-pod constraint tensors and the
topology (gang-locality) tensors when the cluster carries them — runs the
auction (ops/assign.py, with the hand-written choose kernels on the card)
and brings the result home as ONE stacked [4, P] int32 tensor.  Runs on
the card unless the caller asks for the CPU (``device="cpu"``, the plain
torch versions — what the tests use).  There is no fallback: without CUDA
the constructor raises, and a CUDA runtime failure during a cycle raises
:class:`BackendUnavailable` for the caller to handle.

Uploads are cached by host-array identity (``_put``, the JAX backend's
``_dev_cache``): a cycle over an unchanged array reuses its device copy.
Per-cycle state (the constraint domain state, the gang placement counts)
is never cached.  ``UPLOAD_BYTES`` counts the bytes of cache misses.
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
from .base import SchedulingBackend

__all__ = ["CudaBackend", "make_backend", "UPLOAD_BYTES"]

# Host→device bytes of upload-cache misses since the counter was last set
# to 0 (the JAX backend records the same through record_transfer).
UPLOAD_BYTES = 0


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
        # one backend may serve cycles from several threads.
        self._dev_cache: dict[int, tuple[weakref.ref, torch.Tensor, weakref.finalize]] = {}
        self._dev_cache_cap = 512
        self._put_lock = threading.Lock()

    def _drop_dev_cache(self) -> None:
        """Forget every cached upload (after a device failure the buffers
        may belong to a dead context)."""
        with self._put_lock:
            for ent in self._dev_cache.values():
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
        UPLOAD_BYTES += int(arr.nbytes)
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
                self._dev_cache.pop(oldest)[2].detach()
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
                    hard_pa=cons.n_pa_terms > 0,
                )
            if packed.topology is not None:
                tpods, tmeta, tstate = topology_to_device(packed.topology, self.device, put=self._put)
                pods.update(tpods)
                kw.update(tmeta=tmeta, tstate=tstate)
            assigned, rounds, _avail, acc_round, rank_of = assign_cycle(
                nodes, pods, profile.weights(), max_rounds=profile.max_rounds, block=profile.pod_block, **kw
            )
            # ONE device→host fetch for the whole result.
            combined = torch.stack([assigned, acc_round, rank_of, torch.full_like(assigned, rounds)]).cpu().numpy()
        except RuntimeError as e:
            if self.device.type == "cuda" and _is_device_failure(e):
                self._drop_dev_cache()
                raise BackendUnavailable(f"cuda backend runtime failure: {e}") from e
            raise
        return combined[0], int(combined[3, 0]), {"acc_round": combined[1], "rank": combined[2]}


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
