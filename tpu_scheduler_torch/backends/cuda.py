"""CUDA (PyTorch) batched backend — the port of ``tpu_scheduler/backends/tpu.py``.

Uploads the packed tensors once per cycle — with the inter-pod constraint
tensors when the cluster carries them — runs the auction (ops/assign.py,
with the hand-written choose kernels on the card) and brings the result
home as ONE stacked [4, P] int32 tensor.  Topology cycles are not ported
yet and raise ``NotImplementedError``.  Runs on the card unless
the caller asks for the CPU (``device="cpu"``, the plain torch versions —
what the tests use).  There is no fallback: without CUDA the constructor
raises, and a CUDA runtime failure during a cycle raises
:class:`BackendUnavailable` for the caller to handle.
"""

from __future__ import annotations

import torch

from ..convert import constraints_to_device, to_device
from ..errors import BackendUnavailable
from ..models.profiles import SchedulingProfile
from ..ops.assign import assign_cycle, split_device_arrays
from ..ops.choose import KernelError
from ..ops.pack import PackedCluster
from .base import SchedulingBackend

__all__ = ["CudaBackend", "make_backend"]


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
    supports_topology = False

    def __init__(self, device: str | torch.device | None = None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise BackendUnavailable("cuda backend: torch.cuda.is_available() is False")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"cuda backend: unsupported device {dev}")
        self.device = dev

    def assign(self, packed: PackedCluster, profile: SchedulingProfile):
        if packed.topology is not None:
            raise NotImplementedError("cuda backend: topology cycles are not ported yet")
        try:
            nodes, pods = split_device_arrays(to_device(packed, self.device))
            cons = packed.constraints
            ckw = {}
            if cons is not None:
                cpods, cmeta, cstate = constraints_to_device(cons, self.device)
                pods.update(cpods)
                ckw = dict(
                    cmeta=cmeta, cstate=cstate, soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0,
                    hard_pa=cons.n_pa_terms > 0,
                )
            assigned, rounds, _avail, acc_round, rank_of = assign_cycle(
                nodes, pods, profile.weights(), max_rounds=profile.max_rounds, block=profile.pod_block, **ckw
            )
            # ONE device→host fetch for the whole result.
            combined = torch.stack([assigned, acc_round, rank_of, torch.full_like(assigned, rounds)]).cpu().numpy()
        except RuntimeError as e:
            if self.device.type == "cuda" and _is_device_failure(e):
                raise BackendUnavailable(f"cuda backend runtime failure: {e}") from e
            raise
        return combined[0], int(combined[3, 0]), {"acc_round": combined[1], "rank": combined[2]}


def make_backend(name: str, **kw) -> SchedulingBackend:
    """The port's backend factory (the JAX package's factory knows no
    "cuda")."""
    if name == "cuda":
        return CudaBackend(**kw)
    raise ValueError(f"unknown backend {name!r} (expected 'cuda')")
