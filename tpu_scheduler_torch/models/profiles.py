"""Scheduling profiles — named policy configurations (copy of
``tpu_scheduler/models/profiles.py`` without the JSON artifact I/O).

Policy is data: score weights, the auction-round cap, the choose block
size.  Profiles are the "models" of the scheduler; the ``throughput``
profile drives the flagship cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

__all__ = ["SchedulingProfile", "DEFAULT_PROFILE", "PROFILES"]


@dataclass(frozen=True)
class SchedulingProfile:
    name: str = "default"
    # Score weights (kube-scheduler defaults both at 1).
    least_requested_weight: float = 1.0
    balanced_allocation_weight: float = 1.0
    # Deterministic tie-spreading jitter (score points).
    spread_jitter: float = 0.5
    # Auction-round safety cap.
    max_rounds: int = 32
    # Pods per choose block.
    pod_block: int = 4096
    # Soft-term weights: preferred node affinity, per untolerated
    # PreferNoSchedule taint, ScheduleAnyway spread penalty.
    preferred_affinity_weight: float = 1.0
    soft_taint_weight: float = 10.0
    topology_weight: float = 1.0
    # Rank-aware gang co-placement weight: topology/locality.gang_topology_term.
    gang_locality_weight: float = 64.0
    # Auction driver of the JAX package ("auto"/"monolithic"/"epochs").
    # The port has one eager driver; every value maps to it, since the JAX
    # drivers are bit-identical in results.
    driver: str = "auto"

    def __post_init__(self):
        if self.driver not in ("auto", "monolithic", "epochs"):
            raise ValueError(f"unknown driver {self.driver!r} (expected 'auto', 'monolithic' or 'epochs')")

    def weights(self) -> np.ndarray:
        return np.array(
            [
                self.least_requested_weight,
                self.balanced_allocation_weight,
                self.spread_jitter,
                self.preferred_affinity_weight,
                self.soft_taint_weight,
                self.topology_weight,
                self.gang_locality_weight,
            ],
            dtype=np.float32,
        )

    def with_(self, **kw) -> "SchedulingProfile":
        return replace(self, **kw)


DEFAULT_PROFILE = SchedulingProfile()

PROFILES: dict[str, SchedulingProfile] = {
    "default": DEFAULT_PROFILE,
    # Bin-packing flavour: prefer fuller nodes (negative least-requested).
    "most-requested": SchedulingProfile(name="most-requested", least_requested_weight=-1.0),
    # Pure spread on balanced allocation.
    "balanced-only": SchedulingProfile(name="balanced-only", least_requested_weight=0.0),
    # Mass-admission flavour — the flagship profile: a wide tie-break jitter
    # spreads each auction round's claims across many near-tied nodes,
    # cutting rounds at the cost of ±32 points of scoring noise.
    "throughput": SchedulingProfile(name="throughput", spread_jitter=32.0),
}
