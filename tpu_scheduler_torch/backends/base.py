"""Scheduling-backend interface — copy of ``tpu_scheduler/backends/base.py``.

The boundary is one cycle-level call: packed tensors in, per-pod node
assignments out.  ``schedule`` turns a backend's padded assignment into
bindings, exactly as the JAX package does, so results compare field by
field across the two packages.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from ..models.profiles import DEFAULT_PROFILE, SchedulingProfile
from ..ops.pack import PackedCluster

__all__ = ["CycleResult", "SchedulingBackend"]


@dataclass
class CycleResult:
    """Outcome of one scheduling cycle."""

    assigned: np.ndarray  # [num_pods] int32 — node index into packed.node_names, or −1
    bindings: list[tuple[str, str]]  # (pod full name, node name) for assigned pods
    unschedulable: list[str]  # pod full names with no feasible node this cycle
    rounds: int
    stats: dict = field(default_factory=dict)


class SchedulingBackend(abc.ABC):
    name: str = "abstract"

    # Whether assign() consumes PackedCluster.topology (the gang locality
    # term).
    supports_topology: bool = False

    @abc.abstractmethod
    def assign(self, packed: PackedCluster, profile: SchedulingProfile) -> tuple:
        """Run the cycle over padded tensors; return (assigned [padded_pods],
        rounds) or (assigned, rounds, extras) where ``extras`` carries
        per-pod diagnostics (acceptance round, priority rank) into
        ``CycleResult.stats``."""

    def schedule(self, packed: PackedCluster, profile: SchedulingProfile = DEFAULT_PROFILE) -> CycleResult:
        result = self.assign(packed, profile)
        assigned_padded, rounds = result[0], result[1]
        extras = result[2] if len(result) > 2 else {}
        assigned = np.asarray(assigned_padded)[: packed.num_pods]
        pod_arr = np.asarray(packed.pod_names, dtype=object)
        node_arr = np.asarray(packed.node_names, dtype=object)
        placed = np.flatnonzero(assigned >= 0)
        bindings = list(zip(pod_arr[placed].tolist(), node_arr[assigned[placed]].tolist()))
        unschedulable = pod_arr[np.flatnonzero(assigned < 0)].tolist()
        stats = {"backend": self.name}
        for k, v in extras.items():
            stats[k] = np.asarray(v)[: packed.num_pods]
        return CycleResult(
            assigned=assigned,
            bindings=bindings,
            unschedulable=unschedulable,
            rounds=int(rounds),
            stats=stats,
        )
