"""Scheduling-backend interface — copy of ``tpu_scheduler/backends/base.py``.

The boundary is one cycle-level call: packed tensors in, per-pod node
assignments out.  ``schedule`` turns a backend's padded assignment into
bindings, exactly as the JAX package does, so results compare field by
field across the two packages.  One field is the port's own:
``CycleResult.cut_off``, the unschedulable pods the auction stopped before
it had shown that no node fits them (a backend's ``cut_off`` extra).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from ..models.profiles import DEFAULT_PROFILE, SchedulingProfile
from ..ops.assign import CUT_OFF_CAUSES
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
    # Of ``unschedulable``, the pods a stop of the auction cut off, each with
    # its cause (ops/assign.CUT_OFF_CAUSES): not shown infeasible.
    cut_off: dict[str, str] = field(default_factory=dict)


class SchedulingBackend(abc.ABC):
    name: str = "abstract"

    # Whether a routed cycle may solve shards from concurrent threads.
    # Mesh backends say False: their collectives must launch in one order.
    supports_concurrent_shards: bool = True

    # Whether assign() consumes PackedCluster.topology (the gang locality
    # term).  The controller attaches the tensors, and arms the cross-rack
    # quality backstop, only for backends that say True.
    supports_topology: bool = False

    def shard_for(self, index: int) -> "SchedulingBackend":
        """Backend instance for the ``index``-th parallel shard of a routed
        cycle (parallel/routing.py).  Default: this backend; device-owning
        backends override to spread shards over their devices."""
        return self

    @abc.abstractmethod
    def assign(self, packed: PackedCluster, profile: SchedulingProfile) -> tuple:
        """Run the cycle over padded tensors; return (assigned [padded_pods],
        rounds) or (assigned, rounds, extras) where ``extras`` carries
        per-pod diagnostics (acceptance round, priority rank) into
        ``CycleResult.stats``; a ``cut_off`` extra (each pod's index into
        ops/assign.CUT_OFF_CAUSES) becomes ``CycleResult.cut_off``."""

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
        cut_off = {}
        for k, v in extras.items():
            if k == "cut_off":
                codes = np.asarray(v)[: packed.num_pods]
                rows = np.flatnonzero(codes)
                cut_off = dict(zip(pod_arr[rows].tolist(), (CUT_OFF_CAUSES[c] for c in codes[rows].tolist())))
            else:
                stats[k] = np.asarray(v)[: packed.num_pods]
        return CycleResult(
            assigned=assigned,
            bindings=bindings,
            unschedulable=unschedulable,
            rounds=int(rounds),
            stats=stats,
            cut_off=cut_off,
        )
