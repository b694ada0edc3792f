"""ClusterSnapshot — an immutable, I/O-free view of cluster state.

Copy of the part of ``tpu_scheduler/core/snapshot.py`` that packing needs:
every predicate is evaluated against one snapshot taken per scheduling
cycle, and the snapshot is exactly what gets packed into device tensors
(ops/pack.py, ops/constraints.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from ..api.objects import Node, Pod, is_pod_bound

__all__ = ["ClusterSnapshot"]


@dataclass(frozen=True)
class ClusterSnapshot:
    """Point-in-time cluster state: all nodes + all pods (bound pods consume
    node capacity; pending pods are the scheduling workload)."""

    nodes: tuple[Node, ...]
    pods: tuple[Pod, ...]
    # Built once by ``build``: all (pod, node) placements onto nodes of the
    # snapshot, and the subset whose pod declares anti-affinity terms.
    _placed: list = field(default_factory=list, compare=False, repr=False)
    _placed_with_terms: list = field(default_factory=list, compare=False, repr=False)
    # Lazy pending-pod memo (the snapshot is immutable, so one scan suffices).
    _pending: list | None = field(default=None, compare=False, repr=False)

    @staticmethod
    def build(nodes: Iterable[Node], pods: Iterable[Pod]) -> "ClusterSnapshot":
        snap = ClusterSnapshot(nodes=tuple(nodes), pods=tuple(pods))
        by_name = {n.name: n for n in snap.nodes}
        for p in snap.pods:
            if p.spec is not None and p.spec.node_name is not None:
                node = by_name.get(p.spec.node_name)
                if node is not None:
                    snap._placed.append((p, node))
                    if p.spec.anti_affinity:
                        snap._placed_with_terms.append((p, node))
        return snap

    def placed_pods(self) -> list:
        """All (pod, node) placements onto nodes present in the snapshot."""
        return self._placed

    def placed_pods_with_terms(self) -> list:
        """Placements whose pod declares anti-affinity terms."""
        return self._placed_with_terms

    def pending_pods(self) -> list[Pod]:
        """Pods to schedule: phase Pending and not yet bound.  Memoized;
        callers must not mutate the returned list."""
        if self._pending is None:
            object.__setattr__(
                self, "_pending", [p for p in self.pods if p.status.phase == "Pending" and not is_pod_bound(p)]
            )
        return self._pending
