"""ClusterSnapshot — an immutable, I/O-free view of cluster state.

Copy of the part of ``tpu_scheduler/core/snapshot.py`` that packing needs:
every predicate is evaluated against one snapshot taken per scheduling
cycle, and the snapshot is exactly what gets packed into device tensors
(ops/pack.py).
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
    # Lazy pending-pod memo (the snapshot is immutable, so one scan suffices).
    _pending: list | None = field(default=None, compare=False, repr=False)

    @staticmethod
    def build(nodes: Iterable[Node], pods: Iterable[Pod]) -> "ClusterSnapshot":
        return ClusterSnapshot(nodes=tuple(nodes), pods=tuple(pods))

    def pending_pods(self) -> list[Pod]:
        """Pods to schedule: phase Pending and not yet bound.  Memoized;
        callers must not mutate the returned list."""
        if self._pending is None:
            object.__setattr__(
                self, "_pending", [p for p in self.pods if p.status.phase == "Pending" and not is_pod_bound(p)]
            )
        return self._pending
