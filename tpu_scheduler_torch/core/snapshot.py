"""ClusterSnapshot — an immutable, I/O-free view of cluster state.

Copy of ``tpu_scheduler/core/snapshot.py`` less its topology attachment:
every predicate is evaluated against one snapshot taken per scheduling
cycle, and the snapshot is exactly what gets packed into device tensors
(ops/pack.py, ops/constraints.py).  ``node_allocatable``,
``node_used_resources`` and ``node_net_available`` serve the scalar
predicates (core/predicates.py), memoized per (immutable) snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from ..api.objects import Node, Pod, PodResources, is_extended_resource, is_pod_bound, total_pod_resources
from ..api.quantity import cpu_to_millis, memory_to_bytes

__all__ = ["ClusterSnapshot", "node_allocatable", "node_net_available", "node_used_resources"]


def node_allocatable(node: Node, snapshot: "ClusterSnapshot | None" = None) -> PodResources:
    """Allocatable (cpu millicores, memory bytes, extended counts) of a
    node; zero without ``status.allocatable``.  With ``snapshot`` the
    parse is memoized on it.  Returns a fresh copy either way."""
    if snapshot is not None:
        cached = snapshot._alloc_cache.get(node.name)
        if cached is None:
            snapshot._alloc_cache[node.name] = cached = node_allocatable(node)
        return cached.copy()
    out = PodResources()
    if node.status is not None and node.status.allocatable is not None:
        for name, q in node.status.allocatable.items():
            if name == "cpu":
                out.cpu = cpu_to_millis(q)
            elif name == "memory":
                out.memory = memory_to_bytes(q)
            elif is_extended_resource(name):
                # Kube-native names the framework does not model (pods,
                # ephemeral-storage) are ignored on both sides.
                if out.extended is None:
                    out.extended = {}
                out.extended[name] = memory_to_bytes(q)
    return out


@dataclass(frozen=True)
class ClusterSnapshot:
    """Point-in-time cluster state: all nodes + all pods (bound pods consume
    node capacity; pending pods are the scheduling workload)."""

    nodes: tuple[Node, ...]
    pods: tuple[Pod, ...]
    _pods_by_node: dict[str, list[Pod]] = field(default_factory=dict, compare=False, repr=False)
    # Lazy per-node memos: parsed allocatable, summed bound-pod usage, and
    # their difference (node_allocatable / node_used_resources /
    # node_net_available).
    _alloc_cache: dict[str, PodResources] = field(default_factory=dict, compare=False, repr=False)
    _used_cache: dict[str, PodResources] = field(default_factory=dict, compare=False, repr=False)
    _net_cache: dict[str, PodResources] = field(default_factory=dict, compare=False, repr=False)
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
                snap._pods_by_node.setdefault(p.spec.node_name, []).append(p)
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

    def pods_on_node(self, node_name: str) -> list[Pod]:
        """The pods bound to ``node_name``."""
        return self._pods_by_node.get(node_name, [])

    def pending_pods(self) -> list[Pod]:
        """Pods to schedule: phase Pending and not yet bound.  Memoized;
        callers must not mutate the returned list."""
        if self._pending is None:
            object.__setattr__(
                self, "_pending", [p for p in self.pods if p.status.phase == "Pending" and not is_pod_bound(p)]
            )
        return self._pending


def node_net_available(snapshot: ClusterSnapshot, node: Node) -> PodResources:
    """allocatable − Σ bound-pod requests, memoized per snapshot; returns a
    fresh copy."""
    cached = snapshot._net_cache.get(node.name)
    if cached is None:
        net = node_allocatable(node, snapshot)
        net -= node_used_resources(snapshot, node.name)
        snapshot._net_cache[node.name] = cached = net
    return cached.copy()


def node_used_resources(snapshot: ClusterSnapshot, node_name: str) -> PodResources:
    """Sum of the requests of the pods bound to ``node_name``, memoized per
    snapshot; returns a fresh copy."""
    cached = snapshot._used_cache.get(node_name)
    if cached is None:
        used = PodResources()
        for p in snapshot.pods_on_node(node_name):
            used += total_pod_resources(p)
        snapshot._used_cache[node_name] = cached = used
    return cached.copy()
