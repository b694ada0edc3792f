"""Expert-parallel analogue: route pod classes to per-pool scheduling shards
(SURVEY.md §2b EP — "routing pod classes (GPU/TPU/CPU pools) to per-pool
scoring shards").

A cluster partitioned by a node label (``pool=compute``, ``pool=memory`` …)
decomposes: a pending pod whose nodeSelector PINS the partition key is only
feasible inside that pool, so the global P×N auction splits into independent
per-pool auctions of Σ Pᵢ×Nᵢ work — strictly less compute, smaller tiles,
and (the EP part) each pool shard dispatches to its own device: JAX's async
dispatch overlaps the pool solves exactly like expert shards overlap in an
MoE layer, with results gathered once at the end.

Pods that don't pin the key (and nodes lacking it) form the RESIDUAL, solved
after the pools against post-commit capacity via the controller's placed
overlay.  Semantics:

  • validity/capacity: exact — pools are disjoint node sets, a routed pod's
    selector makes off-pool nodes infeasible anyway, and the residual sees
    every pool placement as consumed capacity (same overlay the mixed
    priority-segment path uses, runtime/controller.py);
  • choice parity: NOT bit-identical to the unrouted auction (per-shard rank
    spaces change the tie-break jitter), matching the framework's parity
    contract for decomposed paths — binding validity, not identical choices
    (SURVEY.md §7 hard part (e));
  • priority: exact within a pool and within the residual; a residual pod
    competes only for post-pool capacity (the decomposition's documented
    trade — the same one the reference's random sampling makes globally,
    ``src/main.rs:49-71``).

Constrained cycles (anti-affinity / topology spread) bypass routing: domain
state spans pools, so the controller routes them through the constraint
tensor path instead.

Port: a copy of ``tpu_scheduler/parallel/routing.py``, unchanged (pure host code).
"""

from __future__ import annotations

from ..api.objects import Pod
from ..core.snapshot import ClusterSnapshot

__all__ = ["partition_snapshot", "PoolPartition"]


class PoolPartition:
    """One partitioning of a cycle: per-pool sub-snapshots + residual."""

    def __init__(self, pools: dict[str, ClusterSnapshot], residual_pending: list[Pod]):
        self.pools = pools
        self.residual_pending = residual_pending

    @property
    def routed_pods(self) -> int:
        return sum(len(s.pending_pods()) for s in self.pools.values())


def _pinned_value(pod: Pod, key: str) -> str | None:
    if pod.spec is None or not pod.spec.node_selector:
        return None
    return pod.spec.node_selector.get(key)


def partition_snapshot(snapshot: ClusterSnapshot, pool_key: str) -> PoolPartition | None:
    """Split a cycle by ``pool_key``.

    Pool ``v`` gets: the nodes labeled ``pool_key=v``, every pod bound to
    one of them (capacity bookkeeping), and the pending pods whose selector
    pins ``pool_key=v``.  Pending pods that don't pin the key — and any pod
    pinning a value no node carries (it can never bind; it must surface as
    unschedulable through the residual) — stay in the residual.  Returns
    None when routing would not split anything (≤1 non-empty pool, or
    nothing routable) — the caller then takes the plain batch path.
    """
    # One pass each over nodes, pending, and bound pods — O(nodes + pods)
    # regardless of pool cardinality.
    node_pool: dict[str, str] = {}
    nodes_by_pool: dict[str, list] = {}
    for n in snapshot.nodes:
        v = (n.metadata.labels or {}).get(pool_key)
        if v is not None:
            node_pool[n.name] = v
            nodes_by_pool.setdefault(v, []).append(n)

    routable: dict[str, list[Pod]] = {}
    residual: list[Pod] = []
    for p in snapshot.pending_pods():
        v = _pinned_value(p, pool_key)
        if v is not None and v in nodes_by_pool:
            routable.setdefault(v, []).append(p)
        else:
            residual.append(p)
    if len(routable) <= 1:
        return None

    bound_by_pool: dict[str, list[Pod]] = {}
    for q in snapshot.pods:
        if q.spec is not None and q.spec.node_name is not None:
            v = node_pool.get(q.spec.node_name)
            if v in routable:
                bound_by_pool.setdefault(v, []).append(q)

    pools: dict[str, ClusterSnapshot] = {}
    for v, pending in routable.items():
        pools[v] = ClusterSnapshot.build(nodes_by_pool[v], bound_by_pool.get(v, []) + pending)
    return PoolPartition(pools, residual)
