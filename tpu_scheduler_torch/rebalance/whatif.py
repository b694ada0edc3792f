"""Autoscaler what-if — the questions the packing tier makes answerable.

Node-ADD policy (pending-backlog SLO driven): given the standing pending
backlog, how many nodes must join for every pending pod to fit?  The
backlog's requests first-fit-decreasing into the SCHEDULABLE fleet's free
capacity; whatever remains packs into hypothetical new nodes of the
fleet's largest shape — the count is the recommendation.

Node-REMOVE policy (defrag driven): how many nodes could leave today?  The
rebalancer's already-drained (labeled, empty) nodes plus the nodes the
packing solve projects drainable right now — the scale-down headroom.

Deterministic: exact ints, sorted orders, no rng — safe on the scorecard.

Port: a copy of ``tpu_scheduler/rebalance/whatif.py``, unchanged; its lazy
import of ``autoscale.policy.pack_catalog`` (the two packages import each
other) points into the port.
"""

from __future__ import annotations

import numpy as np

from .snapshot import RebalanceSnapshot
from .solver import solve_packing

__all__ = ["autoscaler_whatif"]


# shape: (snapshot: obj, pending: obj, drained_labeled: int, topo: obj,
#   catalog: obj, quota_left: obj) -> dict
def autoscaler_whatif(snapshot, pending, drained_labeled: int = 0, topo=None, catalog=None, quota_left=None) -> dict:
    """The what-if block: ``nodes_needed`` (node-add recommendation for the
    current backlog), ``nodes_removable`` (scale-down headroom), and the
    backlog accounting behind them.  ``pending`` is the pending Pod list;
    ``drained_labeled`` counts already-drained (cordoned, empty) nodes.

    With a heterogeneous ``catalog`` (InstanceSKU tuple, optionally bounded
    by ``quota_left``), the overflow additionally packs by cost-aware FFD
    over the catalog: ``sku_plan`` ({sku: count} — WHICH shapes to buy),
    ``plan_cost_per_hour``, and ``nodes_needed`` becomes the plan's node
    total so the autoscale policy never re-derives shape choice."""
    from ..api.objects import total_pod_resources

    rs = RebalanceSnapshot.build(snapshot)
    free = rs.alloc - rs.used
    np.maximum(free, 0, out=free)
    usable = [i for i in range(len(rs.node_names)) if rs.dest_ok[i]]
    usable.sort(key=lambda i: (-int(free[i, 0]), rs.node_names[i]))
    reqs = []
    for p in sorted(pending, key=lambda p: p.metadata.name or ""):
        r = total_pod_resources(p)
        reqs.append((int(r.cpu), int(r.memory)))
    reqs.sort(key=lambda r: (-max(r[0], r[1]), r))
    left = free.copy()
    overflow: list[tuple[int, int]] = []
    for cpu, mem in reqs:
        placed = False
        for i in usable:
            if int(left[i, 0]) >= cpu and int(left[i, 1]) >= mem:
                left[i, 0] -= cpu
                left[i, 1] -= mem
                placed = True
                break
        if not placed:
            overflow.append((cpu, mem))
    # Hypothetical new nodes: the fleet's largest shape per axis (a fleet
    # of zero nodes recommends one node per overflow pod — conservative).
    nodes_needed = 0
    if overflow:
        if len(rs.alloc):
            shape = (int(rs.alloc[:, 0].max()), int(rs.alloc[:, 1].max()))
        else:
            shape = (0, 0)
        if shape[0] <= 0 or shape[1] <= 0:
            nodes_needed = len(overflow)
        else:
            room = [0, 0]
            for cpu, mem in overflow:
                if room[0] < cpu or room[1] < mem:
                    nodes_needed += 1
                    room = [shape[0], shape[1]]
                room[0] -= cpu
                room[1] -= mem
    plan = solve_packing(rs, topo)
    out = {
        "pending_pods": len(reqs),
        "pending_unplaceable": len(overflow),
        "nodes_needed": nodes_needed,
        "nodes_removable": int(drained_labeled) + len(plan.drained),
        "drained_now": int(drained_labeled),
        "drainable_projected": len(plan.drained),
    }
    if catalog is not None:
        from ..autoscale.policy import pack_catalog

        sku_plan, unplaceable = pack_catalog(overflow, catalog, quota_left)
        by_name = {s.name: s for s in catalog}
        out["sku_plan"] = sku_plan
        out["plan_cost_per_hour"] = round(
            sum(by_name[sku].hourly_cost * n for sku, n in sku_plan.items()), 9
        )
        # Overflow the catalog cannot serve (quota-capped or oversized) —
        # the fleet-fit overflow itself stays in pending_unplaceable.
        out["plan_unplaceable"] = unplaceable
        out["nodes_needed"] = sum(sku_plan.values())
    return out
