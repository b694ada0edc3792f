"""RebalanceSnapshot — the consistent packing view one background solve
reads.

Built once per solve from the cycle's (immutable) ClusterSnapshot, so the
background thread can hold it safely while the cycle loop moves on — the
shared-cache stance the delta engine's ``_reduced_view`` established.

Victim taxonomy (conservative by construction — a migration may only ever
move a pod whose placement is purely resource-driven):

  • **movable** — bound, not a gang member (gangs admit all-or-nothing and
    never migrate piecewise), no nodeSelector / required node affinity, no
    anti-affinity / pod-affinity / topology-spread (moving a constrained
    pod could invalidate a placement the solve cannot see), no extended
    resources (the two fixed axes are the packing vocabulary), not
    selected by any PodDisruptionBudget (migrations are voluntary
    disruptions; protected workloads are simply never victims), and not
    vetoed by the caller's ``victim_ok`` (deferred/assumed binds, shard
    ownership).  Soft preferences (preferred affinity, PreferNoSchedule)
    do not pin: they bias scores, never feasibility.
  • **pinned** — every other bound pod.  A node hosting any pinned mass
    can never be drained empty, so it is excluded from drain candidacy
    outright (a partial drain shrinks nothing).

Receiver eligibility (``dest_ok``): schedulable (not cordoned) and free of
NoSchedule/NoExecute taints — movable pods carry no tolerations
requirement, so any hard taint excludes the node for all of them.

Port: a copy of ``tpu_scheduler/rebalance/snapshot.py``, unchanged; the
PDB match is the port controller's ``_pdb_matches``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api.objects import Pod, full_name, total_pod_resources
from ..core.snapshot import ClusterSnapshot, node_allocatable, node_used_resources

__all__ = ["RebalanceSnapshot", "is_movable"]


# shape: (pod: obj) -> bool
def _spec_pins(pod: Pod) -> bool:
    """Does the pod's own spec pin it (constraint-driven placement)?"""
    s = pod.spec
    if s is None:
        return True
    return bool(
        s.gang
        or s.node_selector
        or s.node_affinity
        or s.anti_affinity
        or s.pod_affinity
        or s.topology_spread
    )


# shape: (pod: obj, pdbs: obj, victim_ok: obj) -> bool
def is_movable(pod: Pod, pdbs=(), victim_ok=None) -> bool:
    """The closed victim test (see the module docstring's taxonomy)."""
    if _spec_pins(pod):
        return False
    req = total_pod_resources(pod)
    if req.extended and any(v for v in req.extended.values()):
        return False
    if victim_ok is not None and not victim_ok(full_name(pod)):
        return False
    if pdbs:
        from ..runtime.controller import _pdb_matches

        if any(_pdb_matches(b, pod) for b in pdbs):
            return False
    return True


# shape: (node: obj) -> bool
def _dest_ok(node) -> bool:
    if node.spec is None:
        return True
    if node.spec.unschedulable:
        return False
    for t in node.spec.taints or ():
        if t.effect in ("NoSchedule", "NoExecute"):
            return False
    return True


@dataclass(frozen=True)
class RebalanceSnapshot:
    """One consistent packing view: exact-int capacity over two fixed axes
    (cpu millicores, memory bytes — the same scalars ``fits_in`` compares),
    the movable victim list, and per-node drain/receive eligibility."""

    node_names: tuple[str, ...]
    alloc: np.ndarray  # [N, 2] i64 — allocatable (cpu_m, mem_bytes)
    used: np.ndarray  # [N, 2] i64 — ALL bound demand (movable + pinned)
    pinned: np.ndarray  # [N] bool — node hosts non-movable bound mass
    dest_ok: np.ndarray  # [N] bool — schedulable receiver
    # (pod_full, node row, cpu_m, mem_bytes) per movable pod, sorted by
    # (node row, pod name) so every downstream order is deterministic.
    movable: tuple[tuple[str, int, int, int], ...]

    # shape: (snapshot: obj, pdbs: obj, victim_ok: obj) -> obj
    @staticmethod
    def build(snapshot: ClusterSnapshot, pdbs=(), victim_ok=None) -> "RebalanceSnapshot":
        nodes = snapshot.nodes
        names = tuple(n.name for n in nodes)
        row = {name: i for i, name in enumerate(names)}
        n = len(names)
        alloc = np.zeros((n, 2), dtype=np.int64)
        used = np.zeros((n, 2), dtype=np.int64)
        dest = np.zeros((n,), dtype=bool)
        for i, node in enumerate(nodes):
            a = node_allocatable(node, snapshot)
            u = node_used_resources(snapshot, node.name)
            alloc[i] = (a.cpu, a.memory)
            used[i] = (u.cpu, u.memory)
            dest[i] = _dest_ok(node)
        pinned = np.zeros((n,), dtype=bool)
        movable: list[tuple[str, int, int, int]] = []
        for pod, node in snapshot.placed_pods():
            i = row.get(node.name)
            if i is None:
                continue
            if is_movable(pod, pdbs, victim_ok):
                req = total_pod_resources(pod)
                movable.append((full_name(pod), i, int(req.cpu), int(req.memory)))
            else:
                pinned[i] = True
        movable.sort(key=lambda m: (m[1], m[0]))
        return RebalanceSnapshot(
            node_names=names, alloc=alloc, used=used, pinned=pinned, dest_ok=dest, movable=tuple(movable)
        )
