"""The background packing solve — whole-node drains via first-fit-decreasing.

Objective (the constraint-based pod-packing framing): maximize
**packing efficiency** — demand over the allocatable of the nodes that
carry any demand — equivalently minimize **stranded capacity**, the free
room trapped on occupied nodes.  Because the re-placement side of a
migration belongs to the delta engine (whose spreading score would scatter
descheduled pods right back onto empty nodes), the solve's unit of progress
is the **whole-node drain**: a node is worth draining only if ALL of its
bound mass is movable and the remaining receivers can absorb it — then the
executor unbinds its pods and cordons the emptied node, so the occupied set
monotonically shrinks regardless of where the re-placement lands.

Topology preference (the ``CompiledTopology`` distance machinery):
drain candidates are ordered emptiest-COARSEST-DOMAIN first — emptying the
last occupied node of a rack frees the whole rack (the ``rack-defrag``
migration reason, vs the plain ``defrag-drain``) — and receivers are
ordered fullest-domain-first, then by interconnect distance from the drain
source, so the projected packing consolidates into already-hot racks.

Everything is deterministic: sorted orders, exact int64 arithmetic, no rng.

Port: a copy of ``tpu_scheduler/rebalance/solver.py``, unchanged: the
rack-aware order reads the port's own topology compile
(``topology.model.CompiledTopology``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .planner import MIGRATION_REASONS
from .snapshot import RebalanceSnapshot

__all__ = ["Migration", "PackingPlan", "packing_stats", "solve_packing"]


# shape: (alloc: [N, 2] i64, used: [N, 2] i64) -> dict
def packing_stats(alloc: np.ndarray, used: np.ndarray) -> dict:
    """Packing-efficiency / stranded-capacity verdict over one capacity
    view.  ``efficiency`` is the dominant-axis fill of the OCCUPIED node
    set (1.0 = every occupied node full on its binding axis; an empty
    cluster scores 1.0 — nothing is stranded); ``stranded_frac`` is the
    free share of occupied capacity on the same axis.  Exact integer sums;
    the single division is deterministic on a given platform."""
    occ = (used > 0).any(axis=1)
    occupied = int(occ.sum())
    out = {
        "occupied_nodes": occupied,
        "empty_nodes": int(len(used) - occupied),
        "efficiency": 1.0,
        "stranded_frac": 0.0,
    }
    if not occupied:
        return out
    a = alloc[occ].sum(axis=0)
    u = used[occ].sum(axis=0)
    fills = [int(u[k]) / int(a[k]) for k in range(2) if int(a[k]) > 0]
    if fills:
        eff = max(fills)
        out["efficiency"] = round(eff, 6)
        # Pre-oversubscribed state (synthetic round-robin binding) can push
        # the occupied-set fill past 1; stranded capacity floors at zero.
        out["stranded_frac"] = round(max(0.0, 1.0 - eff), 6)
    return out


@dataclass(frozen=True)
class Migration:
    """One planned deschedule: the pod, its source node, the receiver the
    PROJECTION packed it onto (a hint — the delta engine owns the real
    re-placement), and the closed migration reason."""

    pod_full: str
    src: str
    dst: str
    cpu: int
    mem: int
    reason: str


@dataclass(frozen=True)
class PackingPlan:
    """One solve's verdict: migrations in drain order (grouped by source
    node — the executor's whole-node batch unit), the drained node names,
    and the projected before/after packing stats."""

    migrations: tuple[Migration, ...]
    drained: tuple[str, ...]
    before: dict
    after: dict


# shape: (alloc: [N, 2] i64, used: [N, 2] i64, headroom: float) -> [N, 2] i64
def _receiver_budget(alloc: np.ndarray, used: np.ndarray, headroom: float) -> np.ndarray:
    """The migration-diff operand: how much projected mass each receiver
    may still absorb — ``headroom · alloc − used``, floored at zero (an
    already-over-full node absorbs nothing)."""
    budget = (alloc.astype(np.float64) * headroom).astype(np.int64) - used
    np.maximum(budget, 0, out=budget)
    return budget


# shape: (budget: [N, 2] i64, req_cpu: [M] i64, req_mem: [M] i64) -> [N, M] bool
def _fit_matrix(budget: np.ndarray, req_cpu: np.ndarray, req_mem: np.ndarray) -> np.ndarray:
    """The migration-diff feasibility operand: which receiver row can host
    which victim, per-axis outer compare — the whole-group fast abort
    (a victim no receiver fits sinks its node's drain before any FFD)."""
    return (budget[:, 0:1] >= req_cpu[None, :]) & (budget[:, 1:2] >= req_mem[None, :])


# shape: (rs: obj, topo: obj) -> obj
def _coarse_domains(rs: RebalanceSnapshot, topo):
    """[N] int32 coarsest-level domain ids aligned to ``rs.node_names``
    (compiled against a possibly different node order — map by name), or
    None when the cluster is topology-blind."""
    if topo is None or topo.n_levels == 0:
        return None
    by_name = {name: int(topo.dom_ids[-1][i]) for i, name in enumerate(topo.node_names)}
    if not all(name in by_name for name in rs.node_names):
        return None
    return np.asarray([by_name[name] for name in rs.node_names], dtype=np.int32)


# shape: (rs: obj, topo: obj, max_migrations: int, headroom: float) -> obj
def solve_packing(rs: RebalanceSnapshot, topo=None, max_migrations: int = 256, headroom: float = 0.9) -> PackingPlan:
    """Compute the bounded whole-node-drain plan (see module docstring).

    ``headroom`` caps how full the projection may pack a receiver (the
    delta engine's greedy re-placement is not the FFD projection, so the
    plan leaves slack for the difference); ``max_migrations`` bounds the
    plan size outright."""
    n = len(rs.node_names)
    before = packing_stats(rs.alloc, rs.used)
    used = rs.used.copy()
    budget = _receiver_budget(rs.alloc, used, headroom)
    by_node: dict[int, list[tuple[str, int, int]]] = {}
    for pod_full, i, cpu, mem in rs.movable:
        by_node.setdefault(i, []).append((pod_full, cpu, mem))
    occ = (used > 0).any(axis=1)
    doms = _coarse_domains(rs, topo)
    dist = topo.distance_matrix() if (topo is not None and doms is not None and n <= 4096) else None

    # shape: (i: int) -> float
    def node_fill(i: int) -> float:
        fills = [int(used[i, k]) / int(rs.alloc[i, k]) for k in range(2) if int(rs.alloc[i, k]) > 0]
        return max(fills) if fills else 1.0

    # shape: (d: int) -> float
    def dom_fill(d: int) -> float:
        rows = np.flatnonzero(doms == d)
        a = rs.alloc[rows].sum(axis=0)
        u = used[rows].sum(axis=0)
        fills = [int(u[k]) / int(a[k]) for k in range(2) if int(a[k]) > 0]
        return max(fills) if fills else 1.0

    # Drain candidates: occupied, unpinned, every gram of demand movable.
    cands = [
        i
        for i in range(n)
        if occ[i]
        and not rs.pinned[i]
        and i in by_node
        and sum(c for _p, c, _m in by_node[i]) == int(used[i, 0])
        and sum(m for _p, _c, m in by_node[i]) == int(used[i, 1])
    ]
    # Emptiest coarsest-domain first (free whole racks), then emptiest
    # node, then name — fully deterministic.
    cands.sort(
        key=lambda i: (
            dom_fill(int(doms[i])) if doms is not None else 0.0,
            node_fill(i),
            rs.node_names[i],
        )
    )
    drained: list[int] = []
    received: set[int] = set()  # nodes the projection already packed INTO
    migrations: list[Migration] = []
    for src in cands:
        if src in received:
            # A node that absorbed projected mass is a keep-node now —
            # draining it would re-migrate pods the plan just moved (chain
            # churn) and silently erase the received mass from the
            # projection's books.
            continue
        pods = sorted(by_node[src], key=lambda p: (-max(p[1], p[2]), p[0]))  # FFD by dominant axis
        if len(migrations) + len(pods) > max_migrations:
            continue
        # Receivers: occupied, schedulable, not the source, not drained —
        # fullest domain first, fullest node next, NEAREST to the source as
        # the final tie-break (the interconnect-distance preference).
        recv = [
            j
            for j in range(n)
            if j != src and occ[j] and rs.dest_ok[j] and j not in drained
        ]
        recv.sort(
            key=lambda j: (
                -dom_fill(int(doms[j])) if doms is not None else 0.0,
                -node_fill(j),
                float(dist[src, j]) if dist is not None else 0.0,
                rs.node_names[j],
            )
        )
        if recv:
            # Whole-group fast abort: a victim NO receiver could host even
            # with its full remaining budget sinks this drain outright.
            fits = _fit_matrix(
                budget[np.asarray(recv, dtype=np.int64)],
                np.asarray([c for _p, c, _m in pods], dtype=np.int64),
                np.asarray([m for _p, _c, m in pods], dtype=np.int64),
            )
            if not bool(fits.any(axis=0).all()):
                continue
        trial: list[tuple[str, int, int, int]] = []  # (pod_full, dst, cpu, mem)
        spent: dict[int, np.ndarray] = {}
        ok = True
        for pod_full, cpu, mem in pods:
            placed = False
            for j in recv:
                free = budget[j] - spent.get(j, 0)
                if int(free[0]) >= cpu and int(free[1]) >= mem:
                    spent[j] = spent.get(j, np.zeros(2, dtype=np.int64)) + np.asarray([cpu, mem], dtype=np.int64)
                    trial.append((pod_full, j, cpu, mem))
                    placed = True
                    break
            if not placed:
                ok = False
                break
        if not ok:
            continue
        # Commit the drain: move the projected mass, mark the node drained.
        reason = MIGRATION_REASONS[0]  # defrag-drain
        if doms is not None:
            others = np.flatnonzero((doms == doms[src]) & occ)
            if len(others) == 1 and int(others[0]) == src:
                reason = MIGRATION_REASONS[1]  # rack-defrag: the rack empties whole
        for pod_full, j, cpu, mem in trial:
            used[j] += (cpu, mem)
            budget[j] -= (cpu, mem)
            received.add(j)
            migrations.append(
                Migration(pod_full=pod_full, src=rs.node_names[src], dst=rs.node_names[j], cpu=cpu, mem=mem, reason=reason)
            )
        used[src] = 0
        occ[src] = False
        drained.append(src)
    after = packing_stats(rs.alloc, used)
    return PackingPlan(
        migrations=tuple(migrations),
        drained=tuple(rs.node_names[i] for i in drained),
        before=before,
        after=after,
    )
