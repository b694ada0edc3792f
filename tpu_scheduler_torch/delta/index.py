"""DeltaIndex — watch events → dirty pods, then the invalidation closure.

The reflector already streams copy-on-write by-node indexes and DELETE keys;
this module is the missing classification layer: each cycle's raw pod events
fold into the SolveState's capacity tensors and produce the DIRTY set — the
pods whose last verdict can no longer be trusted — which then CLOSES:

  • **capacity closure** — a deleted/retired placement frees capacity on a
    KNOWN node, so exactly the verdicts that node was blocking retire: a
    plain (constraint-free) pod's infeasibility is per-node-local
    predicates + capacity, so freed room on node X can only cure verdicts
    whose BLOCKING SET (node-locally-feasible nodes, computed at verdict
    time) contains X — churn on an unrelated node leaves them standing.
    Constrained verdicts (anti-affinity / pod-affinity / spread / gang)
    and verdicts without a blocking set (the budget ran out) keep the old
    coarse rule — any free retires — because a placed-pod deletion
    anywhere can shift their cross-node domain state.  Conservative
    either way: extra re-solves possible, missed placements never.
  • **constraint closure** — a deleted PENDING pod frees no capacity but may
    have been the anti-affinity carrier (or spread-domain occupant, via the
    ``sp_dom_sel``-projected cells) whose term blocked someone; verdicts
    retire the same way.
  • **gang closure** — gangs admit all-or-nothing, so a dirty member dirties
    the whole gang's verdicts (membership from the full pending set).
  • **pod-affinity closure** (engine commit) — fresh placements can SATISFY
    a positive pod-affinity seeker, the one way new placements ADD
    feasibility; verdicts flagged has_pod_affinity retire when anything
    placed.

Soundness argument (the shadow-solve parity gate holds it): with the node
set unchanged, a skipped pod's infeasibility can only be cured by freed
capacity, a removed constraint carrier, or a new positive-affinity match —
each of which retires the verdict above.  Everything else (new placements,
new pods) only ever REMOVES feasibility, which keeps an unschedulable
verdict true.

Port: a copy of ``tpu_scheduler/delta/index.py``, unchanged (NumPy).
"""

from __future__ import annotations

import numpy as np

from ..api.objects import full_name
from .state import SolveState, req64_of

__all__ = ["DeltaIndex", "FoldResult"]


class FoldResult:
    """One cycle's classification verdict."""

    __slots__ = ("ok", "freed_nodes", "freed_unknown", "carrier_deleted", "dirty")

    def __init__(self):
        self.ok = True  # False => escalate (vocabulary drift)
        self.freed_nodes: set[str] = set()  # nodes where committed capacity released
        self.freed_unknown = False  # capacity freed on an untracked node (coarse)
        self.carrier_deleted = False  # a pending pod (potential AA/spread carrier) vanished
        self.dirty: set[str] = set()  # pod full names whose verdict retired

    @property
    def freed(self) -> bool:
        return self.freed_unknown or bool(self.freed_nodes)

    def note_release(self, node) -> None:
        """Fold one SolveState.release result: a node name is a per-node
        free, "" an untracked (coarse) free, None a no-op."""
        if node is None:
            return
        if node:
            self.freed_nodes.add(node)
        else:
            self.freed_unknown = True


def _pod_full(key) -> str:
    ns, name = key
    return f"{ns or 'default'}/{name}"


def _node_of(pod) -> str | None:
    return pod.spec.node_name if pod is not None and pod.spec is not None else None


def blocking_nodes(pod, snapshot) -> frozenset:
    """The pod's node-locally-feasible node names — the per-verdict
    BLOCKING SET: selector / taint / required-node-affinity / cordon
    exclusions are static for the SolveState's node signature (any node
    content change escalates to a full wave), so freed capacity on a node
    OUTSIDE this set can never cure the verdict."""
    from ..core.predicates import NODE_LOCAL_PREDICATES

    return frozenset(
        node.name
        for node in snapshot.nodes
        if all(pred(pod, node, snapshot) for _r, pred in NODE_LOCAL_PREDICATES)
    )


def verdict_constrained(pod) -> bool:
    """Cross-node-entangled verdicts (anti-affinity / pod-affinity /
    topology-spread / gang) always retire on any freed capacity — a
    placed-pod deletion anywhere can shift their domain counts."""
    s = pod.spec
    return s is not None and bool(s.anti_affinity or s.pod_affinity or s.topology_spread or s.gang)


class DeltaIndex:
    """Buffers raw reflector pod events between plans and folds them into a
    SolveState + dirty classification.  Registered as a reflector pod
    listener once per scheduler; the buffer drains at plan time (or is
    discarded by a full-wave rebuild, whose snapshot already reflects every
    buffered event)."""

    def __init__(self):
        self._events: list[tuple] = []

    def on_pod_event(self, key, prev, new) -> None:
        self._events.append((key, prev, new))

    def on_pod_events(self, events: list[tuple]) -> None:
        """Batch feed (reflector add_pod_batch_listener): one call per sync
        with the drained event list — replaces per-event dispatch cost with
        one list extend."""
        self._events.extend(events)

    def pending_events(self) -> int:
        return len(self._events)

    def take(self) -> list[tuple]:
        out, self._events = self._events, []
        return out

    def fold(self, state: SolveState, events: list[tuple]) -> FoldResult:
        """Fold one cycle's events into ``state`` — the VECTORIZED fast
        path.  When every event key is unique the per-key outcomes are
        independent, so the loop partitions once (deletes / binds /
        re-pendings), batches the set bookkeeping, and applies ALL capacity
        movement as two unbuffered scatters (``np.add.at``/``subtract.at``)
        instead of one tiny ndarray op per event — int64 adds are exact and
        order-free, so the result is bit-identical to the scalar fold
        (tests/test_fleet.py pins the parity).  Duplicate keys (several
        events for one pod in a cycle) and vocabulary misses fall back to
        the order-dependent scalar loop."""
        if len(events) < 8 or len({k for k, _p, _n in events}) != len(events):
            return self._fold_scalar(state, events)
        out = FoldResult()
        deletes: list[tuple] = []
        bounds: list[tuple] = []
        repend: list[str] = []
        for key, prev, new in events:
            pf = _pod_full(key)
            if new is None:
                deletes.append((pf, prev))
            else:
                node = _node_of(new)
                if node is None:
                    repend.append(pf)
                else:
                    req = req64_of(new, state.res_vocab)
                    if req is None:
                        # Vocabulary miss: the scalar loop owns the exact
                        # stop-at-first-miss semantics (no state touched yet).
                        return self._fold_scalar(state, events)
                    bounds.append((pf, node, req))
        placements = state.placements
        unsched = state.unsched
        sub_rows: list[int] = []
        sub_reqs: list = []
        add_rows: list[int] = []
        add_reqs: list = []
        for pf, prev in deletes:
            ent = placements.pop(pf, None)
            if ent is None:
                if _node_of(prev) is None:
                    out.carrier_deleted = True
            elif ent[0] >= 0:
                sub_rows.append(ent[0])
                sub_reqs.append(ent[2])
                out.freed_nodes.add(ent[1])
            else:
                out.freed_unknown = True
            unsched.pop(pf, None)
        out.dirty.update(repend)
        for pf in repend:
            ent = placements.pop(pf, None)
            if ent is not None:
                if ent[0] >= 0:
                    sub_rows.append(ent[0])
                    sub_reqs.append(ent[2])
                    out.freed_nodes.add(ent[1])
                else:
                    out.freed_unknown = True
            unsched.pop(pf, None)
        row_of = state.row
        for pf, node, req in bounds:
            ent = placements.get(pf)
            if ent is not None and ent[1] == node and not (ent[2] != req).any():
                unsched.pop(pf, None)  # confirmation of our own commit
                continue
            if ent is not None:  # rebind / request drift: move the mass
                placements.pop(pf)
                if ent[0] >= 0:
                    sub_rows.append(ent[0])
                    sub_reqs.append(ent[2])
                    out.freed_nodes.add(ent[1])
                else:
                    out.freed_unknown = True
            r = row_of.get(node, -1)
            if r >= 0:
                add_rows.append(r)
                add_reqs.append(req)
            placements[pf] = (r, node, req)
            unsched.pop(pf, None)
        if sub_rows:
            np.subtract.at(state.used64, np.asarray(sub_rows), np.stack(sub_reqs))
        if add_rows:
            np.add.at(state.used64, np.asarray(add_rows), np.stack(add_reqs))
        return out

    def _fold_scalar(self, state: SolveState, events: list[tuple]) -> FoldResult:
        """The original one-event-at-a-time fold.  Exact-once accounting:
        confirmations of our own commits are no-ops; out-of-band binds and
        rebinds adjust by the difference; deletes free exactly what was
        committed.  Order-dependent, so it also serves duplicate-key event
        runs (bind→delete→re-create of one pod in a single cycle)."""
        out = FoldResult()
        for key, prev, new in events:
            pf = _pod_full(key)
            if new is None:  # DELETED
                released = state.release(pf)
                if released is not None:
                    out.note_release(released)
                elif _node_of(prev) is None:
                    # A pending pod vanished: zero capacity change, but it
                    # may have carried the term/domain cell blocking a
                    # constrained verdict.
                    out.carrier_deleted = True
                state.unsched.pop(pf, None)
                continue
            node = _node_of(new)
            if node is not None:  # bound (created bound, or confirmed/out-of-band)
                req = req64_of(new, state.res_vocab)
                if req is None:
                    out.ok = False  # new resource column: full-pack event
                    return out
                ent = state.placements.get(pf)
                if ent is None:
                    state.commit(pf, node, req)
                elif ent[1] != node or (ent[2] != req).any():
                    # Re-bound elsewhere (409 winner) or request drift: move
                    # the mass; the old node's room frees.
                    out.note_release(state.release(pf))
                    state.commit(pf, node, req)
                else:
                    state.unsched.pop(pf, None)  # confirmed; verdict moot
                continue
            # Pending (created or modified): its spec may have changed —
            # any standing verdict retires and the pod re-solves.  A
            # bound -> pending transition (a rebalancer deschedule, or a
            # defensive regression) frees its node's room.
            out.dirty.add(pf)
            out.note_release(state.release(pf))
            state.unsched.pop(pf, None)
        return out

    def close(self, state: SolveState, fold: FoldResult, placements_made: bool, pending_all: list) -> int:
        """Close the dirty set over the SolveState's standing verdicts;
        returns the number of verdicts retired.  After this, "dirty" is
        simply "pending and without a standing verdict" — the engine picks
        the cycle's work straight off ``state.unsched`` membership."""
        retired = 0
        standing = state.unsched
        if fold.freed_unknown or fold.carrier_deleted:
            # Coarse path: capacity freed outside the packed axis, or a
            # potential constraint carrier vanished — retire everything.
            retired += len(standing)
            standing.clear()
        elif fold.freed_nodes:
            # Per-node capacity closure: freed room on node X retires a
            # PLAIN verdict only when X is in its blocking set (node-
            # locally feasible — a selector/taint-excluded node's churn
            # cannot cure it).  Constrained verdicts and budget-elided
            # blocking sets keep the coarse any-free rule.
            freed = fold.freed_nodes
            for pf in [
                pf
                for pf, (_pa, _g, blocked, constrained) in standing.items()
                if constrained or blocked is None or (blocked & freed)
            ]:
                del standing[pf]
                retired += 1
        if placements_made:
            # New placements only ADD feasibility through positive
            # pod-affinity — retire exactly those verdicts.
            for pf in [pf for pf, ent in standing.items() if ent[0]]:
                del standing[pf]
                retired += 1
        if not standing:
            return retired
        # Gang closure: a dirty member (fresh pod, retired verdict) dirties
        # the whole gang — membership over the FULL pending set, so a member
        # in backoff still drags its gang-mates' verdicts with it when it
        # re-dirties.
        dirty_gangs: set[str] = set()
        for p in pending_all:
            g = p.spec.gang if p.spec is not None else None
            if g and full_name(p) not in standing:
                dirty_gangs.add(g)
        if dirty_gangs:
            for pf in [pf for pf, ent in standing.items() if ent[1] in dirty_gangs]:
                del standing[pf]
                retired += 1
        return retired
