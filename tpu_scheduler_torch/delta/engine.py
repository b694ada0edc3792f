"""DeltaEngine — plan/commit orchestration of the incremental cycle.

Every owned cycle the controller asks for a plan.  The answer is either a
``DeltaPlan`` — solve ONLY the dirty pods against the carried residual
tensors — or ``None``, which escalates to the classic full-wave cycle
(fresh capacity sweep, every eligible pod re-solved) followed by a state
rebuild.  Escalation happens only on the closed ``ESCALATION_REASONS``:

  cold              no SolveState yet (first owned cycle of a process)
  restore           checkpoint restore — never trust restored residuals
  takeover          leadership/shard-ownership change (another replica's
                    commits may predate our watch view of them)
  breaker-recovery  the API circuit breaker re-closed — the brownout may
                    have dropped watch evidence on the floor
  node-change       node set/order/content signature drift (capacity rows
                    cannot be remapped safely)
  vocab-change      a request names a resource column the packed vocabulary
                    lacks (full pack re-derives scales)
  closure-overflow  the invalidation closure grew past the threshold —
                    a full sweep is cheaper than incremental bookkeeping
  epoch-refresh     periodic paranoia full-wave (bounds the lifetime of any
                    undetected bookkeeping drift)
  mesh-rebind       a fleet takeover/resize rebound absorbed shards onto
                    this replica's device mesh — the carried residuals were
                    laid out for the old node slice, so the widened slice
                    re-solves from scratch (the JAX package's tpu_scheduler/fleet)

The shadow-solve parity gate (sim): on sampled delta cycles the controller
solves the FULL eligible set beside the delta path and the engine records
whether both placed exactly the same pod set — the
invariant-equivalence contract (placements may differ only within the
score tie-break freedom; the PLACED SET and the unschedulable set may not).

Port: a copy of ``tpu_scheduler/delta/engine.py``.  ``"mesh-rebind"`` is
raised by the fleet (the controller's mesh-binding sync after a takeover or
a resize).  The full-wave commit's rebuild has a span of its own
(``delta/commit/rebuild``).  Three departures keep a mass wave's engine work
off its path, each with the JAX package's results: a plan whose pending pods
without a standing verdict already pass the overflow threshold escalates
before the fold (``escalated_early``, counted in
``scheduler_delta_early_escalations_total``); the rebuild takes the pack's
capacity sweep of the same snapshot; and it leaves the placement ledger to
be written when first read (``SolveState.defer_placements``).  One
departure changes results: the verdicts a commit records leave out the pods
the cycle was cut off from (``_record_verdicts``).
"""

from __future__ import annotations

import logging

import numpy as np

from ..api.objects import full_name
from ..utils.tracing import span
from .index import DeltaIndex, blocking_nodes, verdict_constrained
from .state import SolveState

logger = logging.getLogger("tpu_scheduler_torch.delta")

__all__ = ["ESCALATION_REASONS", "DeltaPlan", "DeltaEngine"]

# The closed escalation vocabulary: ``invalidate`` refuses any other reason.
ESCALATION_REASONS = (
    "cold",
    "restore",
    "takeover",
    "breaker-recovery",
    "node-change",
    "vocab-change",
    "closure-overflow",
    "epoch-refresh",
    "mesh-rebind",
)


def _outside(res, vocab: tuple[str, ...]) -> bool:
    """Whether the request sums ``res`` name an extended resource outside
    ``vocab`` (``req64_of`` gives None for such a pod)."""
    return bool(res.extended) and any(v and name not in vocab for name, v in res.extended.items())


class DeltaPlan:
    """One delta cycle's work order: the dirty pods to solve, the count of
    standing verdicts skipped, and the carried capacity pair the repack
    consumes instead of the O(bound-pods) sweep."""

    __slots__ = ("pods", "skipped", "alloc_used64", "retired")

    def __init__(self, pods: list, skipped: int, alloc_used64, retired: int):
        self.pods = pods
        self.skipped = skipped
        self.alloc_used64 = alloc_used64  # ([N_pad, R] i64, [N_pad, R] i64) or None
        self.retired = retired


class DeltaEngine:
    """Owns the SolveState + DeltaIndex and the escalation policy.  Written
    only by the controller's cycle loop (single-threaded); the HTTP debug
    thread reads GIL-atomic copies via ``stats()``."""

    # Closure-overflow threshold: a dirty set above max(OVERFLOW_MIN,
    # OVERFLOW_FRAC · total pods) means incremental bookkeeping is no longer
    # buying anything — rebuild wholesale.
    OVERFLOW_MIN = 512
    OVERFLOW_FRAC = 0.5
    # Per-verdict blocking-set budget (pod × node predicate probes per
    # commit): a mass-unschedulable cycle falls back to blocked=None (the
    # coarse any-free rule) instead of stalling the loop classifying it.
    BLOCKING_BUDGET = 200_000

    def __init__(self, metrics=None, epoch_refresh: int = 64):
        self.metrics = metrics
        self.epoch_refresh = int(epoch_refresh)
        self.index = DeltaIndex()
        self.state: SolveState | None = None
        self._invalid_reason: str | None = None  # forces the next plan full
        self._full_reason: str | None = None  # the reason the CURRENT cycle went full
        self._placements_since_plan = False
        # Whether the last plan escalated on counts alone, before the fold
        # (the controller's per-cycle counter; not a ``stats()`` key).
        self.escalated_early = False
        self.generation = 0
        # Lifetime stats (served to the sim scorecard / bench / tests).
        self.delta_cycles = 0
        self.full_solve_reasons: dict[str, int] = {}
        self.skipped_total = 0
        self.dirty_sizes: list[int] = []
        self.shadow_checks = 0
        self.shadow_mismatches = 0
        self.shadow_skipped = 0

    # -- lifecycle ----------------------------------------------------------

    def attach(self, reflector) -> None:
        """Subscribe to the reflector's pod event stream (the watch-delta
        feed the DeltaIndex classifies).  Prefers the BATCH feed (one call
        per sync with the drained event list) over per-event dispatch; the
        per-event path survives for reflectors without the batch hook."""
        batch = getattr(reflector, "add_pod_batch_listener", None)
        if batch is not None:
            batch(self.index.on_pod_events)
        else:
            reflector.add_pod_listener(self.index.on_pod_event)

    def invalidate(self, reason: str) -> None:
        """Force the next plan to escalate (takeover, restore, breaker
        recovery).  The strongest pending reason wins nothing — first set
        sticks, which is enough: any escalation rebuilds everything."""
        if reason not in ESCALATION_REASONS:
            raise ValueError(f"unknown escalation reason {reason!r}")
        if self._invalid_reason is None:
            self._invalid_reason = reason

    def uncommit(self, pod_full: str) -> None:
        """A committed placement did not stick (requeue after an async bind
        failure, deferred-flush overflow): release its capacity so the
        ledger matches the API truth again."""
        if self.state is not None:
            self.state.release(pod_full)

    # -- plan ---------------------------------------------------------------

    def _escalate(self, reason: str):
        self._full_reason = reason
        self._invalid_reason = None
        return None

    def plan(self, snapshot, pending: list, pending_all: list, packed, node_sig, preempting: bool = False):
        """Classify this cycle: a DeltaPlan (solve the dirty set against
        carried residuals) or None (escalate to the full-wave path; the
        reason is recorded and counted at commit).

        ``preempting`` disables the verdict skip (every eligible pod stays
        dirty): the preemption pass retries exactly the pods the cycle
        marked unschedulable, and a PDB-blocked preemption must re-attempt
        as budgets thaw — a standing verdict would silently starve it.  The
        carried-capacity fast path still applies."""
        self._full_reason = None
        self.escalated_early = False
        st = self.state
        if st is None:
            return self._escalate(self._invalid_reason or "cold")
        if self._invalid_reason is not None:
            return self._escalate(self._invalid_reason)
        if (
            packed is None
            or tuple(packed.node_names) != st.node_names
            or node_sig != st.node_sig
        ):
            return self._escalate("node-change")
        if packed.res_vocab != st.res_vocab or packed.res_scales != st.res_scales:
            return self._escalate("vocab-change")
        if st.delta_cycles_since_full >= self.epoch_refresh:
            return self._escalate("epoch-refresh")
        threshold = max(self.OVERFLOW_MIN, int(self.OVERFLOW_FRAC * len(snapshot.pods)))
        if not preempting and len(pending) - len(st.unsched) > threshold:
            # The fold and the close only retire standing verdicts, so the
            # dirty set holds at least every pending pod the ledger does not
            # skip: the cycle overflows whatever they find.  Of the fold's
            # own verdicts only a vocabulary miss ranks above the overflow,
            # and the buffered events show it without the fold; the rebuild
            # discards them, as it discards every buffered event.
            self.escalated_early = True
            if self.metrics is not None:
                self.metrics.inc("scheduler_delta_early_escalations_total")
            with span("index"):
                outside = self.index.binds_outside_vocab(st.res_vocab)
            return self._escalate("vocab-change" if outside else "closure-overflow")
        with span("index"):
            fold = self.index.fold(st, self.index.take())
        if not fold.ok:
            return self._escalate("vocab-change")
        with span("close"):
            retired = self.index.close(st, fold, self._placements_since_plan, pending_all)
            self._placements_since_plan = False
            standing = st.unsched
            if preempting:
                dirty = list(pending)
                skipped = 0
            else:
                dirty = [p for p in pending if full_name(p) not in standing]
                skipped = len(pending) - len(dirty)
        if len(dirty) > threshold:
            return self._escalate("closure-overflow")
        alloc_used = None
        if dirty:
            with span("repack"):
                # A dirty pod naming a resource column outside the carried
                # vocabulary is a full-pack event (the full path re-derives
                # scales); detect it here, where the padded sweep is skipped.
                for p in dirty:
                    if self.index.requests.of(p, st.res_vocab) is None:
                        return self._escalate("vocab-change")
                alloc_used = (st.alloc64, st.used64)
        return DeltaPlan(dirty, skipped, alloc_used, retired)

    # -- commit -------------------------------------------------------------

    def commit(self, plan, snapshot, packed, node_sig, placed: list, unschedulable: list, pending_all: list, res_memo=None) -> None:
        """Fold the cycle's outcome back into the SolveState.  ``plan`` is
        the object this cycle ran under (None = the full-wave path ran, so
        the state rebuilds wholesale from the solved snapshot)."""
        if plan is None:
            reason = self._full_reason or "cold"
            self.full_solve_reasons[reason] = self.full_solve_reasons.get(reason, 0) + 1
            if self.metrics is not None:
                self.metrics.inc("scheduler_full_solves_total", labels={"reason": reason})
            with span("rebuild"):
                self._rebuild(snapshot, packed, node_sig, placed, unschedulable, pending_all, res_memo)
            return
        st = self.state
        for pod, node in placed:
            req = self.index.requests.of(pod, st.res_vocab)
            if req is None:
                # Should be unreachable (plan pre-checked the dirty set);
                # never poison the ledger — escalate instead.
                self.invalidate("vocab-change")
                continue
            st.commit(full_name(pod), node.name, req)
        if placed:
            self._placements_since_plan = True
        self._record_verdicts(st, snapshot, unschedulable, pending_all)
        st.delta_cycles_since_full += 1
        self.delta_cycles += 1
        self.skipped_total += plan.skipped
        self.dirty_sizes.append(len(plan.pods))
        if self.metrics is not None:
            self.metrics.inc("scheduler_delta_cycles_total")
            if plan.skipped:
                self.metrics.inc("scheduler_delta_skipped_pods_total", plan.skipped)
            self.metrics.observe("scheduler_delta_dirty_pods", float(len(plan.pods)))

    def _record_verdicts(self, st: SolveState, snapshot, unschedulable: list, pending_all: list) -> None:
        """Write this cycle's unschedulable verdicts into the ledger, each
        with its per-node blocking set (budgeted — beyond
        ``BLOCKING_BUDGET`` pod×node probes the rest record blocked=None
        and retire coarsely) and its constraint-entanglement flag.

        The controller hands in only the pods shown to fit no node: unlike
        the JAX package's, it leaves out the pods the cycle was cut off from
        (the auction's round cap or stall, the mop-up's work cap), so no
        verdict stands for them and the next plan keeps them dirty."""
        if not unschedulable:
            return
        by_full = {full_name(p): p for p in pending_all}
        budget = self.BLOCKING_BUDGET
        n_nodes = len(snapshot.nodes)
        for pf in unschedulable:
            p = by_full.get(pf)
            if p is None or p.spec is None:
                continue  # vanished mid-cycle; the DELETE event owns it
            constrained = verdict_constrained(p)
            blocked = None
            if not constrained and n_nodes and budget >= n_nodes:
                budget -= n_nodes
                blocked = blocking_nodes(p, snapshot)
            st.unsched[pf] = (bool(p.spec.pod_affinity), p.spec.gang or None, blocked, constrained)

    def _rebuild(self, snapshot, packed, node_sig, placed: list, unschedulable: list, pending_all: list, res_memo) -> None:
        """Reset the SolveState from a freshly solved full-wave cycle: the
        capacity pair is the exact sweep the pack ran on this snapshot
        (ops/pack._alloc_and_used64, memoized on it; copied, since the state
        writes into it) plus this cycle's commits, the placement ledger is
        the snapshot's placements plus those commits, written when it is
        first read (``SolveState.defer_placements``), and the verdict
        ledger restarts from this cycle's unschedulable set."""
        self.index.take()  # buffered events are already reflected in the snapshot
        self.generation += 1
        if packed is None or tuple(n.name for n in snapshot.nodes) != tuple(packed.node_names):
            # No packed axis to align to (an empty-pending escalation
            # cycle, or the cached pack predates node churn): stay cold —
            # the next packing cycle rebuilds against a fresh axis.
            self.state = None
            return
        from ..ops.pack import _alloc_and_used64, _resources

        vocab = packed.res_vocab
        alloc64, used64, row = _alloc_and_used64(snapshot, packed.padded_nodes, res_memo, vocab)
        st = SolveState(
            node_names=tuple(packed.node_names),
            node_sig=node_sig,
            res_vocab=vocab,
            res_scales=packed.res_scales,
            alloc64=alloc64.copy(),
            used64=used64.copy(),
            row=row,
            generation=self.generation,
        )
        memo = res_memo if res_memo is not None else {}
        on_nodes = snapshot.placed_pods()
        for pod, _node in on_nodes:
            hit = memo.get(id(pod))
            res = hit[1] if hit is not None and hit[0] is pod else _resources(pod, memo)
            if res.extended and _outside(res, vocab):
                self.state = None  # resource outside the vocab: stay cold
                return
        # This cycle's commits as SolveState.commit makes them one by one —
        # a pod naming a resource outside the vocabulary left out, a full
        # name's first commit counting — with their capacity added in
        # scatters; the ledger's entries are written when it is first read.
        # Two pods share a full name only without a namespace (one of them
        # at None, the other at ""), so only those are named here.
        commits: dict[int, tuple] = {}  # id(pod) -> (pod, node), in commit order
        loose: set[str] | None = None
        rows: list[int] = []
        cpu: list[int] = []
        mem: list[int] = []
        used64 = st.used64
        for pn in placed:
            pod, node = pn
            hit = memo.get(id(pod))
            res = hit[1] if hit is not None and hit[0] is pod else _resources(pod, memo)
            if (res.extended and _outside(res, vocab)) or id(pod) in commits:
                continue
            if not pod.metadata.namespace:
                if loose is None:
                    loose = {full_name(q) for q, _n in on_nodes if not q.metadata.namespace}
                pf = full_name(pod)
                if pf in loose:
                    continue
                loose.add(pf)
            commits[id(pod)] = pn
            r = row.get(node.metadata.name, -1)
            if r >= 0:
                rows.append(r)
                cpu.append(res.cpu)
                mem.append(res.memory)
                if res.extended:
                    for name, v in res.extended.items():
                        if v:
                            used64[r, vocab.index(name)] += v
        if rows:
            at = np.asarray(rows)
            np.add.at(used64[:, 0], at, np.asarray(cpu, dtype=np.int64))
            np.add.at(used64[:, 1], at, np.asarray(mem, dtype=np.int64))
        st.defer_placements(on_nodes, commits, self.index.requests)
        self._record_verdicts(st, snapshot, unschedulable, pending_all)
        self.state = st
        self._placements_since_plan = False

    # -- shadow parity ------------------------------------------------------

    def record_shadow(self, ok: bool | None, detail: str = "") -> None:
        """Record one shadow-solve comparison: True = parity held, False =
        the full solve placed a different pod set (a closure bug), None =
        the cycle was not comparable (bind failures / open breaker)."""
        if ok is None:
            self.shadow_skipped += 1
            return
        self.shadow_checks += 1
        if not ok:
            self.shadow_mismatches += 1
            if self.metrics is not None:
                self.metrics.inc("scheduler_delta_shadow_mismatches_total")
            logger.warning("delta shadow-solve parity MISMATCH: %s", detail)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime engine stats (GIL-atomic copies — safe from any thread;
        consumed by the sim scorecard, bench, and tests)."""
        sizes = list(self.dirty_sizes)
        return {
            "enabled": True,
            "generation": self.generation,
            "valid": self.state is not None and self._invalid_reason is None,
            "delta_cycles": self.delta_cycles,
            "full_solves": sum(self.full_solve_reasons.values()),
            "full_solve_reasons": dict(sorted(self.full_solve_reasons.items())),
            "skipped_total": self.skipped_total,
            "standing_verdicts": len(self.state.unsched) if self.state is not None else 0,
            "dirty_sizes": sizes,
            "shadow_checks": self.shadow_checks,
            "shadow_mismatches": self.shadow_mismatches,
            "shadow_skipped": self.shadow_skipped,
        }
