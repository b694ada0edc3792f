"""Scenario scorecard — one JSON verdict per simulated run.

Runs the framework's global invariants I1–I4 (the same checks
``tests/test_stress.py`` pins, made churn-aware) against the final cluster
state, plus the virtual-time SLOs a placement system is judged on:
time-to-bind percentiles, binding throughput per virtual second, the
pending backlog, and preemption/eviction churn.

Churn-awareness: a placement that was valid when made can look invalid
against the FINAL state after the node was re-tainted/cordoned or the pod's
gang was partially killed by a node failure — those placements are
verifiably disturbed, so I2/I4 skip them (counted, never silent) and I3
skips gangs with a churn-disturbed member.  Capacity (I1) has no such
escape: an oversubscribed node is a scheduler bug under any history.

``SCORECARD_FIELDS`` is the closed top-level schema; ``build_scorecard``
enforces it, and the README "Simulation & chaos" catalogue is drift-gated
against it by ``scripts/lint.py`` (the METR-gate pattern).

Port: a copy of ``tpu_scheduler/sim/scorecard.py`` over the port's
predicates, snapshot and ``learn/objective.policy_block``, with one change
of cost, not of result: I2's per-placement "final state minus this pod"
snapshot is sliced from the final snapshot's indexes (``_without``) rather
than rebuilt from every pod.
"""

from __future__ import annotations

import hashlib
import json

from ..core import predicates as P
from ..core.snapshot import ClusterSnapshot, node_allocatable, node_used_resources
from ..learn.objective import policy_block

__all__ = [
    "SCORECARD_FIELDS",
    "INCREMENTAL_FIELDS",
    "REBALANCE_FIELDS",
    "ELASTICITY_FIELDS",
    "LATENCY_FIELDS",
    "CONVERGENCE_FIELDS",
    "COMPILE_FIELDS",
    "check_invariants",
    "build_scorecard",
    "build_latency_block",
    "fingerprint",
]

# The closed top-level schema of a scorecard (drift-gated against README.md).
SCORECARD_FIELDS = (
    "scenario",
    "seed",
    "mode",
    "pass",
    "virtual_seconds",
    "cycles",
    "pods",
    "slo",
    "invariants",
    "chaos_injected",
    "resilience",
    "availability",
    "convergence",
    "locality",
    "profile",
    "compile",
    "incremental",
    "rebalance",
    "elasticity",
    "policy",
    "latency",
    "flight_recorder",
    "fingerprint",
)

# The closed schema of the ``incremental`` block (drift-gated against the
# README "Incremental scheduling" catalogue by the DLTA analyze rule).
# Strictly virtual/control-flow quantities: cycle counts, escalation-reason
# counts, dirty-set size percentiles, and the shadow-solve parity verdicts —
# never wall clock, so byte-identity and record→replay hold.
INCREMENTAL_FIELDS = (
    "enabled",
    "required",
    "delta_cycles",
    "full_solves",
    "full_solve_fraction",
    "escalations",
    "dirty_p50",
    "dirty_p95",
    "dirty_max",
    "skipped_pods",
    "standing_verdicts",
    "shadow_checks",
    "shadow_mismatches",
    "shadow_skipped",
    "shadow_parity_ok",
    "ok",
)

# The closed schema of the ``rebalance`` block (drift-gated against the
# README "Rebalancing & defragmentation" catalogue by the REBL analyze
# rule).  Strictly deterministic quantities: lifetime counts from the
# Rebalancer ledger, exact-integer packing stats over the FINAL cluster
# state, and the orphan evidence derived from the chaos unbind log — never
# wall clock, so byte-identity and record→replay hold.
REBALANCE_FIELDS = (
    "enabled",
    "required",
    "solves",
    "migrations",
    "completed",
    "skips",
    "nodes_drained",
    "pressure_releases",
    "unbinds_while_open",
    "orphaned_migrations",
    "packing_efficiency",
    "efficiency_gate",
    "stranded_frac",
    "occupied_nodes",
    "empty_nodes",
    "migration_budget",
    "preemption_churn",
    "whatif",
    "ok",
)


# The closed schema of the ``compile`` block.  In the port it counts CUDA
# kernel builds (nvcc runs, utils/profiler.compile_stats()["builds"]): the
# count may grow only during the warmup window; a single post-warmup build
# fails compile-required scenarios (the builds are cached by source digest,
# so a healthy run builds at most once per source, at its first launch).
# Deliberately environment-robust: the block carries the warmup-window
# LENGTH (scenario config) and the POST-warmup count (0 in any healthy run,
# warm or cold cache) but never the warmup count itself — that number
# differs between a cold record and a warm same-process replay, and the
# scorecard must stay bit-identical across record→replay (the same
# reasoning that keeps ``compile`` spans out of the profile block's census).
COMPILE_FIELDS = (
    "enabled",
    "required",
    "warmup_cycles",
    "post_warmup_compiles",
    "steady_flat",
    "ok",
)


# The closed schema of the ``elasticity`` block (drift-gated against the
# README "Autoscaling & elasticity" catalogue by the ELAS analyze rule).
# Strictly deterministic quantities: lifetime counts from the Autoscaler
# and SimCloudProvider ledgers, virtual provisioning lag, the node-hour
# cost integral of elastic capacity, and a joint cost+SLO objective whose
# SLO term charges still-pending pods their unmet age — so the static
# baseline fails the gate on merit.  The reclaim-orphan count (provider
# reclaim unbinds ∪ scale-down drain unbinds that ended pending or lost)
# is REQUIRED zero whenever the block gates at all.
ELASTICITY_FIELDS = (
    "enabled",
    "required",
    "scale_ups",
    "scale_downs",
    "skus",
    "pending_provisions",
    "provision_lag_p99_s",
    "reclaims",
    "reclaim_orphans",
    "quota_errors",
    "stockout_errors",
    "skips",
    "cost_node_hours",
    "joint_objective",
    "objective_gate",
    "ok",
)


# The closed schema of the ``convergence`` block (drift-gated against the
# README "Chaos fuzzing" catalogue by the FUZZ analyze rule).  The fuzzer's
# end-state quiescence oracle: after the last scheduled fault
# (``last_fault_t`` — the latest chaos-window end, replica kill, or rack
# failure) the backlog must drain (``pending_final`` == 0), every LIVE
# replica's deferred-bind buffer must flush (``deferred_residue`` == 0),
# no unexpired shard/replica/gang-reservation lease may be held by a dead
# replica (``stale_leases`` == 0), and the overtime the run spent settling
# past max(duration, last fault) must stay within ``settle_bound_s``.
# Strictly virtual-time quantities — byte-identity and record→replay hold.
CONVERGENCE_FIELDS = (
    "enabled",
    "required",
    "last_fault_t",
    "settle_overtime_s",
    "settle_bound_s",
    "pending_final",
    "deferred_residue",
    "stale_leases",
    "ok",
)


# The closed schema of the ``latency`` block (drift-gated against the README
# "Latency & time-to-bind" catalogue by the LATN analyze rule).  Strictly
# virtual-time quantities: every number derives from scheduler-clock ``t``
# stamps on flight-recorder events plus the harness's arrival ledger — never
# wall clock, so byte-identity and record→replay hold.
LATENCY_FIELDS = (
    "required",
    "ok",
    "measured",
    "coverage",
    "sum_to_ttb_ok",
    "max_sum_error_s",
    "cadence_wait_fraction",
    "segments",
    "tiers",
)


# shape: (samples: obj, bound_total: obj, required: obj, tol: obj) -> obj
def build_latency_block(
    samples: list[tuple[str, dict]],
    bound_total: int | None = None,
    required: bool = False,
    tol: float = 1e-6,
) -> dict:
    """Fold per-pod waterfalls (``utils/events.waterfall`` outputs, paired
    with their SLO tier) into the closed ``latency`` scorecard block.

    The audit that catches attribution leaks: every sample's segments +
    unattributed must sum to its TTB within ``tol`` — a timeline whose
    interval fell through the segment taxonomy fails ``sum_to_ttb_ok`` and,
    on latency-required scenarios, the run.  ``coverage`` (measured /
    bound_total) is reported for the latency-smoke gate but never fails the
    scorecard itself: a pod bound on the final cycle legitimately misses its
    confirm."""
    per_seg: dict[str, list[float]] = {}
    per_tier: dict[str, list[dict]] = {}
    ttbs: list[float] = []
    cadence_sum = 0.0
    max_err = 0.0
    for tier, wf in samples:
        err = abs(sum(wf["segments"].values()) + wf["unattributed"] - wf["ttb"])
        max_err = max(max_err, err)
        ttbs.append(wf["ttb"])
        cadence_sum += wf["segments"].get("cadence-wait", 0.0)
        per_tier.setdefault(tier, []).append(wf)
        for seg, v in wf["segments"].items():
            per_seg.setdefault(seg, []).append(v)

    def pcts(vals: list[float]) -> dict:
        s = sorted(vals)
        return {"p50_s": round(_percentile(s, 0.50), 6), "p99_s": round(_percentile(s, 0.99), 6)}

    measured = len(samples)
    ttb_total = sum(ttbs)
    sum_ok = max_err <= tol
    tiers = {
        tier: {
            "count": len(wfs),
            "ttb": pcts([w["ttb"] for w in wfs]),
            "segments": {seg: pcts([w["segments"][seg] for w in wfs]) for seg in sorted(per_seg)},
        }
        for tier, wfs in sorted(per_tier.items())
    }
    block = {
        "required": bool(required),
        "ok": sum_ok and (measured > 0 or not required),
        "measured": measured,
        "coverage": round(measured / bound_total, 6) if bound_total else None,
        "sum_to_ttb_ok": sum_ok,
        "max_sum_error_s": round(max_err, 9),
        "cadence_wait_fraction": round(cadence_sum / ttb_total, 6) if ttb_total > 0 else 0.0,
        "segments": {seg: pcts(vals) for seg, vals in sorted(per_seg.items())},
        "tiers": tiers,
    }
    assert tuple(block) == LATENCY_FIELDS, "latency block schema drifted from LATENCY_FIELDS"
    return block


def fingerprint(bind_log: list[tuple[float, str, str]], placements: list[tuple[str, str]]) -> str:
    """Determinism fingerprint: sha256 over the confirmed binding sequence
    (virtual time, pod, node — in POST order) and the final placement set.
    Two runs agree on this iff they made identical decisions."""
    h = hashlib.sha256()
    h.update(json.dumps(bind_log, sort_keys=False).encode())
    h.update(json.dumps(sorted(placements)).encode())
    return h.hexdigest()


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (deterministic, no
    interpolation-mode ambiguity)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _without(final: ClusterSnapshot, k: int, i: int) -> ClusterSnapshot:
    """``ClusterSnapshot.build(final.nodes, [q for q in final.pods if q is not
    pod])`` for ``pod = final.pods[k]``, the ``i``-th placement of ``final``:
    the same snapshot, derived from ``final``'s indexes by slicing instead of
    a rescan of every pod.  (The JAX scorecard rebuilds it from every pod,
    which makes I2 quadratic in the pod count.)  The other nodes' pod lists
    are shared, read-only."""
    pod = final.placed_pods()[i][0]
    by_node = dict(final._pods_by_node)
    by_node[pod.spec.node_name] = [q for q in by_node[pod.spec.node_name] if q is not pod]
    placed = final._placed[:i] + final._placed[i + 1 :]
    with_terms = final._placed_with_terms
    if pod.spec.anti_affinity:
        with_terms = [pn for pn in with_terms if pn[0] is not pod]
    return ClusterSnapshot(
        nodes=final.nodes,
        pods=final.pods[:k] + final.pods[k + 1 :],
        _pods_by_node=by_node,
        _placed=placed,
        _placed_with_terms=with_terms,
        topology=final.topology,
    )


def check_invariants(
    api,
    scheduled_names: set[str],
    disturbed_pods: set[str],
    disturbed_nodes: set[str],
    gangs: dict[str, set[str]],
) -> dict:
    """I1–I4 against the final API state.

    ``scheduled_names`` — pods the SCHEDULER placed (arrivals, not pre-bound
    seeds); ``disturbed_pods``/``disturbed_nodes`` — churn-touched objects
    whose placements are excluded from the order-dependent re-checks;
    ``gangs`` — gang name -> member pod names (full membership ever seen).
    """
    final = ClusterSnapshot.build(api.list_nodes(), api.list_pods())
    node_by = {n.name: n for n in final.nodes}
    out: dict = {}

    # I1 capacity — exact scalar arithmetic, no exclusions ever.
    over = [
        n.name
        for n in final.nodes
        if (lambda used, alloc: used.cpu > alloc.cpu or used.memory > alloc.memory)(
            node_used_resources(final, n.name), node_allocatable(n)
        )
    ]
    out["capacity"] = {"ok": not over, "oversubscribed_nodes": over}

    # I2 predicates — every undisturbed placement passes the order-free
    # scalar chain vs the final state minus itself (spread excluded: it is
    # order-dependent by construction; see tests/test_stress.py).
    order_free = [(r, pred) for r, pred in P.PREDICATE_CHAIN if r != P.InvalidNodeReason.TOPOLOGY_SPREAD_VIOLATION]
    checked = skipped = 0
    violations: list[str] = []
    pos = {id(p): k for k, p in enumerate(final.pods)}
    for i, (pod, node) in enumerate(final.placed_pods()):
        name = pod.metadata.name
        if name not in scheduled_names:
            continue
        if name in disturbed_pods or node.name in disturbed_nodes:
            skipped += 1
            continue
        checked += 1
        others = _without(final, pos[id(pod)], i)
        for reason, pred in order_free:
            if not pred(pod, node_by[node.name], others):
                violations.append(f"{name} on {node.name}: {reason.name}")
    out["predicates"] = {"ok": not violations, "checked": checked, "skipped_churned": skipped, "violations": violations[:20]}

    # I3 gang atomicity — an undisturbed gang is never partially ADMITTED:
    # no mix of bound and still-pending members.  Members that already
    # COMPLETED (bound, ran their lifetime, deleted) don't break atomicity —
    # admission was whole; they just finished at different times.
    placed_names = {p.metadata.name for p in final.pods if p.spec is not None and p.spec.node_name}
    pending_names = {p.metadata.name for p in final.pods if p.spec is None or not p.spec.node_name}
    g_checked = g_skipped = 0
    partial: list[str] = []
    for g, members in sorted(gangs.items()):
        if members & disturbed_pods:
            g_skipped += 1
            continue
        g_checked += 1
        n_placed = len(members & placed_names)
        n_pending = len(members & pending_names)
        if n_placed and n_pending:
            partial.append(f"{g}: {n_placed} bound / {n_pending} pending of {len(members)}")
    out["gangs"] = {"ok": not partial, "checked": g_checked, "skipped_churned": g_skipped, "partial": partial}

    # I4 selectors — nodeSelector / hard taints / required node affinity /
    # cordon on undisturbed placements (subsumed by I2; cheap triage).
    sel_bad: list[str] = []
    for pod, node in final.placed_pods():
        name = pod.metadata.name
        if name not in scheduled_names or name in disturbed_pods or node.name in disturbed_nodes:
            continue
        for reason, pred in P.NODE_LOCAL_PREDICATES:
            if not pred(pod, node_by[node.name], final):
                sel_bad.append(f"{name} on {node.name}: {reason.name}")
                break
    out["selectors"] = {"ok": not sel_bad, "violations": sel_bad[:20]}

    out["ok"] = all(out[k]["ok"] for k in ("capacity", "predicates", "gangs", "selectors"))
    return out


def build_scorecard(
    *,
    scenario: str,
    seed: int,
    mode: str,
    virtual_seconds: float,
    cycles: int,
    pod_counts: dict,
    ttb: list[float],
    backlog_pod_seconds: float,
    metrics_snapshot: dict,
    invariants: dict,
    chaos_injected: dict,
    resilience: dict,
    availability: dict,
    convergence: dict,
    locality: dict,
    profile: dict,
    compile: dict,
    incremental: dict,
    rebalance: dict,
    elasticity: dict,
    latency: dict,
    recorder_stats: dict,
    fp: str,
    policy_required: bool = False,
    policy_floor: float = 0.0,
) -> dict:
    """Assemble the one-JSON verdict.  Strictly virtual-time quantities —
    wall clock never appears, so the scorecard is bit-identical across runs
    and machines (the determinism acceptance criterion)."""
    ttb_sorted = sorted(ttb)
    slo = {
        "p50_time_to_bind_s": round(_percentile(ttb_sorted, 0.50), 6),
        "p99_time_to_bind_s": round(_percentile(ttb_sorted, 0.99), 6),
        "max_time_to_bind_s": round(ttb_sorted[-1], 6) if ttb_sorted else 0.0,
        "bound_per_virtual_second": round(len(ttb) / virtual_seconds, 4) if virtual_seconds > 0 else 0.0,
        "pending_backlog_pod_seconds": round(backlog_pod_seconds, 4),
        "preemption_churn": int(metrics_snapshot.get("scheduler_preemption_victims_total", 0))
        + int(metrics_snapshot.get("scheduler_noexecute_evictions_total", 0)),
        "requeues": int(metrics_snapshot.get("scheduler_requeues_total", 0)),
        "watch_errors": int(metrics_snapshot.get("scheduler_watch_errors_total", 0)),
    }
    # The policy objective (learn/objective.py): one scalar folded from the
    # blocks already computed above — nothing new is measured, so the
    # record→replay byte-identity contract is untouched.
    policy = policy_block(
        slo=slo,
        pod_counts=pod_counts,
        locality=locality,
        rebalance=rebalance,
        required=policy_required,
        floor=policy_floor,
    )
    card = {
        "scenario": scenario,
        "seed": seed,
        "mode": mode,
        # The degraded-mode invariant rides the verdict: a binding POST
        # through an OPEN circuit breaker is a resilience-layer bug even
        # when every placement invariant holds.  Locality-required scenarios
        # additionally gate on ZERO cross-rack gangs — a communication-
        # locality regression fails the run like an SLO regression does.
        # Multi-replica scenarios additionally gate on the availability
        # block's ok: zero double-binds, zero orphaned pods, and every
        # replica-kill's shard takeover within 2 x lease_duration.
        # Profile-required scenarios additionally gate on attribution
        # coverage ≥ 0.9 (the profile block): an unattributed cycle region
        # is an observability regression and fails the run.
        # Incremental-required scenarios additionally gate on the
        # incremental block's ok: shadow-solve parity on EVERY sampled
        # cycle and full_solve_fraction <= 0.10 — the delta path must stay
        # the default and provably equivalent.
        "pass": bool(
            invariants.get("ok")
            and pod_counts.get("lost", 1) == 0
            and pod_counts.get("double_bound", 1) == 0
            and resilience.get("binds_while_open", 0) == 0
            and not (locality.get("required") and locality.get("cross_rack_gangs", 0) != 0)
            and not (availability.get("enabled") and not availability.get("ok"))
            and not (profile.get("required") and not profile.get("coverage_ok"))
            # Compile-required scenarios additionally gate on the compile
            # block's ok: the XLA compile count must go FLAT after the
            # warmup window — one post-warmup compile is a shape-bucket
            # retrace leak (the runtime twin of the JITC static pass) and
            # fails the run like an SLO regression does.
            and not (compile.get("required") and not compile.get("ok"))
            and not (incremental.get("required") and not incremental.get("ok"))
            # Rebalance-required scenarios additionally gate on the
            # rebalance block's ok: final packing efficiency past the
            # scenario's gate within the migration budget, zero orphaned
            # migrations, zero deschedules through an open breaker, and a
            # consistent autoscaler what-if — a fragmentation regression
            # fails the run like an SLO regression does.
            and not (rebalance.get("required") and not rebalance.get("ok"))
            # Elasticity-required scenarios additionally gate on the
            # elasticity block's ok: the joint cost+SLO objective must
            # clear the scenario's gate AND the reclaim-orphan count must
            # be zero — a static fleet (or an autoscaler that buys its way
            # to the SLO at unbounded cost, or orphans a reclaimed pod)
            # fails the run like an SLO regression does.
            and not (elasticity.get("required") and not elasticity.get("ok"))
            # Policy-required scenarios additionally gate on the policy
            # block's ok: the learned-objective scalar must clear the
            # scenario's floor — a tuning run that wins one component by
            # wrecking another fails the run like an SLO regression does.
            and not (policy.get("required") and not policy.get("ok"))
            # Latency-required scenarios additionally gate on the latency
            # block's ok: waterfall segments must sum to TTB within
            # rounding on EVERY measured pod — an attribution leak is an
            # observability regression and fails the run.
            and not (latency.get("required") and not latency.get("ok"))
            # Convergence-required scenarios (the fuzzer's generated plans
            # and the lease-brownout scenario) additionally gate on the
            # convergence block's ok: after the last fault the backlog
            # drains, live deferred buffers flush, and no dead replica
            # holds an unexpired lease — a wedged end state fails the run.
            and not (convergence.get("required") and not convergence.get("ok"))
        ),
        "virtual_seconds": round(virtual_seconds, 6),
        "cycles": cycles,
        "pods": pod_counts,
        "slo": slo,
        "invariants": invariants,
        "chaos_injected": dict(sorted(chaos_injected.items())),
        "resilience": resilience,
        "availability": availability,
        "convergence": convergence,
        "locality": locality,
        "profile": profile,
        "compile": compile,
        "incremental": incremental,
        "rebalance": rebalance,
        "elasticity": elasticity,
        "policy": policy,
        "latency": latency,
        "flight_recorder": recorder_stats,
        "fingerprint": fp,
    }
    assert tuple(card) == SCORECARD_FIELDS, "scorecard schema drifted from SCORECARD_FIELDS"
    return card
