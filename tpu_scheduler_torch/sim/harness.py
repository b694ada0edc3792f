"""The simulation harness — a real ``Scheduler`` driven by virtual time.

One ``run_scenario`` call wires together:

  ``VirtualClock``  →  ``FakeApiServer(clock=...)``  →  ``ChaosApiServer``
                    →  ``Scheduler(clock=..., rng=seeded)``

and runs the discrete-event loop: apply every workload op due at the
current virtual time, run one scheduling cycle, fold the confirmed bindings
(time-to-bind, completion scheduling), advance the clock one cycle
interval.  Nothing sleeps; a 2-minute scenario with thousands of pods costs
seconds of wall clock.

Determinism: every randomness source is derived from the ONE scenario seed
(workload, chaos, scheduler/reflector jitter), all bookkeeping iterates in
sorted or insertion order, and the scorecard contains only virtual-time
quantities — the same ``--scenario --seed`` pair produces an identical
binding sequence and byte-identical scorecard JSON on every run.  With
``record=...`` the resolved op stream + chaos decision schedule persist to
JSONL (sim/trace.py); ``replay=...`` feeds them back and verifies the
fingerprint bit-matches the recorded footer.

Port: a copy of ``tpu_scheduler/sim/harness.py``.  The scheduler under
test is the port's ``Scheduler``, and the default backend is
``CudaBackend()`` on the card (the JAX harness defaults to NativeBackend):
without CUDA it raises ``BackendUnavailable``, and a run on the CPU must ask
for ``CudaBackend(device="cpu")``.  The cycles are bit-equal to the JAX
package's NumPy oracle, so an episode's fingerprint and scorecard are the
JAX sim's over NativeBackend.  It runs every registered scenario: one
replica or several, with the rebalancer, the autoscaler and its simulated
cloud provider where the scenario turns them on.
"""

from __future__ import annotations

import heapq
import random

from ..api.objects import is_pod_bound
from ..backends.cuda import CudaBackend
from ..models.profiles import DEFAULT_PROFILE
from ..runtime.fake_api import FakeApiServer
from ..testing import make_node, make_pod
from ..topology.locality import gang_placement_stats
from ..topology.model import DEFAULT_LEVEL_KEYS
from ..utils.events import waterfall
from ..utils.profiler import compile_listener_active, compile_stats, tier_of
from ..utils.tracing import base_name
from .chaos import ChaosApiServer
from .clock import VirtualClock
from .multi import MultiReplicaHarness
from .scenarios import SCENARIOS, Scenario
from .scorecard import (
    COMPILE_FIELDS,
    CONVERGENCE_FIELDS,
    ELASTICITY_FIELDS,
    _percentile,
    build_latency_block,
    build_scorecard,
    check_invariants,
    fingerprint,
)
from .trace import TraceWriter, load_trace
from .workload import generate_events, initial_nodes

__all__ = ["run_scenario", "scenario_episode", "EpisodeContext", "ReplayMismatchError"]


class ReplayMismatchError(RuntimeError):
    """A --replay run's fingerprint differs from the recorded footer."""

    def __init__(self, expected: str, got: str):
        super().__init__(f"replay fingerprint mismatch: recorded {expected[:16]}…, replayed {got[:16]}…")
        self.expected = expected
        self.got = got


class EpisodeContext:
    """What ``scenario_episode`` yields once per cycle, BEFORE the fleet
    steps: live references into the run (never copies — one episode, one
    world).  ``learn/env.py`` derives its observation from these; the plain
    ``run_scenario`` loop never looks at them, so ordinary runs pay
    nothing for the episode surface."""

    __slots__ = ("clock", "api", "chaos", "fleet", "state", "cycle")

    def __init__(self, clock, api, chaos, fleet, state, cycle: int):
        self.clock = clock
        self.api = api  # the inner FakeApiServer (truth, not the chaos shim)
        self.chaos = chaos
        self.fleet = fleet
        self.state = state
        self.cycle = cycle  # completed cycles so far (0 on the first yield)


class _SimState:
    """Run bookkeeping shared by record and replay paths."""

    def __init__(self):
        self.nodes: dict[str, dict] = {}  # live node name -> payload
        self.arrival_t: dict[str, float] = {}
        self.lifetime: dict[str, float] = {}
        self.live: set[str] = set()  # created, not deleted
        self.bound_live: set[str] = set()
        self.bind_epoch: dict[str, int] = {}
        self.gangs: dict[str, set[str]] = {}
        self.disturbed_pods: set[str] = set()
        self.disturbed_nodes: set[str] = set()
        self.scheduled_names: set[str] = set()
        # Topology bookkeeping: every node's domains (kept after delete —
        # a failed rack's placements still need scoring) and each pod's
        # FIRST bound node (bind-time locality; churn re-binds are the
        # disturbed set's business, not a locality verdict's).
        self.node_domains: dict[str, dict] = {}
        self.first_bind: dict[str, str] = {}
        self.counts = {"arrived": 0, "churn_recreated": 0, "completed": 0, "evicted": 0, "migrated": 0}
        self.ttb: list[float] = []
        self.tier: dict[str, str] = {}  # pod name -> SLO tier (from priority at arrival)
        self.double_bound = 0


def _resolve_scenario(scenario: Scenario | str) -> Scenario:
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown scenario {scenario!r} (known: {', '.join(sorted(SCENARIOS))})") from None


_LEVEL_LABEL = dict(DEFAULT_LEVEL_KEYS)  # level name -> node label key


def _node_obj(payload: dict, unschedulable: bool = False):
    labels = {"zone": payload["zone"], "name": payload["name"]}
    for level, key in DEFAULT_LEVEL_KEYS:
        if payload.get(level):
            # Topology-labeled fleets (WorkloadSpec slice_size/rack_size)
            # advertise their domains the kube-native way, which
            # topology-enables the scheduler under test (controller "auto").
            labels[key] = payload[level]
    return make_node(
        payload["name"],
        cpu=payload["cpu"],
        memory=f"{payload['mem_gi']}Gi",
        labels=labels,
        unschedulable=unschedulable,
    )


def _pod_obj(payload: dict):
    return make_pod(
        payload["name"],
        cpu=f"{payload['cpu_m']}m",
        memory=f"{payload['mem_mi']}Mi",
        priority=payload.get("priority", 0),
        labels={"app": payload.get("app", "app-0")},
        node_selector={"zone": payload["zone"]} if payload.get("zone") else None,
        gang=payload.get("gang"),
    )


def _profile_block(sc: Scenario, fleet: MultiReplicaHarness) -> dict:
    """The scorecard ``profile`` verdict: attribution coverage across the
    fleet's continuous profile rings (utils/profiler.py) plus the span
    CENSUS — per-path span counts with indexed segments collapsed to their
    base (``solve/round[03]`` → ``solve/round``).

    Deterministic by construction: span presence/counts are pure control
    flow (bit-identical under record/replay) and ``coverage_ok`` is a
    wide-margin boolean; raw durations never enter the scorecard (the
    byte-identity contract).  ``compile`` spans are excluded — XLA
    compile-cache state is environment, not scheduling."""
    census: dict[str, int] = {}
    cycles = 0
    wall = 0.0
    other = 0.0
    for r in fleet.scheds:
        snap = r.profile_ring.snapshot()
        cycles += snap["cycles"]
        wall += snap["wall_total_s"]
        other += snap["other_total_s"]
        for path, count in r.profile_ring.span_census().items():
            if "compile" in path:
                continue
            base = "/".join(base_name(seg) for seg in path.split("/"))
            census[base] = census.get(base, 0) + count
    return {
        "enabled": True,
        "required": bool(sc.profile_required),
        "coverage_ok": bool(wall <= 0 or (1.0 - other / wall) >= 0.9),
        "cycles": cycles,
        "span_census": dict(sorted(census.items())),
    }


def _compile_block(sc: Scenario, post_warmup_compiles: int, enabled: bool) -> dict:
    """The scorecard ``compile`` verdict — the runtime twin of the JITC
    static pass (scripts/analyze/jitc.py): after ``compile_warmup_cycles``
    cycles every shape bucket must already be traced, so a later XLA
    compile means a raw per-cycle dimension leaked into a jit signature.

    Deterministic by construction: the block carries only the warmup-window
    LENGTH and the POST-warmup compile count — never the warmup compile
    count itself, which differs between a cold record (every bucket traces)
    and a warm replay (the in-process cache is already primed).  A PASSING
    run has ``post_warmup_compiles == 0`` in both, so the gate preserves
    record→replay bit-identity.

    Port: the count is of kernel builds (nvcc runs, ``record_kernel_build``)
    after warm-up, ``enabled`` when the backend runs on the card
    (``compile_listener_active(backend)``).  On the CPU nothing is built, the
    count is vacuously zero and ``ok`` stays green, as under the JAX
    package's NativeBackend.  The builds are cached by source digest, so a
    card run builds at most once per source, inside the warm-up window."""
    flat = int(post_warmup_compiles) == 0
    out = {
        "enabled": bool(enabled),
        "required": bool(sc.compile_required),
        "warmup_cycles": int(sc.compile_warmup_cycles),
        "post_warmup_compiles": int(post_warmup_compiles),
        "steady_flat": flat,
        "ok": flat or not enabled,
    }
    assert tuple(out) == COMPILE_FIELDS, "compile block drifted from COMPILE_FIELDS"
    return out


# shape: (sc: obj, fleet: obj, st: obj) -> obj
def _latency_block(sc: Scenario, fleet: MultiReplicaHarness, st: "_SimState") -> dict:
    """The scorecard ``latency`` verdict: every undisturbed bound pod's
    flight-recorder timeline reduced to its waterfall (utils/events.py),
    anchored at the harness's nominal arrival time, folded by SLO tier.

    Deterministic by construction: the recorder stamps every event with the
    scheduler clock (``t``, virtual here) and ``waterfall`` reads only those
    stamps, so the whole block is bit-identical under record/replay.
    Multi-replica runs concatenate per-replica timelines for the same pod
    (a migrated pod's history lives on two recorders) in replica order and
    stably sort by ``t``."""
    timelines: dict[str, list[dict]] = {}
    for r in fleet.scheds:
        for pf in r.recorder.tracked_pods():
            timelines.setdefault(pf, []).extend(r.recorder.timeline(pf))
    samples: list[tuple[str, dict]] = []
    for pf in sorted(timelines):
        name = pf.rpartition("/")[2]
        if name in st.disturbed_pods or name not in st.arrival_t:
            continue
        tl = sorted(timelines[pf], key=lambda ev: float(ev.get("t", ev.get("ts", 0.0))))
        wf = waterfall(tl, arrival_t=st.arrival_t[name])
        if wf is None:
            continue
        samples.append((st.tier.get(name, "default"), wf))
    return build_latency_block(
        samples,
        bound_total=len(st.ttb),
        required=bool(sc.latency_required),
    )


def _incremental_block(sc: Scenario, fleet: MultiReplicaHarness) -> dict:
    """The scorecard ``incremental`` verdict (tpu_scheduler/delta):
    delta-vs-full cycle counts, escalation-reason tallies, dirty-set size
    percentiles, and the shadow-solve parity record, aggregated across the
    fleet.  Deterministic by construction — every quantity is control flow
    (cycle counts, set sizes, parity booleans), never wall clock.

    ``ok`` holds the incremental engine's contract: zero
    parity mismatches (with at least one check when sampling is on) and the
    full-wave solve staying the RARE path (fraction <= 0.10)."""
    engines = [r.delta for r in fleet.scheds if r.delta is not None]
    out = {
        "enabled": bool(engines),
        "required": bool(sc.incremental_required),
        "delta_cycles": 0,
        "full_solves": 0,
        "full_solve_fraction": 0.0,
        "escalations": {},
        "dirty_p50": 0,
        "dirty_p95": 0,
        "dirty_max": 0,
        "skipped_pods": 0,
        "standing_verdicts": 0,
        "shadow_checks": 0,
        "shadow_mismatches": 0,
        "shadow_skipped": 0,
        "shadow_parity_ok": True,
        "ok": True,
    }
    if not engines:
        out["ok"] = not sc.incremental_required
        return out
    sizes: list[int] = []
    escalations: dict[str, int] = {}
    for eng in engines:
        s = eng.stats()
        out["delta_cycles"] += s["delta_cycles"]
        out["full_solves"] += s["full_solves"]
        out["skipped_pods"] += s["skipped_total"]
        out["standing_verdicts"] += s["standing_verdicts"]
        out["shadow_checks"] += s["shadow_checks"]
        out["shadow_mismatches"] += s["shadow_mismatches"]
        out["shadow_skipped"] += s["shadow_skipped"]
        sizes.extend(s["dirty_sizes"])
        for reason, n in s["full_solve_reasons"].items():
            escalations[reason] = escalations.get(reason, 0) + n
    out["escalations"] = dict(sorted(escalations.items()))
    total = out["delta_cycles"] + out["full_solves"]
    if total:
        out["full_solve_fraction"] = round(out["full_solves"] / total, 6)
    sizes.sort()
    out["dirty_p50"] = int(_percentile(sizes, 0.50))
    out["dirty_p95"] = int(_percentile(sizes, 0.95))
    out["dirty_max"] = sizes[-1] if sizes else 0
    out["shadow_parity_ok"] = out["shadow_mismatches"] == 0
    out["ok"] = bool(
        out["shadow_parity_ok"]
        and out["full_solve_fraction"] <= 0.10
        and (out["shadow_checks"] > 0 or sc.delta_shadow_every <= 0)
    )
    return out


def _rebalance_block(
    sc: Scenario,
    fleet: MultiReplicaHarness,
    inner,
    chaos,
    pending_final,
    lost_names,
    open_iv_by_replica,
    enabled: bool,
    slo_churn: int,
) -> dict:
    """The scorecard ``rebalance`` verdict (tpu_scheduler/rebalance).

    Packing efficiency / stranded capacity are computed from the FINAL API
    state with the same exact-integer capacity math the rebalancer itself
    packs with — so the rebalancer-OFF baseline gets the identical verdict
    surface and must fail the same gate.  Orphan evidence comes from the
    chaos unbind log vs the final state: a pod ever descheduled that ends
    the run neither bound nor legitimately gone is an orphaned migration
    (the acceptance quantity chaos variants hold at zero), and a
    deschedule POSTed inside its OWN replica's breaker-open interval is a
    degraded-mode bug counted in ``unbinds_while_open``."""
    from ..core.snapshot import ClusterSnapshot
    from ..rebalance import REBALANCE_CORDON_LABEL, RebalanceSnapshot, packing_stats

    rebs = [r.rebalancer for r in fleet.scheds if r.rebalancer is not None]
    out = {
        "enabled": bool(rebs),
        "required": bool(sc.rebalance_required),
        "solves": 0,
        "migrations": 0,
        "completed": 0,
        "skips": {},
        "nodes_drained": 0,
        "pressure_releases": 0,
        "unbinds_while_open": 0,
        "orphaned_migrations": 0,
        "packing_efficiency": 1.0,
        "efficiency_gate": round(float(sc.rebalance_efficiency_gate), 6),
        "stranded_frac": 0.0,
        "occupied_nodes": 0,
        "empty_nodes": 0,
        "migration_budget": int(sc.rebalance_migration_budget),
        "preemption_churn": int(slo_churn),
        "whatif": None,
        "ok": True,
    }
    skips: dict[str, int] = {}
    for reb in rebs:
        s = reb.stats()
        out["solves"] += s["solves"]
        out["migrations"] += s["executed"]
        out["completed"] += s["completed"]
        out["nodes_drained"] += s["nodes_drained"]
        out["pressure_releases"] += s["pressure_releases"]
        for k, v in s["skips"].items():
            skips[k] = skips.get(k, 0) + v
    out["skips"] = dict(sorted(skips.items()))
    final = ClusterSnapshot.build(inner.list_nodes(), inner.list_pods())
    rs = RebalanceSnapshot.build(final)
    stats = packing_stats(rs.alloc, rs.used)
    out["packing_efficiency"] = stats["efficiency"]
    out["stranded_frac"] = stats["stranded_frac"]
    out["occupied_nodes"] = stats["occupied_nodes"]
    out["empty_nodes"] = stats["empty_nodes"]
    unbound_names = {pf.rpartition("/")[2] for _t, pf in chaos.unbind_log}
    pending_names = {p.metadata.name for p in pending_final}
    out["orphaned_migrations"] = len(unbound_names & (pending_names | set(lost_names)))
    out["unbinds_while_open"] = sum(
        1
        for (t, _pf), actor in zip(chaos.unbind_log, chaos.unbind_actors)
        if any(s < t < e for s, e in open_iv_by_replica[actor])
    )
    if sc.rebalance_whatif:
        from ..rebalance import autoscaler_whatif

        drained_labeled = sum(
            1 for n in final.nodes if (n.metadata.labels or {}).get(REBALANCE_CORDON_LABEL)
        )
        out["whatif"] = autoscaler_whatif(final, pending_final, drained_labeled=drained_labeled)
    gate = out["efficiency_gate"]
    budget = out["migration_budget"]
    whatif = out["whatif"]
    out["ok"] = bool(
        (gate <= 0 or out["packing_efficiency"] >= gate)
        and (budget <= 0 or out["migrations"] <= budget)
        and out["orphaned_migrations"] == 0
        and out["unbinds_while_open"] == 0
        and (
            whatif is None
            or whatif["pending_unplaceable"] == 0
            or whatif["nodes_needed"] >= 1
        )
    )
    if not enabled and not sc.rebalance_required:
        out["ok"] = True  # a scenario without the tier has nothing to judge
    return out


def _locality_block(sc: Scenario, st: "_SimState") -> dict:
    """The scorecard ``locality`` verdict: per-gang placement-distance
    statistics over FIRST-bind placements (bind-time locality — churn
    re-binds belong to the disturbed set, which is skipped here exactly like
    I2/I3 skip it: counted, never silent).  ``cross_rack_gangs`` is the
    number the pass gate holds at zero for ``locality_required`` scenarios —
    a locality regression fails a run the same way an SLO regression does."""
    levels = [level for level, _k in DEFAULT_LEVEL_KEYS if any(level in d for d in st.node_domains.values())]
    out = {
        "enabled": bool(levels),
        "required": bool(sc.locality_required),
        "levels": levels,
        "gangs_scored": 0,
        "gangs_skipped_churned": 0,
        "gangs_unscored": 0,
        "max_distance": 0.0,
        "mean_distance": 0.0,
        "cross_rack_edges": 0,
        "cross_rack_gangs": 0,
        "single_domain_gangs": 0,
    }
    if not levels:
        return out
    level_dists = [1.0] * len(levels)
    means: list[float] = []
    for g, members in sorted(st.gangs.items()):
        if members & st.disturbed_pods:
            out["gangs_skipped_churned"] += 1
            continue
        doms = []
        for m in sorted(members):
            node = st.first_bind.get(m)
            nd = st.node_domains.get(node) if node is not None else None
            if nd is None:
                doms = None
                break
            doms.append(tuple(nd.get(level, f"~{node}") for level in levels))
        if doms is None or len(doms) < 2:
            # Never admitted (or a 1-member tail) — nothing to score; the
            # SLO/backlog numbers already account for unplaced demand.
            out["gangs_unscored"] += 1
            continue
        stats = gang_placement_stats(doms, level_dists)
        out["gangs_scored"] += 1
        out["max_distance"] = max(out["max_distance"], stats["max_distance"])
        means.append(stats["mean_distance"])
        out["cross_rack_edges"] += stats["cross_edges"]
        if stats["cross_edges"]:
            out["cross_rack_gangs"] += 1
        elif stats["max_distance"] == 0.0:
            out["single_domain_gangs"] += 1
    if means:
        out["mean_distance"] = round(sum(means) / len(means), 6)
    return out


def _elasticity_block(
    sc: Scenario,
    fleet: MultiReplicaHarness,
    pending_final,
    lost_names,
    end_t: float,
    st: "_SimState",
    enabled: bool,
) -> dict:
    """The scorecard ``elasticity`` verdict (tpu_scheduler/autoscale).

    The joint objective is computed from the SAME surface whether the
    autoscaler ran or not: effective p99 time-to-bind — every bound pod's
    TTB plus every still-pending pod charged its unmet age at episode end —
    plus ``autoscale_cost_weight`` × the provider's elastic node-hour cost
    integral (zero for the static fleet).  So the ``autoscale=False``
    baseline gets the identical verdict surface and must fail the same
    gate on merit: it pays no cost but its unserved backlog's effective
    p99 blows the objective.  Reclaim-orphan evidence: any pod the
    provider force-unbound at a reclaim deadline (or the autoscaler
    unbound while draining a scale-down candidate) that ends the run
    neither bound nor legitimately gone — REQUIRED zero whenever the
    block gates at all."""
    autos = [r.autoscaler for r in fleet.scheds if r.autoscaler is not None]
    provider = fleet.provider
    out = {
        "enabled": bool(enabled and provider is not None),
        "required": bool(sc.autoscale_required),
        "scale_ups": {},
        "scale_downs": {},
        "skus": {},
        "pending_provisions": 0,
        "provision_lag_p99_s": 0.0,
        "reclaims": 0,
        "reclaim_orphans": 0,
        "quota_errors": 0,
        "stockout_errors": 0,
        "skips": {},
        "cost_node_hours": 0.0,
        "joint_objective": 0.0,
        "objective_gate": round(float(sc.autoscale_objective_gate), 6),
        "ok": True,
    }
    ups: dict[str, int] = {}
    downs: dict[str, int] = {}
    skips: dict[str, int] = {}
    unbound_short: set[str] = set()
    for auto in autos:
        s = auto.stats()
        for k, v in s["scale_ups"].items():
            ups[k] = ups.get(k, 0) + v
        for k, v in s["scale_downs"].items():
            downs[k] = downs.get(k, 0) + v
        for k, v in s["skips"].items():
            skips[k] = skips.get(k, 0) + v
        unbound_short.update(pf.rpartition("/")[2] for pf in auto.drain_unbound)
    out["scale_ups"] = dict(sorted(ups.items()))
    out["scale_downs"] = dict(sorted(downs.items()))
    out["skips"] = dict(sorted(skips.items()))
    if provider is not None:
        pstats = provider.stats()
        out["skus"] = pstats["skus"]
        out["pending_provisions"] = pstats["pending_provisions"]
        out["reclaims"] = pstats["reclaim_notices"]
        out["quota_errors"] = pstats["quota_errors"]
        out["stockout_errors"] = pstats["stockout_errors"]
        lags = sorted(provider.provision_lags())
        out["provision_lag_p99_s"] = round(_percentile(lags, 0.99), 6)
        out["cost_node_hours"] = round(provider.cost_node_hours(end_t), 6)
        unbound_short.update(pf.rpartition("/")[2] for pf in provider.reclaim_unbound)
    pending_names = {p.metadata.name for p in pending_final}
    out["reclaim_orphans"] = len(unbound_short & (pending_names | set(lost_names)))
    # Effective p99 TTB: the SLO term no fleet can game by refusing to
    # bind — unserved demand is charged its full unmet age.
    eff = sorted(
        st.ttb
        + [end_t - st.arrival_t[p.metadata.name] for p in pending_final if p.metadata.name in st.arrival_t]
    )
    joint = _percentile(eff, 0.99) + float(sc.autoscale_cost_weight) * out["cost_node_hours"]
    out["joint_objective"] = round(joint, 6)
    gate = out["objective_gate"]
    out["ok"] = bool((gate <= 0 or out["joint_objective"] <= gate) and out["reclaim_orphans"] == 0)
    assert tuple(out) == ELASTICITY_FIELDS, "elasticity block drifted from ELASTICITY_FIELDS"
    return out


# shape: (sc: obj, fleet: obj, inner: obj, pending_final: obj, end_t: float) -> obj
def _convergence_block(sc: Scenario, fleet: MultiReplicaHarness, inner, pending_final, end_t: float) -> dict:
    """The scorecard ``convergence`` verdict — the fuzzer's end-state
    quiescence oracle (sim/fuzz).  After the last scheduled fault
    (latest chaos-window end, replica kill, or rack failure) the run must
    settle: backlog drained, every LIVE replica's deferred-bind buffer
    flushed, and no unexpired shard/replica/gang-reservation lease held by
    a dead replica (a crashed owner's leases stop renewing and expire
    within one TTL, so a settled fleet counts zero).  The shard-map lease
    is excluded — its holder is the map payload, not a replica identity.
    ``settle_overtime_s`` is the virtual time spent past
    max(duration, last fault); the loop's drain-grace exit bounds it, and
    the bound here re-derives that cap so a wedged run is named, not
    silently truncated.  Deterministic by construction: every quantity is
    virtual time or control flow."""
    from ..fleet import GANG_RESERVATION_PREFIX, SHARD_MAP_LEASE
    from ..runtime.shards import REPLICA_LEASE_PREFIX, SHARD_LEASE_PREFIX

    last_fault = 0.0
    for w in sc.chaos.windows:
        last_fault = max(last_fault, float(w.end))
    for t, _idx in sc.replica_kills:
        last_fault = max(last_fault, float(t))
    for t in sc.workload.rack_fail_times:
        last_fault = max(last_fault, float(t))
    # The settle bound the loop itself enforces: one drain-grace stretch of
    # no-progress cycles plus two lease TTLs for takeover/expiry tails.
    settle_bound = 2.0 * float(sc.lease_duration) + float(sc.drain_grace_cycles) * float(sc.cycle_interval)
    overtime = max(0.0, end_t - max(float(sc.duration), last_fault))
    deferred = sum(len(r.deferred_binds) for i, r in enumerate(fleet.scheds) if fleet.alive[i])
    live = {r.identity for i, r in enumerate(fleet.scheds) if fleet.alive[i] and getattr(r, "identity", None)}
    stale = 0
    lister = getattr(inner, "list_lease_summaries", None)
    if lister is not None:
        for info in lister():
            name = info["name"]
            if name == SHARD_MAP_LEASE:
                continue
            if not name.startswith((SHARD_LEASE_PREFIX, REPLICA_LEASE_PREFIX, GANG_RESERVATION_PREFIX)):
                continue
            if info.get("holder") and info["holder"] not in live and end_t < float(info.get("expires", 0.0)):
                stale += 1
    out = {
        "enabled": True,
        "required": bool(sc.convergence_required),
        "last_fault_t": round(last_fault, 6),
        "settle_overtime_s": round(overtime, 6),
        "settle_bound_s": round(settle_bound, 6),
        "pending_final": len(pending_final),
        "deferred_residue": int(deferred),
        "stale_leases": stale,
        "ok": bool(
            len(pending_final) == 0 and deferred == 0 and stale == 0 and overtime <= settle_bound + 1e-9
        ),
    }
    assert tuple(out) == CONVERGENCE_FIELDS, "convergence block drifted from CONVERGENCE_FIELDS"
    return out


def run_scenario(
    scenario: Scenario | str,
    seed: int = 0,
    backend=None,
    record: str | None = None,
    replay: str | None = None,
    events_buffer: int = 4096,
    topology="auto",
    profile_gates: dict | None = None,
    rebalance="auto",
    autoscale="auto",
    profile=None,
) -> dict:
    """Run one scenario to its verdict; returns the scorecard dict.

    ``record`` persists the run as a JSONL trace; ``replay`` re-runs a trace
    (its header names the scenario) and raises ``ReplayMismatchError`` if
    the replayed fingerprint differs from the recorded one.  ``topology``
    passes through to the Scheduler: "auto" (default) detects the workload's
    slice/rack node labels, None runs the topology-BLIND baseline the
    locality scorecard block quantifies against.  ``profile_gates`` (a dict,
    filled in place) receives the WALL-derived profiler gate inputs —
    aggregate attribution coverage and the measured overhead estimate —
    which are deliberately kept OFF the scorecard (it must stay
    byte-identical across runs); `sim --profile-check` consumes them.
    ``rebalance`` mirrors the topology switch for the background defrag
    tier: "auto" (default) follows the scenario's ``rebalance`` knob,
    False forces the rebalancer-OFF baseline the fragmentation scorecard
    block quantifies against (and must FAIL the efficiency gate).
    ``autoscale`` is the same switch for the elastic-capacity tier:
    "auto" follows the scenario's ``autoscale`` knob, False forces the
    static-fleet baseline the elasticity scorecard block quantifies
    against (and must FAIL the joint cost+SLO objective gate).
    ``profile`` overrides the ``SchedulingProfile`` the fleet schedules
    with (None = the default, exactly as before — fingerprints hold); a
    scenario's ``preemption`` knob still applies on top."""
    gen = scenario_episode(
        scenario,
        seed=seed,
        backend=backend,
        record=record,
        replay=replay,
        events_buffer=events_buffer,
        topology=topology,
        profile_gates=profile_gates,
        rebalance=rebalance,
        autoscale=autoscale,
        profile=profile,
    )
    # Drive the episode with no per-cycle actions — byte-identical to the
    # pre-generator loop; the gym-style surface (learn/env.py) is the only
    # caller that ever sends one.
    try:
        next(gen)
        while True:
            gen.send(None)
    except StopIteration as stop:
        return stop.value


def scenario_episode(
    scenario: Scenario | str,
    seed: int = 0,
    backend=None,
    record: str | None = None,
    replay: str | None = None,
    events_buffer: int = 4096,
    topology="auto",
    profile_gates: dict | None = None,
    rebalance="auto",
    autoscale="auto",
    profile=None,
):
    """The discrete-event loop as a generator: yields an ``EpisodeContext``
    once per cycle (after due ops apply, BEFORE the fleet steps) and accepts
    an optional ``SchedulingProfile`` in return, installed fleet-wide for
    the next cycle window (the controller reads its profile fresh every
    cycle).  Returns the scorecard via ``StopIteration.value``.  Same
    determinism contract as ``run_scenario`` — the yield exchanges no
    randomness, so a None-action drive is bit-identical to the plain run."""
    replay_data = load_trace(replay) if replay else None
    if replay_data is not None:
        sc = _resolve_scenario(replay_data["header"]["scenario"])
        seed = int(replay_data["header"]["seed"])
    else:
        sc = _resolve_scenario(scenario)

    clock = VirtualClock()
    inner = FakeApiServer(watch_history=sc.watch_history, clock=clock)
    chaos = ChaosApiServer(
        inner,
        sc.chaos,
        rng=random.Random(f"{seed}:chaos"),
        clock=clock,
        replay_decisions=replay_data["chaos"] if replay_data else None,
    )
    backend = backend or CudaBackend()
    profile = profile if profile is not None else DEFAULT_PROFILE
    if sc.preemption and not profile.preemption:
        profile = profile.with_(preemption=True)
    # One harness regardless of replica count: replicas == 1 constructs the
    # scheduler exactly as the single-replica path always did (same rng
    # label, no shard machinery), so pre-sharding fingerprints hold.
    rebalance_on = bool(getattr(sc, "rebalance", False)) and rebalance is not False
    autoscale_on = bool(getattr(sc, "autoscale", False)) and autoscale is not False
    fleet = MultiReplicaHarness(
        sc,
        seed,
        clock,
        chaos,
        backend,
        profile,
        events_buffer,
        topology,
        rebalance_on=rebalance_on,
        autoscale_on=autoscale_on,
    )

    writer = TraceWriter(record) if record else None
    if writer:
        writer.header(sc.name, seed, backend.name)

    st = _SimState()
    # Timed internal ops (record mode only): completions + flap returns.
    future: list[tuple[float, int, dict]] = []
    fseq = 0

    def push_future(t: float, op: dict) -> None:
        nonlocal fseq
        fseq += 1
        heapq.heappush(future, (t, fseq, op))

    # -- op application (the ONE mutation path; every applied op is traced) --

    def apply_op(op: dict) -> None:
        kind = op["op"]
        now = clock.now
        if kind == "create_pod":
            p = op["pod"]
            name = p["name"]
            inner.create_pod(_pod_obj(p))
            st.live.add(name)
            st.scheduled_names.add(name)
            # SLO clock starts at the event's nominal arrival ("at"), not at
            # application: a pod arriving between cycles queues until the
            # next one, and that queueing delay is real time-to-bind.
            st.arrival_t[name] = float(op.get("at", now))
            st.tier[name] = tier_of(int(p.get("priority", 0)))
            if p.get("lifetime_s"):
                st.lifetime[name] = float(p["lifetime_s"])
            if p.get("gang"):
                st.gangs.setdefault(p["gang"], set()).add(name)
            if op.get("churned"):
                st.counts["churn_recreated"] += 1
                st.disturbed_pods.add(name)
            else:
                st.counts["arrived"] += 1
        elif kind == "delete_pod":
            name = op["name"]
            inner.delete_pod("default", name)
            st.live.discard(name)
            st.bound_live.discard(name)
            if op.get("reason") == "completed":
                st.counts["completed"] += 1
        elif kind == "create_node":
            payload = op["node"]
            inner.create_node(_node_obj(payload))
            st.nodes[payload["name"]] = payload
            doms = {level: payload[level] for level, _k in DEFAULT_LEVEL_KEYS if payload.get(level)}
            if doms:
                st.node_domains[payload["name"]] = doms
        elif kind == "delete_node":
            inner.delete_node(op["name"])
            st.nodes.pop(op["name"], None)
            st.disturbed_nodes.add(op["name"])
        elif kind == "cordon":
            payload = st.nodes[op["name"]]
            inner.update_node(_node_obj(payload, unschedulable=True))
            st.disturbed_nodes.add(op["name"])
        else:
            raise ValueError(f"unknown sim op {kind!r}")
        if writer:
            writer.action(now, op)

    def evict_node_pods(node_name: str, recreate: bool) -> None:
        """Delete every pod bound to the node; optionally re-arrive them as
        fresh Pending pods (the ReplicaSet stand-in).  Sorted for
        determinism; bindings in flight are impossible (single-threaded)."""
        from ..api.objects import total_pod_resources

        for pod in sorted(inner.list_pods(f"spec.nodeName={node_name}"), key=lambda p: p.metadata.name):
            name = pod.metadata.name
            req = total_pod_resources(pod)
            spec = {
                "name": name,
                "cpu_m": int(req.cpu),  # PodResources carries millicores
                "mem_mi": int(req.memory // (1 << 20)),
                "priority": pod.spec.priority if pod.spec else 0,
                "app": (pod.metadata.labels or {}).get("app", "app-0"),
            }
            if pod.spec is not None and pod.spec.gang:
                spec["gang"] = pod.spec.gang
            if pod.spec is not None and pod.spec.node_selector:
                spec["zone"] = pod.spec.node_selector.get("zone")
            if name in st.lifetime:
                spec["lifetime_s"] = st.lifetime[name]
            apply_op({"op": "delete_pod", "name": name, "reason": "churn"})
            st.disturbed_pods.add(name)
            if recreate:
                apply_op({"op": "create_pod", "pod": spec, "churned": True})

    def resolve_event(ev) -> None:
        """Turn one generated workload event into concrete ops (record mode)."""
        if ev.kind == "pods":
            for p in ev.payload["pods"]:
                apply_op({"op": "create_pod", "pod": p, "at": ev.t})
            return
        if ev.kind == "node-add":
            if ev.payload["name"] not in st.nodes:
                apply_op({"op": "create_node", "node": dict(ev.payload)})
            return
        if ev.kind == "rack-fail":
            # Whole-rack outage: resolve "pick" against the sorted live rack
            # list, then fail every node in it (each op recorded
            # individually, so replay stays bit-identical).
            rack_nodes: dict[str, list[str]] = {}
            for name in sorted(st.nodes):
                rack = st.nodes[name].get("rack")
                if rack:
                    rack_nodes.setdefault(rack, []).append(name)
            racks = sorted(rack_nodes)
            if not racks:
                return
            target = racks[int(ev.payload["pick"] * len(racks)) % len(racks)]
            for name in rack_nodes[target]:
                evict_node_pods(name, recreate=True)
                apply_op({"op": "delete_node", "name": name})
            return
        # Node-targeting events resolve "pick" against the sorted live fleet.
        names = sorted(st.nodes)
        if not names:
            return
        target = names[int(ev.payload["pick"] * len(names)) % len(names)]
        if ev.kind == "node-drain":
            evict_node_pods(target, recreate=True)
            apply_op({"op": "cordon", "name": target})
        elif ev.kind == "node-fail":
            evict_node_pods(target, recreate=True)
            apply_op({"op": "delete_node", "name": target})
        elif ev.kind == "node-flap":
            payload = st.nodes[target]
            evict_node_pods(target, recreate=True)
            apply_op({"op": "delete_node", "name": target})
            push_future(clock.now + float(ev.payload["down_s"]), {"op": "create_node", "node": payload})
        else:
            raise ValueError(f"unknown workload event {ev.kind!r}")

    # -- initial fleet + event stream ---------------------------------------

    if replay_data is not None:
        actions = replay_data["actions"]
        events = []
    else:
        actions = []
        events = generate_events(sc.workload, sc.duration, random.Random(f"{seed}:workload"))
        for payload in initial_nodes(sc.workload):
            apply_op({"op": "create_node", "node": payload})
    ai = ei = 0  # replay: actions (incl. the t=0 fleet) apply in the loop

    # -- bind folding --------------------------------------------------------

    bind_cursor = 0
    evict_cursor = 0
    unbind_cursor = 0

    def fold_outcomes() -> int:
        """Fold chaos logs since the last cycle: time-to-bind, completion
        scheduling, double-bind detection, sanctioned evictions, and
        rebalancer deschedules (a migrated pod leaves the bound set so its
        re-bind is a migration completing, never a double-bind)."""
        nonlocal bind_cursor, evict_cursor, unbind_cursor
        new_binds = 0
        for t, pod_full, _node in chaos.bind_log[bind_cursor:]:
            name = pod_full.rpartition("/")[2]
            if name in st.bound_live:
                st.double_bound += 1
            st.bound_live.add(name)
            st.bind_epoch[name] = st.bind_epoch.get(name, 0) + 1
            st.first_bind.setdefault(name, _node)
            if name in st.arrival_t:
                st.ttb.append(round(t - st.arrival_t[name], 9))
            if replay_data is None and name in st.lifetime:
                epoch = st.bind_epoch[name]
                push_future(t + st.lifetime[name], {"op": "delete_pod", "name": name, "reason": "completed", "_epoch": epoch})
            new_binds += 1
        bind_cursor = len(chaos.bind_log)
        for _t, pod_full in chaos.evict_log[evict_cursor:]:
            name = pod_full.rpartition("/")[2]
            if name in st.live:
                st.live.discard(name)
                st.bound_live.discard(name)
                st.disturbed_pods.add(name)
                st.counts["evicted"] += 1
        evict_cursor = len(chaos.evict_log)
        # Rebalancer deschedules happen AFTER the cycle's binds (the tick
        # runs at cycle end), so draining them after the bind fold keeps
        # intra-cycle order: unbound pods re-enter pending and their next
        # bind re-adds them above.
        restarts = _forced_restarts()
        for _t, pod_full in chaos.unbind_log[unbind_cursor:]:
            name = pod_full.rpartition("/")[2]
            st.bound_live.discard(name)
            st.counts["migrated"] += 1
            # A spot reclaim or autoscale drain is a forced RESTART, not a
            # scheduling decision: the TTB clock restarts at eviction, so
            # the scorecard judges how fast the fleet re-places the pod —
            # not the cloud's choice of when to take the node away.
            # (Rebalancer migrations keep the original clock: the
            # scheduler chose those.)
            if pod_full in restarts and name in st.arrival_t:
                st.arrival_t[name] = _t
                st.disturbed_pods.add(name)
        unbind_cursor = len(chaos.unbind_log)
        return new_binds

    def _forced_restarts() -> set[str]:
        # shape: () -> set[str]  (full pod names force-unbound by the
        # provider's reclaim kill path or an autoscaler scale-down drain)
        out: set[str] = set()
        if getattr(fleet, "provider", None) is not None:
            out.update(fleet.provider.reclaim_unbound)
        for sched in fleet.scheds:
            if sched.autoscaler is not None:
                out.update(sched.autoscaler.drain_unbound)
        return out

    # -- the discrete-event loop --------------------------------------------

    cycles = 0
    no_progress = 0
    max_pending = 0
    # Compile-flatness bookkeeping: the process-global compile count at the
    # warmup-cycle boundary.  None until the run crosses it (a run shorter
    # than the warmup window is all-warmup: post-warmup count 0).
    warmup_compile_mark: int | None = None
    hard_cap = int(3 * sc.duration / sc.cycle_interval) + 400
    while True:
        now = clock.now
        if replay_data is not None:
            while ai < len(actions) and actions[ai][0] <= now:
                try:
                    apply_op(actions[ai][1])
                except Exception as e:
                    # A recorded op that no longer applies means the trace is
                    # corrupt or the world diverged — name it, don't 404.
                    raise RuntimeError(
                        f"trace replay diverged applying action {ai} ({actions[ai][1].get('op')!r}): {e}"
                    ) from e
                ai += 1
        else:
            while future and future[0][0] <= now:
                _t, _s, op = heapq.heappop(future)
                epoch = op.pop("_epoch", None)
                if op["op"] == "delete_pod":
                    name = op["name"]
                    # A completion for an earlier life of the pod (churn
                    # recreated it since) or a pod evicted meanwhile: skip.
                    if name not in st.bound_live or (epoch is not None and st.bind_epoch.get(name) != epoch):
                        continue
                elif op["op"] == "create_node" and op["node"]["name"] in st.nodes:
                    continue  # flap return raced a node-add; keep the live one
                apply_op(op)
            while ei < len(events) and events[ei].t <= now:
                resolve_event(events[ei])
                ei += 1

        # The episode surface: hand the cycle to the caller; a returned
        # profile applies fleet-wide from this cycle on (the controller
        # reads ``self.profile`` fresh each cycle, so installation is just
        # attribute assignment — zero cost on the None-action path).
        action = yield EpisodeContext(clock, inner, chaos, fleet, st, cycles)
        if action is not None:
            for sched in fleet.scheds:
                sched.profile = action

        fleet.step()
        cycles += 1
        if warmup_compile_mark is None and cycles >= sc.compile_warmup_cycles:
            warmup_compile_mark = int(compile_stats()["builds"])
        new_binds = fold_outcomes()
        pending = len(inner.list_pods("status.phase=Pending"))
        max_pending = max(max_pending, pending)
        if writer:
            writer.cycle(clock.now, cycles, new_binds, pending)
        no_progress = 0 if (new_binds or pending == 0) else no_progress + 1
        if clock.now >= sc.duration:
            events_done = (ai >= len(actions)) if replay_data is not None else (ei >= len(events))
            if events_done and (pending == 0 or no_progress >= sc.drain_grace_cycles):
                break
        if cycles >= hard_cap:
            break
        clock.advance(sc.cycle_interval)

    # -- verdict -------------------------------------------------------------

    end_t = clock.now
    api_pods = {p.metadata.name: p for p in inner.list_pods()}
    lost = sorted(name for name in st.live if name not in api_pods)
    pending_final = [p for p in api_pods.values() if p.status.phase == "Pending" and not is_pod_bound(p)]
    backlog = sum(end_t - st.arrival_t[p.metadata.name] for p in pending_final if p.metadata.name in st.arrival_t)
    pod_counts = {
        **st.counts,
        "bound_total": len(st.ttb),
        "pending_final": len(pending_final),
        "running_final": sum(1 for p in api_pods.values() if is_pod_bound(p)),
        "lost": len(lost),
        "lost_names": lost[:20],
        "double_bound": st.double_bound,
    }
    if getattr(fleet, "provider", None) is not None:
        # A reclaim notice is cluster churn: the run can end inside the
        # notice→kill grace window with pods still bound on the cordoned
        # node — the provider took it, the scheduler didn't misplace them.
        for rec in fleet.provider.records:
            if rec["state"] == "reclaiming":
                st.disturbed_nodes.add(rec["name"])
    invariants = check_invariants(inner, st.scheduled_names, st.disturbed_pods, st.disturbed_nodes, st.gangs)
    placements = [
        (p.metadata.name, p.spec.node_name) for p in api_pods.values() if p.spec is not None and p.spec.node_name
    ]
    fp = fingerprint(chaos.bind_log, placements)
    # Resilience verdict inputs: each replica's breaker open spans vs the
    # binds THAT replica POSTed (chaos.bind_actors attributes every bind_log
    # entry to its posting replica — a survivor binding while a dead
    # replica's breaker log still reads open is healthy failover, not a
    # degraded-mode bug), recovery time after the last chaos window, and the
    # worst backlog the run ever held.
    # Strictly interior, on 9-decimal-rounded bounds (bind_log timestamps
    # are rounded the same way): virtual time is discrete, so the POST that
    # tripped the breaker (or a success completing in the same instant)
    # shares the open-start timestamp, and a half-open probe shares the
    # open-end one — both happened through a not-yet/no-longer open breaker.
    open_iv_by_replica = [
        [(round(s, 9), round(e, 9)) for s, e in r.breaker.open_intervals(end_t)] for r in fleet.scheds
    ]
    open_iv = [span for per_replica in open_iv_by_replica for span in per_replica]
    binds_while_open = sum(
        1
        for (t, _pf, _n), actor in zip(chaos.bind_log, chaos.bind_actors)
        if any(s < t < e for s, e in open_iv_by_replica[actor])
    )
    last_window_end = max((w.end for w in sc.chaos.windows), default=None)
    recovery_s = None
    if last_window_end is not None:
        after = [t for t, _pf, _n in chaos.bind_log if t >= last_window_end]
        recovery_s = round(after[0] - last_window_end, 6) if after else None
    metrics_snapshot = fleet.merged_metrics()
    resilience = {
        "breaker_transitions": sum(len(r.breaker.transitions) for r in fleet.scheds),
        "breaker_opened": sum(r.breaker.opened_total for r in fleet.scheds),
        "breaker_open_seconds": round(sum(e - s for s, e in open_iv), 6),
        "binds_while_open": binds_while_open,
        "recovery_seconds_after_brownout": recovery_s,
        "max_pending_backlog": max_pending,
        "deferred_binds": int(metrics_snapshot.get("scheduler_deferred_binds_total", 0)),
        "flushed_binds": int(metrics_snapshot.get("scheduler_flushed_binds_total", 0)),
        "backoff_pruned": int(metrics_snapshot.get("scheduler_backoff_pruned_total", 0)),
    }
    card = build_scorecard(
        scenario=sc.name,
        seed=seed,
        mode="replay" if replay_data is not None else "live",
        virtual_seconds=end_t,
        cycles=cycles,
        pod_counts=pod_counts,
        ttb=st.ttb,
        backlog_pod_seconds=backlog,
        metrics_snapshot=metrics_snapshot,
        invariants=invariants,
        chaos_injected=chaos.injected,
        resilience=resilience,
        availability=fleet.availability_block(pending_final, st.double_bound),
        convergence=_convergence_block(sc, fleet, inner, pending_final, end_t),
        locality=_locality_block(sc, st),
        profile=_profile_block(sc, fleet),
        compile=_compile_block(
            sc,
            0 if warmup_compile_mark is None else int(compile_stats()["builds"]) - warmup_compile_mark,
            compile_listener_active(backend),
        ),
        incremental=_incremental_block(sc, fleet),
        rebalance=_rebalance_block(
            sc,
            fleet,
            inner,
            chaos,
            pending_final,
            lost,
            open_iv_by_replica,
            rebalance_on,
            int(metrics_snapshot.get("scheduler_preemption_victims_total", 0))
            + int(metrics_snapshot.get("scheduler_noexecute_evictions_total", 0)),
        ),
        elasticity=_elasticity_block(sc, fleet, pending_final, lost, end_t, st, autoscale_on),
        latency=_latency_block(sc, fleet, st),
        recorder_stats={
            "tracked_pods": sum(len(r.recorder.tracked_pods()) for r in fleet.scheds),
            "evicted_timelines": sum(r.recorder.evicted_timelines for r in fleet.scheds),
            "recorded_cycles": sum(len(r.recorder.cycles()) for r in fleet.scheds),
        },
        fp=fp,
        policy_required=bool(sc.policy_required),
        policy_floor=float(sc.policy_objective_floor),
    )
    if writer:
        for ep, inject, lat in chaos.decision_log:
            writer.chaos(ep, inject, lat)
        writer.footer(fp, card)
        writer.close()
    if replay_data is not None and replay_data.get("footer"):
        expected = replay_data["footer"]["fingerprint"]
        if expected != fp:
            raise ReplayMismatchError(expected, fp)
    if profile_gates is not None:
        walls = [r.profile_ring.snapshot() for r in fleet.scheds]
        wall_total = sum(s["wall_total_s"] for s in walls)
        other_total = sum(s["other_total_s"] for s in walls)
        ests = [r.profile_ring.overhead_estimate() for r in fleet.scheds]
        profile_gates["coverage"] = (1.0 - other_total / wall_total) if wall_total > 0 else 1.0
        profile_gates["overhead_frac"] = max((e["overhead_frac"] for e in ests), default=0.0)
        profile_gates["per_span_s"] = max((e["per_span_s"] for e in ests), default=0.0)
        profile_gates["spans_per_cycle"] = max((e["spans_per_cycle"] for e in ests), default=0.0)
    return card
