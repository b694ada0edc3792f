"""The scheduler control loop — the port of ``tpu_scheduler/runtime/controller.py``.

Two scheduling policies behind one loop:

  • ``batch`` (the TPU-native default): every eligible pending pod is packed
    and assigned in one backend cycle (ops/assign.py), then bindings POST to
    the API server.  This replaces the reference's per-pod reconcile
    (``main.rs:73-120``) with the batched north-star path.
  • ``sample``: a faithful re-expression of the reference's policy —
    ≤ ``attempts`` random candidates with replacement from the node cache,
    first to pass the predicate chain wins (``main.rs:49-71``) — useful as a
    behavioral oracle and as the zero-dependency degraded mode.  Unlike the
    reference it commits against an assumed-resources ledger, closing the
    TOCTOU oversubscription race SURVEY.md §5 documents.

Shared semantics with the reference:
  • watches pending pods / all nodes through reflectors (main.rs:133-144)
  • skips already-bound pods (main.rs:74-76)
  • failed pods (no node, binding error) requeue with failure-class-aware
    exponential backoff scaled on ``requeue_seconds`` (the reference's flat
    error_policy delay, main.rs:122-125, upgraded — runtime/resilience.py;
    default base 300 s), and an API circuit breaker defers binding POSTs
    into a bounded flush buffer while the server browns out
  • a backend failure (:class:`BackendUnavailable`) falls back to
    ``fallback_backend`` when one is given, and propagates otherwise; the
    port wires no fallback, so a CUDA failure surfaces instead of a cycle
    that quietly ran elsewhere.

Port: every path of the JAX controller's cycle is kept — both policies,
the delta engine (``delta``, the default, with ``delta_shadow_every``) and
the full wave it escalates to, the incremental repack and the topology
attach, the constrained phase and its host-sequential fallback, gang
admission and the cross-rack backstop, routed cycles, pipelined binds,
preemption and PDBs, NoExecute eviction, the breaker and the deferred
flush, leader election, and the SLO, latency and profile snapshots.  The
subsystems of later port items are refused with ``NotImplementedError``:
the sharded control plane and the fleet (``shards > 1``; ROADMAP Queue 1
item 8), the rebalancer and the autoscaler (``rebalance``, ``autoscale``;
item 9).
"""

from __future__ import annotations

import http.client
import logging
import os
import random
import threading
import time

from collections import OrderedDict
from dataclasses import replace
from itertools import chain, groupby

from ..api.objects import Node, ObjectReference, Pod, PodResources, PodSpec, full_name, is_pod_bound, total_pod_resources
from ..backends.base import SchedulingBackend
from ..core.predicates import (
    NODE_LOCAL_PREDICATES,
    InvalidNodeReason,
    dominant_reason,
    unschedulable_reason_counts,
    anti_affinity_ok,
    make_affinity_checker,
    make_pod_affinity_checker,
    make_preferred_pod_affinity_scorer,
    make_soft_spread_scorer,
    make_spread_checker,
    pod_affinity_ok,
    preferred_affinity_score,
    soft_taint_penalty,
    term_matches,
    topology_spread_ok,
)
from ..core.snapshot import ClusterSnapshot, node_allocatable, node_net_available, node_used_resources
from ..errors import BackendUnavailable, CreateBindingFailed, NoNodeFound, SchedulerError
from ..models.profiles import DEFAULT_PROFILE, SchedulingProfile
from ..ops.pack import extend_node_vocabs, pack_snapshot, repack_incremental
from ..utils.events import SEGMENTS, FlightRecorder, waterfall
from ..utils.metrics import CycleMetrics, MetricsRegistry, cycle_phases
from ..utils.profiler import SLO_TIERS, ProfileRing, tier_of, tier_target, transfer_bytes_total
from ..utils.tracing import Trace, current_trace, set_log_cycle, span
from .fake_api import ApiError, FakeApiServer
from .reflector import ClusterReflector
from .resilience import STATES, BackoffQueue, BreakerConfig, CircuitBreaker

logger = logging.getLogger("tpu_scheduler_torch.controller")

__all__ = ["Scheduler", "ATTEMPTS", "REQUEUE_SECONDS"]

ATTEMPTS = 5  # reference main.rs:49
REQUEUE_SECONDS = 300.0  # reference main.rs:124


def _refuse_unported(shards, rebalance, autoscale) -> None:
    """Refuse the options whose subsystem waits for a later item of the
    port (ROADMAP Queue 1), naming the item."""
    asked = [
        ("shards > 1", int(shards) > 1, 8, "the sharded control plane and the fleet"),
        ("rebalance", rebalance is not None and rebalance is not False, 9, "the rebalancer"),
        ("autoscale", autoscale is not None and autoscale is not False, 9, "the autoscaler"),
    ]
    for what, on, item, name in asked:
        if on:
            raise NotImplementedError(f"{what}: {name} is not ported yet (ROADMAP Queue 1 item {item})")


def _pod_priority(p: Pod) -> int:
    """Pod priority with the unset default — ONE definition for every sort
    key and preemption comparison in this module."""
    return p.spec.priority if p.spec is not None else 0


class _NetAvailArrays:
    """Vectorized net-available capacity over the node axis — the exact
    numpy replica of ``req.fits_in(net − ledger)`` for the host sequential
    phase's node loop (see _run_constrained_phase).  Rows follow snapshot
    node order, so iterating the surviving nodes preserves the loop's
    first-best tie-break exactly.  Extended resources get one column each,
    filled with 0 on nodes lacking the resource (fits_in's device-plugin
    rule: an extended request against a missing resource fails)."""

    def __init__(self, snapshot: ClusterSnapshot, ledger: dict[str, PodResources]):
        import numpy as np

        self._np = np
        self.nodes = snapshot.nodes
        n = len(self.nodes)
        self.cpu = np.empty(n, dtype=np.int64)
        self.mem = np.empty(n, dtype=np.int64)
        self.ext: dict[str, "np.ndarray"] = {}
        self._row = {node.name: i for i, node in enumerate(self.nodes)}
        for i, node in enumerate(self.nodes):
            net = node_net_available(snapshot, node)
            assumed = ledger.get(node.name)
            if assumed is not None:
                net -= assumed
            self.cpu[i] = net.cpu
            self.mem[i] = net.memory
            for k, v in (net.extended or {}).items():
                col = self.ext.get(k)
                if col is None:
                    self.ext[k] = col = np.zeros(n, dtype=np.int64)
                col[i] = v

    def fitting_nodes(self, req: PodResources):
        """Nodes where ``req`` fits net-available (snapshot order).

        Zero-valued extended entries are vacuous, exactly as in fits_in
        (its check is ``v > avail.get(k, 0)``): a request of 0 against a
        resource NO node carries must still pass."""
        np = self._np
        mask = (self.cpu >= req.cpu) & (self.mem >= req.memory)
        for k, v in (req.extended or {}).items():
            if v <= 0:
                continue
            col = self.ext.get(k)
            if col is None:
                return ()  # no node carries the resource at all
            mask &= col >= v
        return (self.nodes[i] for i in np.flatnonzero(mask))

    def commit(self, node_name: str, req: PodResources) -> None:
        i = self._row[node_name]
        self.cpu[i] -= req.cpu
        self.mem[i] -= req.memory
        for k, v in (req.extended or {}).items():
            if v > 0:  # zero entries may name resources with no column
                self.ext[k][i] -= v


def _pdb_matches(pdb, q: Pod) -> bool:
    """Does a PodDisruptionBudget select pod ``q``?  Shared by the
    preemption pass and the per-cycle peak-healthy observer."""
    if (pdb.metadata.namespace or "default") != (q.metadata.namespace or "default"):
        return False
    if not pdb.match_labels and not pdb.match_expressions:
        # policy/v1: an empty selector — absent, None, or an explicit
        # {} / [] — matches every pod in the namespace (unlike this
        # codebase's affinity-term deviation, where empty matches
        # nothing).  Truthiness, not None-ness: a manifest's
        # `matchLabels: {}` must not silently protect nothing.
        return True
    return term_matches(pdb, q.metadata.labels)


class Scheduler:
    def __init__(
        self,
        api: FakeApiServer,
        backend: SchedulingBackend,
        profile: SchedulingProfile = DEFAULT_PROFILE,
        policy: str = "batch",
        attempts: int = ATTEMPTS,
        requeue_seconds: float = REQUEUE_SECONDS,
        fallback_backend: SchedulingBackend | None = None,
        clock=time.monotonic,
        rng: random.Random | None = None,
        pod_block: int = 128,
        node_block: int = 128,
        pipeline: bool = False,
        leader_elect: bool = False,
        identity: str | None = None,
        lease_name: str = "tpu-scheduler",
        lease_duration: float = 15.0,
        shards: int = 1,
        constraint_budgets: dict | None = None,
        events_buffer: int = 4096,
        breaker_config: BreakerConfig | None = None,
        flush_capacity: int = 4096,
        backoff_policies: dict | None = None,
        topology="auto",
        delta: bool = True,
        delta_shadow_every: int = 0,
        rebalance=None,
        autoscale=None,
        autoscale_provider=None,
    ):
        if policy not in ("batch", "sample"):
            raise ValueError(f"unknown policy {policy!r} (expected 'batch' or 'sample')")
        _refuse_unported(shards, rebalance, autoscale)
        self.api = api
        self.backend = backend
        self.profile = profile
        self.policy = policy
        self.attempts = attempts
        self.requeue_seconds = requeue_seconds
        self.fallback_backend = fallback_backend
        self.clock = clock
        self.rng = rng or random.Random()
        self.pod_block = pod_block
        self.node_block = node_block
        self.pipeline = pipeline
        # Overrides for ops/constraints.py tensor budgets (max_aa_terms /
        # max_spread / max_coarse_domains).  Exceeding a budget routes the
        # cycle to the exact host sequential phase — orders of magnitude
        # slower at scale — so clusters with unusually rich constraint
        # structure should raise these rather than fall back.  Validated
        # here: a typo'd key would otherwise surface as a TypeError in the
        # middle of the first constrained cycle.
        self.constraint_budgets = dict(constraint_budgets or {})
        unknown = set(self.constraint_budgets) - {"max_aa_terms", "max_spread", "max_coarse_domains"}
        if unknown:
            raise ValueError(f"unknown constraint_budgets keys: {sorted(unknown)}")
        # The scheduler rng also seeds the reflectors' backoff jitter: one
        # seed makes a whole run (sample draws + watch-recovery timing)
        # reproducible — the simulator's determinism contract (sim/).
        self.reflector = ClusterReflector(api, clock=clock, rng=self.rng)
        self.metrics = MetricsRegistry()
        # Flight recorder (utils/events.py): bounded per-pod decision
        # timelines + cycle ring, served by /debug; events_buffer=0 disables.
        # The scheduler clock rides along so timeline ``t`` stamps share the
        # latency time base (virtual in the sim — waterfalls replay
        # bit-identically; monotonic in the daemon).
        self.recorder = FlightRecorder(max_pods=events_buffer, clock=clock)
        # Continuous cost-attribution profiler (utils/profiler.py): every
        # cycle's hierarchical span tree folds into this bounded ring —
        # always on (the <2% overhead gate is a tier-1 test), served at
        # /debug/profile and summarized into /debug/shards.
        self.profile_ring = ProfileRing()
        # Pending-age tracker (SLO burn): pod full name -> (first-seen clock,
        # SLO tier, "gang"/"solo").  Written only by the cycle loop; the
        # HTTP debug thread reads GIL-atomic copies (resilience_snapshot
        # stance).  Feeds scheduler_pending_age_seconds{tier=,gang=} at
        # exit-from-pending and the per-tier burn-rate gauges every cycle.
        self._pending_meta: dict[str, tuple[float, str, str]] = {}
        # Watch-confirm tracker (admission-latency waterfall): pod full name
        # -> SLO tier, entered at every successful binding POST, drained at
        # the next cycle whose reflector snapshot shows the pod bound — the
        # ``bind-confirmed`` timeline stamp and the point where the pod's
        # waterfall is computed and observed into
        # scheduler_ttb_segment_seconds{segment=,tier=}.  Bounded like the
        # flush buffer; insertion order = confirm-scan order.
        self._pending_confirm: OrderedDict[str, str] = OrderedDict()
        # Per-tier waterfall accumulator backing latency_snapshot() (the
        # /debug/latency payload): tier -> {count, ttb_sum, unattributed_sum,
        # segments{name: sum}}.  Written only by the cycle loop; the HTTP
        # thread reads GIL-atomic copies (resilience_snapshot stance).
        self._latency_tiers: dict[str, dict] = {}
        # Device-transfer bytes already folded into the counter (the
        # profiler's lifetime total is process-wide; we fold per-cycle
        # deltas so the metric is a counter, not a re-published gauge).
        self._xfer_folded = 0
        self._unknown_phase_warned: set[str] = set()
        # Why-pending attribution state, reset per cycle: the snapshot
        # unschedulable pods are explained against, the remaining pod×node
        # explanation budget (EXPLAIN_WORK), and a lazy full-name -> Pod map.
        self._explain_snapshot: ClusterSnapshot | None = None
        self._explain_budget = 0
        self._pod_by_full_cache: tuple | None = None
        self._cycle_tag = 0  # the running cycle's number, for event stamps
        self._cycle_notes: list[str] = []  # cycle-level annotations (fallbacks)
        # Per-pod backoff queue (runtime/resilience.py): pod full name ->
        # retry deadline, with per-failure-class exponential escalation.
        # Jitter draws from the scheduler rng, so one seed still reproduces
        # a whole run (the sim determinism contract).  Dict-compatible —
        # the checkpoint and the gang deadline alignment use it as a dict.
        self.requeue_at = BackoffQueue(base_seconds=requeue_seconds, rng=self.rng, policies=backoff_policies)
        # API-server circuit breaker: fed by bind/watch outcomes; while open
        # the cycle runs in DEGRADED MODE — placements are computed but the
        # binding POSTs defer into self.deferred_binds (bounded) and flush
        # on recovery, so a brownout costs latency, never lost pods.
        self.breaker = CircuitBreaker(clock=clock, config=breaker_config, on_transition=self._on_breaker_transition)
        self.metrics.set_gauge("scheduler_circuit_state", float(STATES.index(self.breaker.state)))
        self.deferred_binds: dict[str, str] = {}  # pod full name -> node (insertion order = flush order)
        self.flush_capacity = flush_capacity
        self._probe_left = 0  # half-open trial binds remaining this cycle
        # Peak observed healthy per budget — the desired-replica proxy the
        # maxUnavailable deficit uses for externally degraded workloads:
        # key -> (peak, cycle the peak was last MET).  The peak holds for
        # PDB_PEAK_WINDOW cycles after the workload last reached it, then
        # the observed level becomes the new baseline — so a transient
        # surge (rolling-update overlap) or a scale-down cannot freeze the
        # budget forever, while a crash keeps it blocked for the window.
        self._pdb_peak_healthy: dict[str, tuple[int, int]] = {}
        # maxUnavailable PDBs: per-budget ("ns/name") pair of (outstanding
        # disruptions this scheduler inflicted, last observed healthy count)
        # — the controller-free disruption ledger (_attempt_preemption).
        self._pdb_disruptions: dict[str, tuple[int, int]] = {}
        # NoExecute taint lifecycle: (pod full name, taint key, taint value)
        # -> first time the pod was seen coexisting with that NoExecute taint
        # while tolerating it only for tolerationSeconds (the per-taint
        # eviction grace clock, _evict_noexecute; a taint added later starts
        # its own window, it does not inherit an earlier taint's).
        self._noexecute_seen: dict[tuple[str, str, str], float] = {}
        self._cycle_count = 0
        self._packed = None
        self._node_sig = None
        self._watch_errors_folded = 0
        # id(pod) -> (pod, PodResources): amortizes the bound-usage request
        # summation across cycles (objects change only on watch events).
        self._res_memo: dict[int, tuple] = {}
        # id(pod) -> (pod, matched-term-id tuples): amortizes the selector-
        # match queries of constrained cycles the same way (self-clears on
        # term-vocabulary change; ops/constraints.pack_constraints).
        self._cons_memo: dict = {}
        # Pipelined binding (SURVEY.md §2b PP): the binding POSTs of cycle k
        # run on a worker thread while cycle k+1 syncs/packs/solves.  The
        # assumed cache (pod full name -> node) makes in-flight bindings
        # visible to the next cycle as consumed capacity — kube-scheduler's
        # assume-cache, here closing the host↔device pipeline bubble.
        self._assumed: dict[str, str] = {}
        # One long-lived worker (lazily started) so its thread-local API
        # connection stays keep-alive across bind batches; at most one batch
        # in flight: (outcomes list, done event).
        self._bind_queue = None
        self._bind_inflight: tuple[list, threading.Event] | None = None
        self._cycle_unschedulable: list[str] = []  # this cycle's no-node pods
        self._cycle_gangs: dict[str, set[str]] = {}  # gang -> CYCLE-wide member names
        # Leader election (SURVEY.md §5 — the reference has none): only the
        # lease holder schedules; standbys keep their reflector caches warm
        # and take over within lease_duration of the leader vanishing.
        self.leader_elect = leader_elect
        self.identity = identity or f"sched-{os.getpid()}-{id(self):x}"
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        # One shard: the sharded control plane (runtime/shards.py of the JAX
        # package) is refused above until its port item.
        self.num_shards = 1
        self.is_leader = not self.leader_elect
        # Takeover hygiene: set when leadership (or a shard) was newly
        # acquired; the next owned cycle revalidates the assumed-bind
        # overlay against the reflector cache before it is applied.
        self._revalidate_pending = False
        # Test/sim hook invoked before every binding POST decision — the
        # chaos harness's replica-kill-between-solve-and-flush lever.
        self.pre_bind_hook = None
        self._renew_stop: threading.Event | None = None
        self._renew_thread: threading.Thread | None = None
        # This cycle's successful (or dispatched) placements — the capacity
        # the preemption pass must see on top of the pre-cycle snapshot.
        self._cycle_placed: list[tuple[Pod, Node]] = []
        # Interconnect topology (topology/): "auto" detects the default node
        # label keys per cycle, an explicit TopologyModel (e.g. from
        # --topology-file) pins the hierarchy, None disables — gang scoring
        # then stays topology-blind.  The compiled form is cached per node
        # OBJECT set (the API layer replaces node objects on modification,
        # so identity captures label changes too).
        self.topology = topology
        self._topo_cache: dict[tuple, tuple] = {}
        # Incremental delta-scheduling engine (delta/): the steady-state
        # cycle solves only the pods invalidated by watch deltas against
        # carried residual-capacity tensors; the full-wave solve survives
        # as the escalation path (cold start, takeover, node-set change,
        # closure overflow, periodic epoch refresh).  Batch-policy only —
        # the sample policy has no packed state to carry, and routed
        # (--pool-key) cycles shard the snapshot in ways the per-node
        # residual ledger does not model.
        if delta and policy == "batch" and not profile.pool_key:
            from ..delta import DeltaEngine

            self.delta = DeltaEngine(metrics=self.metrics)
            self.delta.attach(self.reflector)
        else:
            self.delta = None
        # Shadow parity sampling: every Nth delta cycle also runs the
        # full-wave solve and checks that both placed the same pod set.
        self.delta_shadow_every = int(delta_shadow_every)
        self._delta_plan = None  # the running cycle's DeltaPlan (or None = full wave)
        self._delta_avail = None  # carried (alloc64, used64) for the next _pack, consume-once
        self._cycle_bind_failures = 0  # bind-path failures this cycle (shadow comparability)
        if pipeline and profile.pool_key:
            logger.warning(
                "--pipeline applies to plain unconstrained cycles; routed (--pool-key) and "
                "constrained cycles bind synchronously"
            )

    # -- eligibility -------------------------------------------------------

    def _eligible(self, pending: list[Pod]) -> list[Pod]:
        now = self.clock()
        out = []
        for p in pending:
            retry_at = self.requeue_at.get(full_name(p))
            if retry_at is None or retry_at <= now:
                out.append(p)
        return out

    @staticmethod
    def _requeue_reason_class(reason: str | SchedulerError) -> str:
        """Coarse requeue taxonomy for the ``reason`` label of
        ``scheduler_requeues_by_reason_total`` — the metric slice VERDICT round 5
        called for (classify unschedulable/requeue causes as a product
        feature).  Buckets follow the error sites, not free text."""
        if isinstance(reason, NoNodeFound):
            return "no-node"
        if isinstance(reason, CreateBindingFailed):
            return "binding-failed"
        s = str(reason)
        head = s.split(":", 1)[0]
        if head in ("create-binding-failed", "async-bind-failed"):
            return "binding-failed"
        if head in ("api-error", "network-error"):
            return head
        if "gang" in s:
            return "gang"
        return "other"

    def _requeue(self, pod_name: str, reason: str | SchedulerError) -> None:
        """Requeue a failed pod — the reference's error_policy
        (``main.rs:122-125``) upgraded to failure-class-aware exponential
        backoff (runtime/resilience.py): transient server trouble retries
        fast-then-slow, a no-feasible-node verdict backs off long, and the
        reconcile error (errors.py mirrors ``error.rs:3-15``) stays a
        delayed retry, never a crash."""
        cls = self._requeue_reason_class(reason)
        if cls in ("binding-failed", "api-error", "network-error"):
            self._cycle_bind_failures += 1
            if self.delta is not None:
                # A committed placement that failed to stick (async bind
                # failure, deferred overflow) must release its capacity in
                # the carried residual ledger.
                self.delta.uncommit(pod_name)
        delay = self.requeue_at.fail(pod_name, cls, self.clock())
        self.metrics.inc("scheduler_requeues_total")
        self.metrics.inc("scheduler_requeues_by_reason_total", labels={"reason": cls})
        self.metrics.observe("scheduler_backoff_seconds", delay, labels={"reason": cls})
        self.recorder.record(pod_name, "requeued", self._cycle_tag, reason=cls, detail=str(reason))
        logger.warning(
            "reconcile failed on pod %s: %s; requeue in %.1fs (attempt %d)",
            pod_name, reason, delay, self.requeue_at.attempts(pod_name),
        )

    def _evict_noexecute(self, snapshot: ClusterSnapshot) -> set[str]:
        """NoExecute taint lifecycle (kube's taint manager, which the
        reference lacks entirely): a RUNNING pod on a node carrying NoExecute
        taints is evicted unless it tolerates every one of them.  A taint
        tolerated only via tolerations carrying ``tolerationSeconds`` grants
        a grace window from when this scheduler first sees the (pod, taint)
        coexistence — an approximation of kube's taint-added timestamps, which
        the API surface does not carry.  Returns the evicted pod full names.
        """
        now = self.clock()
        evicted: set[str] = set()
        live_keys: set[tuple[str, str, str]] = set()
        for pod, node in snapshot.placed_pods():
            taints = [t for t in ((node.spec.taints or []) if node.spec is not None else []) if t.effect == "NoExecute"]
            if not taints:
                continue
            full = full_name(pod)
            tols = (pod.spec.tolerations or []) if pod.spec is not None else []
            evict_now = False
            expired = False
            pod_keys: list[tuple[str, str, str]] = []
            # Scan ALL taints (no early break): every finite-grace clock must
            # register as live even when another taint forces eviction — a
            # FAILED eviction must not wipe the other taints' running clocks
            # (they would otherwise restart with a fresh window).
            for taint in taints:
                matching = [t for t in tols if t.tolerates(taint)]
                if not matching:
                    evict_now = True
                    continue
                if any(t.toleration_seconds is None for t in matching):
                    continue  # tolerated forever for this taint
                grace = float(min(t.toleration_seconds for t in matching))
                # Per-(pod, taint) clock: a taint added later starts its own
                # window instead of inheriting an earlier taint's start.
                key = (full, taint.key, taint.value)
                first = self._noexecute_seen.setdefault(key, now)
                pod_keys.append(key)
                if now >= first + grace:
                    expired = True
            live_keys.update(pod_keys)
            if not evict_now and not expired:
                continue
            try:
                self.api.delete_pod(pod.metadata.namespace or "default", pod.metadata.name)
            except ApiError as e:
                # Keep the grace state (still live) — the eviction retries
                # next cycle against the ORIGINAL deadline; a transient API
                # failure must not grant a fresh window.
                logger.warning("NoExecute eviction of %s failed: %s", full, e)
                continue
            evicted.add(full)
            for key in pod_keys:
                self._noexecute_seen.pop(key, None)
                live_keys.discard(key)
            self.metrics.inc("scheduler_noexecute_evictions_total")
            self.recorder.record(full, "evicted", self._cycle_tag, node=node.name, detail="NoExecute taint not tolerated")
            logger.info("evicting %s from %s (NoExecute taint not tolerated)", full, node.name)
        # Clocks no longer ticking (taint removed, pod gone/moved) reset.
        for k in [k for k in self._noexecute_seen if k not in live_keys]:
            del self._noexecute_seen[k]
        return evicted

    # Explanation work budget per cycle (pod×node predicate evaluations):
    # attributing WHY a pod is unschedulable costs one scalar-chain sweep
    # over the nodes per pod — bounded like the mop-up so a mass-
    # unschedulable cycle (a full cluster) cannot stall the loop explaining
    # every one of 50k residue pods.  Pods beyond the budget still count and
    # record, with reason="Unknown"; /debug/pods computes their breakdown
    # live on request instead.
    EXPLAIN_WORK = 200_000

    def _explain_pod(self, pod_full: str) -> Pod | None:
        """Pod lookup in the explain snapshot (lazy map, built once per
        snapshot — only cycles that mark pods unschedulable pay for it)."""
        snap = self._explain_snapshot
        cache = self._pod_by_full_cache
        if cache is None or cache[0] is not snap:
            self._pod_by_full_cache = cache = (snap, {full_name(p): p for p in snap.pending_pods()})
        return cache[1].get(pod_full)

    def _mark_unschedulable(self, pod_full: str) -> None:
        """Requeue a pod the cycle could not place, remember it for the
        end-of-cycle preemption pass (profile.preemption), and ATTRIBUTE the
        verdict: the dominant typed InvalidNodeReason plus per-reason
        candidate-node counts (budgeted), a labeled
        ``scheduler_unschedulable_total{reason=...}`` increment, and an
        "unschedulable" timeline event the /debug why-pending route serves."""
        self._cycle_unschedulable.append(pod_full)
        reason_value, counts, feasible, total = "Unknown", None, None, None
        snap = self._explain_snapshot
        if snap is not None and snap.nodes and self._explain_budget >= len(snap.nodes):
            pod = self._explain_pod(pod_full)
            if pod is not None:
                self._explain_budget -= len(snap.nodes)
                counts, feasible, total = unschedulable_reason_counts(pod, snap)
                reason_value = dominant_reason(counts, feasible)
        self.metrics.inc("scheduler_unschedulable_total", labels={"reason": reason_value})
        self.recorder.record(
            pod_full,
            "unschedulable",
            self._cycle_tag,
            reason=reason_value,
            counts=counts,
            detail=None if feasible is None else f"{feasible}/{total} nodes feasible pre-cycle",
        )
        self._requeue(pod_full, NoNodeFound("no feasible node this cycle"))

    # -- binding (main.rs:83-115) -----------------------------------------

    def _on_breaker_transition(self, t: float, frm: str, to: str) -> None:
        """Breaker state changes surface everywhere an operator looks:
        labeled counter, the state gauge, the cycle notes ring, the log."""
        self.metrics.inc("scheduler_circuit_transitions_total", labels={"to": to})
        self.metrics.set_gauge("scheduler_circuit_state", float(STATES.index(to)))
        if to == "closed" and self.delta is not None:
            # Brownout over: the blackout may have cost watch evidence —
            # never trust the carried residuals across a recovery.
            self.delta.invalidate("breaker-recovery")
        self._cycle_notes.append(f"circuit-breaker: {frm} -> {to}")
        logger.warning("API circuit breaker %s -> %s (%d deferred binds held)", frm, to, len(self.deferred_binds))

    def _defer_bind(self, pod_full: str, node_name: str) -> bool:
        """Degraded mode: the placement is decided but the POST waits out
        the open breaker in the bounded flush buffer.  Returns True so the
        caller commits capacity exactly as for a dispatched bind — the
        deferred pod overlays as bound next cycle (never re-scheduled,
        never double-bound).  A full buffer requeues instead (counted)."""
        if len(self.deferred_binds) >= self.flush_capacity:
            self.metrics.inc("scheduler_deferred_overflow_total")
            self._requeue(pod_full, "api-error: circuit breaker open and flush buffer full")
            return False
        self.deferred_binds[pod_full] = node_name
        self.requeue_at.pop(pod_full, None)
        self.metrics.inc("scheduler_deferred_binds_total")
        self.recorder.record(pod_full, "bind-deferred", self._cycle_tag, node=node_name, detail="circuit open")
        return True

    # Watch-confirm tracker capacity (pods awaiting bound-state confirmation).
    CONFIRM_CAPACITY = 8192

    def _await_confirm(self, pod_full: str) -> None:
        """Register a successfully POSTed bind for watch confirmation — the
        ``confirm`` waterfall segment's open edge.  The SLO tier resolves
        from the pending-age tracker at POST time (the pod leaves that
        tracker on the confirm cycle).  Bounded: at capacity the oldest
        entry drops — its confirm segment goes unmeasured, never unbounded
        memory."""
        if not self.recorder.enabled:
            return
        meta = self._pending_meta.get(pod_full)
        while len(self._pending_confirm) >= self.CONFIRM_CAPACITY:
            self._pending_confirm.popitem(last=False)
        self._pending_confirm[pod_full] = meta[1] if meta is not None else "default"

    def _drain_confirms(self, snapshot: ClusterSnapshot) -> None:
        """Drain the watch-confirm tracker against the fresh reflector
        snapshot: a tracked pod now visible as bound records
        ``bind-confirmed``, gets its waterfall reduced, and observes every
        segment into ``scheduler_ttb_segment_seconds{segment=,tier=}`` plus
        the per-tier accumulator ``latency_snapshot`` serves.  Pods deleted
        before the confirmation arrived just leave the tracker.  All
        quantities derive from timeline ``t`` stamps (the scheduler clock),
        so sim runs stay record/replay bit-identical."""
        want = self._pending_confirm
        if not want:
            return
        present: set[str] = set()
        confirmed: list[str] = []
        for p in snapshot.pods:
            pf = full_name(p)
            if pf in want:
                present.add(pf)
                if is_pod_bound(p):
                    confirmed.append(pf)
        for pf in [pf for pf in want if pf not in present]:
            del want[pf]
        for pf in confirmed:
            tier = want.pop(pf)
            self.recorder.record(pf, "bind-confirmed", self._cycle_tag)
            wf = waterfall(self.recorder.timeline(pf))
            if wf is None:
                continue
            acc = self._latency_tiers.setdefault(
                tier,
                {"count": 0, "ttb_sum": 0.0, "unattributed_sum": 0.0, "segments": {seg: 0.0 for seg in SEGMENTS}},
            )
            acc["count"] += 1
            acc["ttb_sum"] += wf["ttb"]
            acc["unattributed_sum"] += wf["unattributed"]
            for seg, v in wf["segments"].items():
                acc["segments"][seg] += v
                self.metrics.observe("scheduler_ttb_segment_seconds", v, labels={"segment": seg, "tier": tier})

    def _bind(self, namespace: str, name: str, node_name: str) -> bool:
        """Breaker-gated bind: POST when the circuit is closed (or as one of
        the half-open cycle's trial binds); defer into the flush buffer
        while it is open.  Zero POSTs ever happen through an open breaker —
        the degraded-mode invariant the sim scorecard pins."""
        if self.pre_bind_hook is not None:
            self.pre_bind_hook(namespace, name, node_name)
        mode = self.breaker.mode()
        if mode == "open" or (mode == "half-open" and self._probe_left <= 0):
            return self._defer_bind(f"{namespace}/{name}", node_name)
        if mode == "half-open":
            self._probe_left -= 1
        return self._post_binding(namespace, name, node_name)

    def _post_binding(self, namespace: str, name: str, node_name: str, flush: bool = False) -> bool:
        """The actual binding POST + outcome taxonomy; every outcome feeds
        the breaker.  ``flush`` marks a deferred bind being flushed: its
        optimistic pods-bound count was taken at defer time, so a flush
        failure corrects the series instead of re-counting."""
        if flush and self.pre_bind_hook is not None:
            # Deferred-flush POSTs reach here without passing _bind; the
            # replica-kill hook must cover the flush window too.
            self.pre_bind_hook(namespace, name, node_name)
        pod_full = f"{namespace}/{name}"
        try:
            self.api.create_binding(namespace, name, ObjectReference(name=node_name))
            self.breaker.record(True)
            logger.info("Binding pod %s to %s", pod_full, node_name)
            self.metrics.inc("scheduler_bindings_total")
            if flush:
                self.metrics.inc("scheduler_flushed_binds_total")
                self.recorder.record(pod_full, "bind-flushed", self._cycle_tag, node=node_name)
            self.recorder.record(pod_full, "bound", self._cycle_tag, node=node_name)
            self._await_confirm(pod_full)
            self.requeue_at.pop(pod_full, None)
            return True
        except CreateBindingFailed as e:
            self.breaker.record(False)
            if flush:
                self.metrics.inc("scheduler_pods_bound_total", -1)
            self._requeue(pod_full, f"create-binding-failed: {e}")
            return False
        except ApiError as e:
            # A 4xx is a HEALTHY server refusing this one request; only
            # 5xx counts against the breaker's server-health window.
            self.breaker.record(e.code < 500)
            if flush:
                self.metrics.inc("scheduler_pods_bound_total", -1)
            if e.code == 409:
                # Already bound elsewhere (await_change, main.rs:74-76).
                logger.info("pod %s already bound; skipping", pod_full)
                return False
            self._requeue(pod_full, f"api-error: {e}")
            return False
        except (OSError, http.client.HTTPException) as e:
            # Transport/protocol failure mid-POST (dropped keep-alive,
            # refused connection, server died mid-response →
            # IncompleteRead/BadStatusLine): KubeApiClient deliberately does
            # not auto-retry POSTs, so the error surfaces here — requeue
            # this one pod instead of crashing the whole cycle
            # (error_policy, main.rs:122-125).
            self.breaker.record(False)
            if flush:
                self.metrics.inc("scheduler_pods_bound_total", -1)
            self._requeue(pod_full, f"network-error: {type(e).__name__}: {e}")
            return False

    def _flush_or_overlay_deferred(self, snapshot: ClusterSnapshot, mode: str) -> ClusterSnapshot:
        """Reconcile the deferred-bind buffer against the cycle snapshot:
        drop stale entries (pod deleted / bound out-of-band / target node
        gone), flush what the breaker allows (everything when closed, the
        probe budget when half-open), and overlay what remains as bound so
        the cycle neither re-schedules a deferred pod nor re-uses its
        capacity."""
        by_full = {full_name(p): p for p in snapshot.pods}
        node_names = {n.name for n in snapshot.nodes}
        for pf in [pf for pf, node in self.deferred_binds.items()
                   if (p := by_full.get(pf)) is None or is_pod_bound(p) or node not in node_names]:
            del self.deferred_binds[pf]
            # The defer optimistically counted the pod bound; correct it.
            self.metrics.inc("scheduler_deferred_dropped_total")
            self.metrics.inc("scheduler_pods_bound_total", -1)
        if mode == "half-open":
            batch = list(self.deferred_binds.items())[: self._probe_left]
        elif mode == "closed":
            batch = list(self.deferred_binds.items())
        else:
            batch = []
        flushed: dict[str, str] = {}
        for pf, node_name in batch:
            # Re-check per POST: a probe failure mid-flush re-opens the
            # breaker, and the rest of the batch must stay deferred (the
            # zero-binds-while-open invariant holds even inside a flush).
            mode = self.breaker.mode()
            if mode == "open":
                break
            if mode == "half-open":
                if self._probe_left <= 0:
                    break
                self._probe_left -= 1
            del self.deferred_binds[pf]
            namespace, _, name = pf.rpartition("/")
            if self._post_binding(namespace or "default", name, node_name, flush=True):
                flushed[pf] = node_name
        if flushed:
            logger.info("flushed %d deferred bind(s) after breaker recovery (%d still held)",
                        len(flushed), len(self.deferred_binds))
        # Overlay survivors AND just-flushed pods as bound clones (the
        # assumed-cache pattern): the snapshot was taken before the flush
        # POSTs, so without the overlay this very cycle would re-schedule a
        # freshly flushed pod straight into a 409.
        overlay = {**self.deferred_binds, **flushed}
        if not overlay:
            return snapshot
        node_by = {n.name: n for n in snapshot.nodes}
        pods = []
        for p in snapshot.pods:
            target = overlay.get(full_name(p))
            if target is not None and not is_pod_bound(p):
                pods.append(self._bound_clone(p, node_by[target]))
            else:
                pods.append(p)
        return ClusterSnapshot.build(snapshot.nodes, pods)

    # -- batch policy ------------------------------------------------------

    def _pack(self, snapshot: ClusterSnapshot):
        """Full pack, or incremental refresh when the node set is stable
        (the device-resident tensor path).  New pod-driven vocabulary
        entries (a fresh deployment's selector pair / affinity term) GROW
        the cached node tensors in place (ops/pack.extend_node_vocabs)
        instead of abandoning the incremental path."""
        sig = self.reflector.node_set_signature()
        # Carried residual capacity from the delta engine, consume-once: it
        # matches the FIRST pack of the cycle (the dirty batch); any later
        # segment pack must re-sweep against its own overlaid snapshot.
        delta_cap = self._delta_avail
        self._delta_avail = None
        memo_cap = 4 * max(1, len(snapshot.pods))
        if len(self._res_memo) > memo_cap or len(self._cons_memo) > memo_cap:
            live = {id(p) for p in snapshot.pods}
            if len(self._res_memo) > memo_cap:
                self._res_memo = {k: v for k, v in self._res_memo.items() if k in live}
            if len(self._cons_memo) > memo_cap:
                from ..ops.constraints import prune_match_memo

                self._cons_memo = prune_match_memo(self._cons_memo, live)
        if self._packed is not None and sig == self._node_sig:
            try:
                extended = extend_node_vocabs(self._packed, snapshot)
                if extended is not self._packed:
                    self.metrics.inc("scheduler_vocab_extensions_total")
                packed = repack_incremental(
                    extended, snapshot, pod_block=self.pod_block, res_memo=self._res_memo, alloc_used64=delta_cap
                )
                self.metrics.inc("scheduler_incremental_packs_total")
            except (ValueError, KeyError):
                # The cached node tensors don't match the live node order
                # after all (e.g. a checkpoint-restored cache whose reflector
                # relisted in a different order: the signature is sorted, the
                # pack is order-sensitive).  Degrade to a full pack — never
                # crash the cycle on a stale cache.
                packed = pack_snapshot(
                    snapshot, pod_block=self.pod_block, node_block=self.node_block, res_memo=self._res_memo
                )
                self._node_sig = sig
                self.metrics.inc("scheduler_full_packs_total")
        else:
            packed = pack_snapshot(
                snapshot, pod_block=self.pod_block, node_block=self.node_block, res_memo=self._res_memo
            )
            self._node_sig = sig
            self.metrics.inc("scheduler_full_packs_total")
        self._packed = packed
        return packed

    def _compiled_topology(self, snapshot: ClusterSnapshot):
        """The cycle's CompiledTopology (or None when disabled / the cluster
        advertises no topology labels).  A snapshot that already carries one
        (attach_topology — rebuilt segment snapshots inherit via the node
        objects) wins; otherwise compile-and-cache keyed on the node object
        identity tuple."""
        if snapshot.topology is not None:
            return snapshot.topology
        if self.topology is None:
            return None
        key = tuple(id(n) for n in snapshot.nodes)
        hit = self._topo_cache.get(key)
        if hit is not None:
            return hit[0]
        from ..topology.model import TopologyModel

        model = self.topology if isinstance(self.topology, TopologyModel) else TopologyModel.detect(snapshot.nodes)
        compiled = model.compile(snapshot.nodes) if model is not None else None
        if len(self._topo_cache) >= 4:
            # Tiny LRU-ish cap: the fleet path legitimately compiles two
            # views per cycle (global for keying, sliced for the solve).
            self._topo_cache.pop(next(iter(self._topo_cache)))
        self._topo_cache[key] = (compiled,)
        return compiled

    def _attach_topology(self, packed, batch_snapshot: ClusterSnapshot):
        """Attach the cycle's TopologySet to a per-cycle copy of the packed
        tensors (the constraints pattern: gang membership changes every
        cycle, so it is never part of the incremental pack cache).  No-op —
        zero added tensors, zero solve cost — for gangless batches or
        topology-blind clusters."""
        if not getattr(self.backend, "supports_topology", False):
            # A topology-BLIND backend judged by the cross-rack quality
            # backstop would see its gangs deferred every cycle; the whole
            # subsystem stays off for it (backends/base.py supports_topology).
            return packed
        pending = batch_snapshot.pending_pods()
        if not any(p.spec is not None and p.spec.gang for p in pending):
            return packed
        compiled = self._compiled_topology(batch_snapshot)
        if compiled is None:
            return packed
        from ..topology.locality import pack_topology

        topo = pack_topology(compiled, pending, packed.padded_pods, packed.node_names, packed.padded_nodes)
        if topo is None:
            return packed
        self.metrics.inc("scheduler_topology_cycles_total")
        return replace(packed, topology=topo)

    def _split_affinity_pending(self, snapshot: ClusterSnapshot, pending: list[Pod]) -> tuple[list[Pod], list[Pod]]:
        """Split pending pods into (plain, constrained) for the batch path.

        Constrained = the pod declares anti-affinity/topology-spread, or an
        anti-affinity term of a *placed* pod or of another *pending* pod
        matches it (direction B — including carriers that may be placed later
        this same cycle, so a plain-classified pod can never be affected by
        any affinity term).  Until the packed tensors carry affinity state,
        constrained pods are scheduled through the exact sequential chain —
        correct first, then fast (config 5 tensorization is the ops-layer
        milestone).
        """
        # Probe-index carrier terms so classification stays near-linear —
        # ONE implementation of the first-pair index trick, shared with
        # pack_constraints' matched-bitmap loops (ops/constraints.py).
        from ..ops.constraints import _matched_term_ids, _term_probe_index

        carriers = [q for q, _ in snapshot.placed_pods_with_terms()] + [
            q for q in pending if q.spec is not None and q.spec.anti_affinity
        ]
        term_list = [
            (None, (q.metadata.namespace, t)) for q in carriers for t in q.spec.anti_affinity
        ]
        probe, residual = _term_probe_index(term_list)

        plain: list[Pod] = []
        constrained: list[Pod] = []
        for p in pending:
            if p.spec is not None and (
                p.spec.anti_affinity
                or p.spec.pod_affinity
                or p.spec.preferred_pod_affinity
                or p.spec.preferred_pod_anti_affinity
                or p.spec.topology_spread
            ):
                constrained.append(p)
                continue
            hit = bool(
                _matched_term_ids(term_list, probe, residual, p.metadata.namespace, p.metadata.labels or {})
            )
            (constrained if hit else plain).append(p)
        return plain, constrained

    @staticmethod
    def _scalar_score(
        pod: Pod,
        node: Node,
        snapshot: ClusterSnapshot,
        ledger: dict[str, PodResources],
        weights,
        soft_spread_penalty: float = 0.0,
        preferred_pod_score: float = 0.0,
        req: PodResources | None = None,
    ) -> float:
        """LeastRequested + BalancedAllocation + soft terms for one
        (pod, node) — the scalar twin of ops/score.py (without the tie-break
        jitter; the sequential phase breaks ties by node order instead).

        Soft terms mirror the tensor path weight-for-weight: preferred node
        affinity (+w₃), PreferNoSchedule taints (−w₄), and the caller-supplied
        ScheduleAnyway spread penalty (−w₅, from make_soft_spread_scorer)."""
        alloc = node_allocatable(node, snapshot)
        used = node_used_resources(snapshot, node.name)
        assumed = ledger.get(node.name)
        if assumed is not None:
            used += assumed
        if req is None:
            req = total_pod_resources(pod)
        fc = (used.cpu + req.cpu) / alloc.cpu if alloc.cpu > 0 else 1.0
        fm = (used.memory + req.memory) / alloc.memory if alloc.memory > 0 else 1.0
        lr = ((1.0 - fc) + (1.0 - fm)) * 50.0
        ba = (1.0 - abs(fc - fm)) * 100.0
        score = float(weights[0]) * lr + float(weights[1]) * ba
        score += float(weights[3]) * preferred_affinity_score(pod, node)
        score -= float(weights[4]) * soft_taint_penalty(pod, node)
        score -= float(weights[5]) * soft_spread_penalty
        # Preferred inter-pod (anti-)affinity carries its own 1-100 term
        # weights, signed — no profile knob (mirrors ops/score.py).
        score += preferred_pod_score
        return score

    def _run_constrained_phase(
        self, snapshot: ClusterSnapshot, constrained: list[Pod], placed: list[tuple[Pod, Node]]
    ) -> tuple[int, int]:
        """Schedule affinity-constrained pods sequentially with the full
        predicate chain: exhaustive over nodes (not sampled), best score
        wins, commitments tracked in the ledger + overlay.

        A vectorized resource PREFILTER (exact replica of fits_in over
        net-available − ledger, numpy over the node axis) skips nodes the
        scalar chain's first check would reject anyway — at a near-full
        cluster that is most of them, and this phase's cost is per
        (pod, node) host work (the stall mop-up ran 46 s of an 88 s
        50k × 5k cycle before it).  Survivors still run the unchanged
        scalar chain, so outcomes are bit-identical."""
        ledger: dict[str, PodResources] = {}
        for pod, node in placed:  # batch commitments consume capacity
            committed = ledger.setdefault(node.name, PodResources())
            committed += total_pod_resources(pod)
        prefilter = _NetAvailArrays(snapshot, ledger)
        weights = self.profile.weights()
        bound = 0
        unschedulable = 0
        order = sorted(constrained, key=lambda p: -_pod_priority(p))
        segment_gangs: dict[str, list[Pod]] = {}
        for pod in order:
            if pod.spec is not None and pod.spec.gang:
                segment_gangs.setdefault(pod.spec.gang, []).append(pod)
        handled_gangs: set[str] = set()
        for pod in order:
            gang = pod.spec.gang if pod.spec is not None else None
            if gang:
                # All-or-nothing gang admission in the host phase: trial-
                # place every member through the sequential chain against
                # scratch state, then commit whole or requeue whole (closes
                # the round-4 silent-livelock: a constrained gang in an
                # untensorizable cluster used to requeue forever).
                if gang in handled_gangs:
                    continue
                handled_gangs.add(gang)
                b, u = self._admit_gang_host(snapshot, gang, segment_gangs[gang], placed, ledger, prefilter, weights)
                bound += b
                unschedulable += u
                continue
            req = total_pod_resources(pod)  # hoisted: O(1) per candidate below
            best = self._choose_constrained_node(pod, snapshot, ledger, placed, prefilter, weights, req)
            if best is None:
                self._mark_unschedulable(full_name(pod))
                unschedulable += 1
                continue
            if self._bind(pod.metadata.namespace or "default", pod.metadata.name, best.name):
                bound += 1
                committed = ledger.setdefault(best.name, PodResources())
                committed += req
                placed.append((pod, best))
                self._cycle_placed.append((pod, best))
                prefilter.commit(best.name, req)
        return bound, unschedulable

    def _choose_constrained_node(
        self, pod: Pod, snapshot: ClusterSnapshot, ledger: dict, placed: list, prefilter, weights, req: PodResources
    ) -> Node | None:
        """Best-scoring feasible node for one pod through the exact scalar
        chain (exhaustive over the prefilter's fitting nodes).  ``ledger``
        and ``placed`` are whatever state the caller is working against —
        the phase's real state, or a gang trial's scratch copies; the
        prefilter may lag a scratch ledger (it only prunes — the ledger-
        aware scalar chain re-checks resources exactly)."""
        # Precompute the pod's affinity/spread state once — the node loop
        # is then O(1) per candidate instead of re-scanning all placements.
        affinity_checker = make_affinity_checker(pod, snapshot, placed)
        pod_affinity_checker = make_pod_affinity_checker(pod, snapshot, placed)
        spread_checker = make_spread_checker(pod, snapshot, placed)
        soft_spread = make_soft_spread_scorer(pod, snapshot, placed)
        ppa_scorer = make_preferred_pod_affinity_scorer(pod, snapshot, placed)
        best: Node | None = None
        best_score = 0.0
        for node in prefilter.fitting_nodes(req):
            reason = self._check_with_ledger(
                pod, node, snapshot, ledger, placed,
                affinity_checker=affinity_checker, spread_checker=spread_checker,
                pod_affinity_checker=pod_affinity_checker, req=req,
            )
            if reason is not None:
                continue
            score = self._scalar_score(pod, node, snapshot, ledger, weights, soft_spread(node), ppa_scorer(node), req=req)
            if best is None or score > best_score:
                best, best_score = node, score
        return best

    def _admit_gang_host(
        self,
        snapshot: ClusterSnapshot,
        gang: str,
        members_here: list[Pod],
        placed: list,
        ledger: dict,
        prefilter,
        weights,
    ) -> tuple[int, int]:
        """All-or-nothing admission of one gang inside the host constrained
        phase: trial-place the members through the sequential chain against
        SCRATCH ledger/placement state, commit every placement only if all
        of them succeed, roll back (requeue whole) on any miss.

        Only admits when this phase sees the gang's full remaining
        membership (cycle-wide members either placed earlier this cycle or
        present here): a gang split across scheduling scopes cannot be
        admitted atomically by one scope, so its local share refuses —
        counted in ``scheduler_gang_host_refusals_total`` and logged once
        per gang per cycle, never silently."""
        here_names = {full_name(p) for p in members_here}
        cycle_members = self._cycle_gangs.get(gang, here_names)
        placed_names = {full_name(q) for q, _ in self._cycle_placed}
        missing = cycle_members - here_names - placed_names
        if missing:
            self.metrics.inc("scheduler_gang_host_refusals_total")
            logger.info(
                "gang %s: %d member(s) outside the host constrained phase; refusing its %d local member(s) whole",
                gang, len(missing), len(members_here),
            )
            for p in members_here:
                self._requeue(full_name(p), "gang split across scheduling scopes; retry as a unit")
            return 0, len(members_here)
        # Trial pass against scratch state (PodResources is mutated with +=,
        # so the ledger copy must be value-deep).
        trial_ledger = {k: v.copy() for k, v in ledger.items()}
        trial_placed = list(placed)
        chosen: list[tuple[Pod, Node, PodResources]] = []
        failed_at: str | None = None
        for pod in sorted(members_here, key=_pod_priority, reverse=True):
            req = total_pod_resources(pod)
            best = self._choose_constrained_node(pod, snapshot, trial_ledger, trial_placed, prefilter, weights, req)
            if best is None:
                failed_at = full_name(pod)
                break
            committed = trial_ledger.setdefault(best.name, PodResources())
            committed += req
            trial_placed.append((pod, best))
            chosen.append((pod, best, req))
        if failed_at is not None:
            self.metrics.inc("scheduler_gang_host_rejections_total")
            logger.info(
                "gang %s: trial placement found no node for %s; rejecting whole (%d member(s) requeue)",
                gang, failed_at, len(members_here),
            )
            for p in members_here:
                self._requeue(full_name(p), "gang trial placement incomplete; retry as a unit")
            return 0, len(members_here)
        bound = 0
        for pod, node, req in chosen:
            # A per-member bind failure here is the same admission-vs-bind
            # window the gang engine documents (kube coscheduling has it
            # too): atomicity is admission-time.
            if self._bind(pod.metadata.namespace or "default", pod.metadata.name, node.name):
                bound += 1
                committed = ledger.setdefault(node.name, PodResources())
                committed += req
                placed.append((pod, node))
                self._cycle_placed.append((pod, node))
                prefilter.commit(node.name, req)
        return bound, 0

    @staticmethod
    def _reduced_view(snapshot: ClusterSnapshot, pending: list[Pod]) -> ClusterSnapshot:
        """A ClusterSnapshot sharing ``snapshot``'s node/pod tuples and lazy
        caches (immutable once built, so sharing is safe) with the pending
        list preset to ``pending`` — the delta cycle's O(1) alternative to
        the filtered ``ClusterSnapshot.build`` rebuild.  Every consumer
        (pack, constraints domain state, predicates, gang solve) sees the
        identical placed view; only ``pending_pods()`` shrinks."""
        view = ClusterSnapshot(
            nodes=snapshot.nodes,
            pods=snapshot.pods,
            _pods_by_node=snapshot._pods_by_node,
            _alloc_cache=snapshot._alloc_cache,
            _used_cache=snapshot._used_cache,
            _net_cache=snapshot._net_cache,
            _placed=snapshot._placed,
            _placed_with_terms=snapshot._placed_with_terms,
        )
        object.__setattr__(view, "_pending", list(pending))
        return view

    @staticmethod
    def _bound_clone(pod: Pod, node: Node) -> Pod:
        """A copy of ``pod`` with ``spec.nodeName`` set — lets a same-cycle
        placement consume capacity in a later segment's packed snapshot."""
        spec = replace(pod.spec, node_name=node.name) if pod.spec is not None else PodSpec(node_name=node.name)
        return replace(pod, spec=spec)

    def _solve_gang_aware(self, packed, batch_snapshot: ClusterSnapshot, backend: SchedulingBackend | None = None):
        """Solve with all-or-nothing gang admission (coscheduling — the
        TPU-workload shape: a training job's workers are useless until every
        one places).  A gang whose CYCLE-WIDE members are not all bound by
        this result is rejected whole; its local pods are masked out and the
        cycle RE-SOLVES so the capacity the gang briefly held reallocates to
        other pods in the same cycle (no gang-starves-the-cluster livelock).
        Rejected members surface as unschedulable (requeue; the gang retries
        whole).

        Membership comes from the FULL cycle (``self._cycle_gangs``, set in
        run_cycle), not this batch: a gang split across scheduling scopes
        (mixed priority segments, per-pool shards, the host constrained
        fallback) can never look complete to any one scope, so every scope
        rejects its share and the gang requeues whole — atomicity holds
        regardless of how the cycle was decomposed."""
        members = self._cycle_gangs
        result = self._solve_with_fallback(packed, backend)
        if not members:
            return result
        from ..backends.base import CycleResult

        local_names = {full_name(p) for p in batch_snapshot.pending_pods()}
        rejected_gangs: set[str] = set()
        rejected_pods: set[str] = set()

        def incomplete_now():
            bound_names = {pf for pf, _ in result.bindings}
            return {g for g, ms in members.items() if g not in rejected_gangs and ms & local_names and not ms <= bound_names}

        for _ in range(self.GANG_RESOLVE_BUDGET):  # each iteration rejects ≥1 gang
            incomplete = incomplete_now()
            fragmented = self._cross_rack_rejects(packed, result, members, local_names, rejected_gangs)
            if fragmented:
                # Placement-QUALITY rejection (topology/): the gang bound
                # whole but straddles the coarsest interconnect level even
                # though one domain could fit it at cycle start — a
                # contention race fragmented it mid-auction.  Deferring a
                # cycle (fresh capacity view, empty anchor) beats admitting
                # a permanently slow gang; its capacity reallocates in the
                # re-solve like any incomplete gang's.
                self.metrics.inc("scheduler_gang_locality_rejections_total", len(fragmented))
                for g in sorted(fragmented):
                    logger.info("gang %s admitted cross-rack despite a single-rack fit; deferring whole", g)
                incomplete = incomplete | fragmented
            if not incomplete:
                break
            for g in sorted(incomplete):
                logger.info("gang %s incomplete; rejecting %d members whole and re-solving", g, len(members[g]))
                rejected_gangs.add(g)
                rejected_pods |= members[g] & local_names
            name_to_row = {nm: i for i, nm in enumerate(packed.pod_names)}
            pod_valid = packed.pod_valid.copy()
            for nm in rejected_pods:
                row = name_to_row.get(nm)
                if row is not None:
                    pod_valid[row] = False
            result = self._solve_with_fallback(replace(packed, pod_valid=pod_valid), backend)
        # Iteration budget exhausted with gangs still incomplete: reject them
        # WITHOUT another solve — atomicity is unconditional, the reclaimed
        # capacity just waits for the next cycle.  Counted (VERDICT r3 weak
        # #6): a cascade deep enough to exhaust the budget silently deferring
        # capacity should be visible in /metrics, not only in this comment.
        exhausted = sorted(incomplete_now())
        if exhausted:
            self.metrics.inc("scheduler_gang_resolve_budget_exhausted_total", len(exhausted))
            logger.warning(
                "gang re-solve budget (%d) exhausted with %d gangs still incomplete; "
                "their capacity reallocates next cycle",
                self.GANG_RESOLVE_BUDGET,
                len(exhausted),
            )
        for g in exhausted:
            rejected_gangs.add(g)
            rejected_pods |= members[g] & local_names
        # Metrics are counted once per gang per cycle in run_cycle, from
        # bind outcomes — not here (a split gang passes through several
        # scopes; an admitted gang can still lose a member to a bind error:
        # admission-time atomicity does not survive per-member 409s, the
        # same window kube coscheduling has).
        if not rejected_gangs:
            return result
        return CycleResult(
            assigned=result.assigned,  # per-row view of the final solve; bindings below are authoritative
            bindings=[(pf, n) for pf, n in result.bindings if pf not in rejected_pods],
            unschedulable=sorted(set(result.unschedulable) | rejected_pods),
            rounds=result.rounds,
            stats=result.stats,
        )

    @staticmethod
    def _cross_rack_rejects(packed, result, members, local_names, rejected_gangs) -> set[str]:
        """Fully-bound gangs whose placement crosses the COARSEST topology
        level although a single domain's cycle-start free capacity covered
        the whole gang — the contention-race escape hatch of the fused
        locality term (topology/locality.py): the auction cannot un-place a
        member, so the quality verdict is enforced here, at admission.

        The fit check is the same cpu/mem heuristic the fit bonus uses
        (domain free >= gang demand on both axes) against the CYCLE-START
        capacity: if no domain ever fit, a cross-rack admission is the best
        available and stands."""
        topo = packed.topology
        if topo is None or not members:
            return set()
        import numpy as np

        lv = topo.meta["level_dist"].shape[0]
        dom_id = topo.meta[f"dom_id_{lv - 1}"]  # [N_pad] coarsest level
        n_dom = int(topo.meta[f"dom_onehot_{lv - 1}"].shape[0]) - 1  # minus sentinel
        free = np.maximum(packed.node_avail[:, :2], 0).astype(np.int64)
        dom_free = np.zeros((n_dom + 1, 2), dtype=np.int64)
        np.add.at(dom_free, dom_id, free)
        row_of = {nm: i for i, nm in enumerate(packed.pod_names)}
        node_row = {nm: i for i, nm in enumerate(packed.node_names)}
        node_of = dict(result.bindings)
        out: set[str] = set()
        for g, ms in sorted(members.items()):
            if g in rejected_gangs or not ms & local_names:
                continue
            rows = [row_of.get(nm) for nm in sorted(ms)]
            placed = [node_row.get(node_of.get(nm)) for nm in sorted(ms)]
            if any(r is None for r in rows) or any(p is None for p in placed):
                continue  # not (fully) local/bound — the atomicity loop owns it
            doms = {int(dom_id[p]) for p in placed}
            if len(doms) <= 1:
                continue  # already single-rack
            demand = np.asarray([packed.pod_req[r, :2] for r in rows], dtype=np.int64).sum(axis=0)
            if bool((dom_free[:n_dom] >= demand[None, :]).all(axis=1).any()):
                out.add(g)
        return out

    def _solve_with_fallback(self, packed, backend: SchedulingBackend | None = None):
        """backend.schedule with the BackendUnavailable→fallback contract."""
        backend = backend or self.backend
        try:
            return backend.schedule(packed, self.profile)
        except BackendUnavailable as e:
            # Only the explicit unavailability signal triggers fallback;
            # programming errors in a backend must surface, not be
            # silently absorbed as degraded-mode cycles forever.
            if self.fallback_backend is None:
                raise
            logger.error("backend %s failed (%s); falling back to %s", backend.name, e, self.fallback_backend.name)
            self.metrics.inc("scheduler_backend_fallbacks_total")
            self._cycle_notes.append(f"backend-fallback: {backend.name} -> {self.fallback_backend.name} ({e})")
            return self.fallback_backend.schedule(packed, self.profile)

    def _bind_result(self, batch_snapshot: ClusterSnapshot, result, placed: list[tuple[Pod, Node]]) -> tuple[int, int]:
        """POST a cycle result's bindings; requeue its unschedulables."""
        bound = 0
        node_by_name = {n.name: n for n in batch_snapshot.nodes}
        pod_by_full = {full_name(p): p for p in batch_snapshot.pending_pods()}
        for pod_full, node_name in result.bindings:
            namespace, _, name = pod_full.rpartition("/")
            if self._bind(namespace or "default", name, node_name):
                bound += 1
                pod_obj, node_obj = pod_by_full.get(pod_full), node_by_name.get(node_name)
                if pod_obj is not None and node_obj is not None:
                    placed.append((pod_obj, node_obj))
                    self._cycle_placed.append((pod_obj, node_obj))
        for pod_full in result.unschedulable:
            self._mark_unschedulable(pod_full)
        return bound, len(result.unschedulable)

    # -- pipelined binding (SURVEY.md §2b PP) -------------------------------

    def _schedule_batch_pipelined(self, batch_snapshot: ClusterSnapshot) -> tuple[int, int, int]:
        """Pack + solve, then hand the binding POSTs to a worker thread and
        return — the next cycle overlaps its sync/pack/solve with this
        cycle's host I/O.  ``bound`` counts DISPATCHED bindings; failures
        surface next cycle via the outcome drain (requeue) exactly as a
        synchronous bind's failures would."""
        with span("pack"):
            if self.recorder.enabled:
                self.recorder.record_packed(
                    (full_name(p) for p in batch_snapshot.pending_pods()), self._cycle_tag, self.backend.name
                )
            packed = self._attach_topology(self._pack(batch_snapshot), batch_snapshot)
        with span("solve"):
            result = self._solve_gang_aware(packed, batch_snapshot)
        self._dispatch_binds(result)
        # Dispatched placements count as this cycle's capacity (the
        # preemption pass and the next cycle's assumed overlay both see it).
        node_by_name = {n.name: n for n in batch_snapshot.nodes}
        pod_by_full = {full_name(p): p for p in batch_snapshot.pending_pods()}
        for pod_full, node_name in result.bindings:
            pod_obj, node_obj = pod_by_full.get(pod_full), node_by_name.get(node_name)
            if pod_obj is not None and node_obj is not None:
                self._cycle_placed.append((pod_obj, node_obj))
        for pod_full in result.unschedulable:
            self._mark_unschedulable(pod_full)
        return len(result.bindings), len(result.unschedulable), result.rounds

    def _bind_worker_loop(self) -> None:
        while True:
            job = self._bind_queue.get()
            if job is None:
                return
            bindings, outcomes, done = job
            t0 = time.perf_counter()
            for pod_full, node_name in bindings:
                namespace, _, name = pod_full.rpartition("/")
                try:
                    self.api.create_binding(namespace or "default", name, ObjectReference(name=node_name))
                    outcomes.append((pod_full, None))
                except Exception as e:  # noqa: BLE001 — categorized on the main-thread drain
                    outcomes.append((pod_full, e))
            outcomes.append(("__bind_seconds__", time.perf_counter() - t0))
            done.set()

    def _dispatch_binds(self, result) -> None:
        """Assume every binding, then hand the batch to the bind worker (at
        most one batch in flight — joined before the next dispatch).  The
        worker is one long-lived thread, so its thread-local API connection
        stays keep-alive across batches (no per-cycle TCP/TLS handshake)."""
        self._join_binds()
        if self._bind_queue is None:
            import queue

            self._bind_queue = queue.Queue()
            threading.Thread(target=self._bind_worker_loop, daemon=True).start()
        bindings = list(result.bindings)
        for pod_full, node_name in bindings:
            self._assumed[pod_full] = node_name
        outcomes: list = []
        done = threading.Event()
        self._bind_inflight = (outcomes, done)
        self._bind_queue.put((bindings, outcomes, done))

    def _join_binds(self) -> None:
        """Wait for the in-flight bind batch (if any) and fold its outcomes
        into scheduler state — the same error taxonomy as the synchronous
        ``_bind`` (409 skip, failure requeue), applied on the main thread."""
        if self._bind_inflight is None:
            return
        outcomes, done = self._bind_inflight
        done.wait()
        self._bind_inflight = None
        unexpected: Exception | None = None
        for pod_full, err in outcomes:
            if pod_full == "__bind_seconds__":
                tr = current_trace()
                if tr is not None:
                    tr.record("bind", err)  # the overlapped POST time, attributed at drain
                continue
            if err is None:
                self.breaker.record(True)
                self.metrics.inc("scheduler_bindings_total")
                self.recorder.record(pod_full, "bound", self._cycle_tag, node=self._assumed.get(pod_full))
                self._await_confirm(pod_full)
                self.requeue_at.pop(pod_full, None)
                continue
            # Server-health taxonomy mirrors _post_binding: 4xx = healthy
            # server refusing one request; 5xx/transport = breaker evidence.
            self.breaker.record(isinstance(err, ApiError) and err.code < 500)
            self._assumed.pop(pod_full, None)
            # The dispatching cycle optimistically counted this pod bound
            # (observe_cycle); correct the series so pods_bound_total stays
            # the confirmed count, not dispatch attempts.
            self.metrics.inc("scheduler_pods_bound_total", -1)
            if isinstance(err, ApiError) and err.code == 409:
                logger.info("pod %s already bound; skipping", pod_full)
            elif isinstance(err, (CreateBindingFailed, ApiError, OSError, http.client.HTTPException)):
                self.metrics.inc("scheduler_async_bind_failures_total")
                self._requeue(pod_full, f"async-bind-failed: {type(err).__name__}: {err}")
            elif unexpected is None:
                unexpected = err  # surface AFTER the whole batch is folded
        if unexpected is not None:
            raise unexpected  # programming error — surface, never absorb

    def _revalidate_overlays(self, snapshot: ClusterSnapshot) -> int:
        """Takeover hygiene (first owned cycle after gaining leadership or a
        shard): assumed-bind overlay entries are re-validated against the
        reflector cache.  Confirmed assumptions (pod bound to the assumed
        node) retire silently — that is the normal prune.  STALE ones — pod
        gone, pod bound elsewhere out-of-band, or the target node vanished
        while we stood by — are dropped and counted in
        ``scheduler_assumed_stale_total``: without this, a stale clone would
        overlay as bound forever (capacity leak) or re-dispatch into a
        double-bind race on the new owner's first cycle."""
        if not self._assumed:
            return 0
        by_full = {full_name(p): p for p in snapshot.pods}
        node_names = {n.name for n in snapshot.nodes}
        stale = 0
        for pf in list(self._assumed):
            target = self._assumed[pf]
            p = by_full.get(pf)
            if p is not None and is_pod_bound(p) and p.spec is not None and p.spec.node_name == target:
                del self._assumed[pf]  # confirmed, not stale
                continue
            if p is None or is_pod_bound(p) or target not in node_names:
                del self._assumed[pf]
                stale += 1
        if stale:
            self.metrics.inc("scheduler_assumed_stale_total", stale)
            self._cycle_notes.append(f"takeover: dropped {stale} stale assumed bind(s)")
            logger.info("takeover revalidation dropped %d stale assumed bind(s)", stale)
        return stale

    def _prune_and_overlay_assumed(self, snapshot: ClusterSnapshot) -> ClusterSnapshot:
        """Drop assumptions the watch has confirmed (or whose pod vanished),
        then overlay the rest: an assumed pod appears bound to its node so
        the cycle consumes its capacity and never re-schedules it."""
        if not self._assumed:
            return snapshot
        by_full = {full_name(p): p for p in snapshot.pods}
        for pod_full in list(self._assumed):
            p = by_full.get(pod_full)
            if p is None or is_pod_bound(p):
                del self._assumed[pod_full]
        if not self._assumed:
            return snapshot
        node_by = {n.name: n for n in snapshot.nodes}
        pods = []
        for p in snapshot.pods:
            target = self._assumed.get(full_name(p))
            if target is not None and not is_pod_bound(p) and target in node_by:
                pods.append(self._bound_clone(p, node_by[target]))
            else:
                pods.append(p)
        return ClusterSnapshot.build(snapshot.nodes, pods)

    def _run_routed_cycle(self, snapshot: ClusterSnapshot, part, placed: list[tuple[Pod, Node]]) -> tuple[int, int, int]:
        """Expert-parallel cycle (parallel/routing.py): per-pool shards pack
        and solve CONCURRENTLY (each shard on its own device when the
        backend has several — JAX async dispatch overlaps the solves), then
        bind deterministically in pool order; the residual runs as a normal
        batch against post-pool capacity via the placed overlay."""
        from concurrent.futures import ThreadPoolExecutor

        pools = sorted(part.pools.items())
        self.metrics.inc("scheduler_routed_cycles_total")
        self.metrics.inc("scheduler_routed_pods_total", part.routed_pods)
        # Shard backends resolved on the main thread (shard_for mutates a
        # per-device cache); solves then fan out over worker threads —
        # unless the backend forbids it (mesh backends: collective launch
        # order must be identical on every process of a multi-controller
        # runtime, which a thread pool cannot guarantee).
        shard_backends = [self.backend.shard_for(i) for i in range(len(pools))]
        workers = min(8, len(pools)) if self.backend.supports_concurrent_shards else 1

        def solve(item):
            i, (value, pool_snap) = item
            t0 = time.perf_counter()
            packed = pack_snapshot(pool_snap, pod_block=self.pod_block, node_block=self.node_block)
            pack_dt = time.perf_counter() - t0
            result = self._solve_gang_aware(packed, pool_snap, shard_backends[i])
            return value, pool_snap, result, pack_dt

        # The solve span is the fan-out wall clock; per-pool pack time
        # (overlapped inside it) is recorded into the pack span separately
        # so CycleMetrics attribution stays meaningful on routed cycles.
        with span("solve"):
            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(solve, enumerate(pools)))
        tr = current_trace()
        if tr is not None:
            tr.record("pack", sum(pack_dt for _, _, _, pack_dt in results))
        bound = unsched = rounds = 0
        with span("bind"):
            for _value, pool_snap, result, _pack_dt in results:
                b, u = self._bind_result(pool_snap, result, placed)
                bound += b
                unsched += u
                rounds = max(rounds, result.rounds)
        if part.residual_pending:
            pending_ids = {id(p) for p in snapshot.pending_pods()}
            base_pods = [p for p in snapshot.pods if id(p) not in pending_ids]
            residual_snapshot = ClusterSnapshot.build(
                snapshot.nodes,
                base_pods + [self._bound_clone(q, qn) for q, qn in placed] + part.residual_pending,
            )
            b, u, r = self._schedule_batch(residual_snapshot, placed)
            bound += b
            unsched += u
            rounds += r
        return bound, unsched, rounds

    def _schedule_batch(
        self,
        batch_snapshot: ClusterSnapshot,
        placed: list[tuple[Pod, Node]],
        with_constraints: bool = False,
        mopup_candidates: set[str] | None = None,
    ) -> tuple[int, int, int]:
        """Pack + solve + bind one batch of plain pending pods; successful
        placements append to ``placed``.  Returns (bound, unschedulable,
        rounds).

        ``with_constraints`` additionally packs the anti-affinity/topology-
        spread tensors (ops/constraints.py) so constrained pods ride the
        batch path; raises UntensorizableConstraints when the structure
        exceeds the tensor budgets (caller falls back to the host phase).
        ``mopup_candidates`` (full names) are the constraint-AFFECTED
        pending pods (_split_affinity_pending's classification: declarers
        plus direction-B anti-affinity matches) — the residue subset the
        stall mop-up re-tries sequentially.
        """
        with span("pack"):
            if self.recorder.enabled:
                # "packed" only lands on already-tracked timelines
                # (utils/events.py) — the batch membership verdict without
                # growing the LRU.
                self.recorder.record_packed(
                    (full_name(p) for p in batch_snapshot.pending_pods()), self._cycle_tag, self.backend.name
                )
            packed = self._attach_topology(self._pack(batch_snapshot), batch_snapshot)
            if with_constraints:
                from ..ops.constraints import pack_constraints

                cons = pack_constraints(
                    batch_snapshot,
                    batch_snapshot.pending_pods(),
                    packed.padded_pods,
                    packed.node_names,
                    packed.padded_nodes,
                    match_memo=self._cons_memo,
                    **self.constraint_budgets,
                )
                if cons is not None:
                    # Attached to a per-cycle copy only: the cached pack is
                    # reused incrementally, but domain state depends on the
                    # cycle's placements and is rebuilt every time.
                    packed = replace(packed, constraints=cons)
                    self.metrics.inc("scheduler_constraint_tensor_cycles_total")
            if self._delta_plan is not None:
                # Delta cycle, plain batch: drop node columns no dirty pod
                # can land on (delta/repack.py — the accepted-claimant
                # compaction idea on the node axis).  The cached full-axis
                # pack above is untouched; only this solve sees the workspace.
                from ..delta.repack import compact_candidate_nodes

                compacted = compact_candidate_nodes(packed, node_block=self.node_block)
                if compacted is not packed:
                    packed = compacted
                    self.metrics.inc("scheduler_delta_node_compactions_total")
        with span("solve"):
            result = self._solve_gang_aware(packed, batch_snapshot)
        mop_bound = mop_unsched = 0
        if with_constraints and packed.constraints is not None and result.unschedulable:
            with span("mopup"):
                result, mop_bound, mop_unsched = self._constraint_stall_mopup(
                    batch_snapshot, result, placed, mopup_candidates or set()
                )
        with span("bind"):
            bound, unsched = self._bind_result(batch_snapshot, result, placed)
        return bound + mop_bound, unsched + mop_unsched, result.rounds

    # Sequential mop-up budget: the residue of a stall-stopped constraint
    # auction is small by construction (stall-stop fires when rounds stop
    # accepting, not when demand exceeds capacity), but a genuinely
    # over-subscribed constrained cluster can leave thousands unschedulable —
    # the exhaustive scalar pass is host-side Python, so its work is capped
    # to the highest-priority declarers.  The cap is WORK-based, not
    # pod-count-based: each mop-up pod scans every node through the scalar
    # chain (~40 µs per pair), so a flat 256-pod cap meant 256 × 10k nodes
    # ≈ 100 s at north-star node counts.  MOPUP_WORK bounds pods × nodes
    # (~20 s worst case); pods beyond the cap requeue and retry next cycle
    # — completeness over cycles is unchanged, per-cycle latency is
    # predictable.
    MOPUP_MAX = 256
    MOPUP_WORK = 500_000

    def _mopup_pod_cap(self, n_nodes: int) -> int:
        return min(self.MOPUP_MAX, max(16, self.MOPUP_WORK // max(1, n_nodes)))

    def _constraint_stall_mopup(
        self, batch_snapshot: ClusterSnapshot, result, placed: list, candidates: set[str]
    ):
        """Sequential completeness pass over a constraint auction's residue
        (VERDICT r3 #7).  The auction stops after STALL_ROUNDS consecutive
        zero-acceptance rounds (ops/assign.py) — a time/progress trade that
        can requeue pods the sequential host oracle would still place (the
        within-round conflict filter defers conservatively by rank; three
        jitter re-rolls are not a completeness proof).  Here the exact
        sequential chain (_run_constrained_phase) re-tries the residue's
        constraint-AFFECTED pods (``candidates``: declarers plus pods
        matched by anti-affinity terms — the filter can defer either kind)
        against the cycle's final state: every pod it places was
        stall-stopped, every pod it refuses is genuinely infeasible —
        quantifying the gap the stall heuristic opened
        (scheduler_stall_mopup_* metrics) and closing it in the same cycle.
        Unaffected residue pods are untouched: only the constraint filter
        defers feasible pods, so an unaffected unschedulable is already
        proof of infeasibility."""
        pod_by_full = {full_name(p): p for p in batch_snapshot.pending_pods()}
        declarers = []
        passthrough = []
        for pod_full in result.unschedulable:
            pod = pod_by_full.get(pod_full)
            spec = pod.spec if pod is not None else None
            # Gang admission is all-or-nothing; the gang engine owns it.
            if pod is not None and spec is not None and not spec.gang and pod_full in candidates:
                declarers.append(pod)
            else:
                passthrough.append(pod_full)
        if not declarers:
            return result, 0, 0
        declarers.sort(key=_pod_priority, reverse=True)
        cap = self._mopup_pod_cap(len(batch_snapshot.nodes))
        if len(declarers) > cap:
            passthrough.extend(full_name(p) for p in declarers[cap:])
            declarers = declarers[:cap]
        # The sequential phase must see the auction's accepted placements as
        # consumed capacity/domain state; they are not in ``placed`` yet
        # (binding happens after), so seed a working copy.
        node_by_name = {n.name: n for n in batch_snapshot.nodes}
        seeded = list(placed)
        for pod_full, node_name in result.bindings:
            pod_obj, node_obj = pod_by_full.get(pod_full), node_by_name.get(node_name)
            if pod_obj is not None and node_obj is not None:
                seeded.append((pod_obj, node_obj))
        self.metrics.inc("scheduler_stall_mopup_attempted_total", len(declarers))
        seeded_len = len(seeded)
        bound, unsched = self._run_constrained_phase(batch_snapshot, declarers, seeded)
        placed.extend(seeded[seeded_len:])  # mop-up placements are cycle placements
        if bound:
            self.metrics.inc("scheduler_stall_mopup_bound_total", bound)
            logger.info(
                "constraint stall mop-up placed %d/%d residue pods the auction requeued", bound, len(declarers)
            )
        # _run_constrained_phase binds + marks its own failures; the caller
        # must not re-mark the pods it handled.
        return replace(result, unschedulable=passthrough), bound, unsched

    def _run_batch_cycle(self, snapshot: ClusterSnapshot, trace: Trace) -> tuple[int, int, int]:
        # Plain-vs-constrained classification is per-pod probe work over the
        # whole pending set — "queue" phase, like the eligibility filter.
        with span("queue"):
            pending = snapshot.pending_pods()
            _, constrained = self._split_affinity_pending(snapshot, pending)
        placed: list[tuple[Pod, Node]] = []
        if not constrained:
            # Expert-parallel routing: pods pinned to node pools schedule as
            # independent per-pool shards (parallel/routing.py); constrained
            # cycles bypass it (domain state spans pools).
            if self.profile.pool_key:
                from ..parallel.routing import partition_snapshot

                part = partition_snapshot(snapshot, self.profile.pool_key)
                if part is not None:
                    return self._run_routed_cycle(snapshot, part, placed)
            if self.pipeline and self.breaker.mode() == "closed":
                # PP: hand the binds to a worker thread; the next cycle's
                # sync/pack/solve overlaps this cycle's host I/O.  Degraded
                # cycles (breaker not closed) bind synchronously instead so
                # every outcome feeds the breaker — and an open breaker
                # defers rather than POSTs.
                return self._schedule_batch_pipelined(snapshot)
            # Fast path — one tensor cycle over every pending pod (and the
            # incremental device-resident pack stays hot).
            return self._schedule_batch(snapshot, placed)

        # Constrained cycle, tensor-first: anti-affinity + topology-spread
        # ride the device path as domain-bitmap tensors (ops/constraints.py)
        # so the whole pending set schedules in ONE batch; the sequential
        # host phase below survives only as the fallback for constraint
        # structures beyond the tensor budgets.
        from ..ops.constraints import UntensorizableConstraints

        try:
            return self._schedule_batch(
                snapshot, placed, with_constraints=True,
                mopup_candidates={full_name(p) for p in constrained},
            )
        except UntensorizableConstraints as e:
            logger.info("constraints not tensorizable (%s); host sequential fallback", e)
            self.metrics.inc("scheduler_constraint_host_fallbacks_total")

        # Mixed cycle: schedule in global priority order so a plain pod never
        # takes capacity from a higher-priority constrained pod (or vice
        # versa).  Equal-priority pods carry no ordering obligation, so each
        # priority level contributes at most one plain segment (tensor path)
        # and one constrained segment (exact sequential chain) — adjacent
        # same-kind segments across levels coalesce — and every segment sees
        # all earlier placements as consumed capacity.
        constrained_ids = {id(p) for p in constrained}
        pending_ids = {id(p) for p in pending}
        order = sorted(pending, key=lambda p: -_pod_priority(p))
        segments: list[tuple[bool, list[Pod]]] = []
        for _, level in groupby(order, key=_pod_priority):
            for pod in sorted(level, key=lambda p: id(p) in constrained_ids):  # plain first within a level
                is_constrained = id(pod) in constrained_ids
                if segments and segments[-1][0] == is_constrained:
                    segments[-1][1].append(pod)
                else:
                    segments.append((is_constrained, [pod]))
        base_pods = [p for p in snapshot.pods if id(p) not in pending_ids]
        bound = unschedulable = rounds = 0
        for is_constrained, segment in segments:
            if is_constrained:
                with span("constrained"):
                    b, u = self._run_constrained_phase(snapshot, segment, placed)
                r = 0
            else:
                with span("queue"):
                    batch_snapshot = ClusterSnapshot.build(
                        snapshot.nodes,
                        base_pods + [self._bound_clone(q, qn) for q, qn in placed] + segment,
                    )
                b, u, r = self._schedule_batch(batch_snapshot, placed)
            bound += b
            unschedulable += u
            rounds += r
        return bound, unschedulable, rounds

    # A degraded workload's maxUnavailable budget stays blocked this many
    # cycles past the last time it was at full strength; then the observed
    # level becomes the new baseline (surge/scale-down thaw; see
    # _pdb_peak_healthy in __init__ and the README PDB row).
    PDB_PEAK_WINDOW = 256

    # Reject-and-re-solve iterations per cycle for incomplete gangs; a
    # cascade deeper than this defers the remaining gangs' capacity to the
    # next cycle and counts scheduler_gang_resolve_budget_exhausted_total.
    GANG_RESOLVE_BUDGET = 4

    def _update_pdb_peaks(self, snapshot: ClusterSnapshot) -> None:
        """Per-cycle peak-healthy observation for maxUnavailable budgets —
        the desired-replica proxy (see _attempt_preemption).  Runs every
        cycle (standby cycles included — a successor must not baseline a
        crashed workload at its degraded count) so the proxy sees the
        workload while it is WHOLE.  Also the one place stale per-budget
        state (peaks + disruption debt) is pruned: a deleted/recreated
        budget starts fresh — the operator's immediate reset."""
        try:
            pdbs = list(getattr(self.api, "list_pdbs", list)())
        except (ApiError, OSError, http.client.HTTPException) as e:
            # API outage: keep last-known peaks/debt (conservative) — the
            # cycle itself must keep running on cached state (the same
            # stance as watch errors; tests/test_resilience.py).
            logger.debug("PDB peak observation skipped (api unavailable: %s)", e)
            return
        live: set[str] = set()
        placed = None
        for pdb in pdbs:
            key = f"{pdb.metadata.namespace or 'default'}/{pdb.metadata.name}"
            live.add(key)
            if pdb.max_unavailable is None:
                continue
            if placed is None:
                placed = list(snapshot.placed_pods())
            healthy = sum(1 for q, _qn in placed if _pdb_matches(pdb, q))
            peak, met_at = self._pdb_peak_healthy.get(key, (healthy, self._cycle_count))
            if healthy >= peak:
                peak, met_at = healthy, self._cycle_count
            elif self._cycle_count - met_at >= self.PDB_PEAK_WINDOW:
                # The workload has not been back to its peak for a whole
                # window: accept the new level (thaw) instead of freezing
                # the budget forever on a bygone surge or scale-down.
                peak, met_at = healthy, self._cycle_count
            self._pdb_peak_healthy[key] = (peak, met_at)
        for k in [k for k in self._pdb_peak_healthy if k not in live]:
            del self._pdb_peak_healthy[k]
        for k in [k for k in self._pdb_disruptions if k not in live]:
            del self._pdb_disruptions[k]

    # -- preemption (kube PostFilter; absent in the reference) -------------

    def _attempt_preemption(self, snapshot: ClusterSnapshot) -> tuple[int, int]:
        """Evict strictly-lower-priority victims so this cycle's
        resource-starved pods can bind (kube preemption semantics,
        simplified to immediate deletion — the synthetic cluster has no
        kubelet grace period to await).

        Per preemptor (priority desc): candidate nodes must pass every
        NON-resource predicate as-is (eviction cannot fix a selector, taint,
        or affinity mismatch — and no credit is taken for constraint room an
        eviction might open: conservative); on each, victims are taken
        lowest-priority-first until the preemptor fits; the chosen node
        minimizes (highest victim priority, victim count) — kube's
        minimal-disruption heuristics.  Returns (pods bound, victims
        evicted)."""
        by_full = {full_name(p): p for p in snapshot.pending_pods()}
        pods_on: dict[str, list[Pod]] = {}
        for q, qn in snapshot.placed_pods():
            pods_on.setdefault(qn.name, []).append(q)
        for lst in pods_on.values():
            lst.sort(key=_pod_priority)
        # Seed with THIS cycle's placements (bound or dispatched) — the
        # snapshot predates them, and ignoring them would let the pass bind
        # onto capacity the main pass already consumed (oversubscription).
        extra_used: dict[str, PodResources] = {}
        placed_overlay: list[tuple[Pod, Node]] = list(self._cycle_placed)
        for q, qn in self._cycle_placed:
            u = extra_used.setdefault(qn.name, PodResources())
            u += total_pod_resources(q)
        freed: dict[str, PodResources] = {}  # victims evicted this pass
        bound = victims_total = 0

        # PodDisruptionBudgets (policy/v1 subset): remaining voluntary
        # disruptions per budget, NEVER violated — a victim whose eviction
        # would breach a matching budget is not eligible (api/objects.py
        # PodDisruptionBudget for the semantics and kube deviation).
        pdbs = list(getattr(self.api, "list_pdbs", list)())
        pdb_allow: list[int] = []
        for pdb in pdbs:
            key = f"{pdb.metadata.namespace or 'default'}/{pdb.metadata.name}"
            healthy = sum(1 for q, _qn in snapshot.placed_pods() if _pdb_matches(pdb, q))
            try:
                if pdb.min_available is not None:
                    pdb_allow.append(max(0, healthy - int(pdb.min_available)))
                elif pdb.max_unavailable is not None:
                    # maxUnavailable needs a desired replica count no
                    # controller exists to report.  Two proxies combine
                    # (round-3 advisor): OUR outstanding disruptions (out —
                    # evictions this scheduler inflicted, paid down as
                    # replicas return) and the workload's EXTERNAL
                    # degradation (peak observed healthy − healthy: crashes,
                    # node loss).  The deficit is their max, not sum — an
                    # eviction of ours eventually shows up in healthy too,
                    # and counting it twice would freeze the budget.  Known
                    # deviation: an intentional scale-down reads as
                    # degradation until the peak ages out with the budget
                    # object (documented beside the PDB row in README.md).
                    out, prev = self._pdb_disruptions.get(key, (0, healthy))
                    if healthy > prev:
                        out = max(0, out - (healthy - prev))
                    self._pdb_disruptions[key] = (out, healthy)
                    peak, _met_at = self._pdb_peak_healthy.get(key, (healthy, self._cycle_count))
                    deficit = max(out, peak - healthy)
                    pdb_allow.append(max(0, int(pdb.max_unavailable) - deficit))
                else:
                    # Neither bound set (e.g. a typo'd field dropped by
                    # from_dict): fail CLOSED like any other malformed
                    # budget — kube would reject the manifest at admission.
                    logger.warning("PDB %s sets neither minAvailable nor maxUnavailable; zero disruptions allowed", key)
                    pdb_allow.append(0)
            except (TypeError, ValueError):
                # Malformed budget (e.g. a kube percentage string, which is
                # unsupported by design) fails CLOSED: zero allowance — the
                # never-violate stance protects rather than exposes.
                logger.warning("PDB %s has non-integer bound %r/%r; treating as zero disruptions allowed",
                               key, pdb.min_available, pdb.max_unavailable)
                pdb_allow.append(0)
        # Stale per-budget state is pruned per-cycle in _update_pdb_peaks
        # (deleted/recreated budgets must not inherit debt or peaks).
        _pdb_memo: dict[str, tuple[int, ...]] = {}

        def _pdbs_of(q: Pod) -> tuple[int, ...]:
            full = full_name(q)
            hit = _pdb_memo.get(full)
            if hit is None:
                hit = tuple(i for i, pdb in enumerate(pdbs) if _pdb_matches(pdb, q))
                _pdb_memo[full] = hit
            return hit

        # Gang members never preempt individually: evicting victims to host
        # part of a gang that may never fully place is pure disruption —
        # all-or-nothing admission stays with the gang-aware solve.
        order = sorted(
            (
                by_full[n]
                for n in self._cycle_unschedulable
                if n in by_full and not (by_full[n].spec is not None and by_full[n].spec.gang)
            ),
            key=lambda p: -_pod_priority(p),
        )
        for pod in order:
            prio = _pod_priority(pod)
            req = total_pod_resources(pod)
            best = best_key = None
            # Hoisted per-pod checkers: one placed-pod scan, O(1) per node.
            aa_checker = make_affinity_checker(pod, snapshot, placed_overlay)
            # Positive affinity gates candidates too: eviction frees
            # capacity but can never conjure a co-location match, so a
            # node outside the pod's required domain is never a target.
            pa_checker = make_pod_affinity_checker(pod, snapshot, placed_overlay)
            sp_checker = make_spread_checker(pod, snapshot, placed_overlay)
            for node in snapshot.nodes:
                if any(not pred(pod, node, snapshot) for _, pred in NODE_LOCAL_PREDICATES):
                    continue
                if not aa_checker(node) or not pa_checker(node) or not sp_checker(node):
                    continue
                avail = node_net_available(snapshot, node)
                if node.name in extra_used:
                    avail -= extra_used[node.name]
                if node.name in freed:
                    avail += freed[node.name]
                # Per-axis deficit (cpu, memory, each extended resource the
                # preemptor requests): victims accumulate until every axis
                # is covered.
                need = PodResources(cpu=req.cpu - avail.cpu, memory=req.memory - avail.memory)
                if req.extended:
                    a_ext = avail.extended or {}
                    need.extended = {k: v - a_ext.get(k, 0) for k, v in req.extended.items()}
                victims: list[Pod] = []
                got = PodResources()
                pdb_used: dict[int, int] = {}
                for q in pods_on.get(node.name, []):  # priority ascending
                    if got.covers(need):
                        break
                    if _pod_priority(q) >= prio:
                        break  # sorted: everything after is also ineligible
                    if q.spec is not None and q.spec.gang:
                        # Placed gang members are never INDIVIDUAL victims:
                        # evicting one worker destroys the whole group's
                        # value (the members left running are useless) for
                        # partial capacity gain — and it would break the
                        # framework's all-or-nothing gang guarantee.  Look
                        # past them, like budget-protected pods.
                        continue
                    qpdbs = _pdbs_of(q) if pdbs else ()
                    if any(pdb_allow[i] - pdb_used.get(i, 0) <= 0 for i in qpdbs):
                        continue  # budget-protected: look past it, never evict
                    for i in qpdbs:
                        pdb_used[i] = pdb_used.get(i, 0) + 1
                    victims.append(q)
                    got += total_pod_resources(q)
                if got.covers(need):
                    if victims:
                        # kube's selectVictimsOnNode re-filter: the node must
                        # still satisfy affinity/spread AS IF the victims were
                        # already gone — evicting the very pod that satisfies
                        # the preemptor's required podAffinity (or shifting a
                        # spread minimum) disqualifies the candidate.
                        # (Anti-affinity only relaxes when pods leave — no
                        # re-check needed.)
                        vnames = frozenset(full_name(q) for q in victims)
                        if not make_pod_affinity_checker(pod, snapshot, placed_overlay, exclude=vnames)(node):
                            continue
                        if not make_spread_checker(pod, snapshot, placed_overlay, exclude=vnames)(node):
                            continue
                    key = (_pod_priority(victims[-1]) if victims else -(2**31), len(victims))
                    if best_key is None or key < best_key:
                        best, best_key = (node, victims, pdb_used), key
            if best is None:
                continue
            node, victims, pdb_used = best
            # Commit the chosen node's budget consumption before evicting —
            # a later preemptor in this same pass must not double-spend —
            # and record maxUnavailable debt in the cross-cycle ledger (paid
            # down as replicas return; see pdb_allow construction above).
            for i, n_used in pdb_used.items():
                pdb_allow[i] -= n_used
                b = pdbs[i]
                if b.min_available is None and b.max_unavailable is not None:
                    bkey = f"{b.metadata.namespace or 'default'}/{b.metadata.name}"
                    out, prev = self._pdb_disruptions.get(bkey, (0, 0))
                    self._pdb_disruptions[bkey] = (out + n_used, prev)
            evict_failed = False
            for q in victims:
                try:
                    self.api.delete_pod(q.metadata.namespace or "default", q.metadata.name)
                except ApiError as e:
                    logger.warning("preemption eviction of %s failed: %s", full_name(q), e)
                    evict_failed = True
                    break
                pods_on[node.name].remove(q)
                f = freed.setdefault(node.name, PodResources())
                f += total_pod_resources(q)
                victims_total += 1
                self.metrics.inc("scheduler_preemption_victims_total")
                self.recorder.record(
                    full_name(q), "preempted", self._cycle_tag, node=node.name, detail=f"victim of {full_name(pod)}"
                )
            if evict_failed:
                continue  # freed capacity stays accounted; preemptor retries next cycle
            if self._bind(pod.metadata.namespace or "default", pod.metadata.name, node.name):
                bound += 1
                self.metrics.inc("scheduler_preemptions_total")
                placed_overlay.append((pod, node))
                self._cycle_placed.append((pod, node))
                u = extra_used.setdefault(node.name, PodResources())
                u += req
            elif victims:
                # Victims are already gone but the bind failed: clear the
                # backoff so the preemptor contends for the freed capacity
                # in the very next cycle (its priority wins the auction) —
                # the nominatedNodeName reservation, approximated.
                self.requeue_at.pop(full_name(pod), None)
                self.metrics.inc("scheduler_preemption_bind_failures_total")
                logger.warning(
                    "preemptor %s failed to bind after %d evictions; retrying next cycle", full_name(pod), len(victims)
                )
        return bound, victims_total

    # -- sample policy (reference main.rs:49-71) ---------------------------

    def _select_node_sample(
        self,
        pod: Pod,
        snapshot: ClusterSnapshot,
        ledger: dict[str, PodResources],
        placed: list[tuple[Pod, Node]],
    ) -> Node | None:
        nodes = self.reflector.nodes.state()
        if not nodes:
            return None
        for _ in range(self.attempts):
            candidate = self.rng.choice(nodes)  # with replacement, main.rs:56
            reason = self._check_with_ledger(pod, candidate, snapshot, ledger, placed)
            if reason is None:
                return candidate
            logger.debug("Node %s failed validity check for pod %s: %s", candidate.name, full_name(pod), reason)
        return None

    @staticmethod
    def _check_with_ledger(
        pod: Pod,
        node: Node,
        snapshot: ClusterSnapshot,
        ledger: dict[str, PodResources],
        placed: list[tuple[Pod, Node]],
        affinity_checker=None,
        spread_checker=None,
        pod_affinity_checker=None,
        req: PodResources | None = None,
    ) -> InvalidNodeReason | None:
        """Full predicate chain vs snapshot + this-cycle commitments: the
        assumed-resources ledger (closing the reference's TOCTOU race) and
        the ``placed`` overlay so affinity/spread see same-cycle bindings.

        A caller looping over many nodes for one pod passes prebuilt
        ``affinity_checker``/``spread_checker`` (make_affinity_checker /
        make_spread_checker over the same snapshot+placed) and the pod's
        summed ``req`` to amortise the per-node work; semantics are
        identical either way.
        """
        available = node_net_available(snapshot, node)
        assumed = ledger.get(node.name)
        if assumed is not None:
            available -= assumed
        if req is None:
            req = total_pod_resources(pod)
        if not req.fits_in(available):
            return InvalidNodeReason.NOT_ENOUGH_RESOURCES
        for reason, pred in NODE_LOCAL_PREDICATES:
            if not pred(pod, node, snapshot):
                return reason
        affinity_fine = (
            affinity_checker(node) if affinity_checker is not None else anti_affinity_ok(pod, node, snapshot, extra_placed=placed)
        )
        if not affinity_fine:
            return InvalidNodeReason.ANTI_AFFINITY_VIOLATION
        pa_fine = (
            pod_affinity_checker(node)
            if pod_affinity_checker is not None
            else pod_affinity_ok(pod, node, snapshot, extra_placed=placed)
        )
        if not pa_fine:
            return InvalidNodeReason.POD_AFFINITY_UNSATISFIED
        spread_fine = (
            spread_checker(node) if spread_checker is not None else topology_spread_ok(pod, node, snapshot, extra_placed=placed)
        )
        if not spread_fine:
            return InvalidNodeReason.TOPOLOGY_SPREAD_VIOLATION
        return None

    def _run_sample_cycle(self, snapshot: ClusterSnapshot, pending: list[Pod]) -> tuple[int, int]:
        ledger: dict[str, PodResources] = {}
        placed: list[tuple[Pod, Node]] = []
        bound = 0
        unschedulable = 0
        refused_gangs: set[str] = set()
        for pod in pending:
            if pod.spec is not None and pod.spec.gang:
                # The per-pod sample policy cannot express all-or-nothing
                # admission; refusing beats silently binding half a gang.
                # Counted + logged once per gang per cycle — a permanent
                # config mismatch (gangs under --policy sample) must be
                # visible in /metrics, not only as eternal requeues.
                if pod.spec.gang not in refused_gangs:
                    refused_gangs.add(pod.spec.gang)
                    self.metrics.inc("scheduler_gang_sample_refusals_total")
                    logger.warning(
                        "gang %s requires the batch policy; its pods requeue every cycle under --policy sample",
                        pod.spec.gang,
                    )
                self._requeue(full_name(pod), "gang pods require the batch policy")
                unschedulable += 1
                continue
            node = self._select_node_sample(pod, snapshot, ledger, placed)
            if node is None:
                self._mark_unschedulable(full_name(pod))
                unschedulable += 1
                continue
            if self._bind(pod.metadata.namespace or "default", pod.metadata.name, node.name):
                bound += 1
                committed = ledger.setdefault(node.name, PodResources())
                committed += total_pod_resources(pod)
                placed.append((pod, node))
                self._cycle_placed.append((pod, node))
        return bound, unschedulable

    def _pre_cycle_overlay(self, snapshot: ClusterSnapshot) -> ClusterSnapshot:
        """The between-snapshot-and-decision ledger work of one cycle (the
        ``overlay`` phase): DELETE-stream pruning, control-plane ownership
        (shard leases / leader lease), takeover revalidation, breaker
        bookkeeping + deferred-bind flush/overlay, pipelined-bind fold, and
        PDB peak observation.  Returns the (possibly overlaid) snapshot."""
        # Prune per-pod ledgers from the watch DELETE stream — runs on
        # EVERY cycle, standby included (the standby path deliberately
        # skips the pending-set prune below, which used to leak backoff
        # entries for pods deleted while this instance stood by).
        deleted = self.reflector.take_deleted_pods()
        if deleted:
            pruned = 0
            for ns, name in deleted:
                pf = f"{ns or 'default'}/{name}"
                if self.requeue_at.pop(pf, None) is not None:
                    pruned += 1
                self._assumed.pop(pf, None)
                self._pending_confirm.pop(pf, None)
                if self.deferred_binds.pop(pf, None) is not None:
                    self.metrics.inc("scheduler_deferred_dropped_total")
                    self.metrics.inc("scheduler_pods_bound_total", -1)
            if pruned:
                self.metrics.inc("scheduler_backoff_pruned_total", pruned)
        # Confirm-drain BEFORE any overlay: the raw reflector snapshot is
        # the watch's truth about which POSTed binds the API server has
        # actually confirmed — overlaid snapshots would self-confirm.
        self._drain_confirms(snapshot)
        # Control-plane ownership BEFORE any overlay is applied: a
        # takeover (new leadership / a newly acquired shard) must get to
        # revalidate stale assumed-bind state against the fresh
        # reflector cache before this cycle overlays it as bound.
        if self.leader_elect:
            was = self.is_leader
            try:
                self.is_leader = self.api.acquire_lease(self.lease_name, self.identity, self.lease_duration)
            except (ApiError, OSError, http.client.HTTPException) as e:
                # Can't reach the lease: fail SAFE — never schedule
                # without proof of leadership (a partitioned ex-leader
                # double-scheduling is the failure this exists to stop).
                logger.warning("lease acquire failed (%s); standing by", e)
                self.is_leader = False
            if self.is_leader and not was:
                self.metrics.inc("scheduler_leadership_acquisitions_total")
                logger.info("acquired leadership lease %s as %s", self.lease_name, self.identity)
                self._revalidate_pending = True
            if self.is_leader:
                self._ensure_renewal_thread()
        if self._revalidate_pending and self.is_leader:
            self._revalidate_overlays(snapshot)
            self._revalidate_pending = False
            if self.delta is not None:
                # Fresh leadership: the previous owner's commits may
                # predate our watch view — rebuild the SolveState from a
                # full wave, never revalidate residuals.
                self.delta.invalidate("takeover")
        # Degraded-mode bookkeeping: promote the breaker if its open
        # window elapsed, arm this cycle's half-open probe budget, then
        # flush recovered deferred binds / overlay the still-held ones.
        breaker_mode = self.breaker.mode()
        self._probe_left = self.breaker.config.probe_budget if breaker_mode == "half-open" else 0
        if self.deferred_binds:
            snapshot = self._flush_or_overlay_deferred(snapshot, breaker_mode)
        if self.pipeline:
            # Fold a FINISHED bind batch (never block — blocking here
            # would serialize the pipeline); then hide confirmed /
            # overlay in-flight assumptions onto the snapshot.
            if self._bind_inflight is not None and self._bind_inflight[1].is_set():
                self._join_binds()
            snapshot = self._prune_and_overlay_assumed(snapshot)
        if self.profile.preemption:
            # Observe PDB peak healthy EVERY cycle — standby cycles
            # included (a successor must not baseline a crashed workload
            # at its degraded count) — but only for preemption profiles:
            # nothing else consumes the proxy, and on the HTTP boundary
            # each observation is a real list_pdbs round-trip.
            self._update_pdb_peaks(snapshot)
        return snapshot

    # -- the loop ----------------------------------------------------------

    # hotpath: cycle-driver
    def run_cycle(self) -> CycleMetrics:
        t0 = time.perf_counter()
        self._cycle_unschedulable = []
        self._cycle_placed = []
        self._cycle_gangs = {}
        self._cycle_tag = self._cycle_count + 1
        self._cycle_notes = []
        self._delta_plan = None
        self._delta_avail = None
        self._cycle_bind_failures = 0
        self._explain_snapshot = None
        self._explain_budget = self.EXPLAIN_WORK
        set_log_cycle(self._cycle_tag)
        trace = Trace()
        with trace:
            with span("sync"):
                self.reflector.sync()
                err_delta = self.reflector.errors_seen - self._watch_errors_folded
                if err_delta:
                    # Watch failures become metrics, not crashes (the
                    # reference drops them from the stream, main.rs:138);
                    # the cycle proceeds on last-known reflector state.
                    self.metrics.inc("scheduler_watch_errors_total", err_delta)
                    self._watch_errors_folded = self.reflector.errors_seen
                    # Watch failures are API-brownout evidence too (capped:
                    # two reflectors contribute at most a couple per cycle,
                    # and a backlog of folded errors must not flood the
                    # breaker's rolling window in one cycle).
                    self.breaker.record(False, n=min(int(err_delta), 4))
                elif self.reflector.healthy:
                    self.breaker.record(True)
                snapshot = self.reflector.snapshot()
            # The "overlay" phase: every ledger/ownership/degraded-mode step
            # between the snapshot and the scheduling decision — previously
            # unattributed wall that landed in `other` (the coverage gate's
            # first casualty on steady-state cycles).
            with span("overlay"):
                snapshot = self._pre_cycle_overlay(snapshot)
            if self.leader_elect and not self.is_leader:
                # Standby (no lease): the reflector
                # cache above stays warm (fast takeover); scheduling belongs
                # to the owners.  Local state (requeue backoffs) is NOT
                # pruned on standby cycles — a transient lease failure must
                # not wipe the backoff ledger.
                pending_all = []
                pending = []
                eligible_all = []
            else:
                with span("noexecute"):
                    evicted = self._evict_noexecute(snapshot)
                    if evicted:
                        # Evicted pods leave the cycle immediately: their
                        # capacity frees for this very cycle's placements.
                        snapshot = ClusterSnapshot.build(
                            snapshot.nodes, [p for p in snapshot.pods if full_name(p) not in evicted]
                        )
                with span("queue"):
                    pending_all = snapshot.pending_pods()
                    pending = self._eligible(pending_all)
                    # Prune requeue backoffs for pods that no longer exist /
                    # are no longer pending (deleted, or bound out-of-band).
                    pending_names = {full_name(p) for p in pending_all}
                    for gone in [k for k in self.requeue_at if k not in pending_names]:
                        del self.requeue_at[gone]
                # Incremental engine (delta/): classify this cycle's watch
                # deltas, close the invalidation set, and — on the delta
                # path — shrink the solve to the dirty pods with the carried
                # residual capacity riding into _pack.  ``None`` = escalate:
                # the cycle below runs the classic full wave and the engine
                # rebuilds at commit.
                eligible_all = pending
                if self.delta is not None:
                    with span("delta"):
                        self._delta_plan = self.delta.plan(
                            snapshot,
                            pending,
                            pending_all,
                            self._packed,
                            self.reflector.node_set_signature(),
                            preempting=self.profile.preemption,
                        )
                    if self._delta_plan is not None:
                        pending = self._delta_plan.pods
                        self._delta_avail = self._delta_plan.alloc_used64
            if pending:
                # Schedule only eligible pods; bound pods — including
                # bound-but-still-Pending ones (kubelet lag) — count capacity.
                # (A second "queue" interval: the rebuild + gang census cost
                # accumulates into the same phase as the eligibility filter.)
                with span("queue"):
                    eligible_names = {full_name(p) for p in pending}
                    if self._delta_plan is not None:
                        # Delta cycle: a shared-cache VIEW of the snapshot
                        # with pending preset to the dirty set — zero
                        # object copies, no O(all pods) rebuild (the
                        # filtered rebuild below is the full-wave path's
                        # cost, exactly what the delta cycle shrinks away).
                        cycle_snapshot = self._reduced_view(snapshot, pending)
                    elif len(pending) == len(pending_all):
                        # Every pending pod is eligible (no requeue backoffs
                        # in force): the filtered rebuild would reproduce the
                        # snapshot verbatim, and at flagship scale one
                        # ClusterSnapshot.build over 200k+ pods costs seconds.
                        cycle_snapshot = snapshot
                    else:
                        cycle_snapshot = ClusterSnapshot.build(
                            snapshot.nodes,
                            [
                                p
                                for p in snapshot.pods
                                if p.status.phase != "Pending" or is_pod_bound(p) or full_name(p) in eligible_names
                            ],
                        )
                    # Gang membership over ALL pending pods — including ones
                    # in requeue backoff (excluded from cycle_snapshot): a
                    # gang with any ineligible member must never look
                    # complete to the eligible subset.
                    self._cycle_gangs = {}
                    for p in pending_all:
                        if p.spec is not None and p.spec.gang:
                            self._cycle_gangs.setdefault(p.spec.gang, set()).add(full_name(p))
                    # The cycle snapshot CARRIES the compiled interconnect
                    # topology (node-distance tensor + per-level membership):
                    # pack, scoring, and the admitted-gang locality metrics
                    # below all read the same resolved hierarchy.
                    compiled_topo = self._compiled_topology(cycle_snapshot)
                    if compiled_topo is not None:
                        cycle_snapshot.attach_topology(compiled_topo)
                    self._explain_snapshot = cycle_snapshot
                    self.recorder.seen_many(eligible_names, self._cycle_tag)
                if self.policy == "batch":
                    bound, unsched, rounds = self._run_batch_cycle(cycle_snapshot, trace)
                else:
                    bound, unsched = self._run_sample_cycle(cycle_snapshot, pending)
                    rounds = self.attempts
                if self.profile.preemption and self._cycle_unschedulable:
                    with span("preempt"):
                        p_bound, _victims = self._attempt_preemption(cycle_snapshot)
                    bound += p_bound
                    unsched -= p_bound
                if self._cycle_gangs:
                    with span("gang"):
                        self._account_gangs(eligible_names, compiled_topo)
            else:
                bound, unsched, rounds = 0, 0, 0
            if not (self.leader_elect and not self.is_leader):
                if self.delta is not None:
                    # Fold the cycle's outcome into the SolveState: delta
                    # cycles commit placements/verdicts incrementally; full
                    # waves rebuild wholesale (counting the escalation).
                    # Deferred binds committed here flush later as watch
                    # no-ops — exactly-once by the placements ledger.
                    with span("delta"):
                        with span("commit"):
                            self.delta.commit(
                                self._delta_plan,
                                snapshot,
                                self._packed,
                                self.reflector.node_set_signature(),
                                self._cycle_placed,
                                self._cycle_unschedulable,
                                pending_all,
                                self._res_memo,
                            )
                        if (
                            self._delta_plan is not None
                            and self.delta_shadow_every > 0
                            and self._cycle_tag % self.delta_shadow_every == 0
                        ):
                            with span("shadow"):
                                self._delta_shadow_check(snapshot, eligible_all, pending_all)
                # SLO burn bookkeeping (utils/profiler.SLO_TIERS): pods
                # leaving the pending set observe their final time-in-queue;
                # survivors drive the per-tier oldest-age/burn-rate gauges.
                # Standby cycles skip it — an empty owned set is not a
                # drained queue.
                with span("slo"):
                    self._update_pending_ages(pending_all)

        self._cycle_count += 1
        wall = time.perf_counter() - t0
        top = trace.top_level()
        # The breakdown fields are DERIVED from the same phase set the
        # {phase=} metric series uses (metrics.cycle_phases): a depth-0 span
        # outside that set is counted + warned, never silently `other`-ed.
        phase_set = cycle_phases()
        unknown = sorted(k for k in top if k not in phase_set)
        if unknown:
            self.metrics.inc("scheduler_unattributed_spans_total", len(unknown))
            for k in unknown:
                if k not in self._unknown_phase_warned:
                    self._unknown_phase_warned.add(k)
                    logger.warning(
                        "span %r is not a CycleMetrics phase field; its time stays in other_seconds "
                        "(add a %s_seconds field to CycleMetrics)", k, k,
                    )
        m = CycleMetrics(
            cycle=self._cycle_count,
            backend=self.backend.name if self.policy == "batch" else f"sample×{self.attempts}",
            pending=len(pending),
            bound=bound,
            unschedulable=unsched,
            rounds=rounds,
            wall_seconds=wall,
            # Everything without a phase field of its own (unknown depth-0
            # spans + loop glue).  Spans nest, so this subtracts only the
            # disjoint depth-0 phase totals.
            other_seconds=round(
                max(0.0, wall - sum(v for k, v in top.items() if k in phase_set)), 6
            ),
            **{f"{ph}_seconds": top.get(ph, 0.0) for ph in phase_set if ph != "other"},
        )
        self.metrics.observe_cycle(m)
        self.recorder.record_cycle(m.__dict__, trace.events, notes=self._cycle_notes)
        # Continuous profiler: fold this cycle's attribution tree into the
        # ring (outside the measured wall — the ring never inflates the
        # cycle it records) and publish the device-transfer delta.
        self.profile_ring.ingest(trace, wall)
        xfer = transfer_bytes_total()
        if xfer > self._xfer_folded:
            self.metrics.inc("scheduler_device_transfer_bytes_total", xfer - self._xfer_folded)
            self._xfer_folded = xfer
        set_log_cycle(None)
        return m

    def _delta_shadow_check(self, snapshot: ClusterSnapshot, eligible: list[Pod], pending_all: list[Pod]) -> None:
        """Shadow-solve parity (sampled): solve the FULL eligible
        set fresh — new pack, fresh capacity sweep, gang-aware — and assert
        the delta cycle placed exactly the same POD SET.  Placements may
        differ node-by-node (score tie-break freedom: the reduced pod axis
        reshuffles jitter rows); the placed set and therefore the
        unschedulable set may not — any difference is an invalidation-
        closure bug.  Cycles the contract does not cover record as skipped:
        bind-path failures (the API, not the solver, decided), a not-closed
        breaker, preempting profiles (the shadow does not preempt), and
        constrained batches (the stall mop-up runs outside the solver)."""
        if (
            self._cycle_bind_failures
            or self.breaker.mode() != "closed"
            or self.profile.preemption
            or self.deferred_binds
        ):
            self.delta.record_shadow(None)
            return
        view = self._reduced_view(snapshot, eligible)
        _, constrained = self._split_affinity_pending(view, eligible)
        if constrained:
            self.delta.record_shadow(None)
            return
        packed = self._attach_topology(
            pack_snapshot(view, pod_block=self.pod_block, node_block=self.node_block), view
        )
        saved_gangs = self._cycle_gangs
        gangs: dict[str, set[str]] = {}
        for p in pending_all:
            if p.spec is not None and p.spec.gang:
                gangs.setdefault(p.spec.gang, set()).add(full_name(p))
        self._cycle_gangs = gangs
        try:
            result = self._solve_gang_aware(packed, view)
        finally:
            self._cycle_gangs = saved_gangs
        shadow_placed = {pf for pf, _n in result.bindings}
        actual_placed = {full_name(p) for p, _n in self._cycle_placed}
        ok = shadow_placed == actual_placed
        detail = ""
        if not ok:
            only_full = sorted(shadow_placed - actual_placed)[:5]
            only_delta = sorted(actual_placed - shadow_placed)[:5]
            detail = f"full-only={only_full} delta-only={only_delta}"
        self.delta.record_shadow(ok, detail)

    def _account_gangs(self, eligible_names: set[str], compiled_topo) -> None:
        """Per-gang admission accounting (the ``gang`` phase).  Metrics
        counted ONCE per gang per cycle, from actual bind outcomes
        (dispatched, in pipeline mode) — not per scheduling scope (a split
        gang would otherwise multi-count) and not at admission (a per-member
        bind failure would overcount admissions)."""
        placed_names = {full_name(p) for p, _ in self._cycle_placed}
        node_of = {full_name(p): n.name for p, n in self._cycle_placed}
        for g, ms in sorted(self._cycle_gangs.items()):
            if ms <= placed_names:
                self.metrics.inc("scheduler_gangs_admitted_total")
                detail = g
                if compiled_topo is not None:
                    # Placement-locality verdict per admitted gang: worst
                    # pairwise interconnect distance into the histogram
                    # ("why is this gang slow" starts here), the full stats
                    # onto the members' timelines.
                    from ..topology.locality import gang_placement_stats

                    doms = [
                        d
                        for d in (compiled_topo.domains_of(node_of[m]) for m in sorted(ms))
                        if d is not None
                    ]
                    if len(doms) >= 2:
                        stats = gang_placement_stats(doms, compiled_topo.level_distances())
                        self.metrics.observe(
                            "scheduler_gang_placement_distance", stats["max_distance"]
                        )
                        detail = (
                            f"{g} max_dist={stats['max_distance']}"
                            f" mean_dist={stats['mean_distance']}"
                            f" cross_edges={stats['cross_edges']}"
                        )
                if self.recorder.enabled:
                    for nm in sorted(ms):
                        self.recorder.record(nm, "gang-admitted", self._cycle_tag, detail=detail)
            elif ms & eligible_names:
                self.metrics.inc("scheduler_gang_rejections_total")
                if self.recorder.enabled:
                    for nm in sorted(ms & eligible_names):
                        self.recorder.record(nm, "gang-refused", self._cycle_tag, detail=g)
                # Align the gang's retry deadlines.  Per-member backoff
                # resets desynchronize the gang: each cycle the eligible
                # subset is rejected (gang incomplete) and re-deadlined
                # while the rest still wait, so eligibility ping-pongs
                # between subsets forever and the gang never binds even
                # when capacity exists.  One shared deadline (the max —
                # every member's backoff is respected) makes the gang
                # eligible as a unit.
                deadlines = [self.requeue_at[m] for m in ms if m in self.requeue_at]
                if deadlines:
                    align = max(deadlines)
                    for m in ms & self.requeue_at.keys():
                        self.requeue_at[m] = align

    def run(
        self,
        max_cycles: int | None = None,
        until_settled: bool = False,
        daemon_interval: float | None = None,
        stop_event=None,
        sleep=time.sleep,
    ) -> list[CycleMetrics]:
        """Run cycles; with ``until_settled`` stop once a cycle binds nothing
        and nothing new is pending (the steady state a test/bench wants).

        ``daemon_interval`` switches to long-running daemon mode — the shape
        the reference's ``tokio::select!`` loop serves (main.rs:146-149):
        never exit on settle; after an idle cycle (nothing bound), sleep the
        interval before polling the watches again instead of hot-spinning.
        ``stop_event`` (a ``threading.Event``) requests a clean exit between
        cycles.

        A run may not settle on stale state: with ``until_settled``, an idle
        cycle whose watches are erroring/backing off does NOT count as
        settled (otherwise a transient API-server outage at startup would
        exit 0 having scheduled nothing) — the loop rides out the backoff up
        to ``settle_timeout`` seconds of consecutive unhealthy idling, then
        fails loudly."""
        out = []
        ran = 0
        settle_timeout = 60.0
        unhealthy_idle = 0.0
        flush_tries = 0
        try:
            return self._run_loop(out, ran, max_cycles, until_settled, daemon_interval, stop_event, sleep, settle_timeout, unhealthy_idle, flush_tries)
        finally:
            if self.pipeline:
                self._join_binds()  # even on an unhealthy-watch raise, never leave binds in flight

    def _run_loop(self, out, ran, max_cycles, until_settled, daemon_interval, stop_event, sleep, settle_timeout, unhealthy_idle, flush_tries):
        while max_cycles is None or ran < max_cycles:
            if stop_event is not None and stop_event.is_set():
                break
            m = self.run_cycle()
            out.append(m)
            ran += 1
            if daemon_interval is not None:
                if len(out) > 256:
                    del out[0]  # bounded history — a daemon runs unbounded cycles
                if m.bound == 0:
                    if stop_event is not None:
                        stop_event.wait(daemon_interval)
                    else:
                        sleep(daemon_interval)
            elif until_settled and m.bound == 0:
                if self.leader_elect and not self.is_leader:
                    # A standby is never "settled" — it is waiting for
                    # leadership; idle a renewal interval and try again.
                    sleep(min(1.0, self.lease_duration / 3.0))
                    continue
                if self.pipeline and (self._bind_inflight is not None or self._assumed) and flush_tries < 8:
                    # In-flight/unconfirmed binds: fold their outcomes and
                    # run another cycle so failures requeue before settling
                    # (bounded tries — an unconfirmable assumption must not
                    # spin the loop forever).
                    self._join_binds()
                    flush_tries += 1
                    continue
                if self.deferred_binds:
                    # Deferred binds are waiting out an open circuit
                    # breaker: a run must not settle with decided-but-
                    # unPOSTed placements.  Ride out the open window like
                    # an unhealthy watch, bounded by the same settle
                    # timeout so a permanently dead server still fails
                    # loudly instead of parking forever.
                    wait = min(5.0, max(0.05, self.breaker.seconds_until_probe(self.clock())))
                    unhealthy_idle += wait
                    if unhealthy_idle >= settle_timeout:
                        raise RuntimeError(
                            f"circuit breaker {self.breaker.state} with {len(self.deferred_binds)} "
                            f"deferred binds after {settle_timeout:.0f}s of settling"
                        )
                    sleep(wait)
                    continue
                if self.reflector.healthy:
                    break
                # Sleep out the backoff window instead of spinning no-op
                # cycles against the same stale snapshot.
                wait = min(5.0, max(0.05, self.reflector.seconds_until_retry(self.clock())))
                unhealthy_idle += wait
                if unhealthy_idle >= settle_timeout:
                    raise RuntimeError(
                        f"watches unhealthy for {settle_timeout:.0f}s while settling; "
                        f"last error: {self.reflector.last_error}"
                    )
                sleep(wait)
            else:
                unhealthy_idle = 0.0
                flush_tries = 0
        return out

    def shards_snapshot(self) -> dict:
        """The /debug/shards payload, in its unsharded form (the sharded
        control plane waits for its port item)."""
        return {
            "enabled": False,
            "num_shards": self.num_shards,
            "replica_id": self.identity,
            "perf": self.profile_ring.brief(),
        }

    def _ensure_renewal_thread(self) -> None:
        """Kube-style background lease renewal at TTL/3: a cycle longer than
        the lease (pack+solve on a big cluster) must not let the lease lapse
        mid-cycle — the standby would win the CAS while this leader is still
        binding (split brain).  Renewal failure drops leadership so the next
        cycle stands down."""
        if self._renew_stop is not None:
            return
        self._renew_stop = stop = threading.Event()

        def renew():
            # ``stop`` is captured locally: close() nulls the attribute, and
            # the re-check right before the acquire shrinks the window in
            # which a renewal could slip past a shutdown.  The window is
            # CLOSED by close() joining this thread before it releases the
            # lease — a renewal can finish, but never land after the
            # release (the renew-after-release race, regression-tested via
            # FakeApiServer.lease_history).
            while not stop.wait(self.lease_duration / 3.0):
                if stop.is_set() or not self.is_leader:
                    continue
                try:
                    if not self.api.acquire_lease(self.lease_name, self.identity, self.lease_duration):
                        self.is_leader = False
                except (ApiError, OSError, http.client.HTTPException):
                    self.is_leader = False

        self._renew_thread = threading.Thread(target=renew, daemon=True)
        self._renew_thread.start()

    def _update_pending_ages(self, pending_all: list[Pod]) -> None:
        """SLO pending-age bookkeeping for one cycle (the ``slo`` phase).

        A pod entering the pending set is stamped with first-seen clock, its
        priority tier (utils/profiler.tier_of) and gang-ness; a pod LEAVING
        it (bound, deleted, or shard moved away) observes its final
        time-in-queue into ``scheduler_pending_age_seconds{tier=,gang=}``.
        Survivors drive ``scheduler_pending_oldest_age_seconds{tier=}`` and
        ``scheduler_slo_burn_rate{tier=}`` (oldest age over the tier's
        time-to-bind target; >1 = the tier's SLO is burning).  In sharded
        mode ages are per-owner: a rebalance restarts the clock on the new
        owner — conservative (under-reports pain), documented in README."""
        now = self.clock()
        live: set[str] = set()
        for p in pending_all:
            pf = full_name(p)
            live.add(pf)
            if pf not in self._pending_meta:
                gangness = "gang" if (p.spec is not None and p.spec.gang) else "solo"
                self._pending_meta[pf] = (now, tier_of(_pod_priority(p)), gangness)
        oldest: dict[str, float] = {}
        for pf, (since, tier, gangness) in list(self._pending_meta.items()):
            if pf not in live:
                self.metrics.observe(
                    "scheduler_pending_age_seconds", max(0.0, now - since), labels={"tier": tier, "gang": gangness}
                )
                del self._pending_meta[pf]
                continue
            age = now - since
            if age > oldest.get(tier, 0.0):
                oldest[tier] = age
        for tier, _floor, target in SLO_TIERS:
            age = oldest.get(tier, 0.0)
            self.metrics.set_gauge("scheduler_pending_oldest_age_seconds", round(age, 6), labels={"tier": tier})
            self.metrics.set_gauge(
                "scheduler_slo_burn_rate", round(age / target, 6) if target > 0 else 0.0, labels={"tier": tier}
            )

    def pending_age_debug(self, pod_full: str) -> dict | None:
        """The /debug/pods why-pending ``age`` block: how long this pod has
        been in the queue and which SLO tier it burns against.  Called from
        the HTTP thread; one GIL-atomic dict get (resilience_snapshot
        stance)."""
        meta = self._pending_meta.get(pod_full)
        if meta is None:
            return None
        since, tier, gangness = meta
        age = max(0.0, self.clock() - since)
        target = tier_target(tier)
        return {
            "age_seconds": round(age, 6),
            "tier": tier,
            "gang": gangness == "gang",
            "target_seconds": target,
            "burn_rate": round(age / target, 6) if target > 0 else None,
        }

    def slo_snapshot(self) -> dict:
        """Current per-tier pending-age summary (oldest/count), derived from
        one GIL-atomic copy of the tracker — the /debug/profile slo block."""
        now = self.clock()
        meta = dict(self._pending_meta)
        tiers: dict[str, dict] = {
            tier: {"pending": 0, "oldest_age_s": 0.0, "target_s": target, "burn_rate": 0.0}
            for tier, _floor, target in SLO_TIERS
        }
        for _pf, (since, tier, _gangness) in meta.items():
            t = tiers[tier]
            t["pending"] += 1
            t["oldest_age_s"] = max(t["oldest_age_s"], round(max(0.0, now - since), 6))
        for t in tiers.values():
            if t["target_s"] > 0:
                t["burn_rate"] = round(t["oldest_age_s"] / t["target_s"], 6)
        return tiers

    def profile_snapshot(self) -> dict:
        """The /debug/profile payload for THIS replica: the continuous
        ring's aggregated attribution tree, the kernel-build/transfer split, and
        the SLO burn summary.  Multi-replica deployments register this
        callable in a ReplicaProfileRegistry (utils/profiler.py) so
        /debug/profile?replica= can select and the default view can merge."""
        from ..utils.profiler import compile_stats

        return {
            "replica": self.identity,
            "shards_owned": None,
            "profile": self.profile_ring.snapshot(),
            "compile": compile_stats(),
            "device_transfer_bytes": transfer_bytes_total(),
            "slo": self.slo_snapshot(),
        }

    def latency_snapshot(self) -> dict:
        """The /debug/latency payload for THIS replica: per-tier time-to-bind
        decomposition sums over every confirm-drained pod, plus how many
        confirms are still outstanding.  Multi-replica deployments register
        this callable in a ReplicaLatencyRegistry (utils/profiler.py) so
        /debug/latency?replica= can select and the default view can merge.
        Reads take GIL-atomic whole-dict copies of main-loop-owned state —
        no lock needed (same stance as resilience_snapshot)."""
        tiers = {
            tier: {
                "count": acc["count"],
                "ttb_sum_s": round(acc["ttb_sum"], 9),
                "mean_ttb_s": round(acc["ttb_sum"] / acc["count"], 9) if acc["count"] else 0.0,
                "unattributed_sum_s": round(acc["unattributed_sum"], 9),
                "segments_sum_s": {seg: round(v, 9) for seg, v in acc["segments"].items()},
            }
            for tier, acc in dict(self._latency_tiers).items()
        }
        return {
            "replica": self.identity,
            "confirmed": sum(t["count"] for t in tiers.values()),
            "awaiting_confirm": len(self._pending_confirm),
            "tiers": tiers,
        }

    def resilience_snapshot(self) -> dict:
        """The /debug/resilience payload: breaker state + transition tail,
        backoff-queue stats by failure class, deferred-bind buffer fill.
        Called from the HTTP server thread; all three structures are
        written only by the main cycle loop, and the reads below take
        GIL-atomic whole-dict copies (the same benign-snapshot stance as
        the backends' _shards baseline) — no lock needed or taken."""
        now = self.clock()
        deferred = dict(self.deferred_binds)
        sample = dict(list(deferred.items())[:20])
        return {
            "breaker": self.breaker.debug(now),
            "backoff": self.requeue_at.debug(now),
            "deferred_binds": {"count": len(deferred), "capacity": self.flush_capacity, "sample": sample},
        }

    def close(self) -> None:
        """Release pipeline resources (drain the in-flight bind batch, stop
        the bind worker) and hand off leadership (standbys take over
        immediately instead of waiting out the lease).  Idempotent."""
        self._join_binds()
        if self._renew_stop is not None:
            # Stop AND JOIN the renewal thread BEFORE releasing: a renew
            # already past its stop-check would otherwise re-acquire the
            # lease AFTER the release below, leaving a zombie holder no
            # standby can take over from until the TTL lapses.
            self._renew_stop.set()
            if self._renew_thread is not None:
                self._renew_thread.join(timeout=5.0)
                self._renew_thread = None
            self._renew_stop = None
        if self._bind_queue is not None:
            self._bind_queue.put(None)  # worker-loop shutdown sentinel
            self._bind_queue = None
        if self.leader_elect and self.is_leader:
            try:
                self.api.release_lease(self.lease_name, self.identity)
            except (ApiError, OSError, http.client.HTTPException):
                pass  # the lease expires on its own
            self.is_leader = False
