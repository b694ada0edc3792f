"""Rebalancer — the background tier's control loop.

One ``tick`` per scheduler cycle (cheap no-op off the cadence), run AFTER
the cycle's scheduling work so the tier never sits on the critical path,
and — in daemon mode (``RebalanceConfig.background``) — with the packing
solve itself on a worker thread against the immutable snapshot view.

The drain protocol (per planned node, within ONE tick so no scheduling can
interleave):

  1. verify the node still hosts exactly the planned pods (anything else
     moved under the plan → ``victim-moved``, group abandoned);
  2. breaker-gated UNBIND of each pod (a 5xx/transport failure aborts the
     group — ``unbind-failed`` — and the node is NOT cordoned with pods
     still on it); each descheduled pod becomes Pending and flows through
     the reflector → DeltaIndex invalidation closure → SolveState release
     → delta-engine re-place, exactly like any watch event;
  3. cordon the now-EMPTY node with the ``REBALANCE_CORDON_LABEL`` marker
     so the spreading score cannot scatter the re-placements straight back
     — the occupied set shrinks monotonically.  Labeled nodes are the
     autoscaler's scale-down candidates (whatif.py).

Crash safety: there is NO rebalancer-private durable state.  A crash
between unbinds leaves pods Pending (owned by the normal scheduling path —
never orphaned); a crash after cordon leaves a labeled empty node any
successor's rebalancer recognizes (and pressure-release uncordons).  The
commit-exactly-once story is the SolveState ledger's: the unbind is one
CAS-guarded API call, and re-placement is an ordinary delta-cycle commit.

Pressure release: when the SLO burn rate or the pending backlog crosses the
throttle, the tick UNCORDONS every labeled node before standing down —
reserve capacity returns to the cluster the moment demand needs it (the
node-remove half of the autoscaler loop, inverted on demand).

Port: a copy of ``tpu_scheduler/rebalance/executor.py``, unchanged.  The
background solve worker runs the NumPy solve only: it touches no tensor and
makes no CUDA call, and ``close()`` joins it.
"""

from __future__ import annotations

import threading
import time

from ..utils.tracing import span
from .planner import SKIP_REASONS, RebalanceConfig, select_batch, throttle_reason
from .snapshot import RebalanceSnapshot
from .solver import solve_packing

__all__ = ["REBALANCE_CORDON_LABEL", "Rebalancer"]

# Node-label marker on rebalancer-drained (cordoned) nodes: distinguishes
# them from operator cordons, survives crashes, and names the scale-down
# candidate set the autoscaler what-if reads.
REBALANCE_CORDON_LABEL = "rebalance.tpu-scheduler/drained"


# protocol: machine drain-migration field=- init=verify
# protocol: states: verify | unbound | cordoned | replaced | aborted
# protocol: verify -> unbound | aborted
# protocol: unbound -> cordoned | replaced | aborted
# protocol: cordoned -> replaced | aborted
# protocol: var bound: 0..1 = 1
# protocol: var pending: 0..1 = 0
# protocol: action unbind: verify -> unbound requires bound == 1 effect bound = 0, pending = 1
# protocol: action skip: verify -> aborted
# protocol: action cordon: unbound -> cordoned
# protocol: action replace: unbound -> replaced requires pending == 1 effect pending = 0, bound = 1
# protocol: action replace-cordoned: cordoned -> replaced requires pending == 1 effect pending = 0, bound = 1
# protocol: env crash: verify -> aborted
# protocol: env crash-unbound: unbound -> aborted
# protocol: env crash-cordoned: cordoned -> aborted
# protocol: action rescue: aborted -> aborted requires pending == 1 effect pending = 0, bound = 1
# protocol: invariant never-orphaned: bound == 1 or pending == 1
# protocol: progress pending-replaced: pending == 1
class Rebalancer:
    """Owns the cadence, throttles, in-flight ledger, and lifetime stats.
    Written only by the owning scheduler's cycle loop; the HTTP debug
    thread reads GIL-atomic copies via ``stats()``.

    The ``# protocol:`` contract above models one victim pod through the
    verify→unbind→cordon→re-place drain (model-only: per-pod state lives
    in the ``inflight`` ledger rows, not a field).  The unbind CAS
    atomically turns a bound pod into a pending one (``effect bound = 0,
    pending = 1``), so MODL proves ``never-orphaned`` — at every reachable
    point, including a scheduler crash between any two steps, the pod is
    either still bound or pending for the normal scheduling path
    (``rescue``) to place.  ``pending-replaced`` proves a pending victim
    can never wedge."""

    def __init__(self, config: RebalanceConfig | None = None, metrics=None):
        self.config = config or RebalanceConfig()
        self.metrics = metrics
        # pod full name -> {"src", "reason", "tick"} per issued migration
        # awaiting re-placement (at most one batch outstanding).
        self.inflight: dict[str, dict] = {}
        self.solves = 0
        self.planned = 0
        self.executed = 0
        self.completed = 0
        self.vanished = 0
        self.stalled = 0
        self.nodes_drained = 0
        self.pressure_releases = 0
        self.skips: dict[str, int] = {}
        self.last_plan: dict = {}
        self._tick = 0
        # Wall-clock solve times (bench / debug evidence only — NEVER on
        # the scorecard, which must stay byte-identical).
        self.solve_walls: list[float] = []
        # Background mode: one worker, one (snapshot, topo, pdbs) request
        # slot, one finished plan slot.
        self._bg_lock = threading.Lock()
        self._bg_request = None  # guarded-by: _bg_lock
        self._bg_plan = None  # guarded-by: _bg_lock
        self._bg_event = threading.Event()
        self._bg_thread: threading.Thread | None = None
        self._bg_stop = False

    # -- bookkeeping --------------------------------------------------------

    def _skip(self, reason: str) -> None:
        assert reason in SKIP_REASONS, reason
        self.skips[reason] = self.skips.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.inc("scheduler_rebalance_skips_total", labels={"reason": reason})

    # shape: (self: obj, snapshot: obj) -> int
    def reconcile(self, snapshot) -> int:
        """Resolve the in-flight ledger against the live snapshot: a pod
        bound again is a COMPLETED migration; a pod gone entirely counts
        vanished (the workload deleted it mid-flight — not an orphan, there
        is nothing left to place); a pod pending past ``stale_after`` ticks
        counts stalled and is dropped from the ledger (the normal
        scheduling path owns it either way).  Returns completions."""
        if not self.inflight:
            return 0
        from ..api.objects import full_name, is_pod_bound

        by_full = {full_name(p): p for p in snapshot.pods}
        done = 0
        for pf in list(self.inflight):
            p = by_full.get(pf)
            if p is not None and is_pod_bound(p):
                del self.inflight[pf]
                self.completed += 1
                done += 1
                if self.metrics is not None:
                    self.metrics.inc("scheduler_rebalance_migrations_completed_total")
            elif p is None:
                del self.inflight[pf]
                self.vanished += 1
            elif self._tick - self.inflight[pf]["tick"] >= self.config.stale_after:
                del self.inflight[pf]
                self.stalled += 1
        return done

    # -- the background solve seam -----------------------------------------

    def _bg_loop(self) -> None:
        while True:
            self._bg_event.wait()
            self._bg_event.clear()
            with self._bg_lock:
                if self._bg_stop:
                    return
                req, self._bg_request = self._bg_request, None
            if req is None:
                continue
            rs, topo = req
            t0 = time.perf_counter()
            plan = solve_packing(rs, topo, max_migrations=self.config.max_plan, headroom=self.config.headroom)
            wall = time.perf_counter() - t0
            with self._bg_lock:
                self._bg_plan = plan
                self.solve_walls.append(wall)

    def _solve(self, rs: RebalanceSnapshot, topo):
        """Inline mode: solve now.  Background mode: hand the request to
        the worker and return a previously finished plan if one is ready
        (None otherwise — this tick stands down and a later tick consumes
        the result)."""
        if not self.config.background:
            t0 = time.perf_counter()
            plan = solve_packing(rs, topo, max_migrations=self.config.max_plan, headroom=self.config.headroom)
            self.solve_walls.append(time.perf_counter() - t0)
            return plan
        if self._bg_thread is None:
            self._bg_thread = threading.Thread(target=self._bg_loop, daemon=True)
            self._bg_thread.start()
        with self._bg_lock:
            ready, self._bg_plan = self._bg_plan, None
            if ready is None and self._bg_request is None:
                self._bg_request = (rs, topo)
                self._bg_event.set()
        return ready

    def close(self) -> None:
        if self._bg_thread is not None:
            with self._bg_lock:
                self._bg_stop = True
            self._bg_event.set()
            self._bg_thread.join(timeout=5.0)
            self._bg_thread = None

    # -- the tick -----------------------------------------------------------

    # shape: (self: obj, snapshot: obj, topo: obj, pdbs: obj, burn: float,
    #   backlog: int, breaker_mode: obj, unbind: obj, cordon: obj,
    #   uncordon: obj, victim_ok: obj) -> int
    def tick(
        self,
        snapshot,
        *,
        topo=None,
        pdbs=(),
        burn: float = 0.0,
        backlog: int = 0,
        breaker_mode: str = "closed",
        unbind=None,
        cordon=None,
        uncordon=None,
        victim_ok=None,
    ) -> int:
        """One background-tier step (see the module docstring's protocol).
        ``pdbs=None`` means the PDB read failed — the tick stands down
        (``api-error``) rather than migrate a possibly protected pod.
        Returns the number of migrations issued this tick."""
        self._tick += 1
        self.reconcile(snapshot)
        on_cadence = self.config.every <= 1 or (self._tick % self.config.every) == 0
        if not on_cadence:
            return 0
        reason = throttle_reason(breaker_mode, burn, backlog, len(self.inflight), self.executed, self.config)
        if reason in ("slo-burn", "backlog") and uncordon is not None:
            released = 0
            for node in snapshot.nodes:
                if (node.metadata.labels or {}).get(REBALANCE_CORDON_LABEL) and uncordon(node):
                    released += 1
            if released:
                self.pressure_releases += released
                if self.metrics is not None:
                    self.metrics.inc("scheduler_rebalance_pressure_releases_total", released)
        if reason is not None:
            self._skip(reason)
            return 0
        if pdbs is None:
            self._skip("api-error")
            return 0
        with span("snapshot"):
            rs = RebalanceSnapshot.build(snapshot, pdbs, victim_ok)
        with span("solve"):
            plan = self._solve(rs, topo)
        if plan is None:
            return 0  # background solve pending — neither work nor a skip
        self.solves += 1
        self.planned += len(plan.migrations)
        self.last_plan = {
            "migrations": len(plan.migrations),
            "drained": len(plan.drained),
            "efficiency_before": plan.before["efficiency"],
            "efficiency_after": plan.after["efficiency"],
        }
        if self.metrics is not None:
            self.metrics.inc("scheduler_rebalance_solves_total")
        if not plan.migrations:
            self._skip("no-gain")
            return 0
        with span("plan"):
            budget_left = 0
            if self.config.max_migrations:
                budget_left = max(0, self.config.max_migrations - self.executed)
            groups = select_batch(plan, self.config.batch, budget_left)
        issued = 0
        with span("migrate"):
            from ..api.objects import full_name

            bound_by_node: dict[str, set[str]] = {}
            for p, node in snapshot.placed_pods():
                bound_by_node.setdefault(node.name, set()).add(full_name(p))
            for g in groups:
                src = g[0].src
                if bound_by_node.get(src, set()) != {m.pod_full for m in g}:
                    self._skip("victim-moved")
                    continue
                drained_clean = True
                for m in g:
                    if unbind is None or not unbind(m.pod_full, m.src):
                        self._skip("unbind-failed")
                        drained_clean = False
                        break
                    self.inflight[m.pod_full] = {"src": m.src, "reason": m.reason, "tick": self._tick}
                    self.executed += 1
                    issued += 1
                    if self.metrics is not None:
                        self.metrics.inc("scheduler_rebalance_migrations_total", labels={"reason": m.reason})
                if drained_clean and cordon is not None and cordon(src):
                    self.nodes_drained += 1
                    if self.metrics is not None:
                        self.metrics.inc("scheduler_rebalance_nodes_drained_total")
        return issued

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime stats — strictly counts and projected-efficiency floats
        (deterministic control flow; no wall clock), consumed by the sim
        scorecard, /debug/rebalance, bench, and tests."""
        return {
            "enabled": True,
            "ticks": self._tick,
            "solves": self.solves,
            "planned": self.planned,
            "executed": self.executed,
            "completed": self.completed,
            "vanished": self.vanished,
            "stalled": self.stalled,
            "inflight": len(self.inflight),
            "nodes_drained": self.nodes_drained,
            "pressure_releases": self.pressure_releases,
            "skips": dict(sorted(self.skips.items())),
            "last_plan": dict(self.last_plan),
        }
