"""Autoscaler — the elastic-capacity control loop.

One ``tick`` per scheduler cycle, run AFTER the rebalancer's so the
defragmenter's drains are visible before any capacity decision.  The
provider ``pump`` (provision joins, reclaim notices, grace-deadline kills)
runs EVERY tick — lifecycle latency must not quantize to the decision
cadence — while decisions themselves are cadence-gated, breaker-gated, and
cooldown-damped.  In sharded mode only the shard-0 owner ticks (the caller
gates), and in daemon mode (``AutoscaleConfig.background``) the catalog
what-if plans on a worker thread against the immutable snapshot view.

The scale-up path: whatif overflow → cost-aware SKU FFD (``pack_catalog``)
→ provider requests, at most ``max_per_tick``, only past the SLO-burn
trigger, and never while earlier provisions are still landing
(``inflight`` — buying again would double-count the same backlog).

The scale-down path (the rebalancer's drain protocol, elastic nodes ONLY): prefer
empty provider nodes beyond the warm ``reserve`` (the rebalancer's
drained-and-parked base nodes count toward the same reserve — the
hysteresis that keeps the two subsystems from fighting); a lightly-loaded
candidate is drained first — per-pod breaker-gated CAS unbinds, then
cordon, then the provider delete — and only when its pods provably fit
elsewhere, so a scale-down can never strand demand or orphan a pod.

Crash safety mirrors the rebalancer: no autoscaler-private durable state.
A crash between unbinds leaves pods Pending (the normal scheduling path
owns them); a crash between request and join loses nothing — the provider
record is the ledger and the next owner's pump joins the node.

Port: a copy of ``tpu_scheduler/autoscale/controller.py``, unchanged.  The
background plan worker runs the NumPy what-if only (no tensor, no CUDA
call); ``close()`` joins it.
"""

from __future__ import annotations

import threading
import time

from ..utils.tracing import span
from .policy import SKIP_REASONS, AutoscaleConfig, pack_catalog, throttle_reason
from .provider import ProviderError, QuotaExceeded, Stockout

__all__ = ["Autoscaler"]


class Autoscaler:
    """Owns the cadence, throttles, cooldown, and lifetime stats.  Written
    only by the owning scheduler's cycle loop; the HTTP debug thread reads
    GIL-atomic copies via ``stats()``."""

    def __init__(self, config: AutoscaleConfig | None = None, provider=None, metrics=None):
        if provider is None:
            raise ValueError("Autoscaler needs a provider")
        self.config = config or AutoscaleConfig()
        self.provider = provider
        self.metrics = metrics
        self.scale_ups: dict[str, int] = {}  # SKU -> provision requests issued
        self.scale_downs: dict[str, int] = {}  # SKU -> scale-down deletes
        self.skips: dict[str, int] = {}
        self.reclaim_notices_seen = 0
        self.reclaim_kills_seen = 0
        # Pod full names unbound by the scale-down drain protocol — the
        # scorecard's drain-orphan evidence (ordered, append-only).
        self.drain_unbound: list[str] = []
        self.last_decision: dict = {}
        self._tick = 0
        self._cooldown_left = 0
        # Wall-clock plan times (bench / debug evidence only — NEVER on
        # the scorecard, which must stay byte-identical).
        self.plan_walls: list[float] = []
        # Background mode: one worker, one request slot, one finished plan.
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
            self.metrics.inc("scheduler_autoscale_skips_total", labels={"reason": reason})

    def _decision(self, action: str, **detail) -> None:
        self.last_decision = {"tick": self._tick, "action": action, **detail}

    # -- the background plan seam ------------------------------------------

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
            snapshot, pending, drained_labeled, topo = req
            t0 = time.perf_counter()
            plan = self._whatif(snapshot, pending, drained_labeled, topo)
            wall = time.perf_counter() - t0
            with self._bg_lock:
                self._bg_plan = plan
                self.plan_walls.append(wall)

    def _whatif(self, snapshot, pending, drained_labeled: int, topo) -> dict:
        from ..rebalance.whatif import autoscaler_whatif

        return autoscaler_whatif(
            snapshot,
            pending,
            drained_labeled=drained_labeled,
            topo=topo,
            catalog=self.provider.catalog,
            quota_left=self.provider.quota_left(),
        )

    def _plan(self, snapshot, pending, drained_labeled: int, topo):
        """Inline mode: plan now.  Background mode: hand the request to the
        worker and return a previously finished plan if one is ready (None
        otherwise — this tick stands down and a later tick consumes it)."""
        if not self.config.background:
            t0 = time.perf_counter()
            plan = self._whatif(snapshot, pending, drained_labeled, topo)
            self.plan_walls.append(time.perf_counter() - t0)
            return plan
        if self._bg_thread is None:
            self._bg_thread = threading.Thread(target=self._bg_loop, daemon=True)
            self._bg_thread.start()
        with self._bg_lock:
            ready, self._bg_plan = self._bg_plan, None
            if ready is None and self._bg_request is None:
                self._bg_request = (snapshot, pending, drained_labeled, topo)
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

    # shape: (self: obj, snapshot: obj, pending: obj, topo: obj, burn: float,
    #   breaker_mode: obj, drained_labeled: int, unbind: obj, now: float) -> int
    def tick(
        self,
        snapshot,
        pending,
        *,
        topo=None,
        burn: float = 0.0,
        breaker_mode: str = "closed",
        drained_labeled: int = 0,
        unbind=None,
        now: float = 0.0,
    ) -> int:
        """One elastic-capacity step (see the module docstring's protocol).
        ``pending`` is the unplaced backlog AFTER this cycle's placements;
        ``drained_labeled`` counts the rebalancer's parked reserve nodes.
        Returns scale actions issued this tick (requests + deletes)."""
        self._tick += 1
        with span("pump"):
            pumped = self.provider.pump(now)
        self.reclaim_notices_seen += pumped["reclaim_notices"]
        self.reclaim_kills_seen += pumped["reclaim_kills"]
        if self.metrics is not None:
            if pumped["reclaim_notices"]:
                self.metrics.inc("scheduler_autoscale_reclaims_total", pumped["reclaim_notices"])
            self.metrics.set_gauge(
                "scheduler_autoscale_pending_provisions", float(self.provider.pending_provisions())
            )
        if self.config.every > 1 and (self._tick % self.config.every) != 0:
            return 0
        reason = throttle_reason(breaker_mode, self._cooldown_left)
        if reason == "cooldown":
            self._cooldown_left -= 1
        if reason is not None:
            self._skip(reason)
            return 0
        with span("plan"):
            plan = self._plan(snapshot, pending, drained_labeled, topo)
        if plan is None:
            return 0  # background plan pending — neither work nor a skip
        with span("scale"):
            demand = plan.get("sku_plan") or {}
            if (demand or plan.get("pending_unplaceable", 0)) and burn >= self.config.burn_trigger:
                return self._scale_up(demand, now)
            return self._scale_down(snapshot, drained_labeled, unbind, now)

    def _scale_up(self, demand: dict, now: float) -> int:
        """Issue the planned provision requests (bounded, quota/stockout
        tolerant) — or stand down while earlier ones are still landing."""
        if self.provider.pending_provisions():
            self._skip("inflight")
            return 0
        if not demand:
            # Overflow exists but the quota-aware plan found nothing to
            # buy — confirm against the provider (the quota authority)
            # with one probe of the cheapest SKU; a freed quota turns the
            # probe into a real scale-up.
            sku = min(self.provider.catalog, key=lambda s: (s.hourly_cost, s.name)).name
            try:
                self.provider.request(sku, now)
            except QuotaExceeded:
                self._skip("quota")
                return 0
            except Stockout:
                self._skip("stockout")
                return 0
            except ProviderError:
                self._skip("api-error")
                return 0
            self.scale_ups[sku] = self.scale_ups.get(sku, 0) + 1
            self._cooldown_left = self.config.cooldown
            self._decision("scale-up", requested=1, plan={sku: 1})
            if self.metrics is not None:
                self.metrics.inc("scheduler_autoscale_scale_ups_total", labels={"sku": sku})
            return 1
        issued = 0
        failed: dict[str, str] = {}
        for sku, count in sorted(demand.items()):
            for _ in range(count):
                if issued >= self.config.max_per_tick:
                    break
                try:
                    self.provider.request(sku, now)
                except QuotaExceeded:
                    failed[sku] = "quota"
                    break  # this SKU is capped for now; try the next one
                except Stockout:
                    failed[sku] = "stockout"
                    break
                except ProviderError:
                    self._skip("api-error")
                    return issued
                self.scale_ups[sku] = self.scale_ups.get(sku, 0) + 1
                issued += 1
                if self.metrics is not None:
                    self.metrics.inc("scheduler_autoscale_scale_ups_total", labels={"sku": sku})
            if issued >= self.config.max_per_tick:
                break
        if issued:
            self._cooldown_left = self.config.cooldown
            self._decision("scale-up", requested=issued, plan=dict(sorted(demand.items())))
        elif failed:
            # Every attempted SKU bounced — surface the dominant refusal.
            self._skip("quota" if "quota" in failed.values() else "stockout")
            self._decision("refused", errors=dict(sorted(failed.items())))
        return issued

    def _scale_down(self, snapshot, drained_labeled: int, unbind, now: float) -> int:
        """Retire elastic capacity: delete empty provider nodes beyond the
        warm reserve, else drain the least-loaded candidate through the
        unbind→cordon→delete protocol when its pods fit elsewhere."""
        ready = self.provider.ready_nodes()
        if not ready:
            self._skip("no-demand")
            return 0
        pods_by_node: dict[str, list] = {name: [] for name in ready}
        for name in ready:
            pods_by_node[name] = sorted(
                self.provider.api.list_pods(f"spec.nodeName={name}"), key=lambda p: p.metadata.name
            )
        empties = sorted(name for name in ready if not pods_by_node[name])
        if empties:
            removable = min(len(empties), max(0, drained_labeled + len(empties) - self.config.reserve))
            if removable <= 0:
                self._skip("reserve")
                return 0
            deleted = 0
            for name in empties[: min(removable, self.config.max_per_tick)]:
                if self.provider.delete(name, now):
                    sku = ready[name]
                    self.scale_downs[sku] = self.scale_downs.get(sku, 0) + 1
                    deleted += 1
                    if self.metrics is not None:
                        self.metrics.inc("scheduler_autoscale_scale_downs_total", labels={"sku": sku})
            if deleted:
                self._cooldown_left = self.config.cooldown
                self._decision("scale-down", deleted=deleted)
            return deleted
        # No empties: the reserve must already be parked elsewhere before a
        # live node is worth draining at all (hysteresis, again).
        if drained_labeled < self.config.reserve:
            self._skip("reserve")
            return 0
        name = min(ready, key=lambda n: (len(pods_by_node[n]), n))
        victims = pods_by_node[name]
        if len(victims) > self.config.drain_max_pods or not self._fits_elsewhere(snapshot, name, victims):
            self._skip("not-empty")
            return 0
        from ..api.objects import full_name

        for pod in victims:
            if unbind is None or not unbind(full_name(pod), name):
                self._skip("unbind-failed")
                return 0
            self.drain_unbound.append(full_name(pod))
        self.provider._cordon(name)  # the drain protocol's cordon step
        if not self.provider.delete(name, now):
            self._skip("api-error")  # a bind raced the drain; keep the node
            return 0
        sku = ready[name]
        self.scale_downs[sku] = self.scale_downs.get(sku, 0) + 1
        self._cooldown_left = self.config.cooldown
        self._decision("scale-down", deleted=1, drained=len(victims))
        if self.metrics is not None:
            self.metrics.inc("scheduler_autoscale_scale_downs_total", labels={"sku": sku})
        return 1

    def _fits_elsewhere(self, snapshot, candidate: str, victims) -> bool:
        """FFD the candidate's pods into the rest of the fleet's free,
        schedulable capacity — the no-stranded-demand precondition."""
        from ..api.objects import total_pod_resources
        from ..core.snapshot import node_allocatable, node_used_resources

        free = []
        for node in snapshot.nodes:
            if node.name == candidate:
                continue
            if node.spec is not None and node.spec.unschedulable:
                continue
            alloc = node_allocatable(node)
            used = node_used_resources(snapshot, node.name)
            free.append([int(alloc.cpu - used.cpu), int(alloc.memory - used.memory)])
        free.sort(key=lambda f: -f[0])
        reqs = []
        for pod in victims:
            r = total_pod_resources(pod)
            reqs.append((int(r.cpu), int(r.memory)))
        reqs.sort(key=lambda r: (-max(r[0], r[1]), r))
        for cpu, mem in reqs:
            placed = False
            for f in free:
                if f[0] >= cpu and f[1] >= mem:
                    f[0] -= cpu
                    f[1] -= mem
                    placed = True
                    break
            if not placed:
                return False
        return True

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime stats — strictly counts (deterministic control flow; no
        wall clock), consumed by the sim scorecard, /debug/autoscale,
        bench, and tests."""
        return {
            "enabled": True,
            "ticks": self._tick,
            "scale_ups": dict(sorted(self.scale_ups.items())),
            "scale_downs": dict(sorted(self.scale_downs.items())),
            "reclaim_notices": self.reclaim_notices_seen,
            "reclaim_kills": self.reclaim_kills_seen,
            "drain_unbound": len(self.drain_unbound),
            "skips": dict(sorted(self.skips.items())),
            "last_decision": dict(self.last_decision),
        }
