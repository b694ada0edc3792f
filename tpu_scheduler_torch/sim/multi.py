"""Multi-replica sim harness — N controllers, one chaos apiserver, one clock.

``MultiReplicaHarness`` runs N real ``Scheduler`` instances (each with its
own reflectors, breaker, and backoff ledgers) against ONE ``ChaosApiServer``
on ONE ``VirtualClock``, the pending set partitioned across lease-owned
shards (runtime/shards.py).  Each discrete-event step cycles every live
replica in index order — the fixed order is what keeps the shared chaos
rng's draw sequence, and therefore the whole run, bit-identical under
record/replay.

Replica kills are the chaos this harness adds: at each scheduled
``(virtual time, replica)`` point the replica's next cycle is interrupted
between solve and flush (a hook raises on the first binding POST decision,
so placements were computed but ZERO binds left the process) and the
replica is never cycled again — its leases are NOT released, exactly like a
crash.  Survivors must absorb the orphaned shards within
``2 × lease_duration``; the scorecard ``availability`` block holds that
bound, plus double-binds = 0 and orphaned-pods = 0, as a pass gate.

A 1-replica harness constructs the scheduler exactly as the single-replica
path always did (same rng label, no shard machinery), so every pre-existing
scenario's fingerprint is unchanged.

Port: a copy of ``tpu_scheduler/sim/multi.py`` over the port's
``Scheduler``.  The replicas share one backend and, where the scenario
turns the autoscaler on, one ``SimCloudProvider`` drawing from its own
``random.Random(f"{seed}:provider")`` stream, as in the JAX harness.
"""

from __future__ import annotations

import random

from ..backends.base import SchedulingBackend
from ..runtime.controller import Scheduler

__all__ = ["AVAILABILITY_FIELDS", "ReplicaKilled", "MultiReplicaHarness"]

# The closed schema of the scorecard ``availability`` block.
AVAILABILITY_FIELDS = (
    "enabled",
    "replicas",
    "shards",
    "lease_duration_s",
    "kills",
    "max_takeover_latency_s",
    "takeover_bound_s",
    "lease_outage_credit_s",
    "orphaned_pods",
    "orphaned_reservations",
    "double_binds",
    "ok",
)


class ReplicaKilled(Exception):
    """Raised from the pre-bind hook to crash a replica between solve and
    flush — placements decided, zero POSTs issued."""

    def __init__(self, replica: int):
        super().__init__(f"replica {replica} killed mid-cycle")
        self.replica = replica


class MultiReplicaHarness:
    """The replica fleet + kill schedule + takeover bookkeeping."""

    def __init__(
        self,
        sc,
        seed: int,
        clock,
        chaos,
        backend: SchedulingBackend,
        profile,
        events_buffer: int,
        topology,
        rebalance_on: bool = False,
        autoscale_on: bool = False,
    ):
        self.sc = sc
        self.clock = clock
        self.chaos = chaos
        self.replicas = max(1, int(sc.replicas))
        self.shards = int(sc.shards) if sc.shards > 0 else 2 * self.replicas
        # ONE provider per cluster (the cloud account), shared by every
        # replica: the shard-0 owner's autoscaler drives it, and a shard-0
        # takeover inherits the in-flight provisions and reclaim deadlines
        # because the ledger lives here, not in the dead replica.  Its rng
        # label ("provider") is its own stream — scheduler/chaos/workload
        # draw sequences are untouched, so old fingerprints hold.
        self.provider = None
        if autoscale_on:
            from ..autoscale import DEFAULT_CATALOG, SimCloudProvider

            catalog = tuple(
                s for s in DEFAULT_CATALOG if not sc.autoscale_skus or s.name in sc.autoscale_skus
            )
            self.provider = SimCloudProvider(
                chaos,
                clock=clock,
                rng=random.Random(f"{seed}:provider"),
                catalog=catalog,
                total_quota=int(sc.autoscale_quota),
                reclaim_rate=float(sc.autoscale_reclaim_rate),
                reclaim_grace_s=float(sc.autoscale_reclaim_grace_s),
            )
        self.scheds: list[Scheduler] = []
        for i in range(self.replicas):
            kwargs = dict(
                profile=profile,
                requeue_seconds=sc.requeue_seconds,
                clock=clock,
                # Replica 0 keeps the historic rng label so single-replica
                # scenarios stay fingerprint-identical with old traces.
                rng=random.Random(f"{seed}:sched" if i == 0 else f"{seed}:sched{i}"),
                events_buffer=events_buffer,
                topology=topology,
                # Incremental engine shadow sampling (delta/):
                # deterministic — span presence and parity verdicts are pure
                # control flow, so record/replay bit-identity holds.
                delta_shadow_every=getattr(sc, "delta_shadow_every", 0),
            )
            if rebalance_on:
                # Background rebalancer (rebalance/), INLINE
                # solve mode: a worker thread would race the VirtualClock,
                # so the sim runs the packing solve synchronously inside
                # the cadence-gated tick — every decision is control flow
                # and record/replay bit-identity holds.
                from ..rebalance import RebalanceConfig

                kwargs.update(
                    rebalance=RebalanceConfig(
                        every=int(sc.rebalance_every),
                        batch=int(sc.rebalance_batch),
                        max_migrations=int(sc.rebalance_migration_budget),
                    )
                )
            if autoscale_on:
                # Closed-loop autoscaler (autoscale/), INLINE
                # plan mode for the same VirtualClock reason as above.
                # Every replica gets an Autoscaler but only the shard-0
                # owner ticks (runtime/controller.py gates), so the shared
                # provider sees exactly one decision stream.
                from ..autoscale import AutoscaleConfig

                kwargs.update(
                    autoscale=AutoscaleConfig(
                        every=int(sc.autoscale_every),
                        burn_trigger=float(sc.autoscale_burn_trigger),
                        max_per_tick=int(sc.autoscale_max_per_tick),
                        cooldown=int(sc.autoscale_cooldown),
                        reserve=int(sc.autoscale_reserve),
                    ),
                    autoscale_provider=self.provider,
                )
            if self.replicas > 1:
                kwargs.update(shards=self.shards, identity=f"replica-{i}", lease_duration=sc.lease_duration)
            self.scheds.append(Scheduler(chaos, backend, **kwargs))
        self.alive = [True] * self.replicas
        self._kills = sorted((float(t), int(idx)) for t, idx in sc.replica_kills)
        self._kill_cursor = 0
        # One record per executed kill; takeover_latency_s fills in when
        # every orphaned shard is re-owned by a live replica.
        self.kills: list[dict] = []
        self._awaiting_takeover: list[dict] = []

    @property
    def primary(self) -> Scheduler:
        return self.scheds[0]

    # -- one discrete-event step --------------------------------------------

    def step(self) -> None:
        """Cycle every live replica in index order, executing kills due at
        the current virtual time during the victim's own cycle."""
        now = self.clock.now
        due: set[int] = set()
        while self._kill_cursor < len(self._kills) and self._kills[self._kill_cursor][0] <= now:
            due.add(self._kills[self._kill_cursor][1])
            self._kill_cursor += 1
        for i, sched in enumerate(self.scheds):
            if not self.alive[i]:
                continue
            self.chaos.actor = i
            if i in due:
                self._kill_during_cycle(i, sched)
            else:
                sched.run_cycle()
        self._resolve_takeovers()

    def _kill_during_cycle(self, i: int, sched: Scheduler) -> None:
        """Crash the replica between solve and flush: the hook fires on its
        first binding POST decision of the cycle.  A cycle with nothing to
        bind dies at cycle end instead — either way the replica never
        cycles again and never releases a lease."""

        def die(_ns, _name, _node):
            raise ReplicaKilled(i)

        sched.pre_bind_hook = die
        try:
            sched.run_cycle()
        except ReplicaKilled:
            pass
        finally:
            sched.pre_bind_hook = None
        self.alive[i] = False
        orphans = sorted(sched.shard_set.owned) if sched.shard_set is not None else []
        rec = {
            "replica": i,
            "at": round(self.clock.now, 6),
            "orphan_shards": orphans,
            "takeover_latency_s": None,
        }
        self.kills.append(rec)
        if orphans:
            self._awaiting_takeover.append(rec)
        else:
            rec["takeover_latency_s"] = 0.0

    def _live_owned(self) -> set[int]:
        owned: set[int] = set()
        for i, sched in enumerate(self.scheds):
            if self.alive[i] and sched.shard_set is not None:
                owned.update(sched.shard_set.owned)
        return owned

    def _resolve_takeovers(self) -> None:
        if not self._awaiting_takeover:
            return
        owned_now = self._live_owned()
        resolved = []
        for rec in self._awaiting_takeover:
            if all(s in owned_now for s in rec["orphan_shards"]):
                rec["takeover_latency_s"] = round(self.clock.now - rec["at"], 6)
                resolved.append(rec)
        for rec in resolved:
            self._awaiting_takeover.remove(rec)

    # -- verdict inputs -----------------------------------------------------

    def merged_metrics(self) -> dict:
        """Counter snapshots summed across replicas (numeric values only;
        single-replica runs reduce to the one snapshot unchanged)."""
        out: dict = {}
        for sched in self.scheds:
            for k, v in sched.metrics.snapshot().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
                elif k not in out:
                    out[k] = v
        return out

    def _shard_of(self, pod) -> int:
        """Keyer-consistent pod→shard: a live replica's installed ShardKeyer
        (the fleet's topology keying) judges ownership exactly as the
        controllers do; the flat module hash is the fallback for fleets that
        never compiled one."""
        for i, sched in enumerate(self.scheds):
            if self.alive[i] and sched.shard_set is not None:
                return sched.shard_set.shard_of(pod)
        from ..runtime.shards import shard_of_pod

        return shard_of_pod(pod, self.shards)

    def _lease_outage_overlap(self, t0: float, t1: float) -> float:
        """Virtual seconds within [t0, t1] during which the lease CAS
        endpoints were HARD down (an injected error or refusal rate >= 1.0).
        No scheduler can complete a takeover through a dead CAS, so the
        takeover bound credits exactly this overlap — found by the chaos
        fuzzer (a replica kill composed with a total lease-500 window made
        the physically-optimal takeover miss the fixed bound by the outage
        length).  Partial brownouts (< 1.0) leave retries a way through and
        still count against the budget."""
        cfg = getattr(self.chaos, "config", None)
        if cfg is None:
            return 0.0
        total = 0.0
        for w in cfg.windows:
            hard = max(w.lease_error_rate or 0.0, w.lease_refused_rate or 0.0)
            if hard >= 1.0:
                total += max(0.0, min(t1, float(w.end)) - max(t0, float(w.start)))
        return total

    def availability_block(self, pending_final, double_binds: int) -> dict:
        """The scorecard ``availability`` verdict.  ``ok`` requires zero
        double-binds, zero orphaned pods (a final-pending pod whose shard no
        live replica owns has no controller responsible for it), zero
        orphaned gang reservations (an unexpired reservation lease held by a
        dead replica would wedge peer capacity past the settle), and every
        kill's takeover resolved within 2 × lease_duration of virtual
        time — plus, per kill, the hard-lease-outage credit above."""
        enabled = self.replicas > 1
        out = {
            "enabled": enabled,
            "replicas": self.replicas,
            "shards": self.shards if enabled else 0,
            "lease_duration_s": round(float(self.sc.lease_duration), 6) if enabled else None,
            "kills": self.kills,
            "max_takeover_latency_s": None,
            "takeover_bound_s": round(2.0 * float(self.sc.lease_duration), 6) if enabled else None,
            "lease_outage_credit_s": 0.0 if enabled else None,
            "orphaned_pods": 0,
            "orphaned_reservations": 0,
            "double_binds": int(double_binds),
            "ok": True,
        }
        if not enabled:
            return out
        owned_now = self._live_owned()
        out["orphaned_pods"] = sum(1 for p in pending_final if self._shard_of(p) not in owned_now)
        from ..fleet.reservation import count_orphaned_reservations

        live = {sched.identity for i, sched in enumerate(self.scheds) if self.alive[i]}
        out["orphaned_reservations"] = count_orphaned_reservations(self.chaos, self.clock.now, live)
        latencies = [rec["takeover_latency_s"] for rec in self.kills]
        resolved = [lat for lat in latencies if lat is not None]
        if resolved:
            out["max_takeover_latency_s"] = round(max(resolved), 6)
        takeovers_ok = True
        max_credit = 0.0
        for rec in self.kills:
            lat = rec["takeover_latency_s"]
            if lat is None:
                takeovers_ok = False
                continue
            credit = self._lease_outage_overlap(rec["at"], rec["at"] + lat)
            max_credit = max(max_credit, credit)
            if lat > out["takeover_bound_s"] + credit:
                takeovers_ok = False
        out["lease_outage_credit_s"] = round(max_credit, 6)
        out["ok"] = bool(
            double_binds == 0
            and out["orphaned_pods"] == 0
            and out["orphaned_reservations"] == 0
            and takeovers_ok
        )
        return out
