"""Replica harness — the port of ``tpu_scheduler/sim/multi.py`` on its
single-replica path.

``MultiReplicaHarness`` runs the scheduler under test against ONE
``ChaosApiServer`` on ONE ``VirtualClock``.  In the JAX package it runs N
replicas over lease-owned shards and kills replicas on a schedule; the port
has one replica until the sharded control plane and the fleet are ported
(ROADMAP Queue 1 item 8), and no rebalancer or autoscaler until item 9.
``refuse_unported`` names the item a scenario waits for; the harness calls
it before it builds anything, and the constructor holds to it too.

The one replica is constructed exactly as the JAX harness constructs it
(the same rng label, no shard machinery), so the binding sequence — and the
fingerprint — is the JAX sim's.
"""

from __future__ import annotations

import random

from ..backends.base import SchedulingBackend
from ..runtime.controller import Scheduler

__all__ = ["AVAILABILITY_FIELDS", "MultiReplicaHarness", "refuse_unported"]

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


def refuse_unported(sc, rebalance="auto", autoscale="auto") -> None:
    """Raise ``NotImplementedError`` naming the scenario and the ROADMAP
    Queue 1 item(s) it waits for: more than one replica or a replica kill
    (item 8), a rebalancer or an autoscaler — the scenario's knob, or
    ``True`` passed for either switch (item 9)."""
    asked = [
        (f"{int(sc.replicas)} replicas", int(sc.replicas) > 1, 8),
        ("replica kills", bool(sc.replica_kills), 8),
        ("the rebalancer", bool(sc.rebalance) or rebalance is True, 9),
        ("the autoscaler", bool(sc.autoscale) or autoscale is True, 9),
    ]
    whats = [what for what, on, _item in asked if on]
    if not whats:
        return
    items = sorted({item for _what, on, item in asked if on})
    label = "item" if len(items) == 1 else "items"
    raise NotImplementedError(
        f"scenario {sc.name!r}: {', '.join(whats)} not ported yet "
        f"(ROADMAP Queue 1 {label} {' and '.join(str(i) for i in items)})"
    )


class MultiReplicaHarness:
    """The one-replica fleet the harness steps and reads its verdict from."""

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
        refuse_unported(sc, rebalance=bool(rebalance_on), autoscale=bool(autoscale_on))
        self.replicas = 1
        self.scheds: list[Scheduler] = [
            Scheduler(
                chaos,
                backend,
                profile=profile,
                requeue_seconds=sc.requeue_seconds,
                clock=clock,
                rng=random.Random(f"{seed}:sched"),
                events_buffer=events_buffer,
                topology=topology,
                # Incremental engine shadow sampling (delta/): deterministic
                # — span presence and parity verdicts are pure control flow,
                # so record/replay bit-identity holds.
                delta_shadow_every=getattr(sc, "delta_shadow_every", 0),
            )
        ]
        self.alive = [True]
        self.kills: list[dict] = []

    @property
    def primary(self) -> Scheduler:
        return self.scheds[0]

    def step(self) -> None:
        """One discrete-event step: cycle the replica (the chaos layer's
        ``actor`` stays 0, the one replica's index)."""
        self.primary.run_cycle()

    def merged_metrics(self) -> dict:
        """The counter snapshot (the JAX harness sums it across replicas;
        one replica's is its own)."""
        return dict(self.primary.metrics.snapshot())

    def availability_block(self, pending_final, double_binds: int) -> dict:
        """The scorecard ``availability`` verdict of a one-replica run: not
        enabled, nothing to take over, ``ok``."""
        out = {
            "enabled": False,
            "replicas": self.replicas,
            "shards": 0,
            "lease_duration_s": None,
            "kills": self.kills,
            "max_takeover_latency_s": None,
            "takeover_bound_s": None,
            "lease_outage_credit_s": None,
            "orphaned_pods": 0,
            "orphaned_reservations": 0,
            "double_binds": int(double_binds),
            "ok": True,
        }
        assert tuple(out) == AVAILABILITY_FIELDS, "availability block drifted from AVAILABILITY_FIELDS"
        return out
