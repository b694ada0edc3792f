"""Programmable chaos layer over ``FakeApiServer``.

Generalizes the runtime's one-off fault hooks — ``fail_next_bindings``
(runtime/fake_api.py) and the tests' hand-rolled ``FlakyWatch`` — into one
declarative, SEEDED fault surface the simulator (and any test) can drive:

  • binding 500s (``CreateBindingFailed``) at a configurable rate
  • virtual binding latency (advances a ``VirtualClock`` per POST — the
    in-process twin of a slow apiserver)
  • generic API errors on the scheduler-facing mutation/read endpoints
    (``delete_pod`` evictions, ``list_pdbs``)
  • watch drops (``ConnectionError``) and 410 Gone storms (``ApiError(410)``)
    raised from ``poll()`` — events stay queued, exactly the FlakyWatch
    contract, so the reflector's backoff-and-retry path is what recovers
  • lease-op faults on the coordination surface every control-plane
    protocol rides (shard leases, replica presence, gang reservations, the
    shard map): CAS 500s (``lease_error_rate``), refused acquires
    (``lease_refused_rate`` — the CAS loses as if a conflicting writer
    won), and virtual lease latency (``lease_latency_s``)
  • timed fault WINDOWS overriding any base rate over a virtual interval
    (an api-brownout is one window; a flap storm is several)

Every injection decision is drawn from one dedicated RNG in call order, and
every decision is exposed through ``decision_log`` so a trace can replay
the exact fault schedule bit-identically (sim/trace.py).  The wrapper is a
transparent proxy (``__getattr__``) for everything it does not fault, so it
drops into ``Scheduler(api=...)`` unchanged.

Port: a copy of ``tpu_scheduler/sim/chaos.py``, unchanged, over the
port's ``runtime/fake_api.FakeApiServer`` (the same method set).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..errors import CreateBindingFailed
from ..runtime.fake_api import ApiError, FakeApiServer

__all__ = ["ChaosConfig", "ChaosWindow", "ChaosApiServer", "ChaosWatch"]


@dataclass(frozen=True)
class ChaosWindow:
    """Rate overrides active during ``[start, end)`` virtual seconds; a
    ``None`` field inherits the base ``ChaosConfig`` rate.  Later windows in
    the tuple win where they overlap."""

    start: float
    end: float
    binding_error_rate: float | None = None
    binding_latency_s: float | None = None
    api_error_rate: float | None = None
    watch_drop_rate: float | None = None
    watch_gone_rate: float | None = None
    lease_error_rate: float | None = None
    lease_refused_rate: float | None = None
    lease_latency_s: float | None = None


@dataclass(frozen=True)
class ChaosConfig:
    """Base fault rates (probability per call; latency in virtual seconds)."""

    binding_error_rate: float = 0.0  # CreateBindingFailed per binding POST
    binding_latency_s: float = 0.0  # virtual seconds added per successful POST
    api_error_rate: float = 0.0  # ApiError(500) on delete_pod / list_pdbs
    watch_drop_rate: float = 0.0  # poll() raises ConnectionError
    watch_gone_rate: float = 0.0  # poll() raises ApiError(410) — Gone storm
    lease_error_rate: float = 0.0  # ApiError(500) on acquire/release/get lease
    lease_refused_rate: float = 0.0  # acquire_lease CAS refused (returns False)
    lease_latency_s: float = 0.0  # virtual seconds added per lease mutation
    windows: tuple[ChaosWindow, ...] = ()

    def rate(self, name: str, t: float) -> float:
        value = getattr(self, name)
        for w in self.windows:
            if w.start <= t < w.end:
                override = getattr(w, name)
                if override is not None:
                    value = override
        return value

    @property
    def any_faults(self) -> bool:
        base = any(
            getattr(self, f) > 0
            for f in (
                "binding_error_rate",
                "binding_latency_s",
                "api_error_rate",
                "watch_drop_rate",
                "watch_gone_rate",
                "lease_error_rate",
                "lease_refused_rate",
                "lease_latency_s",
            )
        )
        return base or bool(self.windows)


class ChaosWatch:
    """Watch proxy whose ``poll()`` may raise per the chaos schedule.  A
    faulted poll leaves the underlying queue untouched (events are delayed,
    never lost) — the same contract as the resilience tests' FlakyWatch,
    which is what makes the reflector's backoff the recovery path."""

    def __init__(self, chaos: "ChaosApiServer", inner, kind: str):
        self._chaos = chaos
        self._inner = inner
        self._kind = kind

    def poll(self):
        if self._chaos._decide("watch_drop_rate", f"watch-drop:{self._kind}"):
            raise ConnectionError(f"chaos: {self._kind} watch dropped")
        if self._chaos._decide("watch_gone_rate", f"watch-gone:{self._kind}"):
            raise ApiError(410, f"chaos: {self._kind} watch resourceVersion too old")
        return self._inner.poll()

    def close(self):
        return self._inner.close()


class ChaosApiServer:
    """Fault-injecting proxy around a ``FakeApiServer`` (or compatible).

    ``replay_decisions`` switches the layer from drawing its RNG to replaying
    a recorded decision sequence verbatim (sim/trace.py) — the schedule is
    then part of the trace, not a function of the config."""

    def __init__(
        self,
        inner: FakeApiServer,
        config: ChaosConfig | None = None,
        rng: random.Random | None = None,
        clock=None,
        replay_decisions: list | None = None,
    ):
        self.inner = inner
        self.config = config or ChaosConfig()
        self.rng = rng or random.Random(0)
        self.clock = clock or getattr(inner, "_clock", None) or (lambda: 0.0)
        # Injection counters by kind — the scorecard's chaos evidence.
        self.injected: dict[str, int] = {}
        # Every rate draw, in call order: (endpoint, injected, latency).
        self.decision_log: list[tuple[str, bool, float]] = []
        self._replay = list(replay_decisions) if replay_decisions is not None else None
        self._replay_pos = 0
        # Deterministic observation stream: (virtual t, pod_full, node) per
        # CONFIRMED binding — the harness's time-to-bind source and the
        # run's determinism fingerprint material.
        self.bind_log: list[tuple[float, str, str]] = []
        # Which replica POSTed each bind_log entry (parallel list, same
        # length): the multi-replica harness sets ``actor`` before each
        # replica's cycle so the scorecard can judge binds-while-open
        # against the POSTING replica's breaker, not every replica's.
        # Deliberately OUTSIDE bind_log so single-replica fingerprints are
        # byte-identical with pre-sharding traces.
        self.actor = 0
        self.bind_actors: list[int] = []
        # Scheduler-driven pod deletions that succeeded (preemption victims,
        # NoExecute evictions) — sanctioned removals, not lost pods.
        self.evict_log: list[tuple[float, str]] = []
        # Rebalancer deschedules that succeeded (rebalance/executor.py):
        # the pod returned to Pending for a delta-engine re-place.  The
        # harness drains this to keep its bound-pod bookkeeping exact (a
        # migrated pod's re-bind is a migration completing, never a
        # double-bind) and the scorecard derives orphaned-migration
        # evidence from it.  ``unbind_actors`` mirrors ``bind_actors``:
        # which replica issued each deschedule, so unbinds-while-open is
        # judged against the POSTING replica's breaker.
        self.unbind_log: list[tuple[float, str]] = []
        self.unbind_actors: list[int] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- decisions ----------------------------------------------------------

    def _decide(self, rate_name: str, endpoint: str) -> bool:
        rate = self.config.rate(rate_name, self.clock())
        if self._replay is not None:
            if rate <= 0:
                return False  # no draw happened at record time either
            if self._replay_pos >= len(self._replay):
                raise RuntimeError(f"chaos replay exhausted at {endpoint} (trace/config mismatch)")
            ep, inject, _lat = self._replay[self._replay_pos]
            if ep != endpoint:
                raise RuntimeError(f"chaos replay diverged: expected {ep!r}, got {endpoint!r}")
            self._replay_pos += 1
            if inject:
                self.injected[endpoint] = self.injected.get(endpoint, 0) + 1
            return inject
        if rate <= 0:
            return False
        inject = self.rng.random() < rate
        self.decision_log.append((endpoint, inject, 0.0))
        if inject:
            self.injected[endpoint] = self.injected.get(endpoint, 0) + 1
        return inject

    def _latency(self) -> float:
        return self.config.rate("binding_latency_s", self.clock())

    # -- faulted endpoints --------------------------------------------------

    def watch_nodes(self, *args, **kwargs) -> ChaosWatch:
        return ChaosWatch(self, self.inner.watch_nodes(*args, **kwargs), "Node")

    def watch_pods(self, *args, **kwargs) -> ChaosWatch:
        return ChaosWatch(self, self.inner.watch_pods(*args, **kwargs), "Pod")

    def create_binding(self, namespace: str, pod_name: str, target) -> None:
        if self._decide("binding_error_rate", "bind-500"):
            raise CreateBindingFailed(f"chaos: injected apiserver 500 binding {namespace}/{pod_name}")
        lat = self._latency()
        if lat > 0 and hasattr(self.clock, "advance"):
            # Virtual POST latency: the cycle's own clock moves, so requeue
            # deadlines and workload arrivals feel the slow apiserver.
            self.clock.advance(lat)
            self.injected["bind-latency"] = self.injected.get("bind-latency", 0) + 1
        self.inner.create_binding(namespace, pod_name, target)
        self.bind_log.append((round(self.clock(), 9), f"{namespace}/{pod_name}", target.name))
        self.bind_actors.append(self.actor)

    def delete_pod(self, namespace: str, name: str) -> None:
        if self._decide("api_error_rate", "delete-500"):
            raise ApiError(500, f"chaos: injected apiserver 500 deleting {namespace}/{name}")
        self.inner.delete_pod(namespace, name)
        self.evict_log.append((round(self.clock(), 9), f"{namespace}/{name}"))

    def unbind_pod(self, namespace: str, pod_name: str, expect_node: str | None = None) -> None:
        if self._decide("api_error_rate", "unbind-500"):
            raise ApiError(500, f"chaos: injected apiserver 500 descheduling {namespace}/{pod_name}")
        self.inner.unbind_pod(namespace, pod_name, expect_node)
        self.unbind_log.append((round(self.clock(), 9), f"{namespace}/{pod_name}"))
        self.unbind_actors.append(self.actor)

    def list_pdbs(self) -> list:
        if self._decide("api_error_rate", "list-pdbs-500"):
            raise ApiError(500, "chaos: injected apiserver 500 listing PDBs")
        return self.inner.list_pdbs()

    # -- lease endpoints (the coordination surface every control-plane
    # -- protocol rides: shard/replica/gang-reservation/shard-map leases) ----

    def _lease_latency(self) -> None:
        lat = self.config.rate("lease_latency_s", self.clock())
        if lat > 0 and hasattr(self.clock, "advance"):
            # Virtual CAS latency: the cycle's own clock moves, so lease
            # TTL deadlines feel the slow coordination plane.
            self.clock.advance(lat)
            self.injected["lease-latency"] = self.injected.get("lease-latency", 0) + 1

    def acquire_lease(self, name: str, holder: str, duration_seconds: float) -> bool:
        if self._decide("lease_error_rate", "lease-acquire-500"):
            raise ApiError(500, f"chaos: injected apiserver 500 acquiring lease {name}")
        if self._decide("lease_refused_rate", "lease-refused"):
            return False  # CAS lost — indistinguishable from a conflicting writer winning
        self._lease_latency()
        return self.inner.acquire_lease(name, holder, duration_seconds)

    def release_lease(self, name: str, holder: str) -> None:
        if self._decide("lease_error_rate", "lease-release-500"):
            raise ApiError(500, f"chaos: injected apiserver 500 releasing lease {name}")
        self._lease_latency()
        return self.inner.release_lease(name, holder)

    def get_lease(self, name: str) -> dict | None:
        if self._decide("lease_error_rate", "lease-get-500"):
            raise ApiError(500, f"chaos: injected apiserver 500 reading lease {name}")
        return self.inner.get_lease(name)
