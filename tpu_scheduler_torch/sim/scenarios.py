"""Named scenario registry — the seed-addressable robustness surface.

Every scenario is a complete experiment definition: workload shape, chaos
schedule, cadence, and policy knobs.  ``--scenario NAME --seed N`` fully
determines a run; the registry below is drift-gated against the README
"Simulation & chaos" catalogue by ``scripts/lint.py`` (SIMC, the METR-gate
pattern), so a scenario cannot ship undocumented.

All durations/rates are VIRTUAL seconds — a 2-minute scenario costs wall
clock proportional to the scheduling work, not the simulated time.

Port: a copy of ``tpu_scheduler/sim/scenarios.py``: all 25 scenarios, as
data; the port's harness runs every one.
"""

from __future__ import annotations

from dataclasses import dataclass

from .chaos import ChaosConfig, ChaosWindow
from .workload import WorkloadSpec

__all__ = ["Scenario", "SCENARIOS", "arrival_rate_variant"]


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    duration: float  # virtual seconds of workload generation
    workload: WorkloadSpec
    chaos: ChaosConfig = ChaosConfig()
    cycle_interval: float = 1.0  # virtual seconds between scheduler cycles
    requeue_seconds: float = 3.0  # failed-pod retry delay (virtual)
    watch_history: int = 1 << 18  # FakeApiServer retained watch events
    preemption: bool = False
    drain_grace_cycles: int = 12  # no-progress cycles after duration before stopping
    # Gate the scorecard pass on ZERO cross-rack gangs (the locality block):
    # for topology-labeled workloads where a single-rack fit always exists,
    # any cross-rack admission is a placement-quality regression.
    locality_required: bool = False
    # Multi-replica control plane (sim/multi.py): run this many controller
    # replicas against the one chaos apiserver, the pending set partitioned
    # into ``shards`` lease-owned shards (0 = 2 x replicas).  ``replica_kills``
    # lists (virtual time, replica index) crash points — the replica dies
    # between solve and flush of its next cycle (zero binds POSTed) and
    # NEVER releases its leases; survivors must absorb its shards within
    # 2 x lease_duration (the scorecard ``availability`` pass gate).
    replicas: int = 1
    shards: int = 0
    lease_duration: float = 5.0
    replica_kills: tuple[tuple[float, int], ...] = ()
    # Gate the scorecard pass on attribution coverage (the ``profile``
    # block, utils/profiler.py): steady-state-family scenarios must explain
    # ≥ 90% of their cycle wall through the span tree — an instrumentation
    # regression (a new unattributed cycle region) fails the run like an
    # SLO regression does.
    profile_required: bool = False
    # Compile-cache flatness (the scorecard ``compile`` block — the runtime
    # twin of the JITC static pass): ``compile_required`` gates the
    # scorecard pass on ZERO XLA compiles after the first
    # ``compile_warmup_cycles`` cycles.  Shape buckets are all traced
    # during warmup; a later compile means a raw per-cycle dim leaked into
    # a jit signature (a retrace leak the static pass missed).  Vacuously
    # green under the pure-numpy NativeBackend (the block's ``enabled`` bit
    # says so) — the jit-stability smoke drives the TpuBackend on CPU to
    # make the gate bite.
    compile_required: bool = False
    compile_warmup_cycles: int = 24
    # Incremental delta engine (tpu_scheduler/delta): ``delta_shadow_every``
    # > 0 runs the full-wave shadow solve beside every Nth delta cycle and
    # records placed-set parity; ``incremental_required`` gates the
    # scorecard pass on the ``incremental`` block's ok (shadow parity on
    # every sampled cycle AND full_solve_fraction <= 0.10).
    delta_shadow_every: int = 0
    incremental_required: bool = False
    # Background rebalancer (tpu_scheduler/rebalance): ``rebalance`` runs
    # the defrag tier inline on the cycle cadence (``rebalance_every``
    # cycles between ticks, ``rebalance_batch`` migrations per tick);
    # ``rebalance_required`` gates the scorecard pass on the ``rebalance``
    # block's ok — final packing efficiency >= ``rebalance_efficiency_gate``
    # (0 disables the efficiency gate), migrations within
    # ``rebalance_migration_budget`` (0 = unbounded), and ZERO orphaned
    # migrations.  ``rebalance_whatif`` computes the autoscaler what-if
    # block (node-add need for the final backlog, scale-down headroom).
    rebalance: bool = False
    rebalance_every: int = 4
    rebalance_batch: int = 8
    rebalance_required: bool = False
    rebalance_efficiency_gate: float = 0.0
    rebalance_migration_budget: int = 0
    rebalance_whatif: bool = False
    # Policy objective (tpu_scheduler/learn): every scorecard carries the
    # ``policy`` block (the learned-objective scalar + component breakdown);
    # ``policy_required`` additionally gates the pass on
    # ``objective >= policy_objective_floor`` — the floor a tuned profile
    # must clear WITHOUT breaking any other gate.
    policy_required: bool = False
    policy_objective_floor: float = 0.0
    # Time-to-bind waterfall (utils/events.py + the scorecard ``latency``
    # block): ``latency_required`` gates the scorecard pass on the latency
    # block's ok — at least one measured pod AND every measured pod's
    # segment decomposition summing to its TTB within rounding (the
    # attribution-leak audit).
    latency_required: bool = False
    # Closed-loop autoscaler (tpu_scheduler/autoscale): ``autoscale`` runs
    # the elastic-capacity tier inline after the rebalancer's tick
    # (``autoscale_every`` cycles between decisions) against a shared
    # seeded SimCloudProvider; ``autoscale_required`` gates the scorecard
    # pass on the ``elasticity`` block's ok — the joint cost+SLO objective
    # (effective p99 TTB + ``autoscale_cost_weight`` × elastic node-hours)
    # <= ``autoscale_objective_gate`` (0 disables the gate) AND zero
    # reclaim orphans.  ``autoscale_skus`` restricts the DEFAULT_CATALOG
    # by name (empty = full catalog); ``autoscale_quota`` caps the
    # account-wide concurrent elastic node count (0 = unbounded);
    # ``autoscale_reclaim_rate`` is the spot-reclaim hazard (reclaims per
    # virtual second per spot node, 0 = never) with
    # ``autoscale_reclaim_grace_s`` of notice; ``autoscale_burn_trigger``,
    # ``autoscale_max_per_tick``, ``autoscale_reserve``, and
    # ``autoscale_cooldown`` are the AutoscaleConfig knobs.
    # End-state convergence (the fuzzer's quiescence oracle, sim/fuzz):
    # ``convergence_required`` gates the scorecard pass on the
    # ``convergence`` block's ok — after the last scheduled fault the
    # backlog must drain, live replicas' deferred buffers must flush, and
    # no unexpired shard/replica/reservation lease may be held by a dead
    # replica, all within the settle bound.  Off by default: scenarios with
    # a standing backlog by design (autoscaler-backlog-whatif) judge
    # convergence informationally, never as a gate.
    convergence_required: bool = False
    autoscale: bool = False
    autoscale_every: int = 2
    autoscale_required: bool = False
    autoscale_burn_trigger: float = 0.02
    autoscale_cost_weight: float = 0.0
    autoscale_objective_gate: float = 0.0
    autoscale_quota: int = 0
    autoscale_reclaim_rate: float = 0.0
    autoscale_reclaim_grace_s: float = 5.0
    autoscale_max_per_tick: int = 8
    autoscale_reserve: int = 1
    autoscale_cooldown: int = 4
    autoscale_skus: tuple[str, ...] = ()


SCENARIOS: dict[str, Scenario] = {}


def _register(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


_register(
    Scenario(
        name="steady-state",
        description="Poisson arrivals with pod completions at ~70% utilization; the healthy-daemon baseline every other scenario deviates from",
        duration=120.0,
        workload=WorkloadSpec(
            initial_nodes=60,
            arrival_rate=15.0,
            lifetime_mean_s=25.0,
            gang_fraction=0.05,
            selector_fraction=0.2,
            priority_tiers=(0, 0, 0, 5, 50),
        ),
        profile_required=True,
        latency_required=True,
        compile_required=True,
    )
)

_register(
    Scenario(
        name="burst-storm",
        description="Quiet background load punctured by 500-pod storms every 20 virtual seconds — tests backlog drain and time-to-bind tails",
        duration=100.0,
        workload=WorkloadSpec(
            initial_nodes=100,
            arrival_rate=2.0,
            bursts=((10.0, 500), (30.0, 500), (50.0, 500), (70.0, 500)),
            lifetime_mean_s=15.0,
            gang_fraction=0.1,
            priority_tiers=(0, 0, 5),
        ),
        latency_required=True,
    )
)

_register(
    Scenario(
        name="arrival-rate-sweep",
        description="The latency bench's scenario family: steady-state's cluster shape at a parameterized Poisson rate (arrival_rate_variant), pass-gated on the time-to-bind waterfall summing to TTB — bench.py latency_row sweeps the rate to put the TTB-vs-load curve on the record",
        duration=45.0,
        workload=WorkloadSpec(
            initial_nodes=60,
            arrival_rate=12.0,
            lifetime_mean_s=20.0,
            gang_fraction=0.05,
            selector_fraction=0.2,
            priority_tiers=(0, 0, 0, 5, 50),
        ),
        latency_required=True,
        # An oversubscribing rate variant drains only as lifetimes expire.
        drain_grace_cycles=25,
    )
)


# shape: (rate: obj) -> obj
def arrival_rate_variant(rate: float) -> Scenario:
    """The ``arrival-rate-sweep`` family member at a given Poisson rate —
    the parameterization bench.py's latency_row sweeps.  Variants are NOT
    registered (the registry stays the closed, README-documented set); the
    harness accepts Scenario objects directly."""
    from dataclasses import replace

    base = SCENARIOS["arrival-rate-sweep"]
    return replace(
        base,
        name=f"arrival-rate-{rate:g}",
        description=f"arrival-rate-sweep variant at {rate:g} pods/s",
        workload=replace(base.workload, arrival_rate=float(rate)),
    )


_register(
    Scenario(
        name="node-flap",
        description="Nodes repeatedly vanish and return (NotReady flaps) plus drains and permanent failures; bound pods re-arrive as Pending",
        duration=90.0,
        workload=WorkloadSpec(
            initial_nodes=40,
            arrival_rate=8.0,
            lifetime_mean_s=30.0,
            node_flap_rate=0.25,
            node_fail_rate=0.05,
            node_drain_rate=0.05,
            node_add_rate=0.05,
            flap_down_s=4.0,
        ),
        # Flapping clusters also stress the watch path: drops force backoff
        # + queued-event catch-up on top of the object churn.
        chaos=ChaosConfig(watch_drop_rate=0.05),
    )
)

_register(
    Scenario(
        name="api-brownout",
        description="The apiserver browns out mid-run: binding 500s, added binding latency, watch drops and a 410 Gone storm inside timed windows",
        duration=90.0,
        workload=WorkloadSpec(initial_nodes=50, arrival_rate=12.0, lifetime_mean_s=25.0),
        chaos=ChaosConfig(
            binding_latency_s=0.002,
            windows=(
                ChaosWindow(start=20.0, end=45.0, binding_error_rate=0.3, watch_drop_rate=0.3, binding_latency_s=0.02),
                ChaosWindow(start=55.0, end=65.0, watch_gone_rate=0.5, api_error_rate=0.2),
            ),
        ),
    )
)

_register(
    Scenario(
        name="api-brownout-recovery",
        description="A hard 20s API blackout (every binding POST 500s, watches drop): the circuit breaker must open, defer binds with ZERO POSTs while open, then probe half-open, flush the buffer, and drain the backlog after the window closes",
        duration=90.0,
        workload=WorkloadSpec(initial_nodes=50, arrival_rate=10.0, lifetime_mean_s=30.0),
        chaos=ChaosConfig(
            windows=(
                ChaosWindow(start=20.0, end=40.0, binding_error_rate=1.0, watch_drop_rate=0.5, api_error_rate=0.3),
            ),
        ),
        # The open window escalates (5 -> 10 -> 20s virtual) while probes
        # keep failing inside the blackout; give the post-window drain
        # enough grace to cover one full escalated re-open.
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="gang-heavy",
        description="40% of arrivals are 2-8 member gangs across priority tiers on an OVERSUBSCRIBED cluster with preemption on — all-or-nothing admission under real contention",
        duration=80.0,
        workload=WorkloadSpec(
            initial_nodes=10,
            arrival_rate=8.0,
            lifetime_mean_s=45.0,
            gang_fraction=0.4,
            gang_size_max=8,
            priority_tiers=(0, 1, 5, 50, 100),
        ),
        preemption=True,
        # Oversubscribed by design: the backlog drains only as lifetimes
        # expire, so give the post-duration drain a longer leash.
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="slice-fragmented-cluster",
        description="Topology-labeled fleet (8 racks x 2 slices) under mixed single-pod + gang load: fillers fragment free capacity while single-rack fits still exist everywhere — topology-aware scoring must admit EVERY gang with zero cross-rack edges (pass-gated), where blind scoring scatters them",
        duration=40.0,
        workload=WorkloadSpec(
            initial_nodes=48,
            slice_size=3,
            rack_size=6,
            arrival_rate=5.0,
            bursts=((2.0, 40),),  # the fragmenting filler/gang wave
            gang_fraction=0.45,
            gang_size_max=4,
            lifetime_mean_s=35.0,
        ),
        locality_required=True,
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="rack-failure-during-gang-admission",
        description="A whole rack dies mid-run while gangs are being admitted: every node in the picked rack vanishes, its pods re-arrive Pending, and admission must continue whole-gang on the surviving racks (invariants + replay bit-identity under rack-scale churn)",
        duration=40.0,
        workload=WorkloadSpec(
            initial_nodes=30,
            slice_size=0,
            rack_size=5,
            arrival_rate=6.0,
            gang_fraction=0.4,
            gang_size_max=5,
            lifetime_mean_s=25.0,
            rack_fail_times=(12.0,),
        ),
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="replica-kill-mid-cycle",
        description="Active-active sharded control plane: two replicas split four lease-owned shards; the busier replica is crash-killed between solve and flush (zero binds POSTed, leases never released) — the survivor must absorb the orphaned shards within 2x lease_duration with zero double-binds and zero orphaned pods (availability pass gate)",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=30,
            arrival_rate=6.0,
            lifetime_mean_s=25.0,
            gang_fraction=0.1,
            priority_tiers=(0, 0, 5),
        ),
        replicas=2,
        shards=4,
        lease_duration=5.0,
        replica_kills=((15.0, 0),),
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="mesh-rebind-on-takeover",
        description="Multi-mesh fleet failover (tpu_scheduler/fleet): a topology-labeled 4-rack fleet keys its four shards to contiguous rack slices (one device-mesh binding per owned shard); killing a replica mid-cycle forces the survivor to absorb the orphaned shards AND rebind them onto its own mesh — the delta engine must escalate exactly one mesh-rebind full wave, takeover within 2x lease_duration, zero double-binds, zero orphaned reservations",
        duration=40.0,
        workload=WorkloadSpec(
            initial_nodes=32,
            rack_size=8,
            arrival_rate=6.0,
            lifetime_mean_s=25.0,
            gang_fraction=0.1,
            priority_tiers=(0, 0, 5),
        ),
        replicas=2,
        shards=4,
        lease_duration=5.0,
        replica_kills=((15.0, 0),),
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="cross-shard-gang-admission",
        description="Cross-replica gang admission (tpu_scheduler/fleet): four replicas each own ONE rack-keyed shard (8 nodes) while gangs of up to 12 members arrive — wider than any single slice under the one-member-per-node proxy, so the owner must two-phase RESERVE peer shards, solve the gang against the widened slice, and COMMIT the reservation on admission; a lease brownout window exercises the all-or-nothing abort path, and the run must settle with zero double-binds and zero orphaned reservations",
        duration=40.0,
        workload=WorkloadSpec(
            initial_nodes=32,
            rack_size=8,
            arrival_rate=4.0,
            lifetime_mean_s=30.0,
            gang_fraction=0.35,
            gang_size_max=12,
            pod_cpu_m=(2000, 4000),
            pod_mem_mi=(512, 1024),
        ),
        chaos=ChaosConfig(
            windows=(ChaosWindow(start=18.0, end=24.0, api_error_rate=0.2, watch_drop_rate=0.1),),
        ),
        replicas=4,
        shards=4,
        lease_duration=5.0,
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="replica-kill-during-brownout",
        description="The replica-kill composed with the PR-4 circuit breaker: a hard binding blackout opens the owner's breaker (binds defer in memory), then the owner is crash-killed mid-brownout — its deferred buffer dies with it, the survivor re-places those pods through its OWN degraded mode, and the run must still end with zero double-binds and zero binds through an open breaker",
        duration=80.0,
        workload=WorkloadSpec(
            initial_nodes=30,
            arrival_rate=6.0,
            lifetime_mean_s=30.0,
        ),
        chaos=ChaosConfig(
            windows=(ChaosWindow(start=12.0, end=30.0, binding_error_rate=1.0, watch_drop_rate=0.3),),
        ),
        replicas=2,
        shards=4,
        lease_duration=5.0,
        replica_kills=((18.0, 0),),
        drain_grace_cycles=30,
    )
)

_register(
    Scenario(
        name="lease-brownout-during-takeover",
        description="The lease-fault surface composed with failover: the coordination plane browns out (lease CAS 500s, refused acquires, virtual lease latency) in a window spanning a replica crash-kill — the survivor's takeover CAS calls fail and retry through the hardened refuse-don't-raise path, and the run must still absorb the orphaned shards within 2x lease_duration with zero double-binds and a converged end state (pass-gated availability + convergence blocks)",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=30,
            arrival_rate=6.0,
            lifetime_mean_s=25.0,
            gang_fraction=0.1,
            priority_tiers=(0, 0, 5),
        ),
        chaos=ChaosConfig(
            windows=(
                ChaosWindow(start=12.0, end=28.0, lease_error_rate=0.3, lease_refused_rate=0.15, lease_latency_s=0.005),
            ),
        ),
        replicas=2,
        shards=4,
        lease_duration=5.0,
        replica_kills=((15.0, 0),),
        convergence_required=True,
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="churn-steady-state",
        description="The incremental engine's home turf: Poisson arrivals + completions at moderate utilization with NO node churn — the delta cycle must stay the default (full_solve_fraction <= 0.10) while the sampled full-wave shadow solve proves placed-set parity on every check (pass-gated incremental block)",
        duration=120.0,
        workload=WorkloadSpec(
            initial_nodes=60,
            arrival_rate=15.0,
            lifetime_mean_s=25.0,
            gang_fraction=0.05,
            selector_fraction=0.2,
            priority_tiers=(0, 0, 0, 5, 50),
        ),
        delta_shadow_every=8,
        incremental_required=True,
        compile_required=True,
    )
)

_register(
    Scenario(
        name="fragmentation-long-horizon",
        description="Long-horizon fragmentation: arrival waves place-and-spread across 24 nodes, completions thin the cluster to a sparse scatter, and the quiet tail belongs to the background rebalancer — the scorecard rebalance block must recover the packing-efficiency gate within the migration budget (pass-gated), where the rebalancer-off baseline stays fragmented and fails it",
        duration=120.0,
        workload=WorkloadSpec(
            initial_nodes=24,
            arrival_rate=0.0,
            bursts=((1.0, 90), (8.0, 70), (16.0, 60)),
            pod_cpu_m=(500, 1000, 2000),
            pod_mem_mi=(512, 1024, 2048),
            lifetime_mean_s=45.0,
        ),
        rebalance=True,
        rebalance_every=4,
        rebalance_batch=12,
        rebalance_required=True,
        rebalance_efficiency_gate=0.35,
        rebalance_migration_budget=160,
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="defrag-smoke",
        description="The defrag tier-1 gate: a 12-node single-wave fragmentation run sized to finish on CPU in seconds — the rebalancer must consolidate the surviving scatter past the efficiency gate within the migration budget while the rebalancer-off baseline fails the same gate (make defrag-smoke)",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=12,
            arrival_rate=0.0,
            bursts=((1.0, 90),),
            pod_cpu_m=(500, 1000, 2000),
            pod_mem_mi=(512, 1024, 2048),
            lifetime_mean_s=30.0,
        ),
        rebalance=True,
        rebalance_every=3,
        rebalance_batch=12,
        rebalance_required=True,
        rebalance_efficiency_gate=0.35,
        rebalance_migration_budget=120,
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="rebalance-under-chaos",
        description="Migrations composed with the chaos stack: a hard binding blackout opens the breaker mid-defrag (unbinds must defer — zero deschedules through an open breaker), then the shard-0 owner carrying the rebalancer is crash-killed — the survivor absorbs shard 0 and the background tier with it, and the run must end with zero double-binds and ZERO orphaned migrations (pass-gated rebalance + availability blocks)",
        duration=110.0,
        workload=WorkloadSpec(
            initial_nodes=20,
            arrival_rate=0.0,
            bursts=((1.0, 70), (10.0, 50)),
            pod_cpu_m=(500, 1000, 2000),
            pod_mem_mi=(512, 1024, 2048),
            lifetime_mean_s=40.0,
        ),
        chaos=ChaosConfig(
            windows=(
                # Mid-defrag blackout: every binding POST 500s AND the
                # deschedule endpoint itself faults — the breaker must
                # open, the rebalancer must stand down (breaker-open
                # skips), and zero unbinds may land inside the open spans.
                ChaosWindow(start=8.0, end=22.0, binding_error_rate=1.0, api_error_rate=0.4, watch_drop_rate=0.3),
            ),
        ),
        replicas=2,
        shards=4,
        lease_duration=5.0,
        replica_kills=((40.0, 0),),
        rebalance=True,
        rebalance_every=4,
        rebalance_batch=10,
        rebalance_required=True,
        rebalance_efficiency_gate=0.0,
        rebalance_migration_budget=200,
        drain_grace_cycles=30,
    )
)

_register(
    Scenario(
        name="autoscaler-backlog-whatif",
        description="The autoscaler what-if the packing tier makes answerable: an 8-node cluster buried under a forever-lived burst holds a standing pending backlog — the rebalancer must stand DOWN (backlog/SLO-burn throttle, counted skips), and the scorecard rebalance block's whatif must recommend a concrete node-add count that would clear the backlog (pass-gated consistency)",
        duration=30.0,
        workload=WorkloadSpec(
            initial_nodes=8,
            arrival_rate=0.0,
            bursts=((1.0, 140),),
            pod_cpu_m=(1000, 2000),
            pod_mem_mi=(1024, 2048),
            lifetime_mean_s=0.0,
        ),
        rebalance=True,
        rebalance_every=2,
        rebalance_batch=8,
        rebalance_required=True,
        rebalance_whatif=True,
        drain_grace_cycles=10,
    )
)

_register(
    Scenario(
        name="diurnal-traffic",
        description="The autoscaling steady-state gate: a 4-node base fleet sized for the trough rides two full diurnal waves (rate 2/s ± 100%, 60 s period) of chunky pods — the closed loop must buy capacity into each crest and retire it in each trough, and the pass gates on the joint cost+SLO objective the static fleet cannot reach (elasticity block, autoscale=False must FAIL)",
        duration=120.0,
        workload=WorkloadSpec(
            initial_nodes=4,
            arrival_rate=2.0,
            diurnal_period=60.0,
            diurnal_amplitude=1.0,
            pod_cpu_m=(1000, 2000, 4000),
            pod_mem_mi=(1024, 2048, 4096),
            lifetime_mean_s=12.0,
        ),
        autoscale=True,
        autoscale_required=True,
        autoscale_burn_trigger=0.01,
        autoscale_cost_weight=10.0,
        autoscale_objective_gate=30.0,
        autoscale_cooldown=2,
        drain_grace_cycles=20,
    )
)

_register(
    Scenario(
        name="flash-crowd-provisioning-lag",
        description="The provisioning-lag gate: a 4-node fleet takes a 90-pod flash crowd at t=8 — capacity bought at the crest lands only after the SKU's seeded provisioning latency, so the p99 time-to-bind is lag-exposed by construction; the pass gates on the joint cost+SLO objective (elasticity block, autoscale=False must FAIL)",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=4,
            arrival_rate=0.5,
            bursts=((8.0, 90),),
            pod_cpu_m=(1000, 2000),
            pod_mem_mi=(1024, 2048),
            lifetime_mean_s=25.0,
        ),
        autoscale=True,
        autoscale_required=True,
        autoscale_cost_weight=10.0,
        autoscale_objective_gate=30.0,
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="spot-reclaim-storm",
        description="The reclaim-safety gate: the catalog is restricted to the cheap preemptible SKU and the provider reclaims spot nodes at hazard 0.02/s with 4 s of notice — every reclaimed node's pods must be force-unbound through the faultable unbind path and re-placed by the delta engine; the pass gates on ZERO reclaim orphans plus the joint objective (elasticity block, autoscale=False must FAIL)",
        duration=90.0,
        workload=WorkloadSpec(
            initial_nodes=3,
            arrival_rate=1.0,
            bursts=((5.0, 80),),
            pod_cpu_m=(1000, 2000),
            pod_mem_mi=(1024, 2048),
            lifetime_mean_s=20.0,
        ),
        autoscale=True,
        autoscale_required=True,
        autoscale_burn_trigger=0.01,
        autoscale_cost_weight=10.0,
        autoscale_objective_gate=35.0,
        autoscale_reclaim_rate=0.02,
        autoscale_reclaim_grace_s=4.0,
        autoscale_cooldown=2,
        autoscale_skus=("spot-16",),
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="quota-capped-surge",
        description="The quota-pressure gate: a 100-pod surge against an account-wide quota of TWO elastic nodes — the cost-aware plan buys to the cap, further asks are refused live (quota-exceeded provider errors + counted `quota` skips), and the two nodes it did win must still clear the joint objective a static fleet cannot (elasticity block, autoscale=False must FAIL)",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=3,
            arrival_rate=0.5,
            bursts=((5.0, 100),),
            pod_cpu_m=(1000, 2000),
            pod_mem_mi=(1024, 2048),
            lifetime_mean_s=20.0,
        ),
        autoscale=True,
        autoscale_required=True,
        autoscale_cost_weight=10.0,
        autoscale_objective_gate=35.0,
        autoscale_quota=2,
        drain_grace_cycles=25,
    )
)

_register(
    Scenario(
        name="train-smoke",
        description="The policy-training gate: a topology-labeled 12-node cluster (2 racks x 2 slices) under mixed single-pod + gang load, sized so one episode costs well under a second on CPU — `sim train` climbs the scorecard policy objective here, and the pass gates on the objective floor the default profile clears (make train-smoke)",
        duration=24.0,
        workload=WorkloadSpec(
            initial_nodes=12,
            slice_size=3,
            rack_size=6,
            arrival_rate=4.0,
            bursts=((2.0, 24),),
            gang_fraction=0.3,
            gang_size_max=3,
            lifetime_mean_s=15.0,
            priority_tiers=(0, 0, 5, 50),
        ),
        drain_grace_cycles=15,
        policy_required=True,
        policy_objective_floor=1.0,
    )
)

_register(
    Scenario(
        name="sim-smoke",
        description="The tier-1 gate: ~2k pods over 200 nodes with node churn AND an api-brownout window, sized to finish green on CPU in seconds",
        duration=60.0,
        workload=WorkloadSpec(
            initial_nodes=200,
            arrival_rate=30.0,
            bursts=((5.0, 200),),
            lifetime_mean_s=20.0,
            gang_fraction=0.08,
            selector_fraction=0.15,
            priority_tiers=(0, 0, 5, 50),
            node_flap_rate=0.1,
            node_fail_rate=0.03,
            node_add_rate=0.03,
        ),
        chaos=ChaosConfig(
            watch_drop_rate=0.02,
            windows=(ChaosWindow(start=15.0, end=35.0, binding_error_rate=0.2, watch_drop_rate=0.2, binding_latency_s=0.005),),
        ),
    )
)
