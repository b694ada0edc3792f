"""The controller slice as a whole: the port's ``Scheduler`` over
``CudaBackend(device="cpu")`` against the JAX package's ``Scheduler`` over
``NativeBackend`` (both full-wave, ``delta=False``, and both through the
delta engine, ``delta=True``), each on its own
in-process API server loaded with one cluster — the JAX objects, and the
same objects carried across as manifests (``convert.cluster_from_manifests``)
— with one scripted clock and one seeded rng each.  Every scenario holds,
exactly: the per-cycle pending / bound / unschedulable / rounds, the final
pod → node map, the counters (less seconds, bytes and kernel builds), the
requeue deadlines and the timeline event kinds of a few pods.  The NumPy
oracle is what the port follows bit for bit.  Then the CLI: the port's
``--device cpu`` run against the JAX CLI's ``--backend native`` run (with
``--rebalance`` and ``--autoscale`` too, and their debug routes), the flag
it refuses, and its refusal to run on the CPU unless asked."""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.resilience as jax_resilience  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
from conftest import FakeClock  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
from tpu_scheduler.models.profiles import PROFILES as JAX_PROFILES  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.resilience as resilience  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.cli import MIXED_WORKLOAD  # noqa: E402
from tpu_scheduler_torch.errors import BackendUnavailable  # noqa: E402
from tpu_scheduler_torch.models.profiles import PROFILES  # noqa: E402
from tpu_scheduler_torch.utils.metrics import cycle_phases  # noqa: E402
from tpu_scheduler_torch.utils.profiler import SPAN_CATALOGUE  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_KEY, RACK_KEY = "topology.tpu-scheduler/slice", "topology.tpu-scheduler/rack"
# Timing and transfer counters differ by construction; everything else is
# held equal.
_UNCOMPARED = ("scheduler_last_cycle_seconds", "scheduler_last_pods_per_second",
               "scheduler_device_transfer_bytes_total")


class Side:
    """One package's world: its API server, clock, schedulers, and how a JAX
    object crosses into it (identity for the JAX side, the manifests for the
    port)."""

    def __init__(self, port: bool, delta: bool = False):
        self.port = port
        self.delta = delta
        self.clock = FakeClock()
        self.api = (fake_api if port else jax_fake_api).FakeApiServer(clock=self.clock)
        self.scheds = []
        self.retired = None  # a replica that handed its lease off

    def pod(self, p):
        return objects.Pod.from_dict(jax_objects.pod_to_dict(p)) if self.port else p

    def node(self, n):
        return objects.Node.from_dict(jax_objects.node_to_dict(n)) if self.port else n

    def pdb(self, b):
        return objects.PodDisruptionBudget.from_dict(b.to_dict()) if self.port else b

    def scheduler(self, profile_name="default", profile_kw=None, breaker=None, **kw):
        profiles = PROFILES if self.port else JAX_PROFILES
        profile = profiles[profile_name].with_(**(profile_kw or {}))
        mod = controller if self.port else jax_controller
        backend = CudaBackend(device="cpu") if self.port else NativeBackend()
        if breaker is not None:
            kw["breaker_config"] = (resilience if self.port else jax_resilience).BreakerConfig(**breaker)
        sched = mod.Scheduler(self.api, backend, profile=profile, clock=self.clock, rng=random.Random(kw.pop("seed", 7)),
                              delta=self.delta, **kw)
        self.scheds.append(sched)
        return sched


def _load(side, nodes, pods, pdbs=()):
    side.api.load([side.node(n) for n in nodes], [side.pod(p) for p in pods])
    for b in pdbs:
        side.api.create_pdb(side.pdb(b))


# --- scenarios: (cluster, schedulers, per-cycle mutations) ---------------------


def _synth(**kw):
    snap = jax_testing.synth_cluster(**kw)
    return list(snap.nodes), list(snap.pods)


def sc_batch(side):
    """40 pending × 10 nodes; late arrivals, then a node joins (a full
    repack), then incremental packs again."""
    nodes, pods = _synth(n_nodes=10, n_pending=40, n_bound=6, seed=1, selector_fraction=0.3)
    _load(side, nodes, pods)
    side.scheduler(requeue_seconds=5.0)
    late = [jax_testing.make_pod(f"late-{i}", cpu="900m", memory="2Gi") for i in range(12)]

    def mutate(cycle):
        if cycle == 1:
            for p in late[:6]:
                side.api.create_pod(side.pod(p))
        if cycle == 2:
            side.api.create_node(side.node(jax_testing.make_node("joined", cpu="16", memory="64Gi")))
            for p in late[6:]:
                side.api.create_pod(side.pod(p))
    return mutate, 5, 10.0


def sc_mixed(side):
    """The CLI's mixed workload at 200 × 24: selectors, taints, node and pod
    affinity hard and soft, spread, gangs and extended resources."""
    nodes, pods = _synth(n_nodes=24, n_pending=200, n_bound=0, seed=0, **MIXED_WORKLOAD)
    _load(side, nodes, pods)
    side.scheduler()
    return None, 3, 400.0


def _topology_cluster(n_nodes=32, n_pods=120, seed=3):
    rng = random.Random(seed)
    nodes = [jax_testing.make_node(f"tn{i:03d}", cpu="8", memory="32Gi",
                                   labels={SLICE_KEY: f"s{i // 4}", RACK_KEY: f"r{i // 16}"}) for i in range(n_nodes)]
    pods, gi = [], 0
    while len(pods) < n_pods:
        if rng.random() < 0.4:
            for m in range(rng.randrange(3, 7)):
                pods.append(jax_testing.make_pod(f"g{gi}-m{m}", cpu="2", memory="4Gi", gang=f"gang-{gi}"))
            gi += 1
        else:
            pods.append(jax_testing.make_pod(f"solo{len(pods)}", cpu="1", memory="2Gi"))
    return nodes, pods


def sc_topology(side):
    """Gangs on slice- and rack-labelled nodes (``topology="auto"``: the
    gang term rides the choose kernel), oversubscribed so gangs compete."""
    nodes, pods = _topology_cluster()
    _load(side, nodes, pods)
    side.scheduler(profile_name="throughput", profile_kw=dict(pod_block=64), requeue_seconds=2.0)
    return None, 3, 5.0


def sc_sample(side):
    """The reference's policy: at most five random candidates per pod from
    the seeded rng, first feasible wins; gangs are refused."""
    nodes, pods = _synth(n_nodes=8, n_pending=60, n_bound=4, seed=5, selector_fraction=0.4, gang_fraction=0.1)
    _load(side, nodes, pods)
    side.scheduler(policy="sample", requeue_seconds=3.0, seed=11)
    return None, 3, 5.0


def sc_preemption(side):
    """Full nodes of low-priority pods, high-priority pods pending: victims
    are evicted except where a PodDisruptionBudget protects them."""
    nodes = [jax_testing.make_node(f"n{i}", cpu="4", memory="16Gi") for i in range(4)]
    bound = [jax_testing.make_pod(f"low-{i}", cpu="1", memory="1Gi", node_name=f"n{i % 4}", phase="Running",
                                  priority=i % 3, labels={"app": "web" if i % 2 else "batch"}) for i in range(16)]
    pending = [jax_testing.make_pod(f"high-{i}", cpu="1500m", memory="1Gi", priority=100 + i) for i in range(5)]
    pdb = jax_objects.PodDisruptionBudget(metadata=jax_objects.ObjectMeta(name="web", namespace="default"),
                                          min_available=6, match_labels={"app": "web"})
    _load(side, nodes, bound + pending, [pdb])
    side.scheduler(profile_kw=dict(preemption=True), requeue_seconds=1.0)
    return None, 3, 5.0


def sc_pool_routing(side):
    """``pool_key`` routing: pods pinning a pool solve as per-pool shards
    (routed through ``shard_for``), the rest as a residual batch."""
    nodes, pods = _synth(n_nodes=12, n_pending=80, n_bound=8, seed=6, selector_fraction=0.8)
    _load(side, nodes, pods)
    side.scheduler(profile_kw=dict(pool_key="pool"), requeue_seconds=4.0)
    return None, 3, 5.0


def sc_pipeline(side):
    """Pipelined binds: cycle k's POSTs overlap cycle k+1, in-flight binds
    overlay as assumed; late arrivals keep the pipeline busy."""
    nodes, pods = _synth(n_nodes=12, n_pending=60, n_bound=10, seed=8)
    _load(side, nodes, pods)
    sched = side.scheduler(pipeline=True, requeue_seconds=2.0)
    late = [jax_testing.make_pod(f"late-{i}", cpu="700m", memory="1Gi") for i in range(20)]

    def mutate(cycle):
        sched._join_binds()  # the worker's outcomes fold at a fixed point of the script
        if cycle in (1, 2):
            for p in late[10 * (cycle - 1):10 * cycle]:
                side.api.create_pod(side.pod(p))
    return mutate, 4, 3.0


def sc_bind_failures(side):
    """Injected binding failures (breaker off): the failed pods requeue
    with the binding-failed class's backoff and bind on a later cycle."""
    nodes, pods = _synth(n_nodes=8, n_pending=30, n_bound=0, seed=9)
    _load(side, nodes, pods)
    side.scheduler(requeue_seconds=2.0, breaker=dict(failure_ratio=2.0))

    def mutate(cycle):
        if cycle == 0:
            side.api.fail_next_bindings = 5
        if cycle == 2:
            side.api.fail_next_bindings = 2
    return mutate, 5, 1.5


def sc_breaker_brownout(side):
    """A brownout trips the breaker: binds defer into the flush buffer while
    it is open, probe when it half-opens, flush on recovery."""
    nodes, pods = _synth(n_nodes=8, n_pending=40, n_bound=0, seed=10)
    _load(side, nodes, pods)
    side.scheduler(requeue_seconds=2.0, breaker=dict(window=10, min_samples=4, open_seconds=3.0))
    late = [jax_testing.make_pod(f"late-{i}", cpu="300m", memory="512Mi") for i in range(12)]

    def mutate(cycle):
        if cycle == 0:
            side.api.fail_next_bindings = 4
        if cycle in (1, 3):
            for p in late[6 * (cycle // 3):6 * (cycle // 3) + 6]:
                side.api.create_pod(side.pod(p))
    return mutate, 6, 2.0


def sc_noexecute(side):
    """A NoExecute taint lands on a node: intolerant pods are evicted at
    once, a pod tolerating it for 30 s after its grace, and the pending
    pods avoid the node."""
    nodes = [jax_testing.make_node(f"n{i}", cpu="8", memory="16Gi") for i in range(4)]
    bound = [jax_testing.make_pod(f"run-{i}", cpu="1", memory="1Gi", node_name=f"n{i % 4}", phase="Running")
             for i in range(8)]
    tolerant = jax_testing.make_pod("tolerant", cpu="1", memory="1Gi", node_name="n0", phase="Running")
    tolerant.spec.tolerations = [jax_objects.Toleration(key="maint", operator="Equal", value="now",
                                                        effect="NoExecute", toleration_seconds=30)]
    pending = [jax_testing.make_pod(f"new-{i}", cpu="1", memory="1Gi") for i in range(10)]
    _load(side, nodes, bound + [tolerant] + pending[:4])
    side.scheduler(requeue_seconds=2.0)
    tainted = jax_testing.make_node("n0", cpu="8", memory="16Gi",
                                    taints=[jax_objects.Taint(key="maint", value="now", effect="NoExecute")])

    def mutate(cycle):
        if cycle == 1:
            side.api.update_node(side.node(tainted))
            for p in pending[4:]:
                side.api.create_pod(side.pod(p))
    return mutate, 5, 12.0


def sc_leader_election(side):
    """Two replicas on one API server under leader election: only the lease
    holder schedules; when it hands the lease off, the standby takes over
    and revalidates."""
    nodes, pods = _synth(n_nodes=8, n_pending=40, n_bound=4, seed=12)
    _load(side, nodes, pods[:30])
    a = side.scheduler(leader_elect=True, identity="replica-a", lease_duration=15.0, requeue_seconds=2.0, seed=1)
    side.scheduler(leader_elect=True, identity="replica-b", lease_duration=15.0, requeue_seconds=2.0, seed=2)

    def mutate(cycle):
        if cycle == 2:
            for p in pods[30:]:
                side.api.create_pod(side.pod(p))
            a.close()  # hand-off: releases the lease
            side.scheds.remove(a)
            side.retired = a
    return mutate, 5, 6.0


SCENARIOS = {
    "batch": sc_batch, "mixed": sc_mixed, "topology": sc_topology, "sample": sc_sample,
    "preemption": sc_preemption, "pool_routing": sc_pool_routing, "pipeline": sc_pipeline,
    "bind_failures": sc_bind_failures, "breaker_brownout": sc_breaker_brownout, "noexecute": sc_noexecute,
    "leader_election": sc_leader_election,
}


def _drive(scenario, port: bool, delta: bool = False) -> dict:
    side = Side(port, delta)
    mutate, cycles, step = SCENARIOS[scenario](side)
    per_cycle = []
    for c in range(cycles):
        if mutate is not None:
            mutate(c)
        row = []
        for sched in list(side.scheds):
            m = sched.run_cycle()
            row.append((m.pending, m.bound, m.unschedulable, m.rounds))
        per_cycle.append(row)
        side.clock.t += step
    scheds = side.scheds + ([side.retired] if side.retired is not None else [])
    for sched in scheds:
        sched.close()
    placement = {f"{p.metadata.namespace or 'default'}/{p.metadata.name}": p.spec.node_name if p.spec else None
                 for p in side.api.list_pods()}
    finals = []
    for sched in scheds:
        counters = {k: v for k, v in sched.metrics.snapshot().items() if k not in _UNCOMPARED}
        tracked = sorted(sched.recorder.tracked_pods())
        kinds = {pf: [ev["kind"] for ev in sched.recorder.timeline(pf)] for pf in tracked[:: max(1, len(tracked) // 6)]}
        finals.append((counters, dict(sched.requeue_at), kinds, sched.is_leader,
                       sorted(sched.deferred_binds.items())))
    return {"per_cycle": per_cycle, "placement": placement, "finals": finals,
            "leases": side.api.list_lease_summaries()}


@pytest.mark.parametrize("scenario,delta", [pytest.param(s, False, id=s) for s in SCENARIOS]
                         + [pytest.param(s, True, id=f"{s}-delta") for s in SCENARIOS])
def test_controller_matches_jax_controller(scenario, delta):
    """The port's controller over CudaBackend(device="cpu") against the JAX
    controller over NativeBackend, exactly, full-wave and through the delta
    engine: per-cycle counts, the final pod → node map, the counters without
    timings, the requeue deadlines, the timeline kinds of a sample of pods,
    the leases."""
    port, jax = _drive(scenario, True, delta), _drive(scenario, False, delta)
    assert port["per_cycle"] == jax["per_cycle"]
    assert port["placement"] == jax["placement"]
    for p_final, j_final in zip(port["finals"], jax["finals"], strict=True):
        assert p_final == j_final
    assert port["leases"] == jax["leases"]
    # Each scenario does the work it is about.
    counters = port["finals"][0][0]
    assert sum(row[0][1] for row in port["per_cycle"]) > 0
    expect = {
        "batch": ("scheduler_incremental_packs_total", "scheduler_full_packs_total"),
        "mixed": ("scheduler_constraint_tensor_cycles_total",),
        "topology": ("scheduler_topology_cycles_total", "scheduler_gangs_admitted_total"),
        "sample": ("scheduler_gang_sample_refusals_total",),
        "preemption": ("scheduler_preemptions_total", "scheduler_preemption_victims_total"),
        "pool_routing": ("scheduler_routed_cycles_total",),
        "bind_failures": ('scheduler_requeues_by_reason_total{reason="binding-failed"}',),
        "breaker_brownout": ("scheduler_deferred_binds_total", "scheduler_flushed_binds_total"),
        "noexecute": ("scheduler_noexecute_evictions_total",),
        "leader_election": ("scheduler_leadership_acquisitions_total",),
    }.get(scenario, ())
    for name in expect:
        assert any(name in final[0] and final[0][name] > 0 for final in port["finals"]), (name, counters)


def test_rebalance_and_autoscale_options_build_the_tiers():
    """``rebalance=True`` builds a rebalancer with the default config;
    ``autoscale`` needs a provider, as in the JAX controller; the sample
    policy builds neither; the debug payloads match the JAX controller's."""
    import tpu_scheduler.autoscale as jax_autoscale
    import tpu_scheduler_torch.autoscale as autoscale

    def observe(pk_controller, pk_fake_api, pk_autoscale, backend):
        api = pk_fake_api.FakeApiServer()
        out = []
        for kw in (dict(rebalance=True), dict(autoscale=True), dict(rebalance=True, policy="sample")):
            sched = pk_controller.Scheduler(api, backend, **kw)
            out.append((sched.rebalancer is not None, sched.autoscaler is not None, sched.rebalance_snapshot(),
                        sched.autoscale_snapshot(), sched.shards_snapshot()["enabled"]))
        provider = pk_autoscale.SimCloudProvider(api, clock=lambda: 0.0, rng=random.Random(0))
        sched = pk_controller.Scheduler(api, backend, autoscale=True, autoscale_provider=provider)
        sched.run_cycle()
        out.append((sched.autoscaler is not None, sched.autoscale_snapshot()))
        sched.close()
        return out

    port = observe(controller, fake_api, autoscale, CudaBackend(device="cpu"))
    jax = observe(jax_controller, jax_fake_api, jax_autoscale, NativeBackend())
    assert port == jax
    assert port[0][0] and not port[1][1] and not port[2][0] and port[3][0]


def test_backend_failure_propagates_without_a_fallback():
    """A BackendUnavailable during a cycle leaves run_cycle: the port wires
    no fallback, so a failed card never turns into a CPU cycle."""

    class Failing(CudaBackend):
        def assign(self, packed, profile):
            raise BackendUnavailable("card lost")

    api = fake_api.FakeApiServer()
    api.create_node(objects.Node.from_dict(jax_objects.node_to_dict(jax_testing.make_node("n1"))))
    api.create_pod(objects.Pod.from_dict(jax_objects.pod_to_dict(jax_testing.make_pod("p1"))))
    sched = controller.Scheduler(api, Failing(device="cpu"))
    with pytest.raises(BackendUnavailable, match="card lost"):
        sched.run_cycle()
    assert sched.metrics.snapshot().get("scheduler_backend_fallbacks_total", 0) == 0


def test_cycle_spans_are_phase_fields():
    """A live constrained cycle's depth-0 spans are all CycleMetrics phase
    fields (nothing unattributed) and the breakdown reconstructs the wall."""
    side = Side(True)
    nodes, pods = _synth(n_nodes=12, n_pending=50, n_bound=6, seed=3, anti_affinity_fraction=0.2,
                         spread_fraction=0.2, gang_fraction=0.1)
    _load(side, nodes, pods)
    sched = side.scheduler(requeue_seconds=0.0)
    m = sched.run_cycle()
    assert "scheduler_unattributed_spans_total" not in sched.metrics.snapshot()
    assert sum(getattr(m, f"{ph}_seconds") for ph in cycle_phases()) == pytest.approx(m.wall_seconds, abs=2e-3)
    for path in sched.profile_ring.span_census():
        for seg in path.split("/"):
            assert seg.split("[", 1)[0] in SPAN_CATALOGUE, path


# --- the CLI ---------------------------------------------------------------------

CLI_FLAGS = ["--nodes", "50", "--pods", "200", "--workload", "mixed", "--no-delta", "--log-level", "WARNING"]


def _cli(module: str, *args: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


def _summary(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


def test_cli_matches_jax_cli():
    """``python -m tpu_scheduler_torch.cli --device cpu`` and the JAX CLI's
    ``--backend native`` on the same flags: the same cycles, bound total and
    last unschedulable count; the summary keeps the JAX CLI's keys."""
    port = _summary(_cli("tpu_scheduler_torch.cli", "--device", "cpu", *CLI_FLAGS))
    jax = _summary(_cli("tpu_scheduler.cli", "--backend", "native", *CLI_FLAGS))
    for key in ("cycles", "bound_total", "unschedulable_last"):
        assert port[key] == jax[key], key
    assert set(jax) <= set(port)
    assert port["backend"] == "cuda" and port["device"] == "cpu" and port["bound_total"] > 0


def test_cli_delta_matches_jax_cli():
    """Without ``--no-delta`` both CLIs run the delta engine: the same
    cycles, bound total and last unschedulable count, and no notice that
    the cycles are full waves."""
    flags = [f for f in CLI_FLAGS if f != "--no-delta"]
    port_proc = _cli("tpu_scheduler_torch.cli", "--device", "cpu", *flags)
    port = _summary(port_proc)
    jax = _summary(_cli("tpu_scheduler.cli", "--backend", "native", *flags))
    for key in ("cycles", "bound_total", "unschedulable_last"):
        assert port[key] == jax[key], key
    assert port["counters"].get("scheduler_delta_cycles_total", 0) == jax["counters"].get(
        "scheduler_delta_cycles_total", 0)
    assert '"delta": false' not in port_proc.stderr


@pytest.mark.parametrize("extra", [["--shards", "2"], ["--shards", "4", "--replica-id", "r0", "--no-delta"]])
def test_cli_sharded_matches_jax_cli(extra):
    """``--shards K``: the sharded control plane on one replica, against the
    JAX CLI on the same flags — the same cycles, bound total, last
    unschedulable count and shard counters."""
    flags = ["--nodes", "50", "--pods", "200", "--workload", "mixed", "--log-level", "WARNING", *extra]
    port = _summary(_cli("tpu_scheduler_torch.cli", "--device", "cpu", *flags))
    jax = _summary(_cli("tpu_scheduler.cli", "--backend", "native", *flags))
    for key in ("cycles", "bound_total", "unschedulable_last"):
        assert port[key] == jax[key], key
    for name in ("scheduler_shard_acquisitions_total", "scheduler_delta_cycles_total"):
        assert port["counters"].get(name, 0) == jax["counters"].get(name, 0), name
    assert port["counters"]["scheduler_shard_acquisitions_total"] == int(extra[1]) and port["bound_total"] > 0


def test_cli_sharded_without_cuda_fails_before_any_cycle():
    proc = _cli("tpu_scheduler_torch.cli", "--shards", "4", "--replica-id", "r0", "--nodes", "4", "--pods", "4",
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert '"summary"' not in proc.stdout and '"cycle"' not in proc.stdout


def _keys(obj):
    """The key structure of a JSON payload (dicts by key, lists by their
    first element's)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__


@pytest.mark.parametrize("extra", [["--rebalance", "--rebalance-every", "1", "--rebalance-batch", "4"],
                                   ["--autoscale"]])
def test_cli_rebalance_and_autoscale_match_jax_cli(extra):
    """``--rebalance`` (a background solve worker) and ``--autoscale`` (the
    simulated provider, a background plan worker) on both CLIs: the same
    cycles, bound total and last unschedulable count.  Which tick consumes
    a worker's plan depends on its timing, so the tier's own counters are
    not held here (the inline tiers are, in ``tests/test_torch_rebalance.py``
    and ``tests/test_torch_autoscale.py``)."""
    flags = ["--nodes", "50", "--pods", "200", "--bound-pods", "100", "--log-level", "WARNING", *extra]
    port = _summary(_cli("tpu_scheduler_torch.cli", "--device", "cpu", *flags))
    jax = _summary(_cli("tpu_scheduler.cli", "--backend", "native", *flags))
    for key in ("cycles", "bound_total", "unschedulable_last"):
        assert port[key] == jax[key], key
    assert port["bound_total"] > 0


def test_cli_debug_rebalance_and_autoscale_routes_match_jax(tmp_path):
    """The CLI's wiring in process: ``make_scheduler`` and ``start_http``
    with ``--rebalance --autoscale --catalog-file`` serve ``/debug/
    rebalance`` and ``/debug/autoscale`` with the key structure of the JAX
    CLI's scheduler (the same configs: background workers, a provider over
    the in-process API seeded with ``--seed``, the file's catalog) after
    three cycles; both workers are joined by ``close``.  Against a remote
    cluster the CLI keeps the autoscaler off with the JAX CLI's stderr
    line."""
    import contextlib
    import io
    import time
    import urllib.request

    import tpu_scheduler.autoscale as jax_autoscale
    import tpu_scheduler.rebalance as jax_rebalance
    import tpu_scheduler.runtime.http_api as jax_http_api
    import tpu_scheduler_torch.cli as port_cli

    catalog = tmp_path / "catalog.json"
    catalog.write_text(json.dumps([{"name": "x-8", "cpu": 8, "mem_gi": 32, "hourly_cost": 1.5, "spot": True}]))
    argv = ["--nodes", "30", "--pods", "120", "--bound-pods", "60", "--rebalance", "--rebalance-every", "1",
            "--autoscale", "--catalog-file", str(catalog), "--http-port", "0"]
    args = port_cli.build_parser().parse_args(argv)
    api = port_cli.synthetic_api(args)
    sched = port_cli.make_scheduler(args, api, CudaBackend(device="cpu"))
    srv = port_cli.start_http(args, api, sched)
    jargs = dict(n_nodes=30, n_pending=120, n_bound=60, seed=args.seed)
    japi = jax_fake_api.FakeApiServer()
    jsnap = jax_testing.synth_cluster(**jargs)
    japi.load(jsnap.nodes, jsnap.pods)
    jsched = jax_controller.Scheduler(
        japi, NativeBackend(),
        rebalance=jax_rebalance.RebalanceConfig(every=1, batch=args.rebalance_batch, background=True),
        autoscale=jax_autoscale.AutoscaleConfig(background=True),
        autoscale_provider=jax_autoscale.SimCloudProvider(japi, clock=time.monotonic, rng=random.Random(args.seed),
                                                          catalog=jax_autoscale.load_catalog(str(catalog))),
    )
    jsrv = jax_http_api.HttpApiServer(japi, rebalance=jsched.rebalance_snapshot,
                                      autoscale=jsched.autoscale_snapshot).start()
    try:
        for _ in range(3):
            sched.run_cycle()
            jsched.run_cycle()
        bodies = {}
        for name, base in (("port", srv.base_url), ("jax", jsrv.base_url)):
            bodies[name] = {}
            for route in ("rebalance", "autoscale"):
                with urllib.request.urlopen(f"{base}/debug/{route}") as r:
                    bodies[name][route] = json.loads(r.read())
    finally:
        srv.stop()
        jsrv.stop()
        sched.close()
        jsched.close()
    assert _keys(bodies["port"]) == _keys(bodies["jax"])
    for route in ("rebalance", "autoscale"):
        assert bodies["port"][route]["config"] == bodies["jax"][route]["config"]
    assert bodies["port"]["autoscale"]["catalog"] == bodies["jax"]["autoscale"]["catalog"]
    assert bodies["port"]["rebalance"]["config"]["background"] and bodies["port"]["autoscale"]["config"]["background"]
    assert sched.rebalancer._bg_thread is None and sched.autoscaler._bg_thread is None
    remote = port_cli.build_parser().parse_args(["--autoscale", "--api-server", "http://127.0.0.1:1"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        off = port_cli.make_scheduler(remote, fake_api.FakeApiServer(), CudaBackend(device="cpu"))
    assert off.autoscaler is None
    assert err.getvalue().strip() == json.dumps({"autoscale": False, "reason": "remote cluster"})


DISTRIBUTED_FLAGS = ["--distributed", "--backend", "cuda-sharded", "--device", "cpu", "--nodes", "24",
                     "--pods", "96", "--workload", "mixed", "--log-level", "WARNING"]
SUMMARY_KEYS = ("cycles", "bound_total", "unschedulable_last")


def test_cli_distributed_single_process_under_torchrun_env():
    """``--distributed`` with torchrun's environment at world size 1: the
    process group starts over env://, the mesh stays single-process, and the
    run completes its cycles with the summary of the run without
    ``--distributed``."""
    from test_torch_multihost import _free_port

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1", "RANK": "0"}
    dist = _summary(_cli("tpu_scheduler_torch.cli", *DISTRIBUTED_FLAGS, env_extra=env))
    plain = _summary(_cli("tpu_scheduler_torch.cli", *DISTRIBUTED_FLAGS[1:]))
    assert dist["cycles"] >= 1 and dist["bound_total"] > 0
    assert {k: dist[k] for k in SUMMARY_KEYS} == {k: plain[k] for k in SUMMARY_KEYS}
    assert dist["backend"] == "cuda-sharded" and dist["device"] == "cpu"


def test_cli_two_processes_agree_with_one():
    """Two CLI processes over ``SCHED_*`` (gloo, ``[cpu] * 8`` each: a (8, 2)
    mesh across them): both ranks' summaries and pod → node maps are equal,
    and equal to the one-process run's."""
    from test_torch_multihost import _spawn

    def sched_env(world):
        return lambda rank, coordinator: {
            "SCHED_COORDINATOR": coordinator, "SCHED_NUM_PROCESSES": str(world), "SCHED_PROCESS_ID": str(rank),
        }

    # One process: no --distributed, so init_distributed is the no-op (with
    # it, a world of 1 would ask torchrun's env:// instead).
    runs = {world: _spawn("cli", world=world, extra=tuple(DISTRIBUTED_FLAGS[world == 1:]), env_extra=sched_env(world))
            for world in (1, 2)}
    seen = []
    for world, results in runs.items():
        for rc, out, res in results:
            assert rc == 0 and res is not None and res["rc"] == 0, out[-3000:]
            assert (res["collectives"] > 0) == (world > 1), res["collectives"]  # the cycles ran across processes
            summary = json.loads([ln for ln in out.splitlines() if ln.startswith('{"summary"')][-1])
            seen.append(({k: summary[k] for k in SUMMARY_KEYS}, res["placements"]))
    assert len(seen) == 3 and seen[0][0]["bound_total"] > 0
    assert all(s == seen[0] for s in seen[1:])


def test_cli_without_cuda_fails_and_never_runs_on_the_cpu():
    """Without CUDA the default device fails with BackendUnavailable's
    message and a non-zero exit: no cycle ran anywhere."""
    proc = _cli("tpu_scheduler_torch.cli", "--nodes", "4", "--pods", "4", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert '"summary"' not in proc.stdout and '"cycle"' not in proc.stdout
