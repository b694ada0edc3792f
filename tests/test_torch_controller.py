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
``--device cpu`` run against the JAX CLI's ``--backend native`` run, the
flags it refuses, and its refusal to run on the CPU unless asked."""

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


def test_unported_options_are_refused_by_item():
    api = fake_api.FakeApiServer()
    backend = CudaBackend(device="cpu")
    for kw, item in ((dict(shards=2), "item 8"), (dict(rebalance=True), "item 9"), (dict(autoscale=True), "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            controller.Scheduler(api, backend, **kw)
    sched = controller.Scheduler(api, backend)
    assert sched.shards_snapshot()["enabled"] is False


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


@pytest.mark.parametrize("flags", [["sim"], ["--shards", "2"], ["--rebalance"], ["--autoscale"], ["--distributed"]])
def test_cli_refuses_unported_flags(flags):
    proc = _cli("tpu_scheduler_torch.cli", *flags, "--device", "cpu", "--nodes", "2", "--pods", "2")
    assert proc.returncode == 2
    assert "not ported yet" in proc.stderr and "ROADMAP Queue 1 item" in proc.stderr
    assert '"summary"' not in proc.stdout


def test_cli_without_cuda_fails_and_never_runs_on_the_cpu():
    """Without CUDA the default device fails with BackendUnavailable's
    message and a non-zero exit: no cycle ran anywhere."""
    proc = _cli("tpu_scheduler_torch.cli", "--nodes", "4", "--pods", "4", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert '"summary"' not in proc.stdout and '"cycle"' not in proc.stdout
