"""The port's host runtime beside the JAX package's, module by module, on the
same inputs: the backoff queue and the circuit breaker (one seeded rng, one
scripted clock), the in-process API server (resource versions, watch
events, injected binding failures, leases), the reflector's snapshots, the
metrics exposition, the flight recorder's timelines and waterfalls, the
profile ring, pool routing — and the repairs that the controller slice
needed below it: the host scorers of the constrained phase, the backend's
routed-shard boundary, the manifest parsers, the upload counter under
concurrency and the kernel library built once under concurrent first
launches."""

import random
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.core.predicates as jax_pred  # noqa: E402
import tpu_scheduler.core.snapshot as jax_snapshot  # noqa: E402
import tpu_scheduler.parallel.routing as jax_routing  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.reflector as jax_reflector  # noqa: E402
import tpu_scheduler.runtime.resilience as jax_resilience  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
import tpu_scheduler.utils.events as jax_events  # noqa: E402
import tpu_scheduler.utils.metrics as jax_metrics  # noqa: E402
import tpu_scheduler.utils.profiler as jax_profiler  # noqa: E402
import tpu_scheduler.utils.tracing as jax_tracing  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.backends.cuda as cuda_mod  # noqa: E402
import tpu_scheduler_torch.core.predicates as pred  # noqa: E402
import tpu_scheduler_torch.core.snapshot as snapshot  # noqa: E402
import tpu_scheduler_torch.ops.choose as choose_mod  # noqa: E402
import tpu_scheduler_torch.parallel.routing as routing  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.reflector as reflector  # noqa: E402
import tpu_scheduler_torch.runtime.resilience as resilience  # noqa: E402
import tpu_scheduler_torch.utils.events as events  # noqa: E402
import tpu_scheduler_torch.utils.metrics as metrics  # noqa: E402
import tpu_scheduler_torch.utils.profiler as profiler  # noqa: E402
import tpu_scheduler_torch.utils.tracing as tracing  # noqa: E402
from tpu_scheduler_torch.backends.base import SchedulingBackend  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.cli import MIXED_WORKLOAD  # noqa: E402
from tpu_scheduler_torch.convert import cluster_from_manifests  # noqa: E402
from tpu_scheduler_torch.parallel.mesh import make_mesh  # noqa: E402
from tpu_scheduler_torch.parallel.sharded import ShardedBackend  # noqa: E402

PORT = dict(resilience=resilience, fake_api=fake_api, reflector=reflector, metrics=metrics, events=events,
            profiler=profiler, tracing=tracing, routing=routing, objects=objects, snapshot=snapshot)
JAX = dict(resilience=jax_resilience, fake_api=jax_fake_api, reflector=jax_reflector, metrics=jax_metrics,
           events=jax_events, profiler=jax_profiler, tracing=jax_tracing, routing=jax_routing, objects=jax_objects,
           snapshot=jax_snapshot)


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def carried(snap):
    """The port's (nodes, pods) of a JAX snapshot, through the manifests."""
    nodes, pods, _ = cluster_from_manifests(
        [jax_objects.node_to_dict(n) for n in snap.nodes], [jax_objects.pod_to_dict(p) for p in snap.pods])
    return nodes, pods


def both_clusters(**kw):
    """One synthetic cluster as JAX objects and as the port's objects."""
    snap = jax_testing.synth_cluster(**kw)
    nodes, pods = carried(snap)
    return (list(snap.nodes), list(snap.pods)), (nodes, pods)


# --- resilience ----------------------------------------------------------------

FAIL_SCRIPT = [
    ("default/a", "no-node"), ("default/b", "api-error"), ("default/a", "no-node"), ("default/c", "binding-failed"),
    ("default/b", "api-error"), ("default/b", "network-error"), ("default/a", "gang"), ("default/d", "other"),
    ("default/c", "binding-failed"), ("default/a", "no-node"),
]


def test_backoff_queue_deadlines_match():
    """Same seed, same failures at the same times: the same delays, deadlines,
    attempt counts and debug view."""
    out = {}
    for tag, mods in (("port", PORT), ("jax", JAX)):
        q = mods["resilience"].BackoffQueue(base_seconds=7.5, rng=random.Random(13))
        delays = [q.fail(pod, cls, now=3.0 * i) for i, (pod, cls) in enumerate(FAIL_SCRIPT)]
        q.pop("default/d")
        out[tag] = (delays, dict(q), {k: q.attempts(k) for k in q}, q.meta(), q.debug(40.0),
                    [q.eligible(k, 60.0) for k in sorted(q)])
    assert out["port"] == out["jax"]


def test_circuit_breaker_transitions_match():
    """One scripted outcome stream on one scripted clock: the same state
    after every step, the same transitions and the same open intervals."""
    rng = random.Random(5)
    script = [(rng.random() < 0.7, rng.choice((0.0, 0.5, 2.0, 7.0))) for _ in range(300)]
    out = {}
    for tag, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        seen = []
        br = mods["resilience"].CircuitBreaker(
            clock=clock, config=mods["resilience"].BreakerConfig(window=10, open_seconds=3.0),
            on_transition=lambda t, frm, to: seen.append((t, frm, to)),
        )
        modes = []
        for ok, dt in script:
            clock.t += dt
            modes.append(br.mode())
            br.record(ok)
        out[tag] = (modes, seen, br.open_intervals(clock.t), br.debug(clock.t), br.seconds_until_probe(clock.t))
    assert out["port"] == out["jax"]
    assert out["port"][1], "the script trips the breaker"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_circuit_breaker_success_runs_match(seed):
    """``record_successes(n)`` on the port's breaker against ``n`` calls of
    ``record(True)`` on the JAX package's, after seeded histories of
    outcomes and clock steps (closed with and without failures in the
    window, open, half-open; ratios that can and cannot trip): the same
    state, transitions and answers after the run and after more outcomes."""
    rng = random.Random(seed)
    for _ in range(200):
        cfg = dict(window=rng.randint(1, 12), min_samples=rng.randint(1, 10),
                   failure_ratio=rng.choice((0.0, 0.3, 0.5, 1.0, 1.5)), open_seconds=rng.choice((0.5, 3.0)))
        history = [(rng.random() < 0.7, rng.choice((0.0, 0.5, 2.0))) for _ in range(rng.randint(0, 30))]
        n = rng.randint(0, 40)
        after = [(rng.random() < 0.7, rng.choice((0.0, 1.0))) for _ in range(5)]
        out = {}
        for tag, mods in (("port", PORT), ("jax", JAX)):
            clock = Clock()
            seen = []
            br = mods["resilience"].CircuitBreaker(clock=clock, config=mods["resilience"].BreakerConfig(**cfg),
                                                    on_transition=lambda t, frm, to: seen.append((t, frm, to)))
            for ok, dt in history:
                clock.t += dt
                br.record(ok)
            if tag == "port":
                br.record_successes(n)
            else:
                for _ in range(n):
                    br.record(True)
            states = [(br.mode(), br.debug(clock.t))]
            for ok, dt in after:
                clock.t += dt
                br.record(ok)
                states.append((br.mode(), br.debug(clock.t)))
            out[tag] = (states, seen, br.open_intervals(clock.t))
        assert out["port"] == out["jax"], cfg


# --- the in-process API server and the reflector -------------------------------


def _events(watch, mods):
    obj = mods["objects"]
    return [(e.type, obj.pod_to_dict(e.object) if isinstance(e.object, obj.Pod) else obj.node_to_dict(e.object))
            for e in watch.poll()]


def _api_script(api, mods, nodes, pods, clock):
    """One operation sequence: load, watch, bind, an injected failure, a 409,
    a delete, leases; returns what each step returned or raised."""
    results = []
    api.load(nodes[:6], pods[:12])
    pw, nw = api.watch_pods(), api.watch_nodes()
    ref = mods["objects"].ObjectReference
    for i, p in enumerate(pods[:8]):
        try:
            api.create_binding(p.metadata.namespace or "default", p.metadata.name, ref(name=nodes[i % 6].name))
            results.append(("bound", api.latest_rv))
        except Exception as e:  # noqa: BLE001 — the failure is the result
            results.append((type(e).__name__, str(e)))
        if i == 2:
            api.fail_next_bindings = 2
    try:
        api.create_binding("default", pods[0].metadata.name, ref(name=nodes[1].name))
    except Exception as e:  # noqa: BLE001
        results.append((type(e).__name__, getattr(e, "code", None)))
    api.delete_pod("default", pods[5].metadata.name)
    api.create_node(nodes[6])
    for p in pods[12:15]:
        api.create_pod(p)
    clock.t = 10.0
    results.append(api.acquire_lease("sched", "a", 15.0))
    results.append(api.acquire_lease("sched", "b", 15.0))
    clock.t = 30.0
    results.append(api.acquire_lease("sched", "b", 15.0))
    api.release_lease("sched", "b")
    results.append(api.acquire_lease("sched", "a", 15.0))
    results.append((api.get_lease("sched"), api.list_lease_summaries(), list(api.lease_history)))
    results.append((api.latest_rv, api.binding_count))
    results.append(sorted((p.metadata.name, p.spec.node_name, p.metadata.resource_version) for p in api.list_pods()))
    return results, _events(pw, mods), _events(nw, mods)


def test_fake_api_sequence_matches():
    """The same operation sequence gives the same resource versions, the
    same watch events, the same errors and the same lease records."""
    (jn, jp), (pn, pp) = both_clusters(n_nodes=8, n_pending=16, n_bound=0, seed=2)
    jc, pc = Clock(), Clock()
    jax_out = _api_script(jax_fake_api.FakeApiServer(clock=jc), JAX, jn, jp, jc)
    port_out = _api_script(fake_api.FakeApiServer(clock=pc), PORT, pn, pp, pc)
    assert port_out == jax_out
    assert any(r[0] == "CreateBindingFailed" for r in jax_out[0] if isinstance(r, tuple))


def _reflector_views(mods, nodes, pods):
    api = mods["fake_api"].FakeApiServer()
    api.load(nodes[:10], pods[:30])
    refl = mods["reflector"].ClusterReflector(api, clock=Clock(), rng=random.Random(3))
    ref = mods["objects"].ObjectReference
    views = []
    for step in range(3):
        refl.sync()
        snap = refl.snapshot()
        views.append((
            [mods["objects"].node_to_dict(n) for n in snap.nodes],
            sorted(mods["objects"].pod_to_dict(p)["metadata"]["name"] for p in snap.pending_pods()),
            sorted((q.metadata.name, n.name) for q, n in snap.placed_pods()),
            refl.node_set_signature(), refl.take_deleted_pods(), refl.healthy,
        ))
        for p in pods[30 + 5 * step:35 + 5 * step]:
            api.create_pod(p)
        unbound = [p for p in api.list_pods() if not p.spec.node_name]
        for i, p in enumerate(unbound[:4]):
            api.create_binding("default", p.metadata.name, ref(name=nodes[i].name))
        api.delete_pod("default", pods[10 * step + 6].metadata.name)
        if step == 1:
            api.delete_node(nodes[9].name)
    return views


def test_reflector_snapshots_match():
    """After the same watch stream (adds, binds, deletes, a node removal)
    the reflectors' snapshots agree: nodes, pending and placed pods, the
    node-set signature and the deleted-pod stream."""
    (jn, jp), (pn, pp) = both_clusters(n_nodes=10, n_pending=50, n_bound=6, seed=4)
    assert _reflector_views(PORT, pn, pp) == _reflector_views(JAX, jn, jp)


# --- metrics, events, profiler -------------------------------------------------


def _registry_text(mods):
    r = mods["metrics"].MetricsRegistry()
    rng = random.Random(9)
    for i in range(40):
        r.inc("scheduler_requeues_total")
        r.inc("scheduler_requeues_by_reason_total", labels={"reason": rng.choice(("no-node", "api-error"))})
        r.observe("scheduler_backoff_seconds", rng.random() * 50, labels={"reason": "no-node"})
        r.set_gauge("scheduler_circuit_state", float(i % 3))
    phases = mods["metrics"].cycle_phases()
    for c in range(5):
        r.observe_cycle(mods["metrics"].CycleMetrics(
            cycle=c + 1, backend="b", pending=100, bound=90 - c, unschedulable=10 + c, rounds=c + 2,
            wall_seconds=0.5 + c / 8, **{f"{ph}_seconds": (k + 1) / 64 for k, ph in enumerate(phases)}))
    # The uptime gauge is the one wall-clock line of the exposition.
    text = "".join(ln for ln in r.to_prometheus().splitlines(True) if not ln.startswith("scheduler_uptime_seconds "))
    return text, r.snapshot(), phases


def test_metrics_exposition_matches_byte_for_byte():
    """The same increments, observations, gauges and cycles: the same
    exposition text, byte for byte (less the uptime sample), and the same
    flat snapshot and phase set."""
    port_text, port_snap, port_phases = _registry_text(PORT)
    jax_text, jax_snap, jax_phases = _registry_text(JAX)
    assert port_text == jax_text
    assert port_snap == jax_snap
    assert port_phases == jax_phases


def test_every_cycle_phase_is_a_catalogued_depth0_span():
    """Every CycleMetrics ``*_seconds`` field is a phase of the exposition
    and a name of the span catalogue: a depth-0 span the controller opens
    lands in its own field, never in ``other``."""
    phases = metrics.cycle_phases()
    assert "other" in phases and "wall" not in phases
    assert set(phases) - {"other"} <= set(profiler.SPAN_CATALOGUE)
    text, _, _ = _registry_text(PORT)
    observed = {ln.split('phase="', 1)[1].split('"', 1)[0] for ln in text.splitlines()
                if ln.startswith("scheduler_phase_seconds_count{")}
    assert observed == set(phases)


def _timelines(mods):
    clock = Clock(100.0)
    rec = mods["events"].FlightRecorder(max_pods=4, per_pod=6, clock=clock)
    script = ["seen", "packed", "unschedulable", "requeued", "seen", "packed", "bound", "bind-confirmed"]
    for i in range(12):
        pod = f"default/p{i % 6}"
        clock.t += 0.25 * (i + 1)
        rec.seen(pod, i)
        for kind in script[(i % 3):(i % 3) + 5]:
            clock.t += 0.125
            rec.record(pod, kind, i, node="n1" if kind == "bound" else None, detail=f"k{i}")
    tracked = rec.tracked_pods()
    tl = {p: [{k: v for k, v in ev.items() if k != "ts"} for ev in rec.timeline(p)] for p in tracked}
    wf = {p: mods["events"].waterfall(rec.timeline(p)) for p in tracked}
    return tracked, tl, wf, rec.evicted_timelines


def test_flight_recorder_timelines_and_waterfalls_match():
    """The same events on one scripted clock: the same tracked pods (LRU
    eviction included), timelines (less the wall stamp) and waterfalls."""
    port, jax = _timelines(PORT), _timelines(JAX)
    assert port == jax
    assert any(w is not None for w in port[2].values())


def _ring(mods):
    ring = mods["profiler"].ProfileRing(window=8)
    for c in range(12):
        tr = mods["tracing"].Trace()
        for path, dt in (("sync", 0.01 * c), ("pack", 0.02), ("solve", 0.05 + c / 100), ("solve/round[00]", 0.03),
                         ("solve/round[01]/score", 0.01), ("bind", 0.004 * (c % 3))):
            tr.record(path, dt)
        ring.ingest(tr, 0.2 + c / 50)
    snap = ring.snapshot()
    return snap, ring.brief(), mods["profiler"].build_tree(tr, 0.4), mods["profiler"].coverage(tr, 0.4)


def test_profile_ring_folds_the_same_trees():
    port, jax = _ring(PORT), _ring(JAX)
    assert port == jax


def test_partition_snapshot_pools_match():
    """Pool routing over the same cluster: the same pools, the same routed
    pods and the same residual."""
    (jn, jp), (pn, pp) = both_clusters(n_nodes=12, n_pending=60, n_bound=10, seed=6, selector_fraction=0.7)
    out = {}
    for tag, (mods, nodes, pods) in {"jax": (JAX, jn, jp), "port": (PORT, pn, pp)}.items():
        snap = mods["snapshot"].ClusterSnapshot.build(nodes, pods)
        part = mods["routing"].partition_snapshot(snap, "pool")
        out[tag] = None if part is None else (
            {v: (sorted(n.name for n in s.nodes), sorted(p.metadata.name for p in s.pending_pods()))
             for v, s in part.pools.items()},
            part.routed_pods, sorted(p.metadata.name for p in part.residual_pending))
    assert out["port"] == out["jax"]
    assert out["port"] is not None and len(out["port"][0]) >= 2


# --- repairs below the controller ----------------------------------------------

SCORER_CLUSTER = dict(n_nodes=24, n_pending=200, n_bound=60, seed=1, **MIXED_WORKLOAD)


@pytest.mark.parametrize("scorer", ["preferred_affinity_score", "soft_taint_penalty",
                                    "make_preferred_pod_affinity_scorer", "make_soft_spread_scorer"])
def test_host_scorers_match_jax(scorer):
    """The four soft scorers of the host-sequential constrained phase, on
    the CLI's mixed workload, every pending pod against every node, with a
    few same-cycle placements: equal floats."""
    jsnap = jax_testing.synth_cluster(**SCORER_CLUSTER)
    psnap = snapshot.ClusterSnapshot.build(*carried(jsnap))
    jpend, ppend = jsnap.pending_pods(), psnap.pending_pods()
    jextra = [(jpend[i], jsnap.nodes[i % len(jsnap.nodes)]) for i in range(0, 40, 3)]
    pextra = [(ppend[i], psnap.nodes[i % len(psnap.nodes)]) for i in range(0, 40, 3)]
    jf, pf = getattr(jax_pred, scorer), getattr(pred, scorer)
    nonzero = 0
    for jpod, ppod in zip(jpend, ppend):
        if scorer.startswith("make_"):
            js, ps = jf(jpod, jsnap, jextra), pf(ppod, psnap, pextra)
            got = [(ps(pn), js(jn)) for pn, jn in zip(psnap.nodes, jsnap.nodes)]
        else:
            got = [(pf(ppod, pn), jf(jpod, jn)) for pn, jn in zip(psnap.nodes, jsnap.nodes)]
        for p_val, j_val in got:
            assert p_val == j_val and type(p_val) is type(j_val)
            nonzero += p_val != 0
    assert nonzero > 0


class _Stub(SchedulingBackend):
    name = "stub"

    def assign(self, packed, profile):
        raise NotImplementedError


def test_backend_boundary_routes_shards():
    """The routed cycle's boundary: shards may solve concurrently by
    default and come from ``shard_for``; on the CPU (or one card) every
    shard is the backend itself; mesh backends refuse concurrency."""
    stub = _Stub()
    assert stub.supports_concurrent_shards is True and stub.shard_for(3) is stub
    cpu = CudaBackend(device="cpu")
    assert cpu.supports_concurrent_shards is True
    assert all(cpu.shard_for(i) is cpu for i in range(4))
    sharded = ShardedBackend(mesh=make_mesh([torch.device("cpu")] * 2, tp=1))
    assert sharded.supports_concurrent_shards is False


def test_shard_for_round_robins_over_cards(monkeypatch):
    """With several cards, shard i goes to card i mod count: the backend
    itself for its own card, one cached backend per other card."""
    backend = CudaBackend(device="cpu")
    backend.device = torch.device("cuda", 0)  # as if constructed on card 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = [backend.shard_for(i) for i in range(6)]
    assert got[0] is backend and got[3] is backend
    assert got[1] is got[4] and got[2] is got[5] and got[1] is not got[2]
    assert [g.device for g in got[1:3]] == [torch.device("cuda", 1), torch.device("cuda", 2)]


def _noexecute_objects(mods, testing):
    pod = testing.make_pod("tolerant", cpu="250m", memory="128Mi", labels={"app": "x"})
    pod.spec.tolerations = [mods["objects"].Toleration(key="maint", operator="Equal", value="soon",
                                                      effect="NoExecute", toleration_seconds=30)]
    node = testing.make_node("drained", cpu=8, memory="16Gi", labels={"zone": "a"})
    node.spec = mods["objects"].NodeSpec(taints=[mods["objects"].Taint(key="maint", value="soon", effect="NoExecute")])
    return pod, node


def test_manifest_round_trip():
    """JAX object → JAX serializer → the port's parser → the port's
    serializer gives the JAX manifest back: the mixed workload (gangs,
    extended resources, taints, every affinity family) and a pod and node
    made with ``make_pod``/``make_node`` carrying a NoExecute toleration and
    taint."""
    snap = jax_testing.synth_cluster(n_nodes=30, n_pending=200, n_bound=40, seed=3, **MIXED_WORKLOAD)
    pod, node = _noexecute_objects(JAX, jax_testing)
    pods, nodes = list(snap.pods) + [pod], list(snap.nodes) + [node]
    assert any(p.spec.gang for p in pods) and any(n.spec and n.spec.taints for n in nodes)
    for p in pods:
        d = jax_objects.pod_to_dict(p)
        assert objects.pod_to_dict(objects.Pod.from_dict(d)) == d
    for n in nodes:
        d = jax_objects.node_to_dict(n)
        assert objects.node_to_dict(objects.Node.from_dict(d)) == d
    parsed = objects.Pod.from_dict(jax_objects.pod_to_dict(pod))
    assert parsed.spec.tolerations[0].toleration_seconds == 30


def test_concurrent_uploads_count_every_byte(monkeypatch):
    """Eight threads uploading distinct arrays through one backend: the
    counter and the profiler's transfer total both see every byte."""
    backend = CudaBackend(device="cpu")
    arrays = [[np.full((64 + t, 7), t, dtype=np.int32) for _ in range(40)] for t in range(8)]
    expected = sum(a.nbytes for per in arrays for a in per)
    monkeypatch.setattr(cuda_mod, "UPLOAD_BYTES", 0)
    xfer0 = profiler.transfer_bytes_total()
    barrier = threading.Barrier(8)

    def upload(per):
        barrier.wait()
        for a in per:
            backend._put(a)

    threads = [threading.Thread(target=upload, args=(per,)) for per in arrays]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cuda_mod.UPLOAD_BYTES == expected
    assert profiler.transfer_bytes_total() - xfer0 == expected


def test_kernel_library_builds_once_under_concurrent_first_launches(monkeypatch):
    """Eight threads whose first launch comes at the same moment: one build,
    one bind, one library for all (the build is slowed behind a barrier so
    every thread is inside ``_library`` before it finishes)."""
    monkeypatch.setattr(choose_mod, "_LIB", [])
    builds, binds = [], []
    barrier = threading.Barrier(8, timeout=2.0)

    def slow_build(*_a, **_k):
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return "lib.so", 0.2, ""

    def bind(path):
        binds.append(path)
        return object()

    monkeypatch.setattr(choose_mod, "build_library", slow_build)
    monkeypatch.setattr(choose_mod, "bind_library", bind)
    got = []

    def first_launch():
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            pass
        got.append(choose_mod._library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(binds) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_kernel_builds_are_counted_and_traced(monkeypatch, tmp_path):
    """A build that runs (not one found built) lands in the build counter
    and, inside a cycle's trace, as a ``compile`` span."""
    src = tmp_path / "k.cu"
    src.write_text("// test source\n")
    monkeypatch.setattr(choose_mod, "_BUILD_ROOT", tmp_path / "out")
    monkeypatch.setattr(choose_mod, "_nvcc", lambda: "nvcc")

    class Proc:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **_kw):
        with open(cmd[cmd.index("-o") + 1], "w"):
            pass
        return Proc()

    monkeypatch.setattr(choose_mod.subprocess, "run", fake_run)
    before = profiler.compile_stats()
    tr = tracing.Trace()
    with tr:
        path, seconds, _ = choose_mod.build_library(src, "libk.so")
    assert path.exists()
    after = profiler.compile_stats()
    assert after["builds"] == before["builds"] + 1
    assert after["build_s"] == pytest.approx(before["build_s"] + seconds)
    assert "compile" in tr.durations
    # Found built: no build, no count.
    choose_mod.build_library(src, "libk.so")
    assert profiler.compile_stats()["builds"] == after["builds"]


def test_cluster_from_manifests_carries_pdbs():
    pdb = jax_objects.PodDisruptionBudget(
        metadata=jax_objects.ObjectMeta(name="web", namespace="default"), min_available=2, match_labels={"app": "web"})
    nodes, pods, pdbs = cluster_from_manifests([], [], [pdb.to_dict()])
    assert nodes == [] and pods == []
    assert pdbs[0].to_dict() == pdb.to_dict()
    assert (pdbs[0].min_available, pdbs[0].max_unavailable) == (2, None)


def test_device_profile_writes_a_trace_and_is_inert_without_a_dir(tmp_path):
    """``device_profile`` wraps torch.profiler: a Chrome trace lands in the
    directory; without one nothing is traced or written."""
    with tracing.device_profile(None):
        torch.ones(4).sum()
    out = tmp_path / "prof"
    with tracing.device_profile(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (out / "device_trace.json").stat().st_size > 0
