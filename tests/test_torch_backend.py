"""``CudaBackend`` of the PyTorch/CUDA port: on the CPU it must schedule
exactly as the JAX package's NumPy oracle ``NativeBackend`` (bindings,
unschedulable pods, rounds, per-pod stats) — unconstrained and constrained
cycles alike, the constrained ones also passing the order-witness replay
through the JAX package's scalar predicates; it never drops to the CPU
without being asked; it refuses a topology cycle whose gang ids are out of
range (tests/test_torch_topology.py holds topology cycles against the
oracle); and the port imports nothing of JAX or the JAX package."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_scheduler.api.objects as jax_objects
import tpu_scheduler_torch.api.objects as port_objects
import tpu_scheduler_torch.ops.choose as choose_mod
from test_constraints_tensor import _replay_validity
from tpu_scheduler.backends.native import NativeBackend
from tpu_scheduler.core.snapshot import ClusterSnapshot as JaxSnapshot
from tpu_scheduler.models.profiles import PROFILES as JAX_PROFILES
from tpu_scheduler.ops.constraints import pack_constraints as jax_pack_constraints
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
from tpu_scheduler.testing import make_node as jax_node
from tpu_scheduler.testing import make_pod as jax_pod
from tpu_scheduler.testing import synth_cluster as jax_synth
from tpu_scheduler_torch.backends.cuda import CudaBackend, make_backend
from tpu_scheduler_torch.core.snapshot import ClusterSnapshot
from tpu_scheduler_torch.errors import BackendUnavailable
from tpu_scheduler_torch.models.profiles import PROFILES
from tpu_scheduler_torch.ops.constraints import pack_constraints
from tpu_scheduler_torch.ops.pack import STALL_ROUNDS, pack_snapshot
from tpu_scheduler_torch.testing import make_node, make_pod, synth_cluster

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

MID = dict(
    selector_fraction=0.3, tainted_fraction=0.2, cordoned_fraction=0.1, node_affinity_fraction=0.3,
    soft_taint_fraction=0.3, preferred_affinity_fraction=0.3, extended_fraction=0.2,
)


def _assert_same_result(rn, rt):
    assert rt.bindings == rn.bindings
    assert rt.unschedulable == rn.unschedulable
    assert rt.rounds == rn.rounds
    np.testing.assert_array_equal(rt.assigned, rn.assigned)
    for key in ("acc_round", "rank"):
        np.testing.assert_array_equal(rt.stats[key], rn.stats[key], err_msg=key)
    assert rt.stats["backend"] == "cuda"


@pytest.mark.parametrize("features", ["plain", "all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpu_schedule_matches_native(seed, features):
    kw = dict(n_nodes=48, n_pending=400, n_bound=96, seed=seed, **(MID if features == "all" else {}))
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw), pod_block=64), JAX_PROFILES["throughput"].with_(pod_block=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw), pod_block=64),
                                            PROFILES["throughput"].with_(pod_block=64))
    _assert_same_result(rn, rt)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_every_profile_with_soft_terms_matches_native(profile):
    """Every profile with soft taints, preferred affinity and extended
    resources on, against the NumPy oracle (the float32 op order of the
    reference tree, with no multiply-add contraction)."""
    kw = dict(n_nodes=24, n_pending=200, n_bound=48, seed=5, soft_taint_fraction=0.3,
              preferred_affinity_fraction=0.3, extended_fraction=0.2)
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw)), JAX_PROFILES[profile].with_(pod_block=64, max_rounds=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw)),
                                            PROFILES[profile].with_(pod_block=64, max_rounds=64))
    _assert_same_result(rn, rt)


@pytest.mark.parametrize("driver", ["auto", "monolithic", "epochs"])
def test_every_driver_value_maps_to_one_driver(driver):
    kw = dict(n_nodes=16, n_pending=200, n_bound=16, seed=4)
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw)), JAX_PROFILES["default"].with_(pod_block=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw)),
                                            PROFILES["default"].with_(pod_block=64, driver=driver))
    _assert_same_result(rn, rt)


def test_no_cuda_raises(monkeypatch):
    """Without CUDA the entry points raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        CudaBackend()
    with pytest.raises(BackendUnavailable):
        make_backend("cuda")
    with pytest.raises(ValueError):
        make_backend("tpu")
    with pytest.raises(ValueError):
        CudaBackend(device="meta")


@pytest.mark.parametrize("field", ["topology"])
def test_constrained_or_topology_cycle_raises(field):
    """A topology cycle whose gang ids point outside its gang term raises
    ValueError before any round (the kernels would read out of bounds)."""
    from tpu_scheduler_torch.topology.locality import pack_topology
    from tpu_scheduler_torch.topology.model import DEFAULT_LEVEL_KEYS, TopologyModel

    snap = synth_cluster(n_nodes=8, n_pending=20, seed=0, gang_fraction=0.5)
    for i, node in enumerate(snap.nodes):
        node.metadata.labels[DEFAULT_LEVEL_KEYS[1][1]] = f"r{i // 4}"
    packed = pack_snapshot(snap)
    compiled = TopologyModel.detect(snap.nodes).compile(snap.nodes)
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    bad = dataclasses.replace(topo, pod_gang_id=np.where(topo.pod_gang_id > 0, topo.n_gangs + 1, 0).astype(np.int32))
    with pytest.raises(ValueError, match="pod_gang_id"):
        CudaBackend(device="cpu").assign(dataclasses.replace(packed, **{field: bad}), PROFILES["default"])
    assert CudaBackend.supports_topology
    CudaBackend(device="cpu").assign(dataclasses.replace(packed, **{field: topo}), PROFILES["default"])


def test_port_imports_no_jax():
    """In a fresh interpreter, the port (every submodule) and chip_smoke.py
    load no jax module and no tpu_scheduler module."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpu_scheduler_torch\n"
        "for m in pkgutil.walk_packages(tpu_scheduler_torch.__path__, 'tpu_scheduler_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'tpu_scheduler.'))\n"
        "       or n == 'tpu_scheduler']\n"
        "print(json.dumps({'bad': bad, 'mods': sorted(n for n in sys.modules if n.startswith('tpu_scheduler_torch'))}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert len(report["mods"]) >= 15
    for name in ("delta.engine", "delta.index", "delta.repack", "delta.state", "runtime.checkpoint",
                 "runtime.http_api", "runtime.kubeconfig", "runtime.controller", "cli", "sim.chaos", "sim.cli",
                 "sim.clock", "sim.harness", "sim.multi", "sim.scenarios", "sim.scorecard", "sim.trace",
                 "sim.workload", "learn.objective", "rebalance.snapshot", "rebalance.solver", "fleet",
                 "runtime.shards", "fleet.keyer", "fleet.reservation", "fleet.resize", "parallel.mesh",
                 "sim.fuzz", "sim.fuzz.cli", "sim.fuzz.corpus", "sim.fuzz.coverage", "sim.fuzz.generate",
                 "sim.fuzz.oracle", "sim.fuzz.plan", "sim.fuzz.shrink", "rebalance.planner", "rebalance.executor",
                 "rebalance.whatif", "autoscale", "autoscale.policy", "autoscale.provider", "autoscale.controller",
                 "learn.env", "learn.search", "learn.distill", "learn.cli", "parallel.multihost", "ops.native_ext"):
        assert f"tpu_scheduler_torch.{name}" in report["mods"], name


def test_chip_smoke_refuses_without_cuda():
    """The smoke script prints no result and exits non-zero on a machine
    without CUDA."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# --- constrained cycles ------------------------------------------------------

CONS_ALL = dict(
    anti_affinity_fraction=0.2, spread_fraction=0.2, schedule_anyway_fraction=0.15, pod_affinity_fraction=0.15,
    preferred_pod_affinity_fraction=0.2,
)


def _with_constraints(snap, packed, pack_fn, **kw):
    cons = pack_fn(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes, **kw)
    assert cons is not None
    return dataclasses.replace(packed, constraints=cons)


def _constrained_both(jax_snap, port_snap, profile="default", block=64, **kw):
    """NativeBackend on the JAX package's packing vs CudaBackend(cpu) on the
    port's: equal results, a valid order witness, no kernel launch."""
    jp = _with_constraints(jax_snap, jax_pack(jax_snap, pod_block=block), jax_pack_constraints, **kw)
    tp = _with_constraints(port_snap, pack_snapshot(port_snap, pod_block=block), pack_constraints, **kw)
    rn = NativeBackend().schedule(jp, JAX_PROFILES[profile].with_(pod_block=block, max_rounds=64))
    launches = (choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED)
    rt = CudaBackend(device="cpu").schedule(tp, PROFILES[profile].with_(pod_block=block, max_rounds=64))
    assert (choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED) == launches
    _assert_same_result(rn, rt)
    assert _replay_validity(jax_snap, jp, rt) == 0
    return rt


@pytest.mark.parametrize("profile", ["default", "throughput"])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_constrained_cycle_matches_native(seed, profile):
    kw = dict(n_nodes=60, n_pending=400, n_bound=100, seed=seed, extended_fraction=0.1, **CONS_ALL)
    r = _constrained_both(jax_synth(**kw), synth_cluster(**kw), profile)
    assert len(r.bindings) > 300


def test_constrained_hard_only_matches_native():
    kw = dict(n_nodes=60, n_pending=400, n_bound=100, seed=2, anti_affinity_fraction=0.3, spread_fraction=0.3)
    ts = synth_cluster(**kw)
    tp = pack_snapshot(ts)
    cons = pack_constraints(ts, ts.pending_pods(), tp.padded_pods, tp.node_names, tp.padded_nodes)
    assert cons.n_pa_terms == cons.n_ppa_terms == cons.n_spread_soft == 0
    _constrained_both(jax_synth(**kw), ts)


def test_constrained_stalled_auction_stops():
    """A spread water line frozen by a full minimum domain defers the same
    pods every round: the cycle stops after STALL_ROUNDS rounds that accept
    nobody, well before the round cap (tests/test_constraints_tensor.py's
    stall case)."""
    kw = dict(n_nodes=100, n_pending=1200, n_bound=200, seed=0, spread_fraction=0.15)
    r = _constrained_both(
        jax_synth(**kw), synth_cluster(**kw), "throughput", block=4096, max_aa_terms=256, max_spread=256
    )
    assert r.rounds < 32 and len(r.bindings) > 1000 and r.unschedulable
    assert r.stats["acc_round"].max() == r.rounds - 1 - STALL_ROUNDS


def _keyless(m, node, pod):
    term = [m.PodAntiAffinityTerm(match_labels={"app": "db"}, topology_key="zone")]
    placed = [pod("old", labels={"app": "db"}, node_name="k1", phase="Running")]
    return [node("k1"), node("k2")], placed + [pod("new-db", labels={"app": "db"}, anti_affinity=term)]


def _namespaced(m, node, pod):
    term = [m.PodAntiAffinityTerm(match_labels={"app": "db"}, topology_key="zone")]
    placed = [pod("other-ns", namespace="prod", labels={"app": "db"}, node_name="a1", phase="Running")]
    return [node("a1", labels={"zone": "a"})], placed + [
        pod("new-db", namespace="dev", labels={"app": "db"}, anti_affinity=term)
    ]


@pytest.mark.parametrize(
    "build,want",
    [(_keyless, [("default/new-db", "k2")]), (_namespaced, [("dev/new-db", "a1")])],
    ids=["keyless_node_is_singleton_domain", "anti_affinity_namespace_scoped"],
)
def test_constrained_targeted_clusters(build, want):
    """Keyless nodes degrade to per-node domains; terms see only their own
    namespace (tests/test_constraints_tensor.py's cases)."""
    js = JaxSnapshot.build(*build(jax_objects, jax_node, jax_pod))
    ts = ClusterSnapshot.build(*build(port_objects, make_node, make_pod))
    assert _constrained_both(js, ts).bindings == want
