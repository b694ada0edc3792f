"""Checkpoints of the port (``tpu_scheduler_torch/runtime/checkpoint.py``)
against the JAX package's: the same files (JSON keys and values, ``.npz``
array names and contents) for the same scheduler state, round trips within
the port, and restores across the packages in both directions — the
requeue ledger, the counters, the packed node cache and the delta engine's
``"restore"`` escalation all carry over, and the restored schedulers go on
to bind exactly as each other.  A version mismatch raises the same error."""

import json
import os
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.runtime.checkpoint as jax_checkpoint  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.testing as jt  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.runtime.checkpoint as checkpoint  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


PACKED_ARRAYS = ("node_alloc", "node_avail", "node_labels", "node_taints", "node_aff", "node_valid",
                 "node_taints_soft", "node_pref")
# Counters the two packages keep differently by construction (the last
# three only the port keeps).
UNCOMPARED = ("scheduler_device_transfer_bytes_total", "scheduler_delta_early_escalations_total",
              "scheduler_assumed_overlay_view_pods_total", "scheduler_assumed_overlay_cloned_pods_total")


def _mods(port):
    if port:
        return fake_api, controller, checkpoint, (lambda: CudaBackend(device="cpu"))
    return jax_fake_api, jax_controller, jax_checkpoint, NativeBackend


def _cluster():
    """A node too small for one pod (a requeue), room for the rest, a few
    bound pods, gangs and selectors."""
    snap = jt.synth_cluster(n_nodes=6, n_pending=30, n_bound=8, seed=2, selector_fraction=0.3,
                            node_affinity_fraction=0.2, soft_taint_fraction=0.2, preferred_affinity_fraction=0.2)
    nodes = list(snap.nodes) + [jt.make_node("tiny", cpu="0", memory="0")]
    pods = list(snap.pods) + [jt.make_pod("stuck", cpu="64", memory="1Gi")]
    return nodes, pods


def _world(port, nodes, pods, t=100.0):
    api_mod, ctl, _ckpt, backend = _mods(port)
    clock = FakeClock(t)
    api = api_mod.FakeApiServer(clock=clock)
    conv_n = (lambda n: objects.Node.from_dict(jax_objects.node_to_dict(n))) if port else (lambda n: n)
    conv_p = (lambda p: objects.Pod.from_dict(jax_objects.pod_to_dict(p))) if port else (lambda p: p)
    api.load([conv_n(n) for n in nodes], [conv_p(p) for p in pods])
    sched = ctl.Scheduler(api, backend(), clock=clock, rng=random.Random(3), requeue_seconds=30.0)
    return api, sched, clock, conv_p


def _saved(port, path, t=100.0):
    """Run two cycles (a cold wave, then a delta cycle with late arrivals)
    and save; the scheduler and its API server."""
    nodes, pods = _cluster()
    api, sched, clock, conv = _world(port, nodes, pods, t)
    sched.run_cycle()
    for i in range(3):
        api.create_pod(conv(jt.make_pod(f"late-{i}", cpu="500m", memory="512Mi")))
    clock.t += 5.0
    sched.run_cycle()
    _mods(port)[2].save_scheduler(sched, str(path))
    return api, sched


def _files(path):
    with open(os.path.join(str(path), "state.json")) as f:
        state = json.load(f)
    state["counters"] = {k: v for k, v in state["counters"].items() if k not in UNCOMPARED}
    with np.load(os.path.join(str(path), "node_tensors.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return state, arrays


def test_checkpoint_files_match_jax(tmp_path):
    """The same scheduler state writes the same checkpoint in both packages:
    every JSON key and value (counters less the transfer bytes), every
    ``.npz`` array name, dtype and content."""
    _saved(True, tmp_path / "port")
    _saved(False, tmp_path / "jax")
    p_state, p_arrays = _files(tmp_path / "port")
    j_state, j_arrays = _files(tmp_path / "jax")
    assert p_state == j_state
    assert p_state["version"] == checkpoint.CHECKPOINT_VERSION == jax_checkpoint.CHECKPOINT_VERSION == 5
    assert p_state["delta"]["delta_cycles"] == 1 and p_state["shards"]["0"]["requeue"]
    assert sorted(p_arrays) == sorted(j_arrays) == sorted(PACKED_ARRAYS)
    for k in PACKED_ARRAYS:
        assert p_arrays[k].dtype == j_arrays[k].dtype, k
        np.testing.assert_array_equal(p_arrays[k], j_arrays[k], err_msg=k)


def _saved_after_wave(port, path):
    """A cold wave, then a wave whose pending pods pass the overflow
    threshold (it escalates before the fold), saved right after it."""
    nodes, pods = _cluster()
    api, sched, clock, conv = _world(port, nodes, pods)
    sched.delta.OVERFLOW_MIN, sched.delta.OVERFLOW_FRAC = 4, 0.1
    sched.run_cycle()
    for i in range(24):
        api.create_pod(conv(jt.make_pod(f"wave-{i}", cpu="100m", memory="128Mi")))
    clock.t += 5.0
    sched.run_cycle()
    _mods(port)[2].save_scheduler(sched, str(path))
    return sched


def test_checkpoint_after_escalated_wave_matches_jax(tmp_path):
    """A checkpoint taken right after a wave that escalated before the fold
    writes the JAX package's files, though the port's placement ledger is
    still unwritten then (the save reads none of it); read afterwards, both
    ledgers and the engine's stats are the JAX package's."""
    ps = _saved_after_wave(True, tmp_path / "port")
    assert ps.delta.state._deferred is not None
    js = _saved_after_wave(False, tmp_path / "jax")
    p_state, p_arrays = _files(tmp_path / "port")
    j_state, j_arrays = _files(tmp_path / "jax")
    assert p_state == j_state
    assert p_state["delta"]["full_solve_reasons"] == {"closure-overflow": 1, "cold": 1}
    assert ps.metrics.snapshot().get("scheduler_delta_early_escalations_total") == 1
    assert sorted(p_arrays) == sorted(j_arrays)
    for k in p_arrays:
        np.testing.assert_array_equal(p_arrays[k], j_arrays[k], err_msg=k)
    assert ps.delta.stats() == js.delta.stats()
    for st, other in ((ps.delta.state, js.delta.state),):
        assert sorted(st.unsched.items()) == sorted(other.unsched.items())
        assert sorted((pf, r, n, tuple(int(x) for x in q)) for pf, (r, n, q) in st.placements.items()) == \
            sorted((pf, r, n, tuple(int(x) for x in q)) for pf, (r, n, q) in other.placements.items())
        assert (st.used64 == other.used64).all() and (st.alloc64 == other.alloc64).all()
    ps.close()
    js.close()


def _restored_view(sched):
    """What a restore puts into a scheduler, comparably."""
    packed = sched._packed
    return {
        "requeue": {k: round(v, 9) for k, v in dict(sched.requeue_at).items()},
        "meta": dict(sched.requeue_at.meta()),
        "counters": {k: v for k, v in sched.metrics.counters.items() if k not in UNCOMPARED},
        "cycle_count": sched._cycle_count,
        "node_sig": sched._node_sig,
        "deferred": dict(sched.deferred_binds),
        "delta": (sched.delta.generation, sched.delta.delta_cycles, sched.delta.skipped_total,
                  dict(sched.delta.full_solve_reasons)),
        "packed": None if packed is None else (
            packed.node_names, packed.res_vocab, packed.res_scales, dict(packed.vocab), dict(packed.taint_vocab),
            dict(packed.aff_vocab), dict(packed.soft_taint_vocab), dict(packed.pref_vocab),
            [getattr(packed, k).tolist() for k in PACKED_ARRAYS],
            {k: (getattr(packed, k).shape, str(getattr(packed, k).dtype)) for k in ("pod_req", "pod_sel", "pod_ntol",
                                                                                   "pod_aff", "pod_pref_w")}),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    """A checkpoint written by one package restores into a fresh scheduler
    of each, over the cluster as it stood at the save: the same requeue
    ledger (deadlines re-based on the new clock), counters, packed cache and
    engine counters; the first cycle escalates with "restore", and both
    restored schedulers bind the same pods to the same nodes."""
    path = tmp_path / writer
    w_api, _ = _saved(writer == "port", path)
    w_objs = objects if writer == "port" else jax_objects
    node_docs = [w_objs.node_to_dict(n) for n in w_api.list_nodes()]
    pod_docs = [w_objs.pod_to_dict(p) for p in w_api.list_pods()]
    views, outcomes = [], []
    for port in (True, False):
        api_mod, ctl, ckpt, backend = _mods(port)
        objs = objects if port else jax_objects
        clock = FakeClock(7.0)
        api = api_mod.FakeApiServer(clock=clock)
        api.load([objs.Node.from_dict(d) for d in node_docs], [objs.Pod.from_dict(d) for d in pod_docs])
        sched = ctl.Scheduler(api, backend(), clock=clock, rng=random.Random(3), requeue_seconds=30.0)
        assert ckpt.restore_scheduler(sched, str(path)) is True
        views.append(_restored_view(sched))
        api.create_pod(objs.Pod.from_dict(jax_objects.pod_to_dict(jt.make_pod("after", cpu="250m", memory="256Mi"))))
        clock.t += 1.0
        m = sched.run_cycle()
        outcomes.append(((m.pending, m.bound, m.unschedulable), sched.delta.stats(),
                         sorted((p.metadata.name, p.spec.node_name) for p in api.list_pods())))
        assert sched.delta.stats()["full_solve_reasons"].get("restore") == 1
        assert "default/stuck" in sched.requeue_at
        sched.close()
    assert views[0] == views[1]
    assert views[0]["packed"] is not None and views[0]["delta"][1] == 1
    assert views[0]["requeue"]["default/stuck"] == pytest.approx(7.0 + 30.0 - 5.0)
    assert outcomes[0] == outcomes[1] and outcomes[0][0][1] == 1


@pytest.mark.parametrize("case", ["requeue", "counters", "packed_cache", "stale", "missing", "reordered"])
def test_checkpoint_round_trip(case, tmp_path):
    """The JAX package's checkpoint round trips, on the port: requeue
    backoffs keep their remaining time on a new clock, counters and the
    cycle count survive, the packed cache seeds the incremental pack, a
    stale or reordered cache costs one full repack but never a wrong
    decision, a missing checkpoint is a no-op."""
    def conv(p):
        return objects.Pod.from_dict(jax_objects.pod_to_dict(p))

    def node(n):
        return objects.Node.from_dict(jax_objects.node_to_dict(n))

    def build(api, clock=None):
        return controller.Scheduler(api, CudaBackend(device="cpu"), clock=clock or FakeClock(1000.0))

    api = fake_api.FakeApiServer()
    path = str(tmp_path)
    if case == "missing":
        sched = build(api)
        assert checkpoint.restore_scheduler(sched, str(tmp_path / "nope")) is False
        assert sched.requeue_at == {}
        return
    if case == "requeue":
        api.load([node(jt.make_node("n1", cpu="0", memory="0"))], [conv(jt.make_pod("stuck", cpu="1", memory="1Gi"))])
        sched = build(api, FakeClock(100.0))
        sched.run_cycle()
        assert sched.requeue_at["default/stuck"] == pytest.approx(100.0 + sched.requeue_seconds)
        checkpoint.save_scheduler(sched, path)
        clock2 = FakeClock(5.0)
        sched2 = build(api, clock2)
        assert checkpoint.restore_scheduler(sched2, path) is True
        assert sched2.requeue_at["default/stuck"] == pytest.approx(5.0 + sched.requeue_seconds)
        assert sched2.run_cycle().pending == 0
        clock2.t += sched2.requeue_seconds + 1
        m = sched2.run_cycle()
        assert m.pending == 1 and m.unschedulable == 1
    elif case == "counters":
        api.load([node(jt.make_node("n1", cpu="8", memory="32Gi"))], [conv(jt.make_pod(f"p{i}")) for i in range(3)])
        sched = build(api)
        sched.run_cycle()
        checkpoint.save_scheduler(sched, path)
        sched2 = build(api)
        checkpoint.restore_scheduler(sched2, path)
        assert sched2.metrics.counters["scheduler_bindings_total"] == 3
        assert sched2._cycle_count == sched._cycle_count
    elif case == "packed_cache":
        api.load([node(jt.make_node(f"n{i}", cpu="8", memory="32Gi")) for i in range(4)],
                 [conv(jt.make_pod(f"p{i}")) for i in range(6)])
        sched = build(api)
        sched.run_cycle()
        checkpoint.save_scheduler(sched, path)
        sched2 = build(api)
        checkpoint.restore_scheduler(sched2, path)
        np.testing.assert_array_equal(sched2._packed.node_alloc, sched._packed.node_alloc)
        for i in range(3):
            api.create_pod(conv(jt.make_pod(f"late-{i}")))
        assert sched2.run_cycle().bound == 3
        assert sched2.metrics.counters.get("scheduler_incremental_packs_total", 0) >= 1
        assert sched2.metrics.counters["scheduler_full_packs_total"] == 1
    elif case == "stale":
        api.load([node(jt.make_node("n1", cpu="8", memory="32Gi"))], [conv(jt.make_pod("p0"))])
        sched = build(api)
        sched.run_cycle()
        checkpoint.save_scheduler(sched, path)
        api2 = fake_api.FakeApiServer()
        api2.load([node(jt.make_node("m1", cpu="8", memory="32Gi")), node(jt.make_node("m2", cpu="8", memory="32Gi"))],
                  [conv(jt.make_pod("q0")), conv(jt.make_pod("q1"))])
        sched2 = build(api2)
        checkpoint.restore_scheduler(sched2, path)
        assert sched2.run_cycle().bound == 2
        assert sched2.metrics.counters["scheduler_full_packs_total"] == 2
    else:
        api.load([node(jt.make_node("a", cpu="8", memory="32Gi")), node(jt.make_node("c", cpu="8", memory="32Gi"))], [])
        sched = build(api)
        sched.run_cycle()
        api.create_node(node(jt.make_node("b", cpu="8", memory="32Gi")))
        api.create_pod(conv(jt.make_pod("p0")))
        sched.run_cycle()
        checkpoint.save_scheduler(sched, path)
        api2 = fake_api.FakeApiServer()
        api2.load([node(jt.make_node(n, cpu="8", memory="32Gi")) for n in ("a", "b", "c")], [conv(jt.make_pod("q0"))])
        by_name = {n.name: n for n in api2.list_nodes()}
        for old in api.list_nodes():
            by_name[old.name].metadata.resource_version = old.metadata.resource_version
        sched2 = build(api2)
        checkpoint.restore_scheduler(sched2, path)
        assert sched2.run_cycle().bound == 1


@pytest.mark.parametrize("version", [1, 3, 4, 999])
def test_checkpoint_versions(version, tmp_path):
    """Versions 1-5 restore (an old file starts the engine cold, then one
    full wave); any other raises the JAX package's ValueError, word for
    word."""
    state = {"version": version, "cycle_count": 5, "counters": {}, "noexecute_elapsed": [], "pdb_peaks": {},
             "pdb_disruptions": {}, "node_sig": None}
    if version >= 3:
        state.update(shard_count=1, shards={"0": {"requeue": {"default/a": [10.0, "no-node", 2]}}}, deferred_binds=[])
    else:
        state.update(requeue_remaining={"default/a": 10.0}, requeue_meta={"default/a": ["no-node", 2]})
    os.makedirs(str(tmp_path), exist_ok=True)
    with open(os.path.join(str(tmp_path), "state.json"), "w") as f:
        json.dump(state, f)
    errors = []
    for port in (True, False):
        api_mod, ctl, ckpt, backend = _mods(port)
        sched = ctl.Scheduler(api_mod.FakeApiServer(), backend(), clock=FakeClock())
        try:
            assert ckpt.restore_scheduler(sched, str(tmp_path)) is True
        except ValueError as e:
            errors.append(str(e))
            continue
        assert sched.requeue_at.attempts("default/a") == 2 and sched._cycle_count == 5
        assert sched.delta.delta_cycles == 0
    if version == 999:
        assert len(errors) == 2 and errors[0] == errors[1] == "checkpoint version 999 != 5"
    else:
        assert errors == []


def test_shard_hash_matches_jax():
    from tpu_scheduler.runtime.shards import shard_for_name as jax_shard_for_name

    for key in ("default/a", "default/g1-0", "gang-7", ""):
        for k in (1, 2, 4, 7):
            assert checkpoint.shard_for_name(key, k) == jax_shard_for_name(key, k)
