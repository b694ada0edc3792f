"""The port's host layer beside the cycle: ``CudaBackend``'s upload cache
(identity-keyed, weakref eviction, a cap, never written by a cycle) and the
host packing and predicates the controller calls — ``repack_avail``,
``extend_node_vocabs``, ``repack_incremental`` with ``res_memo``, the
resource-scale guard, the predicate chain (``check_node_validity``,
``unschedulable_reason_counts``, ``dominant_reason``), the snapshot's
resource helpers, ``masks.reason_rejection_counts`` and the manifest
serializers — each held bit for bit against the JAX package's function on
the same synthetic snapshots, node churn and vocabulary growth included."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.core.predicates as jax_pred  # noqa: E402
import tpu_scheduler.core.snapshot as jax_snapshot  # noqa: E402
import tpu_scheduler.ops.masks as jax_masks  # noqa: E402
import tpu_scheduler.ops.pack as jax_pack  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.backends.cuda as cuda_mod  # noqa: E402
import tpu_scheduler_torch.core.predicates as pred  # noqa: E402
import tpu_scheduler_torch.core.snapshot as snapshot  # noqa: E402
import tpu_scheduler_torch.ops.masks as masks  # noqa: E402
import tpu_scheduler_torch.ops.pack as pack  # noqa: E402
import tpu_scheduler_torch.testing as testing  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.models.profiles import PROFILES  # noqa: E402
from tpu_scheduler_torch.ops.constraints import pack_constraints  # noqa: E402
from tpu_scheduler_torch.topology.locality import pack_topology  # noqa: E402
from tpu_scheduler_torch.topology.model import DEFAULT_LEVEL_KEYS, TopologyModel  # noqa: E402

# One module per package for each piece, so a scenario runs the same code
# against both.
PORT = dict(objects=objects, snapshot=snapshot, pack=pack, testing=testing, pred=pred)
JAX = dict(objects=jax_objects, snapshot=jax_snapshot, pack=jax_pack, testing=jax_testing, pred=jax_pred)

MIXED = dict(
    n_nodes=24, n_pending=80, n_bound=40, seed=8, selector_fraction=0.4, tainted_fraction=0.3,
    cordoned_fraction=0.1, node_affinity_fraction=0.3, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3,
    extended_fraction=0.2,
)
CONSTRAINED = dict(
    n_nodes=16, n_pending=40, n_bound=48, seed=11, tainted_fraction=0.2, cordoned_fraction=0.1,
    node_affinity_fraction=0.2, anti_affinity_fraction=0.3, spread_fraction=0.3, pod_affinity_fraction=0.2,
    extended_fraction=0.2,
)
_PACKED_FIELDS = (
    "node_alloc", "node_avail", "node_labels", "node_taints", "node_aff", "node_valid", "node_taints_soft",
    "node_pref", "pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff", "pod_has_aff", "pod_prio",
    "pod_valid", "pod_ntol_soft", "pod_pref_w",
)
_PACKED_META = ("vocab", "taint_vocab", "aff_vocab", "soft_taint_vocab", "pref_vocab", "res_vocab", "res_scales",
                "node_names", "pod_names")


def _assert_packed_equal(p, j):
    for f in _PACKED_FIELDS:
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _PACKED_META:
        assert getattr(p, f) == getattr(j, f), f
    assert [q.metadata.name for q in p.pod_objs] == [q.metadata.name for q in j.pod_objs]


def _churn(m, snap):
    """Deterministic churn of ``snap`` with package ``m``'s objects: the
    first 10 pending pods leave, 5 are replaced by new objects (priority
    changed), 5 arrive with a selector pair, an affinity term and a
    preferred term no pod used before, and 6 pending pods get bound."""
    o, t = m["objects"], m["testing"]
    pending = snap.pending_pods()
    kept = pending[10:]
    replaced = [dataclasses.replace(kept[i], spec=dataclasses.replace(kept[i].spec, priority=9)) for i in range(5)]
    expr = o.LabelSelectorRequirement(key="slot", operator="In", values=["3", "5"])
    added = [
        t.make_pod(f"fresh-{i}", cpu="250m", memory="512Mi", node_selector={"name": f"node-{i}"},
                   node_affinity=[o.NodeSelectorTerm(match_expressions=[expr])],
                   preferred_node_affinity=[o.PreferredSchedulingTerm(weight=7, term=o.NodeSelectorTerm(
                       match_expressions=[o.LabelSelectorRequirement(key="pool", operator="Exists")]))])
        for i in range(5)
    ]
    bound = [dataclasses.replace(p, spec=dataclasses.replace(p.spec, node_name=f"node-{i}"),
                                 status=o.PodStatus(phase="Running")) for i, p in enumerate(kept[5:11])]
    others = [p for p in snap.pods if p not in pending]
    return m["snapshot"].ClusterSnapshot.build(snap.nodes, others + bound + replaced + kept[11:] + added)


def _run_repack(m, kw):
    """A full pack, then the controller's incremental path over churn: the
    packs, the memo's size, and each function's result."""
    pk = m["pack"]
    snap = m["testing"].synth_cluster(**kw)
    memo: dict = {}
    packed = pk.pack_snapshot(snap, res_memo=memo)
    snap2 = _churn(m, snap)
    out = {"full": packed, "avail": pk.repack_avail(packed, snap2)}
    grown = pk.extend_node_vocabs(packed, snap2)
    out["grown"] = grown
    out["incremental"] = pk.repack_incremental(grown, snap2, res_memo=memo)
    out["incremental_no_memo"] = pk.repack_incremental(grown, snap2)
    out["vocab_memo"] = pk.resource_vocab(snap2, memo)
    out["vocab"] = pk.resource_vocab(snap2)
    out["memo_size"] = len(memo)
    return out


@pytest.mark.parametrize("kw", [MIXED, dict(MIXED, seed=2, n_pending=120, extended_fraction=0.0)],
                         ids=["mixed", "no_extended"])
def test_repack_paths_match_jax(kw):
    p, j = _run_repack(PORT, kw), _run_repack(JAX, kw)
    for key in ("full", "avail", "grown", "incremental", "incremental_no_memo"):
        _assert_packed_equal(p[key], j[key])
    assert p["grown"] is not p["full"] and len(p["grown"].vocab) > len(p["full"].vocab)
    assert p["grown"].node_labels is not p["full"].node_labels  # grown by copy
    assert p["vocab_memo"] == j["vocab_memo"] == p["vocab"] == j["vocab"]
    assert p["memo_size"] == j["memo_size"]
    # The incremental pack equals a fresh pack with the grown vocabularies.
    snap2 = _churn(PORT, testing.synth_cluster(**kw))
    g = p["grown"]
    fresh = pack.pack_snapshot(snap2, vocab=g.vocab, taint_vocab=g.taint_vocab, aff_vocab=g.aff_vocab,
                               soft_taint_vocab=g.soft_taint_vocab, pref_vocab=g.pref_vocab)
    inc = p["incremental"]
    for f in ("pod_req", "pod_sel", "pod_ntol", "pod_aff", "pod_pref_w", "node_avail", "node_labels"):
        np.testing.assert_array_equal(getattr(inc, f), getattr(fresh, f), err_msg=f)


def test_repack_incremental_reuses_unchanged_rows(monkeypatch):
    """Only the 5 replaced and 5 new pods of the churn take the packing
    body; the 59 unchanged ones are gathered from the cached rows."""
    snap = testing.synth_cluster(**MIXED)
    packed = pack.pack_snapshot(snap)
    snap2 = _churn(PORT, snap)
    calls = []
    real = pack._pack_pods
    monkeypatch.setattr(pack, "_pack_pods", lambda pending, *a, **k: calls.append(len(pending)) or real(pending, *a, **k))
    inc = pack.repack_incremental(pack.extend_node_vocabs(packed, snap2), snap2)
    assert calls == [10]
    assert inc.num_pods == len(snap2.pending_pods()) == 69


def _refusals(m):
    """The ValueError messages of every refusal of the incremental paths:
    a changed node set, an extended allocatable that outgrows its frozen
    divisor, and the scale guard itself."""
    pk, t = m["pack"], m["testing"]
    snap = t.synth_cluster(**MIXED)
    packed = pk.pack_snapshot(snap)
    fewer = m["snapshot"].ClusterSnapshot.build(snap.nodes[1:], snap.pods)
    messages = []
    for fn in (pk.repack_avail, pk.extend_node_vocabs, pk.repack_incremental):
        with pytest.raises(ValueError) as e:
            fn(packed, fewer)
        messages.append(str(e.value))
    # A node whose extended allocatable outgrows the frozen divisor.
    big = dataclasses.replace(snap.nodes[0], status=dataclasses.replace(
        snap.nodes[0].status, allocatable={**snap.nodes[0].status.allocatable, "example.com/tpu": str(2**40)}))
    grown = m["snapshot"].ClusterSnapshot.build((big,) + snap.nodes[1:], snap.pods)
    for fn in (pk.repack_avail, pk.repack_incremental):
        with pytest.raises(ValueError) as e:
            fn(packed, grown)
        messages.append(str(e.value))
    with pytest.raises(ValueError) as e:
        pk._check_alloc_within_scales(np.array([[0, 0, 2**40]], dtype=np.int64), (1, 1024, 1))
    messages.append(str(e.value))
    pk._check_alloc_within_scales(np.array([[0, 0, 2**30]], dtype=np.int64), (1, 1024, 1))
    return messages


def test_node_churn_and_outgrown_scales_refuse_as_jax():
    messages = _refusals(PORT)
    assert len(messages) == 6
    assert messages == _refusals(JAX)


@pytest.mark.parametrize("m", [PORT, JAX], ids=["port", "jax"])
def test_vocab_bloat_refuses(m):
    """No new entry: the pack itself comes back; dead columns outnumbering
    the live entries: ValueError, in both packages."""
    t, pk = m["testing"], m["pack"]
    nodes = [t.make_node(f"n{i}", labels={"k": str(i)}) for i in range(4)]
    build = m["snapshot"].ClusterSnapshot.build
    snap0 = build(nodes, [t.make_pod(f"p{i}", node_selector={"k": str(i)}) for i in range(20)])
    packed = pk.pack_snapshot(snap0)
    assert pk.extend_node_vocabs(packed, snap0) is packed
    with pytest.raises(ValueError, match="vocabulary bloat"):
        pk.extend_node_vocabs(packed, build(nodes, [t.make_pod("r", node_selector={"y": "0"})]))


# --- predicates and the snapshot's resource helpers ---------------------------------


def _verdicts(m, kw):
    s, p = m["snapshot"], m["pred"]
    snap = m["testing"].synth_cluster(**kw)
    out = {"validity": [], "counts": [], "dominant": [], "resources": [], "fits": []}
    for node in snap.nodes:
        out["resources"].append(tuple(
            (r.cpu, r.memory, r.extended) for r in (s.node_allocatable(node), s.node_allocatable(node, snap),
                                                    s.node_used_resources(snap, node.name),
                                                    s.node_net_available(snap, node))))
    for pod in snap.pending_pods():
        out["validity"].append(tuple(
            None if (r := p.check_node_validity(pod, node, snap)) is None else r.value for node in snap.nodes))
        counts, feasible, total = p.unschedulable_reason_counts(pod, snap)
        out["counts"].append((counts, feasible, total))
        out["dominant"].append(p.dominant_reason(counts, feasible))
        out["fits"].append([p.pod_fits_resources(pod, n, snap) for n in snap.nodes])
    return out


@pytest.mark.parametrize("kw", [MIXED, CONSTRAINED], ids=["mixed", "constrained"])
def test_predicate_chain_matches_jax(kw):
    got, want = _verdicts(PORT, kw), _verdicts(JAX, kw)
    assert got == want
    reasons = {v for row in got["validity"] for v in row}
    assert len(reasons) >= 4  # several predicates decide somewhere
    assert [r.value for r in pred.InvalidNodeReason] == [r.value for r in jax_pred.InvalidNodeReason]
    assert pred.dominant_reason({}, 0) == jax_pred.dominant_reason({}, 0)
    assert pred.dominant_reason({"A": 2, "B": 2}, 0) == jax_pred.dominant_reason({"A": 2, "B": 2}, 0) == "A"


def test_snapshot_helpers_return_copies():
    snap = testing.synth_cluster(**MIXED)
    node = snap.nodes[0]
    net = snapshot.node_net_available(snap, node)
    net.cpu -= 10**6
    assert snapshot.node_net_available(snap, node).cpu != net.cpu
    assert snap.pods_on_node(node.name) == [p for p in snap.pods if p.spec.node_name == node.name]


def test_reason_rejection_counts_match_jax():
    packed = pack.pack_snapshot(testing.synth_cluster(**MIXED))
    a = {k: getattr(packed, k) for k in ("pod_req", "pod_sel", "pod_sel_count", "node_avail", "node_labels",
                                         "pod_ntol", "node_taints", "pod_aff", "pod_has_aff", "node_aff")}
    want = jax_masks.reason_rejection_counts(np, jax_masks.feasibility_breakdown(np, *a.values()), packed.node_valid)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = masks.reason_rejection_counts(masks.feasibility_breakdown(*t.values()), torch.from_numpy(packed.node_valid))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert any(int(v.sum()) for v in got.values())


# --- objects ---------------------------------------------------------------------


def _no_uid(d):
    d = dict(d, metadata={k: v for k, v in d["metadata"].items() if k != "uid"})
    return d


def test_manifest_serializers_match_jax():
    kw = dict(MIXED, anti_affinity_fraction=0.3, spread_fraction=0.3, schedule_anyway_fraction=0.2,
              pod_affinity_fraction=0.2, preferred_pod_affinity_fraction=0.3, gang_fraction=0.2)
    sp, sj = testing.synth_cluster(**kw), jax_testing.synth_cluster(**kw)
    assert [_no_uid(objects.pod_to_dict(p)) for p in sp.pods] == [_no_uid(jax_objects.pod_to_dict(p)) for p in sj.pods]
    assert [_no_uid(objects.node_to_dict(n)) for n in sp.nodes] == [
        _no_uid(jax_objects.node_to_dict(n)) for n in sj.nodes]
    manifest = {"metadata": {"name": "pdb", "namespace": "ns"},
                "spec": {"selector": {"matchLabels": {"app": "a"}, "matchExpressions": [
                    {"key": "tier", "operator": "In", "values": ["x"]}]}, "minAvailable": 2}}
    pdb, jpdb = objects.PodDisruptionBudget.from_dict(manifest), jax_objects.PodDisruptionBudget.from_dict(manifest)
    assert pdb.to_dict() == jpdb.to_dict()
    strip = lambda d: dict(d, metadata={k: v for k, v in d["metadata"].items() if k != "uid"})  # noqa: E731
    assert strip(dataclasses.asdict(pdb)) == strip(dataclasses.asdict(jpdb))
    b = objects.Binding(metadata=objects.ObjectMeta(name="p", uid="u"), target=objects.ObjectReference(name="n"))
    jb = jax_objects.Binding(metadata=jax_objects.ObjectMeta(name="p", uid="u"),
                             target=jax_objects.ObjectReference(name="n"))
    assert dataclasses.asdict(b) == dataclasses.asdict(jb)


def test_pod_resources_arithmetic_matches_jax():
    pods_p = testing.synth_cluster(**MIXED).pods
    pods_j = jax_testing.synth_cluster(**MIXED).pods
    acc_p, acc_j = objects.PodResources(), jax_objects.PodResources()
    for a, b in zip(pods_p, pods_j):
        rp, rj = objects.total_pod_resources(a), jax_objects.total_pod_resources(b)
        acc_p += rp
        acc_j += rj
        assert rp.fits_in(acc_p) == rj.fits_in(acc_j)
    acc_p -= objects.total_pod_resources(pods_p[3])
    acc_j -= jax_objects.total_pod_resources(pods_j[3])
    assert dataclasses.asdict(acc_p) == dataclasses.asdict(acc_j)
    c = acc_p.copy()
    c.cpu += 1
    assert c.cpu != acc_p.cpu


# --- the upload cache ---------------------------------------------------------------


def test_cache_hits_misses_evicts_and_caps():
    backend = CudaBackend(device="cpu")
    cuda_mod.UPLOAD_BYTES = 0
    a = np.arange(1000, dtype=np.int32)
    t1 = backend._put(a)
    assert cuda_mod.UPLOAD_BYTES == a.nbytes
    assert backend._put(a) is t1 and cuda_mod.UPLOAD_BYTES == a.nbytes  # hit
    assert t1.data_ptr() != a.ctypes.data  # a copy, never an alias of the host array
    b = a.copy()
    assert backend._put(b) is not t1 and cuda_mod.UPLOAD_BYTES == 2 * a.nbytes  # miss
    assert len(backend._dev_cache) == 2
    del a, b
    gc.collect()
    assert len(backend._dev_cache) == 0  # evicted with their host arrays
    backend._dev_cache_cap = 4
    keep = [np.full(8, i, dtype=np.int32) for i in range(10)]
    for arr in keep:
        backend._put(arr)
    assert len(backend._dev_cache) == 4
    assert set(backend._dev_cache) == {id(arr) for arr in keep[-4:]}
    backend._put(keep[6])  # a hit refreshes recency
    backend._put(np.zeros(3, np.int32))
    assert id(keep[6]) in backend._dev_cache and id(keep[7]) not in backend._dev_cache


def test_cache_eviction_inside_a_locked_put_does_not_deadlock():
    """The cyclic garbage collector can run an upload's finalizer (the
    eviction) on any allocation, also inside ``_put``'s locked section on
    the same thread: the put finishes and the dead entry is gone.  (With a
    non-reentrant lock the thread waited on itself forever; a ``sim fuzz``
    campaign over one backend hung that way.)"""
    import threading

    class CollectingDict(dict):
        def pop(self, *a):
            gc.collect()  # the dead cycle's array dies here, under the lock
            return super().pop(*a)

    backend = CudaBackend(device="cpu")
    backend._dev_cache = CollectingDict()
    gc.disable()
    try:
        doomed = np.arange(16, dtype=np.int32)
        backend._put(doomed)
        cycle = [doomed]
        cycle.append(cycle)  # reachable only through a reference cycle
        del doomed, cycle
        live = np.ones(8, dtype=np.int32)
        done = threading.Event()
        worker = threading.Thread(target=lambda: (backend._put(live), done.set()), daemon=True)
        worker.start()
        worker.join(timeout=30)
        assert done.is_set(), "_put deadlocked on its own finalizer"
        assert list(backend._dev_cache) == [id(live)]
    finally:
        gc.enable()


def _labelled(kw):
    snap = testing.synth_cluster(**kw)
    for i, node in enumerate(snap.nodes):
        node.metadata.labels.update({DEFAULT_LEVEL_KEYS[0][1]: f"s{i // 4}", DEFAULT_LEVEL_KEYS[1][1]: f"r{i // 8}"})
    packed = pack.pack_snapshot(snap, pod_block=32)
    compiled = TopologyModel.detect(snap.nodes).compile(snap.nodes)
    args = (snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    return dataclasses.replace(packed, topology=pack_topology(compiled, *args), constraints=pack_constraints(snap, *args))


def test_cycles_leave_cached_tensors_unchanged():
    """Two cycles on one constrained topology cluster: the second uploads
    nothing, every cached tensor is bit-equal after each cycle, and the
    results are equal; a copy of the cluster misses the cache."""
    packed = _labelled(dict(CONSTRAINED, gang_fraction=0.4, schedule_anyway_fraction=0.2,
                            preferred_pod_affinity_fraction=0.2))
    backend = CudaBackend(device="cpu")
    profile = PROFILES["default"].with_(pod_block=32, max_rounds=64)
    cuda_mod.UPLOAD_BYTES = 0
    r1 = backend.schedule(packed, profile)
    first_bytes = cuda_mod.UPLOAD_BYTES
    assert first_bytes > 0
    before = {k: ent[1].clone() for k, ent in backend._dev_cache.items()}
    r2 = backend.schedule(packed, profile)
    assert cuda_mod.UPLOAD_BYTES == first_bytes  # all hits
    assert set(backend._dev_cache) == set(before)
    for k, ent in backend._dev_cache.items():
        assert torch.equal(ent[1], before[k])
    np.testing.assert_array_equal(r1.assigned, r2.assigned)
    assert r1.rounds == r2.rounds and r1.bindings == r2.bindings
    copy = dataclasses.replace(packed, **{k: v.copy() for k, v in packed.device_arrays().items()})
    r3 = backend.schedule(copy, profile)
    assert cuda_mod.UPLOAD_BYTES > first_bytes
    np.testing.assert_array_equal(r3.assigned, r1.assigned)
