"""Host packing of the PyTorch/CUDA port vs the JAX package: the port's
``synth_cluster`` + ``pack_snapshot`` must produce exactly the JAX package's
tensors (every ``device_arrays()`` entry, dtype and value), names,
vocabularies and resource scales — bit for bit, the contract the JAX
package holds between its own backends."""

import dataclasses

import numpy as np
import pytest

from tpu_scheduler.core.snapshot import ClusterSnapshot as JaxSnapshot
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
from tpu_scheduler.testing import make_node as jax_node
from tpu_scheduler.testing import make_pod as jax_pod
from tpu_scheduler.testing import synth_cluster as jax_synth
from tpu_scheduler_torch.convert import packed_from_arrays
from tpu_scheduler_torch.core.snapshot import ClusterSnapshot
from tpu_scheduler_torch.errors import PackingError
from tpu_scheduler_torch.ops.pack import pack_snapshot
from tpu_scheduler_torch.testing import make_node, make_pod, synth_cluster

FEATURES = {
    "plain": {},
    "hard": dict(selector_fraction=0.5, tainted_fraction=0.3, cordoned_fraction=0.1, node_affinity_fraction=0.4),
    "soft": dict(soft_taint_fraction=0.4, preferred_affinity_fraction=0.4),
    "extended": dict(extended_fraction=0.3),
    "all": dict(
        selector_fraction=0.3, multi_container_fraction=0.3, tainted_fraction=0.2, cordoned_fraction=0.05,
        node_affinity_fraction=0.3, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3, extended_fraction=0.2,
    ),
    # Constraint fractions draw from the same random stream: the pods (and
    # so the packed tensors) must still match.
    "constraint_draws": dict(
        anti_affinity_fraction=0.2, spread_fraction=0.2, schedule_anyway_fraction=0.1, gang_fraction=0.1,
        pod_affinity_fraction=0.1, preferred_pod_affinity_fraction=0.1,
    ),
}

VOCABS = ("vocab", "taint_vocab", "aff_vocab", "soft_taint_vocab", "pref_vocab")


def assert_packed_equal(jp, tp):
    ja, ta = jp.device_arrays(), tp.device_arrays()
    assert sorted(ja) == sorted(ta)
    for key, arr in ja.items():
        assert ta[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(ta[key], arr, err_msg=key)
    assert tp.pod_names == jp.pod_names
    assert tp.node_names == jp.node_names
    for key in VOCABS:
        assert getattr(tp, key) == getattr(jp, key), key
    assert tp.res_vocab == jp.res_vocab
    assert tp.res_scales == jp.res_scales


@pytest.mark.parametrize("blocks", [(16, 8), (1, 1)])
@pytest.mark.parametrize("features", sorted(FEATURES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_matches_jax(seed, features, blocks):
    kw = dict(n_nodes=40, n_pending=150, n_bound=60, seed=seed, **FEATURES[features])
    pod_block, node_block = blocks
    jp = jax_pack(jax_synth(**kw), pod_block=pod_block, node_block=node_block)
    tp = pack_snapshot(synth_cluster(**kw), pod_block=pod_block, node_block=node_block)
    assert_packed_equal(jp, tp)


@pytest.mark.parametrize("seed", [0, 4])
def test_round_trip_through_convert(seed):
    """The JAX package's PackedCluster fields, carried across as NumPy
    arrays, rebuild the port's PackedCluster exactly — and share no buffer
    with the source."""
    kw = dict(n_nodes=30, n_pending=90, n_bound=30, seed=seed, **FEATURES["all"])
    jp = jax_pack(jax_synth(**kw), pod_block=8, node_block=8)
    carried = packed_from_arrays(
        jp.device_arrays(), jp.pod_names, jp.node_names,
        **{k: getattr(jp, k) for k in VOCABS}, res_vocab=jp.res_vocab, res_scales=jp.res_scales,
    )
    assert_packed_equal(jp, carried)
    assert_packed_equal(jp, pack_snapshot(synth_cluster(**kw), pod_block=8, node_block=8))
    assert not np.shares_memory(carried.pod_req, jp.pod_req)
    assert carried.constraints is None and carried.topology is None
    with pytest.raises(TypeError, match="unknown fields"):
        packed_from_arrays(jp.device_arrays(), jp.pod_names, jp.node_names, bogus={})


def test_degenerate_clusters_match_jax():
    """Zero nodes, zero pending pods, and a pod with negative priority and
    an extended request against nodes that lack the resource."""
    cases = [
        ([], [("p", dict())]),
        ([("n", dict())], []),
        ([("a", dict(cpu="2")), ("b", dict(cpu="4", extended={"example.com/gpu": "2"}))],
         [("p0", dict(priority=-3, extended={"example.com/gpu": "1"})), ("p1", dict(priority=5, cpu="3"))]),
    ]
    for nodes, pods in cases:
        jp = jax_pack(JaxSnapshot.build([jax_node(n, **k) for n, k in nodes], [jax_pod(p, **k) for p, k in pods]))
        tp = pack_snapshot(ClusterSnapshot.build([make_node(n, **k) for n, k in nodes], [make_pod(p, **k) for p, k in pods]))
        assert_packed_equal(jp, tp)


def test_supplied_vocab_miss_raises():
    snap = synth_cluster(n_nodes=8, n_pending=40, seed=1, selector_fraction=1.0)
    with pytest.raises(PackingError):
        pack_snapshot(snap, vocab={})
    assert isinstance(PackingError("x"), KeyError)


def test_packed_cluster_is_frozen():
    packed = pack_snapshot(synth_cluster(n_nodes=4, n_pending=4, seed=0))
    with pytest.raises(dataclasses.FrozenInstanceError):
        packed.pod_req = None
