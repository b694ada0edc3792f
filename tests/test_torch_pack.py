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


# --- inter-pod constraint packing (ops/constraints.py host half) ------------

import types  # noqa: E402

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler_torch.api.objects as port_objects  # noqa: E402
from tpu_scheduler.ops.constraints import UntensorizableConstraints as JaxUntensorizable  # noqa: E402
from tpu_scheduler.ops.constraints import pack_constraints as jax_pack_constraints  # noqa: E402
from tpu_scheduler_torch.convert import constraints_from_arrays  # noqa: E402
from tpu_scheduler_torch.ops.constraints import UntensorizableConstraints, pack_constraints  # noqa: E402

JAX_NS = types.SimpleNamespace(node=jax_node, pod=jax_pod, snap=JaxSnapshot, obj=jax_objects)
PORT_NS = types.SimpleNamespace(node=make_node, pod=make_pod, snap=ClusterSnapshot, obj=port_objects)

CONSTRAINT_MIXES = {
    "all": dict(
        anti_affinity_fraction=0.2, spread_fraction=0.2, schedule_anyway_fraction=0.15, pod_affinity_fraction=0.15,
        preferred_pod_affinity_fraction=0.2,
    ),
    "hard": dict(anti_affinity_fraction=0.3, spread_fraction=0.3),
    "soft": dict(schedule_anyway_fraction=0.3, preferred_pod_affinity_fraction=0.3),
}


def _placed_cluster(m):
    """Placed pods carrying and matching every term kind, across two
    namespaces, on zone-keyed and keyless nodes."""
    o = m.obj
    nodes = [m.node(f"z{i}", labels={"zone": f"z{i % 3}", "name": f"z{i}"}) for i in range(6)]
    nodes += [m.node(f"k{i}") for i in range(2)]  # keyless
    aa = [o.PodAntiAffinityTerm(match_labels={"app": "db"}, topology_key="zone")]
    host_aa = [o.PodAntiAffinityTerm(match_labels={"app": "web"}, topology_key="name")]
    pa = [o.PodAntiAffinityTerm(match_labels={"pa": "g1"}, topology_key="zone")]
    ppa = [o.WeightedPodAffinityTerm(weight=50, term=o.PodAntiAffinityTerm(match_labels={"sg": "s"}, topology_key="zone"))]
    spread = [o.TopologySpreadConstraint(topology_key="zone", max_skew=1, match_labels={"app": "web"})]
    soft = [o.TopologySpreadConstraint(topology_key="zone", max_skew=2, match_labels={"app": "db"},
                                       when_unsatisfiable="ScheduleAnyway")]
    pods = [
        m.pod("old-db", labels={"app": "db", "pa": "g1"}, anti_affinity=aa, node_name="z0", phase="Running"),
        m.pod("old-web", labels={"app": "web", "sg": "s"}, anti_affinity=host_aa, node_name="k0", phase="Running"),
        m.pod("old-prod", namespace="prod", labels={"app": "db"}, node_name="z1", phase="Running"),
        m.pod("old-sg", labels={"sg": "s", "app": "web"}, node_name="z4", phase="Running"),
        m.pod("new-db", labels={"app": "db"}, anti_affinity=aa, topology_spread=soft),
        m.pod("new-web", labels={"app": "web"}, anti_affinity=host_aa, topology_spread=spread),
        m.pod("new-pa", labels={"pa": "g1"}, pod_affinity=pa, preferred_pod_affinity=ppa),
        m.pod("new-prod", namespace="prod", labels={"app": "db"}, anti_affinity=aa),
        m.pod("new-anti", labels={"sg": "x"}, preferred_pod_anti_affinity=ppa),
    ]
    return m.snap.build(nodes, pods)


def _pack_cons(snap, packed, pack_fn, **kw):
    return pack_fn(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes, **kw)


def assert_constraints_equal(jc, tc):
    assert (jc is None) == (tc is None)
    if jc is None:
        return
    for name, a in vars(jc).items():
        b = getattr(tc, name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert b == a, name


@pytest.mark.parametrize("mix", sorted(CONSTRAINT_MIXES))
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_pack_constraints_matches_jax(seed, mix):
    kw = dict(n_nodes=40, n_pending=150, n_bound=40, seed=seed, **CONSTRAINT_MIXES[mix])
    js, ts = jax_synth(**kw), synth_cluster(**kw)
    jp, tp = jax_pack(js, pod_block=16, node_block=8), pack_snapshot(ts, pod_block=16, node_block=8)
    jc = _pack_cons(js, jp, jax_pack_constraints, max_aa_terms=256, max_spread=256)
    tc = _pack_cons(ts, tp, pack_constraints, max_aa_terms=256, max_spread=256)
    assert tc is not None
    assert_constraints_equal(jc, tc)


def test_pack_constraints_placed_state_matches_jax():
    js, ts = _placed_cluster(JAX_NS), _placed_cluster(PORT_NS)
    jc = _pack_cons(js, jax_pack(js), jax_pack_constraints)
    tc = _pack_cons(ts, pack_snapshot(ts), pack_constraints)
    assert_constraints_equal(jc, tc)
    # Non-vacuous: coarse and node-granular marks, counts, both namespaces.
    assert tc.aa_dom_m.any() and tc.aa_dom_c.any() and tc.aa_node_c.any() and tc.pa_dom_m.any()
    assert tc.ppa_dom_cnt.any() and tc.sps_counts.any() and (tc.pod_ppa_w < 0).any()
    assert tc.n_terms >= 3 and tc.n_pa_terms == 1 and tc.n_ppa_terms == 1


def test_pack_constraints_none_when_unconstrained():
    ts = synth_cluster(n_nodes=8, n_pending=20, seed=0)
    assert _pack_cons(ts, pack_snapshot(ts), pack_constraints) is None


def test_untensorizable_many_valued_shared_key_raises():
    """The cluster of tests/test_constraints_tensor.py: 20 two-node racks
    against an 8-domain budget refuse tensorization in both packages."""

    def build(m):
        nodes = [m.node(f"n{i}", labels={"rack": f"r{i // 2}"}) for i in range(40)]
        term = [m.obj.PodAntiAffinityTerm(match_labels={"app": "db"}, topology_key="rack")]
        return m.snap.build(nodes, [m.pod("db-0", labels={"app": "db"}, anti_affinity=term)])

    js, ts = build(JAX_NS), build(PORT_NS)
    with pytest.raises(JaxUntensorizable):
        _pack_cons(js, jax_pack(js), jax_pack_constraints, max_coarse_domains=8)
    with pytest.raises(UntensorizableConstraints, match="shared-value domains"):
        _pack_cons(ts, pack_snapshot(ts), pack_constraints, max_coarse_domains=8)
    assert _pack_cons(ts, pack_snapshot(ts), pack_constraints, max_coarse_domains=20).n_terms == 1


def test_pack_constraints_match_memo():
    """Cold, warm and absent memo give the same tensors; the memo
    re-signs when the term vocabulary changes."""
    kw = dict(n_nodes=40, n_pending=200, n_bound=80, seed=5, **CONSTRAINT_MIXES["all"])
    ts = synth_cluster(**kw)
    tp = pack_snapshot(ts)
    memo: dict = {}
    cold = _pack_cons(ts, tp, pack_constraints, match_memo=memo)
    assert len(memo) > 1
    warm = _pack_cons(ts, tp, pack_constraints, match_memo=memo)
    fresh = _pack_cons(ts, tp, pack_constraints)
    assert_constraints_equal(cold, warm)
    assert_constraints_equal(cold, fresh)
    js = jax_synth(**kw)
    assert_constraints_equal(_pack_cons(js, jax_pack(js), jax_pack_constraints), cold)
    sig = memo["sig"]
    ts2 = ClusterSnapshot.build(ts.nodes, [p for p in ts.pods if p.spec is None or not p.spec.anti_affinity])
    _pack_cons(ts2, tp, pack_constraints, match_memo=memo)
    assert memo["sig"] != sig


@pytest.mark.parametrize("seed", [0, 4])
def test_constraints_round_trip_through_convert(seed):
    """The JAX package's ConstraintSet, carried across as NumPy arrays and
    counts, rebuilds the port's exactly — sharing no buffer with it."""
    kw = dict(n_nodes=30, n_pending=90, n_bound=30, seed=seed, **CONSTRAINT_MIXES["all"])
    js = jax_synth(**kw)
    jc = _pack_cons(js, jax_pack(js), jax_pack_constraints)
    counts = {k: getattr(jc, k) for k in ("n_terms", "n_pa_terms", "n_ppa_terms", "n_spread", "n_spread_soft")}
    carried = constraints_from_arrays(jc.pod_arrays(), jc.meta_arrays(), jc.state_arrays(), **counts)
    assert_constraints_equal(jc, carried)
    assert not np.shares_memory(carried.pod_aa_carries, jc.pod_aa_carries)
    with pytest.raises(TypeError, match="expected counts"):
        constraints_from_arrays(jc.pod_arrays(), jc.meta_arrays(), jc.state_arrays(), n_terms=1)


def test_constraint_budgets_and_memo_pruning_match_jax():
    """The copied budgets keep the JAX package's values (its tests pin
    results at their boundaries), and the memo pruning keeps the same keys."""
    import tpu_scheduler.ops.constraints as JC
    import tpu_scheduler.ops.pack as JP
    import tpu_scheduler_torch.ops.constraints as TC
    import tpu_scheduler_torch.ops.pack as TP

    for name in ("RANK_INF", "MAX_AA_TERMS", "MAX_SPREAD", "MAX_COARSE_DOMAINS", "DENSE_CELLS", "DENSE_TENSOR_BYTES",
                 "SPREAD_CASCADE", "ACTIVE_CHUNK"):
        assert getattr(TC, name) == getattr(JC, name), name
    assert TP.STALL_ROUNDS == JP.STALL_ROUNDS
    ts = synth_cluster(n_nodes=20, n_pending=80, n_bound=20, seed=2, **CONSTRAINT_MIXES["all"])
    memo: dict = {}
    _pack_cons(ts, pack_snapshot(ts), pack_constraints, match_memo=memo)
    live = {id(p) for p in ts.pending_pods()[::2]}
    kept = TC.prune_match_memo(memo, live)
    assert kept.keys() == JC.prune_match_memo(memo, live).keys()
    assert "sig" in kept and 1 < len(kept) < len(memo)


def test_selector_predicates_match_jax():
    """labels_match_selector / selector_matches / term_matches /
    node_topology_domain of the port equal the JAX package's on every
    operator, empty selectors and missing labels."""
    import tpu_scheduler.core.predicates as JPr
    import tpu_scheduler_torch.core.predicates as TPr

    def exprs(o):
        return [
            [o.LabelSelectorRequirement(key="app", operator="In", values=["db", "web"])],
            [o.LabelSelectorRequirement(key="app", operator="NotIn", values=["db"])],
            [o.LabelSelectorRequirement(key="tier", operator="Exists")],
            [o.LabelSelectorRequirement(key="tier", operator="DoesNotExist")],
            [o.LabelSelectorRequirement(key="app", operator="Bogus", values=["db"])],
            None,
        ]

    labelsets = [None, {}, {"app": "db"}, {"app": "web", "tier": "1"}, {"tier": "2"}]
    selectors = [None, {}, {"app": "db"}, {"app": "web", "tier": "1"}]
    jx, tx = exprs(jax_objects), exprs(port_objects)
    for labels in labelsets:
        for sel in selectors:
            assert TPr.labels_match_selector(sel, labels) == JPr.labels_match_selector(sel, labels)
            for je, te in zip(jx, tx):
                want = JPr.selector_matches(sel, je, labels)
                assert TPr.selector_matches(sel, te, labels) == want
                jt = jax_objects.PodAntiAffinityTerm(match_labels=sel, match_expressions=je, topology_key="zone")
                tt = port_objects.PodAntiAffinityTerm(match_labels=sel, match_expressions=te, topology_key="zone")
                assert TPr.term_matches(tt, labels) == JPr.term_matches(jt, labels) == want
    for labels in ({"zone": "a"}, None):
        assert TPr.node_topology_domain(make_node("n1", labels=labels), "zone") == JPr.node_topology_domain(
            jax_node("n1", labels=labels), "zone"
        )
