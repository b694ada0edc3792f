"""Topology (gang-locality) cycles of the PyTorch/CUDA port against the JAX
package, on the same NumPy inputs: the copied model and packing
(``TopologyModel``, ``load_topology_file``, ``pack_topology``), the port's
per-(gang, domain) state, its update and the dense term built from it
against the JAX package's per-node state, ``gang_state_update`` and
``gang_topology_term`` (NumPy path) bit for bit,
``score_block`` with the term against the JAX ``score_block`` under jnp,
the choose wrappers' topology operand, ``CudaBackend(device="cpu")``
topology cycles — unconstrained and constrained — against ``NativeBackend``
and the JAX ``TpuBackend`` (its jnp path), and the port's ``ShardedBackend``
on a topology-carrying cluster against the JAX ``ShardedBackend`` (both
solve topology-blind)."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
from tpu_scheduler.backends.tpu import TpuBackend  # noqa: E402
from tpu_scheduler.models.profiles import PROFILES as JAX_PROFILES  # noqa: E402
from tpu_scheduler.ops import constraints as jax_cons  # noqa: E402
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack  # noqa: E402
from tpu_scheduler.ops.score import score_block as jax_score_block  # noqa: E402
from tpu_scheduler.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tpu_scheduler.parallel.sharded import ShardedBackend as JaxShardedBackend  # noqa: E402
from tpu_scheduler.testing import synth_cluster as jax_synth  # noqa: E402
from tpu_scheduler.topology import locality as jax_loc  # noqa: E402
from tpu_scheduler.topology import model as jax_model  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.convert import topology_from_arrays, topology_to_device  # noqa: E402
from tpu_scheduler_torch.models.profiles import PROFILES  # noqa: E402
from tpu_scheduler_torch.ops import choose as choose_mod  # noqa: E402
from tpu_scheduler_torch.ops.constraints import pack_constraints  # noqa: E402
from tpu_scheduler_torch.ops.pack import pack_snapshot  # noqa: E402
from tpu_scheduler_torch.ops.score import score_block  # noqa: E402
from tpu_scheduler_torch.parallel.mesh import make_mesh  # noqa: E402
from tpu_scheduler_torch.parallel.sharded import ShardedBackend  # noqa: E402
from tpu_scheduler_torch.testing import synth_cluster  # noqa: E402
from tpu_scheduler_torch.topology import locality, model  # noqa: E402

SLICE_KEY, RACK_KEY = model.DEFAULT_LEVEL_KEYS[0][1], model.DEFAULT_LEVEL_KEYS[1][1]

# Gang-heavy clusters (gangs of 2-4), labelled into slices of 4 and racks of
# 8 nodes; the constrained one with every inter-pod family on.
GANGS = dict(n_nodes=32, n_pending=300, n_bound=40, seed=3, gang_fraction=0.4, selector_fraction=0.2)
GANGS_CONSTRAINED = dict(
    GANGS, seed=6, anti_affinity_fraction=0.15, spread_fraction=0.15, schedule_anyway_fraction=0.15,
    pod_affinity_fraction=0.1, preferred_pod_affinity_fraction=0.15,
)


def _label(snap, slice_size=4, rack_size=8):
    for i, node in enumerate(snap.nodes):
        node.metadata.labels.update({SLICE_KEY: f"s{i // slice_size}", RACK_KEY: f"r{i // rack_size}"})
    return snap


def _attach(snap, packed, model_mod, loc_mod, cons_fn=None):
    compiled = model_mod.TopologyModel.detect(snap.nodes).compile(snap.nodes)
    topo = loc_mod.pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names,
                                 packed.padded_nodes)
    assert topo is not None
    fields = {"topology": topo}
    if cons_fn is not None:
        fields["constraints"] = cons_fn(snap, snap.pending_pods(), packed.padded_pods, packed.node_names,
                                        packed.padded_nodes)
    return dataclasses.replace(packed, **fields)


def _port_packed(kw, constrained=False, block=64):
    snap = _label(synth_cluster(**kw))
    return _attach(snap, pack_snapshot(snap, pod_block=block), model, locality,
                   pack_constraints if constrained else None)


def _jax_packed(kw, constrained=False, block=64):
    snap = _label(jax_synth(**kw))
    return _attach(snap, jax_pack(snap, pod_block=block), jax_model, jax_loc,
                   jax_cons.pack_constraints if constrained else None)


@functools.cache
def _native(name: str, profile: str):
    kw, constrained = {"plain": (GANGS, False), "constrained": (GANGS_CONSTRAINED, True)}[name]
    return NativeBackend().schedule(_jax_packed(kw, constrained), JAX_PROFILES[profile].with_(pod_block=64,
                                                                                               max_rounds=64))


def _assert_same(rn, rt):
    assert rt.bindings == rn.bindings
    assert rt.unschedulable == rn.unschedulable
    assert rt.rounds == rn.rounds
    np.testing.assert_array_equal(rt.assigned, rn.assigned)
    if "acc_round" in rn.stats:
        np.testing.assert_array_equal(rt.stats["acc_round"], rn.stats["acc_round"])


# --- model and packing --------------------------------------------------------


def test_detect_compile_and_distances_match_jax():
    snap_p, snap_j = _label(synth_cluster(**GANGS)), _label(jax_synth(**GANGS))
    cp = model.TopologyModel.detect(snap_p.nodes).compile(snap_p.nodes)
    cj = jax_model.TopologyModel.detect(snap_j.nodes).compile(snap_j.nodes)
    assert [(lv.name, lv.key, lv.distance) for lv in cp.model.levels] == [
        (lv.name, lv.key, lv.distance) for lv in cj.model.levels
    ]
    assert cp.node_names == cj.node_names and cp.dom_counts == cj.dom_counts
    assert cp.node_domain_names == cj.node_domain_names
    for a, b in zip(cp.dom_ids, cj.dom_ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cp.distance_matrix(), cj.distance_matrix())
    np.testing.assert_array_equal(cp.level_distances(), cj.level_distances())
    assert cp.domains_of(cp.node_names[5]) == cj.domains_of(cj.node_names[5])
    assert model.TopologyModel.detect(synth_cluster(n_nodes=4, n_pending=2).nodes) is None


def test_load_topology_file_matches_jax(tmp_path):
    spec = {
        "levels": [{"name": "slice", "distance": 1.0}, {"name": "rack", "key": RACK_KEY, "distance": 2.5}],
        "nodes": {"node-0": {"slice": "s0", "rack": "r0"}, "node-1": {"slice": "s1"}},
    }
    path = tmp_path / "topo.json"
    path.write_text(json.dumps(spec))
    nodes_p, nodes_j = synth_cluster(n_nodes=6, n_pending=1).nodes, jax_synth(n_nodes=6, n_pending=1).nodes
    nodes_p[2].metadata.labels[RACK_KEY] = nodes_j[2].metadata.labels[RACK_KEY] = "r9"
    cp = model.load_topology_file(str(path)).compile(nodes_p)
    cj = jax_model.load_topology_file(str(path)).compile(nodes_j)
    assert cp.node_domain_names == cj.node_domain_names
    np.testing.assert_array_equal(cp.distance_matrix(), cj.distance_matrix())
    with pytest.raises(ValueError):
        model.TopologyModel.from_spec({"levels": []})


@pytest.mark.parametrize("kw", [GANGS, dict(GANGS, seed=9, n_nodes=37, gang_fraction=0.7)], ids=["gangs", "dense"])
def test_pack_topology_matches_jax(kw):
    tp, tj = _port_packed(kw).topology, _jax_packed(kw).topology
    assert tp.n_gangs == tj.n_gangs and tp.gang_names == tj.gang_names
    np.testing.assert_array_equal(tp.pod_gang_id, tj.pod_gang_id)
    assert sorted(tp.meta) == sorted(tj.meta)
    for k in tp.meta:
        assert tp.meta[k].dtype == tj.meta[k].dtype, k
        np.testing.assert_array_equal(tp.meta[k], tj.meta[k], err_msg=k)
    # The port's per-domain zeros are the JAX package's per-node zeros summed
    # per domain.
    want = _domain_state(tj.state_arrays()["gang_nodes"], tj.meta)
    assert sorted(tp.state_arrays()) == ["placed", "total"]
    for k, v in want.items():
        assert tp.state_arrays()[k].dtype == np.float32
        np.testing.assert_array_equal(tp.state_arrays()[k], v)
    snap = synth_cluster(n_nodes=8, n_pending=10, seed=1)
    compiled = model.TopologyModel.detect(_label(snap).nodes).compile(snap.nodes)
    packed = pack_snapshot(snap)
    assert locality.pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names,
                                  packed.padded_nodes) is None


# --- the term and its state -----------------------------------------------------


def _domain_state(gang_nodes, meta):
    """The port's per-(gang, domain) state of a JAX per-node state
    ``gang_nodes`` [G+1, N+1] (its sentinel column dropped): ``placed``
    [G+1, Dt], each level's ``gang_nodes @ onehot.T`` side by side, and
    ``total`` [G+1].  Integer counts: exact in any order."""
    n = meta["dom_id_0"].shape[0]
    per_node = gang_nodes[:, :n].astype(np.float64)
    levels = meta["level_dist"].shape[0]
    placed = np.concatenate([per_node @ meta[f"dom_onehot_{lvl}"].T for lvl in range(levels)], axis=1)
    return {"placed": placed.astype(np.float32), "total": per_node.sum(axis=1).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_term(meta, state, avail, gid, req, active, w):
    """The port's dense term from the per-domain ``state`` (NumPy arrays in,
    torch out), through gang_cycle_operands and gang_round_operands."""
    tmeta = {k: _t(v) for k, v in meta.items()}
    op = locality.gang_round_operands(locality.gang_cycle_operands(tmeta), {k: _t(v.copy()) for k, v in state.items()},
                                      tmeta, _t(avail), _t(gid), _t(req), _t(active), w)
    return locality.gang_topology_term(op)


def _random_round(seed, g1, n, p, dists, domains):
    rng = np.random.default_rng(seed)
    meta = {"level_dist": np.asarray(dists, np.float32)}
    for lvl, d in enumerate(domains):
        dom_id = rng.integers(0, d + 1, n).astype(np.int32)
        onehot = np.zeros((d + 1, n), np.float32)
        onehot[dom_id, np.arange(n)] = 1.0
        meta[f"dom_id_{lvl}"], meta[f"dom_onehot_{lvl}"] = dom_id, onehot
        meta[f"gang_tb_{lvl}"] = rng.random((g1, d + 1)).astype(np.float32)
    gang_nodes = rng.integers(0, 3, (g1, n + 1)).astype(np.float32) * (rng.random((g1, n + 1)) < 0.2)
    # Capacities and requests in KiB-like units, as packed clusters hold them.
    avail = (rng.integers(-2, 64, (n, 3)) * 65536).astype(np.int32)
    req = (rng.integers(0, 8, (p, 3)) * 65536).astype(np.int32)
    gid = rng.integers(0, g1, p).astype(np.int32)
    active = rng.random(p) < 0.7
    return meta, gang_nodes, avail, req, gid, active, rng


def _same_bits(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want, np.float32).view(np.int32))


ROUNDS = [
    (0, [1.0, 1.0], [12, 4]), (1, [1.0, 2.5], [9, 3]), (2, [0.75], [20]), (3, [1.0, 1.0, 3.0], [16, 8, 2]),
    (4, [0.5, 1.0, 2.0, 4.0], [30, 10, 5, 2]), (5, [1.0, 1.0], [1, 1]), (6, [3.0], [61]),
]


@pytest.mark.parametrize("seed,dists,domains", ROUNDS)
def test_term_and_state_update_match_jax_numpy(seed, dists, domains):
    """A mid-cycle state (random placed counts): the dense term from the
    per-domain state equals the JAX term from the per-node state; the
    update, with non-claimants on the sentinel N, equals the JAX update
    summed per domain."""
    g1, n, p = 11, 61, 57
    meta, gang_nodes, avail, req, gid, active, rng = _random_round(seed, g1, n, p, dists, domains)
    w = np.float32(64.0)
    want = jax_loc.gang_topology_term(np, gang_nodes, meta, avail, gid, req, active, w)
    state = _domain_state(gang_nodes, meta)
    got = _port_term(meta, state, avail, gid, req, active, w)
    _same_bits(got, want)
    assert (got[0] == 0).all() and not torch.signbit(got[0]).any()

    accepted = rng.random(p) < 0.5
    choice = rng.integers(0, n, p).astype(np.int32)
    choice[~accepted & (rng.random(p) < 0.5)] = n  # the non-claimant sentinel
    want_state = _domain_state(jax_loc.gang_state_update(np, gang_nodes, accepted, choice, gid), meta)
    tstate = {k: _t(v.copy()) for k, v in state.items()}
    dom_col = locality.gang_cycle_operands({k: _t(v) for k, v in meta.items()})["dom_col"]
    out = locality.gang_state_update(tstate, dom_col, _t(accepted), _t(choice), _t(gid))
    assert out is tstate and out["placed"].data_ptr() == tstate["placed"].data_ptr()  # updated in place
    for k, v in want_state.items():
        _same_bits(out[k], v)


@pytest.mark.parametrize("weight", [0.0, -0.0, 1e-3, 0.3, 1.0, 64.0, 1e5, 1e9, -2.5])
@pytest.mark.parametrize("seed", [7, 8])
def test_term_across_weights_matches_jax(seed, weight):
    """Weight 0 (w·t is −0.0 where t < 0), negative weights and weights
    across magnitudes, with level distances across magnitudes too."""
    meta, gang_nodes, avail, req, gid, active, _rng = _random_round(seed, 9, 45, 40, [1e-3, 1e4], [7, 3])
    w = np.float32(weight)
    want = jax_loc.gang_topology_term(np, gang_nodes, meta, avail, gid, req, active, w)
    _same_bits(_port_term(meta, _domain_state(gang_nodes, meta), avail, gid, req, active, w), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_over_rounds_matches_jax(seed):
    """Three rounds of placements folded into both states from zero, the
    term after each: the per-domain counts track the per-node ones."""
    g1, n, p = 7, 40, 60
    meta, _gn, avail, req, gid, active, rng = _random_round(seed, g1, n, p, [1.0, 2.0], [10, 2])
    gang_nodes = np.zeros((g1, n + 1), np.float32)
    tmeta = {k: _t(v) for k, v in meta.items()}
    cyc = locality.gang_cycle_operands(tmeta)
    state = locality.gang_state_zeros(tmeta, g1 - 1, "cpu")
    w = np.float32(64.0)
    for _ in range(3):
        accepted = active & (rng.random(p) < 0.4)
        choice = np.where(accepted, rng.integers(0, n, p), n).astype(np.int32)
        gang_nodes = jax_loc.gang_state_update(np, gang_nodes, accepted, choice, gid)
        locality.gang_state_update(state, cyc["dom_col"], _t(accepted), _t(choice.astype(np.int64)), _t(gid))
        active = active & ~accepted
        want = jax_loc.gang_topology_term(np, gang_nodes, meta, avail, gid, req, active, w)
        op = locality.gang_round_operands(cyc, state, tmeta, _t(avail), _t(gid), _t(req), _t(active), w)
        _same_bits(locality.gang_topology_term(op), want)


def test_term_on_a_packed_cluster_matches_jax():
    """The term at cycle start and after a round's placements, on the
    packed gang cluster (the same NumPy arrays through both)."""
    packed = _port_packed(GANGS)
    topo = packed.topology
    g1, n = topo.n_gangs + 1, packed.padded_nodes
    rng = np.random.default_rng(4)
    gang_nodes = np.zeros((g1, n + 1), np.float32)
    gang_nodes[rng.integers(1, g1, 40), rng.integers(0, n, 40)] += 1.0
    w = np.float32(PROFILES["default"].weights()[6])
    want = jax_loc.gang_topology_term(np, gang_nodes, topo.meta, packed.node_avail, topo.pod_gang_id,
                                      packed.pod_req, packed.pod_valid, w)
    pods, meta, state = topology_to_device(topo, "cpu")
    for k, v in _domain_state(gang_nodes, topo.meta).items():
        state[k].copy_(_t(v))
    op = locality.gang_round_operands(locality.gang_cycle_operands(meta), state, meta, _t(packed.node_avail),
                                      pods["pod_gang_id"], _t(packed.pod_req), _t(packed.pod_valid), w)
    _same_bits(locality.gang_topology_term(op), want)


def test_cycle_operands_are_the_reference_ops():
    """dom_col is each level's domain id shifted to its block; herd is
    1 + 4·tb in float32, as the reference forms it."""
    topo = _port_packed(GANGS).topology
    _pods, meta, _state = topology_to_device(topo, "cpu")
    cyc = locality.gang_cycle_operands(meta)
    blocks = locality.domain_columns(meta)
    assert blocks[0][0] == 0 and blocks[1][0] == blocks[0][1] and cyc["dom_col"].dtype == torch.int32
    for lvl, (off, width) in enumerate(blocks):
        np.testing.assert_array_equal(cyc["dom_col"][lvl].numpy(), topo.meta[f"dom_id_{lvl}"] + off)
        want = np.float32(1.0) + np.float32(locality.HERD_SCALE) * topo.meta[f"gang_tb_{lvl}"]
        _same_bits(cyc["herd"][:, off : off + width].contiguous(), want)


def test_topology_to_device_builds_zero_state():
    topo = _port_packed(GANGS).topology
    pods, meta, state = topology_to_device(topo, "cpu")
    assert torch.equal(pods["pod_gang_id"], torch.from_numpy(topo.pod_gang_id))
    assert sorted(meta) == sorted(topo.meta)
    dt = sum(topo.meta[f"gang_tb_{lvl}"].shape[1] for lvl in range(topo.meta["level_dist"].shape[0]))
    assert sorted(state) == ["placed", "total"]
    assert state["placed"].shape == (topo.n_gangs + 1, dt) and state["total"].shape == (topo.n_gangs + 1,)
    assert all(v.dtype == torch.float32 and not v.any() for v in state.values())
    calls = []
    topology_to_device(topo, "cpu", put=lambda a: calls.append(a) or torch.from_numpy(a))
    assert len(calls) == 1 + len(topo.meta)  # pod and meta arrays; never the state


def test_score_block_with_term_matches_jax():
    rng = np.random.default_rng(8)
    b, n = 29, 41
    alloc = rng.integers(1000, 64000, (n, 2)).astype(np.int32)
    avail = (alloc - rng.integers(0, 900, (n, 2))).astype(np.int32)
    req = rng.integers(0, 800, (b, 2)).astype(np.int32)
    gid = rng.integers(0, 6, b).astype(np.int32)
    term = (rng.normal(size=(6, n)) * 1e3).astype(np.float32)
    term[0] = 0.0
    w = JAX_PROFILES["throughput"].weights()
    ranks, nodes = np.arange(b, dtype=np.uint32), np.arange(n, dtype=np.uint32)
    want = np.asarray(jax_score_block(jnp, req, alloc, avail, w, ranks, nodes, salt=3, pod_gang_id=gid,
                                      topo_gang_node=term))
    t = torch.from_numpy
    got = score_block(t(req), t(alloc), t(avail), t(w), t(ranks.astype(np.int32)), t(nodes.astype(np.int32)),
                      salt=3, pod_gang_id=t(gid), topo_gang_node=t(term))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


# --- the choose wrappers' topology operand ---------------------------------------


def _block_args(packed, lo, hi):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pod = [t(getattr(packed, k)[lo:hi]) for k in ("pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff",
                                                    "pod_has_aff", "pod_pref_w", "pod_ntol_soft", "pod_valid")]
    node = [t(getattr(packed, k)) for k in ("node_avail", "node_alloc", "node_valid", "node_labels", "node_taints",
                                             "node_aff", "node_pref", "node_taints_soft")]
    return pod + [torch.arange(lo, hi, dtype=torch.int32)] + node


def _round_term(packed, weight, lo=0, hi=64):
    """The cycle-start GangTerm of ``packed`` with the gang ids of rows
    [lo, hi)."""
    pods, meta, state = topology_to_device(packed.topology, "cpu")
    op = locality.gang_round_operands(locality.gang_cycle_operands(meta), state, meta, _t(packed.node_avail),
                                      pods["pod_gang_id"], _t(packed.pod_req), _t(packed.pod_valid), weight)
    return op._replace(gang_id=pods["pod_gang_id"][lo:hi])


@pytest.mark.parametrize("constrained", [False, True])
def test_choose_with_topo_on_cpu_is_plain_and_moves_gangs(constrained):
    packed = _port_packed(GANGS_CONSTRAINED if constrained else GANGS, constrained)
    args = _block_args(packed, 0, 64)
    w = PROFILES["throughput"].weights()
    topo = _round_term(packed, w[6])
    launches = (choose_mod.LAUNCHES_TOPO, choose_mod.LAUNCHES_CONSTRAINED_TOPO)
    if constrained:
        from tpu_scheduler_torch.convert import constraints_to_device
        from tpu_scheduler_torch.ops.constraints import augment_round_state, round_blocked_masks

        cons = packed.constraints
        cpods, cmeta, cstate = constraints_to_device(cons, "cpu")
        masks = round_blocked_masks(augment_round_state(cstate, cmeta), cmeta, cons.n_spread_soft > 0,
                                    cons.n_ppa_terms > 0, cons.n_pa_terms > 0)
        cons_pod = {k: cpods[k][:64] for k in choose_mod.CONSTRAINT_POD_KEYS}
        got = choose_mod.choose_block_constrained(*args, cons_pod, masks, w, 2, topo=topo)
        want = choose_mod.choose_block_constrained_plain(*args, cons_pod, masks, w, 2, topo=topo)
        blind = choose_mod.choose_block_constrained_plain(*args, cons_pod, masks, w, 2)
    else:
        got = choose_mod.choose_block(*args, w, 2, topo=topo)
        want = choose_mod.choose_block_plain(*args, w, 2, topo=topo)
        blind = choose_mod.choose_block_plain(*args, w, 2)
    assert (choose_mod.LAUNCHES_TOPO, choose_mod.LAUNCHES_CONSTRAINED_TOPO) == launches  # CPU: no launch
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[0] != blind[0]).any())  # the term moved some pods


def _tie_case(b=45, n=700, gangs=5):
    """Every node identical, no jitter: every base score ties.  One level
    of 4-node slices; gang g has one member placed in slice g and one in
    slice 160 + g (nodes 640 + 4·g .. +3, another warp), so the term ties
    the 8 nodes of those two slices at its maximum.  Node 4·g is invalid:
    each gang's pods must pick 4·g + 1, the gangless pods node 0."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    req = torch.tensor([[100, 131072]] * b, dtype=torch.int32)
    alloc = torch.tensor([[8000, 16777216]] * n, dtype=torch.int32)
    avail = torch.tensor([[2000, 4194304]] * n, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    valid[[4 * g for g in range(1, gangs + 1)]] = False
    args = [
        req, z(b, 8), z(b), z(b, 8), z(b, 8), z(b), z(b, 8), z(b, 8),
        torch.ones(b, dtype=torch.bool), torch.arange(b, dtype=torch.int32),
        avail, alloc, valid, z(n, 8), z(n, 8), z(n, 8), z(n, 8), z(n, 8),
    ]
    d = 175 + 1  # domains 0..174 and the sentinel
    dom = torch.arange(n, dtype=torch.int32) // 4
    placed = z(gangs + 1, d)
    for g in range(1, gangs + 1):
        placed[g, g] = placed[g, 160 + g] = 1.0
    gid = torch.arange(b, dtype=torch.int32) % (gangs + 1)
    op = locality.GangTerm(gid, dom[None, :].contiguous(), torch.tensor([1.0]), placed, placed.sum(dim=1),
                           torch.full((gangs + 1, 2), 100.0), torch.full((d, 2), 1e6), torch.ones((gangs + 1, d)),
                           64.0)
    return args, op


def test_term_ties_resolve_to_the_lowest_index_as_jax():
    args, op = _tie_case()
    no_jitter = PROFILES["throughput"].weights().copy()
    no_jitter[2] = 0.0
    choice, has, _best = choose_mod.choose_block(*args, no_jitter, 0, topo=op)
    assert bool(has.all())
    want = torch.where(op.gang_id > 0, 4 * op.gang_id + 1, 0)
    assert torch.equal(choice, want.to(torch.int32))
    # The same term from the JAX package's per-node state.
    n = args[10].shape[0]
    gang_nodes = np.zeros((op.placed.shape[0], n + 1), np.float32)
    for g in range(1, op.placed.shape[0]):
        gang_nodes[g, [4 * g + 1, 640 + 4 * g + 1]] = 1.0
    dom = op.dom_col[0].numpy()
    onehot = np.zeros((op.placed.shape[1], n), np.float32)
    onehot[dom, np.arange(n)] = 1.0
    meta = {"level_dist": np.float32([1.0]), "dom_id_0": dom, "dom_onehot_0": onehot,
            "gang_tb_0": np.zeros(op.herd.shape, np.float32)}
    free = np.full((n, 2), 250_000, np.int32)  # every slice holds 1e6 of each
    req = np.full((op.gang_id.shape[0], 2), 0, np.int32)
    pod_gid = np.arange(op.placed.shape[0], dtype=np.int32)
    req[: pod_gid.shape[0]] = 50
    want_t = jax_loc.gang_topology_term(np, gang_nodes, meta, free, pod_gid, req[: pod_gid.shape[0]],
                                        np.ones(pod_gid.shape[0], bool), np.float32(64.0))
    _same_bits(locality.gang_topology_term(op), want_t)


@pytest.mark.parametrize("bad", [-1, 99])
def test_out_of_range_gang_id_raises(bad):
    packed = _port_packed(GANGS)
    args = _block_args(packed, 0, 16)
    topo = _round_term(packed, 64.0, 0, 16)
    gid = torch.zeros(16, dtype=torch.int32)
    gid[5] = bad
    with pytest.raises(ValueError, match="pod_gang_id"):
        choose_mod.choose_block(*args, PROFILES["default"].weights(), 0, topo=topo._replace(gang_id=gid))
    g1 = topo.placed.shape[0]
    with pytest.raises(ValueError, match="pod_gang_id"):
        choose_mod.check_gang_ids(gid, g1)
    choose_mod.check_gang_ids(torch.clamp(gid, 0, g1 - 1), g1)


@pytest.mark.parametrize("bad", [-1, 10_000])
def test_out_of_range_domain_column_raises(bad):
    packed = _port_packed(GANGS)
    args = _block_args(packed, 0, 16)
    topo = _round_term(packed, 64.0, 0, 16)
    dom_col = topo.dom_col.clone()
    dom_col[1, 3] = bad
    with pytest.raises(ValueError, match="dom_col"):
        choose_mod.choose_block(*args, PROFILES["default"].weights(), 0, topo=topo._replace(dom_col=dom_col))
    choose_mod.check_domain_columns(topo.dom_col, topo.placed.shape[1])


def test_topo_operand_shapes_and_level_cap_are_checked():
    """The launch-side checks (device-agnostic, so they run here): more
    levels than the kernels take, and a state of the wrong shape."""
    packed = _port_packed(GANGS)
    topo = _round_term(packed, 64.0, 0, 16)
    n, device = packed.padded_nodes, torch.device("cpu")
    assert choose_mod._check_topo(topo, 16, n, device) is topo
    lv = choose_mod.MAX_LEVELS + 1
    deep = topo._replace(dom_col=topo.dom_col[:1].repeat(lv, 1), level_dist=torch.ones(lv))
    with pytest.raises(ValueError, match="levels"):
        choose_mod._check_topo(deep, 16, n, device)
    with pytest.raises(ValueError, match="rem"):
        choose_mod._check_topo(topo._replace(rem=topo.rem[:, :1].contiguous()), 16, n, device)
    with pytest.raises(ValueError, match="pod_gang_id"):
        choose_mod._check_topo(topo, 17, n, device)


# --- cycles -----------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["default", "throughput"])
@pytest.mark.parametrize("name", ["plain", "constrained"])
def test_cpu_topology_cycle_matches_native(name, profile):
    kw, constrained = {"plain": (GANGS, False), "constrained": (GANGS_CONSTRAINED, True)}[name]
    packed = _port_packed(kw, constrained)
    rt = CudaBackend(device="cpu").schedule(packed, PROFILES[profile].with_(pod_block=64, max_rounds=64))
    rn = _native(name, profile)
    _assert_same(rn, rt)
    blind = CudaBackend(device="cpu").schedule(dataclasses.replace(packed, topology=None),
                                               PROFILES[profile].with_(pod_block=64, max_rounds=64))
    assert blind.bindings != rt.bindings  # the term is live


@pytest.mark.parametrize("name", ["plain", "constrained"])
def test_cpu_topology_cycle_matches_jax_tpu_backend(name):
    """The JAX TpuBackend's jnp path (its topology cycles never take the
    Pallas kernel) against the port on the same cluster."""
    kw, constrained = {"plain": (GANGS, False), "constrained": (GANGS_CONSTRAINED, True)}[name]
    profile = "throughput"
    rj = TpuBackend(jax.devices("cpu")[0], use_pallas=False).schedule(
        _jax_packed(kw, constrained), JAX_PROFILES[profile].with_(pod_block=64, max_rounds=64))
    rt = CudaBackend(device="cpu").schedule(_port_packed(kw, constrained),
                                            PROFILES[profile].with_(pod_block=64, max_rounds=64))
    _assert_same(rj, rt)


def test_topology_from_arrays_carries_the_jax_set():
    jp = _jax_packed(GANGS)
    tj = jp.topology
    port = _port_packed(GANGS)
    carried = topology_from_arrays(tj.pod_arrays(), tj.meta_arrays(), tj.n_gangs, tj.gang_names, tj.compiled)
    assert carried.pod_gang_id is not tj.pod_gang_id
    assert all(carried.meta[k] is not v for k, v in tj.meta.items())
    profile = PROFILES["default"].with_(pod_block=64, max_rounds=64)
    rt = CudaBackend(device="cpu").schedule(dataclasses.replace(port, topology=carried), profile)
    _assert_same(_native("plain", "default"), rt)
    with pytest.raises(TypeError):
        topology_from_arrays({"pod_gang_id": tj.pod_gang_id, "x": tj.pod_gang_id}, tj.meta, 1, ("g",), None)


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_topology_cluster_is_solved_blind(tp):
    """The JAX ShardedBackend never reads packed.topology; neither does the
    port's: equal to it, and to its own topology=None solve."""
    jr = JaxShardedBackend(jax_make_mesh(tp=tp), use_pallas=False).schedule(
        _jax_packed(GANGS, block=32), JAX_PROFILES["default"].with_(pod_block=32))
    packed = _port_packed(GANGS, block=32)
    backend = ShardedBackend(make_mesh([torch.device("cpu")] * 8, tp=tp))
    assert backend.supports_topology is False
    r = backend.schedule(packed, PROFILES["default"].with_(pod_block=32))
    np.testing.assert_array_equal(r.assigned, jr.assigned)
    assert r.rounds == jr.rounds
    blind = backend.schedule(dataclasses.replace(packed, topology=None), PROFILES["default"].with_(pod_block=32))
    np.testing.assert_array_equal(r.assigned, blind.assigned)


def test_demand_adds_in_pod_order_on_several_threads():
    """The per-gang demand rounds as np.add.at where sums are inexact, also
    when torch runs on several threads (index_put_ would add with atomics
    there)."""
    rng = np.random.default_rng(12)
    idx = np.sort(rng.integers(0, 300, 50_000))
    rng.shuffle(idx[:20_000])
    vals = (rng.random((50_000, 2)) * 1e7).astype(np.float32)
    want = np.zeros((300, 2), np.float32)
    np.add.at(want, idx, vals)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = locality._add_rows(torch.zeros((300, 2)), torch.from_numpy(idx), torch.from_numpy(vals))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got.numpy(), want)
