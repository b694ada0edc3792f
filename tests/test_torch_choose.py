"""The port's choose step vs the JAX package: ``choose_block_plain`` (and
``choose_block``, which dispatches to it for CPU tensors) must equal both
the Pallas kernel in interpret mode and the jnp expression tree
``_choose_block`` bit for bit — same feasibility flags, same choices, same
best scores — on the cases of tests/test_pallas_choose.py plus salt ≠ 0,
extended resources and vocabulary widths beyond the Pallas band limit.
The port's masks and score are also held against the JAX package's
xp-generic functions evaluated with NumPy."""

import dataclasses

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_scheduler.core.snapshot import ClusterSnapshot  # noqa: E402
from tpu_scheduler.models.profiles import DEFAULT_PROFILE, PROFILES, SchedulingProfile  # noqa: E402
from tpu_scheduler.ops import masks as jax_masks  # noqa: E402
from tpu_scheduler.ops import score as jax_score  # noqa: E402
from tpu_scheduler.ops.assign import _choose_block  # noqa: E402
from tpu_scheduler.ops.pack import pack_snapshot  # noqa: E402
from tpu_scheduler.ops.pallas_choose import build_node_info, choose_block_pallas  # noqa: E402
from tpu_scheduler.testing import make_node, make_pod, synth_cluster  # noqa: E402
from tpu_scheduler_torch.ops import masks, score  # noqa: E402
from tpu_scheduler_torch.ops.choose import KernelError, choose_block, choose_block_plain  # noqa: E402

POD_KEYS = ("pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff", "pod_has_aff", "pod_pref_w", "pod_ntol_soft")
NODE_KEYS = (
    "node_avail", "node_alloc", "node_valid", "node_labels", "node_taints", "node_aff", "node_pref", "node_taints_soft",
)


def _case(n_nodes, n_pending, seed, n_bound=None, **soft):
    snap = synth_cluster(
        n_nodes=n_nodes, n_pending=n_pending, n_bound=n_nodes if n_bound is None else n_bound, seed=seed, **soft
    )
    return dict(pack_snapshot(snap, pod_block=8, node_block=8).device_arrays())


def _port_args(a):
    """choose_block's positional tensors (CPU) from NumPy device arrays."""
    t = lambda key: torch.from_numpy(np.ascontiguousarray(a[key]))  # noqa: E731
    p = a["pod_req"].shape[0]
    return (
        [t(k) for k in POD_KEYS]
        + [t("pod_valid"), torch.arange(p, dtype=torch.int32)]
        + [t(k) for k in NODE_KEYS]
    )


def _jnp_path(a, weights, salt):
    p = a["pod_req"].shape[0]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    nodes = {k: v for k, v in j.items() if k.startswith("node_")}
    blk = {k: j[k] for k in POD_KEYS}
    blk.update(active=j["pod_valid"], ranks=jnp.arange(p, dtype=jnp.uint32))
    c, h = _choose_block(j["node_avail"], nodes, jnp.asarray(weights), blk, salt=salt)
    return np.asarray(c), np.asarray(h)


def _pallas_path(a, weights, salt, pod_tile=8, node_tile=128):
    p = a["pod_req"].shape[0]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    c, h, b = choose_block_pallas(
        *(j[k] for k in POD_KEYS), j["pod_valid"], jnp.arange(p, dtype=jnp.uint32),
        build_node_info(j["node_avail"], j["node_alloc"], j["node_valid"]),
        j["node_labels"].T, j["node_taints"].T, j["node_aff"].T, j["node_pref"].T, j["node_taints_soft"].T,
        jnp.asarray(weights), salt=jnp.int32(salt), pod_tile=pod_tile, node_tile=node_tile, interpret=True,
        return_best=True,
    )
    return np.asarray(c), np.asarray(h), np.asarray(b)


def _assert_all_paths_equal(a, weights=None, salt=0, pallas=True):
    """Port (plain and dispatcher) == jnp tree, and == Pallas interpret
    mode when its band limits admit the cluster.  Returns the port's
    (choice, has)."""
    weights = DEFAULT_PROFILE.weights() if weights is None else weights
    args = _port_args(a)
    pc, ph, pb = (x.numpy() for x in choose_block_plain(*args, weights, salt))
    dc, dh, db = (x.numpy() for x in choose_block(*args, weights, salt))
    np.testing.assert_array_equal(pc, dc)
    np.testing.assert_array_equal(ph, dh)
    np.testing.assert_array_equal(pb.view(np.int32), db.view(np.int32))
    assert pc.dtype == np.int32 and ph.dtype == bool and pb.dtype == np.float32
    jc, jh = _jnp_path(a, weights, salt)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pc, jc)  # both give 0 where nothing is feasible
    assert np.isneginf(pb[~ph]).all()
    if pallas:
        kc, kh, kb = _pallas_path(a, weights, salt)
        np.testing.assert_array_equal(ph, kh)
        np.testing.assert_array_equal(pc[ph], kc[kh])
        np.testing.assert_array_equal(pb[ph].view(np.int32), kb[kh].view(np.int32))
    return pc, ph


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_nodes,n_pending", [(24, 40), (64, 96), (17, 33)])
def test_choose_matches_pallas_and_jnp(seed, n_nodes, n_pending):
    _assert_all_paths_equal(_case(n_nodes, n_pending, seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_choose_soft_terms(seed):
    _assert_all_paths_equal(_case(24, 40, seed, soft_taint_fraction=0.4, preferred_affinity_fraction=0.4))


@pytest.mark.parametrize("seed", [0, 3])
def test_choose_dense_hard_predicates(seed):
    a = _case(
        32, 48, seed, selector_fraction=0.8, tainted_fraction=0.6, node_affinity_fraction=0.6,
        soft_taint_fraction=0.5, preferred_affinity_fraction=0.5,
    )
    _assert_all_paths_equal(a)


def test_choose_tile_remainders():
    _assert_all_paths_equal(_case(19, 13, seed=7))


def test_choose_all_infeasible():
    a = _case(8, 16, seed=3)
    a["node_avail"] = np.zeros_like(a["node_avail"])
    choice, has = _assert_all_paths_equal(a)
    assert not has.any() and (choice == 0).all()


def test_choose_inactive_pods_masked():
    a = _case(16, 24, seed=5)
    a["pod_valid"] = np.zeros_like(a["pod_valid"])
    _, has = _assert_all_paths_equal(a)
    assert not has.any()


def test_choose_exact_tie_lowest_index():
    """Identical nodes and zero jitter tie every (pod, node) score exactly:
    torch.argmax, like jnp.argmax, must return the first index."""
    nodes = [make_node(f"n{i:03d}", cpu="8", memory="16Gi") for i in range(64)]
    pods = [make_pod(f"p{i}", cpu="100m", memory="128Mi") for i in range(16)]
    a = dict(pack_snapshot(ClusterSnapshot.build(nodes, pods), pod_block=8, node_block=8).device_arrays())
    choice, has = _assert_all_paths_equal(a, SchedulingProfile(spread_jitter=0.0).weights())
    assert has.all() and (choice == 0).all()  # 16 pods: no padding rows


def test_choose_two_node_tie_later_pair():
    """A tie between two nodes past index 0 resolves to the lower one."""
    nodes = [make_node(f"n{i:02d}", cpu="8", memory="16Gi") for i in range(40)]
    pods = [make_pod(f"b{i}", cpu="6", memory="1Gi", node_name=f"n{i:02d}", phase="Running") for i in range(40)
            if i not in (13, 29)]
    pods += [make_pod(f"p{i}", cpu="100m", memory="128Mi") for i in range(9)]
    a = dict(pack_snapshot(ClusterSnapshot.build(nodes, pods), pod_block=8, node_block=8).device_arrays())
    choice, has = _assert_all_paths_equal(a, SchedulingProfile(spread_jitter=0.0).weights())
    assert has[:9].all() and not has[9:].any()  # 9 pods, padded to 16 rows
    assert (choice[:9] == 13).all()


@pytest.mark.parametrize("salt", [1, 7, 63])
def test_choose_salted_rounds(salt):
    a = _case(24, 40, seed=2, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3)
    _assert_all_paths_equal(a, PROFILES["throughput"].weights(), salt=salt)


def test_choose_extended_resources():
    _assert_all_paths_equal(_case(30, 48, seed=4, extended_fraction=0.4))


def test_choose_wide_vocab_beyond_pallas_band():
    """Vocabulary widths above the Pallas band limit (255): the port serves
    them directly and must still equal the jnp tree."""
    a = _case(16, 24, seed=0, selector_fraction=0.6)
    wide = 264
    rng = np.random.default_rng(0)
    for pod_key, node_key in (("pod_sel", "node_labels"), ("pod_ntol", "node_taints")):
        extra = wide - a[pod_key].shape[1]
        a[pod_key] = np.pad(a[pod_key], ((0, 0), (0, extra)))
        a[node_key] = np.pad(a[node_key], ((0, 0), (0, extra)))
    a["node_labels"][:, -1] = (rng.random(a["node_labels"].shape[0]) < 0.5).astype(np.float32)
    a["pod_sel"][::3, -1] = 1.0
    a["pod_sel_count"] = a["pod_sel"].sum(1).astype(np.float32)
    _assert_all_paths_equal(a, pallas=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_match_numpy_reference(seed):
    a = _case(
        20, 32, seed, tainted_fraction=0.4, node_affinity_fraction=0.4, cordoned_fraction=0.2,
        extended_fraction=0.3,
    )
    names = ("pod_req", "pod_sel", "pod_sel_count", "node_avail", "node_labels", "pod_ntol", "node_taints",
             "pod_aff", "pod_has_aff", "node_aff")
    ref = jax_masks.feasibility_breakdown(np, *(a[k] for k in names))
    got = masks.feasibility_breakdown(*(torch.from_numpy(a[k]) for k in names))
    assert sorted(ref) == sorted(got)
    for reason, m in ref.items():
        np.testing.assert_array_equal(got[reason].numpy(), m, err_msg=reason)
    block_names = ("pod_req", "pod_sel", "pod_sel_count", "pod_valid", "node_avail", "node_labels", "node_valid",
                   "pod_ntol", "node_taints", "pod_aff", "pod_has_aff", "node_aff")
    ref_block = jax_masks.feasibility_block(np, *(a[k] for k in block_names))
    got_block = masks.feasibility_block(*(torch.from_numpy(a[k]) for k in block_names))
    np.testing.assert_array_equal(got_block.numpy(), ref_block)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("salt", [None, 0, 5])
def test_score_matches_numpy_reference(profile, salt):
    a = _case(24, 40, seed=6, soft_taint_fraction=0.4, preferred_affinity_fraction=0.4)
    w = PROFILES[profile].weights()
    p, n = a["pod_req"].shape[0], a["node_avail"].shape[0]
    ref = jax_score.score_block(
        np, a["pod_req"], a["node_alloc"], a["node_avail"], w,
        np.arange(p, dtype=np.uint32), np.arange(n, dtype=np.uint32),
        pod_pref_w=a["pod_pref_w"], node_pref=a["node_pref"],
        pod_ntol_soft=a["pod_ntol_soft"], node_taints_soft=a["node_taints_soft"], salt=salt,
    )
    t = lambda key: torch.from_numpy(a[key])  # noqa: E731
    got = score.score_block(
        t("pod_req"), t("node_alloc"), t("node_avail"), torch.from_numpy(w),
        torch.arange(p, dtype=torch.int32), torch.arange(n),
        pod_pref_w=t("pod_pref_w"), node_pref=t("node_pref"),
        pod_ntol_soft=t("pod_ntol_soft"), node_taints_soft=t("node_taints_soft"), salt=salt,
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_jitter_hash_wraps_like_uint32():
    """Large ranks and node indices overflow uint32 in the reference hash;
    the int64 emulation must wrap identically."""
    ranks = np.array([0, 1, 65535, 2**31 - 1], dtype=np.uint32)
    nodes = np.array([0, 3, 2**20 + 7, 2**31 - 2], dtype=np.uint32)
    req = np.zeros((4, 2), np.int32)
    alloc = np.full((4, 2), 1000, np.int32)
    w = PROFILES["throughput"].weights()
    ref = jax_score.score_block(np, req, alloc, alloc, w, ranks, nodes, salt=9)
    got = score.score_block(
        torch.from_numpy(req), torch.from_numpy(alloc), torch.from_numpy(alloc), torch.from_numpy(w),
        torch.from_numpy(ranks.astype(np.int32)), torch.from_numpy(nodes.astype(np.int64)), salt=9,
    )
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_choose_block_rejects_other_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises — never a silent fallback."""
    args = [x.to("meta") for x in _port_args(_case(8, 8, seed=0))]
    with pytest.raises(ValueError, match="unsupported device"):
        choose_block(*args, DEFAULT_PROFILE.weights())


def test_kernel_build_without_nvcc_raises(monkeypatch):
    from tpu_scheduler_torch.ops import choose as choose_mod

    monkeypatch.setattr(choose_mod.shutil, "which", lambda _name: None)
    monkeypatch.setattr(choose_mod.os.path, "exists", lambda _path: False)
    with pytest.raises(KernelError, match="nvcc not found"):
        choose_mod._nvcc()


# --- the constrained choose (kernel #2's plain version and operands) --------

from tpu_scheduler.ops import constraints as jax_cons  # noqa: E402
from tpu_scheduler.ops.pallas_choose import (  # noqa: E402
    constrained_kernel_node_operands,
    constrained_kernel_pod_operands,
)
from tpu_scheduler_torch.ops import choose as choose_mod  # noqa: E402
from tpu_scheduler_torch.ops import constraints as port_cons  # noqa: E402
from tpu_scheduler_torch.ops.choose import (  # noqa: E402
    CONSTRAINT_POD_KEYS,
    choose_block_constrained,
    choose_block_constrained_plain,
    constrained_node_operands,
    constrained_pod_operands,
)

CONS_ALL = dict(
    anti_affinity_fraction=0.25, spread_fraction=0.25, schedule_anyway_fraction=0.2, pod_affinity_fraction=0.2,
    preferred_pod_affinity_fraction=0.25,
)
CONS_HARD = dict(anti_affinity_fraction=0.3, spread_fraction=0.3)


def _cons_case(n_nodes, n_pending, seed, fractions, kill_pa=False, **extra):
    """(device arrays, cons pod arrays, round state, meta, flags): a packed
    constrained cluster whose round state is randomised from the seed;
    ``kill_pa`` makes every positive-affinity term globally inactive."""
    snap = synth_cluster(n_nodes=n_nodes, n_pending=n_pending, n_bound=n_nodes, seed=seed, **fractions, **extra)
    packed = pack_snapshot(snap, pod_block=1, node_block=1)
    cons = jax_cons.pack_constraints(
        snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes
    )
    rng = np.random.default_rng(seed)
    meta = cons.meta_arrays()
    state = {}
    for k, v in cons.state_arrays().items():
        if k.endswith(("_cnt", "counts")):
            state[k] = rng.integers(0, 4, v.shape).astype(np.float32)
        else:
            state[k] = (rng.random(v.shape) < (0.0 if kill_pa and k.startswith("pa_") else 0.1)).astype(np.float32)
    state["sp_counts"] *= meta["sp_uses_dom"]
    flags = dict(soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0, hard_pa=cons.n_pa_terms > 0)
    return dict(packed.device_arrays()), cons.pod_arrays(), jax_cons.augment_round_state(np, state, meta), meta, flags


def _assert_constrained_paths_equal(case, weights, salt):
    a, cpods, state, meta, flags = case
    masks = jax_cons.round_blocked_masks(np, state, meta, **flags)
    masks_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in masks.items()}
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(cpods[k])) for k in CONSTRAINT_POD_KEYS}
    args = _port_args(a)
    pc, ph, pb = (x.numpy() for x in choose_block_constrained_plain(*args, cons_pod, masks_t, weights, salt))
    before = choose_mod.LAUNCHES_CONSTRAINED
    dc, dh, db = (x.numpy() for x in choose_block_constrained(*args, cons_pod, masks_t, weights, salt))
    assert choose_mod.LAUNCHES_CONSTRAINED == before  # the CPU branch launches nothing
    np.testing.assert_array_equal(pc, dc)
    np.testing.assert_array_equal(ph, dh)
    np.testing.assert_array_equal(pb.view(np.int32), db.view(np.int32))

    p, n = a["pod_req"].shape[0], a["node_avail"].shape[0]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    blk = {k: j[k] for k in POD_KEYS}
    blk.update({k: jnp.asarray(v) for k, v in cpods.items()})
    blk.update(active=j["pod_valid"], ranks=jnp.arange(p, dtype=jnp.uint32))
    masks_j = {k: jnp.asarray(v) for k, v in masks.items()}
    nodes = {k: v for k, v in j.items() if k.startswith("node_")}
    jc, jh = _choose_block(j["node_avail"], nodes, jnp.asarray(weights), blk, round_masks=masks_j, salt=salt)
    np.testing.assert_array_equal(ph, np.asarray(jh))
    np.testing.assert_array_equal(pc, np.asarray(jc))

    cons_node, pa_inactive = constrained_kernel_node_operands(blk, masks_j, n)
    kc, kh, kb = choose_block_pallas(
        *(j[k] for k in POD_KEYS), j["pod_valid"], jnp.arange(p, dtype=jnp.uint32),
        build_node_info(j["node_avail"], j["node_alloc"], j["node_valid"]),
        j["node_labels"].T, j["node_taints"].T, j["node_aff"].T, j["node_pref"].T, j["node_taints_soft"].T,
        jnp.asarray(weights), salt=jnp.int32(salt), cons_pod=constrained_kernel_pod_operands(blk, pa_inactive),
        cons_node=cons_node, pod_tile=8, node_tile=128, interpret=True, return_best=True,
    )
    kc, kh, kb = np.asarray(kc), np.asarray(kh), np.asarray(kb)
    np.testing.assert_array_equal(ph, kh)
    np.testing.assert_array_equal(pc[ph], kc[kh])
    np.testing.assert_array_equal(pb[ph].view(np.int32), kb[kh].view(np.int32))
    # Non-vacuous: some pods find a node, and the constraints change the outcome.
    free_c, free_h, _ = (x.numpy() for x in choose_block_plain(*args, weights, salt))
    assert ph.any()
    assert (free_h != ph).any() or (free_c != pc).any()
    return ph


@pytest.mark.parametrize("salt", [0, 5])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_constrained_choose_all_families(seed, salt):
    case = _cons_case(24, 40, seed, CONS_ALL, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3)
    assert all(case[4].values())
    _assert_constrained_paths_equal(case, PROFILES["throughput"].weights(), salt)


def test_constrained_choose_tile_remainders_extended():
    case = _cons_case(19, 13, 7, CONS_ALL, extended_fraction=0.4)
    _assert_constrained_paths_equal(case, DEFAULT_PROFILE.weights(), 3)


def test_constrained_choose_hard_only():
    """Soft widths zero: no soft-spread or preferred term, no hard
    positive affinity."""
    case = _cons_case(24, 40, 2, CONS_HARD)
    assert not any(case[4].values())
    _assert_constrained_paths_equal(case, PROFILES["throughput"].weights(), 1)


def test_constrained_choose_bootstrap_gate():
    """Every positive-affinity term is globally inactive: self-matching
    declarers are waived, the others are blocked everywhere."""
    case = _cons_case(24, 48, 3, CONS_ALL, kill_pa=True)
    _, cpods, state, _, flags = case
    assert flags["hard_pa"] and (state["pa_inactive"] == 1.0).all()
    waived = (cpods["pod_pa_declares"] * cpods["pod_pa_matched"]).sum(1) > 0
    assert waived.any()
    has = _assert_constrained_paths_equal(case, DEFAULT_PROFILE.weights(), 0)
    assert has[waived].any()


@pytest.mark.parametrize("soft_spread,soft_pa,hard_pa", [(s, p, h) for s in (0, 1) for p in (0, 1) for h in (0, 1)])
def test_constrained_operands_match_jax(soft_spread, soft_pa, hard_pa):
    """The kernel's operand builders: the port's bands equal the JAX
    package's with its zero-filled absent features dropped, and the banded
    blocked sum is exactly constraints.blocked_block."""
    a, cpods, state, meta, _ = _cons_case(24, 40, 6, CONS_ALL)
    flags = dict(soft_spread=bool(soft_spread), soft_pa=bool(soft_pa), hard_pa=bool(hard_pa))
    masks = jax_cons.round_blocked_masks(np, state, meta, **flags)
    masks_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in masks.items()}
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(cpods[k])) for k in CONSTRAINT_POD_KEYS}
    pod_ops = constrained_pod_operands(cons_pod, masks_t)
    node_ops = constrained_node_operands(masks_t)
    j_node, pa_inactive = constrained_kernel_node_operands(cpods, {k: jnp.asarray(v) for k, v in masks.items()},
                                                          a["node_avail"].shape[0])
    j_pod = constrained_kernel_pod_operands({k: jnp.asarray(v) for k, v in cpods.items()}, pa_inactive)
    band_n = [j_node[0], j_node[1], j_node[2]] + ([j_node[3]] if hard_pa else [])
    band_p = [j_pod[0], j_pod[1], j_pod[2]] + ([j_pod[3]] if hard_pa else [])
    want = [
        (np.concatenate(band_p, 1), np.concatenate(band_n, 0)),
        (j_pod[4], j_node[4]) if soft_spread else None,
        (j_pod[5], j_node[5]),
        (j_pod[6], j_node[6]) if soft_pa else None,
    ]
    for po, no, w in zip(pod_ops, node_ops, want):
        assert po.is_contiguous() and no.is_contiguous() and po.shape[1] == no.shape[0]
        if w is None:
            assert po.shape[1] == 0
        else:
            np.testing.assert_array_equal(po.numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(no.numpy(), np.asarray(w[1]))
    banded = (pod_ops[0] @ node_ops[0]) > 0
    assert torch.equal(banded, port_cons.blocked_block(cons_pod, masks_t))


def test_constrained_choose_rejects_other_devices():
    a, cpods, state, meta, flags = _cons_case(8, 8, 0, CONS_ALL)
    masks = port_cons.round_blocked_masks(
        {k: torch.from_numpy(v).to("meta") for k, v in state.items()},
        {k: torch.from_numpy(v).to("meta") for k, v in meta.items()}, **flags,
    )
    cons_pod = {k: torch.from_numpy(cpods[k]).to("meta") for k in CONSTRAINT_POD_KEYS}
    args = [x.to("meta") for x in _port_args(a)]
    with pytest.raises(ValueError, match="unsupported device"):
        choose_block_constrained(*args, cons_pod, masks, DEFAULT_PROFILE.weights())


# --- the live-column rule of the constrained kernel ---------------------------

from tpu_scheduler_torch.ops.choose import tile_live_columns  # noqa: E402


def _kernel_sums(pod_rows, node, cols):
    """Σ_{k in cols} pod_rows[:, k] · node[k] as the kernel forms it: a +0.0
    start, then one rounded multiply and one rounded add per column."""
    c = torch.zeros((pod_rows.shape[0], node.shape[1]), dtype=torch.float32)
    for k in cols.tolist():
        c = c + pod_rows[:, k, None] * node[k]
    return c


def _live_case(seed, inactive_share=0.3):
    """(port args with ~``inactive_share`` of the pods inactive, cons_pod,
    masks) on an every-family _cons_case cluster."""
    a, cpods, state, meta, flags = _cons_case(24, 40, seed, CONS_ALL, soft_taint_fraction=0.3)
    masks = jax_cons.round_blocked_masks(np, state, meta, **flags)
    masks_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in masks.items()}
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(cpods[k])) for k in CONSTRAINT_POD_KEYS}
    args = _port_args(a)
    rng = np.random.default_rng(seed + 100)
    args[8] = args[8] & torch.from_numpy(rng.random(args[8].shape[0]) >= inactive_share)
    return args, cons_pod, masks_t


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_live_columns_sum_equals_full_width(seed):
    """Per 8-pod tile and operand pair, the sums over the tile's live
    columns equal the full-width sums bit for bit for every active pod (and
    equal the plain version's matmul in value)."""
    args, cons_pod, masks = _live_case(seed)
    active = args[8]
    pod_ops, node_ops = constrained_pod_operands(cons_pod, masks), constrained_node_operands(masks)
    assert all(po.shape[1] > 0 for po in pod_ops)
    tiles = -(-active.shape[0] // 8)
    walked = 0
    for po, no in zip(pod_ops, node_ops):
        lists = tile_live_columns(po, active)
        assert len(lists) == tiles
        for t, cols in enumerate(lists):
            rows = slice(8 * t, 8 * t + 8)
            act = active[rows]
            want = ((po[rows] != 0) & act[:, None]).any(dim=0).nonzero()[:, 0]
            assert torch.equal(cols, want)  # ascending, from active pods only
            live = _kernel_sums(po[rows], no, cols)
            full = _kernel_sums(po[rows], no, torch.arange(po.shape[1]))
            assert torch.equal(live[act].view(torch.int32), full[act].view(torch.int32))
            assert torch.equal(full[act], (po[rows] @ no)[act])
            walked += len(cols)
    assert 0 < walked < sum(po.shape[1] for po in pod_ops) * tiles


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_inactive_pod_bitmaps_change_nothing(seed):
    """Randomising the constraint bitmaps of inactive pods leaves the active
    pods' (choice, has, best) bit for bit, and the inactive pods keep
    (0, False, −inf): so the kernel may build its lists from active pods."""
    args, cons_pod, masks = _live_case(seed, inactive_share=0.4)
    w = PROFILES["throughput"].weights()
    before = choose_block_constrained_plain(*args, cons_pod, masks, w, 3)
    inactive = ~args[8]
    assert inactive.any() and args[8].any()
    rng = np.random.default_rng(seed)
    noisy = {}
    for key, v in cons_pod.items():
        if key == "pod_ppa_w":
            noise = rng.integers(-100, 101, v.shape) * (rng.random(v.shape) < 0.5)
        else:
            noise = rng.random(v.shape) < 0.5
        noisy[key] = torch.where(inactive[:, None], torch.from_numpy(noise.astype(np.float32)), v)
    assert any(not torch.equal(noisy[k], cons_pod[k]) for k in cons_pod)
    after = choose_block_constrained_plain(*args, noisy, masks, w, 3)
    act = args[8]
    assert before[1][act].any()
    assert torch.equal(before[0][act], after[0][act]) and torch.equal(before[1][act], after[1][act])
    assert torch.equal(before[2][act].view(torch.int32), after[2][act].view(torch.int32))
    for choice, has, best in (before, after):
        assert (choice[inactive] == 0).all() and not has[inactive].any() and torch.isneginf(best[inactive]).all()


def test_negative_preferred_weight_against_zero_count():
    """A negative preferred weight against a zero count is a −0.0 product;
    summing it or skipping its column gives the same sums and the same
    best bits."""
    args, cons_pod, masks = _live_case(0, inactive_share=0.0)
    cons_pod = dict(cons_pod, pod_ppa_w=cons_pod["pod_ppa_w"].clone())
    masks = dict(masks, ppa_cnt_node=masks["ppa_cnt_node"].clone())
    assert masks["ppa_cnt_node"].shape[0] >= 2
    cons_pod["pod_ppa_w"][:, 0] = -37.0
    masks["ppa_cnt_node"][0] = 0.0
    product = cons_pod["pod_ppa_w"][:, 0, None] * masks["ppa_cnt_node"][0]
    assert torch.signbit(product).all() and (product == 0).all()
    pod_w, cnt = cons_pod["pod_ppa_w"], masks["ppa_cnt_node"]
    summed = _kernel_sums(pod_w, cnt, torch.arange(cnt.shape[0]))
    skipped = _kernel_sums(pod_w, cnt, torch.arange(1, cnt.shape[0]))
    assert torch.equal(summed.view(torch.int32), skipped.view(torch.int32))
    w = PROFILES["throughput"].weights()
    with_col = choose_block_constrained_plain(*args, cons_pod, masks, w, 2)
    without = choose_block_constrained_plain(
        *args, dict(cons_pod, pod_ppa_w=pod_w[:, 1:].contiguous()), dict(masks, ppa_cnt_node=cnt[1:].contiguous()),
        w, 2,
    )
    assert with_col[1].any()
    assert torch.equal(with_col[0], without[0]) and torch.equal(with_col[1], without[1])
    assert torch.equal(with_col[2].view(torch.int32), without[2].view(torch.int32))


@pytest.mark.parametrize("width", [1, 31, 32, 33, 440])
def test_tile_whose_pods_use_every_column_lists_full_width(width):
    """Pods sharing every column out among them give a full-width list; a
    column only an inactive pod uses drops out; a remainder tile is padded
    with inactive pods."""
    b = 11
    cols = torch.arange(width)
    pod = ((cols[None, :] % 8) == (torch.arange(b)[:, None] % 8)).float() * 3.0
    lists = tile_live_columns(pod, torch.ones(b, dtype=torch.bool))
    assert len(lists) == 2 and torch.equal(lists[0], cols)
    assert torch.equal(lists[1], cols[cols % 8 < 3])  # pods 8..10 use the columns ≡ 0, 1, 2 mod 8
    active = torch.ones(b, dtype=torch.bool)
    active[5] = False
    assert torch.equal(tile_live_columns(pod, active)[0], cols[cols % 8 != 5])
    assert [len(c) for c in tile_live_columns(pod, torch.zeros(b, dtype=torch.bool))] == [0, 0]


# --- bitmaps as words (the kernels' operands) and the exact reciprocal ----------

from tpu_scheduler_torch.ops.choose import (  # noqa: E402
    NODE_WORD_KEYS,
    POD_BITMAP_KEYS,
    bitmap_words,
    pack_node_words,
    pow2_reciprocal,
)


def _packbits_words(bits: np.ndarray) -> np.ndarray:
    """[N, W] 0/1 → [ceil(W/32), N] uint32 with np.packbits: little bit
    order puts column 8·b + k at bit k of byte b, and four bytes read as a
    little-endian uint32 put it at bit 8·b + k of the word, so bit k of
    word j is column 32·j + k."""
    n, w = bits.shape
    nw = -(-w // 32)
    padded = np.zeros((n, nw * 32), np.uint8)
    padded[:, :w] = bits != 0
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").reshape(n, nw).T


@pytest.mark.parametrize("width", [0, 1, 8, 31, 32, 33, 264, 300])
def test_pack_node_words_matches_packbits(width):
    rng = np.random.default_rng(width)
    n = 37
    maps = [(rng.random((n, width)) < p).astype(np.float32) for p in (0.5, 0.1, 0.9, 0.3, 0.0)]
    if width:
        maps[0][:, -1] = 1.0  # the last column (bit 31 of a full word at width 32)
        maps[1][:, 0] = -0.0  # −0.0 is a 0
    words = pack_node_words(*(torch.from_numpy(m) for m in maps))
    assert len(words) == len(NODE_WORD_KEYS)
    for m, got in zip(maps, words):
        assert got.dtype == torch.int32 and got.is_contiguous() and tuple(got.shape) == (-(-width // 32), n)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), _packbits_words(m))
    assert torch.equal(bitmap_words(torch.from_numpy(maps[2])), words[2])


def _bitmap_case():
    a = _case(8, 16, seed=0, soft_taint_fraction=0.4, preferred_affinity_fraction=0.4)
    assert all(a[k].shape[1] > 0 for k in POD_BITMAP_KEYS + NODE_WORD_KEYS)
    return a


@pytest.mark.parametrize("value", [2.0, 0.5, -1.0])
@pytest.mark.parametrize("key", POD_BITMAP_KEYS + NODE_WORD_KEYS)
def test_choose_block_rejects_non_binary_bitmap(key, value):
    """A bitmap operand that is not 0/1 raises ValueError naming it, on the
    CPU as on the card: the kernels count bits, which equals the plain
    version's float sums only for 0/1 operands."""
    a = _bitmap_case()
    a[key] = a[key].copy()
    a[key][1, -1] = value
    with pytest.raises(ValueError, match=f"^{key}: holds {value!r}"):
        choose_block(*_port_args(a), DEFAULT_PROFILE.weights())
    a_cons = _cons_case(24, 40, 0, CONS_ALL)
    a_cons[0][key] = a_cons[0][key].copy()
    a_cons[0][key][2, 0] = value
    masks = port_cons.round_blocked_masks(
        {k: torch.from_numpy(v) for k, v in a_cons[2].items()}, {k: torch.from_numpy(v) for k, v in a_cons[3].items()},
        **a_cons[4],
    )
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(a_cons[1][k])) for k in CONSTRAINT_POD_KEYS}
    with pytest.raises(ValueError, match=f"^{key}: holds {value!r}"):
        choose_block_constrained(*_port_args(a_cons[0]), cons_pod, masks, DEFAULT_PROFILE.weights())


@pytest.mark.parametrize("case", ["skips_pod_check", "wrong_shape", "wrong_dtype", "wrong_count"])
def test_prebuilt_node_words_are_taken_as_given(case):
    """A caller that passes node_words has checked the bitmaps once per
    cycle: the wrapper does not read the pod bitmaps again (a 2.0 there
    goes unchecked), but it holds the words to the node bitmaps' shapes
    and to int32, on the CPU as on the card."""
    a = _bitmap_case()
    words = list(pack_node_words(*_port_args(a)[13:18]))
    w = PROFILES["throughput"].weights()
    if case == "skips_pod_check":
        a["pod_sel"] = a["pod_sel"].copy()
        a["pod_sel"][1, -1] = 2.0
        with pytest.raises(ValueError, match="^pod_sel: holds 2.0"):
            choose_block(*_port_args(a), w, 3)
        choose_block(*_port_args(a), w, 3, node_words=words)
        return
    if case == "wrong_shape":
        words[1] = torch.zeros((words[1].shape[0] + 1, words[1].shape[1]), dtype=torch.int32)
        match = "^node_taints words: shape"
    elif case == "wrong_dtype":
        words[0] = words[0].to(torch.int64)
        match = "^node_labels words: dtype"
    else:
        words = words[:4]
        match = "^node_words: 4 tensors"
    with pytest.raises(ValueError, match=match):
        choose_block(*_port_args(a), w, 3, node_words=words)


@pytest.mark.parametrize("k", range(-10, 11))
def test_division_by_power_of_two_is_multiplication_by_reciprocal(k):
    """x / 2^k and x · 2^−k round the same real number, so they are equal
    bit for bit on random float32, subnormal inputs and results, ±0, ±inf
    and values near the overflow and underflow limits."""
    rng = np.random.default_rng(k + 10)
    w = np.float32(2.0**k)
    inv = np.float32(1.0) / w
    assert float(inv) * float(w) == 1.0
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * np.float32(100.0),
        (rng.random(2000) * 2**32).astype(np.uint32).view(np.float32),  # every exponent, NaNs dropped below
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.1754942e-38, 3.4028235e38, -3.4028235e38], np.float32),
        (rng.integers(1, 1 << 23, 500).astype(np.uint32)).view(np.float32),  # subnormals
    ])
    x = x[~np.isnan(x)]
    with np.errstate(over="ignore", under="ignore"):
        np.testing.assert_array_equal((x / w).view(np.int32), (x * inv).view(np.int32))
    assert pow2_reciprocal(w) == float(inv)


@pytest.mark.parametrize("w,exact", [(32.0, True), (0.5, True), (0.3, False), (3.0, False), (0.0, False)])
def test_pow2_reciprocal_rule(w, exact):
    """The launcher's rule: the flagship's 32.0 and the default 0.5 take the
    multiplication; 0.3, 3.0 and 0 (no jitter) keep the division."""
    inv = pow2_reciprocal(w)
    assert (inv is not None) == exact
    if exact:
        assert inv == 1.0 / w


def _word_counts(pod_bits: np.ndarray, node_bits: np.ndarray) -> np.ndarray:
    """[B, N] popcount of (pod words & node words) summed over words."""
    pw, nw = _packbits_words(pod_bits), _packbits_words(node_bits)
    return np.bitwise_count(pw.T[:, None, :] & nw.T[None, :, :]).astype(np.int64).sum(-1)


def _word_model(a, weights, salt):
    """The redesigned kernel's arithmetic in NumPy: the hard predicates and
    the soft count from popcounts of packed words, c_pref as the ascending
    float32 sum of pref_w over the set bits of nz(pref_w) & node_pref from
    +0.0, h / 65536 built in the mantissa, the quantization by the exact
    reciprocal when the jitter is a power of two.  Returns (choice, has,
    best) over every pod and node."""
    f32 = np.float32
    w = np.asarray(weights, f32)
    b, n = a["pod_req"].shape[0], a["node_avail"].shape[0]
    selc = a["pod_sel_count"]
    need = np.where((selc >= 0) & (np.floor(selc) == selc), selc, -1).astype(np.int64)
    feasible = (
        (a["pod_req"][:, None, :] <= a["node_avail"][None, :, :]).all(-1)
        & (_word_counts(a["pod_sel"], a["node_labels"]) == need[:, None])
        & (_word_counts(a["pod_ntol"], a["node_taints"]) == 0)
        & ((_word_counts(a["pod_aff"], a["node_aff"]) > 0) | (a["pod_has_aff"] == 0)[:, None])
        & a["node_valid"][None, :] & a["pod_valid"][:, None]
    )
    c_pref = np.zeros((b, n), f32)
    pref_w, node_pref = a["pod_pref_w"], a["node_pref"]
    for k in range(pref_w.shape[1]):
        hit = (pref_w[:, k] != 0)[:, None] & (node_pref[:, k] != 0)[None, :]
        c_pref = np.where(hit, c_pref + pref_w[:, k, None], c_pref)
    soft = _word_counts(a["pod_ntol_soft"], a["node_taints_soft"]).astype(f32)
    alloc, avail, req = a["node_alloc"][:, :2], a["node_avail"][:, :2], a["pod_req"][:, :2]
    with np.errstate(over="ignore"):
        used = (alloc - avail)[None, :, :] + req[:, None, :]
    safe = (alloc > 0)[None]
    frac = np.where(safe, used.astype(f32) / np.where(safe, alloc.astype(f32)[None], f32(1)), f32(1))
    lr = ((f32(1) - frac[..., 0]) + (f32(1) - frac[..., 1])) * f32(50)
    ba = (f32(1) - np.abs(frac[..., 0] - frac[..., 1])) * f32(100)
    s = (w[0] * lr + w[1] * ba + w[3] * c_pref) - w[4] * soft
    h = (np.arange(b, dtype=np.uint64)[:, None] * 2654435761 + np.arange(n, dtype=np.uint64)[None, :] * 2246822519
         + salt * 3266489917) & 0xFFFFFFFF
    h = ((h ^ (h >> 15)) & 0xFFFF).astype(np.uint32)
    unit16 = (np.uint32(0x3F800000) | (h << np.uint32(7))).view(f32) - f32(1)
    np.testing.assert_array_equal(unit16, h.astype(f32) / f32(65536))
    if w[2] > 0:
        inv = pow2_reciprocal(w[2])
        s = np.floor(s * f32(inv) if inv is not None else s / w[2]) * w[2]
    s = (s + w[2] * unit16).astype(f32)
    masked = np.where(feasible, s, f32(-np.inf))
    choice = masked.argmax(1).astype(np.int32)
    return choice, feasible.any(1), masked[np.arange(b), choice]


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_popcounts_equal_jax_dot_products(seed):
    """The hard and soft counts as popcounts of packed words equal, as
    float32, the dot products the JAX package's choose forms from the
    same inputs (jnp, float32 on the CPU)."""
    a = _case(
        32, 48, seed, selector_fraction=0.7, tainted_fraction=0.5, node_affinity_fraction=0.5,
        soft_taint_fraction=0.5, preferred_affinity_fraction=0.5,
    )
    for pod_key, node_key in (("pod_sel", "node_labels"), ("pod_ntol", "node_taints"), ("pod_aff", "node_aff"),
                              ("pod_ntol_soft", "node_taints_soft")):
        dot = np.asarray(jnp.asarray(a[pod_key]) @ jnp.asarray(a[node_key]).T)
        counts = _word_counts(a[pod_key], a[node_key])
        assert counts.any(), pod_key
        np.testing.assert_array_equal(counts.astype(np.float32).view(np.int32), dot.view(np.int32), err_msg=pod_key)


def _numpy_reference(a, weights, salt):
    """The JAX package's masks and score evaluated with NumPy (the oracle's
    arithmetic), then the first-max argmax: (choice, has, best)."""
    b, n = a["pod_req"].shape[0], a["node_avail"].shape[0]
    names = ("pod_req", "pod_sel", "pod_sel_count", "pod_valid", "node_avail", "node_labels", "node_valid",
             "pod_ntol", "node_taints", "pod_aff", "pod_has_aff", "node_aff")
    m = jax_masks.feasibility_block(np, *(a[k] for k in names))
    s = jax_score.score_block(
        np, a["pod_req"], a["node_alloc"], a["node_avail"], weights, np.arange(b, dtype=np.uint32),
        np.arange(n, dtype=np.uint32), pod_pref_w=a["pod_pref_w"], node_pref=a["node_pref"],
        pod_ntol_soft=a["pod_ntol_soft"], node_taints_soft=a["node_taints_soft"], salt=salt,
    )
    s = np.where(m, s, np.float32(-np.inf)).astype(np.float32)
    choice = s.argmax(1).astype(np.int32)
    return choice, m.any(1), s[np.arange(b), choice]


@pytest.mark.parametrize("jitter", [32.0, 0.5, 0.3, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_word_model_matches_jax(seed, jitter):
    """The redesigned kernel's arithmetic (_word_model) equals the JAX
    package's choose bit for bit: its masks and score evaluated with NumPy
    at every jitter (0.3 keeps the division, 0 skips the quantization), and
    the Pallas kernel in interpret mode (choice, has, best) and the jnp tree
    (choice, has) where the jitter is a power of two or 0.  At 0.3 XLA's
    CPU jit contracts ⌊s/w⌋·w + w·u into a multiply-add, which rounds once
    (ROADMAP Queue 3); with a power of two the product is exact and the
    contraction changes nothing."""
    a = _case(24, 40, seed, soft_taint_fraction=0.4, preferred_affinity_fraction=0.4, tainted_fraction=0.3,
              node_affinity_fraction=0.3)
    weights = dataclasses.replace(PROFILES["throughput"], spread_jitter=jitter).weights()
    salt = 3 + seed
    mc, mh, mb = _word_model(a, weights, salt)
    assert mh.any()
    rc, rh, rb = _numpy_reference(a, weights, salt)
    np.testing.assert_array_equal(mh, rh)
    np.testing.assert_array_equal(mc, rc)
    np.testing.assert_array_equal(mb.view(np.int32), rb.view(np.int32))
    if jitter == 0.3:
        return
    kc, kh, kb = _pallas_path(a, weights, salt)
    np.testing.assert_array_equal(mh, kh)
    np.testing.assert_array_equal(mc[mh], kc[kh])
    np.testing.assert_array_equal(mb[mh].view(np.int32), kb[kh].view(np.int32))
    jc, jh = _jnp_path(a, weights, salt)
    np.testing.assert_array_equal(mh, jh)
    np.testing.assert_array_equal(mc, jc)
