"""The port's constraint engine (``tpu_scheduler_torch/ops/constraints.py``,
device half) vs the JAX package's xp-generic functions, run eagerly with
``xp=jax.numpy`` and with ``xp=np`` on the same NumPy state: every output
equal bit for bit.  Inputs are a real packed ConstraintSet whose round
state is randomised from a NumPy seed (domain marks, counts, inactive
positive-affinity terms, keyless nodes), so every branch sees non-trivial
values.  Covered: augment_round_state, round_blocked_masks and
blocked_block for every mix of soft spread / preferred / hard positive
affinity, constraint_filter on both anti-affinity formulations, the
chunked spread cell scans, and constraint_commit."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tpu_scheduler.ops.constraints as JC  # noqa: E402
import tpu_scheduler_torch.ops.constraints as TC  # noqa: E402
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack  # noqa: E402
from tpu_scheduler.testing import synth_cluster as jax_synth  # noqa: E402

ALL = dict(
    anti_affinity_fraction=0.25, spread_fraction=0.25, schedule_anyway_fraction=0.2, pod_affinity_fraction=0.2,
    preferred_pod_affinity_fraction=0.2,
)
MIXES = [(s, p, h) for s in (False, True) for p in (False, True) for h in (False, True)]


def _case(seed: int, n_nodes: int = 40, n_pending: int = 120):
    """(pods, meta, state) NumPy dicts: a packed ConstraintSet with its
    round state randomised, and ~20% of nodes stripped of every coarse
    domain (keyless nodes: node-granular cells)."""
    snap = jax_synth(n_nodes=n_nodes, n_pending=n_pending, n_bound=n_nodes, seed=seed, **ALL)
    packed = jax_pack(snap, pod_block=8, node_block=8)
    cons = JC.pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    rng = np.random.default_rng(seed)
    pods = {k: v.copy() for k, v in cons.pod_arrays().items()}
    meta = {k: v.copy() for k, v in cons.meta_arrays().items()}
    meta["node_dom_c"][rng.random(meta["node_dom_c"].shape[0]) < 0.2] = 0.0
    state = {}
    for k, v in cons.state_arrays().items():
        if k.endswith(("_cnt", "counts")):
            state[k] = rng.integers(0, 5, v.shape).astype(np.float32)
        else:
            state[k] = (rng.random(v.shape) < 0.15).astype(np.float32)
    for k in ("sp_counts", "sps_counts"):
        state[k] *= meta["sp_uses_dom" if k == "sp_counts" else "sps_uses_dom"]
    # Half the positive-affinity terms match nothing anywhere (bootstrap).
    dead = rng.random(state["pa_dom_m"].shape[0]) < 0.5
    state["pa_dom_m"][dead] = 0.0
    state["pa_node_m"][dead] = 0.0
    return pods, meta, state


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _assert_dicts_equal(port: dict, ref: dict, ref_j: dict):
    assert sorted(port) == sorted(ref) == sorted(ref_j)
    for k in ref:
        got = port[k].numpy()
        assert got.dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got, ref[k], err_msg=k)
        np.testing.assert_array_equal(got, np.asarray(ref_j[k]), err_msg=k)


def _augmented(meta, state):
    return JC.augment_round_state(np, state, meta)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_augment_round_state(seed):
    _, meta, state = _case(seed)
    ref = JC.augment_round_state(np, state, meta)
    ref_j = JC.augment_round_state(jnp, _jnp(state), _jnp(meta))
    _assert_dicts_equal(TC.augment_round_state(_torch(state), _torch(meta)), ref, ref_j)
    assert 0 < ref["pa_inactive"].sum() < ref["pa_inactive"].size  # both kinds of term


@pytest.mark.parametrize("soft_spread,soft_pa,hard_pa", MIXES)
def test_round_blocked_masks_and_blocked_block(soft_spread, soft_pa, hard_pa):
    pods, meta, state = _case(2)
    st = _augmented(meta, state)
    flags = dict(soft_spread=soft_spread, soft_pa=soft_pa, hard_pa=hard_pa)
    ref = JC.round_blocked_masks(np, st, meta, **flags)
    ref_j = JC.round_blocked_masks(jnp, _jnp(st), _jnp(meta), **flags)
    got = TC.round_blocked_masks(_torch(st), _torch(meta), **flags)
    _assert_dicts_equal(got, ref, ref_j)
    blk = {k: v[:48] for k, v in pods.items()}
    ref_b = JC.blocked_block(np, blk, ref)
    got_b = TC.blocked_block(_torch(blk), got).numpy()
    np.testing.assert_array_equal(got_b, ref_b)
    np.testing.assert_array_equal(got_b, np.asarray(JC.blocked_block(jnp, _jnp(blk), ref_j)))
    assert ref_b.any() and not ref_b.all()


def _filter_inputs(seed, pods, meta, accept_p=0.5):
    rng = np.random.default_rng(100 + seed)
    p = pods["pod_aa_carries"].shape[0]
    n = meta["node_dom_c"].shape[0]
    accepted = rng.random(p) < accept_p
    choice = rng.integers(0, n, p).astype(np.int32)
    return accepted, choice, np.arange(p, dtype=np.uint32)


def _filter_all(accepted, choice, ranks, pods, st, meta, hard_pa):
    ref = JC.constraint_filter(np, accepted, choice, ranks, pods, st, meta, hard_pa=hard_pa)
    ref_j = JC.constraint_filter(
        jnp, jnp.asarray(accepted), jnp.asarray(choice), jnp.asarray(ranks), _jnp(pods), _jnp(st), _jnp(meta),
        hard_pa=hard_pa,
    )
    got = TC.constraint_filter(
        torch.from_numpy(accepted), torch.from_numpy(choice), torch.from_numpy(ranks.astype(np.int32)),
        _torch(pods), _torch(st), _torch(meta), hard_pa=hard_pa,
    )
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_j))
    return ref


@pytest.mark.parametrize("hard_pa", [True, False])
@pytest.mark.parametrize("path", ["dense", "segment"])
@pytest.mark.parametrize("seed", [0, 3])
def test_constraint_filter_both_anti_affinity_paths(monkeypatch, seed, path, hard_pa):
    pods, meta, state = _case(seed)
    st = _augmented(meta, state)
    cells = 10**9 if path == "dense" else 0
    monkeypatch.setattr(JC, "DENSE_CELLS", cells)
    monkeypatch.setattr(TC, "DENSE_CELLS", cells)
    accepted, choice, ranks = _filter_inputs(seed, pods, meta)
    kept = _filter_all(accepted, choice, ranks, pods, st, meta, hard_pa)
    assert kept.any() and (kept != accepted).any()  # some survive, some are deferred
    assert not (kept & ~accepted).any()


def test_constraint_filter_nothing_accepted():
    pods, meta, state = _case(1)
    st = _augmented(meta, state)
    accepted, choice, ranks = _filter_inputs(1, pods, meta, accept_p=0.0)
    assert not _filter_all(accepted, choice, ranks, pods, st, meta, True).any()


def test_constraint_filter_chunked_scans(monkeypatch):
    """Over 256 accepted rows and a byte budget that forces 256-row chunks
    of the spread cell passes: still equal to the one-shot reference."""
    pods, meta, state = _case(5, n_nodes=48, n_pending=700)
    st = _augmented(meta, state)
    accepted, choice, ranks = _filter_inputs(5, pods, meta, accept_p=0.8)
    assert accepted.sum() > 2 * 256
    one_shot = _filter_all(accepted, choice, ranks, pods, st, meta, True)
    s, ds = meta["sp_uses_dom"].shape[0], meta["sp_dom_sel"].shape[1]
    budget = 64 * s * ds * 4
    monkeypatch.setattr(JC, "DENSE_TENSOR_BYTES", budget)
    monkeypatch.setattr(TC, "DENSE_TENSOR_BYTES", budget)
    assert TC._cell_chunk(int(accepted.sum()), s * ds) == 256
    np.testing.assert_array_equal(_filter_all(accepted, choice, ranks, pods, st, meta, True), one_shot)


def test_cell_rank_scans_chunked_equal_oneshot(monkeypatch):
    rng = np.random.default_rng(0)
    p, s, d = 533, 7, 5
    mass = (rng.random((p, s)) < 0.3).astype(np.float32)
    nd = np.zeros((p, d), np.float32)
    nd[np.arange(p), rng.integers(0, d, p)] = 1.0
    uses = (rng.random((s, d)) < 0.7).astype(np.float32)
    base = rng.integers(0, 5, (s, d)).astype(np.float32)
    ref_pre = JC._cell_rank_prefix(np, mass, nd, uses)
    ref_lvl = JC._cell_rank_min_level(np, mass, nd, uses, base)
    t = [torch.from_numpy(x) for x in (mass, nd, uses, base)]
    np.testing.assert_array_equal(TC._cell_rank_prefix(*t[:3]).numpy(), ref_pre)
    np.testing.assert_array_equal(TC._cell_rank_min_level(*t).numpy(), ref_lvl)
    monkeypatch.setattr(TC, "DENSE_TENSOR_BYTES", 64 * s * d * 4)  # 256-row chunks
    assert TC._cell_chunk(p, s * d) == 256
    np.testing.assert_array_equal(TC._cell_rank_prefix(*t[:3]).numpy(), ref_pre)
    np.testing.assert_array_equal(TC._cell_rank_min_level(*t).numpy(), ref_lvl)


@pytest.mark.parametrize("soft_spread,soft_pa,hard_pa", MIXES)
def test_constraint_commit(soft_spread, soft_pa, hard_pa):
    pods, meta, state = _case(6)
    st = _augmented(meta, state)
    accepted, choice, _ = _filter_inputs(6, pods, meta, accept_p=0.3)
    flags = dict(soft_spread=soft_spread, soft_pa=soft_pa, hard_pa=hard_pa)
    ref = JC.constraint_commit(np, accepted, choice, pods, st, meta, **flags)
    ref_j = JC.constraint_commit(jnp, jnp.asarray(accepted), jnp.asarray(choice), _jnp(pods), _jnp(st), _jnp(meta), **flags)
    st_t = _torch(st)
    before = {k: v.clone() for k, v in st_t.items()}
    got = TC.constraint_commit(torch.from_numpy(accepted), torch.from_numpy(choice), _torch(pods), st_t, _torch(meta), **flags)
    _assert_dicts_equal(got, ref, ref_j)
    for k, v in before.items():  # the caller's state is left as it was
        assert torch.equal(st_t[k], v), k
    if hard_pa:
        assert (ref["pa_inactive"] != st["pa_inactive"]).any()  # a term came alive
