"""The port's sharded (dp × tp) cycle vs the JAX package: on a mesh of CPU
devices, ``tpu_scheduler_torch.parallel.sharded.ShardedBackend`` must
equal, bit for bit (bindings and rounds), the JAX ``ShardedBackend`` with
the Pallas kernel in interpret mode, the NumPy oracle ``NativeBackend`` and
the port's own single-device ``CudaBackend(device="cpu")`` — unconstrained
and constrained, tp ∈ {1, 2, 4}, including the uneven 1003 × 257 scenario
whose padded axes no dp or tp divides.  Also: the per-shard choose with
``node_offset`` (kernel #2b's plain version) against the JAX kernel, the
offset's 2^24 limit, and the dp copies of a column's capacity on a mesh
that repeats one device."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
from tpu_scheduler.models.profiles import DEFAULT_PROFILE as JAX_DEFAULT  # noqa: E402
from tpu_scheduler.ops import constraints as jax_cons  # noqa: E402
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack  # noqa: E402
from tpu_scheduler.ops.pallas_choose import (  # noqa: E402
    build_node_info,
    choose_block_pallas,
    constrained_kernel_node_operands,
    constrained_kernel_pod_operands,
)
from tpu_scheduler.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tpu_scheduler.parallel.sharded import ShardedBackend as JaxShardedBackend  # noqa: E402
from tpu_scheduler.testing import synth_cluster as jax_synth  # noqa: E402
from tpu_scheduler.testing import uneven_shard_scenario  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend, make_backend  # noqa: E402
from tpu_scheduler_torch.errors import BackendUnavailable  # noqa: E402
from tpu_scheduler_torch.models.profiles import DEFAULT_PROFILE, PROFILES  # noqa: E402
from tpu_scheduler_torch.ops import choose as choose_mod  # noqa: E402
from tpu_scheduler_torch.ops.choose import (  # noqa: E402
    CONSTRAINT_POD_KEYS,
    MAX_NODE_OFFSET,
    choose_block,
    choose_block_constrained,
    choose_block_constrained_plain,
    choose_block_plain,
)
from tpu_scheduler_torch.ops.constraints import pack_constraints  # noqa: E402
from tpu_scheduler_torch.ops.pack import pack_snapshot  # noqa: E402
from tpu_scheduler_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for  # noqa: E402
from tpu_scheduler_torch.parallel.sharded import ShardedBackend, constraint_operands, sharded_assign_cycle  # noqa: E402
from tpu_scheduler_torch.testing import synth_cluster  # noqa: E402

CPU8 = [torch.device("cpu")] * 8

# tests/test_sharded.py's plain (:120) and constrained (:132) clusters.
PLAIN = dict(n_nodes=48, n_pending=280, n_bound=60, seed=2)
CONSTRAINED = dict(
    n_nodes=32, n_pending=120, n_bound=64, seed=5, anti_affinity_fraction=0.2, spread_fraction=0.2,
    schedule_anyway_fraction=0.2, pod_affinity_fraction=0.15, preferred_pod_affinity_fraction=0.2,
)
# tpu_scheduler.testing.uneven_shard_scenario's cluster, built by the port.
UNEVEN = dict(
    n_nodes=257, n_pending=1003, n_bound=301, seed=29, anti_affinity_fraction=0.1, spread_fraction=0.1,
    schedule_anyway_fraction=0.1, pod_affinity_fraction=0.05, preferred_pod_affinity_fraction=0.1,
    tainted_fraction=0.1, cordoned_fraction=0.05, extended_fraction=0.1,
)


def _port_packed(kw, constrained, pod_block, node_block):
    snap = synth_cluster(**kw)
    packed = pack_snapshot(snap, pod_block=pod_block, node_block=node_block)
    if constrained:
        cons = pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
        assert cons is not None
        packed = dataclasses.replace(packed, constraints=cons)
    return packed


def _jax_packed(kw, constrained, pod_block, node_block):
    snap = jax_synth(**kw)
    packed = jax_pack(snap, pod_block=pod_block, node_block=node_block)
    if constrained:
        cons = jax_cons.pack_constraints(
            snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes
        )
        packed = dataclasses.replace(packed, constraints=cons)
    return packed


@functools.cache
def _jax_sharded(name: str, tp: int):
    kw, constrained, blocks = {"plain": (PLAIN, False, (64, 16)), "constrained": (CONSTRAINED, True, (32, 16))}[name]
    r = JaxShardedBackend(jax_make_mesh(tp=tp), use_pallas=True, pallas_interpret=True).schedule(
        _jax_packed(kw, constrained, *blocks)
    )
    return r.assigned, r.rounds


@functools.cache
def _uneven_oracle():
    packed, cpacked = uneven_shard_scenario()
    return tuple((r.assigned, r.rounds) for r in (NativeBackend().schedule(packed), NativeBackend().schedule(cpacked)))


def _assert_equal(port, ref_assigned, ref_rounds):
    np.testing.assert_array_equal(port.assigned, ref_assigned)
    assert port.rounds == ref_rounds


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", ["plain", "constrained"])
def test_sharded_matches_jax_sharded_pallas(name, tp):
    kw, constrained, blocks = {"plain": (PLAIN, False, (64, 16)), "constrained": (CONSTRAINED, True, (32, 16))}[name]
    packed = _port_packed(kw, constrained, *blocks)
    mesh = make_mesh(CPU8, tp=tp)
    assert mesh.shape == {"dp": 8 // tp, "tp": tp}
    before = (choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED)
    r = ShardedBackend(mesh).schedule(packed)
    assert (choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED) == before  # CPU tensors launch nothing
    assert r.stats["backend"] == "cuda-sharded"
    _assert_equal(r, *_jax_sharded(name, tp))
    single = CudaBackend(device="cpu").schedule(packed)
    _assert_equal(r, single.assigned, single.rounds)
    assert len(r.bindings) > (80 if constrained else 200)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("constrained", [False, True])
def test_sharded_uneven_scenario_matches_native(constrained, tp):
    packed = _port_packed(UNEVEN, constrained, 1, 1)
    assert packed.padded_pods == 1003 and packed.padded_nodes == 257
    r = ShardedBackend(make_mesh(CPU8, tp=tp)).schedule(packed)
    _assert_equal(r, *_uneven_oracle()[int(constrained)])
    assert len(r.bindings) > 800


def test_repeated_device_keeps_dp_copies_apart():
    """A (4, 2) mesh of one device: the four dp copies of each column's
    capacity must each be subtracted once per accepted claim.  Storage that
    aliased across rows with in-place updates would subtract four times."""
    snap = synth_cluster(n_nodes=10, n_pending=300, n_bound=10, seed=3, selector_fraction=0.4)
    packed = pack_snapshot(snap, pod_block=1, node_block=1)
    mesh = make_mesh(CPU8, tp=2)
    assert mesh.shape == {"dp": 4, "tp": 2} and len(mesh.distinct_devices()) == 1
    a = dict(packed.device_arrays())
    profile = DEFAULT_PROFILE.with_(max_rounds=256)
    assigned, rounds, avail = sharded_assign_cycle(mesh, a, profile.weights(), profile.max_rounds)
    single = CudaBackend(device="cpu").schedule(packed, profile)
    np.testing.assert_array_equal(assigned.numpy(), single.assigned)
    assert rounds == single.rounds and rounds > 2
    placed = np.flatnonzero(single.assigned >= 0)
    want = packed.node_avail.astype(np.int64).copy()
    np.add.at(want, single.assigned[placed], -packed.pod_req[placed].astype(np.int64))
    assert avail.shape == (4,) + packed.node_avail.shape
    for row in avail:
        np.testing.assert_array_equal(row.numpy(), want)


def test_sharded_contention_many_rounds_matches_single_device():
    snap = synth_cluster(n_nodes=8, n_pending=500, seed=3, selector_fraction=0.4)
    packed = pack_snapshot(snap, pod_block=64, node_block=8)
    profile = PROFILES["default"].with_(max_rounds=256)
    single = CudaBackend(device="cpu").schedule(packed, profile)
    for tp in (2, 4):
        _assert_equal(ShardedBackend(make_mesh(CPU8, tp=tp)).schedule(packed, profile), single.assigned, single.rounds)


# --- the per-shard choose: node_offset (kernel #2b's plain version) ---------

POD_KEYS = ("pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff", "pod_has_aff", "pod_pref_w", "pod_ntol_soft")
NODE_KEYS = (
    "node_avail", "node_alloc", "node_valid", "node_labels", "node_taints", "node_aff", "node_pref", "node_taints_soft",
)


def _offset_case(constrained: bool):
    kw = dict(n_nodes=40, n_pending=24, n_bound=40, seed=7, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3)
    if constrained:
        kw.update(CONSTRAINED, n_nodes=40, n_pending=24, n_bound=40, seed=7)
    snap = jax_synth(**kw)
    packed = jax_pack(snap, pod_block=1, node_block=1)
    a = dict(packed.device_arrays())
    if not constrained:
        return a, None, None
    cons = jax_cons.pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names,
                                     packed.padded_nodes)
    flags = dict(soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0, hard_pa=cons.n_pa_terms > 0)
    assert all(flags.values())
    meta = cons.meta_arrays()
    masks = jax_cons.round_blocked_masks(np, jax_cons.augment_round_state(np, cons.state_arrays(), meta), meta, **flags)
    return a, cons.pod_arrays(), masks


def _port_args(a, lo=0, hi=None):
    """choose_block's positional tensors over node rows [lo, hi)."""
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    p = a["pod_req"].shape[0]
    return (
        [t(a[k]) for k in POD_KEYS] + [t(a["pod_valid"]), torch.arange(p, dtype=torch.int32)]
        + [t(a[k][lo:hi]) for k in NODE_KEYS]
    )


def _port_choose(a, cpods, masks, weights, salt, node_offset, lo=0, hi=None):
    args = _port_args(a, lo, hi)
    if cpods is None:
        return [x.numpy() for x in choose_block(*args, weights, salt, node_offset=node_offset)]
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(cpods[k])) for k in CONSTRAINT_POD_KEYS}
    lm = {k: torch.from_numpy(np.ascontiguousarray(v if k == "pa_inactive" else v[:, lo:hi])) for k, v in masks.items()}
    return [x.numpy() for x in choose_block_constrained(*args, cons_pod, lm, weights, salt, node_offset=node_offset)]


@pytest.mark.parametrize("node_offset", [0, 257, MAX_NODE_OFFSET - 5])
@pytest.mark.parametrize("constrained", [False, True])
def test_node_offset_matches_pallas(constrained, node_offset):
    """Port plain choose with ``node_offset`` == the JAX kernel with
    ``node_offset`` and ``return_best`` (interpret mode): choice, has, and
    best bit for bit; the offset moves the jitter, not the index space."""
    a, cpods, masks = _offset_case(constrained)
    weights = PROFILES["throughput"].weights()
    pc, ph, pb = _port_choose(a, cpods, masks, weights, 3, node_offset)
    p, n = a["pod_req"].shape[0], a["node_avail"].shape[0]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    kw = {}
    if constrained:
        blk = {k: jnp.asarray(v) for k, v in cpods.items()}
        cons_node, pa_inactive = constrained_kernel_node_operands(blk, {k: jnp.asarray(v) for k, v in masks.items()}, n)
        kw = dict(cons_pod=constrained_kernel_pod_operands(blk, pa_inactive), cons_node=cons_node)
    kc, kh, kb = (np.asarray(x) for x in choose_block_pallas(
        *(j[k] for k in POD_KEYS), j["pod_valid"], jnp.arange(p, dtype=jnp.uint32),
        build_node_info(j["node_avail"], j["node_alloc"], j["node_valid"]),
        j["node_labels"].T, j["node_taints"].T, j["node_aff"].T, j["node_pref"].T, j["node_taints_soft"].T,
        jnp.asarray(weights), salt=jnp.int32(3), node_offset=jnp.int32(node_offset), pod_tile=8, node_tile=128,
        interpret=True, return_best=True, **kw,
    ))
    assert ph.any()
    np.testing.assert_array_equal(ph, kh)
    np.testing.assert_array_equal(pc[ph], kc[kh])
    np.testing.assert_array_equal(pb.view(np.int32), kb.view(np.int32))
    if node_offset:
        base = _port_choose(a, cpods, masks, weights, 3, 0)
        assert not np.array_equal(pb[ph].view(np.int32), base[2][ph].view(np.int32))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("constrained", [False, True])
def test_node_slices_merge_to_unsplit(constrained, tp):
    """Each tp slice's choose with its global base as ``node_offset``, merged
    on (score desc, index asc), equals the unsplit choose: choice, has,
    best."""
    a, cpods, masks = _offset_case(constrained)
    weights = JAX_DEFAULT.weights()
    want = _port_choose(a, cpods, masks, weights, 1, 0)
    n = a["node_avail"].shape[0]
    step = -(-n // tp)
    best = choice = None
    for lo in range(0, n, step):
        c, _, b = _port_choose(a, cpods, masks, weights, 1, lo, lo, lo + step)
        c = c + lo
        if best is None:
            best, choice = b, c
            continue
        take = (b > best) | ((b == best) & (c < choice))
        best, choice = np.where(take, b, best), np.where(take, c, choice)
    has = np.isfinite(best)
    np.testing.assert_array_equal(has, want[1])
    np.testing.assert_array_equal(choice[has], want[0][has])
    np.testing.assert_array_equal(best.view(np.int32), want[2].view(np.int32))


@pytest.mark.parametrize("node_offset", [MAX_NODE_OFFSET, MAX_NODE_OFFSET + 1, -1])
def test_node_offset_limit_refused(node_offset):
    a, cpods, masks = _offset_case(True)
    args = _port_args(a)
    w = JAX_DEFAULT.weights()
    cons_pod = {k: torch.from_numpy(np.ascontiguousarray(cpods[k])) for k in CONSTRAINT_POD_KEYS}
    masks_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in masks.items()}
    for call in (
        lambda: choose_block(*args, w, node_offset=node_offset),
        lambda: choose_block_plain(*args, w, node_offset=node_offset),
        lambda: choose_block_constrained(*args, cons_pod, masks_t, w, node_offset=node_offset),
        lambda: choose_block_constrained_plain(*args, cons_pod, masks_t, w, node_offset=node_offset),
    ):
        with pytest.raises(ValueError, match="node_offset"):
            call()


# --- mesh and backend construction -----------------------------------------


def test_mesh_shape_for_and_grid():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(8, tp=4) == (2, 4)
    assert mesh_shape_for(1) == (1, 1)
    assert mesh_shape_for(7) == (7, 1)
    with pytest.raises(ValueError):
        mesh_shape_for(8, tp=3)
    devs = [torch.device("cpu")] * 6
    mesh = make_mesh(devs, tp=3)
    assert mesh.shape == {"dp": 2, "tp": 3}
    assert mesh.devices == [devs[:3], devs[3:]]
    with pytest.raises(ValueError):
        Mesh([[torch.device("cpu")], []])


def test_no_cuda_raises(monkeypatch):
    """Without CUDA the default mesh and the backend raise; they never fall
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        make_mesh()
    with pytest.raises(BackendUnavailable):
        ShardedBackend()
    with pytest.raises(BackendUnavailable):
        make_backend("cuda-sharded", tp=2)
    with pytest.raises(BackendUnavailable):
        ShardedBackend(make_mesh([torch.device("cuda", 0)] * 2, tp=2))
    with pytest.raises(ValueError):
        ShardedBackend(make_mesh([torch.device("meta")] * 2))
    assert isinstance(make_backend("cuda-sharded", mesh=make_mesh(CPU8)), ShardedBackend)


def test_sharded_refuses_topology_cycles():
    packed = pack_snapshot(synth_cluster(n_nodes=8, n_pending=20, seed=0))
    with pytest.raises(NotImplementedError):
        ShardedBackend(make_mesh(CPU8)).assign(dataclasses.replace(packed, topology=object()), DEFAULT_PROFILE)


def test_constraint_operands_pad_the_node_axis():
    packed = _port_packed(CONSTRAINED, True, 32, 1)
    cons = packed.constraints
    n = packed.padded_nodes
    ops = constraint_operands(cons, n, n + 3)
    assert ops["node_dom_c"].shape == (n + 3, cons.node_dom_c.shape[1])
    assert not ops["node_dom_c"][n:].any()
    for k in ("aa_node_m", "aa_node_c", "pa_node_m", "ppa_node_cnt"):
        assert ops[k].shape[1] == n + 3 and not ops[k][:, n:].any()
        np.testing.assert_array_equal(ops[k][:, :n], cons.state_arrays()[k])
