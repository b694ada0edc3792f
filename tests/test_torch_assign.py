"""The port's eager ``assign_cycle`` on the CPU vs the JAX package's jitted
``assign_cycle``: the same NumPy inputs must give equal ``assigned``,
``rounds``, remaining capacity, ``acc_round`` and ``rank_of`` — bit for
bit — across the parity shapes of tests/test_backends_parity.py, block
padding, negative priorities, contention, int32-saturating demand,
degenerate clusters, the round cap, the size chain and every profile.  The
port's sixth output, the pods a stop cut off, is its own (the last tests)."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_scheduler.core.snapshot import ClusterSnapshot  # noqa: E402
from tpu_scheduler.models.profiles import DEFAULT_PROFILE, PROFILES  # noqa: E402
from tpu_scheduler.ops.assign import assign_cycle as jax_assign_cycle  # noqa: E402
from tpu_scheduler.ops.pack import pack_snapshot  # noqa: E402
from tpu_scheduler.testing import make_node, make_pod, synth_cluster  # noqa: E402
from tpu_scheduler_torch.ops.assign import CUT_OFF_CAUSES, _size_chain, assign_cycle, split_device_arrays  # noqa: E402


def _both(packed, weights=None, max_rounds=32, block=32):
    """Run both cycles on one packed cluster; assert every output equal and
    return the port's (assigned, rounds)."""
    weights = DEFAULT_PROFILE.weights() if weights is None else weights
    arrays = packed.device_arrays()
    jn, jp = split_device_arrays({k: jnp.asarray(v) for k, v in arrays.items()})
    ref = jax_assign_cycle(jn, jp, jnp.asarray(weights), max_rounds=max_rounds, block=block)
    tn, tp = split_device_arrays({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
    got = assign_cycle(tn, tp, weights, max_rounds=max_rounds, block=block)
    names = ("assigned", "rounds", "avail", "acc_round", "rank_of")
    for name, r, g in zip(names, ref, got):
        if name == "rounds":
            assert isinstance(g, int) and g == int(r), name
        else:
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    return got[0].numpy(), got[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(5, 10), (16, 100), (64, 500)])
def test_assign_matches_jax(seed, shape):
    n_nodes, n_pending = shape
    packed = pack_snapshot(synth_cluster(n_nodes=n_nodes, n_pending=n_pending, n_bound=n_nodes, seed=seed))
    _both(packed, block=128)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_block_padding(seed):
    """p % block != 0: the cycle pads to a block multiple after the
    priority permutation, leaving real ranks intact."""
    packed = pack_snapshot(
        synth_cluster(n_nodes=12, n_pending=37, n_bound=12, seed=seed), pod_block=1, node_block=1
    )
    assert packed.padded_pods % 16
    _both(packed, block=16)


def test_assign_negative_priorities():
    nodes = [make_node(f"n{i}", cpu="2", memory="4Gi") for i in range(3)]
    pods = [make_pod(f"p{i}", cpu="500m", memory="512Mi", priority=(i % 5) - 3) for i in range(23)]
    packed = pack_snapshot(ClusterSnapshot.build(nodes, pods), pod_block=1, node_block=1)
    assigned, _ = _both(packed, block=8)
    assert (assigned >= 0).sum() == 12  # 3 nodes × 4 pods of 500m


def test_assign_contention_single_node():
    node = make_node("n0", cpu="4", memory="64Gi")
    pods = [make_pod(f"p{i}", cpu="1", memory="1Gi", priority=i) for i in range(6)]
    assigned, _ = _both(pack_snapshot(ClusterSnapshot.build([node], pods)))
    assert set(np.flatnonzero(assigned[:6] >= 0)) == {2, 3, 4, 5}


def test_assign_saturating_demand():
    """Per-node claim prefixes beyond INT32_MAX KiB must saturate, not wrap:
    1000Gi pods against 2047Gi nodes (just under INT32_MAX KiB)."""
    nodes = [make_node(f"n{i}", cpu="64", memory="2047Gi") for i in range(3)]
    pods = [make_pod(f"p{i}", cpu="1", memory="1000Gi", priority=i % 3) for i in range(40)]
    packed = pack_snapshot(ClusterSnapshot.build(nodes, pods))
    assert int(packed.pod_req[:, 1].astype(np.int64).sum()) > 2**31
    assigned, _ = _both(packed, max_rounds=64)
    assert (assigned >= 0).sum() == 6


def test_assign_demand_far_above_capacity():
    packed = pack_snapshot(synth_cluster(n_nodes=8, n_pending=400, seed=11, selector_fraction=0.3))
    _both(packed, max_rounds=256, block=64)


def test_assign_size_chain_stages():
    """Enough pods for a three-stage size chain (2048 → 512 → 256)."""
    packed = pack_snapshot(synth_cluster(n_nodes=16, n_pending=2000, seed=9), pod_block=64)
    assert _size_chain(packed.padded_pods, 64) == [2048, 512, 256]
    _both(packed, max_rounds=64, block=64)


def test_assign_round_cap_latch():
    """A cycle cut by max_rounds leaves the still-active pods unassigned in
    every later stage (the terminal latch)."""
    packed = pack_snapshot(synth_cluster(n_nodes=16, n_pending=2000, seed=9), pod_block=64)
    _, rounds = _both(packed, max_rounds=2, block=64)
    assert rounds == 2


def test_assign_empty_cluster():
    packed = pack_snapshot(ClusterSnapshot.build([], [make_pod("p")]))
    assigned, rounds = _both(packed)
    assert (assigned == -1).all() and rounds == 1


def test_assign_no_pending_pods():
    packed = pack_snapshot(ClusterSnapshot.build([make_node("n")], []))
    assigned, rounds = _both(packed)
    assert (assigned == -1).all() and rounds == 0


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_assign_every_profile(profile):
    """The cluster of the JAX package's own cross-profile parity test.
    (With soft taints under "most-requested", XLA's CPU code contracts
    multiply-adds into FMAs and the jitted JAX cycle drifts from its NumPy
    oracle; tests/test_torch_backend.py holds the port to the oracle there.)"""
    packed = pack_snapshot(synth_cluster(n_nodes=24, n_pending=200, n_bound=48, seed=5))
    _both(packed, PROFILES[profile].weights(), max_rounds=64, block=64)


@pytest.mark.parametrize("value", [2.0, 0.5, -1.0])
@pytest.mark.parametrize("key", [
    "pod_sel", "pod_ntol", "pod_aff", "pod_ntol_soft",
    "node_labels", "node_taints", "node_aff", "node_pref", "node_taints_soft",
])
def test_assign_rejects_non_binary_bitmap(key, value):
    """The choose kernels count bits, so assign_cycle checks every bitmap
    operand once per cycle, before any round, and raises ValueError naming
    the one that is not 0/1 — on the CPU as on the card."""
    packed = pack_snapshot(synth_cluster(n_nodes=6, n_pending=20, n_bound=6, seed=1, soft_taint_fraction=0.5,
                                         preferred_affinity_fraction=0.5))
    arrays = {k: np.array(v) for k, v in packed.device_arrays().items()}
    arrays[key][0, -1] = value
    nodes, pods = split_device_arrays({k: torch.from_numpy(v) for k, v in arrays.items()})
    with pytest.raises(ValueError, match=f"^{key}: holds {value!r}"):
        assign_cycle(nodes, pods, DEFAULT_PROFILE.weights())


def _cut_off(packed, max_rounds, block):
    arrays = packed.device_arrays()
    tn, tp = split_device_arrays({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
    out = assign_cycle(tn, tp, DEFAULT_PROFILE.weights(), max_rounds=max_rounds, block=block)
    return out[0].numpy(), out[5].numpy()


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_assign_reports_the_pods_the_round_cap_cut_off(max_rounds):
    """The port's sixth output, beside the JAX package's five: each pod
    still active when the round cap stopped the cycle ("round_cap").  Every
    other unassigned pod found no feasible node in some round, so a longer
    cycle, the same up to the cap, leaves it unassigned too; every pod the
    longer cycle places beyond those was cut off."""
    packed = pack_snapshot(synth_cluster(n_nodes=16, n_pending=2000, seed=9), pod_block=64)
    _both(packed, max_rounds=max_rounds, block=64)
    assigned, cut_off = _cut_off(packed, max_rounds, 64)
    longer, never = _cut_off(packed, 64, 64)
    assert not never.any()  # the longer cycle ends before its cap
    assert set(np.unique(cut_off)) == {0, CUT_OFF_CAUSES.index("round_cap")}
    assert (assigned[cut_off > 0] == -1).all()
    n = packed.num_pods
    proofs = (assigned[:n] < 0) & (cut_off[:n] == 0)
    assert (longer[:n][proofs] < 0).all()
    assert (cut_off[:n][(longer[:n] >= 0) & (assigned[:n] < 0)] > 0).all()


def test_assign_reports_the_pods_a_stall_cut_off(monkeypatch):
    """A constrained cycle whose filter defers every claim stops after
    STALL_ROUNDS rounds: every pod was still active, so every one is cut
    off ("stall") and none is a proof."""
    import dataclasses

    import tpu_scheduler_torch.ops.assign as assign_mod
    from tpu_scheduler_torch.backends.cuda import CudaBackend
    from tpu_scheduler_torch.ops.constraints import pack_constraints
    from tpu_scheduler_torch.ops.pack import STALL_ROUNDS
    from tpu_scheduler_torch.ops.pack import pack_snapshot as t_pack
    from tpu_scheduler_torch.testing import synth_cluster as t_synth

    snap = t_synth(n_nodes=12, n_pending=48, n_bound=12, seed=2, anti_affinity_fraction=0.2, spread_fraction=0.2)
    packed = t_pack(snap)
    cons = pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    monkeypatch.setattr(assign_mod, "constraint_filter", lambda accepted, *a, **k: torch.zeros_like(accepted))
    result = CudaBackend(device="cpu").schedule(dataclasses.replace(packed, constraints=cons), DEFAULT_PROFILE)
    assert result.rounds == STALL_ROUNDS and not result.bindings
    assert result.cut_off == dict.fromkeys(result.unschedulable, "stall") and len(result.unschedulable) == 48


def test_spread_fill_places_hard_spread_pods_the_level_term_herds():
    """Zone z0's nodes are empty and the others' a quarter full: under the
    level term, LeastRequested draws each Deployment's hard-spread pods
    onto z0, above its water line, and the auction stalls after one pod a
    Deployment.  The water-fill steering (``spread_fill``, the port's own,
    for a cycle that retries pods a stop cut off) sends a Deployment's
    pods to the zones in the order the filter admits them: one round
    places all 36, and every zone ends with 4 pods of each Deployment."""
    import dataclasses

    from tpu_scheduler_torch.api.objects import TopologySpreadConstraint
    from tpu_scheduler_torch.backends.cuda import CudaBackend
    from tpu_scheduler_torch.core.snapshot import ClusterSnapshot as TSnapshot
    from tpu_scheduler_torch.ops.constraints import pack_constraints
    from tpu_scheduler_torch.ops.pack import pack_snapshot as t_pack
    from tpu_scheduler_torch.testing import make_node as t_node, make_pod as t_pod

    nodes = [t_node(f"n{i}", cpu="8", memory="32Gi", labels={"zone": f"z{i % 3}"}) for i in range(9)]
    base = [t_pod(f"base-{i}", cpu="2", memory="4Gi", node_name=f"n{i}", phase="Running") for i in range(9) if i % 3]
    pods = []
    for d in range(3):
        spread = [TopologySpreadConstraint(topology_key="zone", max_skew=1, match_labels={"app": f"web-{d}"})]
        pods += [t_pod(f"web-{d}-{i}", cpu="100m", memory="128Mi", labels={"app": f"web-{d}"}, topology_spread=spread)
                 for i in range(12)]
    snap = TSnapshot.build(nodes, base + pods)
    packed = t_pack(snap)
    cons = pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    results = {}
    for fill in (False, True):
        cycle = dataclasses.replace(packed, constraints=dataclasses.replace(cons, spread_fill=fill))
        results[fill] = CudaBackend(device="cpu").schedule(cycle, DEFAULT_PROFILE)
    herded, filled = results[False], results[True]
    assert len(herded.bindings) == 3 and set(herded.cut_off.values()) == {"stall"}
    assert filled.rounds == 1 and len(filled.bindings) == 36 and not filled.cut_off
    zones = {}
    for pod, node in filled.bindings:
        key = (pod.rsplit("-", 1)[0], int(node[1:]) % 3)
        zones[key] = zones.get(key, 0) + 1
    assert sorted(zones.values()) == [4] * 9


@pytest.mark.parametrize("per_deployment,bout_above", [(60, 256), (100, 256), (100, None)])
def test_a_stop_with_a_residue_beyond_the_mopup_runs_a_fill_bout(per_deployment, bout_above):
    """The level term herds the hard-spread pods as in the test above and
    the auction stalls with nearly all of them active.  Under a threshold
    of 256 (``fill_bout_above``, the controller's stall mop-up cap below
    1,953 nodes), three Deployments of 60 pods (180 active, within the
    mop-up's reach) are cut off, as the JAX package's auction leaves them;
    three of 100 (300 active) get a bout of max_rounds more rounds under
    the water-fill steering, which places every pod, each zone holding a
    third of every Deployment.  Without a threshold there is no bout."""
    import dataclasses

    from tpu_scheduler_torch.api.objects import TopologySpreadConstraint
    from tpu_scheduler_torch.backends.cuda import CudaBackend
    from tpu_scheduler_torch.core.snapshot import ClusterSnapshot as TSnapshot
    from tpu_scheduler_torch.ops.constraints import pack_constraints
    from tpu_scheduler_torch.ops.pack import pack_snapshot as t_pack
    from tpu_scheduler_torch.testing import make_node as t_node, make_pod as t_pod

    nodes = [t_node(f"n{i}", cpu="32", memory="64Gi", labels={"zone": f"z{i % 3}"}) for i in range(9)]
    base = [t_pod(f"base-{i}", cpu="8", memory="8Gi", node_name=f"n{i}", phase="Running") for i in range(9) if i % 3]
    pods = []
    for d in range(3):
        spread = [TopologySpreadConstraint(topology_key="zone", max_skew=1, match_labels={"app": f"web-{d}"})]
        pods += [t_pod(f"web-{d}-{i}", cpu="100m", memory="128Mi", labels={"app": f"web-{d}"}, topology_spread=spread)
                 for i in range(per_deployment)]
    snap = TSnapshot.build(nodes, base + pods)
    packed = t_pack(snap)
    cons = pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    cons = dataclasses.replace(cons, fill_bout_above=bout_above)
    result = CudaBackend(device="cpu").schedule(dataclasses.replace(packed, constraints=cons), DEFAULT_PROFILE)
    if bout_above is None or 3 * per_deployment <= bout_above:
        assert len(result.bindings) == 3 and set(result.cut_off.values()) == {"stall"}
        assert len(result.cut_off) == 3 * per_deployment - 3
        return
    assert not result.cut_off and len(result.bindings) == 3 * per_deployment
    zones = {}
    for pod, node in result.bindings:
        key = (pod.rsplit("-", 1)[0], int(node[1:]) % 3)
        zones[key] = zones.get(key, 0) + 1
    assert sorted(zones.values()) == [33] * 6 + [34] * 3
