"""The port's eager ``assign_cycle`` on the CPU vs the JAX package's jitted
``assign_cycle``: the same NumPy inputs must give equal ``assigned``,
``rounds``, remaining capacity, ``acc_round`` and ``rank_of`` — bit for
bit — across the parity shapes of tests/test_backends_parity.py, block
padding, negative priorities, contention, int32-saturating demand,
degenerate clusters, the round cap, the size chain and every profile."""

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
from tpu_scheduler_torch.ops.assign import _size_chain, assign_cycle, split_device_arrays  # noqa: E402


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
