"""The port's multi-process sharded cycle (``tpu_scheduler_torch.parallel.
multihost`` over ``torch.distributed``) against the JAX package: two OS
processes rendezvous over gloo on 127.0.0.1, each with ``[cpu] * 4`` as its
local devices, so the mesh is dp = 4 × tp = 2 with tp inside each process and
dp crossing them — the shape of ``tests/multihost_worker.py``.  Each rank's
bindings and rounds must equal, bit for bit, the JAX ``NativeBackend``'s, the
JAX single-process sharded cycle's (``ShardedBackend(make_mesh(tp=2))`` on 8
CPU devices, as the JAX tests run it) and the port's single-process
``ShardedBackend`` over ``[cpu] * 8``: the JAX worker's plain and constrained
clusters and an uneven one whose pods no dp divides.  Also: a rank that
raises ends its peer by the group's timeout; ``init_distributed``'s no-op,
environment and backend rule; the process-major layout and its refusal of a
tp row across ranks.

``init_process_group`` is process-wide, so it runs only in the worker
processes, never in the pytest worker: this file run as a script is the
worker (``python tests/test_torch_multihost.py MODE COORDINATOR WORLD RANK``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tpu_scheduler_torch.models.profiles import DEFAULT_PROFILE  # noqa: E402
from tpu_scheduler_torch.ops.constraints import pack_constraints  # noqa: E402
from tpu_scheduler_torch.ops.pack import pack_snapshot  # noqa: E402
from tpu_scheduler_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpu_scheduler_torch.parallel.mesh import Mesh, choose_backend, make_mesh, process_mesh  # noqa: E402
from tpu_scheduler_torch.parallel.sharded import ShardedBackend  # noqa: E402
from tpu_scheduler_torch.testing import synth_cluster  # noqa: E402

# tests/multihost_worker.py's two clusters, and an uneven constrained one:
# pod_block=1 keeps 61 pods, which no global dp of 4 divides, and 13 nodes,
# which tp=2 does not divide.
CASES = {
    "plain": (dict(n_nodes=16, n_pending=64, n_bound=16, seed=2, tainted_fraction=0.2), False, (16, 8)),
    "constrained": (
        dict(
            n_nodes=16, n_pending=48, n_bound=16, seed=5, anti_affinity_fraction=0.25, spread_fraction=0.25,
            schedule_anyway_fraction=0.2, pod_affinity_fraction=0.2, preferred_pod_affinity_fraction=0.2,
            extended_fraction=0.2,
        ),
        True,
        (16, 8),
    ),
    "uneven": (
        dict(
            n_nodes=13, n_pending=61, n_bound=9, seed=29, anti_affinity_fraction=0.1, spread_fraction=0.1,
            schedule_anyway_fraction=0.1, pod_affinity_fraction=0.05, preferred_pod_affinity_fraction=0.1,
            tainted_fraction=0.1, extended_fraction=0.1,
        ),
        True,
        (1, 1),
    ),
}
MAX_ROUNDS = 16
WORLD = 2
LOCAL_CPUS = 4
# Each child is killed past this; the failing-rank case's group timeout.
CHILD_TIMEOUT_S = 120
FAIL_GROUP_TIMEOUT_S = 10.0


def _packed(build, pack, pack_cons, name: str):
    kw, constrained, (pod_block, node_block) = CASES[name]
    snap = build(**kw)
    packed = pack(snap, pod_block=pod_block, node_block=node_block)
    if constrained:
        cons = pack_cons(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
        assert cons is not None
        packed = dataclasses.replace(packed, constraints=cons)
    return packed


def _port_packed(name: str):
    return _packed(synth_cluster, pack_snapshot, pack_constraints, name)


# ---- worker modes (this file run as a script) ------------------------------


def _worker_init(coordinator: str, world: int, rank: int, timeout: float):
    from tpu_scheduler_torch.parallel.mesh import distributed_runtime, init_distributed

    torch.set_num_threads(1)
    assert init_distributed(coordinator, world, rank, local_device_ids=["cpu"] * LOCAL_CPUS, timeout=timeout)
    return distributed_runtime()


def _worker_cycle(coordinator: str, world: int, rank: int) -> dict:
    """Every case through ``ShardedBackend(make_mesh(tp=2)).schedule``, and
    the uneven one through ``sharded_assign_multihost`` on unpadded nodes."""
    import torch.distributed as dist

    from tpu_scheduler_torch.parallel.multihost import sharded_assign_multihost

    runtime = _worker_init(coordinator, world, rank, 60.0)
    mesh = make_mesh(tp=2)
    out = {
        "rank": rank, "backend": runtime.backend, "mesh": [mesh.shape["dp"], mesh.shape["tp"]],
        "rows": len(mesh.devices), "row_offset": mesh.row_offset, "devices": [[str(d) for d in r] for r in mesh.devices],
    }
    try:
        make_mesh(tp=2 * LOCAL_CPUS)
    except ValueError as e:
        out["cross_rank_refusal"] = str(e)
    backend = ShardedBackend(mesh)
    profile = DEFAULT_PROFILE.with_(max_rounds=MAX_ROUNDS)
    for name in CASES:
        r = backend.schedule(_port_packed(name), profile)
        out[name] = {"assigned": np.asarray(r.assigned).tolist(), "rounds": int(r.rounds)}
    plain = _port_packed("uneven")
    assigned, rounds = sharded_assign_multihost(mesh, plain.device_arrays(), profile.weights(), MAX_ROUNDS)
    out["uneven_unconstrained_raw"] = {"assigned": assigned[: plain.num_pods].tolist(), "rounds": int(rounds)}
    dist.destroy_process_group()
    return out


def _worker_fail(coordinator: str, world: int, rank: int) -> dict:
    """Rank 1 raises before the round's first collective (a non-0/1 bitmap
    in its rows) and stays alive; rank 0 must fail by the group's timeout."""
    runtime = _worker_init(coordinator, world, rank, FAIL_GROUP_TIMEOUT_S)
    packed = _port_packed("plain")
    if rank == 1:
        packed = dataclasses.replace(packed, pod_ntol=np.full_like(packed.pod_ntol, 2))
    t0 = time.perf_counter()
    try:
        ShardedBackend(make_mesh(tp=2)).schedule(packed, DEFAULT_PROFILE.with_(max_rounds=MAX_ROUNDS))
    except (RuntimeError, ValueError) as e:
        out = {"rank": rank, "backend": runtime.backend, "raised": type(e).__name__, "message": str(e)[:400],
               "seconds": time.perf_counter() - t0}
        if rank == 1:
            print(json.dumps(out), flush=True)
            time.sleep(2 * FAIL_GROUP_TIMEOUT_S + 10)  # alive, outside any collective, past rank 0's timeout
        return out
    return {"rank": rank, "raised": None}


def _worker_cli(coordinator: str, world: int, rank: int, argv: list) -> dict:
    """``tpu_scheduler_torch.cli.main`` on ``argv`` (the environment carries
    the rendezvous); the cluster's pod → node map read back from its API."""
    from tpu_scheduler_torch import cli
    from tpu_scheduler_torch.parallel import multihost

    torch.set_num_threads(1)
    apis = []
    make_api = cli.make_api
    cli.make_api = lambda args: apis.append(make_api(args)) or apis[-1]
    rc = cli.main(argv)
    placements = {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name for p in apis[0].list_pods()}
    return {"rank": rank, "rc": rc, "placements": placements, "collectives": multihost.COLLECTIVES}


def _worker_main(argv: list) -> int:
    mode, coordinator, world, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    if mode == "cycle":
        out = _worker_cycle(coordinator, world, rank)
    elif mode == "fail":
        out = _worker_fail(coordinator, world, rank)
    else:
        out = _worker_cli(coordinator, world, rank, argv[4:])
    print("RESULT " + json.dumps(out), flush=True)
    return 0


# ---- the pytest side --------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode: str, world: int = WORLD, extra: tuple = (), env_extra=None) -> list:
    """Start ``world`` workers; return each one's (rc, output, RESULT dict),
    every child killed past CHILD_TIMEOUT_S."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []
    for rank in range(world):
        e = dict(env, **(env_extra(rank, coordinator) if env_extra else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, coordinator, str(world), str(rank), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=e, cwd=ROOT,
        ))
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    results = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{mode} worker did not end within {CHILD_TIMEOUT_S} s")
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            results.append((p.returncode, out, json.loads(lines[-1][7:]) if lines else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@functools.cache
def _two_ranks() -> tuple:
    results = _spawn("cycle")
    for rc, out, res in results:
        assert rc == 0 and res is not None, out[-3000:]
    return tuple(res for _, _, res in results)


@functools.cache
def _references(name: str) -> dict:
    """(assigned, rounds) of the JAX NativeBackend, the JAX single-process
    sharded cycle on 8 CPU devices, and the port's single-process
    ShardedBackend over [cpu] * 8."""
    from tpu_scheduler.backends.native import NativeBackend
    from tpu_scheduler.models.profiles import DEFAULT_PROFILE as JAX_DEFAULT
    from tpu_scheduler.ops.constraints import pack_constraints as jax_pack_constraints
    from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
    from tpu_scheduler.parallel.mesh import make_mesh as jax_make_mesh
    from tpu_scheduler.parallel.sharded import ShardedBackend as JaxShardedBackend
    from tpu_scheduler.testing import synth_cluster as jax_synth

    jax_packed = _packed(jax_synth, jax_pack, jax_pack_constraints, name)
    jax_profile = JAX_DEFAULT.with_(max_rounds=MAX_ROUNDS)
    refs = {
        "native": NativeBackend().schedule(jax_packed, jax_profile),
        "jax_sharded": JaxShardedBackend(jax_make_mesh(tp=2)).schedule(jax_packed, jax_profile),
        "port_sharded": ShardedBackend(make_mesh([torch.device("cpu")] * 8, tp=2)).schedule(
            _port_packed(name), DEFAULT_PROFILE.with_(max_rounds=MAX_ROUNDS)
        ),
    }
    return {k: (np.asarray(r.assigned), int(r.rounds)) for k, r in refs.items()}


@pytest.mark.parametrize("reference", ["native", "jax_sharded", "port_sharded"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_process_cycle_matches(name, reference):
    ref_assigned, ref_rounds = _references(name)[reference]
    for res in _two_ranks():
        np.testing.assert_array_equal(np.asarray(res[name]["assigned"]), ref_assigned, err_msg=f"rank {res['rank']}")
        assert res[name]["rounds"] == ref_rounds, res["rank"]
    assert (ref_assigned >= 0).any()


def test_two_process_raw_multihost_call_pads_nodes():
    """``sharded_assign_multihost`` on the uneven cluster's unpadded 13
    nodes (tp padding inside) equals the oracle on both ranks."""
    from tpu_scheduler.backends.native import NativeBackend
    from tpu_scheduler.models.profiles import DEFAULT_PROFILE as JAX_DEFAULT

    packed = _port_packed("uneven")
    ref = NativeBackend().schedule(_jax_uneven_unconstrained(), JAX_DEFAULT.with_(max_rounds=MAX_ROUNDS))
    assert packed.padded_nodes % 2 == 1 and packed.padded_pods % 4
    for res in _two_ranks():
        np.testing.assert_array_equal(res["uneven_unconstrained_raw"]["assigned"], ref.assigned)
        assert res["uneven_unconstrained_raw"]["rounds"] == ref.rounds


def _jax_uneven_unconstrained():
    from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
    from tpu_scheduler.testing import synth_cluster as jax_synth

    kw, _, (pod_block, node_block) = CASES["uneven"]
    return jax_pack(jax_synth(**kw), pod_block=pod_block, node_block=node_block)


def test_two_process_mesh_is_process_major():
    """Rank r owns dp rows [2r, 2r + 2) of the (4, 2) mesh, each tp row of
    its own CPU devices; gloo, as on any CPU mesh; a tp row wider than a
    rank's devices is refused."""
    ranks = _two_ranks()
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["mesh"] == [4, 2] and r["rows"] == 2 and r["row_offset"] == 2 * r["rank"]
        assert r["devices"] == [["cpu", "cpu"], ["cpu", "cpu"]]
        assert "would cross ranks" in r["cross_rank_refusal"]
    for name in CASES:
        assert ranks[0][name] == ranks[1][name]


def test_failing_rank_ends_its_peer_by_the_group_timeout():
    """Rank 1 raises and stays alive outside the collective; rank 0 does not
    hang: its first collective fails after the 10 s group timeout."""
    t0 = time.perf_counter()
    results = _spawn("fail")
    wall = time.perf_counter() - t0
    (rc0, out0, res0), (_, out1, _) = results
    assert rc0 == 0 and res0 is not None, out0[-3000:]
    assert res0["raised"] == "RuntimeError", res0
    assert FAIL_GROUP_TIMEOUT_S * 0.8 <= res0["seconds"] < FAIL_GROUP_TIMEOUT_S + 30, res0
    raised1 = json.loads(next(ln for ln in out1.splitlines() if ln.startswith("{")))
    assert raised1["raised"] == "ValueError" and "bitmap" in raised1["message"], raised1
    assert wall < CHILD_TIMEOUT_S


def test_multihost_cards_experiment_on_cpu(capsys):
    """``experiments/multihost_cards`` (what ``chip_smoke.py``'s multihost
    phase spawns) on two CPU ranks at a small size: both cases of every rank
    equal to the one-process cycle, two collectives a round and one at the
    end."""
    from tpu_scheduler_torch.experiments import multihost_cards

    rc = multihost_cards.main(["--ranks", "2", "--devices", "cpu,cpu", "--nodes", "40", "--pods", "300",
                               "--bound", "20", "--reps", "1", "--timeout", str(CHILD_TIMEOUT_S)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert rc == 0 and lines[-1] == {**lines[-1], "ok": True, "ranks": 2, "backend": "gloo", "mesh": [2, 2]}
    for rank, rec in enumerate(lines[:-1]):
        assert rec["rank"] == rank and rec["row_offset"] == rank
        for case in multihost_cards.CASES:
            c = rec[case]
            assert c["equal_to_one_process"] and c["bound"] > 0
            # The plain versions ran (CPU tensors): no kernel launch counted.
            assert c["launches"] == {"launches": 0, "launches_constrained": 0}
            assert c["collectives"]["calls"] == 2 * (2 * c["rounds"] + 1)  # warm-up + 1 rep


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for k in ("SCHED_COORDINATOR", "SCHED_NUM_PROCESSES", "SCHED_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.init_distributed() is False
    monkeypatch.setenv("SCHED_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SCHED_NUM_PROCESSES", "1")
    assert mesh_mod.init_distributed() is False
    assert not dist.is_initialized() and mesh_mod.distributed_runtime() is None


def test_distributed_config_reads_the_environment(monkeypatch):
    for k in ("SCHED_COORDINATOR", "SCHED_NUM_PROCESSES", "SCHED_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.distributed_config() == (None, 1, 0)
    monkeypatch.setenv("SCHED_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("SCHED_NUM_PROCESSES", "4")
    monkeypatch.setenv("SCHED_PROCESS_ID", "3")
    assert mesh_mod.distributed_config() == ("10.0.0.1:1234", 4, 3)
    # Arguments win over the environment.
    assert mesh_mod.distributed_config("h:1", 2, 1) == ("h:1", 2, 1)


@pytest.mark.parametrize(
    "identities, requested, expected",
    [
        ([("h", ["cpu"] * 4), ("h", ["cpu"] * 4)], None, "gloo"),
        ([("h", ["GPU-a"]), ("h", ["GPU-a"])], None, "gloo"),  # two ranks on one card
        ([("h", ["GPU-a"]), ("h", ["GPU-b"])], None, "nccl"),
        ([("h", ["GPU-a"]), ("g", ["GPU-a"])], None, "nccl"),  # the same id on two hosts
        ([("h", ["GPU-a", "GPU-a"]), ("h", ["GPU-b"])], None, "nccl"),  # a rank repeating its own card
        ([("h", []), ("h", ["GPU-b"])], None, "gloo"),
        ([("h", ["GPU-a"]), ("h", ["GPU-b"])], "gloo", "gloo"),
    ],
)
def test_backend_rule(identities, requested, expected):
    assert choose_backend(identities, requested)[0] == expected


@pytest.mark.parametrize("identities", [[("h", ["GPU-a"]), ("h", ["GPU-a"])], [("h", ["cpu"]), ("h", ["cpu"])]])
def test_backend_rule_refuses_nccl_it_cannot_hold(identities):
    with pytest.raises(ValueError, match="cannot hold"):
        choose_backend(identities, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        choose_backend(identities, "mpi")


def test_process_major_layout_and_refusal():
    cpu4 = [torch.device("cpu")] * 4
    m = process_mesh(cpu4, 2, 1, 2)
    assert m.shape == {"dp": 4, "tp": 2} and m.row_offset == 2 and len(m.devices) == 2
    assert process_mesh(cpu4, None, 0, 3).shape == {"dp": 6, "tp": 2}
    assert process_mesh(cpu4, 4, 2, 3).row_offset == 2
    for tp in (8, 3):
        with pytest.raises(ValueError, match="would cross ranks"):
            process_mesh(cpu4, tp, 0, 2)
    with pytest.raises(ValueError):
        Mesh([cpu4[:2]], process_index=2, process_count=2)


def test_single_process_mesh_is_refused_by_multihost_and_vice_versa():
    from tpu_scheduler_torch.parallel.multihost import sharded_assign_multihost
    from tpu_scheduler_torch.parallel.sharded import sharded_assign_cycle

    packed = _port_packed("plain")
    with pytest.raises(RuntimeError, match="no multi-process runtime"):
        sharded_assign_multihost(make_mesh([torch.device("cpu")] * 4, tp=2), packed.device_arrays(), [1.0] * 8)
    with pytest.raises(ValueError, match="multi-process mesh"):
        sharded_assign_cycle(process_mesh([torch.device("cpu")] * 4, 2, 0, 2), packed.device_arrays(), [1.0] * 8)


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
