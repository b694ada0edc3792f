"""The sharded cycle across processes (``parallel/multihost.py``) on the
devices of one machine:

    python -m tpu_scheduler_torch.experiments.multihost_cards [--ranks K] [--devices 0,1] [--shared]
        [--nodes N --pods P --bound B] [--reps R] [--timeout S]

Spawns ``--ranks`` processes of this module on one free 127.0.0.1 port.
Every rank holds as many local devices as ``--devices`` lists: rank ``r``
takes those card indices shifted by ``r`` times their count (``0,1`` with
two ranks: rank 0 cards 0-1, rank 1 cards 2-3), so each card serves one
rank and ``init_distributed`` picks NCCL; with ``--shared`` every rank
takes the list as it is (ranks that share a card: gloo), and ``cpu``
entries make a CPU mesh (gloo).  A rank's devices are its tp row, so dp
crosses the ranks.  Each rank packs the same cluster
(``synth_cluster(nodes, pods, bound, seed 0)``, pod_block 8192, the
``throughput`` profile), unconstrained and with bench.py's constrained
fractions, and runs each through ``ShardedBackend(make_mesh()).schedule``:
a warm-up and ``--reps`` timed cycles, then, on a card, one more under
torch.profiler (the choose kernels' device time against the exchange's host
time).  The parent holds every rank's bindings and rounds against its own
one-process ``CudaBackend`` cycle on the first device.  Prints the card's
name and power limit, one JSON line per rank and case and a last summary
line; exits non-zero on a disagreement, a failed rank or one that outlives
``--timeout`` seconds.  ``chip_smoke.py``'s ``multihost`` phase runs
:func:`spawn` with two ranks sharing ``cuda:0``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..models.profiles import PROFILES
from ..ops import choose as choose_mod
from ..ops.constraints import pack_constraints
from ..ops.pack import pack_snapshot
from ..testing import synth_cluster
from . import card, profiled

__all__ = ["CASES", "cluster", "spawn", "main"]

CASES = ("flagship", "constrained_flagship")
# bench.py's constrained row: every constraint family and extended resources
# on 10 % of the pending pods each.
_CONS = dict(
    anti_affinity_fraction=0.1, spread_fraction=0.1, schedule_anyway_fraction=0.1, pod_affinity_fraction=0.1,
    preferred_pod_affinity_fraction=0.1, extended_fraction=0.1,
)
_PROFILE = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
_COUNTERS = ("LAUNCHES", "LAUNCHES_CONSTRAINED")
_ROOT = pathlib.Path(__file__).resolve().parents[2]
_MODULE = "tpu_scheduler_torch.experiments.multihost_cards"


def cluster(case: str, nodes: int, pods: int, bound: int):
    """The packed cluster of one case, as every rank packs it (the
    constrained case at bench.py's constrained-row budgets)."""
    extra = _CONS if case == "constrained_flagship" else {}
    snap = synth_cluster(n_nodes=nodes, n_pending=pods, n_bound=bound, seed=0, **extra)
    packed = pack_snapshot(snap, pod_block=8192, node_block=128)
    if extra:
        cons = pack_constraints(
            snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes,
            max_aa_terms=256, max_spread=256,
        )
        packed = dataclasses.replace(packed, constraints=cons)
    return packed


def _rank_devices(devices: list, rank: int, shared: bool) -> list:
    """Rank ``rank``'s local devices: CUDA ordinals (ints) or "cpu"."""
    ids = [d if d == "cpu" else int(d) for d in devices]
    if shared:
        return ids
    return [d if d == "cpu" else d + rank * len(ids) for d in ids]


def _rank(args) -> int:
    """One rank: init, the mesh, each case's cycles; its record and each
    case's bindings into ``args.out``."""
    import torch.distributed as dist

    from ..parallel import multihost
    from ..parallel.mesh import distributed_runtime, init_distributed, make_mesh
    from ..parallel.sharded import ShardedBackend

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    torch.set_num_threads(4)
    devices = _rank_devices(args.devices.split(","), args.rank, args.shared)
    on_card = devices[0] != "cpu"
    t0 = time.perf_counter()
    init_distributed(args.coordinator, args.ranks, args.rank, local_device_ids=devices, timeout=args.group_timeout)
    runtime = distributed_runtime()
    mesh = make_mesh(tp=len(devices))
    out = {"rank": args.rank, "backend": runtime.backend, "mesh": [mesh.shape["dp"], mesh.shape["tp"]],
           "row_offset": mesh.row_offset, "devices": [[str(d) for d in row] for row in mesh.devices],
           "init_seconds": time.perf_counter() - t0, "nvidia_smi": card() if on_card else "cpu"}
    for case in CASES:
        t0 = time.perf_counter()
        packed = cluster(case, args.nodes, args.pods, args.bound)
        setup_s = time.perf_counter() - t0
        backend = ShardedBackend(mesh)
        for name in _COUNTERS:
            setattr(choose_mod, name, 0)
        multihost.COLLECTIVES = multihost.COLLECTIVE_BYTES = 0
        multihost.COLLECTIVE_SECONDS = 0.0
        times, results = [], []
        for _ in range(args.reps + 1):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(backend.schedule(packed, _PROFILE))
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res = results[-1]
        rec = {
            "pods": packed.num_pods, "nodes": packed.num_nodes, "padded": [packed.padded_pods, packed.padded_nodes],
            "setup_seconds": setup_s, "rounds": res.rounds, "bound": len(res.bindings),
            "deterministic": all(np.array_equal(r.assigned, res.assigned) and r.rounds == res.rounds for r in results),
            "warmup_seconds": times[0], "seconds": times[1:],
            "launches": {name.lower(): getattr(choose_mod, name) for name in _COUNTERS},
            "collectives": {"calls": multihost.COLLECTIVES, "seconds": multihost.COLLECTIVE_SECONDS,
                            "bytes_sent": multihost.COLLECTIVE_BYTES},
            "collective_ms_per_round": multihost.COLLECTIVE_SECONDS * 1e3 / ((args.reps + 1) * res.rounds),
        }
        if on_card:
            # One more cycle under torch.profiler: the choose kernels'
            # device time against the exchange's host time.
            multihost.COLLECTIVE_SECONDS = 0.0
            wall_ms, rows = profiled(lambda: backend.schedule(packed, _PROFILE))
            busy = sum(r[1] for r in rows)
            choose_ms = sum(r[1] for r in rows if "choose_kernel" in r[0])
            rec["profiled_cycle"] = {
                "wall_ms": wall_ms, "device_idle_share": 1.0 - busy / wall_ms,
                "choose_kernel_ms_per_round": choose_ms / res.rounds,
                "collective_ms_per_round": multihost.COLLECTIVE_SECONDS * 1e3 / res.rounds,
            }
        np.save(pathlib.Path(args.out) / f"rank{args.rank}_{case}.npy", np.asarray(res.assigned))
        out[case] = rec
        del packed, results, res
        if on_card:
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    (pathlib.Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def _sizing(args) -> list:
    return ["--nodes", str(args.nodes), "--pods", str(args.pods), "--bound", str(args.bound), "--reps", str(args.reps),
            "--group-timeout", str(args.group_timeout)]


def spawn(ranks: int, devices: list, shared: bool, out_dir: pathlib.Path, timeout: float, nodes: int = 10_000,
          pods: int = 100_000, bound: int = 20_000, reps: int = 2, group_timeout: float = 120.0) -> list:
    """Run ``ranks`` ranks of this module over ``devices`` (see the module
    text) and return each rank's record, with each case's bindings under
    ``"assigned"``.  Raises RuntimeError when a rank fails or outlives
    ``timeout`` seconds; every rank is killed by then."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    args = argparse.Namespace(nodes=nodes, pods=pods, bound=bound, reps=reps, group_timeout=group_timeout)
    logs = [out_dir / f"rank{r}.log" for r in range(ranks)]
    procs = []
    try:
        for r in range(ranks):
            cmd = [sys.executable, "-m", _MODULE, "--rank", str(r), "--ranks", str(ranks), "--coordinator",
                   coordinator, "--out", str(out_dir), "--devices", ",".join(map(str, devices)), *_sizing(args)]
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(cmd + (["--shared"] if shared else []), stdout=log,
                                              stderr=subprocess.STDOUT, cwd=_ROOT))
        deadline = time.monotonic() + timeout
        for r, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multihost_cards: rank {r} did not end within {timeout} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise RuntimeError(f"multihost_cards: rank {r} exited {proc.returncode}:\n{logs[r].read_text()[-4000:]}")
    records = []
    for r in range(ranks):
        rec = json.loads((out_dir / f"rank{r}.json").read_text())
        for case in CASES:
            rec[case]["assigned"] = np.load(out_dir / f"rank{r}_{case}.npy")
        records.append(rec)
    return records


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(prog="multihost_cards", description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--devices", default="0", help="rank 0's devices: card indices or cpu, comma-separated")
    p.add_argument("--shared", action="store_true", help="every rank takes the same devices")
    p.add_argument("--nodes", type=int, default=10_000)
    p.add_argument("--pods", type=int, default=100_000)
    p.add_argument("--bound", type=int, default=20_000)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--timeout", type=float, default=600.0, help="each rank is killed past this many seconds")
    p.add_argument("--group-timeout", type=float, default=120.0, help="every collective fails after this")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank(args)
    devices = args.devices.split(",")
    on_card = devices[0] != "cpu"
    if on_card and not torch.cuda.is_available():
        print("multihost_cards: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    from ..backends.cuda import CudaBackend

    print(card() if on_card else "cpu", flush=True)
    reference = CudaBackend(device="cuda:0" if on_card else "cpu")
    refs = {}
    for case in CASES:
        r = reference.schedule(cluster(case, args.nodes, args.pods, args.bound), _PROFILE)
        refs[case] = (r.assigned, r.rounds)
    (_ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
        records = spawn(args.ranks, devices, args.shared, pathlib.Path(tmp), args.timeout, args.nodes, args.pods,
                        args.bound, args.reps, args.group_timeout)
    wall = time.perf_counter() - t0
    ok = True
    for rec in records:
        for case in CASES:
            c = rec[case]
            assigned = c.pop("assigned")
            c["equal_to_one_process"] = bool(np.array_equal(assigned, refs[case][0]) and c["rounds"] == refs[case][1])
            ok &= c["equal_to_one_process"] and c["deterministic"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": ok, "ranks": args.ranks, "backend": records[0]["backend"], "mesh": records[0]["mesh"],
                      "seconds": wall}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
