"""Time kernel #1 (the unconstrained choose) from several builds of
``csrc/choose.cu`` in one process, to compare two designs on the same card
in the same call:

    python -m tpu_scheduler_torch.experiments.bench_choose_builds [NAME=SOURCE ...] [--rounds R] [--reps N]

Each SOURCE is a ``choose.cu`` with this checkout's launcher interface
(default: the checkout's own, as ``this``).  Every build is made at once (one
``nvcc`` each), held bit for bit against the plain version on every case,
then timed by CUDA events in ``--rounds`` rounds that visit the builds
forwards and backwards in turn.  Cases: the flagship block (8192 pods of the
100k x 10k flagship against its 10,112 nodes, the ``throughput`` profile:
jitter 32, a power of two), the same block with a jitter of 0.3 (the
division) and with none, and kernel #2b's shard shape (53,248 x 5,056,
node_offset 5,056).  Prints the card's name and power limit, one JSON line
per build (build seconds, ptxas registers and spills) and one per case
(median and every round's ms per build).  Needs a CUDA device: without one
it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..convert import to_device
from ..models.profiles import PROFILES
from ..ops import choose as choose_mod
from ..ops.pack import pack_snapshot
from ..testing import synth_cluster
from . import card, ptxas_resources, time_cuda

__all__ = ["flagship_cases", "main"]

POD_KEYS = (
    "pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff", "pod_has_aff", "pod_pref_w", "pod_ntol_soft",
)
NODE_KEYS = (
    "node_avail", "node_alloc", "node_valid", "node_labels", "node_taints", "node_aff", "node_pref",
    "node_taints_soft",
)


def _block(arrays: dict, lo: int, hi: int, n_lo: int, n_hi: int) -> list:
    """choose_block's positional tensors for pod rows [lo, hi) against node
    rows [n_lo, n_hi) (ranks = row index, active = pod_valid)."""
    d = arrays["pod_req"].device
    pods = [arrays[k][lo:hi].contiguous() for k in POD_KEYS]
    ranks = torch.arange(lo, hi, dtype=torch.int32, device=d)
    return pods + [arrays["pod_valid"][lo:hi].contiguous(), ranks] + [arrays[k][n_lo:n_hi] for k in NODE_KEYS]


def flagship_cases(device) -> list[tuple[str, list, object, int, int]]:
    """(name, args, weights, salt, node_offset) of each timed case, on
    ``device``."""
    packed = pack_snapshot(
        synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0), pod_block=8192, node_block=128
    )
    arrays = to_device(packed, device)
    n = packed.padded_nodes
    flag = _block(arrays, 0, 8192, 0, n)
    shard = _block(arrays, 0, packed.padded_pods // 2, n // 2, 2 * (n // 2))
    thr = PROFILES["throughput"]
    return [
        ("flagship_block", flag, thr.weights(), 1, 0),
        ("flagship_block_jitter_0.3", flag, thr.with_(spread_jitter=0.3).weights(), 1, 0),
        ("flagship_block_no_jitter", flag, thr.with_(spread_jitter=0.0).weights(), 1, 0),
        ("shard_53248x5056", shard, thr.weights(), 1, n // 2),
    ]


@contextlib.contextmanager
def _using(lib):
    """choose_block launches from ``lib`` inside the block."""
    saved = choose_mod._library
    choose_mod._library = lambda: lib
    try:
        yield
    finally:
        choose_mod._library = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("builds", nargs="*", metavar="NAME=SOURCE")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_choose_builds: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    sources = dict(b.split("=", 1) for b in args.builds) or {"this": str(choose_mod._SOURCE)}
    print(card(), flush=True)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {
            name: pool.submit(choose_mod.build_library, pathlib.Path(src).resolve(), f"libchoose_{name}.so")
            for name, src in sources.items()
        }
        built = {name: f.result() for name, f in futures.items()}
    libs = {}
    for name, (path, seconds, log) in built.items():
        libs[name] = choose_mod.bind_library(path)
        print(json.dumps({"build": name, "source": sources[name], "build_seconds": seconds,
                          "ptxas": ptxas_resources(log)}), flush=True)

    device = torch.device("cuda")
    cases = flagship_cases(device)
    for case, a, w, salt, off in cases:
        want = choose_mod.choose_block_plain(*a, w, salt, node_offset=off)
        words = choose_mod.pack_node_words(*a[13:18])
        equal, runs = {}, {name: [] for name in libs}
        for name, lib in libs.items():
            with _using(lib):
                got = choose_mod.choose_block(*a, w, salt, node_offset=off, node_words=words)
            equal[name] = (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
                           and torch.equal(got[2][got[1]].view(torch.int32), want[2][want[1]].view(torch.int32)))
        for r in range(args.rounds):
            for name in list(libs) if r % 2 == 0 else list(libs)[::-1]:
                with _using(libs[name]):
                    runs[name].append(time_cuda(
                        lambda: choose_mod.choose_block(*a, w, salt, node_offset=off, node_words=words),  # noqa: B023
                        args.reps))
        print(json.dumps({
            "case": case, "B": int(a[0].shape[0]), "N": int(a[10].shape[0]), "node_offset": off,
            "jitter": float(w[2]), "equal": equal, "ms": {k: statistics.median(v) for k, v in runs.items()},
            "runs": runs,
        }), flush=True)
        if not all(equal.values()):
            print(f"bench_choose_builds: a build disagrees with the plain version on {case}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
