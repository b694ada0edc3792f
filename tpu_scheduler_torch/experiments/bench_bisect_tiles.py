"""Time the bisection kernels #3 and #4 at other pods per tile, in one
process: copies of ``csrc/bisect.cu`` whose tile table (``kTilePods``)
gives every variant one size, each built by an ``nvcc`` of its own (all
started together) into ``build/torch_kernels/<source digest>/``, beside this
checkout's own build (the adopted size of each variant):

    python -m tpu_scheduler_torch.experiments.bench_bisect_tiles [--pods 4,8,16,32] [--rounds R] [--reps N]

The copies are written under ``build/bisect_tiles/``.  The inputs are the
experiments' full shape (``bench_kernel_parts``, ``bench_wide_kernel``: P =
106,496, N = 10,240), checked and packed once per kernel
(``ops/bisect.prepare_parts``/``prepare_wide``); each build's output is held
bit for bit against the plain version, then CUDA events time ``--reps``
launches per round on the same prepared rows, in ``--rounds`` rounds that
visit the builds forwards and backwards in turn.  Prints the card's name and
power limit, one JSON line per build (the ptxas registers and spills of each
instance) and one per kernel (the median and every round's ms per build).
Needs a CUDA device: without one it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import bisect as bisect_mod
from ..ops.choose import _PKG, build_library
from . import bench_kernel_parts, bench_wide_kernel, card, ptxas_resources, time_cuda
from .bench_bisect_trees import KERNELS

__all__ = ["tile_source", "main"]

_TABLE = re.compile(r"constexpr int kTilePods\[5\] = \{[^}]*\};")


def tile_source(source: str, pods: int) -> str:
    """``source`` (``csrc/bisect.cu``) with ``pods`` pods per tile for every
    variant."""
    out, count = _TABLE.subn(f"constexpr int kTilePods[5] = {{{', '.join([str(pods)] * 5)}}};", source)
    if count != 1:
        raise ValueError("bisect.cu: the tile table kTilePods was not found once")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", default="4,8,16,32")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bisect_tiles: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    source = bisect_mod._SOURCE
    sources = {"adopted": source}
    for pods in (int(x) for x in args.pods.split(",")):
        path = _PKG.parent / "build" / "bisect_tiles" / f"pods_{pods}" / "bisect.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(tile_source(source.read_text(), pods))
        sources[f"pods_{pods}"] = path
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(build_library, path, bisect_mod._LIB_NAME) for name, path in sources.items()}
        built = {name: f.result() for name, f in futures.items()}
    libs = {}
    for name, (path, seconds, log) in built.items():
        libs[name] = bisect_mod.bind_bisect_library(path)
        print(json.dumps({"build": name, "build_seconds": seconds, "ptxas": ptxas_resources(log)}), flush=True)

    device = torch.device("cuda")
    parts = bench_kernel_parts.make_inputs(device=device)
    wide = bench_wide_kernel.make_inputs(device=device)
    for variant, kernel in enumerate(KERNELS):
        if variant == 4:
            prep, want = bisect_mod.prepare_wide(*wide), bisect_mod.choose_wide_plain(*wide)
        else:
            prep, want = bisect_mod.prepare_parts(*parts, variant=variant), bisect_mod.choose_parts_plain(*parts, variant)
        calls = {name: (lambda lib=lib: bisect_mod.launch_prepared(prep, lib)) for name, lib in libs.items()}  # noqa: B023
        equal = {name: bool(torch.equal(fn(), want)) for name, fn in calls.items()}
        runs = {name: [] for name in libs}
        for r in range(args.rounds):
            for name in list(libs) if r % 2 == 0 else list(libs)[::-1]:
                runs[name].append(time_cuda(calls[name], args.reps))
        print(json.dumps({
            "kernel": kernel, "live_rows": len(prep.live), "equal": equal,
            "pods_per_tile": {name: bisect_mod.pods_per_tile(variant, lib) for name, lib in libs.items()},
            "kernel_ms": {k: statistics.median(v) for k, v in runs.items()}, "runs": runs,
        }), flush=True)
        if not all(equal.values()):
            print(f"bench_bisect_tiles: a build disagrees with the plain version on {kernel}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
