"""Time the bisection kernels #3 and #4 from the package of several
checkouts in one process, to hold a change of ``csrc/bisect.cu`` or its
wrapper against its parent on the same card in the same call:

    python -m tpu_scheduler_torch.experiments.bench_bisect_trees NAME=ROOT [NAME=ROOT ...] [--rounds R] [--reps N]

Each ROOT is a checkout's root (for the parent, ``git archive`` unpacked
into an ignored directory such as ``build/``); its ``tpu_scheduler_torch``
is imported under a name of its own (``bench_choose_trees.load_tree``), so
every tree launches through its own wrapper and its own build of
``bisect.cu`` (into that tree's ``build/torch_kernels/``), while the inputs
are made once, by this checkout, at the experiments' full shape
(``bench_kernel_parts``, ``bench_wide_kernel``: P = 106,496, N = 10,240).
Each tree's output is held bit for bit against this checkout's plain
version; then CUDA events time ``--reps`` calls per round, in ``--rounds``
rounds that visit the trees forwards and backwards in turn: ``ms``, the
whole call (checks and node-side packing included), and ``kernel_ms``, the
launch alone on the prepared node side, for a tree whose wrapper prepares them
(``prepare_parts``/``prepare_wide``; a tree without launches its kernel
straight from the call, and its ``kernel_ms`` times that call).  Prints the
card's name and power limit, one JSON line per tree (build seconds, ptxas
registers and spills) and one per kernel (medians and every round's ms per
tree).  Needs a CUDA device: without one it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys

import torch

from ..ops.bisect import choose_parts_plain, choose_wide_plain
from . import bench_kernel_parts, bench_wide_kernel, card, ptxas_resources, time_cuda
from .bench_choose_trees import load_tree

__all__ = ["load_bisect", "main"]

KERNELS = ("bisect_parts_v0", "bisect_parts_v1", "bisect_parts_v2", "bisect_parts_v3", "bisect_wide")


def load_bisect(name: str, root: str):
    """The ``ops.bisect`` module of the ``tpu_scheduler_torch`` under
    ``root``, imported as part of package ``_tree_<name>``."""
    load_tree(name, root)
    return importlib.import_module(f"_tree_{name}.ops.bisect")


def _calls(mod, variant: int, inputs: tuple) -> tuple:
    """(the whole call, the launch alone on rows prepared once) of one tree."""
    if variant == 4:
        call = lambda: mod.choose_wide(*inputs)  # noqa: E731
        if not hasattr(mod, "prepare_wide"):
            return call, call
        prep = mod.prepare_wide(*inputs)
    else:
        call = lambda: mod.choose_parts(*inputs, variant=variant)  # noqa: E731
        if not hasattr(mod, "prepare_parts"):
            return call, call
        prep = mod.prepare_parts(*inputs, variant=variant)
    return call, lambda: mod.launch_prepared(prep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bisect_trees: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    roots = dict(t.split("=", 1) for t in args.trees)
    print(card(), flush=True)
    trees = {}
    for name, root in roots.items():
        mod = load_bisect(name, root)
        _, seconds, log = mod.build_bisect_library()
        trees[name] = mod
        print(json.dumps({"tree": name, "root": root, "build_seconds": seconds, "ptxas": ptxas_resources(log)}),
              flush=True)

    device = torch.device("cuda")
    parts = bench_kernel_parts.make_inputs(device=device)
    wide = bench_wide_kernel.make_inputs(device=device)
    for variant, kernel in enumerate(KERNELS):
        inputs = wide if variant == 4 else parts
        want = choose_wide_plain(*inputs) if variant == 4 else choose_parts_plain(*inputs, variant)
        calls = {name: _calls(mod, variant, inputs) for name, mod in trees.items()}
        equal = {name: bool(torch.equal(call(), want) and torch.equal(launch(), want))
                 for name, (call, launch) in calls.items()}
        runs = {name: [] for name in trees}
        kernel_runs = {name: [] for name in trees}
        for r in range(args.rounds):
            order = list(trees) if r % 2 == 0 else list(trees)[::-1]
            for name in order:
                runs[name].append(time_cuda(calls[name][0], args.reps))
            for name in order:
                kernel_runs[name].append(time_cuda(calls[name][1], args.reps))
        print(json.dumps({
            "kernel": kernel, "P": int(inputs[0].shape[0]), "N": int(inputs[2 if variant == 4 else 4].shape[1]),
            "equal": equal, "ms": {k: statistics.median(v) for k, v in runs.items()},
            "kernel_ms": {k: statistics.median(v) for k, v in kernel_runs.items()},
            "pods_per_tile": {k: m.pods_per_tile(variant) if hasattr(m, "pods_per_tile") else None
                              for k, m in trees.items()},
            "runs": runs, "kernel_runs": kernel_runs,
        }), flush=True)
        if not all(equal.values()):
            print(f"bench_bisect_trees: a tree disagrees with the plain version on {kernel}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
