"""The choose with the pod features packed into ONE wide [P, 64] float32
operand (+ one [P, 8] int32), on the card (``ops/bisect.choose_wide``) —
the counterpart of ``scripts/bench_wide_kernel.py``, the layout experiment
of the JAX package's kernel work.

    python -m tpu_scheduler_torch.experiments.bench_wide_kernel [--reps N] [--seed S]

Prints the card's name and power limit, then the ms of a call (the checks
and node-side packing included), of a launch alone on the prepared node side, and
Gpair/s.  The inputs
come from a seeded ``torch.Generator`` (the script's layout and
distributions).  Needs a CUDA device: without one it exits 1 and measures
nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.bisect import WIDE_SELC_COL, choose_wide, launch_prepared, pods_per_tile, prepare_wide
from . import card, time_cuda

__all__ = ["P", "N", "F", "make_inputs", "measure", "main"]

P, N = 106_496, 10_240
F = 64  # wide float32 feature width: sel 0:8, …, selector count 40


def make_inputs(p: int = P, n: int = N, f: int = F, seed: int = 0, device="cpu") -> tuple:
    """(pod_i32 [p,8], pod_f32 [p,f], info [8,n], node_f32 [f,n]) on
    ``device``: requests in [1, 1000), every pod active, rank = row;
    selectors at 20 % in columns 0-7 and their count in column 40;
    capacities in [500, 100000); labels at 50 % in node rows 0-7, the other
    rows zero."""
    g = torch.Generator().manual_seed(seed)
    sel = (torch.rand((p, 8), generator=g) < 0.2).to(torch.float32)
    pod_f32 = torch.zeros((p, f), dtype=torch.float32)
    pod_f32[:, 0:8] = sel
    pod_f32[:, WIDE_SELC_COL] = sel.sum(-1)
    pod_i32 = torch.zeros((p, 8), dtype=torch.int32)
    pod_i32[:, 0:2] = torch.randint(1, 1000, (p, 2), generator=g, dtype=torch.int32)
    pod_i32[:, 2] = 1
    pod_i32[:, 3] = torch.arange(p, dtype=torch.int32)
    info = torch.cat([
        torch.randint(500, 100_000, (4, n), generator=g, dtype=torch.int32),
        torch.ones((1, n), dtype=torch.int32), torch.zeros((3, n), dtype=torch.int32),
    ])
    node_f32 = torch.zeros((f, n), dtype=torch.float32)
    node_f32[0:8] = (torch.rand((8, n), generator=g) < 0.5).to(torch.float32)
    return tuple(t.to(device) for t in (pod_i32, pod_f32, info, node_f32))


def measure(device, p: int = P, n: int = N, reps: int = 10, seed: int = 0) -> dict:
    """ms per call (CUDA events; the checks and the node-side packing
    included), ``kernel_ms`` per launch on the prepared node side, Gpair/s of the call
    and the kernel's pods per tile."""
    inputs = make_inputs(p, n, seed=seed, device=device)
    ms = time_cuda(lambda: choose_wide(*inputs), reps)
    prep = prepare_wide(*inputs)
    kernel_ms = time_cuda(lambda: launch_prepared(prep), reps)
    return {"P": p, "N": n, "F": inputs[1].shape[1], "ms": ms, "kernel_ms": kernel_ms, "gpair_per_s": p * n / ms / 1e6,
            "live_rows": len(prep.live), "pods_per_tile": pods_per_tile(4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_wide_kernel: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    print(card(), flush=True)
    r = measure(torch.device("cuda"), reps=args.reps, seed=args.seed)
    print(f"wide-operand kernel: {r['ms']:.3f} ms a call, {r['kernel_ms']:.3f} ms a launch ({r['gpair_per_s']:.2f} "
          f"Gpair/s, {r['live_rows']} live rows, {r['pods_per_tile']} pods a tile)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
