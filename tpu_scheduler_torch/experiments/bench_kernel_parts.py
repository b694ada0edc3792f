"""Bisect the choose kernel's per-pair cost on the card: time the ladder of
stripped-down kernels (fit + argmax, + selector count, + score divisions,
+ jitter hash; ``ops/bisect.choose_parts``) at the north-star shape, to see
what eats the cycles — the counterpart of ``scripts/bench_kernel_parts.py``.

    python -m tpu_scheduler_torch.experiments.bench_kernel_parts [--reps N] [--seed S]

Prints the card's name and power limit, then per variant the ms of a call
(the bitmap check and node-side packing included), of a launch alone on
prepared rows, Gpair/s and the pods per tile.
The inputs come from a seeded ``torch.Generator`` (the script's
distributions; not its numbers, which come from ``jax.random``).  Needs a
CUDA device: without one it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.bisect import choose_parts, launch_prepared, pods_per_tile, prepare_parts
from . import card, time_cuda

__all__ = ["P", "N", "L", "NAMES", "make_inputs", "measure", "main"]

P, N, L = 106_496, 10_240, 8
NAMES = ("fit+argmax", "+sel count", "+score divs", "+hash")


def make_inputs(p: int = P, n: int = N, l: int = L, seed: int = 0, device="cpu") -> tuple:
    """(req [p,2] i32, sel [p,l] f32, selc [p,1] f32, ranks [p,1] i32,
    info [8,n] i32, labels [l,n] f32) on ``device``: requests in [1, 1000),
    selectors at 20 %, capacities in [500, 100000), labels at 50 %."""
    g = torch.Generator().manual_seed(seed)
    req = torch.randint(1, 1000, (p, 2), generator=g, dtype=torch.int32)
    sel = (torch.rand((p, l), generator=g) < 0.2).to(torch.float32)
    selc = sel.sum(-1, keepdim=True)
    ranks = torch.arange(p, dtype=torch.int32).reshape(-1, 1)
    info = torch.cat([
        torch.randint(500, 100_000, (4, n), generator=g, dtype=torch.int32),
        torch.ones((1, n), dtype=torch.int32), torch.zeros((3, n), dtype=torch.int32),
    ])
    labels = (torch.rand((l, n), generator=g) < 0.5).to(torch.float32)
    return tuple(t.to(device) for t in (req, sel, selc, ranks, info, labels))


def measure(device, p: int = P, n: int = N, reps: int = 10, seed: int = 0) -> list[dict]:
    """One record per variant: ms per call (CUDA events; the check and the
    node-side packing included), ``kernel_ms`` per launch on the prepared node side,
    Gpair/s of the call and the kernel's pods per tile."""
    inputs = make_inputs(p, n, seed=seed, device=device)
    recs = []
    for v, name in enumerate(NAMES):
        ms = time_cuda(lambda: choose_parts(*inputs, variant=v), reps)  # noqa: B023 — timed before the next v
        prep = prepare_parts(*inputs, variant=v)
        kernel_ms = time_cuda(lambda: launch_prepared(prep), reps)  # noqa: B023
        recs.append({"variant": v, "name": name, "P": p, "N": n, "ms": ms, "kernel_ms": kernel_ms,
                     "gpair_per_s": p * n / ms / 1e6, "pods_per_tile": pods_per_tile(v)})
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernel_parts: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    print(card(), flush=True)
    for r in measure(torch.device("cuda"), reps=args.reps, seed=args.seed):
        print(f"variant {r['variant']} ({r['name']:12s}): {r['ms']:8.3f} ms a call, {r['kernel_ms']:8.3f} ms a launch "
              f"({r['gpair_per_s']:.2f} Gpair/s, {r['pods_per_tile']} pods a tile)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
