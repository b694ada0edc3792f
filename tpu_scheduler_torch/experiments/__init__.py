"""Experiments on the card: the counterparts of the JAX package's kernel
bisection scripts (``scripts/bench_kernel_parts.py``,
``scripts/bench_wide_kernel.py``).  Each module has a ``main()`` and runs
nothing when imported:

    python -m tpu_scheduler_torch.experiments.bench_kernel_parts
    python -m tpu_scheduler_torch.experiments.bench_wide_kernel
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card", "time_cuda"]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
