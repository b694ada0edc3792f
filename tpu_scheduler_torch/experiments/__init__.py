"""Experiments on the card: the counterparts of the JAX package's kernel
bisection scripts (``scripts/bench_kernel_parts.py``,
``scripts/bench_wide_kernel.py``).  Each module has a ``main()`` and runs
nothing when imported:

    python -m tpu_scheduler_torch.experiments.bench_kernel_parts
    python -m tpu_scheduler_torch.experiments.bench_wide_kernel

and ``bench_choose_builds``, which times kernel #1 from several builds of
``csrc/choose.cu`` in one call.
"""

from __future__ import annotations

import re
import subprocess

import torch

__all__ = ["card", "ptxas_resources", "time_cuda"]


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


def ptxas_resources(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from ``nvcc
    -Xptxas -v`` output; a kernel templated on bools is named as
    ``choose_kernel<false,true>``, any other by its mangled name."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            m = re.match(r"_Z\d+([A-Za-z_]\w*?)I((?:Lb\dE)+)E", entry)
            if m:
                flags = ",".join(("false", "true")[int(b)] for b in re.findall(r"Lb(\d)E", m[2]))
                entry = f"{m[1]}<{flags}>"
            out[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return out
