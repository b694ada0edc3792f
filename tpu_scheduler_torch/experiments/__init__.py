"""Experiments on the card: the counterparts of the JAX package's kernel
bisection scripts (``scripts/bench_kernel_parts.py``,
``scripts/bench_wide_kernel.py``).  Each module has a ``main()`` and runs
nothing when imported:

    python -m tpu_scheduler_torch.experiments.bench_kernel_parts
    python -m tpu_scheduler_torch.experiments.bench_wide_kernel

and ``bench_choose_builds``, which times kernel #1 from several builds of
``csrc/choose.cu`` in one call; ``bench_choose_trees`` and
``bench_topology_trees`` hold this checkout's term-free kernels and its
topology path against another checkout's in one process;
``bench_bisect_trees`` does so for the bisection kernels #3 and #4,
``bench_bisect_tiles`` times them at other pods per tile and
``bisect_sass`` counts their instructions a pair in the SASS.
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


def _demangled(entry: str) -> str:
    """A kernel templated on bool and integer values by its template form
    (``_Z13choose_kernelILb0ELb1EEv…`` → ``choose_kernel<false,true>``,
    ``_Z13bisect_kernelILi3ELi1ELi16EEv…`` → ``bisect_kernel<3,1,16>``);
    any other entry as it is."""
    m = re.match(r"_Z(\d+)", entry)
    if not m:
        return entry
    name_end = m.end() + int(m[1])
    args = re.match(r"I((?:L[a-z]n?\d+E)+)E", entry[name_end:])
    if not args:
        return entry
    values = []
    for kind, neg, digits in re.findall(r"L([a-z])(n?)(\d+)E", args[1]):
        values.append(("false", "true")[int(digits)] if kind == "b" else f"{'-' if neg else ''}{digits}")
    return f"{entry[m.end():name_end]}<{','.join(values)}>"


def ptxas_resources(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from ``nvcc
    -Xptxas -v`` output; a kernel templated on bool and integer values is
    named as ``choose_kernel<false,true>`` or ``bisect_kernel<3,1,16>``, any
    other by its mangled name."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _demangled(line.split("'")[1])
            out[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return out
