"""Instructions a pair in the pod loop of each bisection kernel instance,
from the SASS of this checkout's build of ``csrc/bisect.cu``, and the SM
clock while the kernels run:

    python -m tpu_scheduler_torch.experiments.bisect_sass [--seconds S]

For each ``bisect_kernel<V, WORDS, PODS>`` of ``cuobjdump -sass``, the
longest span that a backward branch closes is the pod loop; its
instructions are counted by opcode and divided by the pairs one pass
scores (the node capacity loads in the span × PODS).  Instructions of the
divisions' slow path lie in the span but do not run when the range check
passes, so a count is an upper bound on what one pair issues.  Then every
variant is launched back to back at the experiments' shape for about
``--seconds`` while ``nvidia-smi`` samples the SM clock.  Prints the
card's name and power limit, one JSON line per instance and one with the
clock samples.  Needs a CUDA device and ``cuobjdump`` beside ``nvcc``:
without a device it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

from ..ops import bisect as bisect_mod
from . import bench_kernel_parts, bench_wide_kernel, card

__all__ = ["pod_loop_counts", "main"]

_INSTANCE = re.compile(r"_Z13bisect_kernelILi(\d)ELi(\d)ELi(\d+)E")
_LINE = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BACK = re.compile(r"BRA (?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")
_CAPS_LOAD = re.compile(r"LDG\.E\.(64|128)\.CONSTANT")


def pod_loop_counts(sass: str) -> dict:
    """{``bisect_kernel<V,WORDS,PODS>``: {"per_pair", "nodes_per_pass",
    "opcodes": {opcode: per pair}}} from a ``cuobjdump -sass`` listing."""
    out = {}
    for func in re.split(r"(?:^|\n)\s*Function : ", sass)[1:]:
        m = _INSTANCE.match(func.split()[0])
        if not m:
            continue
        pods = int(m[3])
        code = [(int(a, 16), text) for a, text in _LINE.findall(func)]
        loop = []
        for addr, text in code:
            back = _BACK.search(text)
            if back and back[1] and int(back[1], 16) < addr:
                span = [t for a, t in code if int(back[1], 16) <= a <= addr]
                loop = span if len(span) > len(loop) else loop
        pairs = max(1, sum(1 for t in loop if _CAPS_LOAD.search(t))) * pods
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for t in loop)
        out[f"bisect_kernel<{m[1]},{m[2]},{m[3]}>"] = {
            "per_pair": len(loop) / pairs, "nodes_per_pass": pairs // pods,
            "opcodes": {k: c / pairs for k, c in ops.most_common()},
        }
    return out


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(found).exists():
        raise FileNotFoundError("cuobjdump not found beside nvcc")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bisect_sass: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    print(card(), flush=True)
    path = bisect_mod.build_bisect_library()[0]
    sass = subprocess.run([_cuobjdump(), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    for kernel, rec in sorted(pod_loop_counts(sass).items()):
        print(json.dumps({"kernel": kernel, **rec}), flush=True)

    device = torch.device("cuda")
    parts = bench_kernel_parts.make_inputs(device=device)
    preps = [bisect_mod.prepare_parts(*parts, variant=v) for v in range(4)]
    preps.append(bisect_mod.prepare_wide(*bench_wide_kernel.make_inputs(device=device)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + args.seconds
        while time.perf_counter() < end:
            for prep in preps:
                bisect_mod.launch_prepared(prep)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = [int(x) for x in smi.communicate(timeout=30)[0].split() if x.isdigit()]
    print(json.dumps({"sm_clock_mhz_samples": samples,
                      "sm_clock_mhz_median": statistics.median(samples) if samples else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
