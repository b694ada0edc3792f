"""The benchmark of ``tpu_scheduler_torch``: one run of one cell.

    python3 benchmark/run.py --workload basic-5k.backlog --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with the card.  Prints
progress and the compared numbers on standard error, and as the last line
of standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, with its limit).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # The kernels build into the checkout's build/torch_kernels/ by themselves.
    from benchmark import harness
    from benchmark.spec import Cell, load_spec

    cell = Cell(load_spec(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    # The last step before the result: nothing the run loaded, the readers
    # and the reference included, may be JAX or the JAX package.
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
