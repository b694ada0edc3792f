"""``python -m tpu_scheduler_torch.cli sim train`` — the training command surface.

Runs the seeded CEM search (learn/search.py) over registered scenarios and
writes the winning profile as a versioned JSON artifact (learn/distill.py).
Stdout is one JSON report line: the held-out tuned-vs-default table, the
chosen vector, and whether the tuned profile actually won (``improved``;
on a loss the artifact falls back to the default profile's weights, so the
output is never worse than what it replaces).  Exit 0 on a written
artifact, 2 on bad arguments — "tuned lost to default" is a reported
outcome, not an error.

Port of ``tpu_scheduler/learn/cli.py``: ``--device {cuda,cpu}`` says where
the episodes run (the card by default; without CUDA exit 1 with
``BackendUnavailable``'s message before any episode).  Every other flag is
the same, and the artifact is the JAX command's, byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..errors import BackendUnavailable
from ..utils.tracing import configure_logging
from .distill import distill
from .search import SearchConfig, train_profile

__all__ = ["main", "build_parser"]


def _csv_ints(text: str) -> tuple:
    # shape: (text: str) -> obj
    return tuple(int(tok) for tok in text.split(",") if tok.strip() != "")


def build_parser() -> argparse.ArgumentParser:
    # shape: () -> obj
    from ..sim.scenarios import SCENARIOS

    p = argparse.ArgumentParser(prog="tpu-scheduler-torch sim train", description=__doc__)
    p.add_argument(
        "--scenario-set",
        default="train-smoke",
        help=f"comma-separated registered scenarios to climb (known: {', '.join(sorted(SCENARIOS))})",
    )
    p.add_argument("--seed", type=int, default=0, help="the ONE seed the CEM sampler derives from")
    p.add_argument("--train-seeds", default="0,1", help="comma-separated episode seeds the optimizer sees")
    p.add_argument("--held-out-seeds", default="101,102", help="disjoint seeds for final tuned-vs-default selection")
    p.add_argument("--generations", type=int, default=3, help="CEM iterations")
    p.add_argument("--population", type=int, default=8, help="candidates per generation")
    p.add_argument("--elite-frac", type=float, default=0.25, help="elite refit fraction")
    p.add_argument("--workers", type=int, default=0, help="thread-pool width for episode evaluation (0 = serial)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="where CudaBackend runs the episodes")
    p.add_argument("--out", default="profile.json", metavar="PATH", help="where the tuned-profile artifact lands")
    p.add_argument("--log-level", default="WARNING")
    return p


def main(argv=None) -> int:
    # shape: (argv: obj) -> int
    from ..sim.scenarios import SCENARIOS

    args = build_parser().parse_args(argv)
    configure_logging(args.log_level, "text")
    scenarios = tuple(tok.strip() for tok in args.scenario_set.split(",") if tok.strip())
    unknown = sorted(set(scenarios) - set(SCENARIOS))
    if unknown:
        print(f"unknown scenarios: {', '.join(unknown)}", file=sys.stderr)
        return 2
    train_seeds = _csv_ints(args.train_seeds)
    held_out = _csv_ints(args.held_out_seeds)
    if set(train_seeds) & set(held_out):
        print("--train-seeds and --held-out-seeds must be disjoint", file=sys.stderr)
        return 2
    cfg = SearchConfig(
        scenarios=scenarios,
        train_seeds=train_seeds,
        held_out_seeds=held_out,
        generations=args.generations,
        population=args.population,
        elite_frac=args.elite_frac,
        seed=args.seed,
        workers=args.workers,
    )
    from ..backends.cuda import CudaBackend

    try:
        CudaBackend(device=args.device)  # no card: fail before any episode
    except BackendUnavailable as e:
        print(f"tpu-scheduler-torch sim train: {e}", file=sys.stderr)
        return 1
    result = train_profile(cfg, log=lambda msg: print(msg, file=sys.stderr), device=args.device)
    provenance = distill(result, args.out)
    print(
        json.dumps(
            {
                "out": args.out,
                "improved": result.improved,
                "profile": result.profile.name,
                "vector": result.vector,
                "train_objective": result.train_objective,
                "default_train_objective": result.default_train_objective,
                "held_out": result.held_out,
                "default_held_out": result.default_held_out,
                "objective_version": provenance["objective_version"],
            },
            sort_keys=True,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
