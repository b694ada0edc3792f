"""``python -m tpu_scheduler_torch.cli sim`` — the simulator's command surface.

Runs one named scenario to its scorecard JSON (stdout, one line) over
``CudaBackend``: on the card by default, on the CPU with ``--device cpu``
(the plain torch versions; the card is never replaced by the CPU unasked —
without CUDA the default exits 1 with ``BackendUnavailable``'s message).
Exit codes: 0 = verdict passed, 1 = verdict failed (invariant violation,
lost or double-bound pods) or no card, 2 = bad arguments, 3 = a
``--replay`` run diverged from its recorded fingerprint.  ``sim fuzz``
runs the chaos fuzzer (``sim/fuzz/cli.py``), ``sim train`` the policy
search (``learn/cli.py``).

Port of ``tpu_scheduler/sim/cli.py``: ``--device {cuda,cpu}`` takes the
place of ``--backend {native,tpu}``; every other flag is the same.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..errors import BackendUnavailable
from ..utils.tracing import configure_logging
from .harness import ReplayMismatchError, run_scenario
from .scenarios import SCENARIOS

__all__ = ["main"]

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-scheduler-torch sim", description=__doc__)
    p.add_argument("--scenario", default="sim-smoke", choices=sorted(SCENARIOS), help="named scenario (see --list)")
    p.add_argument("--seed", type=int, default=0, help="the ONE seed every random choice derives from")
    p.add_argument("--record", default=None, metavar="PATH", help="persist the run as a JSONL trace")
    p.add_argument("--replay", default=None, metavar="PATH", help="re-run a recorded trace and verify bit-identity")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="where CudaBackend runs the cycles")
    p.add_argument(
        "--profile-file",
        default=None,
        metavar="PATH",
        help="schedule with a tuned-profile JSON artifact (learn/profiles schema) instead of the default profile",
    )
    p.add_argument("--events-buffer", type=int, default=4096, help="flight recorder capacity during the run")
    p.add_argument(
        "--profile-check",
        action="store_true",
        help="after the run, enforce the profiler gates: attribution coverage >= 0.9 and "
        "estimated span+ring overhead < 2%% of the cycle wall (exit 1 on breach)",
    )
    p.add_argument("--log-level", default="WARNING")
    p.add_argument("--list", action="store_true", help="list scenarios and exit")
    return p


def main(argv: list[str] | None = None) -> int:
    if argv and argv[0] == "fuzz":
        # Coverage-guided chaos fuzzing (sim/fuzz): seeded fault-plan
        # search + corpus replay, byte-identical per seed:
        #   python -m tpu_scheduler_torch.cli sim fuzz --budget 200 --seed 0
        from .fuzz.cli import main as fuzz_main

        return fuzz_main(argv[1:])
    if argv and argv[0] == "train":
        # Policy training (learn/): seeded CEM over the profile weight
        # surface, distilled to a JSON artifact:
        #   python -m tpu_scheduler_torch.cli sim train --scenario-set train-smoke --seed 0 --out profile.json
        from ..learn.cli import main as train_main

        return train_main(argv[1:])
    args = build_parser().parse_args(argv)
    configure_logging(args.log_level, "text")
    if args.list:
        for name in sorted(SCENARIOS):
            sc = SCENARIOS[name]
            print(json.dumps({"scenario": name, "duration_s": sc.duration, "description": sc.description}))
        return 0
    if args.record and args.replay:
        print("--record and --replay are mutually exclusive", file=sys.stderr)
        return 2
    profile = None
    if args.profile_file:
        from ..models.profiles import SchedulingProfile

        profile = SchedulingProfile.from_file(args.profile_file)
    gates: dict | None = {} if args.profile_check else None
    try:
        from ..backends.cuda import CudaBackend

        card = run_scenario(
            args.scenario,
            seed=args.seed,
            backend=CudaBackend(device=args.device),
            record=args.record,
            replay=args.replay,
            events_buffer=args.events_buffer,
            profile_gates=gates,
            profile=profile,
        )
    except BackendUnavailable as e:
        print(f"tpu-scheduler-torch sim: {e}", file=sys.stderr)
        return 1
    except ReplayMismatchError as e:
        print(json.dumps({"replay_mismatch": True, "expected": e.expected, "got": e.got}))
        return 3
    print(json.dumps(card, sort_keys=True))
    if gates is not None:
        # Wall-derived gate inputs stay OFF the (byte-identical) scorecard;
        # this line is diagnostics, the exit code is the verdict.
        verdict = {
            "profile_check": True,
            "coverage": round(gates["coverage"], 4),
            "overhead_frac": round(gates["overhead_frac"], 5),
            "spans_per_cycle": round(gates["spans_per_cycle"], 1),
            "coverage_ok": gates["coverage"] >= 0.9,
            "overhead_ok": gates["overhead_frac"] < 0.02,
        }
        print(json.dumps(verdict), file=sys.stderr)
        if not (verdict["coverage_ok"] and verdict["overhead_ok"]):
            return 1
    return 0 if card["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
