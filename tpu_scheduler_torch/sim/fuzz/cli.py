"""``python -m tpu_scheduler_torch.cli sim fuzz`` — the chaos-fuzzing campaign.

One invocation = corpus replay + a seeded generation campaign:

  sim fuzz --budget 200 --seed 0 --runlog out.jsonl [--device cpu]

First every checked-in reproducer in ``--corpus`` replays (fingerprint,
verdict, violations, pins — all must match); then ``--budget`` fresh plans
are generated coverage-guided, run, and judged.  Any new violation is
shrunk to a minimal plan and (with ``--write-corpus``) written into the
corpus.  The run log contains only virtual-time quantities, so the same
(budget, seed) pair produces a byte-identical log anywhere — the sim's
determinism contract extended to the search.

Port of ``tpu_scheduler/sim/fuzz/cli.py``: the episodes run over
``CudaBackend`` — on the card by default (without CUDA: exit 1 with
``BackendUnavailable``'s message before any episode), on the CPU with
``--device cpu``.  The run log is the JAX campaign's, line for line.

Exit codes: 0 = corpus green and no new violations, 1 = a corpus entry
drifted, the campaign found a violation, or no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ...errors import BackendUnavailable
from .corpus import entry_for, load_corpus, replay_entry
from .coverage import CoverageMap
from .generate import PlanGenerator
from .oracle import run_plan
from .plan import MAX_OPS, plan_to_json
from .shrink import shrink_plan

__all__ = ["main"]

DEFAULT_CORPUS = os.path.join("tests", "fuzz_corpus")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-scheduler-torch sim fuzz", description=__doc__)
    p.add_argument("--budget", type=int, default=50, help="number of fresh plans to generate and judge")
    p.add_argument("--seed", type=int, default=0, help="the ONE campaign seed (plans, workloads, chaos all derive)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="where CudaBackend runs the episodes")
    p.add_argument("--corpus", default=DEFAULT_CORPUS, metavar="DIR", help="reproducer corpus to replay first")
    p.add_argument("--no-corpus", action="store_true", help="skip the corpus replay phase")
    p.add_argument("--runlog", default=None, metavar="PATH", help="write the per-plan JSONL log here (deterministic)")
    p.add_argument("--write-corpus", action="store_true", help="write shrunk reproducers for new violations into --corpus")
    p.add_argument("--max-ops", type=int, default=MAX_OPS, help=f"ops per generated plan, capped at {MAX_OPS}")
    p.add_argument("--shrink", dest="shrink", action="store_true", default=True, help="shrink new violations (default)")
    p.add_argument("--no-shrink", dest="shrink", action="store_false", help="report violations unshrunk")
    p.add_argument("--log-level", default="ERROR", help="scheduler log level (campaign noise is off by default)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from ...utils.tracing import configure_logging

    configure_logging(args.log_level, "text")
    from ...backends.cuda import CudaBackend

    try:
        backend = CudaBackend(device=args.device)
    except BackendUnavailable as e:
        print(f"tpu-scheduler-torch sim fuzz: {e}", file=sys.stderr)
        return 1
    log_lines: list[str] = []

    def log(obj: dict) -> None:
        line = json.dumps(obj, sort_keys=True)
        log_lines.append(line)
        print(line)

    corpus_ok = True
    corpus_n = 0
    if not args.no_corpus:
        for entry in load_corpus(args.corpus):
            ok, problems, card = replay_entry(entry, backend=backend)
            corpus_n += 1
            corpus_ok = corpus_ok and ok
            log(
                {
                    "corpus": entry["name"],
                    "ok": ok,
                    "problems": problems,
                    "fingerprint": card["fingerprint"],
                    "ops": len(entry["plan"].ops),
                }
            )

    coverage = CoverageMap()
    gen = PlanGenerator(args.seed, coverage, max_ops=args.max_ops)
    found: list[dict] = []
    for i in range(args.budget):
        plan = gen.next_plan(i)
        card, violations = run_plan(plan, args.seed, coverage, backend=backend)
        log(
            {
                "plan": plan.plan_id,
                "base": plan.base,
                "ops": len(plan.ops),
                "pass": card["pass"],
                "violations": violations,
                "fingerprint": card["fingerprint"],
                "coverage_pairs": coverage.distinct(),
            }
        )
        if violations:
            minimal = shrink_plan(plan, args.seed, backend=backend) if args.shrink else plan
            mcard, mviol = run_plan(minimal, args.seed, backend=backend)
            found.append({"plan": minimal, "card": mcard, "violations": mviol})
            log(
                {
                    "violation": minimal.plan_id,
                    "shrunk_ops": len(minimal.ops),
                    "violations": mviol,
                    "plan_json": plan_to_json(minimal),
                }
            )
            if args.write_corpus:
                body = entry_for(
                    entry_name=f"{minimal.plan_id}-min",
                    note=f"Shrunk reproducer found by sim fuzz --seed {args.seed}; violates: {', '.join(mviol)}.",
                    plan=minimal,
                    seed=args.seed,
                    card=mcard,
                    violations=mviol,
                )
                os.makedirs(args.corpus, exist_ok=True)
                path = os.path.join(args.corpus, f"{minimal.plan_id}-min.json")
                with open(path, "w", encoding="utf-8") as fh:
                    json.dump(body, fh, indent=2, sort_keys=True)
                    fh.write("\n")
    summary = {
        "fuzz": True,
        "seed": args.seed,
        "budget": args.budget,
        "corpus_replayed": corpus_n,
        "corpus_ok": corpus_ok,
        "violations_found": len(found),
        "coverage_pairs": coverage.distinct(),
        "lease_pairs": coverage.lease_pairs(),
        "coverage": coverage.to_json(),
    }
    log(summary)
    if args.runlog:
        with open(args.runlog, "w", encoding="utf-8") as fh:
            fh.write("\n".join(log_lines) + "\n")
    return 0 if corpus_ok and not found else 1


if __name__ == "__main__":
    sys.exit(main())
