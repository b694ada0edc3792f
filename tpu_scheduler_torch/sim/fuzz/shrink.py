"""Delta-debugging shrinker: failing plan → minimal reproducer.

Greedy fixed-point reduction: repeatedly try dropping whole ops, then
halving window lengths and magnitudes, keeping any candidate that still
trips the ORIGINAL primary violation under a deterministic re-run.  Every
probe is a full seeded simulation, so the shrink trajectory itself is
reproducible.  The result is what lands in ``tests/fuzz_corpus/`` — small
enough to read, strong enough to pin the bug forever.

Port: a copy of ``tpu_scheduler/sim/fuzz/shrink.py``.
"""

from __future__ import annotations

from dataclasses import replace

from .oracle import run_plan
from .plan import EVENT_OPS, HAZARD_OPS, FaultOp, FaultPlan

__all__ = ["shrink_plan"]

# Stop shrinking a window below this many virtual seconds / a magnitude
# below this rung — probes get meaninglessly weak past these floors.
_MIN_WINDOW_S = 2.0
_MIN_MAGNITUDE = 0.25


def _op_shrink_candidates(op: FaultOp) -> list[FaultOp]:
    out: list[FaultOp] = []
    if op.kind not in EVENT_OPS and op.kind not in HAZARD_OPS:
        span = op.t1 - op.t0
        if span > _MIN_WINDOW_S:
            out.append(replace(op, t1=round(op.t0 + max(_MIN_WINDOW_S, span / 2.0), 1)))
    if op.magnitude > _MIN_MAGNITUDE:
        out.append(replace(op, magnitude=round(max(_MIN_MAGNITUDE, op.magnitude / 2.0), 3)))
    return out


# shape: (plan: obj, seed: int) -> obj
def shrink_plan(plan: FaultPlan, seed: int, run=None, backend=None) -> FaultPlan:
    """Reduce ``plan`` to a local minimum that still reproduces its primary
    (first-listed) violation at ``seed``.

    ``run`` is injectable for tests: a callable (plan) -> list of violation
    names; defaults to the real oracle on ``backend``.
    """
    if run is None:

        def run(p, _seed=seed):
            return run_plan(p, _seed, backend=backend)[1]

    violations = run(plan)
    if not violations:
        return plan
    primary = violations[0]
    changed = True
    while changed:
        changed = False
        # Pass 1: drop whole ops (never below one — an empty plan can't
        # reproduce anything).
        for i in range(len(plan.ops)):
            if len(plan.ops) <= 1:
                break
            cand = replace(plan, ops=plan.ops[:i] + plan.ops[i + 1 :])
            if primary in run(cand):
                plan = cand
                changed = True
                break
        if changed:
            continue
        # Pass 2: weaken surviving ops (shorter windows, lower magnitudes).
        for i, op in enumerate(plan.ops):
            for cand_op in _op_shrink_candidates(op):
                cand = replace(plan, ops=plan.ops[:i] + (cand_op,) + plan.ops[i + 1 :])
                if primary in run(cand):
                    plan = cand
                    changed = True
                    break
            if changed:
                break
    return plan
