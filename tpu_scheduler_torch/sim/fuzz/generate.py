"""Seeded, coverage-biased fault-plan generator.

All randomness flows from one labeled stream (``f"{seed}:fuzz-gen"``), so a
campaign is a pure function of (seed, budget): re-running it replays the
same plans in the same order.  Coverage feedback is deterministic too — the
runs that update the map are themselves seeded — so the guided search stays
bit-reproducible end to end.

Port: a copy of ``tpu_scheduler/sim/fuzz/generate.py``.
"""

from __future__ import annotations

import random

from .coverage import CoverageMap
from .plan import FAULT_OPS, HAZARD_OPS, MAX_OPS, EVENT_OPS, FaultOp, FaultPlan, BASE_WORKLOADS, op_valid_for_base

__all__ = ["PlanGenerator"]

# Severity ladder: quantized so shrunk magnitudes stay on round, diffable
# values and the search space stays small.
_MAGNITUDES = (0.25, 0.5, 0.75, 1.0)

# Plan durations (virtual seconds) the generator samples from.
_DURATIONS = (22.0, 26.0, 30.0)


class PlanGenerator:
    """Generates :class:`FaultPlan` instances, biased toward fault-op kinds
    with unseen (kind × facet) coverage pairs."""

    def __init__(self, seed: int, coverage: CoverageMap | None = None, max_ops: int = MAX_OPS) -> None:
        self.seed = int(seed)
        self.rng = random.Random(f"{seed}:fuzz-gen")
        self.coverage = coverage if coverage is not None else CoverageMap()
        self.max_ops = min(int(max_ops), MAX_OPS)
        self._bases = tuple(sorted(BASE_WORKLOADS))

    def _pick_kind(self, base: str, have_kill: bool) -> str:
        """Weighted pick: 1 + unseen-facet count per kind, so kinds that
        have already been injected under every subsystem state decay to
        baseline weight instead of dominating the schedule."""
        kinds = [k for k in FAULT_OPS if op_valid_for_base(k, base)]
        if have_kill:
            kinds = [k for k in kinds if k != "replica-kill"]
        weights = [1 + self.coverage.unseen(k) for k in kinds]
        total = sum(weights)
        roll = self.rng.random() * total
        acc = 0.0
        for kind, w in zip(kinds, weights):
            acc += w
            if roll < acc:
                return kind
        return kinds[-1]

    def _make_op(self, kind: str, duration: float) -> FaultOp:
        mag = self.rng.choice(_MAGNITUDES)
        if kind == "replica-kill":
            # Kills land mid-run: late enough that shards settled, early
            # enough that takeover + drain fit inside the settle bound.
            t0 = round(self.rng.uniform(8.0, 0.6 * duration), 1)
            return FaultOp(kind=kind, t0=t0, t1=t0, magnitude=mag)
        if kind in EVENT_OPS or kind in HAZARD_OPS:
            t0 = round(self.rng.uniform(4.0, 0.7 * duration), 1)
            return FaultOp(kind=kind, t0=t0, t1=t0, magnitude=mag)
        t0 = round(self.rng.uniform(3.0, 0.7 * duration), 1)
        t1 = round(t0 + self.rng.uniform(3.0, 10.0), 1)
        return FaultOp(kind=kind, t0=t0, t1=t1, magnitude=mag)

    # shape: (index: int) -> obj
    def next_plan(self, index: int) -> FaultPlan:
        """Generate campaign plan number ``index`` (round-robin bases, so
        rack and autoscale vocabularies are all exercised)."""
        base = self._bases[index % len(self._bases)]
        duration = self.rng.choice(_DURATIONS)
        n_ops = self.rng.randint(2, self.max_ops)
        ops: list[FaultOp] = []
        for _ in range(n_ops):
            have_kill = any(op.kind == "replica-kill" for op in ops)
            kind = self._pick_kind(base, have_kill)
            ops.append(self._make_op(kind, duration))
        ops.sort(key=lambda op: (op.t0, op.kind, op.t1, op.magnitude))
        return FaultPlan(
            plan_id=f"plan-{self.seed}-{index:04d}",
            base=base,
            duration=duration,
            ops=tuple(ops),
        )
