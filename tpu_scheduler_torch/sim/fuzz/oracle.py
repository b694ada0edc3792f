"""Invariant oracle: run one fault plan, judge it on the full battery.

``run_plan`` compiles a plan, drives it through ``scenario_episode`` (the
same loop every scripted scenario uses), samples the subsystem-state facets
at each op's activation cycle into the campaign :class:`CoverageMap`, and
returns the scorecard plus the list of violated gates.  ``judge_card``
mirrors the scorecard's composite ``pass`` gate clause by clause, so a
violation name points straight at the failed subsystem instead of a bare
``pass: false``.

Port: a copy of ``tpu_scheduler/sim/fuzz/oracle.py``.  ``run_plan`` takes
the backend the episode runs on (default ``CudaBackend()``, on the card).
"""

from __future__ import annotations

from ..harness import scenario_episode
from .coverage import CoverageMap, sample_facets
from .plan import FaultPlan, compile_plan

__all__ = ["VIOLATIONS", "card_value", "judge_card", "run_plan"]

# Closed violation vocabulary — one name per scorecard pass-gate clause the
# fuzzer can trip (locality/profile/incremental/policy/latency gates are
# never required by fuzz bases, so they cannot appear).
VIOLATIONS = (
    "invariants",  # capacity/selector/gang placement invariants broke
    "lost-pods",  # a pod vanished without bind or terminal state
    "double-binds",  # one pod bound twice
    "binds-while-open",  # a bind POST went through an OPEN breaker
    "availability",  # double-bind/orphan/slow takeover in the replica set
    "rebalance",  # orphaned migration or deschedule through open breaker
    "elasticity",  # autoscaler objective gate or reclaim orphans
    "convergence",  # end state failed to quiesce after the last fault
)


# shape: (card: obj) -> obj
def judge_card(card: dict) -> list[str]:
    """Names of every violated pass gate, in VIOLATIONS order."""
    out: list[str] = []
    if not card["invariants"].get("ok"):
        out.append("invariants")
    if card["pods"].get("lost", 0) != 0:
        out.append("lost-pods")
    if card["pods"].get("double_bound", 0) != 0:
        out.append("double-binds")
    if card["resilience"].get("binds_while_open", 0) != 0:
        out.append("binds-while-open")
    av = card["availability"]
    if av.get("enabled") and not av.get("ok"):
        out.append("availability")
    rb = card["rebalance"]
    if rb.get("enabled") and (rb.get("orphaned_migrations", 0) != 0 or rb.get("unbinds_while_open", 0) != 0):
        out.append("rebalance")
    el = card["elasticity"]
    if el.get("enabled") and el.get("reclaim_orphans", 0) != 0:
        out.append("elasticity")
    cv = card["convergence"]
    if cv.get("required") and not cv.get("ok"):
        out.append("convergence")
    for v in out:
        assert v in VIOLATIONS, f"judge emitted unknown violation {v!r}"
    return out


# shape: (card: obj, path: str) -> obj
def card_value(card: dict, path: str):
    """Resolve a dotted path ("availability.max_takeover_latency_s") into a
    scorecard — the corpus pin mechanism for near-miss plans."""
    node = card
    for part in path.split("."):
        node = node[part]
    return node


# shape: (plan: obj, seed: int) -> (obj, obj)
def run_plan(
    plan: FaultPlan,
    seed: int,
    coverage: CoverageMap | None = None,
    record: str | None = None,
    backend=None,
) -> tuple[dict, list[str]]:
    """Execute one plan deterministically; optionally record the underlying
    JSONL trace.  (Trace *replay* resolves scenarios by registry name, which
    compiled fuzz scenarios deliberately don't have — bit-identity for plans
    is asserted by re-running from (plan, seed) and comparing
    fingerprints.)  ``backend`` is the episode's (``None``: the harness's
    default, ``CudaBackend()``)."""
    sc = compile_plan(plan)
    gen = scenario_episode(sc, seed=seed, backend=backend, record=record)
    activated = [False] * len(plan.ops)
    prev_owned = None
    card: dict
    try:
        ctx = next(gen)
        while True:
            now = ctx.clock.now
            facets, prev_owned = sample_facets(ctx, prev_owned)
            if coverage is not None:
                for i, op in enumerate(plan.ops):
                    if not activated[i] and op.t0 <= now:
                        activated[i] = True
                        coverage.record(op.kind, facets)
            ctx = gen.send(None)
    except StopIteration as stop:
        card = stop.value
    return card, judge_card(card)
