"""Coverage-guided chaos fuzzer (``sim fuzz``) — randomized fault-schedule
search over the deterministic simulator.

The pipeline: a seeded :class:`PlanGenerator` composes :data:`FAULT_OPS`
into serializable :class:`FaultPlan` schedules over parameterized base
workloads; :func:`run_plan` executes each plan through the ordinary
``scenario_episode`` loop and judges it on the union of every scorecard
pass gate plus the end-state convergence check; a :class:`CoverageMap` of
(fault-op × subsystem-state-at-injection) pairs biases generation toward
unseen interleavings; :func:`shrink_plan` delta-debugs a failing plan to a
minimal reproducer for ``tests/fuzz_corpus/``, replayed forever by tier-1.

Everything is derived from ONE campaign seed — the same ``--budget --seed``
pair produces a byte-identical run log on every machine (the sim's
record→replay determinism contract, extended to the search itself).

Port: a copy of ``tpu_scheduler/sim/fuzz/`` over the port's harness.  Every
function that runs an episode takes its ``backend`` (the card by default;
``CudaBackend(device="cpu")`` on the CPU).  Plans on every base run,
``elastic`` (the autoscaler and its provider) included.
"""

from .coverage import STATE_FACETS, CoverageMap
from .generate import PlanGenerator
from .oracle import judge_card, run_plan
from .plan import BASE_WORKLOADS, FAULT_OPS, FaultOp, FaultPlan, compile_plan, plan_from_json, plan_to_json
from .shrink import shrink_plan

__all__ = [
    "BASE_WORKLOADS",
    "FAULT_OPS",
    "STATE_FACETS",
    "CoverageMap",
    "FaultOp",
    "FaultPlan",
    "PlanGenerator",
    "compile_plan",
    "judge_card",
    "plan_from_json",
    "plan_to_json",
    "run_plan",
    "shrink_plan",
]
