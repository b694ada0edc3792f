"""Background rebalancer — the placement-QUALITY tier of the two-tier solver.

The incremental delta engine (delta/) bought steady-state
latency by giving up global optimality: placements are greedy-incremental
and fragmentation accumulates unchecked over long horizons.  This package
is the second tier — a continuous background full-wave packing solve over a
consistent snapshot that proposes BOUNDED defragmentation migration
batches, executed as deschedule → breaker-gated unbind → delta-engine
re-place so every migration flows through the existing DeltaIndex
invalidation closure and SolveState ledger (commit-exactly-once, crash-safe
under replica kill and brownout).

Modules:
  snapshot.py  — RebalanceSnapshot: the consistent packing view (movable
                 victims, pinned mass, receiver eligibility)
  solver.py    — the packing solve: whole-node drains via first-fit-
                 decreasing, packing-efficiency / stranded-capacity math
  planner.py   — RebalanceConfig, the closed migration-reason and skip
                 taxonomies, batch selection (whole-node groups)
  executor.py  — Rebalancer: cadence + SLO-burn/backlog/breaker throttles,
                 the unbind-then-cordon drain protocol, the in-flight
                 ledger, inline and background-thread solve modes
  whatif.py    — autoscaler what-if: node-add / node-remove policies the
                 packing tier makes answerable

Port: a copy of ``tpu_scheduler/rebalance/``; every module is host code
over NumPy and the standard library.  The re-placements a migration causes
run through the port's controller, so on the card they are cycles of
``CudaBackend``'s choose kernels.
"""

from .executor import REBALANCE_CORDON_LABEL, Rebalancer
from .planner import MIGRATION_REASONS, SKIP_REASONS, RebalanceConfig
from .snapshot import RebalanceSnapshot
from .solver import Migration, PackingPlan, packing_stats, solve_packing
from .whatif import autoscaler_whatif

__all__ = [
    "MIGRATION_REASONS",
    "SKIP_REASONS",
    "REBALANCE_CORDON_LABEL",
    "Migration",
    "PackingPlan",
    "RebalanceConfig",
    "RebalanceSnapshot",
    "Rebalancer",
    "autoscaler_whatif",
    "packing_stats",
    "solve_packing",
]
