"""Incremental delta-scheduling engine — the steady-state fast path.

The controller's full cycle rebuilds and re-solves the whole pods×nodes
problem every tick even when only a handful of watch deltas arrived.  This
package makes the DELTA cycle the default and the full-wave solve the rare
escalation:

  • ``state.SolveState`` — solve state persisted ACROSS cycles: committed
    placements, per-node residual-capacity tensors (the exact int64
    alloc/used pair ``ops/pack._avail_i32`` consumes), and the
    skipped-verdict ledger (pods proven unschedulable whose proof still
    stands).
  • ``index.DeltaIndex`` — the watch-delta invalidation closure: raw
    reflector events classify into dirty pods, then the set CLOSES (freed
    capacity re-dirties capacity-blocked verdicts, gang membership keeps
    gangs all-or-nothing, constraint-carrier churn re-dirties constrained
    verdicts, fresh placements re-dirty positive pod-affinity seekers).
  • ``engine.DeltaEngine`` — plan/commit orchestration in the controller:
    packs only the dirty set against the carried residual tensors,
    escalates to a full-wave solve only on the closed
    ``ESCALATION_REASONS`` triggers, and (in the sim) shadow-solves sampled
    cycles to hold the delta path to invariant-equivalence with the full
    solve.

Port: a copy of ``tpu_scheduler/delta/__init__.py``; the package is pure
host code (NumPy), so nothing in it changes for the card — the solve it
feeds runs through ``CudaBackend``.
"""

from .engine import ESCALATION_REASONS, DeltaEngine, DeltaPlan
from .index import DeltaIndex
from .state import SolveState

__all__ = ["DeltaEngine", "DeltaPlan", "DeltaIndex", "SolveState", "ESCALATION_REASONS"]
