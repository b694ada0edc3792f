"""Rebalance policy: config knobs, the closed migration/skip taxonomies,
and batch selection.

The taxonomies are drift-gated against the README "Rebalancing &
defragmentation" catalogue by the REBL analyze rule (the METR pattern), so
a new reason cannot ship undocumented.

**Migration reasons** (why a pod is descheduled):
  defrag-drain — its node drains empty so the occupied set shrinks
  rack-defrag  — same, and the node was its coarsest topology domain's
                 LAST occupied node: the drain frees the whole rack

**Skip reasons** (why a tick did less than it could):
  breaker-open  — the API circuit breaker is not closed; migrations never
                  compete with a browned-out server
  slo-burn      — a priority tier's pending-age burn rate crossed the
                  limit; rebalancing yields to the backlog
  backlog       — the pending set exceeds ``max_pending``; same stance
  inflight      — a previous batch's pods are still awaiting re-placement
                  (bounded disruption: one batch in flight)
  budget        — the lifetime migration budget is spent
  api-error     — a control read (PDB list) failed; the tick stands down
  no-gain       — the solve found nothing worth draining
  victim-moved  — a planned victim's placement changed under the plan; its
                  node group is abandoned (the next solve sees the truth)
  unbind-failed — a deschedule POST failed; the group's drain is aborted
                  (the node is NOT cordoned with pods still on it)

Port: a copy of ``tpu_scheduler/rebalance/planner.py``, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MIGRATION_REASONS", "SKIP_REASONS", "RebalanceConfig", "select_batch", "throttle_reason"]

MIGRATION_REASONS = (
    "defrag-drain",
    "rack-defrag",
)

# protocol: taxonomy SKIP_REASONS producers=_skip,throttle_reason scope=tpu_scheduler_torch/rebalance
SKIP_REASONS = (
    "breaker-open",
    "slo-burn",
    "backlog",
    "inflight",
    "budget",
    "api-error",
    "no-gain",
    "victim-moved",
    "unbind-failed",
)


@dataclass(frozen=True)
class RebalanceConfig:
    """The rebalancer's knobs (catalogued in the README section)."""

    every: int = 8  # cycles between background ticks (the cadence)
    batch: int = 8  # max migrations issued per tick (whole-node groups)
    burn_limit: float = 0.5  # max per-tier SLO burn rate before standing down
    max_pending: int = 8  # max pending backlog before standing down
    max_migrations: int = 0  # lifetime migration budget (0 = unbounded)
    max_plan: int = 256  # migrations per solve (bounds solver work)
    headroom: float = 0.9  # receiver fill cap the projection packs to
    stale_after: int = 32  # ticks before an unplaced migration counts stalled
    background: bool = False  # solve on a worker thread (daemon mode)


# shape: (breaker_mode: obj, burn: float, backlog: int, inflight: int,
#   executed: int, cfg: obj) -> obj
def throttle_reason(breaker_mode, burn: float, backlog: int, inflight: int, executed: int, cfg: RebalanceConfig):
    """The tick-level stand-down decision, most urgent reason first; None
    means the tick may solve and migrate."""
    if breaker_mode != "closed":
        return "breaker-open"
    if burn >= cfg.burn_limit:
        return "slo-burn"
    if backlog > cfg.max_pending:
        return "backlog"
    if inflight:
        return "inflight"
    if cfg.max_migrations and executed >= cfg.max_migrations:
        return "budget"
    return None


# shape: (plan: obj, batch: int, budget_left: int) -> obj
def select_batch(plan, batch: int, budget_left: int = 0) -> list:
    """Whole-node migration groups for one tick, in plan (drain) order.

    A node's drain is never split across ticks — an emptied node is the
    unit of progress — so groups are taken whole while they fit the batch;
    the FIRST group is taken even when it alone exceeds ``batch`` (a node
    needing more moves than the batch size must still be drainable).
    ``budget_left`` (0 = unbounded) additionally caps the total."""
    groups: dict[str, list[Migration]] = {}
    order: list[str] = []
    for m in plan.migrations:
        if m.src not in groups:
            groups[m.src] = []
            order.append(m.src)
        groups[m.src].append(m)
    out: list[list[Migration]] = []
    taken = 0
    for src in order:
        g = groups[src]
        if budget_left and taken + len(g) > budget_left:
            break
        if out and taken + len(g) > batch:
            break
        out.append(g)
        taken += len(g)
        if taken >= batch:
            break
    return out
