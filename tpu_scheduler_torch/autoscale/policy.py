"""Autoscale policy — recommendation → action, with a closed skip taxonomy.

Scale-up picks WHICH SKU by cost-aware first-fit-decreasing of the pending
backlog's overflow over the provider catalog (``pack_catalog`` — the
whatif overflow-packing generalized to shape choice): open one
hypothetical node at a time, each time choosing the SKU that minimizes
hourly cost per overflow pod absorbed (ties broken by absolute cost, then
name), bounded by the provider's remaining quota.  The trigger is the
SLO-burn signal: overflow alone waits; overflow past ``burn_trigger``
buys.

Scale-down routes through the rebalancer's drain protocol and ONLY ever deletes
provider-owned (elastic) nodes; the base fleet is never shrunk.  The
``reserve`` knob is the hysteresis against the rebalancer: the
rebalancer's drained-and-parked nodes count toward the same warm-headroom
reserve, so when the defragmenter is already holding capacity aside the
autoscaler skips (``reserve``) instead of deleting its own empties — the
two subsystems never fight over the same headroom.

Every tick that declines to act reports exactly one reason from
``SKIP_REASONS`` (rebalancer-style closed taxonomy, README-catalogued,
drift-gated by ELAS):

- ``breaker-open``: the API breaker is not closed; provider calls stand down.
- ``cooldown``: the hysteresis window from a recent scale action is open.
- ``inflight``: requested provisions are still landing; buying more would
  double-count the backlog.
- ``quota``: the provider refused every useful SKU on quota.
- ``stockout``: the provider had no capacity for the chosen SKU.
- ``no-demand``: no unplaceable backlog past the burn trigger and no
  scale-down candidate — the steady state.
- ``reserve``: removable empties are retained as warm headroom (counting
  the rebalancer's drained reserve — the anti-thrash hysteresis).
- ``not-empty``: the best scale-down candidate still hosts more pods than
  the drain limit, or its pods fit nowhere else.
- ``unbind-failed``: a drain unbind POST failed; the candidate survives
  untouched.
- ``api-error``: an unexpected provider/API failure; the tick stands down.

Port: a copy of ``tpu_scheduler/autoscale/policy.py``, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SKIP_REASONS", "AutoscaleConfig", "pack_catalog", "throttle_reason"]

# protocol: taxonomy SKIP_REASONS producers=_skip,throttle_reason scope=tpu_scheduler_torch/autoscale
SKIP_REASONS = (
    "breaker-open",
    "cooldown",
    "inflight",
    "quota",
    "stockout",
    "no-demand",
    "reserve",
    "not-empty",
    "unbind-failed",
    "api-error",
)


@dataclass(frozen=True)
class AutoscaleConfig:
    """Autoscaler knobs (README-catalogued, drift-gated by ELAS)."""

    every: int = 2  # cadence: act every Nth scheduler cycle
    burn_trigger: float = 0.02  # min SLO-burn before overflow buys capacity
    max_per_tick: int = 8  # provision requests / deletes issued per tick
    cooldown: int = 4  # ticks of hysteresis after any scale action
    reserve: int = 1  # warm nodes retained (drained + empty elastic count)
    drain_max_pods: int = 4  # max pods unbound to free a scale-down candidate
    background: bool = False  # plan on a worker thread (daemon mode)


# shape: (breaker_mode: str, cooldown_left: int) -> obj
def throttle_reason(breaker_mode: str, cooldown_left: int):
    """The most-urgent stand-down reason before any planning happens, or
    None when the tick may proceed (mirrors the rebalancer's throttle)."""
    if breaker_mode != "closed":
        return "breaker-open"
    if cooldown_left > 0:
        return "cooldown"
    return None


# shape: (overflow: obj, catalog: obj, quota_left: obj) -> obj
def pack_catalog(overflow, catalog, quota_left=None) -> tuple:
    """Cost-aware FFD of the overflow backlog over a heterogeneous catalog.

    ``overflow`` is a list of ``(cpu_millicores, memory_bytes)`` requests
    (the whatif overflow, any order); ``quota_left`` maps SKU name to
    remaining request headroom (None = unbounded).  Opens one hypothetical
    node per round, picking the SKU minimizing hourly_cost per pod it
    absorbs (ties by cost, then name).  Returns ``(plan, unplaceable)``:
    a {sku_name: count} dict and the count of requests no SKU can hold.
    Deterministic: exact ints, sorted orders, no rng."""
    plan: dict[str, int] = {}
    remaining = sorted(overflow, key=lambda r: (-max(r[0], r[1]), r))
    skus = sorted(catalog, key=lambda s: (s.hourly_cost, s.name))
    while remaining:
        best = None
        for sku in skus:
            left = None if quota_left is None else quota_left.get(sku.name)
            if left is not None and plan.get(sku.name, 0) >= left:
                continue
            cap_cpu = sku.cpu * 1000
            cap_mem = sku.mem_gi << 30
            take = []
            for i, (cpu, mem) in enumerate(remaining):
                if cap_cpu >= cpu and cap_mem >= mem:
                    cap_cpu -= cpu
                    cap_mem -= mem
                    take.append(i)
            if not take:
                continue
            key = (sku.hourly_cost / len(take), sku.hourly_cost, sku.name)
            if best is None or key < best[0]:
                best = (key, sku.name, take)
        if best is None:
            break  # nothing left fits any purchasable SKU
        _key, name, take = best
        plan[name] = plan.get(name, 0) + 1
        taken = set(take)
        remaining = [r for i, r in enumerate(remaining) if i not in taken]
    return dict(sorted(plan.items())), len(remaining)
