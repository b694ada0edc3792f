"""The policy objective — one scalar per scorecard, from existing blocks only.

``policy_block`` folds the scorecard's already-computed verdict blocks into
the single number the optimizer climbs (``search.py``) and every scenario
reports (the scorecard ``policy`` block).  Nothing here measures anything
new: every input is a deterministic quantity an existing block carries, so
record→replay byte-identity holds unchanged.

The weight schema is CLOSED and documented (``OBJECTIVE_COMPONENTS``,
drift-gated against the README "Learned policy & tuning" catalogue by the
LERN analyze rule):

  ``slo``       (+1.0)  bind completeness × latency factor — the fraction of
                        demand that ever bound, discounted by the p99
                        time-to-bind against the ``P99_SCALE_S`` horizon.
  ``packing``   (+0.5)  final-state packing efficiency (the rebalance
                        block's exact-integer dominant-axis fill).
  ``locality``  (+0.5)  fraction of scored gangs with zero cross-rack
                        edges (1.0 for topology-blind scenarios — no
                        locality surface to judge).
  ``churn``     (-0.25) preemption victims + NoExecute evictions +
                        rebalancer migrations per successful bind —
                        placement-quality wins must not be bought with
                        disruption.

Every component lands in [0, 1], so the objective lives in [-0.25, 2.0]
with the default weights.  Components are rounded to 6 decimals before the
weighted sum — the scorecard byte-identity contract.

Port: a copy of ``tpu_scheduler/learn/objective.py``, unchanged.
"""

from __future__ import annotations

__all__ = [
    "OBJECTIVE_VERSION",
    "OBJECTIVE_COMPONENTS",
    "POLICY_FIELDS",
    "P99_SCALE_S",
    "policy_block",
    "objective_from_card",
]

# Bump on any formula or weight change: tuned artifacts record the version
# they were trained against, and bench.py refuses cross-version comparison.
OBJECTIVE_VERSION = 1

# The closed (component name -> weight) schema.  Order is the reporting
# order in the scorecard ``policy.components`` block.
OBJECTIVE_COMPONENTS = (
    ("slo", 1.0),
    ("packing", 0.5),
    ("locality", 0.5),
    ("churn", -0.25),
)

# The closed schema of the scorecard ``policy`` block (drift-gated against
# the README "Learned policy & tuning" catalogue by the LERN analyze rule).
POLICY_FIELDS = (
    "enabled",
    "required",
    "version",
    "objective",
    "components",
    "floor",
    "ok",
)

# p99 time-to-bind horizon: a run whose p99 equals this many virtual
# seconds keeps half its bind-completeness credit.
P99_SCALE_S = 30.0


def _clamp01(x: float) -> float:
    # shape: (x: float) -> float
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


def policy_block(
    *,
    slo: dict,
    pod_counts: dict,
    locality: dict,
    rebalance: dict,
    required: bool,
    floor: float,
) -> dict:
    """The scorecard ``policy`` verdict: per-component breakdown plus the
    weighted scalar.  ``required``/``floor`` come from the scenario —
    policy-required scenarios gate the pass on ``objective >= floor``, so
    a tuned profile that wins the objective by breaking a workload fails
    the run instead of shipping."""
    # shape: (slo: obj, pod_counts: obj, locality: obj, rebalance: obj, required: bool, floor: float) -> obj
    demand = int(pod_counts.get("arrived", 0)) + int(pod_counts.get("churn_recreated", 0))
    bound = int(pod_counts.get("bound_total", 0))
    bound_frac = _clamp01(bound / demand) if demand > 0 else 1.0
    latency_factor = 1.0 / (1.0 + float(slo.get("p99_time_to_bind_s", 0.0)) / P99_SCALE_S)

    scored = int(locality.get("gangs_scored", 0))
    if not locality.get("enabled") or scored == 0:
        local_frac = 1.0  # no locality surface to judge
    else:
        local_frac = _clamp01(1.0 - int(locality.get("cross_rack_gangs", 0)) / scored)

    disruptions = (
        int(slo.get("preemption_churn", 0))
        + int(pod_counts.get("migrated", 0))
    )
    churn_frac = _clamp01(disruptions / bound) if bound > 0 else (1.0 if disruptions else 0.0)

    components = {
        "slo": round(bound_frac * latency_factor, 6),
        "packing": round(_clamp01(float(rebalance.get("packing_efficiency", 0.0))), 6),
        "locality": round(local_frac, 6),
        "churn": round(churn_frac, 6),
    }
    objective = round(sum(w * components[name] for name, w in OBJECTIVE_COMPONENTS), 6)
    out = {
        "enabled": True,
        "required": bool(required),
        "version": OBJECTIVE_VERSION,
        "objective": objective,
        "components": components,
        "floor": round(float(floor), 6),
        "ok": bool(floor <= 0 or objective >= floor),
    }
    assert tuple(out) == POLICY_FIELDS, "policy block schema drifted from POLICY_FIELDS"
    return out


def objective_from_card(card: dict) -> float:
    """The scalar the optimizer climbs, read back off a finished scorecard."""
    # shape: (card: obj) -> float
    return float(card["policy"]["objective"])
