"""Fault plans — the fuzzer's closed, serializable chaos vocabulary.

A :class:`FaultPlan` is a small program: a base workload name, a virtual
duration, and up to :data:`MAX_OPS` :class:`FaultOp` instructions drawn from
the closed :data:`FAULT_OPS` vocabulary.  ``compile_plan`` lowers a plan onto
one of the :data:`BASE_WORKLOADS` — producing an ordinary (unregistered)
``Scenario`` that runs through the same harness as every scripted scenario,
so a plan inherits the whole invariant battery for free.  Plans serialize to
canonical JSON (sorted keys, rounded floats) and any run reproduces
bit-identically from (plan, seed) alone.

Port: a copy of ``tpu_scheduler/sim/fuzz/plan.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

from ..chaos import ChaosConfig, ChaosWindow
from ..scenarios import Scenario
from ..workload import WorkloadSpec

__all__ = [
    "BASE_WORKLOADS",
    "FAULT_OPS",
    "MAX_OPS",
    "OP_FIELDS",
    "PLAN_FIELDS",
    "FaultOp",
    "FaultPlan",
    "compile_plan",
    "op_valid_for_base",
    "plan_from_json",
    "plan_to_json",
]

# The closed fault-op vocabulary.  Window ops ("brownout".."lease-latency")
# lower to a ChaosWindow over [t0, t1); event ops ("replica-kill",
# "rack-fail") fire once at t0; hazard ops ("node-flap", "spot-reclaim")
# raise a whole-run rate.  The vocabulary is the JAX package's: plans and
# corpus entries cross the two packages unchanged.
FAULT_OPS = (
    "brownout",  # binding 500s + binding latency over the window
    "bind-500",  # binding_error_rate window
    "unbind-500",  # api_error_rate window (unbind/list paths)
    "watch-drop",  # watch events silently dropped
    "watch-gone",  # 410 Gone storm — forced relists
    "lease-500",  # lease CAS endpoints raise apiserver 500s
    "lease-refused",  # lease acquire loses the CAS without raising
    "lease-latency",  # lease round-trips slow down
    "replica-kill",  # crash-kill one scheduler replica at t0
    "rack-fail",  # whole-rack outage at t0 (gang-rack base only)
    "node-flap",  # nodes blink out and return all run long
    "spot-reclaim",  # provider reclaims autoscaled capacity (elastic base only)
)

# Event/hazard kinds (no [t0, t1) window semantics).
EVENT_OPS = ("replica-kill", "rack-fail")
HAZARD_OPS = ("node-flap", "spot-reclaim")

# Plans are capped small by construction: the corpus promise is that every
# checked-in reproducer has at most MAX_OPS fault ops.
MAX_OPS = 6

# Closed serialization schemas — the serde below asserts against drift.
PLAN_FIELDS = ("plan_id", "base", "duration", "ops")
OP_FIELDS = ("kind", "t0", "t1", "magnitude")


# protocol: machine fuzz-plan field=- init=generated
# protocol: states: generated | judged | passed | violated | minimal
# protocol: generated -> judged
# protocol: judged -> passed | violated
# protocol: violated -> minimal
# protocol: var ops: 0..6 = 2
# protocol: action judge: generated -> judged
# protocol: action clear: judged -> passed
# protocol: action flag: judged -> violated requires ops >= 1
# protocol: action drop_op: violated -> violated requires ops >= 2 effect ops -= 1
# protocol: action settle: violated -> minimal requires ops >= 1
# protocol: invariant capped: ops <= 6
# protocol: invariant minimal_nonempty: state == minimal implies ops >= 1
# protocol: progress shrink_terminates: state == violated
@dataclass(frozen=True)
class FaultOp:
    """One fault instruction: ``kind`` at ``[t0, t1)`` with ``magnitude``.

    ``magnitude`` is a 0..1 severity knob whose meaning is per-kind (error
    rate for window ops, replica index selector for kills, hazard scale for
    flap/reclaim).  Event kinds ignore ``t1``.
    """

    kind: str
    t0: float
    t1: float
    magnitude: float

    def to_json(self) -> dict:
        out = {
            "kind": self.kind,
            "t0": round(float(self.t0), 3),
            "t1": round(float(self.t1), 3),
            "magnitude": round(float(self.magnitude), 3),
        }
        assert tuple(out) == OP_FIELDS, "FaultOp serde drifted from OP_FIELDS"
        return out


@dataclass(frozen=True)
class FaultPlan:
    """A complete fault schedule: base workload + duration + ops."""

    plan_id: str
    base: str
    duration: float
    ops: tuple[FaultOp, ...]

    def to_json(self) -> dict:
        out = {
            "plan_id": self.plan_id,
            "base": self.base,
            "duration": round(float(self.duration), 3),
            "ops": [op.to_json() for op in self.ops],
        }
        assert tuple(out) == PLAN_FIELDS, "FaultPlan serde drifted from PLAN_FIELDS"
        return out


# shape: (plan: obj) -> str
def plan_to_json(plan: FaultPlan) -> str:
    """Canonical JSON: sorted keys, no whitespace variance — diff- and
    fingerprint-stable across machines."""
    return json.dumps(plan.to_json(), sort_keys=True, separators=(",", ":"))


# shape: (text: str) -> obj
def plan_from_json(text: str) -> FaultPlan:
    raw = json.loads(text)
    ops = []
    for op in raw["ops"]:
        if op["kind"] not in FAULT_OPS:
            raise ValueError(f"unknown fault op kind: {op['kind']!r}")
        ops.append(FaultOp(kind=op["kind"], t0=float(op["t0"]), t1=float(op["t1"]), magnitude=float(op["magnitude"])))
    if len(ops) > MAX_OPS:
        raise ValueError(f"plan has {len(ops)} ops, cap is {MAX_OPS}")
    if raw["base"] not in BASE_WORKLOADS:
        raise ValueError(f"unknown base workload: {raw['base']!r}")
    return FaultPlan(plan_id=str(raw["plan_id"]), base=str(raw["base"]), duration=float(raw["duration"]), ops=tuple(ops))


# Base workloads the generator composes over.  All run 2 replicas × 4 shards
# (the interesting lease/takeover machinery is always live) with finite pod
# lifetimes so the convergence gate is meaningful.  Durations here are
# defaults; each plan carries its own.
_MIXED = Scenario(
    name="fuzz-base-mixed",
    description="General mixed workload: steady arrivals, some gangs, three priority tiers.",
    duration=26.0,
    workload=WorkloadSpec(
        initial_nodes=16,
        arrival_rate=4.0,
        gang_fraction=0.15,
        gang_size_max=4,
        priority_tiers=(0, 0, 5),
        lifetime_mean_s=16.0,
    ),
    replicas=2,
    shards=4,
    lease_duration=5.0,
    drain_grace_cycles=25,
    convergence_required=True,
)

_GANG_RACK = Scenario(
    name="fuzz-base-gang-rack",
    description="Gang-heavy workload on racked topology — rack failures are in vocabulary here.",
    duration=26.0,
    workload=WorkloadSpec(
        initial_nodes=20,
        arrival_rate=3.0,
        gang_fraction=0.35,
        gang_size_max=5,
        priority_tiers=(0, 5),
        lifetime_mean_s=18.0,
        rack_size=5,
    ),
    replicas=2,
    shards=4,
    lease_duration=5.0,
    drain_grace_cycles=25,
    convergence_required=True,
)

_ELASTIC = Scenario(
    name="fuzz-base-elastic",
    description="Small fleet + burst with the autoscaler live — spot reclaims are in vocabulary here.",
    duration=26.0,
    workload=WorkloadSpec(
        initial_nodes=5,
        arrival_rate=1.5,
        bursts=((4.0, 25),),
        priority_tiers=(0, 5),
        pod_cpu_m=(500, 1000, 2000),
        pod_mem_mi=(512, 1024, 2048),
        lifetime_mean_s=13.0,
    ),
    replicas=2,
    shards=4,
    lease_duration=5.0,
    drain_grace_cycles=25,
    convergence_required=True,
    autoscale=True,
    autoscale_burn_trigger=0.01,
    autoscale_cooldown=2,
)

BASE_WORKLOADS = {
    "mixed": _MIXED,
    "gang-rack": _GANG_RACK,
    "elastic": _ELASTIC,
}


# shape: (kind: str, base: str) -> bool
def op_valid_for_base(kind: str, base: str) -> bool:
    """Rack failures need racks; spot reclaims need the autoscaler."""
    if kind == "rack-fail":
        return BASE_WORKLOADS[base].workload.rack_size > 0
    if kind == "spot-reclaim":
        return BASE_WORKLOADS[base].autoscale
    return True


def _window_for(op: FaultOp) -> ChaosWindow:
    mag = float(op.magnitude)
    kw: dict = {"start": float(op.t0), "end": float(op.t1)}
    if op.kind == "brownout":
        kw["binding_error_rate"] = mag
        kw["binding_latency_s"] = 0.01 * mag
    elif op.kind == "bind-500":
        kw["binding_error_rate"] = mag
    elif op.kind == "unbind-500":
        kw["api_error_rate"] = mag
    elif op.kind == "watch-drop":
        kw["watch_drop_rate"] = mag
    elif op.kind == "watch-gone":
        kw["watch_gone_rate"] = mag
    elif op.kind == "lease-500":
        kw["lease_error_rate"] = mag
    elif op.kind == "lease-refused":
        kw["lease_refused_rate"] = mag
    elif op.kind == "lease-latency":
        kw["lease_latency_s"] = 0.02 * mag
    else:  # pragma: no cover - generator never routes event/hazard ops here
        raise ValueError(f"not a window op: {op.kind}")
    return ChaosWindow(**kw)


# shape: (plan: obj) -> obj
def compile_plan(plan: FaultPlan) -> Scenario:
    """Lower a plan onto its base workload, yielding an unregistered
    Scenario with ``convergence_required`` inherited from the base."""
    base = BASE_WORKLOADS[plan.base]
    windows = list(base.chaos.windows)
    kills = list(base.replica_kills)
    wl = base.workload
    rack_fails = list(wl.rack_fail_times)
    flap = wl.node_flap_rate
    reclaim = base.autoscale_reclaim_rate
    for op in plan.ops:
        if op.kind in EVENT_OPS:
            if op.kind == "replica-kill":
                kills.append((float(op.t0), int(op.magnitude * 10.0) % max(1, base.replicas)))
            else:
                rack_fails.append(float(op.t0))
        elif op.kind == "node-flap":
            flap = max(flap, 0.3 * float(op.magnitude))
        elif op.kind == "spot-reclaim":
            reclaim = max(reclaim, 0.04 * float(op.magnitude))
        else:
            windows.append(_window_for(op))
    # Never crash the whole fleet: a plan that kills every replica wedges by
    # construction, which would be a false "violation".  Keep the earliest
    # kill per replica index and drop kills past replicas-1.
    kills.sort()
    kept: list[tuple[float, int]] = []
    seen_idx: list[int] = []
    for t, idx in kills:
        if idx not in seen_idx and len(seen_idx) < base.replicas - 1:
            kept.append((t, idx))
            seen_idx.append(idx)
    new_wl = replace(wl, rack_fail_times=tuple(sorted(rack_fails)), node_flap_rate=flap)
    return replace(
        base,
        name=f"fuzz-{plan.base}-{plan.plan_id}",
        description=f"Compiled fault plan {plan.plan_id} on base '{plan.base}'.",
        duration=float(plan.duration),
        workload=new_wl,
        chaos=ChaosConfig(windows=tuple(windows)),
        replica_kills=tuple(kept),
        autoscale_reclaim_rate=reclaim,
    )
