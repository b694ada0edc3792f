"""Seeded workload generator — everything a scenario throws at the cluster,
parameterized by ONE rng seed.

The generator emits a time-ordered list of high-level ``SimEvent``s:

  • ``pods``       — a Poisson arrival or a burst: fully-sampled pod specs
                     (cpu/mem tier, priority tier, optional nodeSelector,
                     optional gang of 2..k members, a sampled lifetime)
  • ``node-add``   — a new node joins (fleet growth)
  • ``node-drain`` — cordon a node and evict its pods (they re-arrive as
                     fresh Pending pods — the ReplicaSet stand-in)
  • ``node-fail``  — the node vanishes outright, pods re-arrive Pending
  • ``node-flap``  — fail + automatic return of the SAME node after
                     ``down_s`` virtual seconds (the NotReady flap)

Node-targeting events carry a ``pick`` float in [0, 1) instead of a node
name: the harness resolves it against the sorted live node list at apply
time, so generation never needs to simulate cluster state — and the
RESOLVED op stream is what the trace records, keeping replays bit-identical
regardless of resolution logic.

All sampling comes from the single ``random.Random`` the caller passes;
each process (arrivals, each churn kind) draws from its own derived seed so
event streams merge deterministically by (time, stream, index).

Port: a copy of ``tpu_scheduler/sim/workload.py``, unchanged: the same
(spec, duration, seed) gives the same event list in both packages.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

__all__ = ["WorkloadSpec", "SimEvent", "generate_events", "initial_nodes"]

# Heterogeneous fleet shapes (cpu cores, memory GiB) — testing.py's tiers.
NODE_SHAPES = ((8, 32), (16, 64), (32, 128))
ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")


@dataclass(frozen=True)
class WorkloadSpec:
    """One scenario's workload shape (all times/rates in VIRTUAL seconds)."""

    initial_nodes: int = 50
    arrival_rate: float = 10.0  # Poisson pod arrivals per virtual second
    bursts: tuple[tuple[float, int], ...] = ()  # (t, n_pods) storms
    gang_fraction: float = 0.0  # fraction of arrivals opening a gang
    gang_size_max: int = 4  # gangs are 2..gang_size_max members
    priority_tiers: tuple[int, ...] = (0,)  # sampled uniformly per pod
    selector_fraction: float = 0.0  # fraction pinning a zone nodeSelector
    pod_cpu_m: tuple[int, ...] = (100, 250, 500, 1000)
    pod_mem_mi: tuple[int, ...] = (128, 256, 512, 1024)
    lifetime_mean_s: float = 0.0  # Exp(mean) run time after bind; 0 = forever
    # Diurnal traffic: when ``diurnal_period`` > 0 the Poisson arrival rate
    # becomes rate(t) = arrival_rate * (1 + amplitude * sin(2πt/period)) —
    # sampled by thinning at the peak rate, so the elastic-capacity wave
    # the autoscaler must ride is itself seeded and deterministic.
    diurnal_period: float = 0.0  # virtual seconds per wave (0 = flat rate)
    diurnal_amplitude: float = 0.0  # fractional swing around arrival_rate
    node_add_rate: float = 0.0  # churn processes, events per virtual second
    node_drain_rate: float = 0.0
    node_fail_rate: float = 0.0
    node_flap_rate: float = 0.0
    flap_down_s: float = 4.0  # how long a flapping node stays gone
    # Interconnect topology (topology/): consecutive node indices group into
    # slices of ``slice_size`` and racks of ``rack_size`` nodes (0 = level
    # absent).  The harness turns these into the default topology node
    # labels, which topology-enables the scheduler under test.
    slice_size: int = 0
    rack_size: int = 0
    # Whole-rack outages: at each listed virtual time, one rack (picked by a
    # seeded draw against the live rack list) fails outright — every node in
    # it vanishes and its pods re-arrive Pending (the rack-power-loss /
    # spine-failure event gangs must survive).
    rack_fail_times: tuple[float, ...] = ()


@dataclass(frozen=True)
class SimEvent:
    t: float
    kind: str  # pods | node-add | node-drain | node-fail | node-flap
    payload: dict = field(default_factory=dict)


def _pod_spec(rng: random.Random, spec: WorkloadSpec, name: str, gang: str | None) -> dict:
    """One pod as a primitives-only dict (trace/JSONL-safe)."""
    p: dict = {
        "name": name,
        "cpu_m": rng.choice(spec.pod_cpu_m),
        "mem_mi": rng.choice(spec.pod_mem_mi),
        "priority": rng.choice(spec.priority_tiers),
        "app": f"app-{rng.randrange(24)}",
    }
    if gang:
        p["gang"] = gang
    if spec.selector_fraction and rng.random() < spec.selector_fraction:
        p["zone"] = rng.choice(ZONES)
    if spec.lifetime_mean_s > 0:
        p["lifetime_s"] = round(rng.expovariate(1.0 / spec.lifetime_mean_s), 6)
    return p


def _arrival_group(rng: random.Random, spec: WorkloadSpec, seq_start: int) -> tuple[list[dict], int]:
    """One arrival: a single pod, or a whole gang of 2..gang_size_max."""
    seq = seq_start
    if spec.gang_fraction and rng.random() < spec.gang_fraction:
        size = rng.randrange(2, spec.gang_size_max + 1)
        gang = f"gang-{seq}"
        pods = []
        for _ in range(size):
            pods.append(_pod_spec(rng, spec, f"sim-p{seq}", gang))
            seq += 1
        # Gang members share one priority — mixed-priority gangs would split
        # across segments and be refused forever by design.
        prio = pods[0]["priority"]
        for p in pods:
            p["priority"] = prio
        return pods, seq
    pod = _pod_spec(rng, spec, f"sim-p{seq}", None)
    return [pod], seq + 1


def generate_events(spec: WorkloadSpec, duration: float, rng: random.Random) -> list[SimEvent]:
    """The full timed event stream for one run — deterministic in (spec,
    duration, rng seed).  Sorted by (t, stream priority, index)."""
    streams: list[tuple[float, int, int, SimEvent]] = []

    # Poisson arrivals (stream 0).
    arr_rng = random.Random(rng.randrange(1 << 62))
    t, seq, idx = 0.0, 0, 0
    if spec.arrival_rate > 0 and spec.diurnal_period > 0:
        # Thinning (Lewis–Shedler): draw at the peak rate, accept with
        # probability rate(t)/peak.  Gated on diurnal_period so the flat
        # path below stays draw-for-draw identical to every older trace.
        import math

        peak = spec.arrival_rate * (1.0 + abs(spec.diurnal_amplitude))
        while True:
            t += arr_rng.expovariate(peak)
            if t >= duration:
                break
            rate_t = spec.arrival_rate * (
                1.0 + spec.diurnal_amplitude * math.sin(2.0 * math.pi * t / spec.diurnal_period)
            )
            if arr_rng.random() * peak > rate_t:
                continue
            pods, seq = _arrival_group(arr_rng, spec, seq)
            streams.append((t, 0, idx, SimEvent(round(t, 6), "pods", {"pods": pods})))
            idx += 1
    elif spec.arrival_rate > 0:
        while True:
            t += arr_rng.expovariate(spec.arrival_rate)
            if t >= duration:
                break
            pods, seq = _arrival_group(arr_rng, spec, seq)
            streams.append((t, 0, idx, SimEvent(round(t, 6), "pods", {"pods": pods})))
            idx += 1

    # Bursts (stream 1) — a storm is one event with n fully-sampled pods.
    burst_rng = random.Random(rng.randrange(1 << 62))
    for i, (bt, n) in enumerate(spec.bursts):
        pods = []
        while len(pods) < n:
            group, seq = _arrival_group(burst_rng, spec, seq)
            pods.extend(group)
        streams.append((float(bt), 1, i, SimEvent(round(float(bt), 6), "pods", {"pods": pods})))

    # Node churn processes (streams 2..5), each an independent Poisson.
    for stream, (kind, rate) in enumerate(
        (
            ("node-add", spec.node_add_rate),
            ("node-drain", spec.node_drain_rate),
            ("node-fail", spec.node_fail_rate),
            ("node-flap", spec.node_flap_rate),
        ),
        start=2,
    ):
        churn_rng = random.Random(rng.randrange(1 << 62))
        if rate <= 0:
            continue
        ct, i = 0.0, 0
        node_seq = spec.initial_nodes
        while True:
            ct += churn_rng.expovariate(rate)
            if ct >= duration:
                break
            if kind == "node-add":
                payload = _node_payload(node_seq, churn_rng, spec)
                node_seq += 1
            elif kind == "node-flap":
                payload = {"pick": churn_rng.random(), "down_s": spec.flap_down_s}
            else:
                payload = {"pick": churn_rng.random()}
            streams.append((ct, stream, i, SimEvent(round(ct, 6), kind, payload)))
            i += 1

    # Whole-rack outages (stream 6) — fixed times from the spec, the rack
    # picked by a seeded draw resolved against the live rack list at apply
    # time (same ``pick`` convention as the node-targeting events).
    rack_rng = random.Random(rng.randrange(1 << 62))
    for i, rt in enumerate(spec.rack_fail_times):
        streams.append(
            (float(rt), 6, i, SimEvent(round(float(rt), 6), "rack-fail", {"pick": rack_rng.random()}))
        )

    streams.sort(key=lambda e: (e[0], e[1], e[2]))
    return [ev for _, _, _, ev in streams]


def _topology_fields(i: int, spec: WorkloadSpec) -> dict:
    """Per-node slice/rack assignment from the consecutive-index grouping."""
    out: dict = {}
    if spec.slice_size > 0:
        out["slice"] = f"slice-{i // spec.slice_size}"
    if spec.rack_size > 0:
        out["rack"] = f"rack-{i // spec.rack_size}"
    return out


def _node_payload(i: int, rng: random.Random, spec: WorkloadSpec) -> dict:
    cores, gib = NODE_SHAPES[rng.randrange(len(NODE_SHAPES))]
    return {"name": f"sim-n{i}", "cpu": cores, "mem_gi": gib, "zone": ZONES[i % len(ZONES)], **_topology_fields(i, spec)}


def initial_nodes(spec: WorkloadSpec) -> list[dict]:
    """The t=0 fleet — shapes round-robin over the tiers (no rng: the
    starting cluster is part of the scenario, not the sample)."""
    out = []
    for i in range(spec.initial_nodes):
        cores, gib = NODE_SHAPES[i % len(NODE_SHAPES)]
        out.append(
            {"name": f"sim-n{i}", "cpu": cores, "mem_gi": gib, "zone": ZONES[i % len(ZONES)], **_topology_fields(i, spec)}
        )
    return out
