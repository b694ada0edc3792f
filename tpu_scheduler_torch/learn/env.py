"""``SchedulerEnv`` — gym-style episodes over the deterministic simulator.

Wraps ``sim/harness.py scenario_episode`` (the discrete-event loop as a
generator) into the step/observe/act interface black-box search climbs:

  observe — a per-cycle feature summary (``OBSERVATION_FIELDS``): pending
            census by SLO tier and gangness, residual-capacity percentiles
            across the node fleet, backlog age, and topology fragmentation.
  act     — a policy vector over ``ACTION_KNOBS`` (the ``SchedulingProfile``
            score-weight surface), installed fleet-wide for the next cycle
            window; ``None`` keeps the current profile (a None-only episode
            is bit-identical to a plain ``run_scenario``).
  reward  — episodic: 0.0 every non-terminal step, and the scorecard
            ``policy`` objective (learn/objective.py) on the terminal one.

Determinism: the env adds NO randomness — every draw still derives from
the one scenario seed inside the harness, observations are pure functions
of the yielded ``EpisodeContext``, and all floats are rounded to 6 decimals
— so the same (scenario, seed, action sequence) produces a byte-identical
observation/reward trajectory in any process.

Port: a copy of ``tpu_scheduler/learn/env.py``, unchanged; an episode with no
``backend`` runs on the card (the port harness's default ``CudaBackend()``).
"""

from __future__ import annotations

from ..api.objects import is_pod_bound
from ..core.snapshot import ClusterSnapshot, node_allocatable, node_used_resources
from ..sim.harness import scenario_episode
from ..sim.scorecard import _percentile
from ..utils.profiler import tier_of

__all__ = ["OBSERVATION_FIELDS", "ACTION_KNOBS", "SchedulerEnv", "action_profile", "observe"]

# The closed observation schema: field name -> position in every
# observation dict (drift-gated against the README "Learned policy &
# tuning" catalogue by the LERN analyze rule).  Strictly virtual-time /
# control-flow quantities — wall clock never appears.
OBSERVATION_FIELDS = (
    "virtual_time",        # clock.now (virtual seconds)
    "pending_total",       # pods awaiting placement
    "pending_gang_pods",   # pending pods that belong to a gang
    "pending_gangs",       # distinct gangs with a pending member
    "pending_critical",    # pending census by SLO tier (utils/profiler.py)
    "pending_high",
    "pending_default",
    "pending_best_effort",
    "backlog_age_mean",    # mean pending age vs nominal arrival (virtual s)
    "backlog_age_max",     # oldest pending pod's age
    "free_cpu_frac_p10",   # residual-capacity percentiles across nodes
    "free_cpu_frac_p50",
    "free_cpu_frac_p90",
    "frag_free_cpu",       # 1 - largest single rack's share of free CPU
)

# The closed action surface: (SchedulingProfile field, lower, upper).  A
# policy vector indexes this tuple; ``action_profile`` clips each entry
# into its bounds, so every action is a VALID profile — validity and
# capacity stay exact no matter what the optimizer proposes.  The bounds
# are the solver's operating envelope, not just sanity limits:
# ``least_requested_weight`` is floored at 0.25 because a negative weight
# (most-requested packing) makes every pod bid the same fullest node and
# the auction's round budget explodes at flagship scale (measured: 97
# rounds vs 8 on 4000x400, half the wave unplaced at max_rounds=32), and
# a zero weight leaves equally-free nodes score-tied, which costs rounds
# the same way (1.35x delta-cycle at the bench shape) — packing density
# belongs to the background rebalancer tier, off the hot path, not to
# the per-cycle score vector.
ACTION_KNOBS = (
    ("least_requested_weight", 0.25, 4.0),
    ("balanced_allocation_weight", 0.0, 4.0),
    ("spread_jitter", 0.0, 64.0),
    ("preferred_affinity_weight", 0.0, 4.0),
    ("soft_taint_weight", 0.0, 40.0),
    ("topology_weight", 0.0, 8.0),
    ("gang_locality_weight", 0.0, 256.0),
)


def action_profile(base, vec):
    """Clip a raw policy vector into ``ACTION_KNOBS`` bounds and graft it
    onto ``base`` (preemption/driver/blocks untouched)."""
    # shape: (base: obj, vec: obj) -> obj
    if len(vec) != len(ACTION_KNOBS):
        raise ValueError(f"action vector has {len(vec)} entries, expected {len(ACTION_KNOBS)}")
    kw = {}
    for (name, lo, hi), raw in zip(ACTION_KNOBS, vec):
        kw[name] = round(min(hi, max(lo, float(raw))), 6)
    return base.with_(**kw)


def observe(ctx) -> dict:
    """The per-cycle feature summary, computed lazily from the yielded
    ``EpisodeContext`` — plain ``run_scenario`` drives never call this, so
    ordinary runs pay nothing for the observation surface."""
    # shape: (ctx: obj) -> obj
    now = ctx.clock.now
    pods = ctx.api.list_pods()
    nodes = ctx.api.list_nodes()
    pending = [p for p in pods if p.status.phase == "Pending" and not is_pod_bound(p)]

    tiers = {"critical": 0, "high": 0, "default": 0, "best-effort": 0}
    gang_pods = 0
    gangs: set[str] = set()
    ages: list[float] = []
    for p in pending:
        prio = p.spec.priority if p.spec is not None and p.spec.priority else 0
        tiers[tier_of(prio)] += 1
        if p.spec is not None and p.spec.gang:
            gang_pods += 1
            gangs.add(p.spec.gang)
        at = ctx.state.arrival_t.get(p.metadata.name)
        if at is not None:
            ages.append(max(0.0, now - at))

    # Residual capacity: free-CPU fraction per node, plus how concentrated
    # the free pool is across racks (a fragmented fleet has plenty of free
    # CPU but no single rack that fits a gang).
    snap = ClusterSnapshot.build(nodes, pods)
    fracs: list[float] = []
    rack_free: dict[str, float] = {}
    total_free = 0.0
    for n in snap.nodes:
        alloc = node_allocatable(n)
        if alloc.cpu <= 0:
            continue
        free = max(0.0, float(alloc.cpu) - float(node_used_resources(snap, n.name).cpu))
        fracs.append(free / float(alloc.cpu))
        total_free += free
        rack = ctx.state.node_domains.get(n.name, {}).get("rack")
        if rack is not None:
            rack_free[rack] = rack_free.get(rack, 0.0) + free
    fracs.sort()
    frag = 0.0
    if total_free > 0 and rack_free:
        frag = 1.0 - max(rack_free.values()) / total_free

    obs = {
        "virtual_time": round(now, 6),
        "pending_total": len(pending),
        "pending_gang_pods": gang_pods,
        "pending_gangs": len(gangs),
        "pending_critical": tiers["critical"],
        "pending_high": tiers["high"],
        "pending_default": tiers["default"],
        "pending_best_effort": tiers["best-effort"],
        "backlog_age_mean": round(sum(ages) / len(ages), 6) if ages else 0.0,
        "backlog_age_max": round(max(ages), 6) if ages else 0.0,
        "free_cpu_frac_p10": round(_percentile(fracs, 0.10), 6),
        "free_cpu_frac_p50": round(_percentile(fracs, 0.50), 6),
        "free_cpu_frac_p90": round(_percentile(fracs, 0.90), 6),
        "frag_free_cpu": round(frag, 6),
    }
    assert tuple(obs) == OBSERVATION_FIELDS, "observation drifted from OBSERVATION_FIELDS"
    return obs


class SchedulerEnv:
    """One episode = one seeded scenario run.  ``reset`` starts the
    generator and returns the first observation; ``step(action)`` installs
    the (optional) policy vector for the next ``window`` cycles and returns
    ``(obs, reward, done, info)``.  After the terminal step ``info`` holds
    the full scorecard under ``"scorecard"``."""

    def __init__(self, scenario, seed: int = 0, backend=None, window: int = 1, topology="auto", rebalance="auto"):
        # shape: (self: obj, scenario: obj, seed: int, backend: obj, window: int, topology: obj, rebalance: obj) -> obj
        if window < 1:
            raise ValueError("window must be >= 1")
        self.scenario = scenario
        self.seed = seed
        self.backend = backend
        self.window = window
        self.topology = topology
        self.rebalance = rebalance
        self._gen = None
        self._ctx = None
        self.card: dict | None = None

    def reset(self) -> dict:
        """Start (or restart) the episode; returns the first observation."""
        # shape: (self: obj) -> obj
        self.card = None
        self._gen = scenario_episode(
            self.scenario,
            seed=self.seed,
            backend=self.backend,
            topology=self.topology,
            rebalance=self.rebalance,
        )
        self._ctx = next(self._gen)
        return observe(self._ctx)

    def base_profile(self):
        """The profile the fleet is currently scheduling with (the action
        vector grafts onto this, preserving preemption/driver)."""
        # shape: (self: obj) -> obj
        if self._ctx is None:
            raise RuntimeError("call reset() first")
        return self._ctx.fleet.scheds[0].profile

    def step(self, action=None):
        """Advance ``window`` cycles under ``action`` (a policy vector over
        ``ACTION_KNOBS``, or None to keep the current profile)."""
        # shape: (self: obj, action: obj) -> obj
        if self._gen is None:
            raise RuntimeError("call reset() first")
        send = action_profile(self.base_profile(), action) if action is not None else None
        try:
            for _ in range(self.window):
                self._ctx = self._gen.send(send)
                send = None  # the profile persists; install once per step
        except StopIteration as stop:
            self.card = stop.value
            self._gen = None
            reward = round(float(self.card["policy"]["objective"]), 6)
            return observe_terminal(self.card), reward, True, {"scorecard": self.card}
        return observe(self._ctx), 0.0, False, {}


def observe_terminal(card: dict) -> dict:
    """The terminal observation: all-zero pending census at the final
    virtual time (the episode is drained or out of budget either way)."""
    # shape: (card: obj) -> obj
    obs = dict.fromkeys(OBSERVATION_FIELDS, 0.0)
    obs["virtual_time"] = round(float(card["virtual_seconds"]), 6)
    obs["pending_total"] = int(card["pods"]["pending_final"])
    return obs
