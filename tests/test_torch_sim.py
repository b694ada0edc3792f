"""The simulator slice: ``tpu_scheduler_torch.sim`` against the JAX package's
``tpu_scheduler.sim`` over ``NativeBackend``, on the same seeds.

The modules first, on the same inputs, with exact equality as the
tolerance: the workload generator's event lists and t=0 fleets, the virtual
clock's firing order, the chaos layer's decisions under one fixed rng, the
trace format (each package reads what the other wrote), the scenario
registry, and the scorecard's ``fingerprint``, ``check_invariants``,
``build_latency_block`` and ``policy_block``.  Then whole episodes at the
scenarios' own sizes, the port over ``CudaBackend(device="cpu")``: the
fingerprint (the binding sequence and the final placements) equal outright,
and the whole scorecard equal outside :data:`ALLOWED_DIFFERENCES`.  Then
traces recorded by either package replayed through the other, the CLI
(``sim --device cpu`` prints the JAX CLI's card), the five multi-replica
scenarios at seed 0 (cards equal, traces replayed across the packages both
ways, the card unchanged under another string-hash seed), the eight
scenarios of the rebalancer and the autoscaler at seed 0 (cards equal,
traces across the packages) and their ``rebalance``/``autoscale``
switches, the default backend's refusal to run without CUDA, and the
``compile`` block's wiring to the kernel-build counter.  All 25 scenarios ×
seeds 0 and 1 run under ``slow``, as ``tests/test_sim.py`` runs the JAX
sim's."""

import dataclasses
import json
import logging
import os
import random
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.sim.chaos as jax_chaos  # noqa: E402
import tpu_scheduler.sim.clock as jax_clock  # noqa: E402
import tpu_scheduler.sim.harness as jax_harness  # noqa: E402
import tpu_scheduler.sim.scenarios as jax_scenarios  # noqa: E402
import tpu_scheduler.sim.scorecard as jax_scorecard  # noqa: E402
import tpu_scheduler.sim.trace as jax_trace  # noqa: E402
import tpu_scheduler.sim.workload as jax_workload  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
from tpu_scheduler.learn.objective import policy_block as jax_policy_block  # noqa: E402
from tpu_scheduler.rebalance import packing_stats as jax_packing_stats  # noqa: E402
from tpu_scheduler.runtime.fake_api import FakeApiServer as JaxFakeApiServer  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.sim.chaos as chaos  # noqa: E402
import tpu_scheduler_torch.sim.cli as sim_cli  # noqa: E402
import tpu_scheduler_torch.sim.clock as clock  # noqa: E402
import tpu_scheduler_torch.sim.harness as harness  # noqa: E402
import tpu_scheduler_torch.sim.scenarios as scenarios  # noqa: E402
import tpu_scheduler_torch.sim.scorecard as scorecard  # noqa: E402
import tpu_scheduler_torch.sim.trace as trace  # noqa: E402
import tpu_scheduler_torch.sim.workload as workload  # noqa: E402
import tpu_scheduler_torch.utils.profiler as profiler  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.errors import BackendUnavailable  # noqa: E402
from tpu_scheduler_torch.learn.objective import policy_block  # noqa: E402
from tpu_scheduler_torch.rebalance import packing_stats  # noqa: E402
from tpu_scheduler_torch.runtime.fake_api import FakeApiServer  # noqa: E402

logging.getLogger("tpu_scheduler").setLevel(logging.ERROR)
logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The closed allow-list of scorecard fields that may differ between the
# port's card and the JAX sim's over NativeBackend, each with its reason.
# Empty: every block is equal — the profile block's span census included,
# once the JAX census is carried over to the port's by ``port_census``
# (the port's round loop opens NativeBackend's round spans).
ALLOWED_DIFFERENCES: dict[str, str] = {}

# The span paths whose census counts differ between the packages, each with
# its reason and the count the port's control flow gives it from the card's
# own numbers: ``syncs`` the census count of ``sync`` (one a cycle),
# ``full_solves`` the incremental block's full-wave commits.
PORT_CENSUS_PATHS = (
    ("sync/poll", "the reflector's watch polls, timed apart from the fold: one a reflector a sync",
     lambda syncs, full_solves: 2 * syncs),
    ("sync/fold", "the event folds into the stores and the index: one a reflector, then the batch-listener flush",
     lambda syncs, full_solves: 3 * syncs),
    ("sync/snapshot", "the reflector's snapshot build, timed apart from the fold: one a sync",
     lambda syncs, full_solves: syncs),
    ("delta/commit/rebuild", "the SolveState rebuild after a full wave, timed apart from the commit: one a "
     "full-wave commit", lambda syncs, full_solves: full_solves),
    ("overlay/bind", "removed: the pipelined bind drain, recorded at fold with a made-up interval, is timed on "
     "the worker's own lane; the sim never pipelines binds, so no census has it", lambda syncs, full_solves: 0),
)


def port_census(jax_card: dict) -> dict[str, int]:
    """The span census the port's card must carry: the JAX card's, with
    each path of :data:`PORT_CENSUS_PATHS` at the count its rule gives
    (a path at 0 is absent, as the census leaves it)."""
    census = dict(jax_card["profile"]["span_census"])
    syncs, full_solves = census.get("sync", 0), jax_card["incremental"]["full_solves"]
    for path, _reason, rule in PORT_CENSUS_PATHS:
        census.pop(path, None)
        count = rule(syncs, full_solves)
        if count:
            census[path] = count
    return dict(sorted(census.items()))


def port_card_of(jax_card: dict) -> dict:
    """The JAX card with its span census carried over to the port's."""
    return {**jax_card, "profile": {**jax_card["profile"], "span_census": port_census(jax_card)}}


# The scenarios with more than one replica (the sharded control plane and
# the fleet).
MULTI_REPLICA = (
    "replica-kill-mid-cycle",
    "mesh-rebind-on-takeover",
    "cross-shard-gang-admission",
    "replica-kill-during-brownout",
    "lease-brownout-during-takeover",
)

# The scenarios with the rebalancer, the autoscaler, or both.
ITEM9 = (
    "rebalance-under-chaos",
    "fragmentation-long-horizon",
    "defrag-smoke",
    "autoscaler-backlog-whatif",
    "diurnal-traffic",
    "flash-crowd-provisioning-lag",
    "spot-reclaim-storm",
    "quota-capped-surge",
)

# Every registered scenario: the port runs all 25.
IN_SCOPE = MULTI_REPLICA + ITEM9 + (
    "steady-state",
    "burst-storm",
    "arrival-rate-sweep",
    "node-flap",
    "api-brownout",
    "api-brownout-recovery",
    "gang-heavy",
    "slice-fragmented-cluster",
    "rack-failure-during-gang-admission",
    "churn-steady-state",
    "train-smoke",
    "sim-smoke",
)

def _cpu():
    return CudaBackend(device="cpu")


@pytest.fixture(autouse=True)
def _jax_compile_listener_off():
    """The JAX sim's ``compile.enabled`` reads a process-wide flag that any
    ``TpuBackend`` built earlier in the process turns on; the cards held
    here are NativeBackend runs, for which the flag is off."""
    import tpu_scheduler.utils.profiler as jax_profiler

    saved = jax_profiler._hooks_installed[0]
    jax_profiler._hooks_installed[0] = False
    yield
    jax_profiler._hooks_installed[0] = saved


def _diff(a, b, path=""):
    """Paths (``/block/field``) where two JSON-like values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                out.append(f"{path}/{k}")
            else:
                out.extend(_diff(a[k], b[k], f"{path}/{k}"))
        return out
    return [] if a == b else [path]


def _hold(port_card: dict, jax_card: dict) -> None:
    """Fingerprints equal; the whole card equal outside the allow-list; the
    verdict passes with no pod lost or double-bound."""
    assert port_card["fingerprint"] == jax_card["fingerprint"]
    differing = [p for p in _diff(port_card, port_card_of(jax_card)) if p not in ALLOWED_DIFFERENCES]
    assert differing == [], differing
    assert port_card["pass"], json.dumps(port_card["invariants"])
    assert port_card["pods"]["lost"] == 0 and port_card["pods"]["double_bound"] == 0


def _both(name: str, seed: int, **kw) -> tuple[dict, dict]:
    """(the port's card over CudaBackend on the CPU, the JAX sim's card over
    NativeBackend) of one registered scenario and seed."""
    port = harness.run_scenario(name, seed=seed, backend=_cpu(), **kw)
    jax = jax_harness.run_scenario(name, seed=seed, backend=NativeBackend())
    return port, jax


# --- modules -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jax_scenarios.SCENARIOS))
def test_scenario_data_and_events_equal(name):
    """Every registered scenario: the same fields, the same t=0 fleet and the
    same generated event list for seeds 0 and 1."""
    jsc, psc = jax_scenarios.SCENARIOS[name], scenarios.SCENARIOS[name]
    assert dataclasses.asdict(psc) == dataclasses.asdict(jsc)
    assert workload.initial_nodes(psc.workload) == jax_workload.initial_nodes(jsc.workload)
    for seed in (0, 1):
        ev_p = workload.generate_events(psc.workload, psc.duration, random.Random(f"{seed}:workload"))
        ev_j = jax_workload.generate_events(jsc.workload, jsc.duration, random.Random(f"{seed}:workload"))
        assert [(e.t, e.kind, e.payload) for e in ev_p] == [(e.t, e.kind, e.payload) for e in ev_j]


def test_registry_and_variants_equal():
    assert list(scenarios.SCENARIOS) == list(jax_scenarios.SCENARIOS)
    for rate in (5, 15, 40):
        assert dataclasses.asdict(scenarios.arrival_rate_variant(rate)) == dataclasses.asdict(
            jax_scenarios.arrival_rate_variant(rate))
    assert set(IN_SCOPE) == set(scenarios.SCENARIOS) and len(IN_SCOPE) == len(set(IN_SCOPE)) == 25


def test_virtual_clock_fires_in_the_same_order():
    """One schedule of callbacks (ties, past times, callbacks that schedule
    more) fires in the same order at the same times on both clocks."""
    def drive(mod):
        c = mod.VirtualClock(start=1.5)
        fired = []

        def ev(tag, again=None):
            def fn():
                fired.append((tag, c.now))
                if again is not None:
                    c.schedule_in(again, ev(tag + "'"))
            return fn

        for tag, at, again in (("b", 5.0, None), ("a", 2.0, 0.5), ("a2", 2.0, None), ("past", 0.0, None),
                               ("c", 2.5, 0.0), ("d", 9.0, None)):
            c.schedule(at, ev(tag, again))
        c.advance(2.0)
        c.sleep(1.0)
        nxt = c.next_event_at()
        c.advance_to(20.0)
        return fired, nxt, c()

    assert drive(clock) == drive(jax_clock)


def _chaos_run(mod, fake_mod, objects_mod, testing_mod, replay=None):
    cfg = mod.ChaosConfig(
        binding_error_rate=0.2, api_error_rate=0.3, watch_drop_rate=0.25, watch_gone_rate=0.1,
        lease_error_rate=0.2, lease_refused_rate=0.2,
        windows=(mod.ChaosWindow(start=2.0, end=4.0, binding_error_rate=0.9, binding_latency_s=0.01),),
    )
    clk = (clock if mod is chaos else jax_clock).VirtualClock()
    inner = fake_mod(clock=clk)
    api = mod.ChaosApiServer(inner, cfg, rng=random.Random("7:chaos"), clock=clk, replay_decisions=replay)
    inner.create_node(testing_mod.make_node("n0", cpu=8, memory="32Gi"))
    watch = api.watch_pods()
    outcomes = []
    for i in range(40):
        clk.advance(0.15)
        inner.create_pod(testing_mod.make_pod(f"p{i}", cpu="100m", memory="64Mi"))
        for call in (
            lambda: api.create_binding("default", f"p{i}", objects_mod.ObjectReference(kind="Node", name="n0")),
            lambda: watch.poll(),
            lambda: api.list_pdbs(),
            lambda: api.acquire_lease(f"l{i % 3}", "me", 5.0),
            lambda: api.get_lease(f"l{i % 3}"),
        ):
            try:
                r = call()
                outcomes.append(("ok", len(r) if isinstance(r, list) else r is not None))
            except Exception as e:  # noqa: BLE001 — the fault kind is the outcome
                outcomes.append((type(e).__name__, str(e)))
    return api.decision_log, dict(api.injected), api.bind_log, outcomes


def test_chaos_decisions_equal_under_one_rng():
    """The same calls against each package's chaos layer with one fixed rng
    draw the same decisions, inject the same faults and confirm the same
    bindings; replaying the port's decisions reproduces them."""
    import tpu_scheduler.api.objects as jax_objects
    import tpu_scheduler_torch.testing as testing

    port = _chaos_run(chaos, FakeApiServer, objects, testing)
    jax = _chaos_run(jax_chaos, JaxFakeApiServer, jax_objects, jax_testing)
    assert port == jax
    assert port[1] and port[2]  # faults were injected and binds confirmed
    replayed = _chaos_run(chaos, FakeApiServer, objects, testing, replay=port[0])
    assert replayed[1:] == port[1:]


def test_trace_format_round_trips_across_packages(tmp_path):
    """A trace written by either package loads, equal, through both."""
    card = {"pass": True, "nested": {"x": [1, 2.5]}}
    for i, mod in enumerate((trace, jax_trace)):
        path = str(tmp_path / f"t{i}.jsonl")
        w = mod.TraceWriter(path)
        w.header("sim-smoke", 3, "cuda")
        w.action(0.1 + 0.2, {"op": "create_pod", "pod": {"name": "p0", "cpu_m": 100}})
        w.chaos("bind-500", True, 0.0)
        w.cycle(1.0, 1, 2, 3)
        w.footer("f" * 64, card)
        w.close()
        loaded = trace.load_trace(path)
        assert loaded == jax_trace.load_trace(path)
        assert loaded["actions"][0][0] == 0.1 + 0.2  # exact floats, not rounded
        assert loaded["header"]["version"] == jax_trace.TRACE_VERSION == trace.TRACE_VERSION


def test_fingerprint_invariants_latency_policy_equal():
    """The scorecard's functions on the same inputs: a cluster with a
    capacity violation, a gang left half-admitted and a cordoned node."""
    import tpu_scheduler.api.objects as jax_objects

    nodes = [jax_testing.make_node(f"n{i}", cpu=2, memory="4Gi", labels={"zone": "zone-a"}) for i in range(3)]
    pods = [
        jax_testing.make_pod("a", cpu="1500m", memory="1Gi", node_name="n0"),
        jax_testing.make_pod("b", cpu="1000m", memory="1Gi", node_name="n0"),  # n0 oversubscribed
        jax_testing.make_pod("g1", cpu="100m", memory="64Mi", node_name="n1", gang="g"),
        jax_testing.make_pod("g2", cpu="100m", memory="64Mi", gang="g"),  # gang half-admitted
        jax_testing.make_pod("z", cpu="100m", memory="64Mi", node_name="n2", node_selector={"zone": "zone-b"}),
    ]
    japi, papi = JaxFakeApiServer(), FakeApiServer()
    japi.load(nodes, pods)
    papi.load([objects.Node.from_dict(jax_objects.node_to_dict(n)) for n in nodes],
              [objects.Pod.from_dict(jax_objects.pod_to_dict(p)) for p in pods])
    args = ({"a", "b", "g1", "g2", "z"}, set(), {"n9"}, {"g": {"g1", "g2"}})
    inv = scorecard.check_invariants(papi, *args)
    assert inv == jax_scorecard.check_invariants(japi, *args)
    assert not inv["capacity"]["ok"] and not inv["gangs"]["ok"] and not inv["selectors"]["ok"]

    bind_log = [(0.5, "default/a", "n0"), (1.25, "default/g1", "n1")]
    placements = [("a", "n0"), ("g1", "n1")]
    assert scorecard.fingerprint(bind_log, placements) == jax_scorecard.fingerprint(bind_log, placements)

    wf = lambda ttb, seg: {"ttb": ttb, "segments": seg, "unattributed": 0.0}  # noqa: E731
    samples = [("default", wf(1.5, {"queue": 1.0, "cadence-wait": 0.5})),
               ("high", wf(0.25, {"queue": 0.25, "cadence-wait": 0.0})),
               ("default", wf(3.0, {"queue": 2.0, "cadence-wait": 0.5}))]
    leaky = [("default", wf(4.0, {"queue": 1.0, "cadence-wait": 0.5}))]
    for given, kw in ((samples, {"bound_total": 4, "required": True}), (samples, {"bound_total": None}),
                      ([], {"bound_total": 0, "required": True}), (leaky, {"bound_total": 1, "required": True})):
        assert scorecard.build_latency_block(given, **kw) == jax_scorecard.build_latency_block(given, **kw)

    blocks = dict(slo={"p99_time_to_bind_s": 7.5, "preemption_churn": 3},
                  pod_counts={"arrived": 40, "churn_recreated": 4, "bound_total": 38, "migrated": 2},
                  locality={"enabled": True, "gangs_scored": 5, "cross_rack_gangs": 1},
                  rebalance={"packing_efficiency": 0.8125}, required=True, floor=1.0)
    assert policy_block(**blocks) == jax_policy_block(**blocks)
    import numpy as np

    alloc = np.array([[4000, 8 << 30], [2000, 4 << 30], [1000, 1 << 30]], dtype=np.int64)
    used = np.array([[3000, 1 << 30], [0, 0], [1200, 1 << 29]], dtype=np.int64)
    assert packing_stats(alloc, used) == jax_packing_stats(alloc, used)


# --- episodes ----------------------------------------------------------------


@pytest.mark.parametrize("name,seed", [("sim-smoke", 0), ("slice-fragmented-cluster", 0), ("train-smoke", 0)])
def test_episode_matches_the_jax_sim(name, seed):
    port, jax = _both(name, seed)
    _hold(port, jax)
    if name != "sim-smoke":
        assert port["locality"]["enabled"] and port["locality"]["gangs_scored"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_arrival_rate_sweep_matches_and_replays(seed, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    port, jax = _both("arrival-rate-sweep", seed, record=path)
    _hold(port, jax)
    replayed = harness.run_scenario(None, replay=path, backend=_cpu())
    assert replayed["fingerprint"] == port["fingerprint"] and replayed["mode"] == "replay"
    assert _diff(replayed, port) == ["/mode"]


@pytest.mark.parametrize("seed", [0, 1])
def test_churn_steady_state_shadow_parity_and_replay(seed, tmp_path):
    """``tests/test_delta.py``'s simulator-driven gate on the port: zero
    shadow mismatches, full_solve_fraction <= 0.10, record→replay
    bit-identity — and the JAX sim's card."""
    path = str(tmp_path / "trace.jsonl")
    port, jax = _both("churn-steady-state", seed, record=path)
    _hold(port, jax)
    inc = port["incremental"]
    assert inc["required"] and inc["ok"]
    assert inc["shadow_checks"] > 0 and inc["shadow_mismatches"] == 0
    assert inc["full_solve_fraction"] <= 0.10
    replayed = harness.run_scenario("churn-steady-state", seed=seed, replay=path, backend=_cpu())
    assert replayed["fingerprint"] == port["fingerprint"]
    assert replayed["incremental"] == inc


@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_traces_replay_across_packages(recorder, tmp_path):
    """sim-smoke (node churn, chaos decisions, a brownout window) recorded
    by one package replays through the other with an equal fingerprint."""
    path = str(tmp_path / "trace.jsonl")
    if recorder == "jax":
        card = jax_harness.run_scenario("sim-smoke", seed=1, backend=NativeBackend(), record=path)
        replayed = harness.run_scenario(None, replay=path, backend=_cpu())
    else:
        card = harness.run_scenario("sim-smoke", seed=1, backend=_cpu(), record=path)
        assert trace.load_trace(path)["header"]["backend"] == "cuda"
        replayed = jax_harness.run_scenario(None, replay=path, backend=NativeBackend())
    assert replayed["fingerprint"] == card["fingerprint"]
    assert replayed["pass"] and card["pass"]


def _cli(module: str, *args: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


@pytest.mark.parametrize("name", MULTI_REPLICA)
def test_multi_replica_scenario_matches_the_jax_sim(name, tmp_path, monkeypatch):
    """N replicas over lease-owned shards on the port against the JAX sim:
    the whole card equal with an empty allow-list, availability and
    convergence passing, the scenario's own evidence (``tests/
    test_multi_replica_sim.py``, ``tests/test_multi_mesh_sim.py``: a kill
    absorbed within 2 × lease, the mesh-rebind wave, two-phase gang
    reservations), and each package's trace replayed through the other with
    an equal fingerprint."""
    from tpu_scheduler_torch.fleet.reservation import GangReservationLedger
    from tpu_scheduler_torch.sim.multi import AVAILABILITY_FIELDS

    calls = []
    orig = GangReservationLedger.reserve
    monkeypatch.setattr(GangReservationLedger, "reserve",
                        lambda self, gang, peers: calls.append(gang) or orig(self, gang, peers))
    jax_path, port_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    port = harness.run_scenario(name, seed=0, backend=_cpu(), record=port_path)
    jax = jax_harness.run_scenario(name, seed=0, backend=NativeBackend(), record=jax_path)
    _hold(port, jax)
    a = port["availability"]
    assert tuple(a) == AVAILABILITY_FIELDS
    assert a["enabled"] and a["ok"] and a["replicas"] > 1 and a["double_binds"] == 0 and a["orphaned_pods"] == 0
    assert a["orphaned_reservations"] == 0
    assert port["convergence"]["ok"] or not port["convergence"]["required"]
    sc = scenarios.SCENARIOS[name]
    if sc.replica_kills:
        assert len(a["kills"]) >= 1 and a["kills"][0]["orphan_shards"]
        assert a["max_takeover_latency_s"] <= a["takeover_bound_s"] + a["lease_outage_credit_s"]
    if name == "mesh-rebind-on-takeover":
        esc = port["incremental"]["escalations"]
        assert esc.get("mesh-rebind", 0) >= 1 and esc.get("takeover", 0) >= 1, esc
    if name == "cross-shard-gang-admission":
        assert calls and a["kills"] == []
    assert jax_harness.run_scenario(None, replay=port_path, backend=NativeBackend())["fingerprint"] == \
        port["fingerprint"]
    assert harness.run_scenario(None, replay=jax_path, backend=_cpu())["fingerprint"] == jax["fingerprint"]


def test_multi_replica_cards_are_independent_of_the_string_hash_seed():
    """The keyer's node sets, the reservation peers and the lease scans walk
    sets and dicts: the port's cards of two multi-replica scenarios are the
    same under PYTHONHASHSEED 1 and 2, and equal the JAX CLI's."""
    for name in ("mesh-rebind-on-takeover", "cross-shard-gang-admission"):
        args = ("sim", "--scenario", name, "--seed", "0")
        runs = [_cli("tpu_scheduler_torch.cli", *args, "--device", "cpu", env_extra={"PYTHONHASHSEED": h})
                for h in ("1", "2")]
        assert [r.returncode for r in runs] == [0, 0], runs[0].stderr[-2000:]
        jax = _cli("tpu_scheduler.cli", *args, env_extra={"PYTHONHASHSEED": "1"})
        cards = {r.stdout.strip().splitlines()[-1] for r in runs}
        assert len(cards) == 1, name
        assert json.loads(cards.pop()) == port_card_of(json.loads(jax.stdout.strip().splitlines()[-1])), name


def test_cli_prints_the_jax_cli_card():
    port = _cli("tpu_scheduler_torch.cli", "sim", "--device", "cpu", "--scenario", "sim-smoke", "--seed", "0")
    jax = _cli("tpu_scheduler.cli", "sim", "--scenario", "sim-smoke", "--seed", "0")
    assert port.returncode == 0 == jax.returncode, port.stderr[-2000:]
    assert json.loads(port.stdout.strip().splitlines()[-1]) == port_card_of(
        json.loads(jax.stdout.strip().splitlines()[-1]))


def test_card_is_independent_of_the_string_hash_seed():
    """With more new pending pods in a cycle than the flight recorder holds
    (train-smoke's 24-pod burst against 16 timelines), the recorder's LRU
    keeps what the order of the cycle's pending pods decides.  The port
    takes the pending list's order, so the whole card is the same under any
    PYTHONHASHSEED.  (The JAX controller passes a set: its
    ``flight_recorder.evicted_timelines`` changes with the seed here.)"""
    args = ("sim", "--device", "cpu", "--scenario", "train-smoke", "--events-buffer", "16")
    runs = [_cli("tpu_scheduler_torch.cli", *args, env_extra={"PYTHONHASHSEED": h}) for h in ("1", "2")]
    assert [r.returncode for r in runs] == [0, 0], runs[0].stderr[-2000:]
    cards = [r.stdout.strip().splitlines()[-1] for r in runs]
    assert cards[0] == cards[1]
    assert json.loads(cards[0])["flight_recorder"]["evicted_timelines"] > 0


def test_cli_lists_the_jax_cli_scenarios(capsys):
    assert sim_cli.main(["--list"]) == 0
    port = capsys.readouterr().out
    import tpu_scheduler.sim.cli as jax_sim_cli

    assert jax_sim_cli.main(["--list"]) == 0
    assert port == capsys.readouterr().out


# --- the rebalancer and the autoscaler -----------------------------------------


@pytest.mark.parametrize("name", ITEM9)
def test_item9_scenario_matches_the_jax_sim(name, tmp_path):
    """The scenarios of the rebalancer and the autoscaler at seed 0: the
    whole card equal with an empty allow-list, the tier enabled and passing
    with its evidence, and each package's trace replayed through the other
    with an equal fingerprint (the provider's node adds and deletes are not
    in the trace: each replay re-derives them from its seeded provider)."""
    jax_path, port_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    port = harness.run_scenario(name, seed=0, backend=_cpu(), record=port_path)
    jax = jax_harness.run_scenario(name, seed=0, backend=NativeBackend(), record=jax_path)
    _hold(port, jax)
    sc = scenarios.SCENARIOS[name]
    if sc.rebalance:
        r = port["rebalance"]
        assert r["enabled"] and r["ok"] and r["orphaned_migrations"] == 0
        assert r["solves"] > 0 or r["skips"].get("backlog", 0) > 0  # the what-if scenario stands down
    if sc.autoscale:
        e = port["elasticity"]
        assert e["enabled"] and e["ok"] and e["reclaim_orphans"] == 0 and sum(e["scale_ups"].values()) > 0
    assert jax_harness.run_scenario(None, replay=port_path, backend=NativeBackend())["fingerprint"] == \
        port["fingerprint"]
    assert harness.run_scenario(None, replay=jax_path, backend=_cpu())["fingerprint"] == jax["fingerprint"]


@pytest.mark.parametrize("name,switch,value", [
    ("defrag-smoke", "rebalance", False), ("train-smoke", "rebalance", True),
    ("flash-crowd-provisioning-lag", "autoscale", False), ("train-smoke", "autoscale", True),
])
def test_rebalance_and_autoscale_switches_match_the_jax_sim(name, switch, value):
    """``rebalance``/``autoscale``: ``False`` forces the tier off on a
    scenario that turns it on (the baseline fails its gate on merit), and
    ``True`` does not turn it on for a scenario without the knob — as in
    the JAX harness."""
    port = harness.run_scenario(name, seed=0, backend=_cpu(), **{switch: value})
    jax = jax_harness.run_scenario(name, seed=0, backend=NativeBackend(), **{switch: value})
    assert port["fingerprint"] == jax["fingerprint"] and _diff(port, port_card_of(jax)) == []
    block = port["rebalance" if switch == "rebalance" else "elasticity"]
    assert not block["enabled"]
    assert port["pass"] == (value is True)


def test_train_subcommand_runs(tmp_path, capsys):
    """``sim train`` runs on the port (``learn/cli.py``); its artifact is
    held against the JAX command's in ``tests/test_torch_learn.py``."""
    out = tmp_path / "p.json"
    assert sim_cli.main(["train", "--device", "cpu", "--train-seeds", "0", "--held-out-seeds", "101",
                         "--generations", "1", "--population", "2", "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["out"] == str(out) and json.loads(out.read_text())["schema_version"] == 1


def test_default_backend_needs_cuda(capsys, monkeypatch):
    """Without CUDA the harness's default backend raises and the CLI's
    default device exits 1: nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        harness.run_scenario("train-smoke")
    assert sim_cli.main(["--scenario", "train-smoke"]) == 1
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is False" in captured.err and '"scenario"' not in captured.out


# --- the compile block ----------------------------------------------------------


def test_compile_block_counts_kernel_builds_after_warmup(monkeypatch):
    """``compile.enabled`` follows the backend's device, and the count is of
    ``record_kernel_build`` calls after the warm-up window: a build there
    fails a compile-required run; one inside the window does not."""

    class OnCard:
        device = torch.device("cuda")

    assert profiler.compile_listener_active(OnCard()) is True
    assert profiler.compile_listener_active(_cpu()) is False
    assert profiler.compile_listener_active(None) is False

    sc = dataclasses.replace(scenarios.SCENARIOS["train-smoke"], compile_required=True, compile_warmup_cycles=4)
    monkeypatch.setattr(harness, "compile_listener_active", lambda backend: True)

    def run(build_at: int) -> dict:
        backend = _cpu()
        calls = [0]
        schedule = backend.schedule

        def counted(*a, **kw):
            calls[0] += 1
            if calls[0] == build_at:
                profiler.record_kernel_build(0.25)  # as ops/choose.build_library does after nvcc
            return schedule(*a, **kw)

        monkeypatch.setattr(backend, "schedule", counted)
        return harness.run_scenario(sc, backend=backend)

    late, early = run(build_at=10), run(build_at=2)
    assert late["compile"] == {"enabled": True, "required": True, "warmup_cycles": 4, "post_warmup_compiles": 1,
                               "steady_flat": False, "ok": False}
    assert not late["pass"]
    assert early["compile"]["post_warmup_compiles"] == 0 and early["compile"]["ok"] and early["pass"]
    assert late["fingerprint"] == early["fingerprint"]


def test_profile_gates_are_filled():
    """``profile_gates`` gets the wall-derived inputs of ``sim
    --profile-check`` (coverage and the span-overhead model, with its
    microbenched span cost) and the scorecard stays the JAX sim's."""
    gates: dict = {}
    port = harness.run_scenario("train-smoke", backend=_cpu(), profile_gates=gates)
    assert set(gates) == {"coverage", "overhead_frac", "per_span_s", "spans_per_cycle"}
    assert 0.0 < gates["coverage"] <= 1.0 and gates["per_span_s"] > 0.0 and gates["spans_per_cycle"] > 0.0
    _hold(port, jax_harness.run_scenario("train-smoke", backend=NativeBackend()))


# --- the slow tier ------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", IN_SCOPE)
@pytest.mark.parametrize("seed", [0, 1])
def test_all_in_scope_scenarios_match(name, seed, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    port, jax = _both(name, seed, record=path)
    _hold(port, jax)
    replayed = harness.run_scenario(None, replay=path, backend=_cpu())
    assert replayed["fingerprint"] == port["fingerprint"], f"{name} seed {seed} replay diverged"
