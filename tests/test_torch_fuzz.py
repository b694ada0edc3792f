"""The chaos fuzzer on the port: ``tpu_scheduler_torch.sim.fuzz`` against
the JAX package's ``tpu_scheduler.sim.fuzz``, on the same plans and seeds.

Every case of ``tests/test_fuzz.py`` runs on both packages — the port's
episodes over ``CudaBackend(device="cpu")``, the JAX ones over
``NativeBackend`` — with exact equality as the tolerance: the corpus (the JAX
package's files, read as data) replays bit-identically, the generator draws
the same plans, the shrinker probes the same candidates, the oracle returns
the same card and coverage.  Then the ``sim fuzz`` campaign: its run log
equals the one the JAX package's generator and oracle give on the same
budget and seed, line for line — plans on the ``elastic`` base (the
autoscaler and its provider) included."""

import json
import os
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.sim.fuzz as jax_fuzz  # noqa: E402
import tpu_scheduler.sim.fuzz.corpus as jax_corpus  # noqa: E402
import tpu_scheduler.sim.fuzz.plan as jax_plan  # noqa: E402
import tpu_scheduler.sim.harness as jax_harness  # noqa: E402
import tpu_scheduler.sim.scenarios as jax_scenarios  # noqa: E402
import tpu_scheduler.sim.workload as jax_workload  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.sim.cli as sim_cli  # noqa: E402
import tpu_scheduler_torch.sim.fuzz as fuzz  # noqa: E402
import tpu_scheduler_torch.sim.fuzz.corpus as corpus  # noqa: E402
import tpu_scheduler_torch.sim.fuzz.plan as plan_mod  # noqa: E402
import tpu_scheduler_torch.sim.harness as harness  # noqa: E402
import tpu_scheduler_torch.sim.scenarios as scenarios  # noqa: E402
import tpu_scheduler_torch.sim.workload as workload  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from test_torch_sim import port_card_of  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(ROOT, "tests", "fuzz_corpus")


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


def _cpu():
    return CudaBackend(device="cpu")


def _jax_plan(plan):
    """The JAX package's FaultPlan of a port plan (through the shared JSON)."""
    return jax_fuzz.plan_from_json(fuzz.plan_to_json(plan))


# --- corpus replay ------------------------------------------------------------------


def test_corpus_entries_replay_bit_identically():
    entries = corpus.load_corpus(CORPUS_DIR)
    assert entries and len(entries) == len(jax_corpus.load_corpus(CORPUS_DIR))
    for entry, jentry in zip(entries, jax_corpus.load_corpus(CORPUS_DIR)):
        assert fuzz.plan_to_json(entry["plan"]) == jax_fuzz.plan_to_json(jentry["plan"])
        ok, problems, card = corpus.replay_entry(entry, backend=_cpu())
        assert ok, f"corpus entry {entry['name']} drifted: {problems}"
        assert 1 <= len(entry["plan"].ops) <= plan_mod.MAX_OPS
        jok, _jproblems, jcard = jax_corpus.replay_entry(jentry)
        assert jok and card == port_card_of(jcard)


def test_corpus_files_carry_the_closed_entry_schema():
    assert corpus.ENTRY_FIELDS == jax_corpus.ENTRY_FIELDS
    assert plan_mod.PLAN_FIELDS == jax_plan.PLAN_FIELDS and plan_mod.OP_FIELDS == jax_plan.OP_FIELDS
    for fname in sorted(os.listdir(CORPUS_DIR)):
        if not fname.endswith(".json"):
            continue
        path = os.path.join(CORPUS_DIR, fname)
        assert corpus.load_entry(path)["expect"] == jax_corpus.load_entry(path)["expect"]
        raw = json.load(open(path, encoding="utf-8"))
        assert set(corpus.ENTRY_FIELDS) <= set(raw)
        for op in raw["plan"]["ops"]:
            assert set(op) == set(plan_mod.OP_FIELDS), fname


def test_lease_outage_credit_regression_pins_the_oracle_fix():
    entry = {e["name"]: e for e in corpus.load_corpus(CORPUS_DIR)}["lease-outage-takeover-credit"]
    ok, _problems, card = corpus.replay_entry(entry, backend=_cpu())
    a = card["availability"]
    assert ok and a["max_takeover_latency_s"] > a["takeover_bound_s"]
    assert a["lease_outage_credit_s"] > 0 and a["ok"] and card["pass"]


# --- plans and the generator -----------------------------------------------------------


def test_vocabularies_and_base_workloads_equal():
    import dataclasses

    assert fuzz.FAULT_OPS == jax_fuzz.FAULT_OPS and fuzz.STATE_FACETS == jax_fuzz.STATE_FACETS
    assert plan_mod.MAX_OPS == jax_plan.MAX_OPS and plan_mod.EVENT_OPS == jax_plan.EVENT_OPS
    assert list(fuzz.BASE_WORKLOADS) == list(jax_fuzz.BASE_WORKLOADS)
    for name, base in fuzz.BASE_WORKLOADS.items():
        assert dataclasses.asdict(base) == dataclasses.asdict(jax_fuzz.BASE_WORKLOADS[name])
        assert base.replicas == 2 and base.shards == 4


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_generator_same_seed_same_plans(seed):
    """The port's generator draws the JAX one's plans, seed for seed, and
    lowers them onto the same scenarios."""
    import dataclasses

    g, jg = fuzz.PlanGenerator(seed, fuzz.CoverageMap()), jax_fuzz.PlanGenerator(seed, jax_fuzz.CoverageMap())
    plans = [g.next_plan(i) for i in range(12)]
    assert [fuzz.plan_to_json(p) for p in plans] == [jax_fuzz.plan_to_json(jg.next_plan(i)) for i in range(12)]
    for p in plans:
        assert dataclasses.asdict(fuzz.compile_plan(p)) == dataclasses.asdict(jax_fuzz.compile_plan(_jax_plan(p)))
    g8 = fuzz.PlanGenerator(seed + 1, fuzz.CoverageMap())
    assert [fuzz.plan_to_json(g8.next_plan(i)) for i in range(12)] != [fuzz.plan_to_json(p) for p in plans]


def test_generated_plans_are_well_formed():
    gen = fuzz.PlanGenerator(3, fuzz.CoverageMap())
    for i in range(12):
        plan = gen.next_plan(i)
        assert plan.base in fuzz.BASE_WORKLOADS and 2 <= len(plan.ops) <= plan_mod.MAX_OPS
        assert sum(1 for op in plan.ops if op.kind == "replica-kill") <= 1
        assert all(op.kind in fuzz.FAULT_OPS for op in plan.ops)
        assert fuzz.plan_from_json(fuzz.plan_to_json(plan)) == plan
        sc = fuzz.compile_plan(plan)
        assert sc.convergence_required and sc.replicas == 2


def test_plan_json_rejects_unknown_ops_and_oversized_plans():
    plan = fuzz.FaultPlan(plan_id="p", base="mixed", duration=20.0, ops=(fuzz.FaultOp("bind-500", 2.0, 6.0, 0.5),))
    raw = json.loads(fuzz.plan_to_json(plan))
    raw["ops"][0]["kind"] = "meteor-strike"
    for mod in (fuzz, jax_fuzz):
        with pytest.raises(ValueError):
            mod.plan_from_json(json.dumps(raw))
    raw["ops"] = [{"kind": "bind-500", "t0": 1.0, "t1": 2.0, "magnitude": 0.5}] * (plan_mod.MAX_OPS + 1)
    for mod in (fuzz, jax_fuzz):
        with pytest.raises(ValueError):
            mod.plan_from_json(json.dumps(raw))
    raw["ops"], raw["base"] = [], "nowhere"
    for mod in (fuzz, jax_fuzz):
        with pytest.raises(ValueError):
            mod.plan_from_json(json.dumps(raw))


# --- the shrinker ------------------------------------------------------------------------


def _shrink_me(mod):
    Op = mod.FaultOp
    return mod.FaultPlan(plan_id="shrink-me", base="mixed", duration=24.0, ops=(
        Op("brownout", 3.0, 9.0, 1.0), Op("lease-500", 5.0, 15.0, 1.0), Op("watch-drop", 6.0, 12.0, 0.75),
        Op("node-flap", 8.0, 8.0, 0.5), Op("replica-kill", 10.0, 10.0, 0.25)))


def test_shrinker_reduces_to_minimal_reproducer():
    """The synthetic judge of the JAX test: both shrinkers probe the same
    candidates in the same order and stop at the same one-op plan."""
    def run(mod):
        probes = []

        def judge(p):
            probes.append(mod.plan_to_json(p))
            return ["boom"] if any(op.kind == "lease-500" and op.magnitude >= 0.5 for op in p.ops) else []

        return mod.plan_to_json(mod.shrink_plan(_shrink_me(mod), 0, run=judge)), probes

    port, jax = run(fuzz), run(jax_fuzz)
    assert port == jax
    minimal = fuzz.plan_from_json(port[0])
    assert len(minimal.ops) == 1 and minimal.ops[0].kind == "lease-500" and minimal.ops[0].magnitude == 0.5
    assert minimal.ops[0].t1 - minimal.ops[0].t0 == 2.0 and len(port[1]) > 5


def test_shrinker_returns_passing_plans_unchanged():
    plan = fuzz.FaultPlan(plan_id="fine", base="mixed", duration=20.0, ops=(fuzz.FaultOp("bind-500", 2.0, 6.0, 0.5),))
    assert fuzz.shrink_plan(plan, 0, run=lambda p: []) == plan


# --- coverage and the oracle ----------------------------------------------------------------


def test_coverage_map_accounting():
    def run(mod):
        cov = mod.CoverageMap()
        out = [cov.distinct(), cov.lease_pairs(), cov.unseen("lease-500")]
        cov.record("lease-500", ("breaker-closed", "fleet-full"))
        cov.record("lease-500", ("breaker-closed", "fleet-degraded"))
        cov.record("bind-500", ("breaker-open",))
        cov.record("bind-500", ("breaker-open",))
        return out + [cov.distinct(), cov.lease_pairs(), cov.unseen("lease-500"), cov.unseen("bind-500"),
                      cov.to_json()]

    port = run(fuzz)
    assert port == run(jax_fuzz)
    assert port[3:6] == [4, 3, len(fuzz.STATE_FACETS) - 3]


def _cov_plan(mod):
    return mod.FaultPlan(plan_id="cov", base="mixed", duration=18.0, ops=(
        mod.FaultOp("lease-refused", 4.0, 9.0, 0.75), mod.FaultOp("watch-drop", 6.0, 11.0, 0.5)))


def test_oracle_fills_coverage_and_is_deterministic():
    cov = fuzz.CoverageMap()
    card1, viol1 = fuzz.run_plan(_cov_plan(fuzz), 0, cov, backend=_cpu())
    card2, viol2 = fuzz.run_plan(_cov_plan(fuzz), 0, backend=_cpu())
    assert card1 == card2 and viol1 == viol2 == []
    assert cov.distinct() == 2 * 5 and cov.lease_pairs() == 5
    jcov = jax_fuzz.CoverageMap()
    jcard, jviol = jax_fuzz.run_plan(_cov_plan(jax_fuzz), 0, jcov)
    assert card1 == port_card_of(jcard) and viol1 == jviol and cov.to_json() == jcov.to_json()


def test_judge_card_and_card_value_match():
    card = fuzz.run_plan(_cov_plan(fuzz), 1, backend=_cpu())[0]
    broken = json.loads(json.dumps(card))
    broken["pods"]["lost"], broken["availability"]["ok"], broken["convergence"]["ok"] = 2, False, False
    for c in (card, broken):
        assert fuzz.judge_card(c) == jax_fuzz.judge_card(c)
    assert fuzz.judge_card(broken) == ["lost-pods", "availability", "convergence"]
    from tpu_scheduler.sim.fuzz.oracle import card_value as jax_card_value
    from tpu_scheduler_torch.sim.fuzz.oracle import card_value

    assert card_value(card, "availability.takeover_bound_s") == jax_card_value(card, "availability.takeover_bound_s")


# --- the convergence gate -------------------------------------------------------------------


def _mini(sc_mod, wl_mod, **kw):
    base = dict(name="fuzz-mini", description="convergence gate unit scenario", duration=10.0,
                workload=wl_mod.WorkloadSpec(initial_nodes=6, arrival_rate=2.0, lifetime_mean_s=6.0),
                replicas=2, shards=4, drain_grace_cycles=15, convergence_required=True)
    base.update(kw)
    return sc_mod.Scenario(**base)


def test_convergence_true_positive_draining_run_quiesces():
    card = harness.run_scenario(_mini(scenarios, workload), seed=0, backend=_cpu())
    assert card == port_card_of(
        jax_harness.run_scenario(_mini(jax_scenarios, jax_workload), seed=0, backend=NativeBackend()))
    c = card["convergence"]
    assert c["required"] and c["ok"] and c["pending_final"] == 0 and c["stale_leases"] == 0 and card["pass"]


def test_convergence_false_positive_guard_wedged_backlog_fails_the_run():
    def wedged(sc_mod, wl_mod):
        return _mini(sc_mod, wl_mod, workload=wl_mod.WorkloadSpec(
            initial_nodes=2, arrival_rate=4.0, lifetime_mean_s=0.0, pod_cpu_m=(4000,), pod_mem_mi=(4096,)))

    card = harness.run_scenario(wedged(scenarios, workload), seed=0, backend=_cpu())
    assert card == port_card_of(
        jax_harness.run_scenario(wedged(jax_scenarios, jax_workload), seed=0, backend=NativeBackend()))
    assert card["convergence"]["pending_final"] > 0 and not card["convergence"]["ok"] and not card["pass"]
    relaxed = harness.run_scenario(replace(wedged(scenarios, workload), convergence_required=False), seed=0,
                                   backend=_cpu())
    assert relaxed["convergence"]["required"] is False and relaxed["pass"]


@pytest.mark.parametrize("seed", [0, 1])
def test_lease_brownout_during_takeover_passes_and_replays(seed, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    card = harness.run_scenario("lease-brownout-during-takeover", seed=seed, backend=_cpu(), record=path)
    assert card == port_card_of(
        jax_harness.run_scenario("lease-brownout-during-takeover", seed=seed, backend=NativeBackend()))
    assert card["pass"] and any(k.startswith("lease-") for k in card["chaos_injected"])
    a = card["availability"]
    assert a["ok"] and a["double_binds"] == 0 and a["orphaned_pods"] == 0
    replayed = harness.run_scenario(None, replay=path, backend=_cpu())
    assert replayed["fingerprint"] == card["fingerprint"] and replayed["availability"] == a


# --- the campaign ----------------------------------------------------------------------------


def _jax_runlog(budget: int, seed: int) -> list[str]:
    """The run log of ``sim fuzz --budget --seed`` from the JAX package's
    corpus replay, generator and oracle."""
    lines = []

    def log(obj):
        lines.append(json.dumps(obj, sort_keys=True))

    corpus_ok = True
    entries = jax_corpus.load_corpus(CORPUS_DIR)
    for entry in entries:
        ok, problems, card = jax_corpus.replay_entry(entry)
        corpus_ok = corpus_ok and ok
        log({"corpus": entry["name"], "ok": ok, "problems": problems, "fingerprint": card["fingerprint"],
             "ops": len(entry["plan"].ops)})
    cov = jax_fuzz.CoverageMap()
    gen = jax_fuzz.PlanGenerator(seed, cov)
    found = 0
    for i in range(budget):
        plan = gen.next_plan(i)
        card, violations = jax_fuzz.run_plan(plan, seed, cov)
        found += bool(violations)
        log({"plan": plan.plan_id, "base": plan.base, "ops": len(plan.ops), "pass": card["pass"],
             "violations": violations, "fingerprint": card["fingerprint"], "coverage_pairs": cov.distinct()})
    log({"fuzz": True, "seed": seed, "budget": budget, "corpus_replayed": len(entries), "corpus_ok": corpus_ok,
         "violations_found": found, "coverage_pairs": cov.distinct(),
         "lease_pairs": cov.lease_pairs(), "coverage": cov.to_json()})
    return lines


@pytest.mark.parametrize("entry", ["cli", "sim-cli"])
def test_sim_fuzz_runlog_matches_jax(entry, tmp_path, capsys):
    """``sim fuzz --budget 4 --seed 0 --device cpu`` through the port's CLI
    (a subprocess) and its sim CLI (in process): the run log equals the JAX
    package's on the same budget and seed, line for line."""
    runlog = tmp_path / "port.jsonl"
    args = ["fuzz", "--device", "cpu", "--budget", "4", "--seed", "0", "--corpus", CORPUS_DIR, "--runlog",
            str(runlog)]
    if entry == "cli":
        proc = subprocess.run([sys.executable, "-m", "tpu_scheduler_torch.cli", "sim", *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.splitlines() == runlog.read_text().splitlines()
    else:
        assert sim_cli.main(args) == 0
        capsys.readouterr()
    lines = runlog.read_text().splitlines()
    assert lines == _jax_runlog(4, 0)
    summary = json.loads(lines[-1])
    assert summary["corpus_ok"] and summary["violations_found"] == 0 and summary["corpus_replayed"] >= 2
    plans = [json.loads(ln) for ln in lines if '"plan"' in ln]
    assert len(plans) == 4 and all("fingerprint" in p for p in plans)  # every plan ran
    assert any(p["base"] == "elastic" for p in plans)


def test_sim_fuzz_without_cuda_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sim_cli.main(["fuzz", "--budget", "1"]) == 1
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is False" in captured.err and '"plan"' not in captured.out


def test_elastic_plan_runs_and_matches_jax():
    """The generator's first plan at seed 0 is on the ``elastic`` base (the
    autoscaler, a spot-reclaim fault among its ops or not): it runs on the
    port, and its card, violations and coverage equal the JAX oracle's."""
    plan = fuzz.PlanGenerator(0, fuzz.CoverageMap()).next_plan(0)
    assert plan.base == "elastic"
    cov, jcov = fuzz.CoverageMap(), jax_fuzz.CoverageMap()
    card, violations = fuzz.run_plan(plan, 0, cov, backend=_cpu())
    jcard, jviolations = jax_fuzz.run_plan(_jax_plan(plan), 0, jcov)
    assert card == port_card_of(jcard) and violations == jviolations and cov.to_json() == jcov.to_json()
    assert card["elasticity"]["enabled"] and card["elasticity"]["reclaim_orphans"] == 0
