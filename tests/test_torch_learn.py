"""The learned policy on the port: ``tpu_scheduler_torch.learn`` (episodes,
the seeded search, the distilled artifacts) and ``sim train``, held against
the JAX package.

Every case of ``tests/test_learn.py`` runs on both packages — the port's
episodes over ``CudaBackend(device="cpu")``, the JAX ones over
``NativeBackend`` — with the JAX test's own assertions holding on both
sides and the observations (trajectories, rewards, cards, CEM histories,
objective tables, training results, profiles) equal, exactly.
``test_distilled_profile_backend_parity`` holds the port's backend against
``NativeBackend`` under the tuned profile.  Then ``sim train`` through both
CLIs (artifacts byte for byte), its refusal to run without CUDA, the
checked-in artifacts byte-equal to the JAX package's, and the serial and
threaded evaluations equal on both packages."""

import dataclasses
import filecmp
import json
import logging
import os
import pathlib
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.learn.cli as jax_learn_cli  # noqa: E402
import tpu_scheduler.learn.distill as jax_distill  # noqa: E402
import tpu_scheduler.learn.env as jax_env  # noqa: E402
import tpu_scheduler.learn.objective as jax_objective  # noqa: E402
import tpu_scheduler.learn.search as jax_search  # noqa: E402
import tpu_scheduler.models.profiles as jax_profiles  # noqa: E402
import tpu_scheduler.sim as jax_sim  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.learn.cli as learn_cli  # noqa: E402
import tpu_scheduler_torch.learn.distill as distill  # noqa: E402
import tpu_scheduler_torch.learn.env as env  # noqa: E402
import tpu_scheduler_torch.learn.objective as objective  # noqa: E402
import tpu_scheduler_torch.learn.search as search  # noqa: E402
import tpu_scheduler_torch.models.profiles as profiles  # noqa: E402
import tpu_scheduler_torch.sim as sim  # noqa: E402
import tpu_scheduler_torch.sim.cli as sim_cli  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from test_torch_sim import port_card_of  # noqa: E402

logging.getLogger("tpu_scheduler").setLevel(logging.ERROR)
logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PROFILES_DIR = ROOT / "tpu_scheduler" / "learn" / "profiles"
PORT_PROFILES_DIR = ROOT / "tpu_scheduler_torch" / "learn" / "profiles"

PORT = types.SimpleNamespace(
    name="port", env=env, search=search, objective=objective, distill=distill, profiles=profiles, sim=sim,
    learn_cli=learn_cli, profiles_dir=PORT_PROFILES_DIR, backend=lambda: CudaBackend(device="cpu"),
    search_kw={"device": "cpu"}, carry=lambda card: card,
)
JAX = types.SimpleNamespace(
    name="jax", env=jax_env, search=jax_search, objective=jax_objective, distill=jax_distill,
    profiles=jax_profiles, sim=jax_sim, learn_cli=jax_learn_cli, profiles_dir=JAX_PROFILES_DIR,
    backend=NativeBackend, search_kw={}, carry=port_card_of,
)

# A mid-box action distinct from the default vector on several knobs.
PROBE_ACTION = [0.5, 4.0, 48.0, 2.0, 20.0, 6.0, 200.0]


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


def _both(case, *args):
    """Run ``case`` on each package; the observations must be equal."""
    port, jax = case(PORT, *args), case(JAX, *args)
    assert port == jax
    return port


def _drive(pk, scenario="train-smoke", seed=0, window=1, actions=()):
    """One full episode on ``pk``'s env; returns (trajectory, card)."""
    e = pk.env.SchedulerEnv(scenario, seed=seed, backend=pk.backend(), window=window)
    traj = [e.reset()]
    acts = dict(enumerate(actions)) if not isinstance(actions, dict) else actions
    done, i = False, 0
    while not done:
        obs, reward, done, _info = e.step(acts.get(i))
        traj.append({"obs": obs, "reward": reward, "done": done})
        i += 1
    return traj, pk.carry(e.card)


# --- episodes ---------------------------------------------------------------


def test_none_action_episode_matches_run_scenario():
    def case(pk):
        _traj, card = _drive(pk)
        plain = pk.carry(pk.sim.run_scenario("train-smoke", seed=0, backend=pk.backend()))
        assert json.dumps(card, sort_keys=True) == json.dumps(plain, sort_keys=True)
        return json.dumps(card, sort_keys=True)

    _both(case)


def test_observation_schema_and_inprocess_determinism():
    def case(pk):
        t1, c1 = _drive(pk, window=4, actions={1: PROBE_ACTION})
        t2, c2 = _drive(pk, window=4, actions={1: PROBE_ACTION})
        assert json.dumps(t1, sort_keys=True) == json.dumps(t2, sort_keys=True)
        assert c1["fingerprint"] == c2["fingerprint"]
        for entry in t1:
            obs = entry["obs"] if isinstance(entry, dict) and "obs" in entry else entry
            assert tuple(obs) == pk.env.OBSERVATION_FIELDS
        assert t1[-1]["reward"] == c1["policy"]["objective"]
        assert all(e["reward"] == 0.0 for e in t1[1:-1])
        return json.dumps(t1, sort_keys=True), c1["fingerprint"]

    _both(case)


_SUBPROC = """
import json, logging
logging.getLogger("{pkg}").setLevel(logging.ERROR)
from {pkg}.learn.env import SchedulerEnv
{backend}
env = SchedulerEnv("train-smoke", seed=3, window=5, backend=backend)
traj = [env.reset()]
done, i = False, 0
while not done:
    obs, reward, done, _ = env.step([0.5, 4.0, 48.0, 2.0, 20.0, 6.0, 200.0] if i == 1 else None)
    traj.append([obs, reward, done])
    i += 1
print(json.dumps(traj, sort_keys=True))
"""


def test_episode_determinism_across_subprocesses():
    """Two fresh interpreters of each package print the same trajectory,
    and the port's is the JAX package's."""
    scripts = {
        "port": _SUBPROC.format(pkg="tpu_scheduler_torch", backend="from tpu_scheduler_torch.backends.cuda import "
                                "CudaBackend\nbackend = CudaBackend(device='cpu')"),
        "jax": _SUBPROC.format(pkg="tpu_scheduler", backend="backend = None"),
    }
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {name: [subprocess.run([sys.executable, "-c", code], capture_output=True, cwd=ROOT, env=run_env,
                                  check=True, timeout=300).stdout for _ in range(2)]
            for name, code in scripts.items()}
    assert outs["port"][0] == outs["port"][1] == outs["jax"][0] == outs["jax"][1]
    assert json.loads(outs["port"][0])


def test_action_changes_binding_fingerprint():
    def case(pk):
        _t1, none_card = _drive(pk, window=4)
        _t2, act_card = _drive(pk, window=4, actions={0: PROBE_ACTION})
        assert none_card["fingerprint"] != act_card["fingerprint"]
        return none_card["fingerprint"], act_card["fingerprint"]

    _both(case)


def test_action_profile_clips_into_knob_box():
    def case(pk):
        base = pk.profiles.DEFAULT_PROFILE
        sent = [1e9, -1e9, 12.0, 1.0, 2.0, 3.0, 4.0]
        p = pk.env.action_profile(base, sent)
        for (name, lo, hi), s in zip(pk.env.ACTION_KNOBS, sent):
            got = getattr(p, name)
            assert lo <= got <= hi and got == round(min(hi, max(lo, s)), 6)
        assert p.preemption == base.preemption
        with pytest.raises(ValueError):
            pk.env.action_profile(base, [1.0])
        return dataclasses.asdict(p), pk.env.ACTION_KNOBS, pk.env.OBSERVATION_FIELDS

    _both(case)


# --- objective / policy block ----------------------------------------------


def test_policy_block_is_closed_and_recomputable():
    def case(pk):
        card = pk.sim.run_scenario("train-smoke", seed=0, backend=pk.backend())
        policy = card["policy"]
        assert tuple(policy) == pk.objective.POLICY_FIELDS
        assert policy["enabled"] and policy["required"] and policy["ok"]
        recomputed = round(sum(w * policy["components"][name] for name, w in pk.objective.OBJECTIVE_COMPONENTS), 6)
        assert policy["objective"] == recomputed
        assert set(policy["components"]) == {name for name, _w in pk.objective.OBJECTIVE_COMPONENTS}
        return policy, pk.objective.objective_from_card(card)

    _both(case)


def test_policy_floor_gates_the_verdict():
    def case(pk):
        base = pk.sim.Scenario(
            name="policy-floor-test", description="test-only", duration=12.0,
            workload=pk.sim.WorkloadSpec(initial_nodes=6, arrival_rate=4.0, lifetime_mean_s=6.0),
            policy_required=True, policy_objective_floor=0.1,
        )
        ok = pk.carry(pk.sim.run_scenario(base, seed=0, backend=pk.backend()))
        assert ok["policy"]["ok"] and ok["pass"]
        failed = pk.carry(pk.sim.run_scenario(dataclasses.replace(base, policy_objective_floor=100.0), seed=0,
                                              backend=pk.backend()))
        assert not failed["policy"]["ok"] and not failed["pass"]
        assert failed["fingerprint"] == ok["fingerprint"]
        return json.dumps(ok, sort_keys=True), json.dumps(failed, sort_keys=True)

    _both(case)


# --- search -----------------------------------------------------------------


def test_cem_converges_on_quadratic_and_reproduces():
    target = [1.5, -0.75, 3.0]

    def fn(pop):
        return [-sum((x - t) ** 2 for x, t in zip(vec, target)) for vec in pop]

    def case(pk):
        def run():
            return pk.search.cem_optimize(fn, lo=[-5.0] * 3, hi=[5.0] * 3, mean0=[0.0] * 3, sigma0=[1.5] * 3,
                                          generations=30, population=32, elite_frac=0.25,
                                          rng=random.Random("quadratic:0"))

        best_vec, best_val, history = run()
        assert best_val > -1e-3 and all(abs(x - t) < 0.1 for x, t in zip(best_vec, target))
        assert round(best_val, 6) == max(g["best"] for g in history)
        b2, v2, h2 = run()
        assert (b2, v2) == (best_vec, best_val)
        assert json.dumps(h2, sort_keys=True) == json.dumps(history, sort_keys=True)
        return best_vec, best_val, history

    _both(case)


def test_evaluate_vectors_parallel_matches_serial():
    """Serial and 4-thread evaluation equal on each package (the port's
    threads each make their own backend), and the port's equal the JAX
    package's."""

    def case(pk):
        vecs = [pk.search.default_vector(), PROBE_ACTION]
        serial = pk.search.evaluate_vectors(vecs, ("train-smoke",), (0, 1), workers=0, **pk.search_kw)
        fanned = pk.search.evaluate_vectors(vecs, ("train-smoke",), (0, 1), workers=4, **pk.search_kw)
        assert serial == fanned
        means = [round(sum(pk.search.episode_objective(v, "train-smoke", s, **pk.search_kw) for s in (0, 1)) / 2, 6)
                 for v in vecs]
        assert serial == means
        return serial

    _both(case)


def _tiny_config(pk):
    return pk.search.SearchConfig(scenarios=("train-smoke",), train_seeds=(0,), held_out_seeds=(101,),
                                  generations=1, population=3, seed=0)


def test_held_out_selection_and_fallback():
    def case(pk):
        res = pk.search.train_profile(_tiny_config(pk), **pk.search_kw)
        assert set(res.held_out) == set(res.default_held_out) == {"train-smoke"}
        table = pk.search.held_out_table(res.vector, ("train-smoke",), (101,), **pk.search_kw)
        assert res.held_out["train-smoke"] == table["train-smoke"]
        tuned_mean = sum(res.held_out.values()) / len(res.held_out)
        default_mean = sum(res.default_held_out.values()) / len(res.default_held_out)
        assert res.improved == (tuned_mean > default_mean)
        if not res.improved:
            assert res.vector == [round(x, 6) for x in pk.search.default_vector()]
            assert res.profile.name == "default"
        else:
            assert res.profile.name == "tuned"
        for (name, _lo, _hi), x in zip(pk.env.ACTION_KNOBS, res.vector):
            assert getattr(res.profile, name) == x
        out = dataclasses.asdict(res)
        out["config"] = dataclasses.asdict(res.config)
        return out

    _both(case)


# --- artifacts --------------------------------------------------------------


def test_profile_roundtrip_and_rejections(tmp_path):
    def case(pk):
        tuned = pk.profiles.DEFAULT_PROFILE.with_(name="rt", gang_locality_weight=99.5)
        path = tmp_path / f"{pk.name}.json"
        tuned.to_file(path, provenance={"source": "test"})
        assert pk.profiles.SchedulingProfile.from_file(path) == tuned
        written = path.read_bytes()
        doc = json.loads(path.read_text())
        messages = []
        for mutate, match in [
            (lambda d: d.update(schema_version=2), "schema_version"),
            (lambda d: d.update(extra_top=1), "unknown"),
            (lambda d: d["profile"].update(ghost_knob=1.0), "ghost_knob"),
        ]:
            bad = json.loads(json.dumps(doc))
            mutate(bad)
            path.write_text(json.dumps(bad))
            with pytest.raises(ValueError, match=match) as e:
                pk.profiles.SchedulingProfile.from_file(path)
            messages.append(str(e.value).replace(str(path), "PATH"))
        return written, messages

    _both(case)


def test_checked_in_default_artifact_is_the_runtime_default():
    def case(pk):
        loaded = pk.profiles.SchedulingProfile.from_file(pk.profiles_dir / "default.json")
        assert loaded == pk.profiles.DEFAULT_PROFILE
        return dataclasses.asdict(loaded), dataclasses.asdict(pk.distill.load_profile(pk.profiles_dir / "tuned.json"))

    _both(case)


@pytest.mark.parametrize("name", ["default.json", "tuned.json"])
def test_port_profile_artifacts_are_the_jax_files(name):
    assert filecmp.cmp(PORT_PROFILES_DIR / name, JAX_PROFILES_DIR / name, shallow=False)


def test_distilled_profile_backend_parity():
    """Zero inference cost: a tuned artifact is just weights, so the port's
    ``CudaBackend`` on the CPU and the JAX package's ``NativeBackend`` make
    the same assignment under it."""
    from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
    from tpu_scheduler.testing import synth_cluster as jax_synth
    from tpu_scheduler_torch.ops.pack import pack_snapshot
    from tpu_scheduler_torch.testing import synth_cluster

    jax_tuned = jax_profiles.SchedulingProfile.from_file(JAX_PROFILES_DIR / "tuned.json")
    tuned = profiles.SchedulingProfile.from_file(PORT_PROFILES_DIR / "tuned.json")
    assert dataclasses.asdict(tuned) == dataclasses.asdict(jax_tuned)
    kw = dict(n_nodes=16, n_pending=120, n_bound=16, seed=7)
    native = NativeBackend().schedule(jax_pack(jax_synth(**kw)), jax_tuned)
    port = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw)), tuned)
    assert np.array_equal(native.assigned, port.assigned) and native.rounds == port.rounds
    assert sorted(native.bindings) == sorted(port.bindings)


def test_train_cli_rejects_overlapping_seed_sets(capsys):
    def case(pk):
        rc = pk.learn_cli.main(["--train-seeds", "0,1", "--held-out-seeds", "1,2"])
        assert rc == 2
        return rc, capsys.readouterr().err

    _both(case)
    assert sim_cli.main(["train", "--scenario-set", "no-such-scenario"]) == 2
    assert "unknown scenarios: no-such-scenario" in capsys.readouterr().err


_TRAIN_ARGS = ["--scenario-set", "train-smoke", "--seed", "0", "--train-seeds", "0", "--held-out-seeds", "101",
               "--generations", "1", "--population", "3"]


def test_sim_train_artifact_matches_the_jax_cli(tmp_path):
    """``sim train`` with a tiny budget through the port's CLI (``--device
    cpu``, in a subprocess) and the JAX CLI: the artifacts byte for byte,
    and the report lines equal but for the output path."""
    run_env = dict(os.environ, JAX_PLATFORMS="cpu")
    paths = {"port": tmp_path / "port.json", "jax": tmp_path / "jax.json"}
    cmds = {"port": ["tpu_scheduler_torch.cli", "sim", "train", *_TRAIN_ARGS, "--device", "cpu"],
            "jax": ["tpu_scheduler.cli", "sim", "train", *_TRAIN_ARGS]}
    reports = {}
    for name, cmd in cmds.items():
        proc = subprocess.run([sys.executable, "-m", *cmd, "--out", str(paths[name])], cwd=ROOT, env=run_env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        reports[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        reports[name].pop("out")
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert reports["port"] == reports["jax"]
    assert profiles.SchedulingProfile.from_file(paths["port"]).name == reports["port"]["profile"]


def test_sim_train_threaded_artifact_equals_the_serial_one(tmp_path, capsys):
    """The port's ``sim train`` with 2 worker threads writes the artifact of
    a serial run but for the echoed ``workers``; the JAX command's with 2
    workers is byte-equal to the port's."""
    docs = {}
    for workers in ("0", "2"):
        out = tmp_path / f"w{workers}.json"
        assert sim_cli.main(["train", *_TRAIN_ARGS, "--device", "cpu", "--workers", workers, "--out", str(out)]) == 0
        docs[workers] = json.loads(out.read_text())
    capsys.readouterr()
    jax_out = tmp_path / "jax_w2.json"
    assert jax_learn_cli.main([*_TRAIN_ARGS, "--workers", "2", "--out", str(jax_out)]) == 0
    assert (tmp_path / "w2.json").read_bytes() == jax_out.read_bytes()
    assert docs["2"]["provenance"]["search"].pop("workers") == 2
    assert docs["0"]["provenance"]["search"].pop("workers") == 0
    assert docs["0"] == docs["2"]


def test_sim_train_without_cuda_fails_before_any_episode(capsys, monkeypatch):
    """The default device is the card: without CUDA ``sim train`` exits 1
    with the backend's message and runs no episode."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(search, "evaluate_vectors", lambda *a, **k: calls.append(a) or [0.0])
    assert sim_cli.main(["train", *_TRAIN_ARGS, "--out", os.devnull]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err and calls == []
