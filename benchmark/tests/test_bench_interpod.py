"""A configuration that uses only the schema's optional keys (zones, and five
pod kinds with required and preferred affinity and anti-affinity and hard
and soft spread) runs end to end on the CPU through the cell's own loop,
files and comparison, from its file alone: the program keeps every
guarantee; the control with the inter-pod filters off, and the faults
planted under the timed path, do not."""

import pathlib

import pytest

from benchmark import harness
from benchmark.spec import Cell

CONFIG = pathlib.Path(__file__).resolve().parent / "interpod-300.json"
SPEC = {
    "configs": [{"name": "interpod-300", "file": str(CONFIG)}],
    "workloads": [{"name": "interpod-300.backlog", "config": "interpod-300", "traffic": "backlog", "chips": 1}],
    "end_to_end": [{"name": "backlog_pods_per_s", "unit": "pods/s"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}
# 300 nodes and waves of 6,000: on most seeds the program's auction places
# such a wave within its round cap, in seconds on the CPU.
SCALE = {"bound_at_start": 3000, "wave": 6000, "grace_s": 60.0}
SEED = 2**31 + 23
# The program's known fault (PERF.md, section 7): the auction's round cap
# leaves pods that the cluster holds marked "no feasible node", and nothing
# retries them.  At this size it shows on this seed: the same 45 pods of the
# measured wave stay unbound on every run.
FAULT_SEED = 77777
INTER = ("anti_affinity_violations", "affinity_violations", "spread_skew_excess")


def run(driver="program", fault=None, grace_s=60.0, seed=SEED):
    cell = Cell(SPEC, "interpod-300.backlog")
    return harness.run(cell, seed, 0.5, False, device="cpu", driver=driver, fault=fault,
                       scale={**SCALE, "grace_s": grace_s})


def test_the_program_keeps_every_guarantee():
    out = run()
    checks = out["checks"]
    assert out["correct"] and out["failed"] == 0, checks
    assert set(INTER) <= set(checks) and all(c["value"] == 0 for c in checks.values()), checks


def test_the_control_without_inter_pod_filters_is_not_correct():
    out = run(driver="affinity")
    assert not out["correct"] and out["checks"]["anti_affinity_violations"]["value"] > 0, out["checks"]
    assert out["checks"]["overcommitted_binds"]["value"] == 0


def test_the_plain_scheduler_with_every_filter_keeps_every_guarantee():
    # It packs (MostAllocated), which only the placement's spread catches.
    checks = run(driver="reference")["checks"]
    assert all(checks[k]["value"] == 0 for k in checks if k != "passed_over_pct"), checks


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_timed_path_is_not_correct(fault):
    out = run(fault=fault, grace_s=5.0)
    assert not out["correct"], (fault, out["checks"])


def test_known_fault_the_round_cap_leaves_pods_unbound_on_one_seed():
    # A record of the program's fault, not of what it should do: once the
    # fault is mended this reads every pod bound, and the test turns round
    # to assert that the run is correct on this seed.
    checks = run(seed=FAULT_SEED, grace_s=10.0)["checks"]
    assert checks["unbound_pods"]["value"] > 0, ("every pod bound: the round-cap fault looks mended", checks)
    assert all(c["value"] == 0 for k, c in checks.items() if k != "unbound_pods"), checks


def test_the_plain_scheduler_binds_the_wave_the_known_fault_leaves():
    witness = run(driver="reference", seed=FAULT_SEED)["checks"]
    assert all(witness[k]["value"] == 0 for k in witness if k != "passed_over_pct"), witness
