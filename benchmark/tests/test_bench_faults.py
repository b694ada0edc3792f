"""The harness at a small size on the CPU: a sound run is correct; a run
with the timed path broken underneath, the control, and a scheduler that
keeps every guarantee but packs, are not."""

import pytest

from bench_sizes import small_run
from benchmark.system import FAULTS


def test_sound_run_is_correct():
    out = small_run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["passed_over_pct"]["value"] == 0
    assert list(out)[-1] == "checks" and "setup_s" in out["metrics"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault):
    out = small_run(fault=fault)
    assert not out["correct"], (fault, out["checks"])


def test_the_control_is_not_correct():
    from benchmark.cluster import load_deployment
    from benchmark.spec import Cell, load_spec

    breaks = load_deployment(Cell(load_spec(), "basic-5k.backlog").config_file).raw["control"]
    out = small_run(driver=breaks)
    assert not out["correct"] and out["checks"]["overcommitted_binds"]["value"] > 0, out["checks"]


def test_a_packing_scheduler_is_not_correct():
    # The reference scheduler keeps every guarantee and packs (MostAllocated):
    # a third of the nodes get none of a wave, which only the spread catches.
    out = small_run(driver="reference")
    checks = out["checks"]
    assert not out["correct"] and checks["passed_over_pct"]["value"] > 30, checks
    assert all(checks[k]["value"] == 0 for k in ("bad_binds", "overcommitted_binds", "unbound_pods")), checks
