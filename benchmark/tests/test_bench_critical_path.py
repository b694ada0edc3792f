"""The critical-path readers on a hand-made trace record: each reads its
fields summed over the traced cycles per 1,000 pods bound, and each gives
None on cycles of a program that lacks its fields."""

import pytest

from benchmark.spec import load_reader

# reader -> its value on TRACE below (seconds over 2,000 pods, in ms/kpod)
EXPECTED = {
    "bind_ms_per_kpod.backlog": (0.5 + 1.5) * 1e6 / 2_000,
    "bind_wait_ms_per_kpod.backlog": ((0.5 - 0.125) + (1.5 - 0.5)) * 1e6 / 2_000,
    "gc_ms_per_kpod.backlog": (0.25 + 0.75) * 1e6 / 2_000,
    "delta_plan_ms_per_kpod.backlog": (0.25 + 0.125 + 0.5) * 1e6 / 2_000,
    "delta_rebuild_ms_per_kpod.backlog": 1.0 * 1e6 / 2_000,
    "sync_fold_ms_per_kpod.backlog": (0.75 + 0.25) * 1e6 / 2_000,
    "sync_snapshot_ms_per_kpod.backlog": 0.125 * 1e6 / 2_000,
}

# What the harness copies of two cycles: the old fields, and the new ones.
OLD = {"pending": 100, "bound": 100, "sync_seconds": 1.0, "delta_seconds": 2.0}
TRACE = {"bound": 2_000, "cycles": [
    {**OLD, "bind_wall_s": 0.5, "bind_cpu_s": 0.125, "gc_pause_s": 0.25,
     "spans": {"delta/index": 0.25, "delta/close": 0.125, "sync/fold": 0.75, "sync/snapshot": 0.125,
               "solve/round": 9.0}},
    {**OLD, "bind_wall_s": 1.5, "bind_cpu_s": 0.5, "gc_pause_s": 0.75,
     "spans": {"delta/repack": 0.5, "delta/commit": 1.5, "delta/commit/rebuild": 1.0, "sync/fold": 0.25}},
]}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_sums_its_fields_per_kpod(name):
    assert load_reader(name)(TRACE) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_its_fields(name):
    read = load_reader(name)
    assert read({"bound": 2_000, "cycles": [dict(OLD), dict(OLD)]}) is None
    assert read({"bound": 2_000, "cycles": [TRACE["cycles"][0], dict(OLD)]}) is None
    assert read({"bound": 0, "cycles": TRACE["cycles"]}) is None
    assert read({"bound": 2_000, "cycles": []}) is None
