"""Time to bind, rates, rooflines and the device reduction on hand-made
numbers, and the roofline on a trace recorded on the card."""

import json
import pathlib

import pytest

from benchmark import devtrace
from benchmark.readers import idle_share, ms_per_kpod, roofline_share
from benchmark.roofline import PEAK_BYTES, PEAK_F32_OPS, choose_bound_s
from benchmark.stats import rate


def test_rate_over_whole_waves():
    assert rate(300, [(0.0, 1.0), (5.0, 7.0)]) == 100.0 and rate(5, []) == 0.0


def test_choose_bound_by_hand():
    t, which = choose_bound_s(100, 10)
    ops, nbytes = 100 * 10 * 47, 100 * 20 + 100 * 10 + 10 * 17
    assert which == "bytes" and t == pytest.approx(nbytes / PEAK_BYTES)
    t, which = choose_bound_s(100_000, 5_000)
    assert which == "operations" and t == pytest.approx(100_000 * 5_000 * 47 / PEAK_F32_OPS)
    t, which = choose_bound_s(100_000, 5_000, active=10)
    assert which == "bytes" and t == pytest.approx((10 * 20 + 100_000 * 10 + 5_000 * 17) / PEAK_BYTES)
    assert ops / PEAK_F32_OPS < nbytes / PEAK_BYTES


def cycle(pending, l1, l2, s1, s2, **phases):
    return {"pending": pending, "launches": {"launches": l1, "launches_constrained": l2},
            "choose_s": {"1": s1, "2": s2}, **phases}


def test_readers_by_hand():
    least = 100_000 * 5_000 * 47 / PEAK_F32_OPS
    trace = {"nodes": 5_000, "bound": 2_000, "busy_s": 0.25, "window_s": 10.0, "cycles": [
        cycle(100_000, 30, 0, 4 * least, 0.0, sync_seconds=1.0),
        cycle(50, 2, 3, 1.0, 1.0, sync_seconds=0.5),  # #2 launched too: not counted
        cycle(100_000, 0, 40, 0.0, 1.0, sync_seconds=0.5),  # #2 only: not counted
    ]}
    assert roofline_share(trace) == pytest.approx(25.0)
    assert ms_per_kpod(trace, "sync_seconds") == pytest.approx(2.0 * 1e6 / 2_000)
    assert idle_share(trace) == pytest.approx(97.5)
    assert roofline_share({"nodes": 5, "cycles": []}) is None


def test_device_union_and_idle_by_phase():
    events = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("copy", 4.0, 4.5), ("late", 9.0, 9.5)]
    windows = [(0.0, 5.0)]
    busy = devtrace.busy_union(events, windows)
    assert busy == [(1.0, 2.5), (4.0, 4.5)] and devtrace.length(busy) == 2.0
    idle = devtrace.idle_by_phase(busy, windows, [("sync", 0.0, 1.0), ("pack", 2.5, 3.5)])
    assert idle == pytest.approx({"sync": 1.0, "pack": 1.0, "other": 1.0})
    assert devtrace.top_ops(events, windows) == [["k1", 1.0], ["k2", 1.0], ["copy", 0.5]]
    choose = devtrace.choose_events([("void choose_kernel<false, true, false>(ChooseArgs)", 1.0, 1.25),
                                     ("void choose_kernel<true, true, false>(ChooseArgs)", 2.0, 2.5)])
    assert devtrace.kernel_seconds(choose, 0.0, 3.0) == {"1": 0.25, "2": 0.5}
    assert devtrace.kernel_seconds(choose, 1.5, 3.0) == {"1": 0.0, "2": 0.5}


def test_roofline_of_kernel_2():
    least = choose_bound_s(100_000, 5_000, widths=(8, 4))[0]
    assert least > choose_bound_s(100_000, 5_000)[0]
    trace = {"nodes": 5_000, "cycles": [
        cycle(100_000, 0, 40, 0.0, 2 * least, constraint_widths=[8, 4]),
        cycle(100_000, 30, 0, 1.0, 0.0),  # #1 only: not #2's
        cycle(50, 2, 3, 1.0, 1.0, constraint_widths=[8, 4]),  # both: neither's
    ]}
    assert roofline_share(trace, "2") == pytest.approx(50.0)
    del trace["cycles"][0]["constraint_widths"]
    assert roofline_share(trace, "2") is None
    assert roofline_share(trace, "1") == pytest.approx(100.0 * choose_bound_s(100_000, 5_000)[0])


def test_roofline_of_kernel_1_as_before_on_a_recorded_trace():
    # The traced cycles of a basic-5k.backlog run on the H100 (seed 4200000201):
    # #1's reading equals what the reader gave before it took a kernel.
    trace = json.loads((pathlib.Path(__file__).parent / "trace_basic-5k.backlog.json").read_text())
    assert roofline_share(trace) == 16.782938863124393
    assert roofline_share(trace, "2") is None
