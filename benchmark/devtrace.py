"""Reduction of a ``torch.profiler`` trace to the benchmark's device numbers.

Intervals are (start, end) seconds on the wall clock (the profiler's
events are stamped in epoch nanoseconds, as ``time.time`` counts).  The
device is busy where any device operation (kernel, copy, set) runs: the
union of their intervals, not their sum, since operations on several
streams overlap.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

__all__ = ["busy_union", "choose_events", "clip", "device_events", "idle_by_phase", "kernel_seconds", "length", "merge", "top_ops"]

# Kernel #1 and #2 of csrc/choose.cu: choose_kernel<CONSTRAINED, ONE_WORD, TOPO>.
_CHOOSE = re.compile(r"choose_kernel<\s*(true|false)")


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of every device operation the profiler saw."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            s = e.start_ns() * 1e-9
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
    return out


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, windows) -> list[tuple[float, float]]:
    """Disjoint ``intervals`` cut to the disjoint ``windows``."""
    out = []
    windows = merge(windows)
    starts = [w[0] for w in windows]
    for s, e in intervals:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(windows) and windows[i][0] < e:
            lo, hi = max(s, windows[i][0]), min(e, windows[i][1])
            if hi > lo:
                out.append((lo, hi))
            i += 1
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def busy_union(events, windows) -> list[tuple[float, float]]:
    """Where the device ran something, inside ``windows``."""
    return clip(merge((s, e) for _, s, e in events), windows)


def idle_by_phase(busy, windows, host_spans) -> dict[str, float]:
    """Idle device seconds inside ``windows``, split by what the host was
    doing: ``host_spans`` are disjoint (name, start, end); idle time under
    no span counts as "other"."""
    idle = []
    for ws, we in merge(windows):
        t = ws
        for s, e in clip(busy, [(ws, we)]):
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if we > t:
            idle.append((t, we))
    spans = sorted(host_spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    out: dict[str, float] = defaultdict(float)
    for s, e in idle:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(spans) and spans[i][1] < e:
            name, ss, se = spans[i]
            ov = min(e, se) - max(s, ss)
            if ov > 0:
                out[name] += ov
                covered += ov
            i += 1
        if e - s - covered > 0:
            out["other"] += e - s - covered
    return dict(out)


def _inside(windows):
    windows = merge(windows)
    starts = [w[0] for w in windows]

    def test(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= windows[i][1]

    return test


def top_ops(events, windows, k: int = 10) -> list[list]:
    """The ``k`` device operations with the most time among those that
    start inside ``windows``."""
    inside = _inside(windows)
    total: dict[str, float] = defaultdict(float)
    for name, s, e in events:
        if inside(s):
            total[name] += e - s
    return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]


def choose_events(events) -> list[tuple[float, float, str]]:
    """(start, end, kernel) of each choose launch, sorted: kernel "1" is
    #1, "2" the constrained #2."""
    out = []
    for name, s, e in events:
        m = _CHOOSE.search(name)
        if m:
            out.append((s, e, "2" if m.group(1) == "true" else "1"))
    return sorted(out)


def kernel_seconds(choose, start: float, end: float) -> dict[str, float]:
    """Device seconds of #1 ("1") and #2 ("2") among ``choose`` (sorted, from
    :func:`choose_events`) starting in [start, end]."""
    out = {"1": 0.0, "2": 0.0}
    i = bisect.bisect_left(choose, (start,))
    while i < len(choose) and choose[i][0] <= end:
        out[choose[i][2]] += choose[i][1] - choose[i][0]
        i += 1
    return out
