"""The collector's pauses inside the cycles, on every thread (CycleMetrics.gc_pause_s), per 1,000 pods bound, ms."""

from benchmark.critical_path import field, per_kpod


def read(trace):
    return per_kpod(trace, field("gc_pause_s"))
