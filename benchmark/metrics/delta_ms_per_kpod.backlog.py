"""The delta engine (delta/: plan, commit, the rebuild after each full wave; CycleMetrics.delta_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "delta_seconds")
