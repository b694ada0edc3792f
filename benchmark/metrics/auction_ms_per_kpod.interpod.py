"""The solve (CycleMetrics.solve_seconds): the auction's rounds, constrained ones through kernel #2, each ending in its host read, per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "solve_seconds")
