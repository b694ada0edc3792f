"""The solve (CudaBackend.schedule through ops/assign and ops/constraints, CycleMetrics.solve_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "solve_seconds")
