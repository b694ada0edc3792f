"""The bind worker's batches, first POST to last (CycleMetrics.bind_wall_s), per 1,000 pods bound, ms."""

from benchmark.critical_path import field, per_kpod


def read(trace):
    return per_kpod(trace, field("bind_wall_s"))
