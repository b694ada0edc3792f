"""The reflector's sync (runtime/reflector, CycleMetrics.sync_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "sync_seconds")
