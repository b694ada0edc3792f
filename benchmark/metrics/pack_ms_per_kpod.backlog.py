"""The controller's pack phase (ops/pack, CycleMetrics.pack_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "pack_seconds")
