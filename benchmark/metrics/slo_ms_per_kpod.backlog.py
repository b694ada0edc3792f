"""The SLO bookkeeping (controller _update_pending_ages, CycleMetrics.slo_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "slo_seconds")
