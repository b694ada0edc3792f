"""The stall mop-up: the exact sequential chain over the constrained residue of an auction (CycleMetrics.mopup_seconds), per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "mopup_seconds")
