"""The controller's overlay phase (controller _pre_cycle_overlay: the assumed-bind ledger and degraded-mode steps; CycleMetrics.overlay_seconds) per 1,000 pods bound, ms."""

from benchmark.readers import ms_per_kpod


def read(trace):
    return ms_per_kpod(trace, "overlay_seconds")
