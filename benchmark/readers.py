"""Arithmetic the per-layer readers share (``metrics/<name>.py``).

A reader takes the traced run's record (``harness._trace_record``) and
returns a number, or None when the run has nothing for it to read.
"""

from __future__ import annotations

from .roofline import choose_bound_s

__all__ = ["idle_share", "ms_per_kpod", "roofline_share"]


def ms_per_kpod(trace: dict, field: str) -> float | None:
    """A host phase's seconds (a ``CycleMetrics`` field) summed over the
    traced cycles, in milliseconds per 1,000 pods bound in the window."""
    if not trace["cycles"] or trace["bound"] <= 0:
        return None
    return sum(c[field] for c in trace["cycles"]) * 1e6 / trace["bound"]


def idle_share(trace: dict) -> float | None:
    """The share of the traced window in which no device operation ran, %."""
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def roofline_share(trace: dict) -> float | None:
    """Kernel #1's share of its roofline: the least time of one pass over
    every (pending pod, node) pair of the cycles whose solve launched only
    #1, over those launches' device seconds, %."""
    least = device = 0.0
    for c in trace["cycles"]:
        if c["launches"]["launches"] > 0 and c["launches"]["launches_constrained"] == 0 and c["pending"] > 0:
            least += choose_bound_s(c["pending"], trace["nodes"])[0]
            device += c["choose_s"]["1"]
    return 100.0 * least / device if device > 0 else None
