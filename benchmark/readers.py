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


# Each choose kernel's launch counter, and the other's.
_LAUNCHES = {"1": ("launches", "launches_constrained"), "2": ("launches_constrained", "launches")}


def roofline_share(trace: dict, kernel: str = "1") -> float | None:
    """Kernel #1's (or #2's) share of its roofline: the least time of one
    pass over every (pending pod, node) pair of the cycles whose solve
    launched only that kernel, over those launches' device seconds, %.  #2's
    pass also reads its constraint bitmaps, whose widths a cycle record
    carries as ``constraint_widths``; without them #2 reads None."""
    own, other = _LAUNCHES[kernel]
    least = device = 0.0
    for c in trace["cycles"]:
        if c["launches"][own] > 0 and c["launches"][other] == 0 and c["pending"] > 0:
            widths = ()
            if kernel == "2":
                widths = c.get("constraint_widths")
                if widths is None:
                    return None
            least += choose_bound_s(c["pending"], trace["nodes"], widths=widths)[0]
            device += c["choose_s"][kernel]
    return 100.0 * least / device if device > 0 else None
