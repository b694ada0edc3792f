"""Arithmetic the critical-path readers share: ``CycleMetrics`` fields
beyond the phases (``spans``, ``gc_pause_s``, ``bind_*``), summed over the
traced cycles per 1,000 pods bound.

A program that lacks a field (an older one) gives None, never an error:
the metric is then left out of the result line.
"""

from __future__ import annotations

__all__ = ["field", "field_difference", "nested_spans", "per_kpod"]


def per_kpod(trace: dict, seconds_of) -> float | None:
    """``seconds_of(cycle)`` summed over the traced cycles, in milliseconds
    per 1,000 pods bound in the window; None when any cycle gives None."""
    if not trace["cycles"] or trace["bound"] <= 0:
        return None
    total = 0.0
    for c in trace["cycles"]:
        seconds = seconds_of(c)
        if seconds is None:
            return None
        total += seconds
    return total * 1e6 / trace["bound"]


def field(name: str):
    """A cycle's ``name`` field, None where the program has none."""
    return lambda c: c.get(name)


def field_difference(a: str, b: str):
    """A cycle's field ``a`` less its field ``b``."""
    return lambda c: c[a] - c[b] if a in c and b in c else None


def nested_spans(*paths: str):
    """The seconds of a cycle's nested spans at ``paths`` (``spans``, keyed
    by base-name path, such as ``delta/commit/rebuild``); a path the cycle
    did not open adds 0."""
    return lambda c: sum(c["spans"].get(p, 0.0) for p in paths) if "spans" in c else None
