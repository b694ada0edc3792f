"""The end-to-end arithmetic: the rate over the window's waves."""

from __future__ import annotations

__all__ = ["rate"]


def rate(pods: int, spans) -> float:
    """Pods over the summed seconds of the (start, end) spans."""
    seconds = sum(e - s for s, e in spans)
    return pods / seconds if seconds > 0 else 0.0
