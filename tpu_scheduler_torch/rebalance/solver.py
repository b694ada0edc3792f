"""Packing statistics — a copy of ``packing_stats`` from
``tpu_scheduler/rebalance/solver.py``.  The packing solve itself waits for
ROADMAP Queue 1 item 9."""

from __future__ import annotations

import numpy as np

__all__ = ["packing_stats"]


def packing_stats(alloc: np.ndarray, used: np.ndarray) -> dict:
    """Packing-efficiency / stranded-capacity verdict over one capacity
    view.  ``efficiency`` is the dominant-axis fill of the OCCUPIED node
    set (1.0 = every occupied node full on its binding axis; an empty
    cluster scores 1.0 — nothing is stranded); ``stranded_frac`` is the
    free share of occupied capacity on the same axis.  Exact integer sums;
    the single division is deterministic on a given platform."""
    occ = (used > 0).any(axis=1)
    occupied = int(occ.sum())
    out = {
        "occupied_nodes": occupied,
        "empty_nodes": int(len(used) - occupied),
        "efficiency": 1.0,
        "stranded_frac": 0.0,
    }
    if not occupied:
        return out
    a = alloc[occ].sum(axis=0)
    u = used[occ].sum(axis=0)
    fills = [int(u[k]) / int(a[k]) for k in range(2) if int(a[k]) > 0]
    if fills:
        eff = max(fills)
        out["efficiency"] = round(eff, 6)
        # Pre-oversubscribed state (synthetic round-robin binding) can push
        # the occupied-set fill past 1; stranded capacity floors at zero.
        out["stranded_frac"] = round(max(0.0, 1.0 - eff), 6)
    return out
