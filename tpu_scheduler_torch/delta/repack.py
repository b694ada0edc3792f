"""Candidate-node workspace compaction for delta cycles.

The PR-9 conflict filter gathers a round's accepted claimants into a
compact ``[A]`` workspace so the cell passes scale with the accepted count,
not the padded pod axis.  This is the node-axis analogue for the delta
cycle: nodes that cannot host even the SMALLEST dirty request on some axis
are infeasible for every dirty pod, so the solve's ``[P, N]`` sweeps can
drop their columns wholesale.

Soundness: the exclusion test is per-axis against the per-axis MINIMUM of
the dirty requests (a node below the cpu minimum fails ``req <= avail`` for
every dirty pod; a zero minimum excludes nothing on that axis), so the
feasible (pod, node) set is unchanged and the solve places the identical
POD SET — only the tie-break jitter (a function of the node column index)
may pick different winners among equal-score candidates, which is inside
the delta contract's documented tie-break freedom.

Applied only when it pays and cannot interact with cross-node state:
  • plain batches only (no packed constraints, no topology state — their
    domain tensors aggregate over the full node axis);
  • at least half the nodes must drop (a mostly-free cluster keeps the
    full axis and the solver's warm compile);
  • the compacted axis pads to a power-of-two bucket (>= node_block) so
    repeated saturated cycles reuse a handful of compiled shapes instead
    of recompiling per cycle.

Port: a copy of ``tpu_scheduler/delta/repack.py``, unchanged (NumPy).  The
compacted node tensors are new arrays each cycle, so ``CudaBackend``'s
identity-keyed upload cache misses on them.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..ops.pack import round_up

__all__ = ["compact_candidate_nodes"]


def _bucket(n: int, node_block: int) -> int:
    """Quantized padding for the compacted axis: next power of two at or
    above ``n``, floored at one node block — few distinct jit shapes."""
    size = max(int(node_block), 1)
    while size < n:
        size *= 2
    return round_up(size, node_block)


def _candidate_mask(avail: np.ndarray, min_req: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Nodes that can host at least the smallest dirty request on BOTH
    fixed axes (cpu, memory) — a node below either minimum fails
    ``req <= avail`` for every dirty pod, so its column is dead weight."""
    return valid & (avail[:, 0] >= min_req[0]) & (avail[:, 1] >= min_req[1])


def compact_candidate_nodes(packed, node_block: int = 128):
    """Gather the candidate-node rows of every node-side tensor into a
    compact workspace (or return ``packed`` unchanged when compaction does
    not pay).  Candidates = valid nodes whose available cpu AND memory meet
    the per-axis minimum of the dirty requests."""
    if packed.constraints is not None or packed.topology is not None:
        return packed
    n_real = len(packed.node_names)
    if n_real == 0:
        return packed
    valid_req = packed.pod_req[packed.pod_valid]
    if valid_req.shape[0] == 0:
        return packed
    min_req = valid_req.min(axis=0)  # [R] i32, per-axis smallest dirty ask
    keep = _candidate_mask(
        packed.node_avail[:n_real], min_req, np.asarray(packed.node_valid[:n_real], dtype=bool)
    )
    idx = np.flatnonzero(keep)
    if len(idx) == 0 or len(idx) > n_real // 2:
        return packed  # nothing to drop, or not enough to pay for new shapes
    n_pad = _bucket(len(idx), node_block)
    out = {}
    for field in (
        "node_alloc",
        "node_avail",
        "node_labels",
        "node_taints",
        "node_aff",
        "node_valid",
        "node_taints_soft",
        "node_pref",
    ):
        arr = getattr(packed, field)
        gathered = arr[idx]
        pad_rows = n_pad - len(idx)
        if pad_rows:
            gathered = np.concatenate(
                [gathered, np.zeros((pad_rows,) + arr.shape[1:], dtype=arr.dtype)], axis=0
            )
        out[field] = gathered
    out["node_names"] = tuple(packed.node_names[i] for i in idx)
    return replace(packed, **out)
