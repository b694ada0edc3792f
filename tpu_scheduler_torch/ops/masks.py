"""Batched feasibility mask in torch — the port of ``tpu_scheduler/ops/masks.py``.

One [pods × nodes] boolean mask:

  fit[p,n]   = all_r( pod_req[p,r] <= node_avail[n,r] )          (PodFitsResources)
  sel[p,n]   = (pod_sel[p] · node_labels[n]) == pod_sel_count[p] (nodeSelector)
  taint[p,n] = (pod_ntol[p] · node_taints[n]) == 0               (taints/tolerations)
  aff[p,n]   = no-affinity or (pod_aff[p] · node_aff[n]) > 0     (node affinity, ORed terms)
  mask       = fit & sel & taint & aff & pod_active & node_valid

The dot products are float32 matmuls of 0/1 bitmaps: every count is a small
exact integer, so any summation order gives the JAX package's values bit
for bit.
"""

from __future__ import annotations

import torch

__all__ = ["feasibility_block", "feasibility_breakdown", "reason_rejection_counts"]


def feasibility_breakdown(
    pod_req: torch.Tensor,
    pod_sel: torch.Tensor,
    pod_sel_count: torch.Tensor,
    node_avail: torch.Tensor,
    node_labels: torch.Tensor,
    pod_ntol: torch.Tensor | None = None,
    node_taints: torch.Tensor | None = None,
    pod_aff: torch.Tensor | None = None,
    pod_has_aff: torch.Tensor | None = None,
    node_aff: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """``{InvalidNodeReason value -> [B, N] pass-mask}`` — the predicate
    masks :func:`feasibility_block` ANDs together."""
    out = {"NotEnoughResources": (pod_req[:, None, :] <= node_avail[None, :, :]).all(-1)}
    out["NodeSelectorMismatch"] = (pod_sel @ node_labels.T) == pod_sel_count[:, None]
    if pod_ntol is not None and node_taints is not None:
        out["TaintNotTolerated"] = (pod_ntol @ node_taints.T) == 0
    if pod_aff is not None and node_aff is not None and pod_has_aff is not None:
        out["NodeAffinityMismatch"] = ((pod_aff @ node_aff.T) > 0) | (pod_has_aff[:, None] == 0)
    return out


def feasibility_block(
    pod_req: torch.Tensor,
    pod_sel: torch.Tensor,
    pod_sel_count: torch.Tensor,
    pod_active: torch.Tensor,
    node_avail: torch.Tensor,
    node_labels: torch.Tensor,
    node_valid: torch.Tensor,
    pod_ntol: torch.Tensor | None = None,
    node_taints: torch.Tensor | None = None,
    pod_aff: torch.Tensor | None = None,
    pod_has_aff: torch.Tensor | None = None,
    node_aff: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, N] bool feasibility of a block of pods against all nodes."""
    parts = feasibility_breakdown(
        pod_req, pod_sel, pod_sel_count, node_avail, node_labels, pod_ntol, node_taints, pod_aff, pod_has_aff, node_aff
    )
    mask = node_valid[None, :] & pod_active[:, None]
    for part in parts.values():
        mask = mask & part
    return mask


def reason_rejection_counts(breakdown: dict[str, torch.Tensor], node_valid: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-pod candidate-node rejection counts from a breakdown: ``{reason
    -> [B] int64 number of otherwise-valid nodes failing that predicate}``
    (non-exclusive: a node can fail several; the first-fail attribution is
    ``core.predicates.unschedulable_reason_counts``)."""
    return {reason: (node_valid[None, :] & ~part).sum(-1) for reason, part in breakdown.items()}
