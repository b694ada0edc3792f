"""Priority scoring in torch — the port of ``tpu_scheduler/ops/score.py``
(LeastRequested + BalancedAllocation, the soft terms, and the uint32
tie-break hash with bucket quantization).

Every float32 operation runs in the JAX package's order, one eager op at a
time (eager torch never fuses a multiply into an add), so scores equal the
NumPy/XLA tree bit for bit:

  used_after[p,n,r] = (alloc[n,r] − avail[n,r]) + req[p,r]       (int32)
  frac              = used_after / alloc              (1.0 where alloc == 0)
  least_requested   = ((1 − frac_cpu) + (1 − frac_mem)) · 50
  balanced          = (1 − |frac_cpu − frac_mem|) · 100
  score             = w₀·least_requested + w₁·balanced + w₃·pref − w₄·soft
  h                 = rank·2654435761 + node·2246822519 + salt·3266489917 (mod 2³²)
  h                 = (h ^ (h >> 15)) & 0xFFFF
  score             = where(w₂ > 0, ⌊score / w₂⌋·w₂, score) + w₂·(h / 65536)

then, in constrained cycles, after the jitter (each term skipped when absent):

  score            −= w₅·(sps_declares @ sp_penalty_node)     soft spread
  score            −= (2·w₂)·(sp_declares @ sp_level_node)    hard-spread steering
  score            += ppa_w @ ppa_cnt_node                    preferred inter-pod

and, in topology cycles, as the last term:

  score            += topo_gang_node[pod_gang_id]             gang co-placement

torch has no uint32 ``add`` or ``>>``, so the hash runs in int64 and masks
to 32 bits; ranks and node indices are below 2³¹, so no product overflows.
"""

from __future__ import annotations

import torch

__all__ = ["score_block"]

_U32 = 0xFFFFFFFF


def _jitter_hash(pod_idx: torch.Tensor, node_idx: torch.Tensor, salt: int | None) -> torch.Tensor:
    """[B, N] int64 hash in [0, 65536): the uint32 wraparound hash of the
    JAX package, emulated in int64."""
    h = ((pod_idx.to(torch.int64)[:, None] * 2654435761) & _U32) + (
        (node_idx.to(torch.int64)[None, :] * 2246822519) & _U32
    )
    if salt is not None:
        h = h + ((int(salt) * 3266489917) & _U32)
    h = h & _U32
    return (h ^ (h >> 15)) & 0xFFFF


def score_block(
    pod_req: torch.Tensor,
    node_alloc: torch.Tensor,
    node_avail: torch.Tensor,
    weights: torch.Tensor,
    pod_idx: torch.Tensor | None = None,
    node_idx: torch.Tensor | None = None,
    pod_pref_w: torch.Tensor | None = None,
    node_pref: torch.Tensor | None = None,
    pod_ntol_soft: torch.Tensor | None = None,
    node_taints_soft: torch.Tensor | None = None,
    salt: int | None = None,
    pod_sps_declares: torch.Tensor | None = None,
    sp_penalty_node: torch.Tensor | None = None,
    pod_sp_declares: torch.Tensor | None = None,
    sp_level_node: torch.Tensor | None = None,
    pod_ppa_w: torch.Tensor | None = None,
    ppa_cnt_node: torch.Tensor | None = None,
    pod_gang_id: torch.Tensor | None = None,
    topo_gang_node: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, N] float32 score of a block of pods against all nodes.

    ``weights`` is the profile's float32 weight vector on the tensors'
    device (models/profiles.py ``weights()`` order); ``pod_idx``/``node_idx``
    are the global indices the jitter hash reads (the jitter is skipped when
    either is None).  The constraint terms take the pod bitmaps [B, ·] and
    the round's node masks [·, N] (ops/constraints.round_blocked_masks);
    the gang term the block's gang ids [B] and the round's [G+1, N] term
    (topology/locality.gang_topology_term)."""
    f32 = torch.float32
    # Scoring reads cpu/mem only (columns 0-1).
    pod_req = pod_req[:, :2]
    node_alloc = node_alloc[:, :2]
    node_avail = node_avail[:, :2]
    used_after = (node_alloc - node_avail)[None, :, :] + pod_req[:, None, :]  # [B,N,2] int32, wraps like numpy
    safe = (node_alloc > 0)[None, :, :]
    denom = torch.where(safe, node_alloc.to(f32)[None, :, :], 1.0)
    frac = torch.where(safe, used_after.to(f32) / denom, 1.0)
    least_requested = ((1.0 - frac[..., 0]) + (1.0 - frac[..., 1])) * 50.0
    balanced = (1.0 - torch.abs(frac[..., 0] - frac[..., 1])) * 100.0
    score = weights[0] * least_requested + weights[1] * balanced
    if pod_pref_w is not None and node_pref is not None:
        score = score + weights[3] * (pod_pref_w @ node_pref.T)
    if pod_ntol_soft is not None and node_taints_soft is not None:
        score = score - weights[4] * (pod_ntol_soft @ node_taints_soft.T)
    if pod_idx is not None and node_idx is not None:
        h = _jitter_hash(pod_idx, node_idx, salt)
        jw = weights[2]
        safe_w = torch.where(jw > 0, jw, 1.0)
        score = torch.where(jw > 0, torch.floor(score / safe_w) * safe_w, score) + jw * (h.to(f32) / 65536.0)
    if pod_sps_declares is not None and sp_penalty_node is not None:
        score = score - weights[5] * (pod_sps_declares @ sp_penalty_node)
    if pod_sp_declares is not None and sp_level_node is not None:
        score = score - (2.0 * weights[2]) * (pod_sp_declares @ sp_level_node)
    if pod_ppa_w is not None and ppa_cnt_node is not None:
        score = score + pod_ppa_w @ ppa_cnt_node
    if pod_gang_id is not None and topo_gang_node is not None:
        score = score + topo_gang_node[pod_gang_id.long()]
    return score.to(f32)
