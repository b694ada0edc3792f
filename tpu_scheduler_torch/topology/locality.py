"""Rank-aware gang co-placement scoring — the port of
``tpu_scheduler/topology/locality.py``.

A gang (an MPI-style training job's workers) is only as fast as its slowest
link, so placement quality is communication performance.  This module turns
the compiled topology (model.py) plus the cycle's gang membership into ONE
per-round additive score tensor ``T[G+1, N]`` shared by every member of a
gang; the choose adds the row of each pod's gang as its last score term
(ops/score.py, and the choose kernels on the card).

Three components, all per (gang, node), recomputed each auction round from
the round-carried placement counts:

  anchor   −w·Σ_l 16·d_l·(placed_total_g − same_l[g, n]) — the distance
           from node n to every already-placed member of g, factored
           through the per-level membership one-hots;
  fit      +w·Σ_l d_l·fits_l[g, dom_l(n)] — the gang's remaining demand
           fits the node's level-l domain whole;
  herd     +w·Σ_l 4·d_l·fits_l·tb_l[g, dom_l(n)] — a per-(gang, domain)
           crc32 tie-break in [0, 1) shared by every member, so the members
           converge on one fitting domain in the first round.

``w`` is the profile's ``gang_locality_weight`` (weights[6]).  Pods outside
any gang ride row 0 of T, which is pinned to +0.0.

``pack_topology`` stays NumPy (host packing, the crc32 herd table bit for
bit); ``gang_topology_term`` and ``gang_state_update`` are torch functions
on one device.  Every float32 operation runs in the JAX package's order, one
eager op at a time, so T equals the NumPy tree bit for bit:

* ``placed @ onehot.T`` sums integer counts (0/1 one-hots), exact in any
  order; ``onehot @ free`` sums free capacities, exact whenever the sums
  are (capacities in KiB that are multiples of a large power of two, as
  every packed cluster here has them) — both are ``torch.matmul`` with
  TF32 off;
* the per-gang remaining demand adds its rows in pod order, as
  ``np.add.at`` does (:func:`_add_rows`), so it rounds as the reference's
  where a sum is inexact; the placement counts are 0/1 adds, exact in any
  order.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "ANCHOR_SCALE",
    "HERD_SCALE",
    "SCORING_KNOBS",
    "TopologySet",
    "gang_placement_stats",
    "gang_state_update",
    "gang_topology_term",
    "pack_topology",
]

# The profile knobs this subsystem reads.
SCORING_KNOBS = ("gang_locality_weight",)

# Component scales inside the term (all further multiplied by the profile's
# gang_locality_weight): ANCHOR > max herd spread > fit > per-pod jitter, so
# once any member is placed no herd tie-break pulls the rest elsewhere.
ANCHOR_SCALE = 16.0
HERD_SCALE = 4.0


@dataclass(frozen=True)
class TopologySet:
    """Per-cycle topology tensors for one packed cluster (host NumPy).  Pod
    rows align with PackedCluster's pending order (padded to P); node
    columns with its node order (padded to N, padding nodes in per-level
    sentinel domains that never fit)."""

    pod_gang_id: np.ndarray  # [P] int32 — 0 = no gang, 1..G
    # meta (static per cycle): per level l in 0..Lv-1:
    #   dom_id_l     [N]         int32  node's domain id (D_l = padding sentinel)
    #   dom_onehot_l [D_l+1, N]  f32    domain membership rows
    #   gang_tb_l    [G+1, D_l+1] f32   per-(gang, domain) herd tie-break [0,1)
    # plus level_dist [Lv] f32.
    meta: dict
    n_gangs: int
    gang_names: tuple[str, ...]  # 1-based: gang_names[g-1] is gang id g
    compiled: object  # the CompiledTopology (host-side consumers)

    def meta_arrays(self) -> dict:
        return self.meta

    def pod_arrays(self) -> dict:
        return {"pod_gang_id": self.pod_gang_id}

    def state_arrays(self) -> dict:
        """Round-start state: per-(gang, node) placed-member counts [G+1,
        N+1].  Column N is the non-claimant sentinel, row 0 the no-gang
        dump — both never read back.  The backends build it on the device
        (``convert.topology_to_device``), never from these host zeros."""
        n = self.meta["dom_id_0"].shape[0]
        return {"gang_nodes": np.zeros((self.n_gangs + 1, n + 1), dtype=np.float32)}


def _herd_tb(gang: str, level: int, dom: int) -> float:
    """Deterministic per-(gang, level, domain) tie-break in [0, 1) — crc32,
    stable across processes, backends and replays."""
    return zlib.crc32(f"{gang}|{level}|{dom}".encode()) / 4294967296.0


def pack_topology(compiled, pending, p_pad: int, node_names: tuple[str, ...], n_pad: int) -> TopologySet | None:
    """Build the cycle's TopologySet, or None when no pending pod declares a
    gang (the term would be all-zero).  ``compiled`` node order must cover
    ``node_names`` (same snapshot); padding rows/columns get gang 0 /
    per-level sentinel domains."""
    gang_ids = np.zeros((p_pad,), dtype=np.int32)
    gang_names: list[str] = []
    by_name: dict[str, int] = {}
    for i, pod in enumerate(pending):
        g = pod.spec.gang if pod.spec is not None else None
        if not g:
            continue
        gid = by_name.get(g)
        if gid is None:
            gang_names.append(g)
            by_name[g] = gid = len(gang_names)  # 1-based
        gang_ids[i] = gid
    if not gang_names:
        return None

    row = {n: i for i, n in enumerate(compiled.node_names)}
    gather = np.asarray([row[n] for n in node_names], dtype=np.intp)
    n_real = len(node_names)
    g1 = len(gang_names) + 1
    meta: dict[str, np.ndarray] = {"level_dist": compiled.level_distances()}
    for l_idx in range(compiled.n_levels):
        d = int(compiled.dom_counts[l_idx])
        dom_id = np.full((n_pad,), d, dtype=np.int32)  # padding → sentinel
        dom_id[:n_real] = compiled.dom_ids[l_idx][gather]
        onehot = np.zeros((d + 1, n_pad), dtype=np.float32)
        onehot[dom_id, np.arange(n_pad)] = 1.0
        tb = np.zeros((g1, d + 1), dtype=np.float32)
        for g, name in enumerate(gang_names, start=1):
            for dom in range(d):  # sentinel column stays 0 (never fits anyway)
                tb[g, dom] = _herd_tb(name, l_idx, dom)
        meta[f"dom_id_{l_idx}"] = dom_id
        meta[f"dom_onehot_{l_idx}"] = onehot
        meta[f"gang_tb_{l_idx}"] = tb
    return TopologySet(
        pod_gang_id=gang_ids,
        meta=meta,
        n_gangs=len(gang_names),
        gang_names=tuple(gang_names),
        compiled=compiled,
    )


def _add_rows(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += vals[i]`` for i in order, in place: ``index_add_``
    on the CPU (a serial loop over i), ``index_put_(accumulate=True)`` on
    CUDA (a stable sort of the indices, then one sequential sum per row).
    The other pairing is not in order: ``index_add_`` adds with atomics on
    CUDA, ``index_put_`` with atomics on several CPU threads."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def gang_topology_term(gang_nodes, meta: dict, avail, pod_gang_id, pod_req, active, weight) -> torch.Tensor:
    """The per-round [G+1, N] float32 additive score tensor (module
    docstring), contiguous, on the tensors' device.

    ``gang_nodes`` is the round-carried [G+1, N+1] placed-member count (its
    sentinel column is sliced off here); ``avail`` [N, R] int32 and
    ``pod_req`` [P, R] int32 / ``active`` [P] bool / ``pod_gang_id`` [P]
    int32 are the round's live capacity and pod rows; ``weight`` the
    profile's gang_locality_weight (a float32 scalar or 0-d tensor).
    ``meta``: TopologySet.meta_arrays as tensors on the same device."""
    f32 = torch.float32
    device = avail.device
    if device.type == "cuda":
        # The matmuls are exact only in full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
    n = avail.shape[0]
    placed = gang_nodes[:, :n]  # [G+1, N] — drop the sentinel column
    g1 = placed.shape[0]
    level_dist = meta["level_dist"]
    weight = torch.as_tensor(weight, dtype=f32, device=device)
    # Remaining demand of each gang's still-active members (cpu, mem), in
    # pod order: float32 on purpose, a scoring heuristic.
    live_req = torch.where(active[:, None], pod_req[:, :2], 0).to(f32)  # [P, 2]
    rem = _add_rows(torch.zeros((g1, 2), dtype=f32, device=device), pod_gang_id.long(), live_req)
    free = torch.clamp(avail[:, :2], min=0).to(f32)  # [N, 2]
    total = placed.sum(dim=1, keepdim=True)  # [G+1, 1]

    # The [G+1, N] intermediates are updated in place (one buffer per term,
    # the same roundings as the reference's out-of-place tree).
    t = torch.zeros((g1, n), dtype=f32, device=device)
    for l_idx in range(level_dist.shape[0]):
        d_l = level_dist[l_idx]
        dom_id = meta[f"dom_id_{l_idx}"].long()
        onehot = meta[f"dom_onehot_{l_idx}"]  # [D+1, N]
        # anchor: (16·d_l)·(total − same), same = the same-level placed
        # count per (gang, node).
        x = (placed @ onehot.T)[:, dom_id]  # [G+1, N]
        torch.sub(total, x, out=x)
        t.sub_(x.mul_(ANCHOR_SCALE * d_l))
        # fit + herd: d_l·(fits·(1 + 4·tb))[:, dom_id] — remaining demand vs
        # the node's level-l domain free capacity; the tie-break rides only
        # on fitting domains.
        dom_free = onehot @ free  # [D+1, 2]
        fits = (rem[:, None, :] <= dom_free[None, :, :]).all(-1).to(f32)  # [G+1, D+1]
        x = (fits * (1.0 + HERD_SCALE * meta[f"gang_tb_{l_idx}"]))[:, dom_id]
        t.add_(x.mul_(d_l))
        del x
    # Row 0 (no gang) pinned to +0.0: score-neutral for gangless pods.
    t.mul_(weight)
    t[0] = 0.0
    return t


def gang_state_update(gang_nodes, accepted, choice, pod_gang_id) -> torch.Tensor:
    """Fold a round's accepted placements into the [G+1, N+1] per-(gang,
    node) counts, IN PLACE (the state is per cycle and never a cached
    upload), and return it.  ``choice`` may carry the non-claimant sentinel
    N (lands in the sentinel column, never read back); gangless pods land
    in row 0 (same)."""
    gang_nodes.index_put_((pod_gang_id.long(), choice.long()), accepted.to(gang_nodes.dtype), accumulate=True)
    return gang_nodes


def gang_placement_stats(member_domains, level_dists) -> dict:
    """Pairwise placement-distance statistics for ONE gang's placed members:
    ``member_domains`` per member the (finest → coarsest) domain-name tuple
    of its node (CompiledTopology.domains_of), ``level_dists`` the per-level
    distance contributions.  Returns max/mean pairwise distance plus
    ``cross_edges``, the pairs that differ at the COARSEST level."""
    k = len(member_domains)
    pairs = 0
    dist_sum = 0.0
    dist_max = 0.0
    cross = 0
    for i in range(k):
        for j in range(i + 1, k):
            pairs += 1
            d = 0.0
            for lvl, w in enumerate(level_dists):
                if member_domains[i][lvl] != member_domains[j][lvl]:
                    d += float(w)
            dist_sum += d
            dist_max = max(dist_max, d)
            if member_domains[i][-1] != member_domains[j][-1]:
                cross += 1
    return {
        "members": k,
        "pairs": pairs,
        "max_distance": round(dist_max, 6),
        "mean_distance": round(dist_sum / pairs, 6) if pairs else 0.0,
        "cross_edges": cross,
    }
