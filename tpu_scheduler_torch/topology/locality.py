"""Rank-aware gang co-placement scoring — the port of
``tpu_scheduler/topology/locality.py``.

A gang (an MPI-style training job's workers) is only as fast as its slowest
link, so placement quality is communication performance.  This module turns
the compiled topology (model.py) plus the cycle's gang membership into one
per-round additive score term T[g, n] shared by every member of a gang; the
choose adds the value of each pod's gang as its last score term
(ops/score.py, and the choose kernels on the card).

Three components, all per (gang, node), recomputed each auction round from
the round-carried placement counts:

  anchor   −w·Σ_l 16·d_l·(placed_total_g − same_l[g, dom_l(n)]) — the
           distance from node n to every already-placed member of g;
  fit      +w·Σ_l d_l·fits_l[g, dom_l(n)] — the gang's remaining demand
           fits the node's level-l domain whole;
  herd     +w·Σ_l 4·d_l·fits_l·tb_l[g, dom_l(n)] — a per-(gang, domain)
           crc32 tie-break in [0, 1) shared by every member, so the members
           converge on one fitting domain in the first round.

``w`` is the profile's ``gang_locality_weight`` (weights[6]).  Pods outside
any gang ride row 0, which is pinned to +0.0.

Every input of T[g, n] is a per-(gang, domain) or per-gang value read at the
node's domain, so the round state is per domain: ``placed`` [G+1, Dt], the
placed-member count of each gang in each domain of every level (level l's
D_l+1 columns, its padding sentinel last, start at Σ_{k<l} (D_k+1)), and
``total`` [G+1].  The JAX package carries a [G+1, N+1] per-node count and
forms ``same`` as ``placed @ onehot.T``; the counts are integers, so the
per-domain sums are the same floats in any order.  On the card the choose
kernels compute each pod's term from this state (:class:`GangTerm`); the
dense [G+1, N] term, :func:`gang_topology_term`, is their plain version,
used on the CPU and by the checks.

``pack_topology`` stays NumPy (host packing, the crc32 herd table bit for
bit); the rest are torch functions on one device.  Every float32 operation
runs in the JAX package's order, one eager op at a time, so T equals the
NumPy tree bit for bit:

* ``onehot @ free`` sums free capacities, exact whenever the sums are
  (capacities in KiB that are multiples of a large power of two, as every
  packed cluster here has them) — ``torch.matmul`` with TF32 off;
* the per-gang demand adds its rows in pod order, as ``np.add.at`` does
  (:func:`_add_rows`), so it rounds as the reference's where a sum is
  inexact; the placement counts are 0/1 adds, exact in any order.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "ANCHOR_SCALE",
    "DENSE_TERMS_CUDA",
    "GangTerm",
    "HERD_SCALE",
    "SCORING_KNOBS",
    "TopologySet",
    "domain_columns",
    "gang_cycle_operands",
    "gang_placement_stats",
    "gang_round_operands",
    "gang_state_update",
    "gang_state_zeros",
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
        """Round-start state: per-(gang, domain) placed-member counts
        ``placed`` [G+1, Dt] (every level's domains, sentinels included) and
        per-gang totals ``total`` [G+1].  Row 0 is the no-gang dump, never
        read back.  The backends build it on the device
        (``convert.topology_to_device``), never from these host zeros."""
        dt = sum(w for _, w in domain_columns(self.meta))
        return {
            "placed": np.zeros((self.n_gangs + 1, dt), dtype=np.float32),
            "total": np.zeros((self.n_gangs + 1,), dtype=np.float32),
        }


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


class GangTerm(NamedTuple):
    """The gang term's operands for one choose launch: every tensor on the
    launch's device, float32 unless named otherwise.  ``gang_id`` [B] int32
    is the block's gang ids (None in what :func:`gang_round_operands`
    returns: ``ops/assign._choose`` fills it per block); ``dom_col`` [Lv, N]
    int32 node n's column in the level-blocked domain axis (level l's D_l+1
    columns start at Σ_{k<l} (D_k+1)); ``level_dist`` [Lv]; ``placed``
    [G+1, Dt] the placed-member count per (gang, domain) and ``total``
    [G+1] per gang; ``rem`` [G+1, 2] each gang's remaining cpu/memory
    demand; ``dom_free`` [Dt, 2] each domain's free cpu/memory; ``herd``
    [G+1, Dt] 1 + 4·tie-break; ``weight`` the profile's
    gang_locality_weight (a host float)."""

    gang_id: torch.Tensor | None
    dom_col: torch.Tensor
    level_dist: torch.Tensor
    placed: torch.Tensor
    total: torch.Tensor
    rem: torch.Tensor
    dom_free: torch.Tensor
    herd: torch.Tensor
    weight: float


def domain_columns(meta: dict) -> list[tuple[int, int]]:
    """(first column, width D_l+1) of each level's block of the domain axis."""
    cols, off = [], 0
    for l_idx in range(meta["level_dist"].shape[0]):
        width = meta[f"gang_tb_{l_idx}"].shape[1]
        cols.append((off, width))
        off += width
    return cols


def gang_cycle_operands(meta: dict) -> dict:
    """Per cycle, on the meta's device: ``dom_col`` [Lv, N] int32 (each
    node's level-l domain id shifted to its level's block) and ``herd``
    [G+1, Dt] = 1 + 4·tb per level, the reference's float32 ops."""
    blocks = domain_columns(meta)
    dom_col = torch.stack([meta[f"dom_id_{l}"] + off for l, (off, _) in enumerate(blocks)])
    herd = torch.cat([1.0 + HERD_SCALE * meta[f"gang_tb_{l}"] for l in range(len(blocks))], dim=1)
    return {"dom_col": dom_col.to(torch.int32).contiguous(), "herd": herd.contiguous()}


def gang_state_zeros(meta: dict, n_gangs: int, device) -> dict:
    """Round-start state on ``device``: ``placed`` [G+1, Dt] and ``total``
    [G+1] float32 zeros."""
    dt = sum(w for _, w in domain_columns(meta))
    return {
        "placed": torch.zeros((n_gangs + 1, dt), dtype=torch.float32, device=device),
        "total": torch.zeros((n_gangs + 1,), dtype=torch.float32, device=device),
    }


def gang_round_operands(cyc: dict, state: dict, meta: dict, avail, pod_gang_id, pod_req, active, weight) -> GangTerm:
    """The round's small inputs of the term (``gang_id`` left None): the
    per-gang remaining demand of the still-active pods, added in pod order
    (:func:`_add_rows`), and each domain's free capacity,
    ``onehot_l @ free`` per level as the reference computes it.  ``cyc``:
    :func:`gang_cycle_operands`; ``state``: the placed counts; ``avail``
    [N, R] int32, ``pod_req`` [P, R] int32, ``active`` [P] bool,
    ``pod_gang_id`` [P] int32: the round's live rows."""
    f32 = torch.float32
    device = avail.device
    if device.type == "cuda":
        # The matmuls are exact only in full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
    g1 = state["total"].shape[0]
    # Remaining demand of each gang's still-active members (cpu, mem), in
    # pod order: float32 on purpose, a scoring heuristic.
    live_req = torch.where(active[:, None], pod_req[:, :2], 0).to(f32)  # [P, 2]
    rem = _add_rows(torch.zeros((g1, 2), dtype=f32, device=device), pod_gang_id.long(), live_req)
    free = torch.clamp(avail[:, :2], min=0).to(f32)  # [N, 2]
    dom_free = torch.cat([meta[f"dom_onehot_{l}"] @ free for l in range(meta["level_dist"].shape[0])])
    return GangTerm(None, cyc["dom_col"], meta["level_dist"], state["placed"], state["total"], rem,
                    dom_free, cyc["herd"], float(np.float32(weight)))


# Calls of gang_topology_term on CUDA tensors: a topology cycle on the card
# never builds the dense term, so a run can show that this stays 0.
DENSE_TERMS_CUDA = 0


def gang_topology_term(op: GangTerm) -> torch.Tensor:
    """The dense [G+1, N] float32 term from the per-(gang, domain) state,
    in the reference's op order (``tpu_scheduler/topology/locality.py``
    :196-213): per level, ``t − (16·d_l)·(total − same)`` then
    ``t + d_l·(fits·herd)``; then ``w·t``, row 0 pinned to +0.0.  ``same``
    is ``placed`` gathered at each node's domain: integer counts, equal to
    the reference's ``placed @ onehot.T`` in any order.  The plain version
    of the kernels' term: the CPU path and the checks use it; a cycle on
    the card never does (:data:`DENSE_TERMS_CUDA` counts the calls there)."""
    global DENSE_TERMS_CUDA
    if op.placed.device.type == "cuda":
        DENSE_TERMS_CUDA += 1
    f32 = torch.float32
    g1, n = op.placed.shape[0], op.dom_col.shape[1]
    fits = (op.rem[:, None, :] <= op.dom_free[None, :, :]).all(-1).to(f32)  # [G+1, Dt]
    fit_herd = fits * op.herd
    # The [G+1, N] intermediates are updated in place (one buffer per term,
    # the same roundings as the reference's out-of-place tree).
    t = torch.zeros((g1, n), dtype=f32, device=op.placed.device)
    for l_idx in range(op.level_dist.shape[0]):
        d_l = op.level_dist[l_idx]
        cols = op.dom_col[l_idx].long()
        x = op.placed[:, cols]  # same: the gang's members placed in the node's level-l domain
        torch.sub(op.total[:, None], x, out=x)
        t.sub_(x.mul_(ANCHOR_SCALE * d_l))
        x = fit_herd[:, cols]
        t.add_(x.mul_(d_l))
        del x
    # Row 0 (no gang) pinned to +0.0: score-neutral for gangless pods.
    t.mul_(torch.as_tensor(op.weight, dtype=f32, device=t.device))
    t[0] = 0.0
    return t


def gang_state_update(state: dict, dom_col, accepted, choice, pod_gang_id) -> dict:
    """Fold a round's accepted placements into ``state`` (``placed`` per
    (gang, domain) at every level, ``total`` per gang), IN PLACE (the state
    is per cycle and never a cached upload), and return it.  ``choice``
    may carry the non-claimant sentinel N: such a pod is never accepted,
    so it adds 0.0 at a real column; gangless pods add into row 0, which
    is never read back.  Counts are integers, exact in any order, so the
    adds may run as atomics (``index_add_`` on CUDA)."""
    n = dom_col.shape[1]
    acc = accepted.to(torch.float32)
    node = torch.where(choice < n, choice, 0).long()
    gid = pod_gang_id.long()
    lv, dt = dom_col.shape[0], state["placed"].shape[1]
    flat = (gid[None, :] * dt + dom_col[:, node].long()).reshape(-1)  # [Lv * P] into placed's rows
    state["placed"].view(-1).index_add_(0, flat, acc.repeat(lv))
    state["total"].index_add_(0, gid, acc)
    return state


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
