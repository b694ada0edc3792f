"""Multi-device scheduling cycle — the port of
``tpu_scheduler/parallel/sharded.py`` (``_build_shard_map``,
``sharded_assign_cycle``, ``ShardedBackend``): the auction distributed over
a (dp, tp) mesh, pods sharded over ``dp``, nodes over ``tp``.

It is a single-controller program, as the JAX package's single-process path
is: each round runs the same local step for every (dp, tp) shard on that
shard's device, and the JAX collectives become explicit in-process ops
(``.to(device)``, ``torch.cat``, a sum).  The algorithm is the JAX
package's sharded one, not ``ops/assign.py``'s: one fixed-shape choose per
shard per round over its whole [p_local, n_local] slice, with no size chain
and no compaction.  Results equal the single-device backends bit for bit:

  choose   — each shard runs the choose over its pod rows and node columns
             (kernel #2b: ``ops/choose.choose_block`` /
             ``choose_block_constrained`` with ``node_offset`` = the
             column's global node base, so the jitter hash reads global node
             indices); the per-pod best is merged across ``tp`` on
             (score desc, node index asc), which equals the global
             first-max argmax.
  accept   — the claims of every dp row are gathered in global priority
             order (pods are permuted before the dp padding, so the row
             concatenation *is* rank order); each shard runs the segmented
             prefix acceptance (``ops/assign.accept_claims``) for the nodes
             of its column; the per-pod accepted flags are summed over
             ``tp`` (node columns are disjoint).
  commit   — each shard subtracts the accepted claims on its own nodes.

Constrained cycles keep the domain state, meta and pod bitmaps REPLICATED:
once per distinct device of the mesh.  The round masks are built there and
sliced to each shard's columns; the within-round filter and the state
commit (``ops/constraints.py``) run there over the gathered global claims.

State ownership (what a mesh that repeats a device needs): a tensor that
only ever gets read — pod rows, node columns, replicated meta and bitmaps —
is uploaded once per device and shared.  Each shard owns its ``avail``,
``active`` and ``assigned``, and every update is out of place, so the dp
copies of a column's capacity never alias even when ``.to(device)`` is a
no-op.

There is no proving, strike or plain-path retry (the JAX backend's guard at
``sharded.py:552-585`` is not mirrored): on CUDA tensors the kernels run or
raise.  Multi-host meshes (``parallel/multihost.py``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backends.base import SchedulingBackend
from ..backends.cuda import _is_device_failure
from ..errors import BackendUnavailable
from ..models.profiles import SchedulingProfile
from ..ops.assign import accept_claims, commit_claims
from ..ops.choose import CONSTRAINT_POD_KEYS, choose_block, choose_block_constrained
from ..ops.constraints import augment_round_state, constraint_commit, constraint_filter, round_blocked_masks
from ..ops.pack import STALL_ROUNDS, PackedCluster, round_up
from .mesh import Mesh, make_mesh

__all__ = ["ShardedBackend", "sharded_assign_cycle", "constraint_operands", "POD_KEYS", "CONSTRAINT_KEYS"]

# Pod-side keys a shard reads, in choose_block's argument order (pod_valid
# seeds the active flags).
POD_KEYS = (
    "pod_req",
    "pod_sel",
    "pod_sel_count",
    "pod_ntol",
    "pod_aff",
    "pod_has_aff",
    "pod_pref_w",
    "pod_ntol_soft",
    "pod_valid",
)
# Node-side keys in choose_block's argument order after ``avail``.
_NODE_KEYS = ("node_alloc", "node_valid", "node_labels", "node_taints", "node_aff", "node_pref", "node_taints_soft")
_NODE_PAD_KEYS = _NODE_KEYS + ("node_avail",)

# Constraint operands in the JAX package's order: pod bitmaps (permuted and
# dp-padded with the pods), meta, initial state.
CONSTRAINT_KEYS = (
    "pod_aa_carries",
    "pod_aa_matched",
    "pod_pa_declares",
    "pod_pa_matched",
    "pod_sp_declares",
    "pod_sp_matched",
    "pod_sps_declares",
    "pod_sps_matched",
    "pod_ppa_w",
    "pod_ppa_matched",
    "node_dom_c",
    "term_uses_dom",
    "pa_uses_dom",
    "ppa_uses_dom",
    "sp_uses_dom",
    "sp_skew",
    "sps_uses_dom",
    "sp_dom_sel",
    "aa_dom_m",
    "aa_dom_c",
    "aa_node_m",
    "aa_node_c",
    "pa_dom_m",
    "pa_node_m",
    "ppa_dom_cnt",
    "ppa_node_cnt",
    "sp_counts",
    "sps_counts",
)
_N_PODKEYS = 10
_N_METAKEYS = 8


def constraint_operands(cons, n_pad_from: int, n_pad_to: int) -> dict:
    """NumPy constraint operands keyed by CONSTRAINT_KEYS, with the node axis
    padded from the pack's padding to the mesh's tp multiple.  Pod bitmaps
    are in PACK order: the cycle permutes and pads them with the pods."""
    extra = n_pad_to - n_pad_from
    ops = dict(cons.pod_arrays())
    meta = cons.meta_arrays()
    state = cons.state_arrays()
    ops["node_dom_c"] = np.pad(meta["node_dom_c"], ((0, extra), (0, 0)))
    for k in ("term_uses_dom", "pa_uses_dom", "ppa_uses_dom", "sp_uses_dom", "sp_skew", "sps_uses_dom", "sp_dom_sel"):
        ops[k] = meta[k]
    for k in ("aa_dom_m", "aa_dom_c", "pa_dom_m", "ppa_dom_cnt", "sp_counts", "sps_counts"):
        ops[k] = state[k]
    for k in ("aa_node_m", "aa_node_c", "pa_node_m", "ppa_node_cnt"):
        ops[k] = np.pad(state[k], ((0, 0), (0, extra)))
    return ops


def _put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


@dataclass
class _Replica:
    """The replicated constraint engine on one device: global pod bitmaps,
    meta and the round-carried domain state."""

    cpods: dict
    meta: dict
    state: dict
    ranks: torch.Tensor


@dataclass
class _Shard:
    """One (dp, tp) shard: read-only pod rows and node columns (shared by
    the shards of a device), and the state it owns."""

    i: int
    j: int
    device: torch.device
    lo: int  # first global pod row
    base: int  # first global node column
    pods: dict
    nodes: dict
    ranks: torch.Tensor
    avail: torch.Tensor
    active: torch.Tensor
    assigned: torch.Tensor


def sharded_assign_cycle(
    mesh: Mesh, arrays: dict, weights, max_rounds: int = 32, constraints: dict | None = None,
    soft_spread: bool = False, soft_pa: bool = False, hard_pa: bool = True,
):
    """Run one cycle over the mesh.  ``arrays``: the PackedCluster device
    arrays (NumPy) with N pre-padded to a tp multiple (pods pad here, after
    the priority permutation); ``constraints``: the
    :func:`constraint_operands` dict of a constrained cycle.  Returns
    (assigned [P] int32 on the CPU, rounds, avail [dp, N_padded, R] int32 on
    the CPU — every dp row's copy of the remaining capacity, which agree)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    n_tot = arrays["node_avail"].shape[0]
    if n_tot % tp:
        raise ValueError(f"sharded_assign_cycle: {n_tot} nodes do not split into tp={tp} columns")
    p_out = arrays["pod_req"].shape[0]
    # Permute BEFORE dp padding: ranks feed the jitter hash and must equal
    # the unpadded single-device order's.
    perm = np.argsort(-arrays["pod_prio"], kind="stable")
    extra = (-p_out) % dp

    def permuted(v: np.ndarray) -> np.ndarray:
        v = v[perm]
        return np.pad(v, ((0, extra),) + ((0, 0),) * (v.ndim - 1)) if extra else v

    pods = {k: permuted(arrays[k]) for k in POD_KEYS}
    p_tot = p_out + extra
    p_local, n_local = p_tot // dp, n_tot // tp
    constrained = constraints is not None
    weights = np.asarray(weights, dtype=np.float32)

    # Read-only uploads, once per (device, row) and (device, column).
    row_cache: dict = {}
    col_cache: dict = {}
    shards = []
    for i in range(dp):
        for j in range(tp):
            d = mesh.devices[i][j]
            lo, base = i * p_local, j * n_local
            if (d, i) not in row_cache:
                row_cache[d, i] = {k: _put(v[lo : lo + p_local], d) for k, v in pods.items()}
            if (d, j) not in col_cache:
                col_cache[d, j] = {k: _put(arrays[k][base : base + n_local], d) for k in _NODE_PAD_KEYS}
            rows, cols = row_cache[d, i], col_cache[d, j]
            shards.append(_Shard(
                i, j, d, lo, base, rows, cols,
                ranks=torch.arange(lo, lo + p_local, dtype=torch.int32, device=d),
                avail=cols["node_avail"].clone(),
                active=rows["pod_valid"].clone(),
                assigned=torch.full((p_local,), -1, dtype=torch.int32, device=d),
            ))
    grid = [shards[i * tp : (i + 1) * tp] for i in range(dp)]

    replicas: dict = {}
    if constrained:
        cpods_h = {k: permuted(constraints[k]) for k in CONSTRAINT_KEYS[:_N_PODKEYS]}
        for d in mesh.distinct_devices():
            meta = {k: _put(constraints[k], d) for k in CONSTRAINT_KEYS[_N_PODKEYS : _N_PODKEYS + _N_METAKEYS]}
            state = {k: _put(constraints[k], d) for k in CONSTRAINT_KEYS[_N_PODKEYS + _N_METAKEYS :]}
            replicas[d] = _Replica(
                cpods={k: _put(v, d) for k, v in cpods_h.items()}, meta=meta,
                state=augment_round_state(state, meta), ranks=torch.arange(p_tot, dtype=torch.int32, device=d),
            )

    home = shards[0].device
    # Per-round values are lists indexed like ``shards`` (k = i * tp + j).
    first = {d: next(k for k, s in enumerate(shards) if s.device == d) for d in replicas}
    go = bool(pods["pod_valid"].any())
    rounds = stall = 0
    while rounds < max_rounds and go and not (constrained and stall >= STALL_ROUNDS):
        # 1. choose: each shard's slice, then the (score desc, index asc)
        # merge across its row's tp shards.
        masks = {d: round_blocked_masks(r.state, r.meta, soft_spread, soft_pa, hard_pa) for d, r in replicas.items()}
        best, local_choice = [], []
        for s in shards:
            pod_args = tuple(s.pods[k] for k in POD_KEYS[:-1]) + (s.active, s.ranks)
            node_args = (s.avail,) + tuple(s.nodes[k] for k in _NODE_KEYS)
            if constrained:
                lm = {
                    k: v if k == "pa_inactive" else v[:, s.base : s.base + n_local].contiguous()
                    for k, v in masks[s.device].items()
                }
                cons_pod = {k: replicas[s.device].cpods[k][s.lo : s.lo + p_local] for k in CONSTRAINT_POD_KEYS}
                idx, _, b = choose_block_constrained(
                    *pod_args, *node_args, cons_pod, lm, weights, rounds, node_offset=s.base
                )
            else:
                idx, _, b = choose_block(*pod_args, *node_args, weights, rounds, node_offset=s.base)
            best.append(b)
            local_choice.append(idx + s.base)
        choice, has, cand, claim_node, claim_req = [], [], [], [], []
        for s in shards:
            row = range(s.i * tp, (s.i + 1) * tp)
            b, c = best[row[0]].to(s.device), local_choice[row[0]].to(s.device)
            for k in row[1:]:
                b_k, c_k = best[k].to(s.device), local_choice[k].to(s.device)
                take = (b_k > b) | ((b_k == b) & (c_k < c))
                b = torch.where(take, b_k, b)
                c = torch.where(take, c_k, c)
            h = torch.isfinite(b)
            wants = s.active & h
            choice.append(c)
            has.append(h)
            cand.append(wants)
            claim_node.append(torch.where(wants, c, n_tot))  # n_tot: no claim
            claim_req.append(torch.where(wants[:, None], s.pods["pod_req"], 0))

        # 2. accept: every shard gathers its column's claims over dp (global
        # priority order) and accepts on its own nodes; flags sum over tp.
        g_choice, in_range, ch_local, claim, acc_range = [], [], [], [], []
        for s in shards:
            column = range(s.j, dp * tp, tp)
            g = torch.cat([claim_node[k].to(s.device) for k in column])
            g_req = torch.cat([claim_req[k].to(s.device) for k in column])
            mine = (g >= s.base) & (g < s.base + n_local)
            g_choice.append(g)
            in_range.append(mine)
            ch_local.append(torch.where(mine, g - s.base, n_local).to(torch.int64))
            claim.append(torch.where(mine[:, None], g_req, 0).to(torch.int64))
            acc_range.append(accept_claims(ch_local[-1], claim[-1], s.avail))
        accepted = [
            sum(acc_range[k].to(s.device).to(torch.int32) for k in range(s.i * tp, (s.i + 1) * tp)) > 0
            for s in shards
        ]

        # 3. constraints: filter and state commit, once per device over the
        # global claims (identical on every shard of the device).
        pa_progress = {}
        if constrained:
            filtered = {}
            for d, rep in replicas.items():
                k0 = first[d]
                gi = torch.clamp(g_choice[k0], max=n_tot - 1)  # the non-claimant sentinel
                filtered[d] = constraint_filter(accepted[k0], gi, rep.ranks, rep.cpods, rep.state, rep.meta, hard_pa)
                rep.state = constraint_commit(
                    filtered[d], gi, rep.cpods, rep.state, rep.meta, soft_spread, soft_pa, hard_pa
                )
                if hard_pa:
                    new_match = (rep.cpods["pod_pa_matched"] * filtered[d][:, None].to(torch.float32)).sum(0) > 0
                    pa_progress[d] = new_match.any()
            accepted = [filtered[s.device] for s in shards]

        # 4. capacity commit from the (filtered) accepted set: each shard
        # subtracts on its own nodes, out of place.
        for k, s in enumerate(shards):
            s.avail = commit_claims(s.avail, ch_local[k], claim[k], accepted[k] & in_range[k])
            acc_local = accepted[k][s.lo : s.lo + p_local]
            s.assigned = torch.where(acc_local, choice[k], s.assigned)
            new_active = cand[k] & ~acc_local
            if constrained and hard_pa:
                # Positive-affinity declarers blocked everywhere stay active
                # while any term gained a match this round (ops/assign.py).
                declares = replicas[s.device].cpods["pod_pa_declares"][s.lo : s.lo + p_local]
                pa_hope = (declares.sum(1) > 0) & pa_progress[s.device]
                new_active = new_active | (s.active & ~has[k] & pa_hope)
            s.active = new_active

        # One host read per round: the active count over dp, and whether
        # anybody was accepted (the stall rule).
        counts = [row[0].active.sum().to(home) for row in grid] + [accepted[0].sum().to(home)]
        *n_active, n_accepted = torch.stack(counts).tolist()
        go = sum(n_active) > 0
        rounds += 1
        if constrained:
            stall = 0 if n_accepted else stall + 1

    assigned_p = torch.cat([row[0].assigned.cpu() for row in grid])
    assigned = torch.full((p_out,), -1, dtype=torch.int32)
    assigned[torch.from_numpy(perm)] = assigned_p[:p_out]
    avail = torch.stack([torch.cat([s.avail.cpu() for s in row]) for row in grid])
    return assigned, rounds, avail


class ShardedBackend(SchedulingBackend):
    """SchedulingBackend over a device mesh — the dp × tp cycle, constrained
    cycles included (replicated domain state).  Runs on every visible CUDA
    device unless given a mesh (``make_mesh([torch.device("cpu")] * 8, tp)``
    for the tests, ``make_mesh([torch.device("cuda:0")] * k, tp)`` for
    virtual shards on one card).  Topology cycles are not ported."""

    name = "cuda-sharded"
    supports_topology = False
    # One mesh program at a time: concurrent shard solves would interleave
    # the shards' launches and buy nothing on a shared set of devices.
    supports_concurrent_shards = False

    def __init__(self, mesh: Mesh | None = None, tp: int | None = None):
        self.mesh = mesh if mesh is not None else make_mesh(tp=tp)
        for d in self.mesh.distinct_devices():
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"cuda-sharded backend: unsupported device {d}")
            if d.type == "cuda" and not torch.cuda.is_available():
                raise BackendUnavailable("cuda-sharded backend: torch.cuda.is_available() is False")

    def assign(self, packed: PackedCluster, profile: SchedulingProfile):
        if packed.topology is not None:
            raise NotImplementedError("cuda-sharded backend: topology cycles are not ported yet")
        tp = self.mesh.shape["tp"]
        a = dict(packed.device_arrays())
        # Node padding to the tp multiple happens here; pod padding to the
        # dp multiple inside the cycle, after the priority permutation.
        n_pad = round_up(packed.padded_nodes, tp)
        for k in _NODE_PAD_KEYS:
            a[k] = np.pad(a[k], ((0, n_pad - packed.padded_nodes),) + ((0, 0),) * (a[k].ndim - 1))
        cons = packed.constraints
        c = constraint_operands(cons, packed.padded_nodes, n_pad) if cons is not None else None
        try:
            assigned, rounds, _avail = sharded_assign_cycle(
                self.mesh, a, profile.weights(), profile.max_rounds, constraints=c,
                soft_spread=cons is not None and cons.n_spread_soft > 0,
                soft_pa=cons is not None and cons.n_ppa_terms > 0,
                hard_pa=cons is not None and cons.n_pa_terms > 0,
            )
        except RuntimeError as e:
            if any(d.type == "cuda" for d in self.mesh.distinct_devices()) and _is_device_failure(e):
                raise BackendUnavailable(f"cuda-sharded backend runtime failure: {e}") from e
            raise
        return assigned.numpy(), rounds
