"""Conflict-free batched assignment — the scheduling cycle in eager torch.

Port of ``tpu_scheduler/ops/assign.py::assign_cycle``: unconstrained,
constrained and topology (gang-locality) cycles, alone or together.  All
pending pods are assigned in a few auction rounds; each round:

  1. choose:  blockwise over the active pods — feasibility + score vs the
     current remaining capacity, masked argmax → choice (ops/choose.py; on
     the card the hand-written kernels).  A constrained cycle first builds
     the round's blocked/penalty node masks from the domain state
     (ops/constraints.round_blocked_masks) and runs the constrained choose.
     A topology cycle first builds the round's small term inputs from the
     per-(gang, domain) placement counts (the gangs' remaining demand and
     the domains' free capacity, topology/locality.gang_round_operands),
     and the choose computes each pod's gang term from them and adds it as
     its last score term; no round builds a [G+1, N] term on the card.
  2. accept:  pods sit in (priority desc, FIFO) order; a stable sort by
     chosen node groups each node's claimants in priority order, and a
     segmented prefix sum of their requests — exact int64 clamped to
     INT32_MAX, which equals the JAX package's saturating int32 scan —
     accepts the longest prefix that fits.  A constrained cycle then drops
     within-round conflicts (constraints.constraint_filter) and folds the
     survivors into the domain state (constraints.constraint_commit).  A
     topology cycle folds the accepted gang members into its per-domain
     placement counts (locality.gang_state_update).
  3. commit:  accepted requests scatter-subtract from remaining capacity;
     pods with no feasible node drop out (capacity only shrinks in a cycle
     — except that a positive-affinity match placed this round can open
     nodes, so blocked declarers stay while any such term progressed).
  4. compact: a cumsum partition packs the still-active pods to the front,
     keeping their relative (priority) order, so the next round's choose
     only touches ceil(n_active / block) blocks.

A constrained cycle also stops after STALL_ROUNDS consecutive rounds that
accept nobody: the filter can defer the same pods forever.

The JAX package runs the rounds as ``lax.while_loop``s inside one jit
program; here the same round body is a Python loop with one host read of
``n_active`` per round.  The static size chain is kept: the pod arrays step
down p, p/4, p/16, … (block-aligned, floored at 256) once the active count
fits the next size, with the same stage handoff and terminal ``done`` latch,
so every round sees the same rows in the same order and the results are bit
identical.  The JAX package's two drivers ("monolithic" and "epochs") are
pinned bit-identical by its own tests; both map to this one driver.

Tensors travel as dicts keyed by the PackedCluster ``device_arrays`` names.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..topology.locality import gang_cycle_operands, gang_round_operands, gang_state_update
from .choose import (
    CONSTRAINT_POD_KEYS,
    NODE_WORD_KEYS,
    POD_BITMAP_KEYS,
    check_domain_columns,
    check_gang_ids,
    check_pod_bitmaps,
    choose_block,
    choose_block_constrained,
    pack_node_words,
)
from .constraints import augment_round_state, constraint_commit, constraint_filter, round_blocked_masks
from .pack import INT32_MAX, STALL_ROUNDS

__all__ = ["accept_claims", "assign_cycle", "commit_claims", "split_device_arrays"]

# Pod-side keys the choose step reads, in choose_block's argument order.
_CHOOSE_KEYS = (
    "pod_req",
    "pod_sel",
    "pod_sel_count",
    "pod_ntol",
    "pod_aff",
    "pod_has_aff",
    "pod_pref_w",
    "pod_ntol_soft",
    "active",
    "ranks",
)
_NODE_KEYS = (
    "node_alloc",
    "node_valid",
    "node_labels",
    "node_taints",
    "node_aff",
    "node_pref",
    "node_taints_soft",
)

# Shrink-chain floor: below this the accept phase is negligible.
_MIN_EPOCH_SIZE = 256


def split_device_arrays(arrays: dict) -> tuple[dict, dict]:
    """Split a device-arrays dict into (node_side, pod_side)."""
    nodes = {k: v for k, v in arrays.items() if k.startswith("node_")}
    pods = {k: v for k, v in arrays.items() if k.startswith("pod_")}
    return nodes, pods


def _chain_size(target: int, block: int) -> int:
    """One shrinking-chain size: a block multiple while above ``block``,
    floored at _MIN_EPOCH_SIZE (the JAX package's rule)."""
    if target > block:
        target = ((target + block - 1) // block) * block
    return max(_MIN_EPOCH_SIZE, target)


def _size_chain(p: int, block: int) -> list[int]:
    """p, p/4, p/16, …; a stage is appended only when it at least halves
    the previous one."""
    sizes = [p]
    while True:
        nxt = _chain_size(sizes[-1] // 4, block)
        if nxt > sizes[-1] // 2:
            return sizes
        sizes.append(nxt)


def _compact(ps: dict) -> dict:
    """Stable active-first packing as a cumsum partition: each row's
    destination is its rank within its class (actives first)."""
    active = ps["active"]
    n_act = torch.cumsum(active.to(torch.int64), 0)
    n_inact = torch.cumsum((~active).to(torch.int64), 0)
    dest = torch.where(active, n_act - 1, n_act[-1] + n_inact - 1)
    src = torch.empty_like(dest)
    src[dest] = torch.arange(dest.shape[0], device=dest.device)
    return {k: v.index_select(0, src) for k, v in ps.items()}


def _prepare_pods(pods: dict, block: int) -> tuple[torch.Tensor, dict]:
    """Permute to priority order, pad to a block multiple, init the auction
    bookkeeping, compact actives to the front.  The permutation comes BEFORE
    the padding: rank positions feed the jitter hash and must equal the
    unpadded order's (padding rows sit at ranks ≥ p_out, inactive)."""
    p = pods["pod_req"].shape[0]
    perm = torch.argsort(-pods["pod_prio"], stable=True)
    ps = {k: v[perm] for k, v in pods.items() if k != "pod_prio"}
    if block < p and p % block != 0:
        extra = block - p % block
        ps = {k: torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))]) for k, v in ps.items()}
        p += extra
    device = ps["pod_req"].device
    ps["ranks"] = torch.arange(p, dtype=torch.int32, device=device)
    ps["assigned"] = torch.full((p,), -1, dtype=torch.int32, device=device)
    ps["acc_round"] = torch.full((p,), -1, dtype=torch.int32, device=device)
    ps["active"] = ps.pop("pod_valid")
    return perm, _compact(ps)


@dataclass
class _Constraints:
    """A constrained cycle's engine state: meta and the round-carried
    domain state (both node/domain-side — never pod-indexed, never sliced),
    the feature flags, and the consecutive zero-acceptance round count."""

    meta: dict
    state: dict
    soft_spread: bool
    soft_pa: bool
    hard_pa: bool
    stall: int = 0


def _choose(
    avail, ps: dict, n_active: int, nodes: dict, words: tuple, weights, block: int, salt: int, masks=None,
    gang=None,
):
    """Per-pod best feasible node vs current capacity, blockwise over the
    compacted pods: only the first ceil(n_active / block) blocks run.
    ``words``: the cycle's node bitmap words (choose.pack_node_words);
    ``masks`` (a constrained round's node masks) selects the constrained
    choose; ``gang`` (a topology round's locality.GangTerm, its gang ids
    None) adds each pod's gang term, with the block's gang ids."""
    p = ps["pod_req"].shape[0]
    node_args = (avail,) + tuple(nodes[k] for k in _NODE_KEYS)

    def run(lo, hi):
        pod_args = (ps[k][lo:hi] for k in _CHOOSE_KEYS)
        topo = None if gang is None else gang._replace(gang_id=ps["pod_gang_id"][lo:hi])
        if masks is None:
            return choose_block(*pod_args, *node_args, weights, salt, node_words=words, topo=topo)[:2]
        cons_pod = {k: ps[k][lo:hi] for k in CONSTRAINT_POD_KEYS}
        return choose_block_constrained(
            *pod_args, *node_args, cons_pod, masks, weights, salt, node_words=words, topo=topo
        )[:2]

    if block >= p:
        return run(0, p)
    choice = torch.zeros((p,), dtype=torch.int32, device=avail.device)
    has = torch.zeros((p,), dtype=torch.bool, device=avail.device)
    for lo in range(0, (n_active + block - 1) // block * block, block):
        choice[lo : lo + block], has[lo : lo + block] = run(lo, lo + block)
    return choice, has


def accept_claims(ch: torch.Tensor, claim: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """The accept step: [P] bool, the claims that fit.  ``ch`` [P] int64 is
    each pod's claimed node row in priority order (``avail.shape[0]`` for a
    non-claimant), ``claim`` [P, R] int64 its request (0 for a
    non-claimant).  A stable sort by node groups each node's claimants in
    priority order; a pod is accepted when the exact int64 prefix of its
    node's claims up to and including its own, clamped to INT32_MAX (the JAX
    package's saturating int32 scan), fits the node's remaining capacity."""
    p = ch.shape[0]
    n = avail.shape[0]
    device = ch.device
    order = torch.argsort(ch, stable=True)
    ch_s = ch[order]
    claim_s = claim[order]
    # Scan each resource column along its contiguous axis: a dim-0 scan of
    # the narrow [P, R] matrix runs as a slow outer-dimension scan on CUDA.
    cum = torch.cumsum(claim_s.T.contiguous(), 1).T
    is_start = torch.ones((p,), dtype=torch.bool, device=device)
    is_start[1:] = ch_s[1:] != ch_s[:-1]
    start_idx = torch.cummax(torch.where(is_start, torch.arange(p, device=device), 0), 0).values
    within = torch.clamp(cum - (cum - claim_s)[start_idx], max=INT32_MAX)
    avail_ext = torch.cat([avail, avail.new_zeros((1, avail.shape[1]))]).to(torch.int64)
    acc_s = (within <= avail_ext[ch_s]).all(-1) & (ch_s < n)
    accepted = torch.empty_like(acc_s)
    accepted[order] = acc_s
    return accepted


def commit_claims(avail: torch.Tensor, ch: torch.Tensor, claim: torch.Tensor, accepted: torch.Tensor) -> torch.Tensor:
    """The commit step: the accepted claims scatter-subtracted from ``avail``
    [n, R] int32 (``ch``/``claim`` as for :func:`accept_claims`).  Returns a
    new tensor; ``avail`` is left as it was."""
    n = avail.shape[0]
    dec = torch.zeros((n + 1, avail.shape[1]), dtype=torch.int64, device=avail.device)
    dec.index_add_(0, ch, torch.where(accepted[:, None], claim, 0))
    return (avail.to(torch.int64) - dec[:n]).to(torch.int32)


def _round(
    avail, ps: dict, n_active: int, rounds: int, nodes: dict, words: tuple, weights, block: int,
    cons: _Constraints | None, topo: dict | None,
):
    """One auction round: choose, accept, (constraint filter and commit),
    (gang placement counts), commit capacity, compact.  Returns (avail, ps,
    n_active) — n_active read to the host; ``cons`` and the ``topo`` state
    (``{"meta", "cycle", "state"}``: the meta, locality.gang_cycle_operands
    and the per-domain counts) are updated in place."""
    n = avail.shape[0]
    masks = None
    if cons is not None:
        masks = round_blocked_masks(cons.state, cons.meta, cons.soft_spread, cons.soft_pa, cons.hard_pa)
    gang = None
    if topo is not None:
        gang = gang_round_operands(
            topo["cycle"], topo["state"], topo["meta"], avail, ps["pod_gang_id"], ps["pod_req"], ps["active"],
            weights[6],
        )
    choice, has = _choose(avail, ps, n_active, nodes, words, weights, block, rounds, masks, gang)
    del gang
    cand = ps["active"] & has
    ch = torch.where(cand, choice.to(torch.int64), n)  # sentinel segment n for non-claimants
    claim = torch.where(cand[:, None], ps["pod_req"], 0).to(torch.int64)
    accepted = accept_claims(ch, claim, avail)

    if cons is not None:
        # Within-round conflicts are deferred (they stay active); the
        # survivors fold into the domain state.
        accepted = constraint_filter(accepted, choice, ps["ranks"], ps, cons.state, cons.meta, cons.hard_pa)
        cons.state = constraint_commit(
            accepted, choice, ps, cons.state, cons.meta, cons.soft_spread, cons.soft_pa, cons.hard_pa
        )

    ps["assigned"] = torch.where(accepted, choice, ps["assigned"])
    ps["acc_round"] = torch.where(accepted, rounds, ps["acc_round"])
    avail = commit_claims(avail, ch, claim, accepted)
    active = cand & ~accepted
    if cons is not None and cons.hard_pa:
        # A pod placed this round can activate a declarer's positive-affinity
        # term and open nodes for it: blocked-everywhere declarers stay
        # active while any term gained a match this round.
        new_match = (ps["pod_pa_matched"] * accepted[:, None].to(torch.float32)).sum(dim=0) > 0
        pa_hope = (ps["pod_pa_declares"].sum(dim=1) > 0) & new_match.any()
        active = active | (ps["active"] & ~has & pa_hope)
    if topo is not None:
        # Non-claimants carry the sentinel n and add 0.0; gangless pods add
        # into row 0, never read back.
        gang_state_update(topo["state"], topo["cycle"]["dom_col"], accepted, ch, ps["pod_gang_id"])
    ps["active"] = active
    ps = _compact(ps)
    # One host read per round: the active count, and the accepted count
    # for the stall rule.
    n_active, n_accepted = torch.stack([ps["active"].sum(), accepted.sum()]).tolist()
    if cons is not None:
        cons.stall = 0 if n_accepted else cons.stall + 1
    return avail, ps, n_active


def _stalled(cons: _Constraints | None) -> bool:
    return cons is not None and cons.stall >= STALL_ROUNDS


def assign_cycle(
    nodes: dict,
    pods: dict,
    weights,
    max_rounds: int = 32,
    block: int = 4096,
    cmeta: dict | None = None,
    cstate: dict | None = None,
    soft_spread: bool = False,
    soft_pa: bool = False,
    hard_pa: bool = True,
    tmeta: dict | None = None,
    tstate: dict | None = None,
):
    """Assign all pending pods to nodes in one cycle.

    ``nodes``/``pods``: the device-arrays dicts split by prefix
    (:func:`split_device_arrays`), torch tensors on one device; ``weights``:
    the profile's float32 weight vector (host).  ``cmeta``/``cstate``
    (ConstraintSet meta_arrays/state_arrays as tensors) switch on the
    constraint path; ``pods`` must then also carry the ConstraintSet
    pod_arrays, and the three flags say which optional features the cycle
    has (the JAX package's assign_cycle contract).  ``tmeta``/``tstate``
    (TopologySet meta_arrays as tensors, and the per-(gang, domain) zeros
    ``{"placed": [G+1, Dt], "total": [G+1]}`` float32,
    convert.topology_to_device) switch on the gang term; ``pods`` must then
    also carry ``pod_gang_id``, and ``tstate`` is updated in place.  Returns (assigned [P]
    int32 — node index or −1, rounds int, remaining node_avail [N,R] int32,
    acc_round [P] int32 — the round each pod was accepted in or −1,
    rank_of [P] int32 — each pod's priority rank).  Every bitmap operand
    must be 0/1 (ValueError otherwise, before any round): the choose
    kernels read the node bitmaps as words, built here once per cycle.
    Gang ids outside [0, G], and domain ids outside the state's columns,
    raise ValueError, once per cycle."""
    p_out = pods["pod_req"].shape[0]
    check_pod_bitmaps(*(pods[k] for k in POD_BITMAP_KEYS))
    topo = None
    if tmeta is not None:
        topo = {"meta": tmeta, "cycle": gang_cycle_operands(tmeta), "state": tstate}
        check_gang_ids(pods["pod_gang_id"], tstate["placed"].shape[0])
        check_domain_columns(topo["cycle"]["dom_col"], tstate["placed"].shape[1])
    words = pack_node_words(*(nodes[k] for k in NODE_WORD_KEYS))
    perm, ps = _prepare_pods(pods, block)
    cons = None
    if cmeta is not None:
        cons = _Constraints(cmeta, augment_round_state(cstate, cmeta), soft_spread, soft_pa, hard_pa)
    p = ps["pod_req"].shape[0]
    device = ps["pod_req"].device
    sizes = _size_chain(p, block)

    assigned_rank = torch.zeros((p,), dtype=torch.int32, device=device)
    acc_round_rank = torch.zeros((p,), dtype=torch.int32, device=device)
    avail = nodes["node_avail"]
    n_active = int(ps["active"].sum())
    rounds = 0
    # Terminal-exit latch: a stage that stops on the round cap, a drained
    # pool or a stall makes every later stage run zero rounds, so the
    # stage-transition slice (which may drop still-active rows) is safe.
    done = False
    for i, size in enumerate(sizes):
        if i > 0:
            # Fold the rows about to be dropped, then slice to the stage size.
            assigned_rank[ps["ranks"].to(torch.int64)] = ps["assigned"]
            acc_round_rank[ps["ranks"].to(torch.int64)] = ps["acc_round"]
            ps = {k: v[:size] for k, v in ps.items()}
        next_size = sizes[i + 1] if i + 1 < len(sizes) else 0
        while (
            not done and rounds < max_rounds and n_active > 0 and not _stalled(cons)
            and (not next_size or n_active > next_size)
        ):
            avail, ps, n_active = _round(avail, ps, n_active, rounds, nodes, words, weights, block, cons, topo)
            rounds += 1
        done = done or rounds >= max_rounds or n_active <= 0 or _stalled(cons)

    # Undo compaction (rank space), then the priority permutation, dropping
    # block padding.
    ranks = ps["ranks"].to(torch.int64)
    assigned_rank[ranks] = ps["assigned"]
    acc_round_rank[ranks] = ps["acc_round"]
    out = torch.full((p_out,), -1, dtype=torch.int32, device=device)
    out[perm] = assigned_rank[:p_out]
    acc_round = torch.full((p_out,), -1, dtype=torch.int32, device=device)
    acc_round[perm] = acc_round_rank[:p_out]
    rank_of = torch.zeros((p_out,), dtype=torch.int32, device=device)
    rank_of[perm] = torch.arange(p_out, dtype=torch.int32, device=device)
    return out, rounds, avail, acc_round, rank_of
