"""Inter-pod constraints as tensors: anti-affinity, positive and preferred
pod affinity, hard and soft topology spread — the port of
``tpu_scheduler/ops/constraints.py``.

Host half (NumPy, copied): the budgets, :class:`ConstraintSet` and
:func:`pack_constraints`, which turn a snapshot's constraint structure into
domain-granular tensors — pod-side bitmaps [P, ·], node → coarse-domain
one-hots [N, D], per-term domain metadata, and the round-start state from
placed pods.  The constants keep the JAX package's values: its tests pin
results at their boundaries.

Device half (torch): the per-round engine the auction runs
(ops/assign.py) — :func:`augment_round_state` once per cycle, then per
round :func:`round_blocked_masks` (the [·, N] blocked/penalty node masks the
choose step reads), :func:`constraint_filter` (within-round conflict
resolution by priority rank) and :func:`constraint_commit` (fold the
round's placements into the domain state).  The rank rules, the
order-witness validity argument and the history of each formulation are
documented on the JAX package's functions; here each function states what
it computes and where the torch form departs in mechanics:

* The filter gathers the round's exact accepted rows with ``torch.nonzero``
  (the NumPy oracle's form: one host sync per round, which the eager driver
  already pays for ``n_active``); the jit path's ``ACTIVE_CHUNK`` tiling
  exists only for XLA's static shapes and is kept as a constant for parity
  of the shared budgets.
* ``.at[].min/.max`` become ``scatter_reduce_(…, "amin"/"amax",
  include_self=True)`` and ``.at[].add`` becomes ``index_add_``.

Every value the engine sums is an exact small-integer float32 (0/1
bitmaps, domain counts, ranks below 2^24), so summation order — atomics in
``index_add_``, chunked scans, dense vs. scatter formulations, cuBLAS vs.
BLAS — cannot change a result: the port equals the NumPy oracle bit for
bit.  On CUDA the count matmuls must run in full float32 (TF32 keeps ten
mantissa bits), which :func:`_exact` enforces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..api.objects import Pod
from ..core.predicates import term_matches
from .pack import round_up

__all__ = [
    "ConstraintSet",
    "UntensorizableConstraints",
    "pack_constraints",
    "prune_match_memo",
    "augment_round_state",
    "round_blocked_masks",
    "blocked_block",
    "constraint_filter",
    "constraint_commit",
    "RANK_INF",
]

# The "no rank" sentinel of the min-rank scatters and water-line mins: the
# float32 value of the JAX package's np.float32(3.0e38), as a Python float
# so torch.where/comparisons keep float32 tensors float32.
RANK_INF = float(np.float32(3.0e38))

# Default budgets (padded): per-term state [T,N]/[S,D] and pod-side bitmaps
# [P,T] etc.; a cluster beyond them raises UntensorizableConstraints.
MAX_AA_TERMS = 256
MAX_SPREAD = 256
MAX_COARSE_DOMAINS = 256

# Anti-affinity filter formulation switch: at or below this terms×D product
# (and DENSE_TENSOR_BYTES for the [A,T,D] tensor) "who came earlier into my
# cell" is a dense exclusive cumsum along the rank-ordered accepted rows;
# above it, one fused segment scatter-min.  Results are bit-identical either
# way (exact small-integer counts; array order is rank order).
DENSE_CELLS = 1024
# Byte budget of one [rows, cells] float32 3-tensor: gates the dense
# anti-affinity path and chunks the spread filter's cell scans along the
# pod axis (exact sums: chunked and one-shot results are equal).
DENSE_TENSOR_BYTES = 400 * 1024 * 1024


def _dense_ok(p: int, cells: int) -> bool:
    return cells <= DENSE_CELLS and p * cells * 4 <= DENSE_TENSOR_BYTES


# Within-round water-line sweeps of the spread admission filter: each sweep
# can lift a constraint's certain minimum one level.  A global constant: a
# size-dependent count would make admission depend on the stage shape.
SPREAD_CASCADE = 4

# Pod-axis tile of the JAX package's jit active-set scans.  The port gathers
# the exact accepted rows instead (the NumPy oracle's form), so it does not
# tile; the value is kept with the other shared budgets.
ACTIVE_CHUNK = 256


class UntensorizableConstraints(Exception):
    """Constraint structure exceeds the tensor budgets — use the host path."""


# Sentinel key under which a match_memo stores the term-vocabulary signature
# it is valid for.  Key spaces (owned HERE, with prune_match_memo and
# _sig_independent — callers must not hand-filter by key type):
#   _MEMO_SIG            — the signature sentinel
#   id(pod) ints         — matched-term ids (vocab-DEPENDENT)
#   ("dk", id(pod))      — declared canonical keys (vocab-independent)
_MEMO_SIG = "sig"
_MEMO_DK = "dk"


def _sig_independent(k) -> bool:
    """Memo keys that survive a vocabulary-signature change."""
    return isinstance(k, tuple) and len(k) == 2 and k[0] == _MEMO_DK


def prune_match_memo(memo: dict, live_ids: set) -> dict:
    """Drop memo entries for dead pod objects, preserving the signature
    sentinel (see the key-space table above)."""
    return {
        k: v
        for k, v in memo.items()
        if k == _MEMO_SIG or k in live_ids or (isinstance(k, tuple) and k[1] in live_ids)
    }




def _term_probe_index(term_list):
    """(indexed, residual) over ``[(key, (ns, term)), ...]`` — the matched-
    bitmap hot loops are O(pods × terms) naively (13M term_matches calls at
    50k pods × ~260 terms, ~15 s host-side); a term with match_labels can
    only match a pod carrying its first sorted (k, v) pair, so pods probe
    the index with their own labels and run the full matcher on the few
    candidates (the same near-linear trick as the controller's
    _split_affinity_pending).  Terms without match_labels land in the
    per-namespace residual."""
    indexed: dict[tuple, list[int]] = {}
    residual: dict[str | None, list[int]] = {}
    for ti, (_key, (t_ns, term)) in enumerate(term_list):
        ml = term.match_labels
        if ml:
            k, v = sorted(ml.items())[0]
            indexed.setdefault((t_ns, k, v), []).append(ti)
        else:
            residual.setdefault(t_ns, []).append(ti)
    return indexed, residual


def _matched_term_ids(term_list, indexed, residual, ns, labels):
    """Term indices of ``term_list`` whose selector matches ``labels`` in
    namespace ``ns`` — candidates from the probe index, verified exactly."""
    cand: set[int] = set(residual.get(ns, ()))
    if labels:
        for kv in labels.items():
            cand.update(indexed.get((ns, kv[0], kv[1]), ()))
    return [ti for ti in cand if term_matches(term_list[ti][1][1], labels)]


def _canon_selector(match_labels, match_expressions) -> tuple:
    ml = tuple(sorted((match_labels or {}).items()))
    mx = tuple(
        sorted(
            (r.key, r.operator, tuple(sorted(r.values or ())) if r.operator in ("In", "NotIn") else tuple(r.values or ()))
            for r in (match_expressions or [])
        )
    )
    return (ml, mx)


def _aa_key(ns, term) -> tuple:
    return (ns, term.topology_key, _canon_selector(term.match_labels, term.match_expressions))


def _sp_key(ns, c) -> tuple:
    return (ns, c.topology_key, int(c.max_skew), _canon_selector(c.match_labels, c.match_expressions))


@dataclass(frozen=True)
class ConstraintSet:
    """Device tensors for AA + spread over one packed cycle.

    Pod rows align with PackedCluster's pending-pod order (padded to P).
    State arrays are the *round-start* state (from placed pods); the auction
    threads them through its while-loop carry.
    """

    # Pod side [P, T] / [P, Ta] / [P, S] / [P, Ss] float32
    pod_aa_carries: np.ndarray
    pod_aa_matched: np.ndarray
    pod_pa_declares: np.ndarray  # positive affinity: the pod declares term
    pod_pa_matched: np.ndarray  # the pod's labels satisfy the term's selector
    pod_sp_declares: np.ndarray
    pod_sp_matched: np.ndarray
    pod_sps_declares: np.ndarray  # soft (ScheduleAnyway) spread declarations
    pod_sps_matched: np.ndarray
    pod_ppa_w: np.ndarray  # [P, Tp] SIGNED preferred-(anti-)affinity weights
    pod_ppa_matched: np.ndarray  # [P, Tp] pod matches the preferred term
    # Node side
    node_dom_c: np.ndarray  # [N, D] float32 one-hot (one col per carried key)
    # Term metadata
    term_uses_dom: np.ndarray  # [T, D] float32 — domains of the term's key
    pa_uses_dom: np.ndarray  # [Ta, D] float32 — positive-affinity term keys
    ppa_uses_dom: np.ndarray  # [Tp, D] float32 — preferred-term keys
    sp_uses_dom: np.ndarray  # [S, D] float32
    sp_skew: np.ndarray  # [S] float32
    sps_uses_dom: np.ndarray  # [Ss, D] float32 — soft-spread constraint keys
    # Spread-domain selection [D, Ds] one-hot: the Ds ≤ D coarse domains any
    # HARD spread constraint references.  The filter's [·,S,D] cell passes
    # project through it so their domain axis carries only spread-relevant
    # columns (a zone-keyed cluster runs them at Ds=8 instead of the full
    # padded vocabulary) — dropped columns have sp_uses_dom ≡ 0, so every
    # product/min they fed was identically zero/INF and admissions are
    # bitwise unchanged.
    sp_dom_sel: np.ndarray
    # Initial state (from placed pods)
    aa_dom_m: np.ndarray  # [T, D] 0/1 — domain holds a pod matched by term
    aa_dom_c: np.ndarray  # [T, D] 0/1 — domain holds a carrier of term
    aa_node_m: np.ndarray  # [T, N] 0/1 — fine-granularity (singleton) twin
    aa_node_c: np.ndarray  # [T, N] 0/1
    pa_dom_m: np.ndarray  # [Ta, D] 0/1 — domain holds a pod matched by PA term
    pa_node_m: np.ndarray  # [Ta, N] 0/1 — fine-granularity twin
    ppa_dom_cnt: np.ndarray  # [Tp, D] float32 — preferred-term match counts
    ppa_node_cnt: np.ndarray  # [Tp, N] float32 — fine-granularity twin
    sp_counts: np.ndarray  # [S, D] float32 — matching placed pods per domain
    sps_counts: np.ndarray  # [Ss, D] float32 — soft-spread matching counts

    n_terms: int
    n_pa_terms: int
    n_ppa_terms: int
    n_spread: int
    n_spread_soft: int

    def pod_arrays(self) -> dict:
        return {
            "pod_aa_carries": self.pod_aa_carries,
            "pod_aa_matched": self.pod_aa_matched,
            "pod_pa_declares": self.pod_pa_declares,
            "pod_pa_matched": self.pod_pa_matched,
            "pod_sp_declares": self.pod_sp_declares,
            "pod_sp_matched": self.pod_sp_matched,
            "pod_sps_declares": self.pod_sps_declares,
            "pod_sps_matched": self.pod_sps_matched,
            "pod_ppa_w": self.pod_ppa_w,
            "pod_ppa_matched": self.pod_ppa_matched,
        }

    def meta_arrays(self) -> dict:
        return {
            "node_dom_c": self.node_dom_c,
            "term_uses_dom": self.term_uses_dom,
            "pa_uses_dom": self.pa_uses_dom,
            "ppa_uses_dom": self.ppa_uses_dom,
            "sp_uses_dom": self.sp_uses_dom,
            "sp_skew": self.sp_skew,
            "sps_uses_dom": self.sps_uses_dom,
            "sp_dom_sel": self.sp_dom_sel,
        }

    def state_arrays(self) -> dict:
        return {
            "aa_dom_m": self.aa_dom_m,
            "aa_dom_c": self.aa_dom_c,
            "aa_node_m": self.aa_node_m,
            "aa_node_c": self.aa_node_c,
            "pa_dom_m": self.pa_dom_m,
            "pa_node_m": self.pa_node_m,
            "ppa_dom_cnt": self.ppa_dom_cnt,
            "ppa_node_cnt": self.ppa_node_cnt,
            "sp_counts": self.sp_counts,
            "sps_counts": self.sps_counts,
        }


def pack_constraints(
    snapshot,
    pending: list[Pod],
    padded_pods: int,
    node_names: tuple[str, ...],
    padded_nodes: int,
    max_aa_terms: int = MAX_AA_TERMS,
    max_spread: int = MAX_SPREAD,
    max_coarse_domains: int = MAX_COARSE_DOMAINS,
    label_block: int = 8,
    match_memo: dict | None = None,
) -> ConstraintSet | None:
    """Build constraint tensors for one cycle; None if nothing constrained.

    Raises :class:`UntensorizableConstraints` when the structure exceeds the
    budgets (the controller's cue to run the host sequential phase instead).

    ``match_memo`` (same contract as ops/pack.py ``res_memo``: object-
    identity keyed, ``id(pod) -> (pod, matched-id tuples)``, caller-owned
    and caller-pruned) memoizes the five selector-match queries per pod —
    the dominant host cost of a constrained cycle (the matched-bitmap and
    placed-state loops are O(pods × terms) term_matches calls without it;
    PERF.md "known remaining headroom").  The memo is only valid for one
    term-vocabulary signature: it self-clears whenever the vocab changes
    (a new app's term appearing is a full-rematch event, steady-state
    cycles hit ~100%).  The API layer replaces pod objects on every
    modification, so identity hits are exactly the unchanged pods."""
    nodes = list(snapshot.nodes)
    assert tuple(n.name for n in nodes) == tuple(node_names)

    def _declared(pod):
        """The pod's declared canonical keys, memoized by object identity:
        (aa [(key, term)], pa [(key, term)], ppa [(key, term, signed_w)],
        sp [(key, c)], sps [(key, c)]).  Valid independent of the term
        vocabulary (derived from the pod object alone), so cached under a
        ("dk", id) key that survives vocab changes only incidentally — a
        sig-triggered clear recomputes it for the price of one pass."""
        mk = (_MEMO_DK, id(pod))
        if match_memo is not None:
            hit = match_memo.get(mk)
            if hit is not None and hit[0] is pod:
                return hit[1]
        ns, spec = pod.metadata.namespace, pod.spec
        aa = [(_aa_key(ns, t), t) for t in (spec.anti_affinity or ())] if spec is not None else []
        pa = [(_aa_key(ns, t), t) for t in (spec.pod_affinity or ())] if spec is not None else []
        ppa = []
        sp: list = []
        sps: list = []
        if spec is not None:
            for w in spec.preferred_pod_affinity or ():
                ppa.append((_aa_key(ns, w.term), w.term, float(w.weight)))
            for w in spec.preferred_pod_anti_affinity or ():
                ppa.append((_aa_key(ns, w.term), w.term, -float(w.weight)))
            for c in spec.topology_spread or ():
                (sp if c.is_hard else sps).append((_sp_key(ns, c), c))
        data = (aa, pa, ppa, sp, sps)
        # Unconstrained pods: recomputing the five empty lists is cheaper
        # than a memo entry per pod (the memo would double in size).
        if match_memo is not None and (aa or pa or ppa or sp or sps):
            match_memo[mk] = (pod, data)
        return data

    # --- vocabularies -----------------------------------------------------
    aa_vocab: dict[tuple, tuple] = {}  # key -> (ns, term)
    pa_vocab: dict[tuple, tuple] = {}
    ppa_vocab: dict[tuple, tuple] = {}  # preferred (soft, signed) — scoring only
    sp_vocab: dict[tuple, tuple] = {}  # hard (DoNotSchedule) — blocking
    sps_vocab: dict[tuple, tuple] = {}  # soft (ScheduleAnyway) — scoring only
    for p in pending:
        ns = p.metadata.namespace
        aa, pa, ppa, sp, sps = _declared(p)
        for key, t in aa:
            aa_vocab.setdefault(key, (ns, t))
        # Positive affinity: only PENDING pods' terms constrain anyone (no
        # symmetric direction — a placed pod's affinity is already satisfied).
        for key, t in pa:
            pa_vocab.setdefault(key, (ns, t))
        for key, t, _w in ppa:
            ppa_vocab.setdefault(key, (ns, t))
        for key, c in sp:
            sp_vocab.setdefault(key, (ns, c))
        for key, c in sps:
            sps_vocab.setdefault(key, (ns, c))
    # One _declared pass per placed carrier: the (key, term) pairs feed both
    # the vocab walk here and the carrier-mark loop at the bottom.
    placed_carrier_keys = [(q, qn, _declared(q)[0]) for q, qn in snapshot.placed_pods_with_terms()]
    for q, _qn, aa_d in placed_carrier_keys:
        ns = q.metadata.namespace
        for key, t in aa_d:
            aa_vocab.setdefault(key, (ns, t))

    if not aa_vocab and not pa_vocab and not ppa_vocab and not sp_vocab and not sps_vocab:
        return None
    if len(aa_vocab) > max_aa_terms:
        raise UntensorizableConstraints(f"{len(aa_vocab)} anti-affinity terms > budget {max_aa_terms}")
    if len(pa_vocab) > max_aa_terms:
        raise UntensorizableConstraints(f"{len(pa_vocab)} pod-affinity terms > budget {max_aa_terms}")
    if len(ppa_vocab) > max_aa_terms:
        raise UntensorizableConstraints(f"{len(ppa_vocab)} preferred pod-affinity terms > budget {max_aa_terms}")
    if len(sp_vocab) > max_spread:
        raise UntensorizableConstraints(f"{len(sp_vocab)} spread constraints > budget {max_spread}")
    if len(sps_vocab) > max_spread:
        raise UntensorizableConstraints(f"{len(sps_vocab)} soft spread constraints > budget {max_spread}")

    # --- topology keys → coarse domains or fine (per-node) ----------------
    keys = (
        {k for (_ns, k, _sel) in aa_vocab}
        | {k for (_ns, k, _sel) in pa_vocab}
        | {k for (_ns, k, _sel) in ppa_vocab}
        | {k for (_ns, k, _sk, _sel) in sp_vocab}
        | {k for (_ns, k, _sk, _sel) in sps_vocab}
    )
    spread_keys = {k for (_ns, k, _sk, _sel) in sp_vocab} | {k for (_ns, k, _sk, _sel) in sps_vocab}
    key_values: dict[str, dict[str, list[int]]] = {k: {} for k in keys}
    for i, n in enumerate(nodes):
        labels = n.metadata.labels or {}
        for k in keys:
            v = labels.get(k)
            if v is not None:
                key_values[k].setdefault(v, []).append(i)

    dom_vocab: dict[tuple[str, str], int] = {}  # (key, value) -> column
    fine_keys: set[str] = set()
    budget = max_coarse_domains
    for k in sorted(keys):
        vals = key_values[k]
        if len(vals) <= budget - len(dom_vocab):
            for v in sorted(vals):
                dom_vocab[(k, v)] = len(dom_vocab)
        elif all(len(nids) == 1 for nids in vals.values()):
            # Hostname-like: unique value per node ⇒ domain ≡ node, exact at
            # fine granularity with zero coarse columns.
            fine_keys.add(k)
            if k in spread_keys:
                raise UntensorizableConstraints(f"spread key {k!r} is per-node-granular ({len(vals)} values)")
        else:
            raise UntensorizableConstraints(f"topology key {k!r} has {len(vals)} shared-value domains > budget")

    d_pad = round_up(max(len(dom_vocab), 1), label_block)
    t_pad = round_up(max(len(aa_vocab), 1), label_block)
    ta_pad = round_up(max(len(pa_vocab), 1), label_block)
    tp_pad = round_up(max(len(ppa_vocab), 1), label_block)
    s_pad = round_up(max(len(sp_vocab), 1), label_block)
    ss_pad = round_up(max(len(sps_vocab), 1), label_block)
    n_pad = padded_nodes

    node_dom_c = np.zeros((n_pad, d_pad), dtype=np.float32)
    for (k, v), j in dom_vocab.items():
        for i in key_values[k][v]:
            node_dom_c[i, j] = 1.0

    aa_terms = list(aa_vocab.items())  # [(key, (ns, term))]
    pa_terms = list(pa_vocab.items())
    ppa_terms = list(ppa_vocab.items())
    sp_terms = list(sp_vocab.items())
    sps_terms = list(sps_vocab.items())

    term_uses_dom = np.zeros((t_pad, d_pad), dtype=np.float32)
    for ti, (key, (_ns, term)) in enumerate(aa_terms):
        if term.topology_key not in fine_keys:
            for v in key_values.get(term.topology_key, ()):  # noqa: B007
                term_uses_dom[ti, dom_vocab[(term.topology_key, v)]] = 1.0
    pa_uses_dom = np.zeros((ta_pad, d_pad), dtype=np.float32)
    for ti, (key, (_ns, term)) in enumerate(pa_terms):
        if term.topology_key not in fine_keys:
            for v in key_values.get(term.topology_key, ()):  # noqa: B007
                pa_uses_dom[ti, dom_vocab[(term.topology_key, v)]] = 1.0
    ppa_uses_dom = np.zeros((tp_pad, d_pad), dtype=np.float32)
    for ti, (key, (_ns, term)) in enumerate(ppa_terms):
        if term.topology_key not in fine_keys:
            for v in key_values.get(term.topology_key, ()):  # noqa: B007
                ppa_uses_dom[ti, dom_vocab[(term.topology_key, v)]] = 1.0
    sp_uses_dom = np.zeros((s_pad, d_pad), dtype=np.float32)
    sp_skew = np.zeros((s_pad,), dtype=np.float32)
    for si, (key, (_ns, c)) in enumerate(sp_terms):
        sp_skew[si] = float(c.max_skew)
        for v in key_values.get(c.topology_key, ()):
            sp_uses_dom[si, dom_vocab[(c.topology_key, v)]] = 1.0
    sps_uses_dom = np.zeros((ss_pad, d_pad), dtype=np.float32)
    for si, (key, (_ns, c)) in enumerate(sps_terms):
        for v in key_values.get(c.topology_key, ()):
            sps_uses_dom[si, dom_vocab[(c.topology_key, v)]] = 1.0
    # Spread-domain selection (see the ConstraintSet field comment): one-hot
    # columns for the domains any hard spread constraint references, padded
    # to the label block so the filter's cell passes stay tile-aligned.
    sp_cols = np.flatnonzero((sp_uses_dom > 0).any(axis=0))
    ds_pad = round_up(max(len(sp_cols), 1), label_block)
    sp_dom_sel = np.zeros((d_pad, ds_pad), dtype=np.float32)
    sp_dom_sel[sp_cols, np.arange(len(sp_cols))] = 1.0

    # --- pod-side bitmaps -------------------------------------------------
    pod_aa_carries = np.zeros((padded_pods, t_pad), dtype=np.float32)
    pod_aa_matched = np.zeros((padded_pods, t_pad), dtype=np.float32)
    pod_pa_declares = np.zeros((padded_pods, ta_pad), dtype=np.float32)
    pod_pa_matched = np.zeros((padded_pods, ta_pad), dtype=np.float32)
    pod_sp_declares = np.zeros((padded_pods, s_pad), dtype=np.float32)
    pod_sp_matched = np.zeros((padded_pods, s_pad), dtype=np.float32)
    pod_sps_declares = np.zeros((padded_pods, ss_pad), dtype=np.float32)
    pod_sps_matched = np.zeros((padded_pods, ss_pad), dtype=np.float32)
    pod_ppa_w = np.zeros((padded_pods, tp_pad), dtype=np.float32)
    pod_ppa_matched = np.zeros((padded_pods, tp_pad), dtype=np.float32)
    aa_index = {key: i for i, (key, _) in enumerate(aa_terms)}
    pa_index = {key: i for i, (key, _) in enumerate(pa_terms)}
    ppa_index = {key: i for i, (key, _) in enumerate(ppa_terms)}
    sp_index = {key: i for i, (key, _) in enumerate(sp_terms)}
    sps_index = {key: i for i, (key, _) in enumerate(sps_terms)}
    aa_probe, aa_res = _term_probe_index(aa_terms)
    pa_probe, pa_res = _term_probe_index(pa_terms)
    ppa_probe, ppa_res = _term_probe_index(ppa_terms)
    sp_probe, sp_res = _term_probe_index(sp_terms)
    sps_probe, sps_res = _term_probe_index(sps_terms)

    if match_memo is not None:
        sig = (
            tuple(k for k, _ in aa_terms),
            tuple(k for k, _ in pa_terms),
            tuple(k for k, _ in ppa_terms),
            tuple(k for k, _ in sp_terms),
            tuple(k for k, _ in sps_terms),
        )
        if match_memo.get(_MEMO_SIG) != sig:
            # Matched-id entries are vocab-dependent — drop them; declared-
            # keys entries derive from the pod object alone and survive
            # (_sig_independent owns that distinction).
            keep = {k: v for k, v in match_memo.items() if _sig_independent(k)}
            match_memo.clear()
            match_memo.update(keep)
            match_memo[_MEMO_SIG] = sig

    def _matched_all(pod):
        """(aa, pa, ppa, sp, sps) matched-id lists for one pod, memoized."""
        if match_memo is not None:
            hit = match_memo.get(id(pod))
            if hit is not None and hit[0] is pod:
                return hit[1]
        ns, labels = pod.metadata.namespace, pod.metadata.labels
        ids = (
            _matched_term_ids(aa_terms, aa_probe, aa_res, ns, labels),
            _matched_term_ids(pa_terms, pa_probe, pa_res, ns, labels),
            _matched_term_ids(ppa_terms, ppa_probe, ppa_res, ns, labels),
            _matched_term_ids(sp_terms, sp_probe, sp_res, ns, labels),
            _matched_term_ids(sps_terms, sps_probe, sps_res, ns, labels),
        )
        if match_memo is not None:
            match_memo[id(pod)] = (pod, ids)
        return ids

    for pi, p in enumerate(pending):
        aa_d, pa_d, ppa_d, sp_d, sps_d = _declared(p)
        for key, _t in aa_d:
            pod_aa_carries[pi, aa_index[key]] = 1.0
        for key, _t in pa_d:
            pod_pa_declares[pi, pa_index[key]] = 1.0
        for key, _t, w in ppa_d:
            pod_ppa_w[pi, ppa_index[key]] += w
        for key, _c in sp_d:
            pod_sp_declares[pi, sp_index[key]] = 1.0
        for key, _c in sps_d:
            pod_sps_declares[pi, sps_index[key]] = 1.0
        aa_m, pa_m, ppa_m, sp_m, sps_m = _matched_all(p)
        for ti in aa_m:
            pod_aa_matched[pi, ti] = 1.0
        for ti in pa_m:
            pod_pa_matched[pi, ti] = 1.0
        for ti in ppa_m:
            pod_ppa_matched[pi, ti] = 1.0
        for si in sp_m:
            pod_sp_matched[pi, si] = 1.0
        for si in sps_m:
            pod_sps_matched[pi, si] = 1.0

    # --- initial state from placed pods -----------------------------------
    aa_dom_m = np.zeros((t_pad, d_pad), dtype=np.float32)
    aa_dom_c = np.zeros((t_pad, d_pad), dtype=np.float32)
    aa_node_m = np.zeros((t_pad, n_pad), dtype=np.float32)
    aa_node_c = np.zeros((t_pad, n_pad), dtype=np.float32)
    pa_dom_m = np.zeros((ta_pad, d_pad), dtype=np.float32)
    pa_node_m = np.zeros((ta_pad, n_pad), dtype=np.float32)
    ppa_dom_cnt = np.zeros((tp_pad, d_pad), dtype=np.float32)
    ppa_node_cnt = np.zeros((tp_pad, n_pad), dtype=np.float32)
    sp_counts = np.zeros((s_pad, d_pad), dtype=np.float32)
    sps_counts = np.zeros((ss_pad, d_pad), dtype=np.float32)
    node_index = {n.name: i for i, n in enumerate(nodes)}

    def _mark(arr_dom, arr_node, ti, term, qnode_name):
        ni = node_index[qnode_name]
        k = term.topology_key
        v = (nodes[ni].metadata.labels or {}).get(k)
        if k not in fine_keys and v is not None:
            arr_dom[ti, dom_vocab[(k, v)]] = 1.0
        else:
            arr_node[ti, ni] = 1.0

    def _count(arr_dom, arr_node, ti, term, qnode_name):
        """+= twin of _mark for the count-valued preferred-term state."""
        ni = node_index[qnode_name]
        k = term.topology_key
        v = (nodes[ni].metadata.labels or {}).get(k)
        if k not in fine_keys and v is not None:
            arr_dom[ti, dom_vocab[(k, v)]] += 1.0
        else:
            arr_node[ti, ni] += 1.0

    if aa_terms or pa_terms or ppa_terms or sp_terms or sps_terms:
        want_sp = bool(sp_terms or sps_terms)
        for q, qnode in snapshot.placed_pods():
            aa_m, pa_m, ppa_m, sp_m, sps_m = _matched_all(q)
            for ti in aa_m:
                _mark(aa_dom_m, aa_node_m, ti, aa_terms[ti][1][1], qnode.name)
            for ti in pa_m:
                _mark(pa_dom_m, pa_node_m, ti, pa_terms[ti][1][1], qnode.name)
            for ti in ppa_m:
                _count(ppa_dom_cnt, ppa_node_cnt, ti, ppa_terms[ti][1][1], qnode.name)
            if want_sp and (sp_m or sps_m):
                nlabels = (nodes[node_index[qnode.name]].metadata.labels) or {}
                for si in sp_m:
                    c = sp_terms[si][1][1]
                    v = nlabels.get(c.topology_key)
                    if v is not None:
                        sp_counts[si, dom_vocab[(c.topology_key, v)]] += 1.0
                for si in sps_m:
                    c = sps_terms[si][1][1]
                    v = nlabels.get(c.topology_key)
                    if v is not None:
                        sps_counts[si, dom_vocab[(c.topology_key, v)]] += 1.0
        for _q, qnode, aa_d in placed_carrier_keys:
            for key, t in aa_d:
                _mark(aa_dom_c, aa_node_c, aa_index[key], t, qnode.name)

    return ConstraintSet(
        pod_aa_carries=pod_aa_carries,
        pod_aa_matched=pod_aa_matched,
        pod_pa_declares=pod_pa_declares,
        pod_pa_matched=pod_pa_matched,
        pod_sp_declares=pod_sp_declares,
        pod_sp_matched=pod_sp_matched,
        pod_sps_declares=pod_sps_declares,
        pod_sps_matched=pod_sps_matched,
        pod_ppa_w=pod_ppa_w,
        pod_ppa_matched=pod_ppa_matched,
        node_dom_c=node_dom_c,
        term_uses_dom=term_uses_dom,
        pa_uses_dom=pa_uses_dom,
        ppa_uses_dom=ppa_uses_dom,
        sp_uses_dom=sp_uses_dom,
        sp_skew=sp_skew,
        sps_uses_dom=sps_uses_dom,
        sp_dom_sel=sp_dom_sel,
        aa_dom_m=aa_dom_m,
        aa_dom_c=aa_dom_c,
        aa_node_m=aa_node_m,
        aa_node_c=aa_node_c,
        pa_dom_m=pa_dom_m,
        pa_node_m=pa_node_m,
        ppa_dom_cnt=ppa_dom_cnt,
        ppa_node_cnt=ppa_node_cnt,
        sp_counts=sp_counts,
        sps_counts=sps_counts,
        n_terms=len(aa_terms),
        n_pa_terms=len(pa_terms),
        n_ppa_terms=len(ppa_terms),
        n_spread=len(sp_terms),
        n_spread_soft=len(sps_terms),
    )


# ---------------------------------------------------------------------------
# Device half: the per-round engine, on torch tensors
# ---------------------------------------------------------------------------

_F32 = torch.float32


def _exact(t: torch.Tensor) -> None:
    """The engine's matmuls sum exact integers only in full float32: make
    sure cuBLAS is not allowed TF32 for them."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def _clip01(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a, max=1.0)


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 0 of an [A, ...] tensor, computed as an
    innermost-dimension scan of its transposed copy: CUDA runs a dim-0 scan
    as an outer-dimension scan, one thread per column walking all A rows
    (~0.5 s of a flagship constrained cycle on an H100).  The sums are
    exact integers, so the two forms are equal."""
    flat = x.reshape(x.shape[0], -1)
    return torch.cumsum(flat.T.contiguous(), dim=1).T.reshape(x.shape)


def _water_line(uses: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[S] min count over each constraint's used domains (0 where it uses
    none)."""
    lo = torch.amin(torch.where(uses > 0, counts, RANK_INF), dim=1)
    return torch.where(lo >= RANK_INF, 0.0, lo)


def _pa_inactive(state: dict) -> torch.Tensor:
    """[Ta] 1.0 where a positive-affinity term has no match anywhere."""
    return ((state["pa_dom_m"].sum(dim=1) + state["pa_node_m"].sum(dim=1)) == 0).to(_F32)


def augment_round_state(state: dict, meta: dict) -> dict:
    """The cycle-start state plus the round-carried entries the engine
    reads instead of re-deriving them every round: ``sp_cell`` [S,D] (spread
    counts masked to used domains), ``sp_lo`` [S] (spread water line) and
    ``pa_inactive`` [Ta] (positive-affinity bootstrap flags).
    :func:`constraint_commit` keeps them current."""
    uses = meta["sp_uses_dom"]
    sp_cell = state["sp_counts"] * uses
    return {**state, "sp_cell": sp_cell, "sp_lo": _water_line(uses, sp_cell), "pa_inactive": _pa_inactive(state)}


def round_blocked_masks(
    state: dict, meta: dict, soft_spread: bool = False, soft_pa: bool = False, hard_pa: bool = True
) -> dict:
    """Per-round [·, N] node masks from the current (augmented) state:

    aa_m_node [T,N]   the node's domain holds a pod matched by term t —
                      blocks carriers of t;
    aa_c_node [T,N]   the domain holds a carrier of t — blocks matched pods;
    sp_node [S,N]     the domain is beyond the spread cascade's reach —
                      blocks declarers of s;
    sp_level_node     [S,N] the domain's height above s's water line (score
                      steering for hard-spread declarers);
    pa_unmatched_node [Ta,N] and pa_inactive [Ta] (``hard_pa``): the
                      positive-affinity term has no match in the domain, and
                      the term is globally inactive (bootstrap waiver);
    sp_penalty_node   [Ss,N] (``soft_spread``): soft-spread match counts;
    ppa_cnt_node      [Tp,N] (``soft_pa``): preferred-term match counts."""
    _exact(meta["node_dom_c"])
    ndc_t = meta["node_dom_c"].T
    masks = {
        "aa_m_node": _clip01(state["aa_dom_m"] @ ndc_t + state["aa_node_m"]),
        "aa_c_node": _clip01(state["aa_dom_c"] @ ndc_t + state["aa_node_c"]),
    }
    uses = meta["sp_uses_dom"]
    counts = state["sp_counts"]
    lo = state["sp_lo"]
    blockcell = uses * (counts >= (meta["sp_skew"] + lo + SPREAD_CASCADE)[:, None])
    masks["sp_node"] = _clip01(blockcell @ ndc_t)
    masks["sp_level_node"] = ((counts - lo[:, None]) * uses) @ ndc_t
    if hard_pa:
        masks["pa_unmatched_node"] = 1.0 - _clip01(state["pa_dom_m"] @ ndc_t + state["pa_node_m"])
        masks["pa_inactive"] = state["pa_inactive"]
    if soft_spread:
        masks["sp_penalty_node"] = state["sps_counts"] @ ndc_t
    if soft_pa:
        masks["ppa_cnt_node"] = state["ppa_dom_cnt"] @ ndc_t + state["ppa_node_cnt"]
    return masks


def blocked_block(blk: dict, masks: dict) -> torch.Tensor:
    """[B, N] constraint-blocked mask for one pod block.  A declared
    positive-affinity term that is globally inactive AND matched by the pod
    itself drops out of the pod's requirements this round (the bootstrap
    waiver); every other declared term blocks its unmatched nodes."""
    b = blk["pod_aa_carries"] @ masks["aa_m_node"]
    b = b + blk["pod_aa_matched"] @ masks["aa_c_node"]
    b = b + blk["pod_sp_declares"] @ masks["sp_node"]
    if "pa_unmatched_node" in masks:
        gated = blk["pod_pa_declares"] * (1.0 - blk["pod_pa_matched"] * masks["pa_inactive"][None, :])
        b = b + gated @ masks["pa_unmatched_node"]
    return b > 0


def _scatter_min(size: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.full((size,), RANK_INF, dtype=_F32, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


def _row_scatter_min(n_rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[r, c] = min over {p : idx[p] == r} of vals[p, c] (RANK_INF fill)."""
    out = torch.full((n_rows, vals.shape[1]), RANK_INF, dtype=_F32, device=vals.device)
    return out.scatter_reduce_(0, idx[:, None].expand_as(vals), vals, "amin", include_self=True)


def _row_scatter_max_t(state_tn: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """[T,N] state with state[c, idx[p]] = max(state, vals[p, c]) folded in
    (a new tensor: the caller's state is left as it was)."""
    out = state_tn.T.contiguous()
    out.scatter_reduce_(0, idx[:, None].expand_as(vals), vals, "amax", include_self=True)
    return out.T.contiguous()


def _row_scatter_add_t(state_tn: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """+= twin of :func:`_row_scatter_max_t` for count-valued state."""
    out = state_tn.T.contiguous()
    out.index_add_(0, idx, vals)
    return out.T.contiguous()


def _cell_chunk(p: int, cells: int) -> int:
    """Pod-axis chunk length keeping one [chunk, S, D] tile inside the byte
    budget (0 = the full tensor fits)."""
    if p * cells * 4 <= DENSE_TENSOR_BYTES:
        return 0
    return max(256, DENSE_TENSOR_BYTES // (cells * 4))


def _cell_rank_scan(mass, nd, uses, out_fn):
    """The spread filter's exclusive-by-rank cell passes: feeds
    ``out_fn(ec3, m3)`` — ``ec3`` the [·,S,D] cumulative cell mass of all
    lower-rank rows, ``m3`` the rows' own-cell one-hots — one-shot when
    [P,S,D] fits the byte budget, else per pod-axis chunk with an [S,D]
    carry, and concatenates the [·,S] outputs."""
    p, s = mass.shape
    d = nd.shape[1]

    def step(carry, mch, ndch):
        m3 = ndch[:, None, :] * uses[None, :, :]
        c3 = mch[:, :, None] * m3
        ec3 = carry[None, :, :] + _cumsum_rows(c3) - c3
        return carry + c3.sum(dim=0), out_fn(ec3, m3)

    carry = torch.zeros((s, d), dtype=_F32, device=mass.device)
    chunk = _cell_chunk(p, s * d)
    if chunk == 0:
        return step(carry, mass, nd)[1]
    outs = []
    for lo in range(0, p, chunk):
        carry, out = step(carry, mass[lo : lo + chunk], nd[lo : lo + chunk])
        outs.append(out)
    return torch.cat(outs)


def _cell_rank_prefix(mass, nd, uses):
    """[P,S] mass of lower rank (array order) in each pod's own (s, domain)
    cell — the quota prefix."""
    return _cell_rank_scan(mass, nd, uses, lambda ec3, m3: (ec3 * m3).sum(dim=2))


def _cell_rank_min_level(mass, nd, uses, base):
    """[P,S] per-pod water line: min over the constraint's used domains of
    ``base`` plus the lower-rank fill of ``mass``."""

    def out_fn(ec3, m3):
        lo = torch.amin(torch.where(uses[None, :, :] > 0, base[None, :, :] + ec3, RANK_INF), dim=2)
        return torch.where(lo >= RANK_INF, 0.0, lo)

    return _cell_rank_scan(mass, nd, uses, out_fn)


def constraint_filter(accepted, choice, ranks, ps: dict, state: dict, meta: dict, hard_pa: bool = True):
    """Within-round conflict resolution: the subset of ``accepted`` [P] that
    survives, pods in array order = priority-rank order.

    * Anti-affinity: in each (term, cell) — the coarse domain when the
      chosen node carries the term's key, else the node itself — a matched
      pod survives only if no earlier accepted carrier shares the cell, and
      vice versa.
    * Positive-affinity bootstrap: of the declarers waived this round, only
      those up to the first accepted match of the term survive.
    * Spread: a declarer on a keyed node is kept iff its cell's round-start
      count plus the lower-rank candidate mass plus one stays within
      ``max_skew`` plus its water line, the line lifted by SPREAD_CASCADE
      sweeps of lower-rank committed fills.

    Only accepted rows can conflict, so the filter works on the exact
    accepted rows (gathered with ``torch.nonzero``) and scatters the
    survivors back."""
    gperm = torch.nonzero(accepted).squeeze(1)
    if gperm.numel() == 0:
        return accepted.clone()
    ndc = meta["node_dom_c"]
    _exact(ndc)
    n, d = ndc.shape
    choice_ws = choice[gperm].to(torch.int64)
    rank_f = ranks[gperm].to(_F32)
    keys = ["pod_aa_carries", "pod_aa_matched", "pod_sp_declares", "pod_sp_matched"]
    if hard_pa:
        keys += ["pod_pa_declares", "pod_pa_matched"]
    pw = {k: ps[k][gperm] for k in keys}
    nd = ndc[choice_ws]  # [A, D] one-hot domains of each accepted pod's node

    uses = meta["term_uses_dom"]  # [T, D]
    uses_sp = meta["sp_uses_dom"]  # [S, D]
    t = uses.shape[0]
    s_sp = uses_sp.shape[0]
    sp0 = state["sp_cell"]
    # One gather matmul for every per-pod cell lookup: AA coarse-key flags
    # and cell ids, spread key flags and own-cell round-start counts.
    dom_ids = torch.arange(d, dtype=_F32, device=ndc.device)
    band = torch.cat([uses, uses * dom_ids[None, :], uses_sp, sp0])  # [2T+2S, D]
    g_all = nd @ band.T
    has_c = g_all[:, :t]  # [A, T] the chosen node has the term's coarse key
    cc = g_all[:, t : 2 * t]  # [A, T] coarse cell id
    in_cell = g_all[:, 2 * t : 2 * t + s_sp]  # [A, S] the node carries the spread key
    c_at = g_all[:, 2 * t + s_sp :]  # [A, S] own-cell round-start count

    # ---- anti-affinity ----------------------------------------------------
    carr, matc = pw["pod_aa_carries"], pw["pod_aa_matched"]
    if _dense_ok(nd.shape[0], t * d):
        m3 = nd[:, None, :] * uses[None, :, :]  # [A,T,D] one-hot coarse cell under t

        def earlier_in_cell(v):  # "an earlier v-pod shares my coarse cell"
            v3 = v[:, :, None] * m3
            ec = _cumsum_rows(v3) - v3
            return (ec * m3).sum(dim=2) > 0

        fine = has_c == 0
        min_c_fine = _row_scatter_min(n, choice_ws, torch.where((carr * fine) > 0, rank_f[:, None], RANK_INF))
        min_m_fine = _row_scatter_min(n, choice_ws, torch.where((matc * fine) > 0, rank_f[:, None], RANK_INF))
        earlier_c = earlier_in_cell(carr * has_c) | (fine & (rank_f[:, None] > min_c_fine[choice_ws]))
        earlier_m = earlier_in_cell(matc * has_c) | (fine & (rank_f[:, None] > min_m_fine[choice_ws]))
        bad_aa = ((matc > 0) & earlier_c) | ((carr > 0) & earlier_m)
    else:
        # One segment scatter-min over the (term, coarse domain ∪ node) cell
        # space: carrier mins in [0, t·cells), matched mins offset by t·cells.
        cells = d + n
        cell = torch.where(has_c > 0, cc, d + choice_ws[:, None].to(_F32))
        g = (torch.arange(t, dtype=_F32, device=ndc.device)[None, :] * cells + cell).to(torch.int32).to(torch.int64)
        gf2 = torch.cat([g.reshape(-1), (g + t * cells).reshape(-1)])
        vals2 = torch.cat([
            torch.where(carr > 0, rank_f[:, None], RANK_INF).reshape(-1),
            torch.where(matc > 0, rank_f[:, None], RANK_INF).reshape(-1),
        ])
        mins = _scatter_min(2 * t * cells, gf2, vals2)
        bad_aa = ((matc > 0) & (rank_f[:, None] > mins[g])) | ((carr > 0) & (rank_f[:, None] > mins[g + t * cells]))
    keep = ~bad_aa.any(dim=1)

    # ---- positive-affinity bootstrap --------------------------------------
    if hard_pa:
        pa_m_acc = pw["pod_pa_matched"] * keep.to(_F32)[:, None]  # [A, Ta]
        min_match_rank = torch.amin(torch.where(pa_m_acc > 0, rank_f[:, None], RANK_INF), dim=0)  # [Ta]
        waived = pw["pod_pa_declares"] * pw["pod_pa_matched"] * state["pa_inactive"][None, :]
        bad_pa = (waived > 0) & keep[:, None] & (rank_f[:, None] > min_match_rank[None, :])
        keep = keep & ~bad_pa.any(dim=1)

    # ---- topology spread: rank-prefix admission + in-round cascade ---------
    skew = meta["sp_skew"]  # [S]
    keep_f = keep.to(_F32)
    cand_m = keep_f[:, None] * pw["pod_sp_matched"] * in_cell  # [A, S] candidate matched mass
    decl_cell = keep_f[:, None] * pw["pod_sp_declares"] * in_cell  # declarers on keyed nodes
    # The cell passes run on the pack-time spread-domain selection only.
    sel = meta["sp_dom_sel"]
    nd_sp, uses_spc, sp0c = nd @ sel, uses_sp @ sel, sp0 @ sel
    pre_all = _cell_rank_prefix(cand_m, nd_sp, uses_spc)
    bound = c_at + pre_all + 1.0  # [A, S] count-after-placement upper bound
    lo_p = torch.zeros_like(c_at) + state["sp_lo"][None, :]
    admit = bound <= (skew[None, :] + lo_p)
    for _ in range(SPREAD_CASCADE):
        rejected = ((decl_cell > 0) & ~admit).any(dim=1)
        committed_pod = keep_f * (1.0 - rejected.to(_F32))  # [A]
        lo_p = _cell_rank_min_level(cand_m * committed_pod[:, None], nd_sp, uses_spc, sp0c)
        admit = admit | (bound <= (skew[None, :] + lo_p))
    keep = keep & ~((decl_cell > 0) & ~admit).any(dim=1)

    out = torch.zeros_like(accepted)
    out[gperm] = keep
    return out


def constraint_commit(
    accepted, choice, ps: dict, state: dict, meta: dict,
    soft_spread: bool = False, soft_pa: bool = False, hard_pa: bool = True,
) -> dict:
    """Fold the round's final accepted placements into the domain state,
    the round-carried entries of :func:`augment_round_state` included.
    Returns a new state dict; the one passed in is left as it was."""
    ndc = meta["node_dom_c"]
    _exact(ndc)
    idx = choice.to(torch.int64)
    nd = ndc[idx]
    accf = accepted.to(_F32)[:, None]
    uses = meta["term_uses_dom"]
    matc = ps["pod_aa_matched"] * accf  # [P, T]
    carr = ps["pod_aa_carries"] * accf
    out = dict(state)
    out["aa_dom_m"] = _clip01(state["aa_dom_m"] + (matc.T @ nd) * uses)
    out["aa_dom_c"] = _clip01(state["aa_dom_c"] + (carr.T @ nd) * uses)
    # Fine granularity: the chosen node lacks the term's coarse key, so the
    # node is its own domain.
    fine = (nd @ uses.T) == 0  # [P, T]
    out["aa_node_m"] = _row_scatter_max_t(state["aa_node_m"], idx, matc * fine)
    out["aa_node_c"] = _row_scatter_max_t(state["aa_node_c"], idx, carr * fine)
    if hard_pa:
        # Every accepted pod matching a PA term activates its landing domain.
        uses_pa = meta["pa_uses_dom"]
        matc_pa = ps["pod_pa_matched"] * accf  # [P, Ta]
        out["pa_dom_m"] = _clip01(state["pa_dom_m"] + (matc_pa.T @ nd) * uses_pa)
        out["pa_node_m"] = _row_scatter_max_t(state["pa_node_m"], idx, matc_pa * ((nd @ uses_pa.T) == 0))
        newly_matched = (matc_pa.sum(dim=0) > 0).to(_F32)  # [Ta]
        out["pa_inactive"] = state["pa_inactive"] * (1.0 - newly_matched)
    if soft_pa:
        uses_ppa = meta["ppa_uses_dom"]
        matc_ppa = ps["pod_ppa_matched"] * accf  # [P, Tp]
        out["ppa_dom_cnt"] = state["ppa_dom_cnt"] + (matc_ppa.T @ nd) * uses_ppa
        out["ppa_node_cnt"] = _row_scatter_add_t(state["ppa_node_cnt"], idx, matc_ppa * ((nd @ uses_ppa.T) == 0))
    uses_sp = meta["sp_uses_dom"]
    out["sp_counts"] = state["sp_counts"] + ((ps["pod_sp_matched"] * accf).T @ nd) * uses_sp
    if soft_spread:
        out["sps_counts"] = state["sps_counts"] + ((ps["pod_sps_matched"] * accf).T @ nd) * meta["sps_uses_dom"]
    out["sp_cell"] = out["sp_counts"] * uses_sp
    out["sp_lo"] = _water_line(uses_sp, out["sp_cell"])
    return out
