"""Tensorization: ClusterSnapshot → packed host tensors (NumPy).

Copy of ``tpu_scheduler/ops/pack.py``: the full pack and the controller's
incremental paths (``repack_avail``, ``extend_node_vocabs``,
``repack_incremental`` with its identity-keyed ``res_memo``).  Layout:

  node_alloc[N,R]  int32   total allocatable (cpu millis, memory KiB, then
                           extended resources — res_vocab/res_scales)
  node_avail[N,R]  int32   remaining = allocatable − Σ bound-pod requests
  node_labels[N,L] float32 bitmap over the selector-pair vocabulary
  node_taints[N,T] float32 bitmap over the hard-taint vocabulary
  node_aff[N,A]    float32 node satisfies affinity-term vocab entry
  pod_req[P,R]     int32   pending-pod requests (millis, KiB ceil, counts)
  pod_sel[P,L]     float32 selector bitmap; pod_sel_count[P] = #selector keys
  pod_ntol[P,T]    float32 1 where the pod does NOT tolerate vocab taint t
  pod_aff[P,A]     float32 bitmap of the pod's node-affinity terms
  pod_has_aff[P]   float32 1 if the pod declares required node affinity
  pod_prio[P]      int32   pod priority

Rounding is conservative — allocatable floors, requests ceil, values clamp
to int32 — so a fit decided on packed tensors is valid under the exact
scalar predicates.  Shapes pad to multiples of (pod_block, node_block);
padding rows have zero requests / zero capacity and are masked out.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..api.objects import (
    LabelSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    Taint,
    full_name,
    is_extended_resource,
    total_pod_resources,
)
from ..api.quantity import cpu_to_millis, memory_to_bytes
from ..core.predicates import HARD_TAINT_EFFECTS, node_selector_term_matches
from ..core.snapshot import ClusterSnapshot
from ..errors import PackingError

__all__ = [
    "PackedCluster",
    "pack_snapshot",
    "build_selector_vocab",
    "build_taint_vocab",
    "build_affinity_vocab",
    "build_soft_taint_vocab",
    "build_pref_vocab",
    "resource_vocab",
    "repack_avail",
    "extend_node_vocabs",
    "repack_incremental",
    "round_up",
    "INT32_MAX",
    "STALL_ROUNDS",
]

CPU, MEM = 0, 1  # resource axis indices
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

# Constraint-cycle auctions stop after this many consecutive zero-acceptance
# rounds (ops/assign.py; the JAX package's value).
STALL_ROUNDS = 3


def round_up(x: int, multiple: int) -> int:
    if multiple <= 1:
        return max(x, 1)
    return max(((x + multiple - 1) // multiple) * multiple, multiple)


def _clamp_i32(x64: np.ndarray) -> np.ndarray:
    """int64 → int32 with saturation (never silent wraparound)."""
    return np.clip(x64, INT32_MIN, INT32_MAX).astype(np.int32)


@dataclass(frozen=True)
class PackedCluster:
    """Static-shape tensor view of one scheduling cycle's input."""

    # Nodes (padded to N)
    node_alloc: np.ndarray  # [N,R] int32
    node_avail: np.ndarray  # [N,R] int32
    node_labels: np.ndarray  # [N,L] float32
    node_taints: np.ndarray  # [N,T] float32
    node_aff: np.ndarray  # [N,A] float32
    node_valid: np.ndarray  # [N]  bool (padding + cordoned nodes are False)
    node_names: tuple[str, ...]  # real nodes only

    # Pending pods (padded to P)
    pod_req: np.ndarray  # [P,R] int32
    pod_sel: np.ndarray  # [P,L] float32
    pod_sel_count: np.ndarray  # [P] float32
    pod_ntol: np.ndarray  # [P,T] float32
    pod_aff: np.ndarray  # [P,A] float32
    pod_has_aff: np.ndarray  # [P] float32
    pod_prio: np.ndarray  # [P] int32
    pod_valid: np.ndarray  # [P]  bool
    pod_names: tuple[str, ...]  # full names of real pending pods

    # Soft (scoring) terms; zero-filled when the cluster has none.
    node_taints_soft: np.ndarray  # [N,Ts] float32 — PreferNoSchedule bitmap
    pod_ntol_soft: np.ndarray  # [P,Ts] float32 — 1 where NOT tolerated
    node_pref: np.ndarray  # [N,A2] float32 — node satisfies pref-term
    pod_pref_w: np.ndarray  # [P,A2] float32 — pod's weight for pref-term

    vocab: dict[tuple[str, str], int]
    taint_vocab: dict[tuple[str, str, str], int]
    aff_vocab: dict[tuple, int]
    soft_taint_vocab: dict[tuple[str, str, str], int]
    pref_vocab: dict[tuple, int]

    # Inter-pod constraint tensors (ops/constraints.ConstraintSet) and
    # interconnect-topology tensors (topology/locality.TopologySet),
    # attached per cycle by the caller.
    constraints: object | None = None
    topology: object | None = None

    # Resource axis names and per-column unit divisors: cpu millis, memory
    # KiB, then each extended resource at the smallest power-of-1024 divisor
    # under which every value fits int32.
    res_vocab: tuple[str, ...] = ("cpu", "memory")
    res_scales: tuple[int, ...] = (1, 1024)

    # The pod OBJECTS behind the rows (pod_names order): the identity keys
    # of repack_incremental's row reuse.  Host-only, never shipped.
    pod_objs: tuple = ()

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_pods(self) -> int:
        return len(self.pod_names)

    @property
    def padded_nodes(self) -> int:
        return self.node_alloc.shape[0]

    @property
    def padded_pods(self) -> int:
        return self.pod_req.shape[0]

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The tensors that ship to the device (names → arrays)."""
        return {
            "node_alloc": self.node_alloc,
            "node_avail": self.node_avail,
            "node_labels": self.node_labels,
            "node_taints": self.node_taints,
            "node_aff": self.node_aff,
            "node_valid": self.node_valid,
            "pod_req": self.pod_req,
            "pod_sel": self.pod_sel,
            "pod_sel_count": self.pod_sel_count,
            "pod_ntol": self.pod_ntol,
            "pod_aff": self.pod_aff,
            "pod_has_aff": self.pod_has_aff,
            "pod_prio": self.pod_prio,
            "pod_valid": self.pod_valid,
            "node_taints_soft": self.node_taints_soft,
            "pod_ntol_soft": self.pod_ntol_soft,
            "node_pref": self.node_pref,
            "pod_pref_w": self.pod_pref_w,
        }


def build_selector_vocab(pods: list[Pod]) -> dict[tuple[str, str], int]:
    """Vocabulary of selector (key, value) pairs over the pending pods."""
    vocab: dict[tuple[str, str], int] = {}
    for p in pods:
        if p.spec is not None and p.spec.node_selector:
            for kv in p.spec.node_selector.items():
                if kv not in vocab:
                    vocab[kv] = len(vocab)
    return vocab


def build_affinity_vocab(pods: list[Pod]) -> dict[tuple, int]:
    """Vocabulary of canonical node-affinity terms over the pending pods."""
    vocab: dict[tuple, int] = {}
    for p in pods:
        if p.spec is not None and p.spec.node_affinity:
            for term in p.spec.node_affinity:
                k = term.key()
                if k not in vocab:
                    vocab[k] = len(vocab)
    return vocab


def build_taint_vocab(nodes) -> dict[tuple[str, str, str], int]:
    """Vocabulary of hard (key, value, effect) taint triples over the nodes."""
    vocab: dict[tuple[str, str, str], int] = {}
    for n in nodes:
        if n.spec is not None and n.spec.taints:
            for t in n.spec.taints:
                if t.effect in HARD_TAINT_EFFECTS:
                    triple = (t.key, t.value, t.effect)
                    if triple not in vocab:
                        vocab[triple] = len(vocab)
    return vocab


def build_soft_taint_vocab(nodes) -> dict[tuple[str, str, str], int]:
    """Vocabulary of PreferNoSchedule taint triples."""
    vocab: dict[tuple[str, str, str], int] = {}
    for n in nodes:
        if n.spec is not None and n.spec.taints:
            for t in n.spec.taints:
                if t.effect == "PreferNoSchedule":
                    triple = (t.key, t.value, t.effect)
                    if triple not in vocab:
                        vocab[triple] = len(vocab)
    return vocab


def build_pref_vocab(pods: list[Pod]) -> dict[tuple, int]:
    """Vocabulary of canonical preferred-affinity terms over pending pods."""
    vocab: dict[tuple, int] = {}
    for p in pods:
        if p.spec is not None and p.spec.preferred_node_affinity:
            for t in p.spec.preferred_node_affinity:
                k = t.term.key()
                if k not in vocab:
                    vocab[k] = len(vocab)
    return vocab


def _term_from_key(key: tuple) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[
            LabelSelectorRequirement(key=k, operator=op, values=list(vals) if vals else None) for k, op, vals in key
        ]
    )


def _pack_node_terms(nodes, term_vocab: dict, n_pad: int, a_pad: int) -> np.ndarray:
    """[N,A] node-satisfies-term bitmap, host-evaluated with the full scalar
    operator semantics (required and preferred affinity alike)."""
    out = np.zeros((n_pad, a_pad), dtype=np.float32)
    if not term_vocab:
        return out
    terms = [(idx, _term_from_key(key)) for key, idx in term_vocab.items()]
    for i, node in enumerate(nodes):
        labels = node.metadata.labels
        for j, term in terms:
            if node_selector_term_matches(term, labels):
                out[i, j] = 1.0
    return out


def _pack_affinity(pending: list[Pod], aff_vocab: dict, p_pad: int, a_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Pod-side affinity bitmaps ([P,A] term membership, [P] has-affinity)."""
    pod_aff = np.zeros((p_pad, a_pad), dtype=np.float32)
    pod_has = np.zeros((p_pad,), dtype=np.float32)
    for i, pod in enumerate(pending):
        terms = (pod.spec.node_affinity or []) if pod.spec is not None else []
        if not terms:
            continue
        pod_has[i] = 1.0
        for term in terms:
            j = aff_vocab.get(term.key())
            if j is None:
                raise PackingError(f"affinity term {term.key()} missing from supplied aff_vocab")
            pod_aff[i, j] = 1.0
    return pod_aff, pod_has


def _pack_pod_pref(pending: list[Pod], pref_vocab: dict, p_pad: int, a_pad: int) -> np.ndarray:
    """[P,A2] per-pod weight of each preferred term (duplicate declarations
    of the same canonical term sum their weights)."""
    pod_pref_w = np.zeros((p_pad, a_pad), dtype=np.float32)
    for i, pod in enumerate(pending):
        terms = (pod.spec.preferred_node_affinity or []) if pod.spec is not None else []
        for t in terms:
            j = pref_vocab.get(t.term.key())
            if j is None:
                raise PackingError(f"preferred term {t.term.key()} missing from supplied pref_vocab")
            pod_pref_w[i, j] += float(t.weight)
    return pod_pref_w


def _pack_ntol(pending: list[Pod], taint_vocab: dict, p_pad: int, t_pad: int) -> np.ndarray:
    """[P,T] 1.0 where the pod does NOT tolerate vocab taint t (padding
    rows/columns are 0 = vacuously tolerated).  Rows are cached by
    toleration content: most pods share a handful of toleration lists."""
    ntol = np.zeros((p_pad, t_pad), dtype=np.float32)
    if not taint_vocab:
        return ntol
    triples = [(idx, Taint(key=k, value=v, effect=e)) for (k, v, e), idx in taint_vocab.items()]
    default_row = np.zeros((t_pad,), dtype=np.float32)
    for j, _ in triples:
        default_row[j] = 1.0
    rows: dict[tuple, np.ndarray] = {}

    def row_for(tolerations) -> np.ndarray:
        key = tuple((t.key, t.operator, t.value, t.effect) for t in tolerations)
        row = rows.get(key)
        if row is None:
            row = np.zeros((t_pad,), dtype=np.float32)
            for j, taint in triples:
                if not any(t.tolerates(taint) for t in tolerations):
                    row[j] = 1.0
            rows[key] = row
        return row

    for i, pod in enumerate(pending):
        tolerations = (pod.spec.tolerations or []) if pod.spec is not None else []
        ntol[i] = row_for(tolerations) if tolerations else default_row
    return ntol


def _resources(pod: Pod, res_memo: dict | None):
    """``total_pod_resources(pod)``, through the identity-keyed memo
    ``res_memo`` (id(pod) -> (pod, PodResources)) when given."""
    if res_memo is None:
        return total_pod_resources(pod)
    hit = res_memo.get(id(pod))
    if hit is not None and hit[0] is pod:
        return hit[1]
    res = total_pod_resources(pod)
    res_memo[id(pod)] = (pod, res)
    return res


def resource_vocab(snapshot: ClusterSnapshot, res_memo: dict | None = None) -> tuple[str, ...]:
    """("cpu", "memory") plus every EXTENDED resource name any pod in the
    snapshot requests (bound pods too), sorted for a stable column order.
    With ``res_memo`` unchanged pods answer from their cached sums."""
    names: set[str] = set()
    for pod in snapshot.pods:
        if pod.spec is None:
            continue
        if res_memo is not None:
            res = _resources(pod, res_memo)
            if res.extended:
                names.update(res.extended)
            continue
        for c in pod.spec.containers:
            if c.resources is not None and c.resources.requests is not None:
                for k in c.resources.requests:
                    if k != "cpu" and k != "memory" and is_extended_resource(k):
                        names.add(k)
    return ("cpu", "memory", *sorted(names))


def _alloc_and_used64(
    snapshot: ClusterSnapshot, n_pad: int, res_memo: dict | None = None, res_vocab: tuple[str, ...] = ("cpu", "memory")
) -> tuple[np.ndarray, np.ndarray, dict[str, int]]:
    """Exact int64 (allocatable, bound-usage) per node, in base units, and
    the node name -> row map — shared by pack, the incremental avail refresh
    and the delta engine's rebuild."""
    r = len(res_vocab)
    alloc64 = np.zeros((n_pad, r), dtype=np.int64)
    used64 = np.zeros((n_pad, r), dtype=np.int64)
    node_index: dict[str, int] = {}
    for i, node in enumerate(snapshot.nodes):
        node_index[node.name] = i
        if node.status is not None and node.status.allocatable is not None:
            alloc = node.status.allocatable
            if "cpu" in alloc:
                alloc64[i, CPU] = cpu_to_millis(alloc["cpu"])
            if "memory" in alloc:
                alloc64[i, MEM] = memory_to_bytes(alloc["memory"])
            for j, name in enumerate(res_vocab[2:], start=2):
                if name in alloc:
                    alloc64[i, j] = memory_to_bytes(alloc[name])
    idxs: list[int] = []
    reslist = []
    for pod in snapshot.pods:
        if pod.spec is not None and pod.spec.node_name is not None:
            i = node_index.get(pod.spec.node_name)
            if i is None:
                continue  # bound to an unknown node; consumes nothing we track
            idxs.append(i)
            reslist.append(_resources(pod, res_memo))
    if idxs:
        idx_arr = np.asarray(idxs, dtype=np.int64)
        m = len(idxs)
        np.add.at(used64[:, CPU], idx_arr, np.fromiter((r.cpu for r in reslist), np.int64, m))
        np.add.at(used64[:, MEM], idx_arr, np.fromiter((r.memory for r in reslist), np.int64, m))
        if len(res_vocab) > 2:
            ext_col = {name: j for j, name in enumerate(res_vocab[2:], start=2)}
            for i, res in zip(idxs, reslist):
                if res.extended:
                    for name, v in res.extended.items():
                        j = ext_col.get(name)
                        if j is not None and v:
                            used64[i, j] += v
    return alloc64, used64, node_index


def _fit_scales(alloc64: np.ndarray, req64: np.ndarray) -> tuple[int, ...]:
    """Per-column divisors: columns 0-1 are fixed (millis, KiB); each
    extended column takes the smallest power of 1024 under which every
    allocatable AND request value fits int32 (ceiled, as requests are)."""
    r = alloc64.shape[1]
    scales = [1, 1024]
    for j in range(2, r):
        m = 0
        if alloc64.shape[0]:
            m = max(m, int(np.abs(alloc64[:, j]).max()))
        if req64.shape[0]:
            m = max(m, int(np.abs(req64[:, j]).max()))
        scale = 1
        while -(-m // scale) > INT32_MAX:
            scale *= 1024
        scales.append(scale)
    return tuple(scales)


def _req_i32(req64: np.ndarray, res_scales: tuple[int, ...]) -> np.ndarray:
    """Requests CEIL under the column divisors."""
    sc = np.asarray(res_scales, dtype=np.int64)[None, :]
    return _clamp_i32(-(np.floor_divide(-req64, sc)))


def _avail_i32(alloc64: np.ndarray, used64: np.ndarray, res_scales: tuple[int, ...]) -> np.ndarray:
    """Remaining capacity, floored under the column divisors."""
    return _clamp_i32(np.floor_divide(alloc64 - used64, np.asarray(res_scales, dtype=np.int64)[None, :]))


def _pack_pods(
    pending: list[Pod], vocab: dict, p_pad: int, l_pad: int, res_vocab: tuple[str, ...], res_memo: dict | None = None
) -> dict:
    """Pod-side tensors; requests in raw base units (the caller ceils them
    by ``res_scales``)."""
    pod_req64 = np.zeros((p_pad, len(res_vocab)), dtype=np.int64)
    pod_sel = np.zeros((p_pad, l_pad), dtype=np.float32)
    pod_sel_count = np.zeros((p_pad,), dtype=np.float32)
    pod_prio = np.zeros((p_pad,), dtype=np.int32)
    pod_valid = np.zeros((p_pad,), dtype=bool)

    n = len(pending)
    reslist = [_resources(pod, res_memo) for pod in pending]
    if n:
        pod_req64[:n, CPU] = np.fromiter((r.cpu for r in reslist), np.int64, n)
        pod_req64[:n, MEM] = np.fromiter((r.memory for r in reslist), np.int64, n)
        pod_prio[:n] = np.fromiter(((p.spec.priority if p.spec is not None else 0) for p in pending), np.int32, n)
        pod_valid[:n] = True
    if len(res_vocab) > 2:
        ext_col = {name: j for j, name in enumerate(res_vocab[2:], start=2)}
        for i, res in enumerate(reslist):
            if res.extended:
                for name, v in res.extended.items():
                    j = ext_col.get(name)
                    if j is not None and v:
                        pod_req64[i, j] = v
    sel_i: list[int] = []
    sel_j: list[int] = []
    for i, pod in enumerate(pending):
        spec = pod.spec
        if spec is not None and spec.node_selector:
            for kv in spec.node_selector.items():
                j = vocab.get(kv)
                if j is None:
                    raise PackingError(f"selector pair {kv} missing from supplied vocab")
                sel_i.append(i)
                sel_j.append(j)
            pod_sel_count[i] = len(spec.node_selector)
    if sel_i:
        pod_sel[sel_i, sel_j] = 1.0
    return dict(
        pod_req64=pod_req64,
        pod_sel=pod_sel,
        pod_sel_count=pod_sel_count,
        pod_prio=pod_prio,
        pod_valid=pod_valid,
        pod_names=tuple(full_name(p) for p in pending),
        pod_objs=tuple(pending),
    )


def pack_snapshot(
    snapshot: ClusterSnapshot,
    pod_block: int = 128,
    node_block: int = 128,
    label_block: int = 8,
    vocab: dict[tuple[str, str], int] | None = None,
    taint_vocab: dict[tuple[str, str, str], int] | None = None,
    aff_vocab: dict[tuple, int] | None = None,
    soft_taint_vocab: dict[tuple[str, str, str], int] | None = None,
    pref_vocab: dict[tuple, int] | None = None,
    res_memo: dict | None = None,
) -> PackedCluster:
    """Pack a snapshot into static-shape tensors.  A supplied vocabulary
    must cover every entry the pending pods and nodes use
    (:class:`PackingError` otherwise); omitted ones are built fresh.
    ``res_memo``: the identity-keyed request-sum memo shared across
    cycles (:func:`repack_incremental`)."""
    pending = snapshot.pending_pods()
    nodes = list(snapshot.nodes)
    if vocab is None:
        vocab = build_selector_vocab(pending)
    if taint_vocab is None:
        taint_vocab = build_taint_vocab(nodes)
    if aff_vocab is None:
        aff_vocab = build_affinity_vocab(pending)
    if soft_taint_vocab is None:
        soft_taint_vocab = build_soft_taint_vocab(nodes)
    if pref_vocab is None:
        pref_vocab = build_pref_vocab(pending)

    n_pad = round_up(len(nodes), node_block)
    p_pad = round_up(len(pending), pod_block)
    l_pad = round_up(len(vocab), label_block)
    t_pad = round_up(len(taint_vocab), label_block)
    a_pad = round_up(len(aff_vocab), label_block)
    ts_pad = round_up(len(soft_taint_vocab), label_block)
    a2_pad = round_up(len(pref_vocab), label_block)

    res_vocab = resource_vocab(snapshot, res_memo)
    alloc64, used64, _ = _alloc_and_used64(snapshot, n_pad, res_memo, res_vocab)
    node_labels = np.zeros((n_pad, l_pad), dtype=np.float32)
    node_taints = np.zeros((n_pad, t_pad), dtype=np.float32)
    node_taints_soft = np.zeros((n_pad, ts_pad), dtype=np.float32)
    node_valid = np.zeros((n_pad,), dtype=bool)
    for i, node in enumerate(nodes):
        node_valid[i] = not (node.spec is not None and node.spec.unschedulable)
        labels = node.metadata.labels
        if labels:
            for kv in labels.items():
                j = vocab.get(kv)
                if j is not None:
                    node_labels[i, j] = 1.0
        if node.spec is not None and node.spec.taints:
            for t in node.spec.taints:
                if t.effect in HARD_TAINT_EFFECTS:
                    j = taint_vocab.get((t.key, t.value, t.effect))
                    if j is None:
                        raise PackingError(f"taint {(t.key, t.value, t.effect)} missing from supplied taint_vocab")
                    node_taints[i, j] = 1.0
                elif t.effect == "PreferNoSchedule":
                    j = soft_taint_vocab.get((t.key, t.value, t.effect))
                    if j is None:
                        raise PackingError(f"taint {(t.key, t.value, t.effect)} missing from supplied soft_taint_vocab")
                    node_taints_soft[i, j] = 1.0

    pod_tensors = _pack_pods(pending, vocab, p_pad, l_pad, res_vocab, res_memo)
    pod_req64 = pod_tensors.pop("pod_req64")
    res_scales = _fit_scales(alloc64, pod_req64)
    scales = np.asarray(res_scales, dtype=np.int64)[None, :]
    pod_aff, pod_has_aff = _pack_affinity(pending, aff_vocab, p_pad, a_pad)
    return PackedCluster(
        node_alloc=_clamp_i32(np.floor_divide(alloc64, scales)),
        node_avail=_avail_i32(alloc64, used64, res_scales),
        node_labels=node_labels,
        node_taints=node_taints,
        node_aff=_pack_node_terms(nodes, aff_vocab, n_pad, a_pad),
        node_valid=node_valid,
        node_names=tuple(n.name for n in nodes),
        pod_req=_req_i32(pod_req64, res_scales),
        pod_ntol=_pack_ntol(pending, taint_vocab, p_pad, t_pad),
        pod_aff=pod_aff,
        pod_has_aff=pod_has_aff,
        node_taints_soft=node_taints_soft,
        pod_ntol_soft=_pack_ntol(pending, soft_taint_vocab, p_pad, ts_pad),
        node_pref=_pack_node_terms(nodes, pref_vocab, n_pad, a2_pad),
        pod_pref_w=_pack_pod_pref(pending, pref_vocab, p_pad, a2_pad),
        vocab=dict(vocab),
        taint_vocab=dict(taint_vocab),
        aff_vocab=dict(aff_vocab),
        soft_taint_vocab=dict(soft_taint_vocab),
        pref_vocab=dict(pref_vocab),
        res_vocab=res_vocab,
        res_scales=res_scales,
        **pod_tensors,
    )


def _check_alloc_within_scales(alloc64: np.ndarray, res_scales: tuple[int, ...]) -> None:
    """Raise when an EXTENDED allocatable column outgrows its frozen
    divisor: a full pack would re-derive the divisor and stay exact, so a
    capacity saturated at INT32_MAX must force that full pack instead.
    cpu/memory scales are fixed and keep the clamp."""
    sc = np.asarray(res_scales, dtype=np.int64)
    if sc.shape[0] > 2 and alloc64.shape[1] > 2:
        if (np.floor_divide(alloc64[:, 2:], sc[None, 2:]) > INT32_MAX).any():
            raise ValueError("resource scales outgrown by node allocatable; run a full pack_snapshot instead")


def repack_avail(packed: PackedCluster, snapshot: ClusterSnapshot) -> PackedCluster:
    """Refresh ``node_avail`` from a new snapshot over the SAME node set
    (ValueError otherwise, or when the resource vocabulary changed); pod
    tensors and bitmaps are untouched."""
    fresh_names = tuple(n.name for n in snapshot.nodes)
    if fresh_names != packed.node_names:
        raise ValueError("repack_avail requires an identical node set/order; run a full pack_snapshot instead")
    if resource_vocab(snapshot) != packed.res_vocab:
        raise ValueError("resource vocabulary changed; run a full pack_snapshot instead")
    alloc64, used64, _ = _alloc_and_used64(snapshot, packed.padded_nodes, None, packed.res_vocab)
    _check_alloc_within_scales(alloc64, packed.res_scales)
    return replace(packed, node_avail=_avail_i32(alloc64, used64, packed.res_scales))


def _grow_columns(arr: np.ndarray, total: int, label_block: int) -> np.ndarray:
    """Copy ``arr`` with its column count grown to cover ``total`` entries
    (padded to the block multiple).  Always copies: a cached array may
    still be in use (the backends' upload cache keys on identity)."""
    width = arr.shape[1]
    if total > width:
        w_pad = round_up(total, label_block)
        return np.pad(arr, ((0, 0), (0, w_pad - width)))
    return arr.copy()


def extend_node_vocabs(packed: PackedCluster, snapshot: ClusterSnapshot, label_block: int = 8) -> PackedCluster:
    """Grow the node-side bitmaps to cover selector pairs, affinity terms
    and preferred terms that the pending pods newly use, over the SAME node
    set: only the new columns are evaluated, existing columns keep their
    indices (so results equal a fresh pack's).  Taint vocabularies are
    node-driven and not extended.  Refuses (ValueError) once dead columns
    would outnumber the live entries: a full pack compacts them."""
    fresh_names = tuple(n.name for n in snapshot.nodes)
    if fresh_names != packed.node_names:
        raise ValueError("extend_node_vocabs requires an identical node set/order; run a full pack_snapshot instead")
    pending = snapshot.pending_pods()
    nodes = list(snapshot.nodes)
    new_sel: dict[tuple[str, str], None] = {}
    new_aff: dict[tuple, None] = {}
    new_pref: dict[tuple, None] = {}
    live_sel: set = set()
    live_aff: set = set()
    live_pref: set = set()
    for p in pending:
        if p.spec is None:
            continue
        if p.spec.node_selector:
            for kv in p.spec.node_selector.items():
                live_sel.add(kv)
                if kv not in packed.vocab:
                    new_sel[kv] = None
        for term in p.spec.node_affinity or []:
            k = term.key()
            live_aff.add(k)
            if k not in packed.aff_vocab:
                new_aff[k] = None
        for t in p.spec.preferred_node_affinity or []:
            k = t.term.key()
            live_pref.add(k)
            if k not in packed.pref_vocab:
                new_pref[k] = None
    if not (new_sel or new_aff or new_pref):
        return packed
    for vocab, live, new in (
        (packed.vocab, live_sel, new_sel),
        (packed.aff_vocab, live_aff, new_aff),
        (packed.pref_vocab, live_pref, new_pref),
    ):
        if len(vocab) + len(new) > max(16, 2 * len(live)):
            raise ValueError(
                f"vocabulary bloat: {len(vocab)} cached + {len(new)} new entries vs {len(live)} live; "
                "full repack compacts the dead columns"
            )

    out = {}
    if new_sel:
        vocab = dict(packed.vocab)
        node_labels = _grow_columns(packed.node_labels, len(vocab) + len(new_sel), label_block)
        for kv in new_sel:
            vocab[kv] = len(vocab)
        for ni, node in enumerate(nodes):
            labels = node.metadata.labels
            if labels:
                for k, v in new_sel:
                    if labels.get(k) == v:
                        node_labels[ni, vocab[(k, v)]] = 1.0
        out["vocab"] = vocab
        out["node_labels"] = node_labels
    for keys, vocab_name, tensor_name in ((new_aff, "aff_vocab", "node_aff"), (new_pref, "pref_vocab", "node_pref")):
        if not keys:
            continue
        vocab = dict(getattr(packed, vocab_name))
        tensor = _grow_columns(getattr(packed, tensor_name), len(vocab) + len(keys), label_block)
        terms = []
        for key in keys:
            vocab[key] = len(vocab)
            terms.append((vocab[key], _term_from_key(key)))
        for ni, node in enumerate(nodes):
            labels = node.metadata.labels
            for j, term in terms:
                if node_selector_term_matches(term, labels):
                    tensor[ni, j] = 1.0
        out[vocab_name] = vocab
        out[tensor_name] = tensor
    return replace(packed, **out)


def repack_incremental(
    packed: PackedCluster,
    snapshot: ClusterSnapshot,
    pod_block: int = 128,
    res_memo: dict | None = None,
    alloc_used64: tuple[np.ndarray, np.ndarray] | None = None,
) -> PackedCluster:
    """Between-cycles repack over the SAME node set: reuse the node-side
    tensors and rebuild only the pending-pod tensors and the remaining
    capacity.  A pending pod whose OBJECT is unchanged since ``packed``
    (same identity) has its rows gathered from the cached tensors; only new
    or changed pods run the packing body.  ``alloc_used64``: a carried
    exact int64 (allocatable, usage) pair, which skips the usage sweep and
    the resource-vocabulary scan (the caller vouches for both).  Raises
    ValueError on anything a full pack must handle (node set, resource
    vocabulary or scales outgrown); ``packed.vocab`` must cover every
    pending selector pair."""
    fresh_nodes = tuple(n.name for n in snapshot.nodes)
    if fresh_nodes != packed.node_names:
        raise ValueError("repack_incremental requires an identical node set/order; run a full pack_snapshot instead")
    if alloc_used64 is None:
        if resource_vocab(snapshot, res_memo) != packed.res_vocab:
            raise ValueError("resource vocabulary changed; run a full pack_snapshot instead")
        alloc64, used64, _ = _alloc_and_used64(snapshot, packed.padded_nodes, res_memo, packed.res_vocab)
    else:
        alloc64, used64 = alloc_used64
        if alloc64.shape != (packed.padded_nodes, len(packed.res_vocab)) or used64.shape != alloc64.shape:
            raise ValueError("carried capacity pair does not match the packed node axis; run a full pack_snapshot instead")
    _check_alloc_within_scales(alloc64, packed.res_scales)
    pending = snapshot.pending_pods()
    p_pad = max(packed.padded_pods, round_up(len(pending), pod_block))
    # Pod widths come from the NODE side: extend_node_vocabs may have grown
    # the columns since the cached pod tensors were built.
    l_w = packed.node_labels.shape[1]
    t_w = packed.node_taints.shape[1]
    a_w = packed.node_aff.shape[1]
    ts_w = packed.node_taints_soft.shape[1]
    a2_w = packed.node_pref.shape[1]

    prev_row = {name: j for j, name in enumerate(packed.pod_names)} if packed.pod_objs else {}
    reuse_src: list[int] = []
    reuse_dst: list[int] = []
    fresh_idx: list[int] = []
    names: list[str] = []
    for i, pod in enumerate(pending):
        nm = full_name(pod)
        names.append(nm)
        j = prev_row.get(nm)
        if j is not None and packed.pod_objs[j] is pod:
            reuse_src.append(j)
            reuse_dst.append(i)
        else:
            fresh_idx.append(i)

    pod_req = np.zeros((p_pad, len(packed.res_vocab)), dtype=np.int32)
    pod_sel = np.zeros((p_pad, l_w), dtype=np.float32)
    pod_sel_count = np.zeros((p_pad,), dtype=np.float32)
    pod_prio = np.zeros((p_pad,), dtype=np.int32)
    pod_valid = np.zeros((p_pad,), dtype=bool)
    pod_ntol = np.zeros((p_pad, t_w), dtype=np.float32)
    pod_aff = np.zeros((p_pad, a_w), dtype=np.float32)
    pod_has_aff = np.zeros((p_pad,), dtype=np.float32)
    pod_ntol_soft = np.zeros((p_pad, ts_w), dtype=np.float32)
    pod_pref_w = np.zeros((p_pad, a2_w), dtype=np.float32)
    pod_valid[: len(pending)] = True

    if reuse_src:
        src = np.asarray(reuse_src, dtype=np.intp)
        dst = np.asarray(reuse_dst, dtype=np.intp)
        pod_req[dst] = packed.pod_req[src]
        pod_sel[dst, : packed.pod_sel.shape[1]] = packed.pod_sel[src]
        pod_sel_count[dst] = packed.pod_sel_count[src]
        pod_prio[dst] = packed.pod_prio[src]
        pod_ntol[dst, : packed.pod_ntol.shape[1]] = packed.pod_ntol[src]
        pod_aff[dst, : packed.pod_aff.shape[1]] = packed.pod_aff[src]
        pod_has_aff[dst] = packed.pod_has_aff[src]
        pod_ntol_soft[dst, : packed.pod_ntol_soft.shape[1]] = packed.pod_ntol_soft[src]
        pod_pref_w[dst, : packed.pod_pref_w.shape[1]] = packed.pod_pref_w[src]

    if fresh_idx:
        fp = [pending[i] for i in fresh_idx]
        fi = np.asarray(fresh_idx, dtype=np.intp)
        n_f = len(fp)
        sub = _pack_pods(fp, packed.vocab, n_f, l_w, packed.res_vocab, res_memo)
        sc = np.asarray(packed.res_scales, dtype=np.int64)
        # Extended columns only: cpu/memory scales are fixed and clamp.
        if sc.shape[0] > 2 and (-(np.floor_divide(-sub["pod_req64"][:, 2:], sc[None, 2:])) > INT32_MAX).any():
            raise ValueError("resource scales outgrown; run a full pack_snapshot instead")
        pod_req[fi] = _req_i32(sub["pod_req64"], packed.res_scales)
        pod_sel[fi] = sub["pod_sel"]
        pod_sel_count[fi] = sub["pod_sel_count"]
        pod_prio[fi] = sub["pod_prio"]
        pod_ntol[fi] = _pack_ntol(fp, packed.taint_vocab, n_f, t_w)
        f_aff, f_has = _pack_affinity(fp, packed.aff_vocab, n_f, a_w)
        pod_aff[fi] = f_aff
        pod_has_aff[fi] = f_has
        pod_ntol_soft[fi] = _pack_ntol(fp, packed.soft_taint_vocab, n_f, ts_w)
        pod_pref_w[fi] = _pack_pod_pref(fp, packed.pref_vocab, n_f, a2_w)

    return replace(
        packed,
        node_avail=_avail_i32(alloc64, used64, packed.res_scales),
        pod_req=pod_req,
        pod_sel=pod_sel,
        pod_sel_count=pod_sel_count,
        pod_prio=pod_prio,
        pod_valid=pod_valid,
        pod_names=tuple(names),
        pod_objs=tuple(pending),
        pod_ntol=pod_ntol,
        pod_aff=pod_aff,
        pod_has_aff=pod_has_aff,
        pod_ntol_soft=pod_ntol_soft,
        pod_pref_w=pod_pref_w,
    )
