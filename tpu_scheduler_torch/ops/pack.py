"""Tensorization: ClusterSnapshot → packed host tensors (NumPy).

Copy of the full-pack half of ``tpu_scheduler/ops/pack.py``; the
incremental repack paths wait for the controller slice.  Layout:

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

from dataclasses import dataclass

import numpy as np

from ..api.objects import LabelSelectorRequirement, NodeSelectorTerm, Pod, Taint, full_name, total_pod_resources
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
    # interconnect-topology tensors, attached per cycle by the caller.  The
    # port's cycle takes the constraints; backends/cuda.py refuses a cluster
    # that carries topology (not ported yet).
    constraints: object | None = None
    topology: object | None = None

    # Resource axis names and per-column unit divisors: cpu millis, memory
    # KiB, then each extended resource at the smallest power-of-1024 divisor
    # under which every value fits int32.
    res_vocab: tuple[str, ...] = ("cpu", "memory")
    res_scales: tuple[int, ...] = (1, 1024)

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


def resource_vocab(snapshot: ClusterSnapshot) -> tuple[str, ...]:
    """("cpu", "memory") plus every EXTENDED resource name any pod in the
    snapshot requests (bound pods too), sorted for a stable column order."""
    names: set[str] = set()
    for pod in snapshot.pods:
        if pod.spec is None:
            continue
        res = total_pod_resources(pod)
        if res.extended:
            names.update(res.extended)
    return ("cpu", "memory", *sorted(names))


def _alloc_and_used64(
    snapshot: ClusterSnapshot, n_pad: int, res_vocab: tuple[str, ...]
) -> tuple[np.ndarray, np.ndarray]:
    """Exact int64 (allocatable, bound-usage) per node, in base units."""
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
            reslist.append(total_pod_resources(pod))
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
    return alloc64, used64


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


def _pack_pods(pending: list[Pod], vocab: dict, p_pad: int, l_pad: int, res_vocab: tuple[str, ...]) -> dict:
    """Pod-side tensors; requests in raw base units (the caller ceils them
    by ``res_scales``)."""
    pod_req64 = np.zeros((p_pad, len(res_vocab)), dtype=np.int64)
    pod_sel = np.zeros((p_pad, l_pad), dtype=np.float32)
    pod_sel_count = np.zeros((p_pad,), dtype=np.float32)
    pod_prio = np.zeros((p_pad,), dtype=np.int32)
    pod_valid = np.zeros((p_pad,), dtype=bool)

    n = len(pending)
    reslist = [total_pod_resources(pod) for pod in pending]
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
) -> PackedCluster:
    """Pack a snapshot into static-shape tensors.  A supplied vocabulary
    must cover every entry the pending pods and nodes use
    (:class:`PackingError` otherwise); omitted ones are built fresh."""
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

    res_vocab = resource_vocab(snapshot)
    alloc64, used64 = _alloc_and_used64(snapshot, n_pad, res_vocab)
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

    pod_tensors = _pack_pods(pending, vocab, p_pad, l_pad, res_vocab)
    pod_req64 = pod_tensors.pop("pod_req64")
    res_scales = _fit_scales(alloc64, pod_req64)
    scales = np.asarray(res_scales, dtype=np.int64)[None, :]
    pod_aff, pod_has_aff = _pack_affinity(pending, aff_vocab, p_pad, a_pad)
    return PackedCluster(
        node_alloc=_clamp_i32(np.floor_divide(alloc64, scales)),
        node_avail=_clamp_i32(np.floor_divide(alloc64 - used64, scales)),
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
