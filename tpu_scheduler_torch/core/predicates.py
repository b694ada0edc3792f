"""Scalar (per pod, per node) predicates — copied from
``tpu_scheduler/core/predicates.py``: the pure reference semantics that
packing evaluates on the host (the hard taint effects, the node-affinity
term match, the label-selector match of inter-pod terms and spread
constraints, the topology-domain rule) and the predicate chain the
controller explains unschedulable pods with (``check_node_validity``,
``unschedulable_reason_counts``, ``dominant_reason``).  The soft scalar
scorers of the JAX module are not copied: nothing in the port reads them.
"""

from __future__ import annotations

import enum
from itertools import chain
from typing import Callable, Sequence

from ..api.objects import LabelSelectorRequirement, Node, Pod, full_name, total_pod_resources
from .snapshot import ClusterSnapshot, node_net_available

__all__ = [
    "InvalidNodeReason",
    "pod_fits_resources",
    "node_selector_matches",
    "node_affinity_matches",
    "node_schedulable",
    "taints_tolerated",
    "anti_affinity_ok",
    "pod_affinity_ok",
    "topology_spread_ok",
    "make_affinity_checker",
    "make_pod_affinity_checker",
    "make_spread_checker",
    "HARD_TAINT_EFFECTS",
    "node_selector_term_matches",
    "labels_match_selector",
    "selector_matches",
    "term_matches",
    "node_topology_domain",
    "check_node_validity",
    "unschedulable_reason_counts",
    "dominant_reason",
    "NODE_LOCAL_PREDICATES",
    "PREDICATE_CHAIN",
]


class InvalidNodeReason(enum.Enum):
    """Typed failure reason of the predicate chain."""

    NOT_ENOUGH_RESOURCES = "NotEnoughResources"
    NODE_SELECTOR_MISMATCH = "NodeSelectorMismatch"
    NODE_AFFINITY_MISMATCH = "NodeAffinityMismatch"
    NODE_UNSCHEDULABLE = "NodeUnschedulable"
    TAINT_NOT_TOLERATED = "TaintNotTolerated"
    ANTI_AFFINITY_VIOLATION = "AntiAffinityViolation"
    POD_AFFINITY_UNSATISFIED = "PodAffinityUnsatisfied"
    TOPOLOGY_SPREAD_VIOLATION = "TopologySpreadViolation"


def pod_fits_resources(pod: Pod, node: Node, snapshot: ClusterSnapshot) -> bool:
    """request ≤ allocatable − Σ bound-pod requests on every axis (a node
    without allocatable fits only zero-request pods)."""
    return total_pod_resources(pod).fits_in(node_net_available(snapshot, node))


def node_selector_matches(pod: Pod, node: Node, snapshot: ClusterSnapshot | None = None) -> bool:
    """Every nodeSelector key equals the node label exactly; a pod with no
    selector matches vacuously; a node with no labels fails any selector."""
    if pod.spec is None or not pod.spec.node_selector:
        return True
    labels = node.metadata.labels
    if not labels:
        return False
    return all(labels.get(k) == v for k, v in pod.spec.node_selector.items())


HARD_TAINT_EFFECTS = ("NoSchedule", "NoExecute")


def _expression_matches(r: LabelSelectorRequirement, labels: dict[str, str]) -> bool:
    if r.operator == "In":
        return r.key in labels and labels[r.key] in (r.values or [])
    if r.operator == "NotIn":
        return r.key not in labels or labels[r.key] not in (r.values or [])
    if r.operator == "Exists":
        return r.key in labels
    if r.operator == "DoesNotExist":
        return r.key not in labels
    return False  # unknown operator matches nothing (fail closed)


def _node_expression_matches(r: LabelSelectorRequirement, labels: dict[str, str]) -> bool:
    """Label-selector operators plus the numeric ``Gt``/``Lt`` (single
    integer value; a missing or non-integer label never matches)."""
    if r.operator in ("Gt", "Lt"):
        if r.key not in labels or not r.values:
            return False
        try:
            label_num = int(labels[r.key])
            want = int(r.values[0])
        except (TypeError, ValueError):
            return False
        return label_num > want if r.operator == "Gt" else label_num < want
    return _expression_matches(r, labels)


def node_selector_term_matches(term, labels: dict[str, str] | None) -> bool:
    """A nodeSelectorTerm matches iff every expression holds; a term with no
    expressions matches nothing."""
    exprs = term.match_expressions
    if not exprs:
        return False
    labels = labels or {}
    return all(_node_expression_matches(r, labels) for r in exprs)


def node_affinity_matches(pod: Pod, node: Node, snapshot: ClusterSnapshot | None = None) -> bool:
    """Required node affinity: terms are ORed; a pod without affinity
    matches vacuously."""
    terms = (pod.spec.node_affinity or []) if pod.spec is not None else []
    if not terms:
        return True
    labels = node.metadata.labels
    return any(node_selector_term_matches(t, labels) for t in terms)


def node_schedulable(pod: Pod, node: Node, snapshot: ClusterSnapshot | None = None) -> bool:
    """False iff the node is cordoned (``spec.unschedulable``)."""
    return not (node.spec is not None and node.spec.unschedulable)


def taints_tolerated(pod: Pod, node: Node, snapshot: ClusterSnapshot | None = None) -> bool:
    """Every NoSchedule/NoExecute taint of the node is tolerated by some
    toleration of the pod; PreferNoSchedule is soft and ignored here."""
    taints = (node.spec.taints or []) if node.spec is not None else []
    if not taints:
        return True
    tolerations = (pod.spec.tolerations or []) if pod.spec is not None else []
    for taint in taints:
        if taint.effect not in HARD_TAINT_EFFECTS:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def labels_match_selector(selector: dict[str, str] | None, labels: dict[str, str] | None) -> bool:
    """True iff ``labels`` carries every pair of ``selector``.  An empty or
    None selector matches nothing (the JAX package's documented deviation
    from the Kubernetes empty-selector-matches-all rule)."""
    if not selector or not labels:
        return False
    return all(labels.get(k) == v for k, v in selector.items())


def selector_matches(
    match_labels: dict[str, str] | None,
    match_expressions: Sequence[LabelSelectorRequirement] | None,
    labels: dict[str, str] | None,
) -> bool:
    """Full label-selector match: every ``match_labels`` pair AND every
    ``match_expressions`` requirement must hold; an entirely empty selector
    matches nothing."""
    if not match_labels and not match_expressions:
        return False
    if match_labels and not labels_match_selector(match_labels, labels):
        return False
    labels = labels or {}
    return all(_expression_matches(r, labels) for r in match_expressions or [])


def term_matches(term, labels: dict[str, str] | None) -> bool:
    """Selector match of an inter-pod term or spread constraint against a
    pod's labels (both carry ``match_labels`` + ``match_expressions``)."""
    return selector_matches(term.match_labels, getattr(term, "match_expressions", None), labels)


def node_topology_domain(node: Node, topology_key: str) -> tuple[str, str]:
    """The node's topology domain under ``topology_key``: ``(key, value)``
    when the node carries the label, else the singleton ``("~node", name)``
    (a keyless node degrades to per-node granularity)."""
    labels = node.metadata.labels or {}
    v = labels.get(topology_key)
    return (topology_key, v) if v is not None else ("~node", node.name)


def make_affinity_checker(
    pod: Pod,
    snapshot: ClusterSnapshot,
    extra_placed: Sequence[tuple[Pod, Node]] = (),
) -> Callable[[Node], bool]:
    """``pod``'s anti-affinity state as a set of blocked topology domains,
    returned as an O(#keys) per-node checker.  Enforced in both directions:
    (A) none of ``pod``'s terms may match a placed pod in the node's domain;
    (B) no placed pod in the node's domain may carry a term matching
    ``pod``.  Terms see only pods of the declaring pod's namespace;
    ``extra_placed`` overlays same-cycle commitments."""
    my_terms = (pod.spec.anti_affinity or []) if pod.spec is not None else []
    my_ns = pod.metadata.namespace
    blocked: set[tuple[str, str]] = set()
    keys: set[str] = set()
    if my_terms:
        for q, qnode in chain(snapshot.placed_pods(), extra_placed):
            if q.metadata.namespace != my_ns:
                continue
            for t in my_terms:
                if term_matches(t, q.metadata.labels):
                    blocked.add(node_topology_domain(qnode, t.topology_key))
                    keys.add(t.topology_key)
    carriers = chain(
        snapshot.placed_pods_with_terms(),
        ((q, qn) for q, qn in extra_placed if q.spec is not None and q.spec.anti_affinity),
    )
    for q, qnode in carriers:
        if q.metadata.namespace != my_ns:
            continue
        for t in q.spec.anti_affinity:
            if term_matches(t, pod.metadata.labels):
                blocked.add(node_topology_domain(qnode, t.topology_key))
                keys.add(t.topology_key)
    if not blocked:
        return lambda node: True
    return lambda node: all(node_topology_domain(node, k) not in blocked for k in keys)


def anti_affinity_ok(
    pod: Pod, node: Node, snapshot: ClusterSnapshot, extra_placed: Sequence[tuple[Pod, Node]] = ()
) -> bool:
    """Inter-pod anti-affinity: one-shot :func:`make_affinity_checker`."""
    return make_affinity_checker(pod, snapshot, extra_placed)(node)


def make_pod_affinity_checker(
    pod: Pod,
    snapshot: ClusterSnapshot,
    extra_placed: Sequence[tuple[Pod, Node]] = (),
    exclude: frozenset[str] = frozenset(),
) -> Callable[[Node], bool]:
    """Positive inter-pod affinity: for EVERY declared term the node's
    domain must hold a placed pod (same namespace) matched by the term.  A
    term that matches no placed pod anywhere is waived iff the pod matches
    its own term (the bootstrap rule); otherwise it fails everywhere.
    ``exclude`` drops placed pods by full name (preemption's re-check)."""
    my_terms = (pod.spec.pod_affinity or []) if pod.spec is not None else []
    if not my_terms:
        return lambda node: True
    my_ns = pod.metadata.namespace
    term_domains: list[set[tuple[str, str]] | None] = []
    for t in my_terms:
        doms: set[tuple[str, str]] = set()
        for q, qnode in chain(snapshot.placed_pods(), extra_placed):
            if exclude and full_name(q) in exclude:
                continue
            if q.metadata.namespace == my_ns and term_matches(t, q.metadata.labels):
                doms.add(node_topology_domain(qnode, t.topology_key))
        if doms:
            term_domains.append(doms)
        elif term_matches(t, pod.metadata.labels):
            term_domains.append(None)  # waived: self-match bootstrap
        else:
            return lambda node: False  # unmatchable, no self-match

    def check(node: Node) -> bool:
        for t, doms in zip(my_terms, term_domains):
            if doms is not None and node_topology_domain(node, t.topology_key) not in doms:
                return False
        return True

    return check


def pod_affinity_ok(
    pod: Pod, node: Node, snapshot: ClusterSnapshot, extra_placed: Sequence[tuple[Pod, Node]] = ()
) -> bool:
    """Positive inter-pod affinity: one-shot :func:`make_pod_affinity_checker`."""
    return make_pod_affinity_checker(pod, snapshot, extra_placed)(node)


def make_spread_checker(
    pod: Pod,
    snapshot: ClusterSnapshot,
    extra_placed: Sequence[tuple[Pod, Node]] = (),
    exclude: frozenset[str] = frozenset(),
) -> Callable[[Node], bool]:
    """Hard topology spread: per constraint, count the placed pods matching
    the selector (pod's namespace) per NAMED domain of the key; placing on
    a node must keep ``count(domain) + 1 − min(counts) ≤ max_skew``.  A
    node lacking the key is exempt; keyless nodes' pods enter no count."""
    constraints = [c for c in ((pod.spec.topology_spread or []) if pod.spec is not None else []) if c.is_hard]
    if not constraints:
        return lambda node: True
    my_ns = pod.metadata.namespace
    per_constraint: list[tuple[str, int, dict[str, int], int]] = []
    for c in constraints:
        counts: dict[str, int] = {}
        for n in snapshot.nodes:
            v = (n.metadata.labels or {}).get(c.topology_key)
            if v is not None:
                counts.setdefault(v, 0)
        for q, qnode in chain(snapshot.placed_pods(), extra_placed):
            if exclude and full_name(q) in exclude:
                continue
            v = (qnode.metadata.labels or {}).get(c.topology_key)
            if v is None or q.metadata.namespace != my_ns:
                continue
            if term_matches(c, q.metadata.labels):
                counts[v] = counts.get(v, 0) + 1
        per_constraint.append((c.topology_key, c.max_skew, counts, min(counts.values(), default=0)))

    def check(node: Node) -> bool:
        labels = node.metadata.labels or {}
        for key, max_skew, counts, lo in per_constraint:
            here = labels.get(key)
            if here is None:
                continue
            if counts.get(here, 0) + 1 - lo > max_skew:
                return False
        return True

    return check


def topology_spread_ok(
    pod: Pod, node: Node, snapshot: ClusterSnapshot, extra_placed: Sequence[tuple[Pod, Node]] = ()
) -> bool:
    """Hard topology spread: one-shot :func:`make_spread_checker`."""
    return make_spread_checker(pod, snapshot, extra_placed)(node)


# The pure (pod, node) predicates of the chain's middle, then the whole
# ordered chain: (reason on failure, predicate).
NODE_LOCAL_PREDICATES: list[tuple[InvalidNodeReason, Callable[[Pod, Node, ClusterSnapshot], bool]]] = [
    (InvalidNodeReason.NODE_SELECTOR_MISMATCH, node_selector_matches),
    (InvalidNodeReason.NODE_AFFINITY_MISMATCH, node_affinity_matches),
    (InvalidNodeReason.NODE_UNSCHEDULABLE, node_schedulable),
    (InvalidNodeReason.TAINT_NOT_TOLERATED, taints_tolerated),
]

PREDICATE_CHAIN: list[tuple[InvalidNodeReason, Callable[[Pod, Node, ClusterSnapshot], bool]]] = [
    (InvalidNodeReason.NOT_ENOUGH_RESOURCES, pod_fits_resources),
    *NODE_LOCAL_PREDICATES,
    (InvalidNodeReason.ANTI_AFFINITY_VIOLATION, anti_affinity_ok),
    (InvalidNodeReason.POD_AFFINITY_UNSATISFIED, pod_affinity_ok),
    (InvalidNodeReason.TOPOLOGY_SPREAD_VIOLATION, topology_spread_ok),
]


def check_node_validity(pod: Pod, node: Node, snapshot: ClusterSnapshot) -> InvalidNodeReason | None:
    """The first failing predicate of the chain, or None if the node is
    valid for the pod."""
    for reason, pred in PREDICATE_CHAIN:
        if not pred(pod, node, snapshot):
            return reason
    return None


def unschedulable_reason_counts(pod: Pod, snapshot: ClusterSnapshot) -> tuple[dict[str, int], int, int]:
    """Per-reason candidate-node rejection counts for one pod, each node
    charged to the FIRST failing predicate in chain order: (counts by
    reason value, feasible nodes, nodes in total)."""
    counts: dict[str, int] = {}
    feasible = 0
    for node in snapshot.nodes:
        reason = check_node_validity(pod, node, snapshot)
        if reason is None:
            feasible += 1
        else:
            counts[reason.value] = counts.get(reason.value, 0) + 1
    return counts, feasible, len(snapshot.nodes)


def dominant_reason(counts: dict[str, int], feasible: int) -> str:
    """The predicate that rejected the most nodes — or NotEnoughResources
    when some node WAS feasible against the pre-cycle snapshot (the
    capacity went to other pods of the same cycle)."""
    if feasible > 0 or not counts:
        return InvalidNodeReason.NOT_ENOUGH_RESOURCES.value
    return max(sorted(counts), key=lambda k: counts[k])
