"""Scalar predicates that packing evaluates on the host — copied from
``tpu_scheduler/core/predicates.py``: the hard taint effects, the
node-affinity term match (In/NotIn/Exists/DoesNotExist/Gt/Lt) and the
label-selector match of inter-pod terms and spread constraints, with the
topology-domain rule.  The rest of the scalar predicate chain waits for the
controller slice of the port."""

from __future__ import annotations

from typing import Sequence

from ..api.objects import LabelSelectorRequirement, Node

__all__ = [
    "HARD_TAINT_EFFECTS",
    "node_selector_term_matches",
    "labels_match_selector",
    "selector_matches",
    "term_matches",
    "node_topology_domain",
]

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
