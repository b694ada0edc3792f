"""Scalar predicates that packing evaluates on the host — copied from
``tpu_scheduler/core/predicates.py``: the hard taint effects and the
node-affinity term match (In/NotIn/Exists/DoesNotExist/Gt/Lt).  The rest of
the scalar predicate chain waits for the controller slice of the port."""

from __future__ import annotations

from ..api.objects import LabelSelectorRequirement

__all__ = ["HARD_TAINT_EFFECTS", "node_selector_term_matches"]

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
