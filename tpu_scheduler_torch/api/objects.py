"""Kubernetes-shaped object model — the part of ``tpu_scheduler/api/objects.py``
that ``testing.synth_cluster`` and ``ops/pack.pack_snapshot`` touch, copied so
the port imports nothing of the JAX package.

Objects are plain dataclasses; the tensor path never touches them per pod.
The manifest (de)serializers, Binding and PodDisruptionBudget wait for the
controller slice of the port.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

from .quantity import cpu_to_millis, memory_to_bytes

__all__ = [
    "ObjectMeta",
    "ResourceRequirements",
    "Container",
    "LabelSelectorRequirement",
    "PodAntiAffinityTerm",
    "PodAffinityTerm",
    "WeightedPodAffinityTerm",
    "TopologySpreadConstraint",
    "NodeSelectorTerm",
    "PodSpec",
    "PodStatus",
    "Pod",
    "Taint",
    "Toleration",
    "PreferredSchedulingTerm",
    "NodeStatus",
    "NodeSpec",
    "Node",
    "PodResources",
    "total_pod_resources",
    "is_extended_resource",
    "is_pod_bound",
    "full_name",
]

_uid_counter = itertools.count(1)


def _next_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str | None = None
    labels: dict[str, str] | None = None
    uid: str = field(default_factory=_next_uid)
    resource_version: int | str = 0


@dataclass
class ResourceRequirements:
    # Quantity strings ("500m", "2Gi") or numbers, keyed by resource name.
    requests: dict[str, Any] | None = None
    limits: dict[str, Any] | None = None


@dataclass
class Container:
    name: str = ""
    resources: ResourceRequirements | None = None


@dataclass
class LabelSelectorRequirement:
    """One ``matchExpressions`` entry: ``In`` / ``NotIn`` / ``Exists`` /
    ``DoesNotExist`` (plus ``Gt``/``Lt`` in node affinity)."""

    key: str
    operator: str
    values: list[str] | None = None


@dataclass
class PodAntiAffinityTerm:
    """Required inter-pod (anti-)affinity term.  Carried by the objects so
    ``synth_cluster`` builds the same pods as the JAX package; the port's
    cycle does not evaluate inter-pod terms yet (constrained slice)."""

    match_labels: dict[str, str] | None = None
    topology_key: str = "kubernetes.io/hostname"
    match_expressions: list[LabelSelectorRequirement] | None = None


PodAffinityTerm = PodAntiAffinityTerm


@dataclass
class WeightedPodAffinityTerm:
    """One preferred inter-pod (anti-)affinity entry (weight 1-100)."""

    weight: int
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class TopologySpreadConstraint:
    """Topology-spread constraint (hard ``DoNotSchedule`` or soft
    ``ScheduleAnyway``); carried, not evaluated, in this slice."""

    topology_key: str
    max_skew: int = 1
    match_labels: dict[str, str] | None = None
    match_expressions: list[LabelSelectorRequirement] | None = None
    when_unsatisfiable: str = "DoNotSchedule"

    @property
    def is_hard(self) -> bool:
        return self.when_unsatisfiable != "ScheduleAnyway"


@dataclass
class NodeSelectorTerm:
    """One nodeSelectorTerms entry of required node affinity: expressions
    ANDed, terms in a list ORed.  A term with no expressions matches
    nothing."""

    match_expressions: list[LabelSelectorRequirement] | None = None

    def key(self) -> tuple:
        """Canonical hashable form — the affinity-term vocabulary key.
        In/NotIn values are sets, so their order is canonicalized; Gt/Lt
        values stay positional."""

        def vals(r):
            v = tuple(r.values or ())
            return tuple(sorted(v)) if r.operator in ("In", "NotIn") else v

        return tuple(sorted((r.key, r.operator, vals(r)) for r in self.match_expressions or []))


@dataclass
class Taint:
    """Node taint.  NoSchedule and NoExecute are hard filters;
    PreferNoSchedule is soft (scored)."""

    key: str
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class Toleration:
    """Pod toleration (k8s semantics): matches a taint iff the key matches
    (empty key + Exists tolerates everything), the operator is Exists or
    Equal with an equal value, and the effect matches (empty matches any)."""

    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""
    toleration_seconds: int | None = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.operator == "Equal" and self.value == taint.value


@dataclass
class PreferredSchedulingTerm:
    """One preferred node-affinity entry: nodes matching ``term`` gain
    ``weight`` (1-100) score points, scaled by the profile."""

    weight: int
    term: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    node_selector: dict[str, str] | None = None
    node_name: str | None = None
    priority: int = 0
    anti_affinity: list[PodAntiAffinityTerm] | None = None
    pod_affinity: list[PodAntiAffinityTerm] | None = None
    preferred_pod_affinity: list[WeightedPodAffinityTerm] | None = None
    preferred_pod_anti_affinity: list[WeightedPodAffinityTerm] | None = None
    topology_spread: list[TopologySpreadConstraint] | None = None
    tolerations: list[Toleration] | None = None
    node_affinity: list[NodeSelectorTerm] | None = None  # required terms, ORed
    preferred_node_affinity: list[PreferredSchedulingTerm] | None = None  # soft, weighted
    gang: str | None = None


@dataclass
class PodStatus:
    phase: str = "Pending"


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec | None = None
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class NodeStatus:
    # Quantity strings/numbers keyed by resource name ("cpu", "memory").
    allocatable: dict[str, Any] | None = None


@dataclass
class NodeSpec:
    taints: list[Taint] | None = None
    unschedulable: bool = False  # kubectl cordon


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: NodeStatus | None = None
    spec: NodeSpec | None = None

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodResources:
    """(cpu millicores, memory bytes) plus countable EXTENDED resources
    (``google.com/tpu: 4``, ``nvidia.com/gpu: 8``, hugepages).  ``extended``
    is None whenever no extended resource is present."""

    cpu: int = 0  # millicores
    memory: int = 0  # bytes
    extended: dict[str, int] | None = None  # resource name -> integer count


def is_extended_resource(name: str) -> bool:
    """Kube's IsExtendedResourceName: domain-qualified names outside the
    kubernetes.io domain, plus hugepages-*."""
    if name.startswith("hugepages-"):
        return True
    if "/" not in name:
        return False
    domain = name.split("/", 1)[0]
    return not (domain == "kubernetes.io" or domain.endswith(".kubernetes.io"))


def total_pod_resources(pod: Pod) -> PodResources:
    """Sum container *requests*: cpu, memory, and each extended resource as
    an exact integer.  Other names are ignored."""
    out = PodResources()
    if pod.spec is None:
        return out
    for c in pod.spec.containers:
        if c.resources is None or c.resources.requests is None:
            continue
        for name, q in c.resources.requests.items():
            if name == "cpu":
                out.cpu += cpu_to_millis(q)
            elif name == "memory":
                out.memory += memory_to_bytes(q)
            elif is_extended_resource(name):
                if out.extended is None:
                    out.extended = {}
                out.extended[name] = out.extended.get(name, 0) + memory_to_bytes(q)
    return out


def is_pod_bound(pod: Pod) -> bool:
    """True iff ``spec.nodeName`` is set."""
    return pod.spec is not None and pod.spec.node_name is not None


def full_name(obj: Pod | Node) -> str:
    """"namespace/name" or bare name."""
    if obj.metadata.namespace:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"
    return obj.metadata.name
