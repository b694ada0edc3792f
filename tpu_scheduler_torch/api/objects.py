"""Kubernetes-shaped object model — the part of ``tpu_scheduler/api/objects.py``
that ``testing.synth_cluster`` and ``ops/pack.pack_snapshot`` touch, copied so
the port imports nothing of the JAX package.

Objects are plain dataclasses; the tensor path never touches them per pod.
The manifest serializers (``pod_to_dict``, ``node_to_dict``), ``Binding``,
``ObjectReference`` and ``PodDisruptionBudget`` are the controller's; the
manifest parsers (``Pod.from_dict``, ``Node.from_dict``) wait for the
controller slice of the port.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Mapping

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
    "PodDisruptionBudget",
    "ObjectReference",
    "Binding",
    "pod_to_dict",
    "node_to_dict",
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
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget, the subset preemption consults: a
    namespace-scoped label selector plus exactly one of ``min_available`` /
    ``max_unavailable`` (absolute counts; percentage strings fail CLOSED —
    zero disruptions allowed).  An empty or absent selector matches every
    pod in the namespace (policy/v1 semantics)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    match_labels: dict[str, str] | None = None
    match_expressions: list[LabelSelectorRequirement] | None = None
    min_available: int | None = None
    max_unavailable: int | None = None

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "PodDisruptionBudget":
        meta = d.get("metadata", {})
        spec = d.get("spec", {})
        sel = spec.get("selector") or {}
        exprs = sel.get("matchExpressions") or []
        return PodDisruptionBudget(
            metadata=ObjectMeta(name=meta.get("name", ""), namespace=meta.get("namespace")),
            match_labels=sel.get("matchLabels"),
            match_expressions=[
                LabelSelectorRequirement(key=e.get("key", ""), operator=e.get("operator", ""), values=e.get("values"))
                for e in exprs
            ]
            or None,
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
        )

    def to_dict(self) -> dict[str, Any]:
        sel: dict[str, Any] = {}
        if self.match_labels:
            sel["matchLabels"] = dict(self.match_labels)
        if self.match_expressions:
            sel["matchExpressions"] = [
                {"key": r.key, "operator": r.operator, **({"values": list(r.values)} if r.values else {})}
                for r in self.match_expressions
            ]
        spec: dict[str, Any] = {"selector": sel}
        if self.min_available is not None:
            spec["minAvailable"] = self.min_available
        if self.max_unavailable is not None:
            spec["maxUnavailable"] = self.max_unavailable
        meta: dict[str, Any] = {"name": self.metadata.name}
        if self.metadata.namespace is not None:
            meta["namespace"] = self.metadata.namespace
        return {"kind": "PodDisruptionBudget", "metadata": meta, "spec": spec}


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


def _selector_to_dict(match_labels, match_expressions) -> dict[str, Any] | None:
    sel: dict[str, Any] = {}
    if match_labels:
        sel["matchLabels"] = dict(match_labels)
    if match_expressions:
        sel["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, **({"values": list(e.values)} if e.values is not None else {})}
            for e in match_expressions
        ]
    return sel or None


def _term_to_dict(t) -> dict[str, Any]:
    term: dict[str, Any] = {"topologyKey": t.topology_key}
    sel = _selector_to_dict(t.match_labels, t.match_expressions)
    if sel:
        term["labelSelector"] = sel
    return term


def _affinity_to_dict(spec: PodSpec) -> dict[str, Any]:
    affinity: dict[str, Any] = {}
    if spec.anti_affinity:
        affinity["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term_to_dict(t) for t in spec.anti_affinity]
        }
    if spec.preferred_pod_anti_affinity:
        affinity.setdefault("podAntiAffinity", {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w.weight, "podAffinityTerm": _term_to_dict(w.term)} for w in spec.preferred_pod_anti_affinity
        ]
    if spec.pod_affinity:
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term_to_dict(t) for t in spec.pod_affinity]
        }
    if spec.preferred_pod_affinity:
        affinity.setdefault("podAffinity", {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w.weight, "podAffinityTerm": _term_to_dict(w.term)} for w in spec.preferred_pod_affinity
        ]
    if spec.node_affinity or spec.preferred_node_affinity:
        node_affinity: dict[str, Any] = {}
        if spec.node_affinity:
            node_affinity["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [_selector_to_dict(None, t.match_expressions) or {} for t in spec.node_affinity]
            }
        if spec.preferred_node_affinity:
            node_affinity["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": t.weight, "preference": _selector_to_dict(None, t.term.match_expressions) or {}}
                for t in spec.preferred_node_affinity
            ]
        affinity["nodeAffinity"] = node_affinity
    return affinity


def pod_to_dict(pod: Pod) -> dict[str, Any]:
    """Serialize to the k8s-manifest shape (the REST wire format): lossless
    for every field the scheduler reads."""
    meta: dict[str, Any] = {"name": pod.metadata.name, "uid": pod.metadata.uid}
    if pod.metadata.namespace is not None:
        meta["namespace"] = pod.metadata.namespace
    if pod.metadata.labels:
        meta["labels"] = dict(pod.metadata.labels)
    if pod.metadata.resource_version:
        meta["resourceVersion"] = str(pod.metadata.resource_version)
    out: dict[str, Any] = {"kind": "Pod", "metadata": meta, "status": {"phase": pod.status.phase}}
    if pod.spec is None:
        return out
    containers = []
    for c in pod.spec.containers:
        entry: dict[str, Any] = {"name": c.name}
        if c.resources is not None:
            entry["resources"] = {
                k: v for k, v in (("requests", c.resources.requests), ("limits", c.resources.limits)) if v is not None
            }
        containers.append(entry)
    spec: dict[str, Any] = {"containers": containers}
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.node_name is not None:
        spec["nodeName"] = pod.spec.node_name
    if pod.spec.priority:
        spec["priority"] = pod.spec.priority
    if pod.spec.gang:
        spec["schedulingGang"] = pod.spec.gang
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {
                **({"key": t.key} if t.key else {}),
                "operator": t.operator,
                **({"value": t.value} if t.value else {}),
                **({"effect": t.effect} if t.effect else {}),
                **({"tolerationSeconds": t.toleration_seconds} if t.toleration_seconds is not None else {}),
            }
            for t in pod.spec.tolerations
        ]
    affinity = _affinity_to_dict(pod.spec)
    if affinity:
        spec["affinity"] = affinity
    if pod.spec.topology_spread:
        constraints = []
        for c in pod.spec.topology_spread:
            constraint: dict[str, Any] = {
                "topologyKey": c.topology_key,
                "maxSkew": c.max_skew,
                "whenUnsatisfiable": c.when_unsatisfiable,
            }
            sel = _selector_to_dict(c.match_labels, c.match_expressions)
            if sel:
                constraint["labelSelector"] = sel
            constraints.append(constraint)
        spec["topologySpreadConstraints"] = constraints
    out["spec"] = spec
    return out


def node_to_dict(node: Node) -> dict[str, Any]:
    """Serialize to the k8s-manifest shape."""
    meta: dict[str, Any] = {"name": node.metadata.name, "uid": node.metadata.uid}
    if node.metadata.labels:
        meta["labels"] = dict(node.metadata.labels)
    if node.metadata.resource_version:
        meta["resourceVersion"] = str(node.metadata.resource_version)
    out: dict[str, Any] = {"kind": "Node", "metadata": meta}
    if node.status is not None and node.status.allocatable is not None:
        out["status"] = {"allocatable": dict(node.status.allocatable)}
    if node.spec is not None:
        spec: dict[str, Any] = {}
        if node.spec.taints:
            spec["taints"] = [{"key": t.key, "value": t.value, "effect": t.effect} for t in node.spec.taints]
        if node.spec.unschedulable:
            spec["unschedulable"] = True
        if spec:
            out["spec"] = spec
    return out


@dataclass
class ObjectReference:
    name: str | None = None
    kind: str = "Node"


@dataclass
class Binding:
    """Pod→node binding: the Binding subresource a scheduler POSTs."""

    metadata: ObjectMeta
    target: ObjectReference


@dataclass
class PodResources:
    """(cpu millicores, memory bytes) plus countable EXTENDED resources
    (``google.com/tpu: 4``, ``nvidia.com/gpu: 8``, hugepages).  ``extended``
    is None whenever no extended resource is present."""

    cpu: int = 0  # millicores
    memory: int = 0  # bytes
    extended: dict[str, int] | None = None  # resource name -> integer count

    def copy(self) -> "PodResources":
        """Independent copy: the snapshot's memos hand these out so callers
        can keep mutating with += / -=."""
        return PodResources(self.cpu, self.memory, dict(self.extended) if self.extended else None)

    def _ext_add(self, other: "PodResources", sign: int) -> None:
        if other.extended:
            if self.extended is None:
                self.extended = {}
            for k, v in other.extended.items():
                self.extended[k] = self.extended.get(k, 0) + sign * v

    def __isub__(self, other: "PodResources") -> "PodResources":
        self.cpu -= other.cpu
        self.memory -= other.memory
        self._ext_add(other, -1)
        return self

    def __iadd__(self, other: "PodResources") -> "PodResources":
        self.cpu += other.cpu
        self.memory += other.memory
        self._ext_add(other, +1)
        return self

    def fits_in(self, avail: "PodResources") -> bool:
        """request ≤ available on EVERY axis (an extended request against a
        node lacking the resource fails — device-plugin semantics)."""
        if self.cpu > avail.cpu or self.memory > avail.memory:
            return False
        if self.extended:
            a = avail.extended or {}
            for k, v in self.extended.items():
                if v > a.get(k, 0):
                    return False
        return True


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
