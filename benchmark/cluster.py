"""The benchmark's own generator: a deployment and its traffic drawn from a seed.

Everything here is plain data (Python and NumPy) and imports nothing of the
program, so the plain reference and the program are handed the same inputs.
A deployment file (``configs/<name>.json``) fixes the node and pod shapes
and the controller settings; a traffic file (``traffic/<name>.json``) fixes
the population and the waves.  Every seed places the same pods a node at
the start, in another order.

Two optional keys of a deployment file describe a cluster whose pods differ
from one another (without them every node carries only its hostname label
and every pod is the plain ``pod``):

* ``node_labels``: ``{label key: [values]}``; node ``i`` carries the
  ``i % len(values)``-th value of each key, beside its hostname.
* ``pod_kinds``: a list of ``{"name", "share", "deployments", "requests"?,
  "terms"}``.  ``share`` of each wave's pods belong to the kind (the rest
  are plain); the kind's ``i``-th pod carries the label ``app:
  <name>-<i % deployments>``, and each of its terms selects that label, its
  own Deployment's.  ``requests`` (``{"cpu", "memory"}``) default to the
  plain pod's.  ``terms`` maps a term kind (``TERM_KINDS``) to one term or a
  list of them: ``anti_affinity`` and ``affinity`` (required) take
  ``topology_key``; ``preferred_affinity`` and ``preferred_anti_affinity``
  also ``weight``; ``spread`` takes ``topology_key``, ``max_skew`` and
  ``when_unsatisfiable`` (``DoNotSchedule`` or ``ScheduleAnyway``).

Which pod of a wave is of which kind is drawn from the seed: every seed
gives the same count of each kind, in another order.  The pods bound at the
start are plain.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Deployment",
    "HOSTNAME_KEY",
    "PodType",
    "TERM_KINDS",
    "Term",
    "base_placement",
    "cpu_milli",
    "load_deployment",
    "load_traffic",
    "mem_bytes",
    "labels_of_node",
    "pod_types",
    "rng_for",
    "type_rows",
]

HOSTNAME_KEY = "kubernetes.io/hostname"
# The inter-pod term kinds a pod kind may carry.
TERM_KINDS = ("anti_affinity", "affinity", "spread", "preferred_affinity", "preferred_anti_affinity")
_SPREAD_MODES = {"DoNotSchedule": True, "ScheduleAnyway": False}

_BIN = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40}


def cpu_milli(q: str) -> int:
    """A Kubernetes CPU quantity ("100m", "4") in millicores."""
    q = str(q)
    return int(q[:-1]) if q.endswith("m") else int(float(q) * 1000)


def mem_bytes(q: str) -> int:
    """A Kubernetes memory quantity ("500Mi", "32Gi", "1024") in bytes."""
    q = str(q)
    for suffix, mult in _BIN.items():
        if q.endswith(suffix):
            return int(q[: -len(suffix)]) * mult
    return int(q)


@dataclass(frozen=True)
class Term:
    """One inter-pod term: ``kind`` (``TERM_KINDS``), the topology key, the
    selector's ``matchLabels`` as sorted (key, value) pairs, a preferred
    term's ``weight``, a spread's ``max_skew``; ``hard`` for the required
    terms and a ``DoNotSchedule`` spread."""

    kind: str
    topology_key: str
    selector: tuple[tuple[str, str], ...]
    weight: int = 0
    max_skew: int = 1
    hard: bool = True


@dataclass(frozen=True)
class PodType:
    """What the pods of one kind and Deployment share: labels, requests
    (quantity strings) and terms."""

    labels: tuple[tuple[str, str], ...]
    cpu: str
    memory: str
    terms: tuple[Term, ...] = ()


@dataclass(frozen=True)
class PodKind:
    """A ``pod_kinds`` entry, parsed; its terms select ``app: <name>-<j>``."""

    name: str
    share: float
    deployments: int
    cpu: str
    memory: str
    terms: tuple[dict, ...]

    def term(self, spec: dict, app: str) -> Term:
        kind = spec["kind"]
        hard = _SPREAD_MODES[spec["when_unsatisfiable"]] if kind == "spread" else not kind.startswith("preferred")
        return Term(kind, spec["topology_key"], (("app", app),), int(spec.get("weight", 0)),
                    int(spec.get("max_skew", 1)), hard)


@dataclass(frozen=True)
class Deployment:
    """A configuration file, parsed: the cluster's nodes, the pod shape and
    the controller settings; the nodes' extra labels and the pod kinds,
    empty for a cluster of plain pods."""

    name: str
    nodes: int
    node_cpu: str
    node_memory: str
    pod_cpu: str
    pod_memory: str
    controller: dict
    raw: dict
    node_labels: dict = field(default_factory=dict)
    kinds: tuple[PodKind, ...] = ()


def _parse_kind(raw: dict, dep_raw: dict, label_keys) -> PodKind:
    requests = raw.get("requests", dep_raw["pod"])
    terms = []
    for kind, specs in raw["terms"].items():
        if kind not in TERM_KINDS:
            raise ValueError(f"pod kind {raw['name']!r}: unknown term {kind!r} (have {TERM_KINDS})")
        for spec in [specs] if isinstance(specs, dict) else specs:
            spec = {**spec, "kind": kind}
            if spec["topology_key"] not in label_keys:
                raise ValueError(f"pod kind {raw['name']!r}: no node carries {spec['topology_key']!r}")
            if kind == "spread" and spec["when_unsatisfiable"] not in _SPREAD_MODES:
                raise ValueError(f"pod kind {raw['name']!r}: when_unsatisfiable must be one of {sorted(_SPREAD_MODES)}")
            terms.append(spec)
    return PodKind(raw["name"], float(raw["share"]), int(raw["deployments"]), requests["cpu"], requests["memory"],
                   tuple(terms))


def load_deployment(path: str | pathlib.Path) -> Deployment:
    raw = json.loads(pathlib.Path(path).read_text())
    node_labels = {key: list(values) for key, values in raw.get("node_labels", {}).items()}
    kinds = tuple(_parse_kind(k, raw, {HOSTNAME_KEY, *node_labels}) for k in raw.get("pod_kinds", ()))
    if sum(k.share for k in kinds) > 1.0:
        raise ValueError(f"{path}: the pod kinds' shares add up to more than 1")
    return Deployment(
        name=raw["name"], nodes=int(raw["nodes"]), node_cpu=raw["node"]["cpu"], node_memory=raw["node"]["memory"],
        pod_cpu=raw["pod"]["cpu"], pod_memory=raw["pod"]["memory"], controller=dict(raw["controller"]), raw=raw,
        node_labels=node_labels, kinds=kinds,
    )


def labels_of_node(dep: Deployment, i: int, name: str) -> dict[str, str]:
    """Node ``i``'s labels: its hostname, and each ``node_labels`` key's
    value dealt to it."""
    return {HOSTNAME_KEY: name, **{key: values[i % len(values)] for key, values in dep.node_labels.items()}}


def pod_types(dep: Deployment) -> list[PodType]:
    """Index 0 is the plain pod; then each kind's Deployments in order."""
    out = [PodType((), dep.pod_cpu, dep.pod_memory)]
    for kind in dep.kinds:
        for j in range(kind.deployments):
            app = f"{kind.name}-{j}"
            out.append(PodType((("app", app),), kind.cpu, kind.memory,
                               tuple(kind.term(spec, app) for spec in kind.terms)))
    return out


def type_rows(dep: Deployment, n: int, rng: np.random.Generator) -> np.ndarray:
    """Index into ``pod_types(dep)`` of each of ``n`` pods: ``floor(share *
    n)`` of each kind, its Deployments in turn, the rest plain, in an order
    drawn from ``rng``."""
    rows = np.zeros(n, dtype=np.int32)
    at, first = 0, 1
    for kind in dep.kinds:
        count = int(kind.share * n + 1e-9)  # 0.1 * 6000 reads 600.0000000000001
        rows[at:at + count] = first + np.arange(count) % kind.deployments
        at, first = at + count, first + kind.deployments
    return rows[rng.permutation(n)]


def load_traffic(path: str | pathlib.Path) -> dict:
    raw = json.loads(pathlib.Path(path).read_text())
    if raw.get("loop") != "waves":
        raise ValueError(f"{path}: loop must be 'waves'")
    return raw


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, from any whole-number seed."""
    return np.random.default_rng([seed % (1 << 64), *stream.encode()])


def base_placement(n_pods: int, n_nodes: int, rng: np.random.Generator) -> np.ndarray:
    """Node index of each pod bound at the start: every node gets the same
    count (to within one), in an order drawn from ``rng``."""
    return (rng.permutation(n_pods) % n_nodes).astype(np.int32)
