"""The system under test, as the CLI daemon builds it, and the benchmark's
view of it.

The benchmark drives ``tpu_scheduler_torch.runtime.controller.Scheduler``
over ``backends.cuda.CudaBackend`` against an in-process API server, and
reads only what the program exposes: ``run_cycle``'s ``CycleMetrics``, the
flight recorder's span intervals, and the upload and launch counters.  This
is the module of the harness that imports the program (besides the
control's binding call); the reference imports none of it.
"""

from __future__ import annotations

import random
import time

from tpu_scheduler_torch.api.objects import (
    Container,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodSpec,
    PodStatus,
    ResourceRequirements,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from tpu_scheduler_torch.backends import cuda as cuda_backend
from tpu_scheduler_torch.models.profiles import PROFILES
from tpu_scheduler_torch.ops import choose
from tpu_scheduler_torch.runtime.controller import Scheduler
from tpu_scheduler_torch.runtime.fake_api import FakeApiServer
from tpu_scheduler_torch.utils.gc_tuning import enable_daemon_gc_tuning
from tpu_scheduler_torch.utils.metrics import CycleMetrics

from .cluster import Deployment, PodType, labels_of_node, pod_types

__all__ = ["FAULTS", "StampingApiServer", "counters", "enable_daemon_gc_tuning", "make_nodes", "make_pods",
           "make_scheduler"]

NAMESPACE = "default"

# The faults the harness can plant under the timed path (benchmark/tests):
# a cycle that leaves the cluster as it was, half of each solve's bindings
# left out, and each binding's node altered where the solve produces it (to
# the cluster's first node: a binding altered to another node that still
# fits is as valid an answer as the program's own).
FAULTS = ("unchanged", "half", "altered")


class StampingApiServer(FakeApiServer):
    """The in-process API server, logging every pod create, delete and
    accepted binding in the order the server applied them, each with the
    benchmark's clock.  ``log`` holds ``(op, pod, node, t)``: op "C" create
    (node set when created bound), "D" delete, "B" binding accepted, "M" a
    quiescent mark the harness adds."""

    def __init__(self, clock=time.perf_counter):
        super().__init__()
        self.stamp = clock
        self.log: list[tuple[str, str | None, str | None, float]] = []  # guarded-by: _lock
        self.bound_at: dict[str, float] = {}  # guarded-by: _lock

    def create_pod(self, pod: Pod) -> None:
        with self._lock:
            super().create_pod(pod)
            self.log.append(("C", pod.metadata.name, pod.spec.node_name, self.stamp()))

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            super().delete_pod(namespace, name)
            self.log.append(("D", name, None, self.stamp()))

    def create_binding(self, namespace: str, pod_name: str, target) -> None:
        with self._lock:
            super().create_binding(namespace, pod_name, target)
            t = self.stamp()
            self.bound_at[pod_name] = t
            self.log.append(("B", pod_name, target.name, t))

    def mark(self) -> None:
        with self._lock:
            self.log.append(("M", None, None, self.stamp()))

    def log_since(self, i: int) -> list:
        with self._lock:
            return self.log[i:]


def node_name(i: int) -> str:
    return f"node-{i}"


def make_nodes(dep: Deployment) -> list[Node]:
    """The deployment's nodes: allocatable CPU and memory, the hostname
    label the kubelet sets and the deployment's ``node_labels``."""
    return [Node(metadata=ObjectMeta(name=node_name(i), labels=labels_of_node(dep, i, node_name(i))),
                 status=NodeStatus(allocatable={"cpu": dep.node_cpu, "memory": dep.node_memory}))
            for i in range(dep.nodes)]


# The PodSpec field that holds each kind of term.
_TERM_FIELDS = {"anti_affinity": "anti_affinity", "affinity": "pod_affinity", "spread": "topology_spread",
                "preferred_affinity": "preferred_pod_affinity",
                "preferred_anti_affinity": "preferred_pod_anti_affinity"}


def _term_object(t):
    if t.kind == "spread":
        return TopologySpreadConstraint(topology_key=t.topology_key, max_skew=t.max_skew,
                                        match_labels=dict(t.selector),
                                        when_unsatisfiable="DoNotSchedule" if t.hard else "ScheduleAnyway")
    term = PodAffinityTerm(match_labels=dict(t.selector), topology_key=t.topology_key)
    return WeightedPodAffinityTerm(weight=t.weight, term=term) if t.kind.startswith("preferred") else term


def _pod(name: str, kind: PodType, node: str | None) -> Pod:
    """A pod of ``kind``: its labels, requests and inter-pod terms, each
    object of its own."""
    requests = {"cpu": kind.cpu, "memory": kind.memory}
    terms: dict[str, list] = {}
    for t in kind.terms:
        terms.setdefault(_TERM_FIELDS[t.kind], []).append(_term_object(t))
    return Pod(
        metadata=ObjectMeta(name=name, namespace=NAMESPACE, labels=dict(kind.labels) or None),
        spec=PodSpec(containers=[Container(name="pause", resources=ResourceRequirements(
            requests=dict(requests), limits=dict(requests)))], node_name=node, **terms),
        status=PodStatus(phase="Running" if node else "Pending"),
    )


def make_pods(dep: Deployment, names: list[str], nodes: list[str] | None = None, types=None) -> list[Pod]:
    """One API object per name, each of its own (as a client would send
    them), with the deployment's requests; bound to ``nodes[i]`` when
    given.  ``types``, when given, holds each pod's index into
    ``cluster.pod_types(dep)``: its labels, requests and terms."""
    if types is not None:
        kinds = pod_types(dep)
        return [_pod(name, kinds[types[i]], nodes[i] if nodes is not None else None) for i, name in enumerate(names)]
    out = []
    requests = {"cpu": dep.pod_cpu, "memory": dep.pod_memory}
    for i, name in enumerate(names):
        node = nodes[i] if nodes is not None else None
        out.append(Pod(
            metadata=ObjectMeta(name=name, namespace=NAMESPACE),
            spec=PodSpec(containers=[Container(name="pause", resources=ResourceRequirements(
                requests=dict(requests), limits=dict(requests)))], node_name=node),
            status=PodStatus(phase="Running" if node else "Pending"),
        ))
    return out


class FaultyBackend(cuda_backend.CudaBackend):
    """CudaBackend with a fault planted in what its solve returns."""

    def __init__(self, fault: str, **kw):
        super().__init__(**kw)
        self.fault = fault

    def schedule(self, packed, profile):
        result = super().schedule(packed, profile)
        if self.fault == "half":
            result.unschedulable = result.unschedulable + [p for p, _ in result.bindings[1::2]]
            result.bindings = result.bindings[::2]
        elif self.fault == "altered":
            first = packed.node_names[0]
            result.bindings = [(p, first) for p, _ in result.bindings]
        return result


def make_scheduler(api: FakeApiServer, dep: Deployment, seed: int, device: str = "cuda",
                   fault: str | None = None) -> Scheduler:
    """The Scheduler the CLI daemon builds for this deployment's settings:
    ``--profile``, the delta engine, ``--pipeline`` and ``--requeue-seconds``
    (the daemon's GC tuning is the run's first step, ``harness.run``)."""
    c = dep.controller
    backend = (FaultyBackend(fault, device=device) if fault in ("half", "altered")
               else cuda_backend.CudaBackend(device=device))
    sched = Scheduler(api, backend, profile=PROFILES[c["profile"]], pod_block=int(c["pod_block"]),
                      delta=bool(c["delta"]), pipeline=bool(c["pipeline"]),
                      requeue_seconds=float(c["requeue_seconds"]), rng=random.Random(seed))
    if fault == "unchanged":
        sched.run_cycle = lambda: CycleMetrics(cycle=0, backend=backend.name, pending=0, bound=0, unschedulable=0,
                                               rounds=0, wall_seconds=0.0)
    return sched


_LAUNCH_COUNTERS = ("LAUNCHES", "LAUNCHES_CONSTRAINED", "LAUNCHES_TOPO", "LAUNCHES_CONSTRAINED_TOPO")


def counters() -> dict:
    """The program's counters the per-layer metrics read: choose launches
    by kernel and upload bytes."""
    out = {name.lower(): getattr(choose, name) for name in _LAUNCH_COUNTERS}
    out["upload_bytes"] = cuda_backend.UPLOAD_BYTES
    return out
