"""Synthetic cluster generation — copy of ``tpu_scheduler/testing.py``
(``synth_cluster`` and its node/pod builders).  Deterministic via an
explicit seed: the same seed and fractions draw the same random sequence as
the JAX package, so both packages build identical clusters.
"""

from __future__ import annotations

import random

from .api.objects import (
    Container,
    LabelSelectorRequirement,
    Node,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAntiAffinityTerm,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from .core.snapshot import ClusterSnapshot

__all__ = ["make_node", "make_pod", "synth_cluster"]

# Node shapes roughly covering a heterogeneous fleet (cpu cores, memory GiB).
_NODE_SHAPES = [(4, 16), (8, 32), (16, 64), (32, 128), (64, 256)]
# Zone labels for selector / topology-spread exercises.
_ZONES = ["zone-a", "zone-b", "zone-c", "zone-d"]
_POOLS = ["default", "compute", "memory-optimized"]


def make_node(
    name: str,
    cpu: str | int = "8",
    memory: str | int = "32Gi",
    labels: dict[str, str] | None = None,
    taints: list[Taint] | None = None,
    unschedulable: bool = False,
    extended: dict[str, str | int] | None = None,
) -> Node:
    spec = NodeSpec(taints=taints, unschedulable=unschedulable) if (taints or unschedulable) else None
    return Node(
        metadata=ObjectMeta(name=name, labels=labels),
        status=NodeStatus(allocatable={"cpu": cpu, "memory": memory, **(extended or {})}),
        spec=spec,
    )


def make_pod(
    name: str,
    namespace: str = "default",
    cpu: str | int = "500m",
    memory: str | int = "1Gi",
    node_selector: dict[str, str] | None = None,
    node_name: str | None = None,
    phase: str = "Pending",
    priority: int = 0,
    labels: dict[str, str] | None = None,
    extended: dict[str, str | int] | None = None,
    anti_affinity: list[PodAntiAffinityTerm] | None = None,
    pod_affinity: list[PodAntiAffinityTerm] | None = None,
    preferred_pod_affinity: list | None = None,
    preferred_pod_anti_affinity: list | None = None,
    topology_spread: list[TopologySpreadConstraint] | None = None,
    tolerations: list[Toleration] | None = None,
    node_affinity: list[NodeSelectorTerm] | None = None,
    preferred_node_affinity: list[PreferredSchedulingTerm] | None = None,
    gang: str | None = None,
) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, namespace=namespace, labels=labels),
        spec=PodSpec(
            containers=[
                Container(
                    name="main",
                    resources=ResourceRequirements(requests={"cpu": cpu, "memory": memory, **(extended or {})}),
                )
            ],
            node_selector=node_selector,
            node_name=node_name,
            priority=priority,
            anti_affinity=anti_affinity,
            pod_affinity=pod_affinity,
            preferred_pod_affinity=preferred_pod_affinity,
            preferred_pod_anti_affinity=preferred_pod_anti_affinity,
            topology_spread=topology_spread,
            tolerations=tolerations,
            node_affinity=node_affinity,
            preferred_node_affinity=preferred_node_affinity,
            gang=gang,
        ),
        status=PodStatus(phase=phase),
    )


def synth_cluster(
    n_nodes: int,
    n_pending: int,
    n_bound: int = 0,
    seed: int = 0,
    selector_fraction: float = 0.2,
    multi_container_fraction: float = 0.1,
    anti_affinity_fraction: float = 0.0,
    spread_fraction: float = 0.0,
    tainted_fraction: float = 0.0,
    cordoned_fraction: float = 0.0,
    node_affinity_fraction: float = 0.0,
    soft_taint_fraction: float = 0.0,
    preferred_affinity_fraction: float = 0.0,
    schedule_anyway_fraction: float = 0.0,
    gang_fraction: float = 0.0,
    pod_affinity_fraction: float = 0.0,
    preferred_pod_affinity_fraction: float = 0.0,
    extended_fraction: float = 0.0,
) -> ClusterSnapshot:
    """Generate a synthetic cluster snapshot.

    ``selector_fraction`` of pending pods carry a nodeSelector on the zone or
    pool labels; ``multi_container_fraction`` get a second container so the
    request-summation path (reference ``util.rs:54-75``) is exercised.
    Bound pods are spread round-robin over nodes so resource-fit sees
    realistic partially-full nodes.  ``anti_affinity_fraction`` of pending
    pods declare self-anti-affinity (against their own ``app`` label) on the
    hostname-like ``name`` key; ``spread_fraction`` declare a hard zone
    topology-spread constraint over their ``app`` label (config 5 shapes).
    ``tainted_fraction`` of nodes carry a NoSchedule pool taint which the
    pods destined for that pool tolerate; ``cordoned_fraction`` are
    cordoned (spec.unschedulable).  ``node_affinity_fraction`` of pending
    pods carry required node affinity exercising every operator (In/NotIn/
    Exists/DoesNotExist/Gt/Lt over zone/pool/slot labels, ORed terms).

    Soft (scoring) terms: ``soft_taint_fraction`` of nodes carry a
    PreferNoSchedule taint (half the pods tolerate it);
    ``preferred_affinity_fraction`` of pending pods declare weighted
    preferredDuringScheduling zone/pool terms; ``schedule_anyway_fraction``
    declare a ScheduleAnyway (soft) zone topology-spread constraint.

    ``gang_fraction`` of pending pods join all-or-nothing gangs of 2-4
    consecutive pods (coscheduling; the TPU training-job shape).

    ``pod_affinity_fraction`` of pending pods declare POSITIVE inter-pod
    affinity: self-affine co-location groups (the term matches the pod's own
    ``pa-group`` label over the zone key), so the first member exercises the
    bootstrap waiver and later members must follow it into its zone.

    ``preferred_pod_affinity_fraction`` declare SOFT inter-pod terms: a
    weighted preference to co-locate with their own soft group over the
    zone key, and (30% of them) a weighted anti-preference against another
    group — the signed-weight scoring path (ops/score.py ppa matmul).

    ``extended_fraction``: that fraction of pending pods request
    ``example.com/tpu`` chips (1-4); every 'compute' pool node exposes 8 —
    the device-plugin resource axis (R > 2 tensors end to end).
    """
    rng = random.Random(seed)
    if n_nodes == 0:
        n_bound = 0  # bound pods need a node to be bound to
    nodes = []
    for i in range(n_nodes):
        cores, gib = _NODE_SHAPES[i % len(_NODE_SHAPES)]
        pool = _POOLS[i % len(_POOLS)]
        labels = {
            "zone": _ZONES[i % len(_ZONES)],
            "pool": pool,
            "name": f"node-{i}",
            "slot": str(i % 16),  # numeric label for Gt/Lt affinity
        }
        taints = [Taint(key="pool", value=pool, effect="NoSchedule")] if rng.random() < tainted_fraction else None
        if soft_taint_fraction and rng.random() < soft_taint_fraction:
            soft = Taint(key="degraded", value=_ZONES[i % len(_ZONES)], effect="PreferNoSchedule")
            taints = (taints or []) + [soft]
        cordoned = rng.random() < cordoned_fraction
        ext_alloc = {"example.com/tpu": "8"} if extended_fraction and pool == "compute" else None
        nodes.append(
            make_node(
                f"node-{i}", cpu=cores, memory=f"{gib}Gi", labels=labels, taints=taints,
                unschedulable=cordoned, extended=ext_alloc,
            )
        )

    pods: list[Pod] = []
    for i in range(n_bound):
        node = f"node-{i % n_nodes}"
        pods.append(
            make_pod(
                f"bound-{i}",
                cpu=f"{rng.choice([100, 250, 500, 1000])}m",
                memory=f"{rng.choice([256, 512, 1024, 2048])}Mi",
                node_name=node,
                phase="Running",
            )
        )
    gang_name = None
    gang_left = 0
    for i in range(n_pending):
        gang = None
        if gang_left > 0:
            gang, gang_left = gang_name, gang_left - 1
        elif gang_fraction and rng.random() < gang_fraction:
            gang_name = f"gang-{i}"
            gang, gang_left = gang_name, rng.randrange(1, 4)  # 2-4 members total
        selector = None
        if rng.random() < selector_fraction:
            if rng.random() < 0.5:
                selector = {"zone": rng.choice(_ZONES)}
            else:
                selector = {"pool": rng.choice(_POOLS)}
        app = f"app-{rng.randrange(0, 50)}"
        anti = None
        if rng.random() < anti_affinity_fraction:
            anti = [PodAntiAffinityTerm(match_labels={"app": app}, topology_key="name")]
        pod_aff = None
        pa_label = None
        if pod_affinity_fraction and rng.random() < pod_affinity_fraction:
            pa_label = f"pa-group-{rng.randrange(0, 8)}"
            pod_aff = [PodAntiAffinityTerm(match_labels={"pa": pa_label}, topology_key="zone")]
        pref_pod_aff = pref_pod_anti = None
        sg_label = None
        if preferred_pod_affinity_fraction and rng.random() < preferred_pod_affinity_fraction:
            sg = rng.randrange(0, 6)
            sg_label = f"soft-g{sg}"
            pref_pod_aff = [
                WeightedPodAffinityTerm(
                    weight=rng.choice([10, 50, 100]),
                    term=PodAntiAffinityTerm(match_labels={"sg": sg_label}, topology_key="zone"),
                )
            ]
            if rng.random() < 0.3:
                other = f"soft-g{(sg + 1) % 6}"
                pref_pod_anti = [
                    WeightedPodAffinityTerm(
                        weight=rng.choice([10, 50]),
                        term=PodAntiAffinityTerm(match_labels={"sg": other}, topology_key="zone"),
                    )
                ]
        spread = None
        if rng.random() < spread_fraction:
            spread = [TopologySpreadConstraint(topology_key="zone", max_skew=rng.choice([1, 2]), match_labels={"app": app})]
        if schedule_anyway_fraction and rng.random() < schedule_anyway_fraction:
            soft_c = TopologySpreadConstraint(
                topology_key="zone",
                max_skew=rng.choice([1, 2]),
                match_labels={"app": app},
                when_unsatisfiable="ScheduleAnyway",
            )
            spread = (spread or []) + [soft_c]
        node_aff = None
        if rng.random() < node_affinity_fraction:
            choice = rng.randrange(5)
            if choice == 0:
                exprs = [LabelSelectorRequirement(key="zone", operator="In", values=rng.sample(_ZONES, 2))]
            elif choice == 1:
                exprs = [LabelSelectorRequirement(key="pool", operator="NotIn", values=[rng.choice(_POOLS)])]
            elif choice == 2:
                exprs = [LabelSelectorRequirement(key="slot", operator="Gt", values=[str(rng.randrange(12))])]
            elif choice == 3:
                exprs = [
                    LabelSelectorRequirement(key="slot", operator="Lt", values=[str(rng.randrange(4, 16))]),
                    LabelSelectorRequirement(key="zone", operator="Exists"),
                ]
            else:
                exprs = [LabelSelectorRequirement(key="missing-key", operator="DoesNotExist")]
            terms = [NodeSelectorTerm(match_expressions=exprs)]
            if rng.random() < 0.3:  # second ORed term
                terms.append(
                    NodeSelectorTerm(
                        match_expressions=[
                            LabelSelectorRequirement(key="zone", operator="In", values=[rng.choice(_ZONES)])
                        ]
                    )
                )
            node_aff = terms
        tols = None
        if tainted_fraction and rng.random() < 0.5:
            # Half the pods tolerate one pool's taint (Equal) or all taints (Exists).
            if rng.random() < 0.3:
                tols = [Toleration(operator="Exists")]
            else:
                tols = [Toleration(key="pool", operator="Equal", value=rng.choice(_POOLS), effect="NoSchedule")]
        if soft_taint_fraction and rng.random() < 0.5:
            # Half the pods shrug off one zone's PreferNoSchedule degradation.
            tols = (tols or []) + [
                Toleration(key="degraded", operator="Equal", value=rng.choice(_ZONES), effect="PreferNoSchedule")
            ]
        pref_aff = None
        if preferred_affinity_fraction and rng.random() < preferred_affinity_fraction:
            pref_aff = [
                PreferredSchedulingTerm(
                    weight=rng.choice([1, 10, 50, 100]),
                    term=NodeSelectorTerm(
                        match_expressions=[
                            LabelSelectorRequirement(key="zone", operator="In", values=[rng.choice(_ZONES)])
                        ]
                    ),
                )
            ]
            if rng.random() < 0.3:  # second weighted term on the pool label
                pref_aff.append(
                    PreferredSchedulingTerm(
                        weight=rng.choice([5, 25]),
                        term=NodeSelectorTerm(
                            match_expressions=[
                                LabelSelectorRequirement(key="pool", operator="In", values=[rng.choice(_POOLS)])
                            ]
                        ),
                    )
                )
        ext_req = None
        if extended_fraction and rng.random() < extended_fraction:
            ext_req = {"example.com/tpu": str(rng.choice([1, 2, 4]))}
        pod = make_pod(
            f"pending-{i}",
            cpu=f"{rng.choice([100, 250, 500, 1000, 2000])}m",
            memory=f"{rng.choice([128, 256, 512, 1024, 4096])}Mi",
            extended=ext_req,
            node_selector=selector,
            priority=rng.randrange(0, 10),
            labels={
                "app": app,
                **({"pa": pa_label} if pa_label else {}),
                **({"sg": sg_label} if sg_label else {}),
            },
            anti_affinity=anti,
            pod_affinity=pod_aff,
            preferred_pod_affinity=pref_pod_aff,
            preferred_pod_anti_affinity=pref_pod_anti,
            topology_spread=spread,
            tolerations=tols,
            node_affinity=node_aff,
            preferred_node_affinity=pref_aff,
            gang=gang,
        )
        if rng.random() < multi_container_fraction:
            pod.spec.containers.append(
                Container(name="sidecar", resources=ResourceRequirements(requests={"cpu": "50m", "memory": "64Mi"}))
            )
        pods.append(pod)

    return ClusterSnapshot.build(nodes, pods)
