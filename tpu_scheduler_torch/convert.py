"""Carry cycle state across from the JAX package.

``cluster_from_manifests`` carries the cluster itself: nodes, pods and
PodDisruptionBudgets as k8s-shaped manifests (what the JAX package's
``pod_to_dict``/``node_to_dict``/``PodDisruptionBudget.to_dict`` give), parsed
into the port's objects — a scheduler has no weights, the cluster is the
state both packages must start from.

``packed_from_arrays`` builds the port's ``PackedCluster`` from the JAX
package's ``PackedCluster`` fields given as plain NumPy arrays and Python
values (``device_arrays()``, names, vocabularies), and
``constraints_from_arrays`` the port's ``ConstraintSet`` from the JAX one's
``pod_arrays()``, ``meta_arrays()``, ``state_arrays()`` and ``n_*`` counts,
and ``topology_from_arrays`` the port's ``TopologySet`` from the JAX one's
``pod_arrays()``, ``meta_arrays()``, gang count and names, so one state can
feed both packages even where the port's own packers are not under test.
``to_device``, ``constraints_to_device`` and ``topology_to_device`` turn
them into torch tensors on one device; each takes an optional ``put``
(host array → tensor on the device), which the backends pass to reuse
their cached uploads of unchanged arrays.  Per-cycle state never goes
through ``put``.
"""

from __future__ import annotations

import numpy as np
import torch

from .api.objects import Node, Pod, PodDisruptionBudget
from .ops.constraints import ConstraintSet
from .ops.pack import PackedCluster
from .topology.locality import TopologySet

__all__ = [
    "cluster_from_manifests",
    "packed_from_arrays",
    "to_device",
    "constraints_from_arrays",
    "constraints_to_device",
    "topology_from_arrays",
    "topology_to_device",
]


def cluster_from_manifests(
    node_dicts, pod_dicts, pdb_dicts=()
) -> tuple[list[Node], list[Pod], list[PodDisruptionBudget]]:
    """(nodes, pods, pdbs) of the port parsed from manifests, in the given
    order — ``FakeApiServer.load(nodes, pods)`` and ``create_pdb`` take
    them as they are."""
    return (
        [Node.from_dict(d) for d in node_dicts],
        [Pod.from_dict(d) for d in pod_dicts],
        [PodDisruptionBudget.from_dict(d) for d in pdb_dicts],
    )


_COUNTS = ("n_terms", "n_pa_terms", "n_ppa_terms", "n_spread", "n_spread_soft")


def packed_from_arrays(arrays: dict, pod_names, node_names, **vocabs) -> PackedCluster:
    """``arrays``: the 18 ``device_arrays()`` entries; ``vocabs``: the
    vocabulary fields (``vocab``, ``taint_vocab``, ``aff_vocab``,
    ``soft_taint_vocab``, ``pref_vocab``; optional ``res_vocab`` and
    ``res_scales``).  Arrays are copied, so the result shares no buffer with
    the source."""
    fields = {k: np.array(v, copy=True) for k, v in arrays.items()}
    for key in ("vocab", "taint_vocab", "aff_vocab", "soft_taint_vocab", "pref_vocab"):
        fields[key] = dict(vocabs.pop(key, {}))
    for key in ("res_vocab", "res_scales"):
        if key in vocabs:
            fields[key] = tuple(vocabs.pop(key))
    if vocabs:
        raise TypeError(f"packed_from_arrays: unknown fields {sorted(vocabs)}")
    return PackedCluster(pod_names=tuple(pod_names), node_names=tuple(node_names), **fields)


def _upload(device: str | torch.device, put=None):
    """``put``, or a fresh upload of a host array to ``device``."""
    if put is not None:
        return put
    return lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)


def to_device(packed: PackedCluster, device: str | torch.device, put=None) -> dict[str, torch.Tensor]:
    """``packed.device_arrays()`` as torch tensors on ``device``."""
    up = _upload(device, put)
    return {k: up(v) for k, v in packed.device_arrays().items()}


def constraints_from_arrays(pod: dict, meta: dict, state: dict, **counts) -> ConstraintSet:
    """``pod``/``meta``/``state``: the ``pod_arrays()``, ``meta_arrays()``
    and ``state_arrays()`` entries; ``counts``: the five ``n_*`` counts.
    Arrays are copied."""
    if sorted(counts) != sorted(_COUNTS):
        raise TypeError(f"constraints_from_arrays: expected counts {sorted(_COUNTS)}, got {sorted(counts)}")
    fields = {k: np.array(v, copy=True) for group in (pod, meta, state) for k, v in group.items()}
    return ConstraintSet(**fields, **{k: int(v) for k, v in counts.items()})


def constraints_to_device(cons: ConstraintSet, device: str | torch.device, put=None) -> tuple[dict, dict, dict]:
    """(pod, meta, state) dicts of torch tensors on ``device``: the pod
    bitmaps ride the auction's pod dict; meta and state are node- and
    domain-side.  The state is per cycle and always a fresh upload."""
    up, fresh = _upload(device, put), _upload(device)
    pods = {k: up(v) for k, v in cons.pod_arrays().items()}
    meta = {k: up(v) for k, v in cons.meta_arrays().items()}
    return pods, meta, {k: fresh(v) for k, v in cons.state_arrays().items()}


def topology_from_arrays(pod: dict, meta: dict, n_gangs: int, gang_names, compiled) -> TopologySet:
    """``pod``/``meta``: a TopologySet's ``pod_arrays()`` and
    ``meta_arrays()`` entries; ``compiled``: its compiled topology (read by
    host-side consumers only).  Arrays are copied."""
    if sorted(pod) != ["pod_gang_id"]:
        raise TypeError(f"topology_from_arrays: expected pod arrays ['pod_gang_id'], got {sorted(pod)}")
    return TopologySet(
        pod_gang_id=np.array(pod["pod_gang_id"], copy=True),
        meta={k: np.array(v, copy=True) for k, v in meta.items()},
        n_gangs=int(n_gangs),
        gang_names=tuple(gang_names),
        compiled=compiled,
    )


def topology_to_device(topo: TopologySet, device: str | torch.device, put=None) -> tuple[dict, dict, dict]:
    """(pod, meta, state) dicts of torch tensors on ``device``: the gang ids
    ride the auction's pod dict (permuted, compacted and sliced with it),
    the meta goes as it is, and the [G+1, N+1] float32 ``gang_nodes`` state
    is made on the device with ``torch.zeros`` (at the full shape a host
    upload would move hundreds of MB of zeros per cycle)."""
    up = _upload(device, put)
    pods = {k: up(v) for k, v in topo.pod_arrays().items()}
    meta = {k: up(v) for k, v in topo.meta_arrays().items()}
    n = topo.meta["dom_id_0"].shape[0]
    state = {"gang_nodes": torch.zeros((topo.n_gangs + 1, n + 1), dtype=torch.float32, device=device)}
    return pods, meta, state
