"""Carry cycle state across from the JAX package.

``packed_from_arrays`` builds the port's ``PackedCluster`` from the JAX
package's ``PackedCluster`` fields given as plain NumPy arrays and Python
values (``device_arrays()``, names, vocabularies), and
``constraints_from_arrays`` the port's ``ConstraintSet`` from the JAX one's
``pod_arrays()``, ``meta_arrays()``, ``state_arrays()`` and ``n_*`` counts,
so one state can feed both packages even where the port's own packers are
not under test.  ``to_device`` and ``constraints_to_device`` turn them into
torch tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.constraints import ConstraintSet
from .ops.pack import PackedCluster

__all__ = ["packed_from_arrays", "to_device", "constraints_from_arrays", "constraints_to_device"]

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


def to_device(packed: PackedCluster, device: str | torch.device) -> dict[str, torch.Tensor]:
    """``packed.device_arrays()`` as torch tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in packed.device_arrays().items()}


def constraints_from_arrays(pod: dict, meta: dict, state: dict, **counts) -> ConstraintSet:
    """``pod``/``meta``/``state``: the ``pod_arrays()``, ``meta_arrays()``
    and ``state_arrays()`` entries; ``counts``: the five ``n_*`` counts.
    Arrays are copied."""
    if sorted(counts) != sorted(_COUNTS):
        raise TypeError(f"constraints_from_arrays: expected counts {sorted(_COUNTS)}, got {sorted(counts)}")
    fields = {k: np.array(v, copy=True) for group in (pod, meta, state) for k, v in group.items()}
    return ConstraintSet(**fields, **{k: int(v) for k, v in counts.items()})


def constraints_to_device(cons: ConstraintSet, device: str | torch.device) -> tuple[dict, dict, dict]:
    """(pod, meta, state) dicts of torch tensors on ``device``: the pod
    bitmaps ride the auction's pod dict; meta and state are node- and
    domain-side."""

    def put(arrays: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}

    return put(cons.pod_arrays()), put(cons.meta_arrays()), put(cons.state_arrays())
