"""Carry cycle state across from the JAX package.

``packed_from_arrays`` builds the port's ``PackedCluster`` from the JAX
package's ``PackedCluster`` fields given as plain NumPy arrays and Python
values (``device_arrays()``, names, vocabularies), so one state can feed
both packages even where the port's own packer is not under test.
``to_device`` turns a packed cluster into torch tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.pack import PackedCluster

__all__ = ["packed_from_arrays", "to_device"]


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
