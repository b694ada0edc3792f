"""The benchmark's own generator: a deployment and its traffic drawn from a seed.

Everything here is plain data (Python and NumPy) and imports nothing of the
program, so the plain reference and the program are handed the same inputs.
A deployment file (``configs/<name>.json``) fixes the node and pod shapes
and the controller settings; a traffic file (``traffic/<name>.json``) fixes
the population and the waves.  Every seed places the same pods a node at
the start, in another order.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass

import numpy as np

__all__ = [
    "Deployment",
    "base_placement",
    "cpu_milli",
    "load_deployment",
    "load_traffic",
    "mem_bytes",
    "rng_for",
]

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
class Deployment:
    """A configuration file, parsed: the cluster's nodes, the pod shape and
    the controller settings."""

    name: str
    nodes: int
    node_cpu: str
    node_memory: str
    pod_cpu: str
    pod_memory: str
    controller: dict
    raw: dict


def load_deployment(path: str | pathlib.Path) -> Deployment:
    raw = json.loads(pathlib.Path(path).read_text())
    return Deployment(
        name=raw["name"], nodes=int(raw["nodes"]), node_cpu=raw["node"]["cpu"], node_memory=raw["node"]["memory"],
        pod_cpu=raw["pod"]["cpu"], pod_memory=raw["pod"]["memory"], controller=dict(raw["controller"]), raw=raw,
    )


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
