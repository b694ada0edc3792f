"""Declarative interconnect-topology model — copy of
``tpu_scheduler/topology/model.py`` (pure Python and NumPy).

A cluster's interconnect hierarchy is a sequence of *levels*, finest first
(e.g. TPU slice → rack): two nodes in the same slice communicate over ICI,
two slices in one rack over the rack fabric, anything further over the pod
spine.  The model is data — loadable from node labels (the kube-native way:
every node advertises its domain per level) or from a ``--topology-file``
JSON spec for clusters whose labels don't carry it — and compiles per node
set into the arrays the scoring path consumes:

  • per-level membership: ``dom_id[l][N]`` int32 domain ids (masks via
    one-hot, built in locality.pack_topology), and
  • a symmetric ``[N, N]`` node-distance tensor (``distance_matrix()``):
    ``dist(a, b) = Σ_l d_l · [dom_l(a) ≠ dom_l(b)]`` — the number of
    hierarchy levels two nodes do NOT share, weighted by each level's
    ``distance`` contribution.  Same slice → 0; same rack, different
    slice → d_slice; different rack → d_slice + d_rack.

The solve path never materializes the [N, N] tensor on device: the
distance-to-placed-ranks sum factors through the per-level membership
one-hots (see locality.gang_topology_term), which is algebraically identical
and keeps device memory O(G·N + D·N) instead of O(N²) at flagship node
counts.  ``distance_matrix()`` serves the host-side consumers — scorecard
locality verdicts, the debug API, and bench reporting — where N is small or
the cost is off the cycle clock.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "DEFAULT_LEVEL_KEYS",
    "CompiledTopology",
    "TopologyLevel",
    "TopologyModel",
    "load_topology_file",
]

# Default node-label keys per hierarchy level, finest first.  A cluster
# advertising either key topology-enables itself (TopologyModel.detect);
# levels whose key no node carries are dropped from the compiled model.
DEFAULT_LEVEL_KEYS = (
    ("slice", "topology.tpu-scheduler/slice"),
    ("rack", "topology.tpu-scheduler/rack"),
)


@dataclass(frozen=True)
class TopologyLevel:
    """One hierarchy level: its name, the node-label key that carries the
    node's domain at this level (None for spec-file-only models), and the
    distance contributed when two nodes differ at this level."""

    name: str
    key: str | None = None
    distance: float = 1.0


@dataclass(frozen=True)
class TopologyModel:
    """The declarative model: ordered levels (finest first) plus an optional
    explicit node → {level name → domain} map (spec files).  Labels win for
    levels with a ``key``; the explicit map covers the rest."""

    levels: tuple[TopologyLevel, ...]
    node_domains: dict = field(default_factory=dict)

    @staticmethod
    def from_node_labels(level_keys=DEFAULT_LEVEL_KEYS) -> "TopologyModel":
        """Model whose domains come entirely from node labels."""
        return TopologyModel(levels=tuple(TopologyLevel(name=n, key=k) for n, k in level_keys))

    @staticmethod
    def detect(nodes, level_keys=DEFAULT_LEVEL_KEYS) -> "TopologyModel | None":
        """Auto-detection for ``--topology auto``: a model over the default
        label keys, or None when NO node advertises any of them — an
        unlabeled cluster stays topology-blind instead of degenerating to
        per-node singleton domains."""
        present = set()
        for node in nodes:
            labels = node.metadata.labels or {}
            for name, key in level_keys:
                if key in labels:
                    present.add(name)
        if not present:
            return None
        return TopologyModel(
            levels=tuple(TopologyLevel(name=n, key=k) for n, k in level_keys if n in present)
        )

    @staticmethod
    def from_spec(spec: dict) -> "TopologyModel":
        """Build from a parsed ``--topology-file`` spec::

            {"levels": [{"name": "slice", "key": "...", "distance": 1.0}, ...],
             "nodes": {"node-1": {"slice": "s0", "rack": "r0"}, ...}}

        ``key`` and ``distance`` are optional per level; ``nodes`` is
        optional (label-only specs just pin the level order/weights)."""
        levels = tuple(
            TopologyLevel(
                name=entry["name"],
                key=entry.get("key"),
                distance=float(entry.get("distance", 1.0)),
            )
            for entry in spec.get("levels", ())
        )
        if not levels:
            raise ValueError("topology spec declares no levels")
        return TopologyModel(levels=levels, node_domains=dict(spec.get("nodes", {})))

    def compile(self, nodes) -> "CompiledTopology":
        """Resolve every node's domain per level against this node set.

        Resolution order: explicit spec map, then the level's label key.  A
        node with neither gets a singleton domain (``~<node>``): it is
        maximally far from everything at that level — conservative for
        locality (never accidentally co-located), and visible in the stats
        rather than silently dropped."""
        names = tuple(n.metadata.name for n in nodes)
        dom_names: list[tuple[str, ...]] = []
        dom_ids: list[np.ndarray] = []
        dom_counts: list[int] = []
        for lv in self.levels:
            vocab: dict[str, int] = {}
            ids = np.zeros((len(names),), dtype=np.int32)
            per_node: list[str] = []
            for i, node in enumerate(nodes):
                spec_doms = self.node_domains.get(node.metadata.name)
                dom = spec_doms.get(lv.name) if spec_doms else None
                if dom is None and lv.key is not None:
                    dom = (node.metadata.labels or {}).get(lv.key)
                if dom is None:
                    dom = f"~{node.metadata.name}"
                if dom not in vocab:
                    vocab[dom] = len(vocab)
                ids[i] = vocab[dom]
                per_node.append(dom)
            dom_ids.append(ids)
            dom_counts.append(len(vocab))
            dom_names.append(tuple(per_node))
        return CompiledTopology(
            model=self,
            node_names=names,
            dom_ids=tuple(dom_ids),
            dom_counts=tuple(dom_counts),
            node_domain_names=tuple(dom_names),
        )


@dataclass(frozen=True)
class CompiledTopology:
    """One model resolved against one node set (order = snapshot order)."""

    model: TopologyModel
    node_names: tuple[str, ...]
    # Per level: [N] int32 domain id, domain count, and the per-node domain
    # NAME tuple (host-side consumers key on names, not ids).
    dom_ids: tuple
    dom_counts: tuple
    node_domain_names: tuple
    _dist: object = field(default=None, compare=False, repr=False)
    _row: object = field(default=None, compare=False, repr=False)

    @property
    def n_levels(self) -> int:
        return len(self.model.levels)

    def level_distances(self) -> np.ndarray:
        """[Lv] float32 distance contribution per level."""
        return np.asarray([lv.distance for lv in self.model.levels], dtype=np.float32)

    def domains_of(self, name: str) -> tuple | None:
        """The node's (finest → coarsest) domain names, or None if unknown."""
        if self._row is None:
            object.__setattr__(self, "_row", {n: i for i, n in enumerate(self.node_names)})
        i = self._row.get(name)
        if i is None:
            return None
        return tuple(doms[i] for doms in self.node_domain_names)

    def distance_matrix(self) -> np.ndarray:
        """The symmetric [N, N] node-distance tensor (lazy, memoized):
        ``Σ_l d_l · [dom_l(a) ≠ dom_l(b)]``.  Host-side consumers only —
        the device solve path uses the factored per-level form
        (locality.gang_topology_term), which is algebraically identical."""
        if self._dist is None:
            n = len(self.node_names)
            dist = np.zeros((n, n), dtype=np.float32)
            for ids, lv in zip(self.dom_ids, self.model.levels):
                dist += np.float32(lv.distance) * (ids[:, None] != ids[None, :])
            object.__setattr__(self, "_dist", dist)
        return self._dist


def load_topology_file(path: str) -> TopologyModel:
    """Parse a ``--topology-file`` JSON spec into a model."""
    with open(path) as f:
        return TopologyModel.from_spec(json.load(f))
