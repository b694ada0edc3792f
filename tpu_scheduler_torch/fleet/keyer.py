"""Topology-keyed shard assignment — the fleet's pod→shard map.

The flat ``shard_for_name`` crc32 hash scatters a rack's pods across every
shard, so one rack's churn dirties every replica's delta engine.  Topology
keying fixes the locality: the COARSEST compiled-topology level's domains
(racks under the default keys) partition into ``num_shards`` contiguous,
node-count-balanced groups, and a pod keys to a *domain* (stable crc32 of
its gang/full name over the domain list) whose group is its shard.  Two
properties fall out:

  • each shard's node columns are a contiguous topology slice — the owner
    solves P/K pods against N/K nodes, the near-linear scaling surface the
    multi-mesh bench row measures; and
  • gang members still share a shard (they key by the GANG name, exactly as
    hash mode does), so all-or-nothing admission survives partitioning.

Hash mode (``domain_map=None``) reproduces ``runtime/shards.shard_for_name``
bit-for-bit — unlabeled clusters and checkpoint-restored replicas behave
exactly as before the fleet layer existed.  ``KEYER_MODES`` is the closed
mode vocabulary (drift-gated against the README "Multi-mesh fleet"
catalogue by the FLET analyze rule).

Port: a copy of ``tpu_scheduler/fleet/keyer.py``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

from ..runtime.shards import shard_for_name, shard_of_pod

__all__ = ["KEYER_MODES", "DomainShardMap", "ShardKeyer"]

# The closed keyer-mode vocabulary (FLET-gated against the README).
KEYER_MODES = ("topology", "hash")


@dataclass(frozen=True)
class DomainShardMap:
    """One CompiledTopology's coarsest level partitioned into shards.

    ``domains`` keeps first-appearance (snapshot) order; ``domain_shard`` is
    the parallel shard index per domain; ``shard_nodes`` holds each shard's
    node names in snapshot order — the contiguous topology slice the owner
    solves against and the mesh binding spans.
    """

    num_shards: int
    domains: tuple
    domain_shard: tuple
    shard_nodes: tuple
    node_shard: dict

    # shape: (topo: obj, num_shards: int) -> obj
    @staticmethod
    def compile(topo, num_shards: int) -> "DomainShardMap | None":
        """Partition the coarsest level's domains into ``num_shards``
        contiguous groups balanced by node count.  Deterministic: domains in
        first-node-appearance order, boundaries at the exact node-count
        prefix ratios — every replica compiling the same topology derives
        the same map.  Returns None for degenerate inputs (no nodes, or an
        unsharded K)."""
        num_shards = int(num_shards)
        if topo is None or num_shards <= 1 or not topo.node_names:
            return None
        coarse = topo.node_domain_names[-1]  # levels are finest-first
        domains: list[str] = []
        members: dict[str, list[str]] = {}
        for name, dom in zip(topo.node_names, coarse):
            if dom not in members:
                domains.append(dom)
                members[dom] = []
            members[dom].append(name)
        total = len(topo.node_names)
        domain_shard: list[int] = []
        shard_nodes: list[list[str]] = [[] for _ in range(num_shards)]
        node_shard: dict[str, int] = {}
        seen = 0
        for dom in domains:
            s = min(num_shards - 1, (seen * num_shards) // total)
            domain_shard.append(s)
            for name in members[dom]:
                shard_nodes[s].append(name)
                node_shard[name] = s
            seen += len(members[dom])
        return DomainShardMap(
            num_shards=num_shards,
            domains=tuple(domains),
            domain_shard=tuple(domain_shard),
            shard_nodes=tuple(tuple(ns) for ns in shard_nodes),
            node_shard=node_shard,
        )

    # shape: (self: obj, shard: int) -> obj
    def domains_of_shard(self, shard: int) -> tuple:
        """The domain names assigned to one shard (first-appearance order)."""
        return tuple(d for d, s in zip(self.domains, self.domain_shard) if s == int(shard))


class ShardKeyer:
    """Pluggable pod→shard assignment for ``runtime/shards.ShardSet``.

    Topology mode (``domain_map`` set): key → domain → the domain's shard
    group.  Hash mode (``domain_map=None``): the historic flat crc32 —
    bit-identical to ``shard_for_name``, so installing a hash keyer is a
    no-op by construction.
    """

    def __init__(self, num_shards: int, domain_map: DomainShardMap | None = None):
        self.num_shards = int(num_shards)
        self.domain_map = domain_map

    @property
    def mode(self) -> str:
        return KEYER_MODES[0] if self.domain_map is not None else KEYER_MODES[1]

    # shape: (self: obj, key: str) -> int
    def shard_for_key(self, key: str) -> int:
        """Stable shard of an identity string (pod full name or gang name).
        Topology mode hashes over the DOMAIN list so the assignment follows
        the topology partition; hash mode is the flat crc32."""
        dm = self.domain_map
        if dm is None or not dm.domains or self.num_shards <= 1:
            return shard_for_name(key, self.num_shards)
        return dm.domain_shard[zlib.crc32(key.encode()) % len(dm.domains)]

    # shape: (self: obj, pod: obj) -> int
    def shard_of_pod(self, pod) -> int:
        """The pod's shard — its GANG name's in a gang (atomic admission
        needs one owner), its own full name's otherwise; same precedence as
        ``runtime/shards.shard_of_pod``."""
        if self.domain_map is None:
            return shard_of_pod(pod, self.num_shards)
        spec = pod.spec
        if spec is not None and spec.gang:
            return self.shard_for_key(spec.gang)
        ns = pod.metadata.namespace or "default"
        return self.shard_for_key(f"{ns}/{pod.metadata.name}")

    # shape: (self: obj, shards: obj) -> obj
    def node_set(self, shards) -> set:
        """Union of the given shards' node-name slices (empty set in hash
        mode — the flat hash spans no node columns)."""
        dm = self.domain_map
        if dm is None:
            return set()
        out: set = set()
        for s in shards:
            if 0 <= int(s) < len(dm.shard_nodes):
                out.update(dm.shard_nodes[int(s)])
        return out
