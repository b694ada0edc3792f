"""Live shard resizing — the fleet's published shard map.

K was fixed at deploy time: every replica was constructed with the same
``--shards`` and nothing could change it without a restart.  The fleet
publishes the CURRENT shard count through one dedicated lease instead —
``tpu-scheduler-shard-map`` — whose HOLDER STRING is the map itself
(``<generation>:<count>``), not a liveness claim:

  • the shard-0 owner is the coordinator (the same tie-break the background
    rebalancer uses): it publishes ``generation+1:<new count>`` to split or
    merge, releasing the old holder string first so the CAS accepts the new
    one regardless of the old lease's TTL state;
  • every replica READS the map at the top of each shard-refresh round and
    adopts a newer generation before renewing: a merge releases leases
    beyond the new range, a split leaves the new orphan shards for the
    normal absorb pass — the proportional-target machinery re-partitions
    ownership without any new protocol;
  • generations are monotonic, so a stale publisher (an old coordinator
    racing its successor) can never roll the fleet backward.

Expiry is deliberately ignored by readers — a map outlives its publisher
exactly like a checkpoint does (checkpoint v5 persists it for restarts).

Port: a copy of ``tpu_scheduler/fleet/resize.py``.
"""

from __future__ import annotations

__all__ = [
    "SHARD_MAP_LEASE",
    "encode_shard_map",
    "decode_shard_map",
    "read_shard_map",
    "publish_shard_map",
]

# The shard-map lease name (FLET-gated against the README).
SHARD_MAP_LEASE = "tpu-scheduler-shard-map"


# shape: (generation: int, num_shards: int) -> str
def encode_shard_map(generation: int, num_shards: int) -> str:
    """The holder-string encoding: ``<generation>:<count>``."""
    return f"{int(generation)}:{int(num_shards)}"


# shape: (holder: str) -> obj
def decode_shard_map(holder) -> tuple | None:
    """(generation, count) from a holder string, or None for anything that
    is not a well-formed positive map (defensive: the lease namespace is
    shared with operators' kubectl)."""
    if not isinstance(holder, str) or ":" not in holder:
        return None
    gen_s, _, count_s = holder.partition(":")
    try:
        gen, count = int(gen_s), int(count_s)
    except ValueError:
        return None
    if gen < 0 or count < 1:
        return None
    return gen, count


# shape: (api: obj) -> obj
def read_shard_map(api) -> tuple | None:
    """The currently published (generation, count), or None when no map has
    ever been published (the fleet runs on its constructed ``--shards``).
    Expiry is ignored — the map is configuration, not liveness."""
    try:
        info = api.get_lease(SHARD_MAP_LEASE)
    except Exception:
        return None
    if info is None:
        return None
    return decode_shard_map(info.get("holder"))


# shape: (api: obj, generation: int, num_shards: int, duration: float) -> bool
def publish_shard_map(api, generation: int, num_shards: int, duration: float) -> bool:
    """CAS-publish a new map generation.  Refuses (False) when the
    published generation is already >= ``generation`` — monotonicity is the
    split-brain guard.  The old holder string is released first so the
    acquire succeeds regardless of the old lease's TTL."""
    current = read_shard_map(api)
    if current is not None and current[0] >= int(generation):
        return False
    try:
        info = api.get_lease(SHARD_MAP_LEASE)
        if info is not None and info.get("holder"):
            api.release_lease(SHARD_MAP_LEASE, info["holder"])
        return bool(api.acquire_lease(SHARD_MAP_LEASE, encode_shard_map(generation, num_shards), float(duration)))
    except Exception:
        return False
