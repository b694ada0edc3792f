"""Fleet layer — K replicas × K meshes as one logical scheduler.

Three pieces turn the sharded control plane (runtime/shards.py) from a
flat-hash partition into a topology-aware fleet:

  • ``keyer``       — pluggable pod→shard assignment: topology mode maps each
                      pod's gang to a contiguous topology-domain slice of the
                      node axis (rack churn dirties exactly one owner's delta
                      engine); hash mode is the historic crc32 fallback for
                      unlabeled clusters and gangless strays.
  • ``reservation`` — cross-replica gang admission: gangs wider than one
                      shard's slice reserve rows on peer shards through the
                      lease layer (two-phase reserve/commit, TTL'd abort on
                      owner crash — zero orphaned reservations by expiry).
  • ``resize``      — the live shard map: split/merge K without a restart,
                      published through a dedicated lease and adopted on the
                      refresh cadence; checkpoint v5 persists it.

Everything here rides the SAME CAS lease primitives the shard/leader layers
use — no new API verbs, so the chaos proxy and record/replay cover the fleet
paths for free.

Port: a copy of ``tpu_scheduler/fleet/``.  The keyer reads the port's
compiled topology (``topology/model.py``); the mesh bindings live in
``parallel/mesh.py`` and ``backends/cuda.py``.
"""

from .keyer import KEYER_MODES, DomainShardMap, ShardKeyer
from .reservation import (
    GANG_RESERVATION_PREFIX,
    RESERVATION_STATES,
    GangReservationLedger,
    count_orphaned_reservations,
    reservation_lease_name,
)
from .resize import (
    SHARD_MAP_LEASE,
    decode_shard_map,
    encode_shard_map,
    publish_shard_map,
    read_shard_map,
)

__all__ = [
    "KEYER_MODES",
    "DomainShardMap",
    "ShardKeyer",
    "RESERVATION_STATES",
    "GANG_RESERVATION_PREFIX",
    "GangReservationLedger",
    "count_orphaned_reservations",
    "reservation_lease_name",
    "SHARD_MAP_LEASE",
    "encode_shard_map",
    "decode_shard_map",
    "read_shard_map",
    "publish_shard_map",
]
