"""Multi-mesh fleet — in the port, only the lease names the sim reads.

The sim scorecard's ``convergence`` block counts stale shard, replica and
gang-reservation leases by name, so the port carries the two fleet lease
names (``tpu_scheduler/fleet/reservation.py:41``,
``tpu_scheduler/fleet/resize.py:36``); the shard and replica prefixes are
in ``runtime/shards.py``.  The keyer, the reservations and the resize —
the fleet itself — wait for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

__all__ = ["GANG_RESERVATION_PREFIX", "SHARD_MAP_LEASE"]

# Lease-name namespace: gang ``g`` reserving shard ``s`` holds
# ``tpu-scheduler-gang-<g>-<s>`` beside the shard/replica leases.
GANG_RESERVATION_PREFIX = "tpu-scheduler-gang-"

# The shard-map lease name.
SHARD_MAP_LEASE = "tpu-scheduler-shard-map"
