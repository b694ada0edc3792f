"""Sharded control plane — in the port, only its lease names.

The sim scorecard's ``convergence`` block counts stale shard and replica
leases by these prefixes (``tpu_scheduler/runtime/shards.py:53,61``).
``ShardSet`` and the sharded cycle wait for ROADMAP Queue 1 item 8, and the
controller refuses ``shards > 1`` until then.
"""

from __future__ import annotations

__all__ = ["SHARD_LEASE_PREFIX", "REPLICA_LEASE_PREFIX"]

# Lease-name prefix: shard i is owned through ``tpu-scheduler-shard-<i>`` in
# kube-system, beside the single-leader lease.
SHARD_LEASE_PREFIX = "tpu-scheduler-shard-"

# Presence lease per replica (``tpu-scheduler-replica-<identity>``).
REPLICA_LEASE_PREFIX = "tpu-scheduler-replica-"
