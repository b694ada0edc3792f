"""Sharded control plane — lease-per-shard ownership for active-active
controller replicas.

The single-leader election (runtime/lease.py + ``--leader-elect``) serializes
the WHOLE pending set behind one process: a leader crash mid-cycle stalls all
scheduling for up to ``lease_duration``.  This module partitions the pending
set into K shards so any replica can own any subset of them:

  • ``shard_for_name`` — stable hash (crc32, PYTHONHASHSEED-proof) of the pod
    full name; ``shard_of_pod`` pins every member of a gang to the GANG
    name's shard, so all-or-nothing admission survives partitioning (a gang
    split across owners could never look complete to any one replica).  The
    fleet layer (fleet/) can swap this flat hash for a
    topology-keyed ``ShardKeyer`` via ``ShardSet.set_keyer`` — each shard's
    node columns then form a contiguous topology slice.
  • one ``coordination.k8s.io`` Lease per shard (``tpu-scheduler-shard-<i>``),
    acquired/renewed through the SAME CAS primitives as the leader lease
    (fake_api.acquire_lease → lease.try_acquire_or_renew) — acquisition races
    resolve at the server as resourceVersion conflicts, never by new verbs.
  • ``ShardSet.refresh`` — one ownership round per scheduling cycle: renew
    what we hold, take over expired/released shards while under a
    proportional target (ceil(K / live replicas)), and RELEASE the excess
    when new replicas join so ownership rebalances without operator action.
    A replica that crashes simply stops renewing; its shards expire and the
    survivors absorb them within one lease TTL + one cycle — the takeover
    bound the sim scorecard's ``availability`` block holds at
    ``2 × lease_duration``.

Everything here is main-thread state called from the controller's cycle loop
(no background renewal thread: the cycle cadence IS the renewal cadence, so
``cycle_interval`` must stay below ``lease_duration`` — the controller warns
when it cannot know, the sim enforces it by construction).  Clocks are
injected, so simulated replicas replay bit-identically.

Port: a copy of ``tpu_scheduler/runtime/shards.py``.  The lease names, the
crc32 assignment and the ownership rounds are the JAX package's, so the
replicas of both packages can share one API server's leases.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

__all__ = [
    "SHARD_LEASE_PREFIX",
    "REPLICA_LEASE_PREFIX",
    "shard_for_name",
    "shard_of_pod",
    "shard_lease_name",
    "ShardDelta",
    "ShardSet",
]

# Lease-name prefix: shard i is owned through ``tpu-scheduler-shard-<i>`` in
# kube-system (LEASE_NAMESPACE), beside the single-leader lease.
SHARD_LEASE_PREFIX = "tpu-scheduler-shard-"

# Presence lease per replica (``tpu-scheduler-replica-<identity>``): a
# replica holding ZERO shards is otherwise invisible to the proportional
# target (shard holders are the only evidence), so incumbents would never
# release toward it.  Renewed every refresh; expiry removes the replica from
# everyone's live count, which is what raises the survivors' targets after a
# crash.
REPLICA_LEASE_PREFIX = "tpu-scheduler-replica-"


def shard_for_name(key: str, num_shards: int) -> int:
    """Stable shard index for an identity string (pod full name or gang
    name).  crc32, not ``hash()``: the assignment must agree across replica
    processes and survive restarts (PYTHONHASHSEED)."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(key.encode()) % num_shards


def shard_of_pod(pod, num_shards: int) -> int:
    """A pod's shard — the GANG name's shard when the pod belongs to one
    (gang members must share an owner for atomic admission), its own full
    name's otherwise."""
    spec = pod.spec
    if spec is not None and spec.gang:
        return shard_for_name(spec.gang, num_shards)
    ns = pod.metadata.namespace or "default"
    return shard_for_name(f"{ns}/{pod.metadata.name}", num_shards)


def shard_lease_name(shard: int) -> str:
    return f"{SHARD_LEASE_PREFIX}{shard}"


@dataclass
class ShardDelta:
    """One refresh round's ownership changes."""

    owned: frozenset = frozenset()  # shards held after the round
    gained: frozenset = frozenset()  # newly acquired this round (takeover/rebalance targets)
    lost: frozenset = frozenset()  # held last round, not renewable now
    released: frozenset = frozenset()  # voluntarily released (rebalance)
    holders: dict = field(default_factory=dict)  # shard -> live holder identity ("" = unheld)
    resized: bool = False  # a newer shard-map generation was adopted this round (fleet/resize.py)


# protocol: machine shard-lease field=- init=free
# protocol: states: free | held | expired
# protocol: free -> held
# protocol: held -> free | expired
# protocol: expired -> held
# protocol: var released: 0..1 = 0
# protocol: action acquire: free -> held requires released == 0
# protocol: action renew: held -> held requires released == 0
# protocol: action release: held -> free effect released = 1
# protocol: env crash-ttl: held -> expired
# protocol: action takeover: expired -> held effect released = 0
# protocol: env thread-renew: free -> held requires released == 0
# protocol: invariant release-is-final: released == 1 implies state == free
# protocol: progress reclaimable: state == expired
class ShardSet:
    """Per-replica shard-ownership ledger over the lease API.

    The ``# protocol:`` contract above models one shard's lease from this
    replica's point of view (model-only, ``field=-``: the state lives in
    the API server, not in a field here).  ``release-is-final`` is the
    release/renew race, proved instead of regression-sampled: after a voluntary
    ``release_all`` the stale renew thread (``thread-renew``) must never
    re-acquire — only a fresh ``takeover`` by a live replica clears the
    released latch.  ``reclaimable`` proves a crash-expired lease can
    always be taken over.

    ``api`` needs ``acquire_lease(name, holder, duration)``,
    ``release_lease(name, holder)``, and ``get_lease(name)`` — the surface
    FakeApiServer, RemoteApiAdapter, and the chaos proxy all serve.
    """

    def __init__(self, api, num_shards: int, identity: str, lease_duration: float, clock, keyer=None):
        self.api = api
        self.num_shards = int(num_shards)
        self.identity = identity
        self.lease_duration = float(lease_duration)
        self.clock = clock
        self.owned: frozenset = frozenset()
        # Pluggable pod→shard assignment (fleet/keyer.ShardKeyer): topology
        # mode keys pods to contiguous topology-domain slices; None keeps
        # the historic flat crc32 exactly.
        self.keyer = keyer
        # Highest shard-map generation adopted so far (fleet/resize.py).
        self.map_generation = 0

    # -- assignment ---------------------------------------------------------

    def set_keyer(self, keyer) -> None:
        """Install (or clear) the fleet ShardKeyer.  The caller owns the
        consequences: a keying change moves pods between shards, so it must
        revalidate its pending view exactly as a takeover does."""
        self.keyer = keyer

    def shard_of(self, pod) -> int:
        if self.keyer is not None:
            return self.keyer.shard_of_pod(pod)
        return shard_of_pod(pod, self.num_shards)

    def owns_pod(self, pod) -> bool:
        return self.shard_of(pod) in self.owned

    def owns_name(self, pod_full: str) -> bool:
        """Ownership by pod full name only — the ledger-prune filter.  Gang
        pods may hash elsewhere via their gang name, so this is used ONLY to
        scope prunes conservatively, never for scheduling eligibility."""
        if self.keyer is not None:
            return self.keyer.shard_for_key(pod_full) in self.owned
        return shard_for_name(pod_full, self.num_shards) in self.owned

    # -- hardened lease primitives ------------------------------------------
    # Lease-endpoint brownouts (sim/chaos.py lease faults, a flaky remote
    # apiserver) REFUSE, never raise into the cycle: a failed acquire is a
    # lost CAS, a failed release leaves the lease to expire within one TTL,
    # a failed read reads as unheld — the CAS still arbitrates takeover.

    def _acquire(self, name: str) -> bool:
        try:
            return bool(self.api.acquire_lease(name, self.identity, self.lease_duration))
        except Exception:
            return False

    def _release(self, name: str) -> None:
        try:
            self.api.release_lease(name, self.identity)
        except Exception:
            pass

    def _get(self, name: str) -> dict | None:
        try:
            return self.api.get_lease(name)
        except Exception:
            return None

    # -- one ownership round ------------------------------------------------

    def _live_holders(self, now: float) -> dict[int, str]:
        """shard -> holder identity for every shard whose lease is live
        (unexpired, non-empty holder); absent shards map to ""."""
        holders: dict[int, str] = {}
        for s in range(self.num_shards):
            info = self._get(shard_lease_name(s))
            if info is not None and info.get("holder") and now < float(info.get("expires", 0.0)):
                holders[s] = info["holder"]
            else:
                holders[s] = ""
        return holders

    def _live_replicas(self, now: float, holders: dict[int, str]) -> int:
        """Count of live replicas (self included) from the presence leases;
        degrades to distinct shard holders when the API cannot list leases
        (a remote server without the collection route) — a zero-shard
        replica then waits for a lease to free instead of being rebalanced
        toward, which is safe, just slower."""
        live = {self.identity}
        lister = getattr(self.api, "list_lease_summaries", None)
        if lister is not None:
            for info in lister():
                if (
                    info["name"].startswith(REPLICA_LEASE_PREFIX)
                    and info.get("holder")
                    and now < float(info.get("expires", 0.0))
                ):
                    live.add(info["holder"])
        else:
            for s in sorted(holders):
                if holders[s]:
                    live.add(holders[s])
        return len(live)

    def _adopt_shard_map(self) -> bool:
        """Fold a newer published shard map (fleet/resize.py) into this
        replica's view before the ownership round: a merge releases leases
        beyond the new range (their pods re-key into the survivors), a
        split leaves the new orphan shards for the absorb pass.  Returns
        True when the shard COUNT changed (the caller re-keys and rebinds)."""
        from ..fleet.resize import read_shard_map

        info = read_shard_map(self.api)
        if info is None:
            return False
        gen, count = info
        if gen <= self.map_generation:
            return False
        self.map_generation = gen
        if count == self.num_shards:
            return False
        for s in sorted(self.owned):
            if s >= count:
                self._release(shard_lease_name(s))
        self.owned = frozenset(s for s in self.owned if s < count)
        self.num_shards = count
        return True

    def publish_resize(self, count: int) -> bool:
        """Coordinator-side split/merge: publish ``generation+1:<count>``.
        Only the shard-0 owner may call this (the rebalancer's tie-break);
        the change lands fleet-wide on the next refresh cadence — including
        on this replica, through the same ``_adopt_shard_map`` path."""
        if 0 not in self.owned or int(count) < 1:
            return False
        from ..fleet.resize import publish_shard_map, read_shard_map

        current = read_shard_map(self.api)
        gen = max(self.map_generation, current[0] if current is not None else 0) + 1
        return publish_shard_map(self.api, gen, int(count), self.lease_duration)

    def refresh(self) -> ShardDelta:
        """Renew owned shards, absorb orphans up to the proportional target,
        release the excess.  Deterministic: shards are visited in a rotated
        order starting at this identity's own hash, so concurrent replicas
        prefer disjoint orphans and the CAS settles the rest."""
        now = self.clock()
        # Presence first: visible to every other replica's target math even
        # while we hold nothing.
        self._acquire(REPLICA_LEASE_PREFIX + self.identity)
        resized = self._adopt_shard_map()
        holders = self._live_holders(now)
        n_replicas = self._live_replicas(now, holders)
        target = -(-self.num_shards // n_replicas)  # ceil
        prev = self.owned
        owned: set[int] = set()
        gained: set[int] = set()
        released: set[int] = set()
        start = shard_for_name(self.identity, self.num_shards)
        order = [(start + i) % self.num_shards for i in range(self.num_shards)]
        # Pass 1: renew what we already hold (never drop involuntarily —
        # losing a renewal CAS means another replica took it, which pass 2's
        # bookkeeping reports as lost).
        for s in order:
            if s in prev and self._acquire(shard_lease_name(s)):
                owned.add(s)
        # Pass 2: rebalance — release the excess above target (freshly
        # joined replicas pick them up next round) from the END of the
        # rotated order, so the shards a replica keeps are the ones nearest
        # its own hash (stable across rounds).
        if len(owned) > target:
            for s in reversed(order):
                if len(owned) <= target:
                    break
                if s in owned:
                    owned.discard(s)
                    released.add(s)
                    self._release(shard_lease_name(s))
        # Pass 3: absorb orphans (expired/released/never-created shards)
        # while under target.
        for s in order:
            if len(owned) >= target:
                break
            if s in owned or holders[s] not in ("", self.identity):
                continue
            if self._acquire(shard_lease_name(s)):
                owned.add(s)
                if s not in prev:
                    gained.add(s)
        self.owned = frozenset(owned)
        return ShardDelta(
            owned=self.owned,
            gained=frozenset(gained),
            lost=frozenset(prev - owned - released),
            released=frozenset(released),
            holders=holders,
            resized=resized,
        )

    def release_all(self) -> None:
        """Clean shutdown: hand every owned shard (and the presence lease)
        back so survivors absorb them immediately instead of waiting out the
        TTL."""
        for s in sorted(self.owned):
            self._release(shard_lease_name(s))
        self._release(REPLICA_LEASE_PREFIX + self.identity)
        self.owned = frozenset()

    def debug(self, now: float) -> dict:
        """The /debug/shards payload (read from the HTTP thread: every read
        below is a GIL-atomic snapshot of main-thread state — the
        resilience_snapshot stance)."""
        leases = {}
        for s in range(self.num_shards):
            info = self._get(shard_lease_name(s))
            leases[shard_lease_name(s)] = (
                None
                if info is None
                else {"holder": info["holder"], "expires_in_s": round(float(info.get("expires", 0.0)) - now, 3)}
            )
        out = {
            "replica_id": self.identity,
            "num_shards": self.num_shards,
            "owned": sorted(self.owned),
            "lease_duration_seconds": self.lease_duration,
            "leases": leases,
            "keyer": self.keyer.mode if self.keyer is not None else "hash",
            "map_generation": self.map_generation,
        }
        dm = getattr(self.keyer, "domain_map", None)
        if dm is not None:
            # Per-shard topology-domain + node-slice info (the fleet view
            # of /debug/shards — which racks each shard's columns span).
            out["shard_domains"] = {
                str(s): {"domains": list(dm.domains_of_shard(s)), "nodes": len(dm.shard_nodes[s])}
                for s in range(dm.num_shards)
            }
        return out
