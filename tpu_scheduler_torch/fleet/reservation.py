"""Cross-replica gang admission — two-phase reserve/commit over leases.

A gang wider than its owner's topology slice cannot admit all-or-nothing
from one shard's node columns.  The owner RESERVES the peer shards whose
slices complete the span — one lease per (gang, peer shard), acquired
through the same CAS primitives every other coordination path uses — and
only then solves the gang against the widened slice:

  reserved   every peer lease acquired (all-or-nothing: one refused CAS
             rolls back the ones already taken)
  committed  the gang admitted (or left the pending set); the reservation
             leases release immediately
  aborted    a peer lease was refused, or the owner gave the span back —
             acquired leases release in the same round
  expired    the owner stopped renewing (crash) and the TTL reclaimed the
             rows — no survivor action needed, which is exactly why the
             chaos verdict can require ZERO orphaned reservations

``RESERVATION_STATES`` is the closed state vocabulary and
``GANG_RESERVATION_PREFIX`` the lease namespace, both drift-gated against
the README "Multi-mesh fleet" catalogue by the FLET analyze rule.  Renewal
rides the shard-refresh cadence (the cycle cadence), so ``cycle_interval <
lease_duration`` covers reservations too.

Port: a copy of ``tpu_scheduler/fleet/reservation.py``.
"""

from __future__ import annotations

__all__ = [
    "RESERVATION_STATES",
    "GANG_RESERVATION_PREFIX",
    "reservation_lease_name",
    "GangReservationLedger",
    "count_orphaned_reservations",
]

# The closed reservation-state vocabulary (FLET-gated against the README).
RESERVATION_STATES = ("reserved", "committed", "aborted", "expired")

# Lease-name namespace: gang ``g`` reserving shard ``s`` holds
# ``tpu-scheduler-gang-<g>-<s>`` beside the shard/replica leases.
GANG_RESERVATION_PREFIX = "tpu-scheduler-gang-"


# shape: (gang: str, shard: int) -> str
def reservation_lease_name(gang: str, shard: int) -> str:
    return f"{GANG_RESERVATION_PREFIX}{gang}-{shard}"


# protocol: machine gang-reservation field=counts[] states=RESERVATION_STATES init=reserved
# protocol: reserved -> committed | aborted | expired
# protocol: var leases: 0..2 = 2
# protocol: var alive: 0..1 = 1
# protocol: action commit: reserved -> committed requires alive == 1
# protocol: action abort: reserved -> aborted requires alive == 1
# protocol: action release: committed -> committed requires leases > 0 effect leases -= 1
# protocol: action release-abort: aborted -> aborted requires leases > 0 effect leases -= 1
# protocol: env crash: reserved -> reserved effect alive = 0
# protocol: env ttl: reserved -> expired requires alive == 0 effect leases = 0
# protocol: env ttl-sweep: committed -> committed requires leases > 0 effect leases -= 1
# protocol: env ttl-sweep-abort: aborted -> aborted requires leases > 0 effect leases -= 1
# protocol: invariant expired-clean: state == expired implies leases == 0
# protocol: progress no-orphaned-reservation: leases > 0
class GangReservationLedger:
    """Per-replica ledger of in-flight gang reservations.

    Main-thread state driven from the controller's cycle loop (the ShardSet
    stance): reserve/renew/commit/abort all happen between solve phases, and
    the injected clock keeps simulated replicas bit-identical.

    The ``# protocol:`` contract above binds ``counts`` (keyed-counter
    form: every subscript literal must be a RESERVATION_STATES member, and
    every member must appear — one source of truth) and models one
    reservation holding two peer-shard leases.  MODL proves
    ``no-orphaned-reservation`` (a held lease always has an enabled
    release or TTL path — never wedged) and ``expired-clean`` (the TTL
    reclaim leaves nothing behind), including across owner crash.
    """

    def __init__(self, api, identity: str, lease_duration: float, clock):
        self.api = api
        self.identity = identity
        self.lease_duration = float(lease_duration)
        self.clock = clock
        # gang -> tuple of reserved peer shards (live reservations only).
        self._active: dict[str, tuple] = {}
        self.counts = {state: 0 for state in RESERVATION_STATES}

    # shape: (self: obj, gang: str, peer_shards: obj) -> bool
    def reserve(self, gang: str, peer_shards) -> bool:
        """Acquire every peer-shard lease or none: the first refused CAS
        releases the ones already taken and reports the reservation aborted.
        Re-reserving an active gang renews instead of double-counting."""
        if gang in self._active:
            return True
        acquired: list = []
        ok = True
        for s in peer_shards:
            try:
                got = self.api.acquire_lease(reservation_lease_name(gang, s), self.identity, self.lease_duration)
            except Exception:
                got = False  # lease-endpoint brownout refuses, never raises into the cycle
            if not got:
                ok = False
                break
            acquired.append(s)
        if not ok:
            for s in acquired:
                self._release(gang, s)
            self.counts["aborted"] += 1
            return False
        self._active[gang] = tuple(acquired)
        self.counts["reserved"] += 1
        return True

    def _release(self, gang: str, shard) -> None:
        try:
            self.api.release_lease(reservation_lease_name(gang, shard), self.identity)
        except Exception:
            pass  # TTL reclaims what a brownout kept us from releasing

    # shape: (self: obj) -> int
    def renew(self) -> int:
        """Renew every active reservation (the refresh-cadence heartbeat).
        A lost CAS means the TTL already expired and another actor took the
        row — the reservation is EXPIRED, dropped so the next cycle
        re-reserves from scratch.  Returns the number expired."""
        expired = 0
        for gang in sorted(self._active):
            held = []
            for s in self._active[gang]:
                try:
                    got = self.api.acquire_lease(reservation_lease_name(gang, s), self.identity, self.lease_duration)
                except Exception:
                    got = False
                if got:
                    held.append(s)
            if len(held) != len(self._active[gang]):
                for s in held:
                    self._release(gang, s)
                del self._active[gang]
                self.counts["expired"] += 1
                expired += 1
        return expired

    # shape: (self: obj, gang: str) -> bool
    def commit(self, gang: str) -> bool:
        """The gang admitted (every member placed, or it left the pending
        set): release the reserved rows immediately — peers reclaim their
        slices without waiting out the TTL."""
        shards = self._active.pop(gang, None)
        if shards is None:
            return False
        for s in shards:
            self._release(gang, s)
        self.counts["committed"] += 1
        return True

    # shape: (self: obj, gang: str) -> bool
    def abort(self, gang: str) -> bool:
        """Give the span back without admission (the gang stayed
        unschedulable even against the widened slice)."""
        shards = self._active.pop(gang, None)
        if shards is None:
            return False
        for s in shards:
            self._release(gang, s)
        self.counts["aborted"] += 1
        return True

    # shape: (self: obj) -> obj
    def active_shards(self) -> set:
        """Union of peer shards currently reserved — the extra node slices
        the owner's cycle snapshot widens to."""
        out: set = set()
        for shards in self._active.values():
            out.update(shards)
        return out

    # shape: (self: obj) -> obj
    def active(self) -> dict:
        """gang -> sorted reserved peer shards (the /debug/shards view)."""
        return {g: sorted(s) for g, s in sorted(self._active.items())}

    # shape: (self: obj) -> obj
    def debug(self) -> dict:
        return {"active": self.active(), "counts": dict(self.counts)}

    def release_all(self) -> None:
        """Clean shutdown: hand every reservation back immediately."""
        for gang in sorted(self._active):
            self.abort(gang)


# shape: (api: obj, now: float, live_holders: obj) -> int
def count_orphaned_reservations(api, now: float, live_holders) -> int:
    """Unexpired gang-reservation leases held by NO live replica — the
    chaos verdict's zero-orphans evidence.  A crashed owner's reservations
    stop renewing and expire within one TTL, so a settled fleet must count
    zero here; an API without a lease-collection route counts zero
    vacuously (the sim's FakeApiServer always has one)."""
    lister = getattr(api, "list_lease_summaries", None)
    if lister is None:
        return 0
    n = 0
    for info in lister():
        if (
            info["name"].startswith(GANG_RESERVATION_PREFIX)
            and info.get("holder")
            and info["holder"] not in live_holders
            and now < float(info.get("expires", 0.0))
        ):
            n += 1
    return n
