"""Coverage map: (fault-op × subsystem-state-at-injection) pairs.

A fault op is only interesting relative to what the scheduler was *doing*
when it landed: a lease 500 during a takeover is a different test than the
same 500 against an idle fleet.  The oracle samples a small closed set of
subsystem facets (:data:`STATE_FACETS`) at the cycle each op first becomes
active and records one (kind, facet) pair per facet.  The generator then
biases kind selection toward ops with unseen facets, steering random search
into the interleavings the scripted scenarios never pinned.

Port: a copy of ``tpu_scheduler/sim/fuzz/coverage.py``.
"""

from __future__ import annotations

__all__ = ["STATE_FACETS", "CoverageMap", "sample_facets"]

# Closed facet vocabulary — one axis per subsystem whose in-flight state
# changes what a fault can break.
STATE_FACETS = (
    "breaker-closed",  # every live replica's circuit breaker is closed
    "breaker-open",  # some live breaker is open or half-open
    "shards-stable",  # shard ownership unchanged since the previous cycle
    "shards-churning",  # ownership moved (takeover / rebalance of shards)
    "rebalance-idle",  # no drain migrations in flight
    "rebalance-active",  # drain migrations in flight on a live replica
    "autoscale-idle",  # no provider provisions pending
    "autoscale-active",  # provider provisions pending
    "fleet-full",  # every replica alive
    "fleet-degraded",  # at least one replica crashed/killed
)


class CoverageMap:
    """Counting map of (fault-op kind, state facet) pairs."""

    def __init__(self) -> None:
        self.pairs: dict[tuple[str, str], int] = {}

    # shape: (kind: str, facets: obj) -> obj
    def record(self, kind: str, facets: tuple[str, ...]) -> None:
        for facet in facets:
            key = (kind, facet)
            self.pairs[key] = self.pairs.get(key, 0) + 1

    def distinct(self) -> int:
        return len(self.pairs)

    def lease_pairs(self) -> int:
        """Distinct pairs whose op kind is one of the lease faults."""
        return sum(1 for kind, _facet in self.pairs if kind.startswith("lease-"))

    # shape: (kind: str) -> int
    def unseen(self, kind: str) -> int:
        """How many facets this kind has never been injected under —
        the generator's bias weight."""
        seen = sum(1 for k, _facet in self.pairs if k == kind)
        return len(STATE_FACETS) - seen

    def to_json(self) -> list:
        """Deterministic listing: sorted (kind, facet, count) triples."""
        return [[k, f, self.pairs[(k, f)]] for k, f in sorted(self.pairs)]


# shape: (ctx: obj, prev_owned: obj) -> (obj, obj)
def sample_facets(ctx, prev_owned) -> tuple[tuple[str, ...], tuple]:
    """Read the subsystem facets out of an EpisodeContext at cycle start.

    ``prev_owned`` is the previous cycle's ownership snapshot (or None on
    the first sample); churn is ownership delta between the two.  Reads are
    strictly side-effect free: breaker state comes from the ``.state``
    attribute (``mode()`` would promote open → half-open as a side effect).
    """
    fleet = ctx.fleet
    live = [r for i, r in enumerate(fleet.scheds) if fleet.alive[i]]
    breaker_open = any(r.breaker.state != "closed" for r in live)
    owned = tuple(
        tuple(sorted(r.shard_set.owned)) if getattr(r, "shard_set", None) is not None else ()
        for i, r in enumerate(fleet.scheds)
        if fleet.alive[i]
    )
    churning = prev_owned is not None and owned != prev_owned
    rebalance_active = any(getattr(r, "rebalancer", None) is not None and r.rebalancer.inflight for r in live)
    provider = getattr(fleet, "provider", None)
    autoscale_active = provider is not None and provider.pending_provisions() > 0
    degraded = not all(fleet.alive)
    facets = (
        "breaker-open" if breaker_open else "breaker-closed",
        "shards-churning" if churning else "shards-stable",
        "rebalance-active" if rebalance_active else "rebalance-idle",
        "autoscale-active" if autoscale_active else "autoscale-idle",
        "fleet-degraded" if degraded else "fleet-full",
    )
    return facets, owned
