"""coordination.k8s.io/v1 Lease objects + the client-side leader-election
algorithm (the kube client-go ``leaderelection`` recipe), shared by every
lease backend:

  * :class:`~tpu_scheduler_torch.runtime.fake_api.FakeApiServer` — in-process
    store with resourceVersion compare-and-swap;
  * :class:`KubeApiClient` of the JAX package's ``runtime/http_api.py`` (not
    ported yet) — the SAME
    algorithm over spec-shaped HTTP requests only (GET/POST/PUT Lease
    objects; no invented verbs), so it works against a real kube-apiserver.

The reference has no leader election (SURVEY.md §5); the capability anchor
is kube's own: a Lease object whose ``spec.holderIdentity`` names the
leader, renewed by CAS on ``metadata.resourceVersion`` — acquisition races
resolve at the server as update conflicts, never by server-side verbs.

Timestamps are RFC3339 MicroTime strings (kube's ``renewTime`` wire shape);
expiry is judged on the CALLER's clock (client-go semantics — the server
never decides leadership).

Port: a copy of ``tpu_scheduler/runtime/lease.py``, unchanged (pure host code).
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Callable

__all__ = [
    "LEASE_NAMESPACE",
    "format_micro_time",
    "parse_micro_time",
    "make_lease",
    "try_acquire_or_renew",
    "release",
]

# Where the scheduler parks its election Lease — kube-system, like
# kube-scheduler's own ``kube-system/kube-scheduler`` lease.
LEASE_NAMESPACE = "kube-system"


def format_micro_time(epoch: float) -> str:
    """RFC3339 with microseconds — kube MicroTime (e.g. 2026-07-30T12:00:00.000000Z)."""
    return datetime.fromtimestamp(epoch, tz=timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def parse_micro_time(s: str | None) -> float | None:
    if not s:
        return None
    try:
        return datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%fZ").replace(tzinfo=timezone.utc).timestamp()
    except ValueError:
        try:  # plain RFC3339 seconds (kube Time rather than MicroTime)
            return datetime.strptime(s, "%Y-%m-%dT%H:%M:%SZ").replace(tzinfo=timezone.utc).timestamp()
        except ValueError:
            return None


def make_lease(namespace: str, name: str, holder: str, duration_seconds: float, now: float) -> dict:
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "holderIdentity": holder,
            "leaseDurationSeconds": int(duration_seconds),
            "acquireTime": format_micro_time(now),
            "renewTime": format_micro_time(now),
            "leaseTransitions": 0,
        },
    }


def try_acquire_or_renew(
    get: Callable[[], dict | None],
    create: Callable[[dict], bool],
    update: Callable[[dict], bool],
    namespace: str,
    name: str,
    holder: str,
    duration_seconds: float,
    now: float,
) -> bool:
    """One election round (client-go ``tryAcquireOrRenew``): create the
    Lease if absent, renew it if held by us, take it over if expired or
    released — all through ``create``/``update`` primitives that return
    False on a conflict (409), which is how a lost race reads.  Returns
    True iff the caller holds the lease afterwards."""
    lease = get()
    if lease is None:
        return create(make_lease(namespace, name, holder, duration_seconds, now))
    spec = lease.get("spec") or {}
    current = spec.get("holderIdentity") or ""
    renew = parse_micro_time(spec.get("renewTime"))
    held_duration = float(spec.get("leaseDurationSeconds") or duration_seconds)
    if current and current != holder and renew is not None and now < renew + held_duration:
        return False  # held by a live leader
    takeover = current != holder
    new_spec = {
        "holderIdentity": holder,
        "leaseDurationSeconds": int(duration_seconds),
        "acquireTime": format_micro_time(now) if takeover else spec.get("acquireTime", format_micro_time(now)),
        "renewTime": format_micro_time(now),
        "leaseTransitions": int(spec.get("leaseTransitions") or 0) + (1 if takeover else 0),
    }
    return update({**lease, "spec": new_spec})


def release(
    get: Callable[[], dict | None],
    update: Callable[[dict], bool],
    holder: str,
    now: float,
) -> None:
    """Voluntary hand-off (client-go ``release``): clear ``holderIdentity``
    and shrink the duration so any standby's next round takes over
    immediately.  Only the holder releases; a CAS conflict means someone
    else already took the lease — nothing left to do either way."""
    lease = get()
    if lease is None or (lease.get("spec") or {}).get("holderIdentity") != holder:
        return
    spec = lease["spec"]
    new_spec = {
        **spec,
        "holderIdentity": "",
        "leaseDurationSeconds": 1,
        "renewTime": format_micro_time(now),
    }
    update({**lease, "spec": new_spec})
