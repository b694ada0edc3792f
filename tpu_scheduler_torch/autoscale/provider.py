"""Deterministic simulated cloud provider — the capacity side of the loop.

The same seeded-rng + VirtualClock discipline as ``sim/chaos.py``: every
draw (provision jitter, stockout, spot reclaim time) comes from ONE
dedicated rng in call order, calls happen only from the autoscaler's
cadence-gated tick (deterministic control flow), so a record→replay re-run
re-derives the identical provisioning schedule bit-identically — provider
node adds/deletes are deliberately NOT in the trace.

The lifecycle per node: ``request`` (quota + stockout checked, jittered
ready time drawn) → provisioning → ready (the node joins via the ordinary
``FakeApiServer`` create-node path, so the reflector/delta engine see it
organically) → optionally reclaiming (spot notice cordons the node, a
short grace later the provider force-unbinds survivors and deletes it) →
deleted.  Force-unbinds go through the chaos shim's faultable
``unbind_pod`` — a failed POST is retried next pump and a node is NEVER
deleted while a pod is still bound to it (the zero-orphan guarantee).

The cost ledger prices every node-interval (virtual seconds, per-SKU
hourly cost) — the cost integral of the ELASTIC capacity, the cost half of
the scorecard's joint objective.

Port: a copy of ``tpu_scheduler/autoscale/provider.py``, unchanged; ``ApiError``
and ``make_node`` are the port's own (``runtime/fake_api.py``,
``testing.py``).
"""

from __future__ import annotations

import http.client
import json
import random
from dataclasses import dataclass, replace as dc_replace

from ..runtime.fake_api import ApiError
from ..testing import make_node

__all__ = [
    "PROVIDER_SKU_LABEL",
    "InstanceSKU",
    "DEFAULT_CATALOG",
    "ProviderError",
    "QuotaExceeded",
    "Stockout",
    "SimCloudProvider",
    "load_catalog",
]

# Node-label marker on provider-provisioned nodes: names the SKU, survives
# crashes, and distinguishes elastic capacity from the scenario's base
# fleet — only labeled nodes are ever scale-down candidates.
PROVIDER_SKU_LABEL = "autoscale.tpu-scheduler/sku"


class ProviderError(Exception):
    """Base class for simulated provider failures."""


class QuotaExceeded(ProviderError):
    """The SKU's (or the account's) concurrent-node quota is exhausted."""


class Stockout(ProviderError):
    """The provider had no capacity for the SKU right now (seeded draw)."""


@dataclass(frozen=True)
class InstanceSKU:
    """One catalog entry: a purchasable node shape (catalogued in the
    README "Autoscaling & elasticity" section, drift-gated by ELAS)."""

    name: str
    cpu: int  # cores
    mem_gi: int  # GiB
    hourly_cost: float  # $ per node-hour (virtual hours)
    quota: int = 0  # max concurrent nodes of this SKU (0 = unbounded)
    provision_s: float = 8.0  # base provisioning latency (virtual seconds)
    provision_jitter_s: float = 4.0  # + uniform(0, jitter) per request
    stockout_rate: float = 0.0  # probability a request stockouts (per draw)
    spot: bool = False  # preemptible: eligible for provider reclaim
    ext: tuple[tuple[str, int], ...] = ()  # extended resources (key, count)


# The default catalog mirrors the workload generator's NODE_SHAPES plus one
# cheap preemptible shape — cost-aware FFD picks spot first when the
# scenario lets it (reclaim risk is the scenario's knob, not the SKU's).
DEFAULT_CATALOG = (
    InstanceSKU(name="std-8", cpu=8, mem_gi=32, hourly_cost=2.4, provision_s=6.0, provision_jitter_s=3.0),
    InstanceSKU(name="std-16", cpu=16, mem_gi=64, hourly_cost=4.8, provision_s=8.0, provision_jitter_s=4.0),
    InstanceSKU(name="std-32", cpu=32, mem_gi=128, hourly_cost=9.6, provision_s=12.0, provision_jitter_s=5.0),
    InstanceSKU(name="spot-16", cpu=16, mem_gi=64, hourly_cost=1.4, spot=True, provision_s=5.0, provision_jitter_s=2.0),
)

_ZONES = ("zone-a", "zone-b", "zone-c", "zone-d")  # workload.py's zones


# shape: (path: str) -> obj
def load_catalog(path: str) -> tuple[InstanceSKU, ...]:
    """Parse a ``--catalog-file`` JSON list of SKU dicts (field names match
    ``InstanceSKU``; ``ext`` may be a {resource: count} object)."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, list) or not raw:
        raise ValueError(f"catalog file {path!r} must hold a non-empty JSON list of SKU objects")
    skus = []
    for entry in raw:
        ext = entry.pop("ext", None)
        if isinstance(ext, dict):
            entry["ext"] = tuple(sorted((k, int(v)) for k, v in ext.items()))
        elif ext is not None:
            entry["ext"] = tuple(tuple(e) for e in ext)
        skus.append(InstanceSKU(**entry))
    names = [s.name for s in skus]
    if len(set(names)) != len(names):
        raise ValueError(f"catalog file {path!r} repeats a SKU name")
    return tuple(skus)


# protocol: machine provider-node field=state init=provisioning
# protocol: states: provisioning | ready | reclaiming | deleted
# protocol: provisioning -> ready | deleted
# protocol: ready -> reclaiming | deleted
# protocol: reclaiming -> deleted
# protocol: var pods: 0..2 = 0
# protocol: action join: provisioning -> ready
# protocol: env bind: ready -> ready effect pods += 1
# protocol: env notice: ready -> reclaiming
# protocol: env bind-raced: reclaiming -> reclaiming effect pods += 1
# protocol: action unbind: reclaiming -> reclaiming requires pods >= 1 effect pods -= 1
# protocol: action kill: reclaiming -> deleted requires pods == 0
# protocol: action delete: ready -> deleted requires pods == 0
# protocol: action delete-pending: provisioning -> deleted
# protocol: invariant delete-only-when-empty: state == deleted implies pods == 0
# protocol: progress reclaim-completes: state == reclaiming
class SimCloudProvider:
    """The deterministic cloud: catalog, quotas, provisioning queue, spot
    reclaim schedule, and the node-hour cost ledger.

    The ``# protocol:`` contract above models one provider node's
    lifecycle composed with the scheduler environment: ``bind`` is a pod
    landing on the node (it keeps landing right through the reclaim grace
    — ``bind-raced`` is the bind that slips in under ``_kill``'s unbind
    loop), ``notice`` is the spot reclaim condemning the node, and both
    delete paths (``kill`` at the reclaim deadline, ``delete`` at
    scale-down) carry the structural guard the docstrings promise: a node
    is deleted only when verifiably empty — MODL proves
    ``delete-only-when-empty`` holds in every reachable composite state,
    and that a reclaiming node can always make progress (unbind until
    empty, then kill).

    ONE instance per cluster (shared across sharded replicas — a shard-0
    takeover inherits in-flight provisions and reclaim deadlines).  All
    mutation happens from the owning tick's thread; debug readers take
    GIL-atomic copies via ``stats()``."""

    def __init__(
        self,
        api,
        clock,
        rng: random.Random | None = None,
        catalog: tuple[InstanceSKU, ...] = DEFAULT_CATALOG,
        total_quota: int = 0,
        reclaim_rate: float = 0.0,
        reclaim_grace_s: float = 5.0,
    ):
        if not catalog:
            raise ValueError("SimCloudProvider needs a non-empty SKU catalog")
        self.api = api  # the chaos shim in the sim — unbinds stay faultable
        self.clock = clock
        self.rng = rng or random.Random(0)
        self.catalog = tuple(catalog)
        self.by_name = {s.name: s for s in self.catalog}
        if len(self.by_name) != len(self.catalog):
            raise ValueError("catalog repeats a SKU name")
        self.total_quota = int(total_quota)  # account-wide cap (0 = unbounded)
        self.reclaim_rate = float(reclaim_rate)  # spot reclaims per virtual second
        self.reclaim_grace_s = float(reclaim_grace_s)
        # One dict per requested node, in request order (the deterministic
        # iteration order of every pump): name, sku, requested_at, ready_at,
        # joined_at, reclaim_at, kill_at, deleted_at, state.
        self.records: list[dict] = []
        self._by_node: dict[str, dict] = {}
        self._seq = 0
        self.quota_errors = 0
        self.stockout_errors = 0
        self.reclaim_notices = 0
        self.reclaimed = 0
        # Pod full names the provider force-unbound at reclaim deadlines —
        # the scorecard's reclaim-orphan evidence (ordered, append-only).
        self.reclaim_unbound: list[str] = []

    # -- accounting ---------------------------------------------------------

    def _active(self, sku_name: str | None = None) -> int:
        return sum(
            1
            for rec in self.records
            if rec["state"] != "deleted" and (sku_name is None or rec["sku"] == sku_name)
        )

    # shape: (self: obj) -> dict
    def quota_left(self) -> dict:
        """Remaining request headroom per SKU (None = unbounded) — what the
        catalog FFD plans against so a plan never asks past a quota."""
        account = None if self.total_quota <= 0 else max(0, self.total_quota - self._active())
        out: dict = {}
        for sku in self.catalog:
            per = None if sku.quota <= 0 else max(0, sku.quota - self._active(sku.name))
            if per is None:
                out[sku.name] = account
            elif account is None:
                out[sku.name] = per
            else:
                out[sku.name] = min(per, account)
        return out

    # shape: (self: obj) -> int
    def pending_provisions(self) -> int:
        return sum(1 for rec in self.records if rec["state"] == "provisioning")

    # shape: (self: obj) -> dict
    def ready_nodes(self) -> dict:
        """Live provider-owned nodes (name -> SKU name), excluding ones a
        reclaim notice already condemned — the scale-down candidate set."""
        return {rec["name"]: rec["sku"] for rec in self.records if rec["state"] == "ready"}

    # -- the provider API ---------------------------------------------------

    # shape: (self: obj, sku_name: str, now: float) -> str
    def request(self, sku_name: str, now: float) -> str:
        """Ask for one node of the SKU.  Raises ``QuotaExceeded`` (checked
        first, no draw) or ``Stockout`` (one seeded draw); otherwise draws
        the jittered ready time (+ the reclaim time for spot shapes under a
        reclaim regime) and queues the provision."""
        sku = self.by_name.get(sku_name)
        if sku is None:
            raise ProviderError(f"unknown SKU {sku_name!r}")
        if sku.quota > 0 and self._active(sku_name) >= sku.quota:
            self.quota_errors += 1
            raise QuotaExceeded(f"SKU {sku_name} quota ({sku.quota}) exhausted")
        if self.total_quota > 0 and self._active() >= self.total_quota:
            self.quota_errors += 1
            raise QuotaExceeded(f"account quota ({self.total_quota}) exhausted")
        if sku.stockout_rate > 0 and self.rng.random() < sku.stockout_rate:
            self.stockout_errors += 1
            raise Stockout(f"SKU {sku_name} out of capacity")
        name = f"auto-{sku_name}-{self._seq}"
        zone = _ZONES[self._seq % len(_ZONES)]
        self._seq += 1
        ready_at = now + sku.provision_s
        if sku.provision_jitter_s > 0:
            ready_at += self.rng.uniform(0.0, sku.provision_jitter_s)
        reclaim_at = None
        if sku.spot and self.reclaim_rate > 0:
            reclaim_at = ready_at + self.rng.expovariate(self.reclaim_rate)
        rec = {
            "name": name,
            "sku": sku_name,
            "zone": zone,
            "requested_at": round(now, 9),
            "ready_at": round(ready_at, 9),
            "joined_at": None,
            "reclaim_at": round(reclaim_at, 9) if reclaim_at is not None else None,
            "kill_at": None,
            "deleted_at": None,
            "state": "provisioning",
        }
        self.records.append(rec)
        self._by_node[name] = rec
        return name

    def _live_node(self, name: str):
        for n in self.api.list_nodes():
            if n.name == name:
                return n
        return None

    def _cordon(self, name: str) -> bool:
        """Mark the node unschedulable in place (the reclaim NOTICE) so the
        scheduler stops placing onto capacity the provider condemned."""
        node = self._live_node(name)
        if node is None:
            return False
        from ..api.objects import NodeSpec

        spec = node.spec if node.spec is not None else NodeSpec()
        try:
            self.api.update_node(dc_replace(node, spec=dc_replace(spec, unschedulable=True)))
        except (ApiError, OSError, http.client.HTTPException):
            return False  # retried next pump — the deadline still stands
        return True

    # shape: (self: obj, now: float) -> dict
    def pump(self, now: float) -> dict:
        """Advance every in-flight lifecycle to ``now`` (called every tick,
        cadence or not): join ready provisions via the ordinary create-node
        path, issue due reclaim notices (cordon), and past each grace
        deadline force-unbind survivors then delete the empty node."""
        out = {"joined": 0, "reclaim_notices": 0, "reclaim_kills": 0, "reclaim_unbinds": 0}
        for rec in self.records:
            if rec["state"] == "provisioning" and rec["ready_at"] <= now:
                sku = self.by_name[rec["sku"]]
                self.api.create_node(
                    make_node(
                        rec["name"],
                        cpu=sku.cpu,
                        memory=f"{sku.mem_gi}Gi",
                        labels={"zone": rec["zone"], "name": rec["name"], PROVIDER_SKU_LABEL: sku.name},
                        extended=dict(sku.ext) if sku.ext else None,
                    )
                )
                rec["state"] = "ready"
                rec["joined_at"] = round(now, 9)
                out["joined"] += 1
            if rec["state"] == "ready" and rec["reclaim_at"] is not None and now >= rec["reclaim_at"]:
                self._cordon(rec["name"])  # best effort — the deadline rules
                rec["state"] = "reclaiming"
                rec["kill_at"] = round(now + self.reclaim_grace_s, 9)
                self.reclaim_notices += 1
                out["reclaim_notices"] += 1
            if rec["state"] == "reclaiming" and now >= rec["kill_at"]:
                if self._kill(rec, out):
                    rec["state"] = "deleted"
                    rec["deleted_at"] = round(now, 9)
                    self.reclaimed += 1
                    out["reclaim_kills"] += 1
        return out

    def _kill(self, rec: dict, out: dict) -> bool:
        """The reclaim deadline: force-unbind every surviving pod through
        the (faultable) unbind path, then delete the node ONLY once it is
        verifiably empty.  A failed unbind aborts — retried next pump, so a
        chaos-injected 500 can delay a reclaim but never orphan a pod."""
        from ..api.objects import full_name

        name = rec["name"]
        for pod in sorted(self.api.list_pods(f"spec.nodeName={name}"), key=lambda p: p.metadata.name):
            try:
                self.api.unbind_pod(pod.metadata.namespace or "default", pod.metadata.name, expect_node=name)
            except (ApiError, OSError, http.client.HTTPException):
                return False
            self.reclaim_unbound.append(full_name(pod))
            out["reclaim_unbinds"] += 1
        if self.api.list_pods(f"spec.nodeName={name}"):
            return False  # a bind landed under us — never delete over a pod
        self.api.delete_node(name)
        return True

    # shape: (self: obj, name: str, now: float) -> bool
    def delete(self, name: str, now: float) -> bool:
        """Scale-down delete of one provider-owned node.  Refuses (False)
        unless the node is verifiably empty — the drain protocol must have
        emptied it first; the zero-orphan guarantee is structural."""
        rec = self._by_node.get(name)
        if rec is None or rec["state"] == "deleted":
            return False
        if self.api.list_pods(f"spec.nodeName={name}"):
            return False
        if rec["state"] != "provisioning":
            self.api.delete_node(name)
        rec["state"] = "deleted"
        rec["deleted_at"] = round(now, 9)
        return True

    # -- evidence -----------------------------------------------------------

    # shape: (self: obj) -> obj
    def provision_lags(self) -> list:
        """Virtual request→join latency per landed node, in join order."""
        return [
            round(rec["joined_at"] - rec["requested_at"], 9)
            for rec in self.records
            if rec["joined_at"] is not None
        ]

    # shape: (self: obj, end_t: float) -> float
    def cost_node_hours(self, end_t: float) -> float:
        """The cost integral: Σ hourly_cost × (lifetime virtual hours) over
        every node that ever joined (still-live nodes price to ``end_t``)."""
        total = 0.0
        for rec in self.records:
            if rec["joined_at"] is None:
                continue
            until = rec["deleted_at"] if rec["deleted_at"] is not None else end_t
            total += self.by_name[rec["sku"]].hourly_cost * max(0.0, until - rec["joined_at"]) / 3600.0
        return round(total, 9)

    # shape: (self: obj) -> dict
    def stats(self) -> dict:
        """Lifetime counters + per-SKU landed census (strictly virtual-time
        / control-flow quantities — scorecard-safe)."""
        skus: dict[str, int] = {}
        for rec in self.records:
            if rec["joined_at"] is not None:
                skus[rec["sku"]] = skus.get(rec["sku"], 0) + 1
        return {
            "requested": len(self.records),
            "pending_provisions": self.pending_provisions(),
            "ready": sum(1 for r in self.records if r["state"] in ("ready", "reclaiming")),
            "deleted": sum(1 for r in self.records if r["state"] == "deleted"),
            "skus": dict(sorted(skus.items())),
            "quota_errors": self.quota_errors,
            "stockout_errors": self.stockout_errors,
            "reclaim_notices": self.reclaim_notices,
            "reclaimed": self.reclaimed,
            "reclaim_unbound": len(self.reclaim_unbound),
        }
