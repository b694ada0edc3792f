"""Closed-loop autoscaler — elastic capacity as a first-class actor.

The rebalancer's what-if (nodes_needed / nodes_removable) only
recommends.  This package closes the loop from signal to capacity against a
deterministic simulated cloud provider: heterogeneous SKU catalogs with
hourly cost and per-SKU quotas, seeded provisioning latency (nodes join
through the ordinary FakeApiServer create-node path so the reflector and
delta engine see them organically), quota/stockout refusals, and
spot/preemptible reclaim with a short grace window.

Scale-up picks WHICH SKU by cost-aware FFD of the pending backlog over the
catalog, driven by the SLO-burn signal; scale-down routes through the
rebalancer's drain protocol (unbind → cordon → provider delete) with
reserve hysteresis against the rebalancer's drained-node parking so the
two subsystems never fight.  The sim scores it all on a pass-gated
"elasticity" scorecard block: a joint cost+SLO objective, scale decisions
and provisioning lag, and a reclaim-orphan count that is REQUIRED zero.

Modules:
  provider.py   — SimCloudProvider: the deterministic cloud (catalog,
                  quotas, provisioning queue, reclaim schedule, cost ledger)
  policy.py     — AutoscaleConfig, the closed skip taxonomy, the
                  cost-aware catalog FFD (pack_catalog), the throttle
  controller.py — Autoscaler: cadence + breaker/cooldown throttles, the
                  scale-up / scale-down tick, inline and background modes

Port: a copy of ``tpu_scheduler/autoscale/``, host code over the standard
library.  The nodes it joins enter the port's controller through the
ordinary create-node path, so the delta engine and ``CudaBackend``'s upload
cache see each new node set as any other.
"""

from .controller import Autoscaler
from .policy import SKIP_REASONS, AutoscaleConfig, pack_catalog
from .provider import (
    DEFAULT_CATALOG,
    PROVIDER_SKU_LABEL,
    InstanceSKU,
    ProviderError,
    QuotaExceeded,
    SimCloudProvider,
    Stockout,
    load_catalog,
)

__all__ = [
    "SKIP_REASONS",
    "DEFAULT_CATALOG",
    "PROVIDER_SKU_LABEL",
    "Autoscaler",
    "AutoscaleConfig",
    "InstanceSKU",
    "ProviderError",
    "QuotaExceeded",
    "SimCloudProvider",
    "Stockout",
    "load_catalog",
    "pack_catalog",
]
