"""Error model — the part of ``tpu_scheduler/errors.py`` the port raises."""

from __future__ import annotations

__all__ = ["SchedulerError", "BackendUnavailable", "PackingError"]


class SchedulerError(Exception):
    """Base class for all framework errors."""


class BackendUnavailable(SchedulerError):
    """The requested scheduling backend (e.g. CUDA) cannot run: no device,
    or a device-runtime failure during the cycle."""


class PackingError(SchedulerError, KeyError):
    """Snapshot → tensor packing failed — a supplied vocabulary does not
    cover the cluster (ops/pack.py).  Subclasses KeyError so callers holding
    a cached vocab can treat it as the cache-miss it is."""
