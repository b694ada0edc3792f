"""Error model — copy of ``tpu_scheduler/errors.py``: the reconcile errors
the controller requeues on, plus the backend and packing failures."""

from __future__ import annotations

__all__ = [
    "SchedulerError",
    "ReconcileError",
    "CreateBindingFailed",
    "CreateBindingObjectFailed",
    "NoNodeFound",
    "BackendUnavailable",
    "PackingError",
]


class SchedulerError(Exception):
    """Base class for all framework errors."""


class ReconcileError(SchedulerError):
    """A reconcile-cycle failure; the controller's error policy requeues it."""


class CreateBindingFailed(ReconcileError):
    """The API server rejected the Binding POST."""


class CreateBindingObjectFailed(ReconcileError):
    """The Binding object could not be constructed/serialised."""


class NoNodeFound(ReconcileError):
    """No feasible node for the pod this cycle."""


class BackendUnavailable(SchedulerError):
    """The requested scheduling backend (e.g. CUDA) cannot run: no device,
    or a device-runtime failure during the cycle.  The controller re-raises
    it unless a fallback backend was given (the port wires none)."""


class PackingError(SchedulerError, KeyError):
    """Snapshot → tensor packing failed — a supplied vocabulary does not
    cover the cluster (ops/pack.py).  Subclasses KeyError so callers holding
    a cached vocab can treat it as the cache-miss it is (the controller's
    incremental-pack fallback, runtime/controller.py)."""
