"""Distillation — the winning vector becomes a runtime artifact.

The whole point of the subsystem: "learned" must cost NOTHING at inference.
A training run's output is just a ``SchedulingProfile`` serialized as the
versioned JSON artifact (``models/profiles.py`` schema), loadable via
``SchedulingProfile.from_file`` / CLI ``--profile-file`` — the tuned
weights ride the existing fused choose path (the plain torch versions
and the CUDA kernels) exactly like the defaults did, so the steady-state delta-cycle
bench is unchanged by construction (bench.py ``policy_row`` holds that).

``provenance`` makes every artifact auditable: the full ``SearchConfig``
echo (one seed reproduces the run), the objective version it was trained
against, the per-generation history, and the held-out table tuned-vs-
default — the numbers the PR reports.

Port: a copy of ``tpu_scheduler/learn/distill.py``, unchanged.
"""

from __future__ import annotations

from dataclasses import asdict

from ..models.profiles import SchedulingProfile
from .objective import OBJECTIVE_VERSION

__all__ = ["distill", "load_profile"]


def distill(result, out_path: str) -> dict:
    """Write the tuned-profile artifact for a finished ``TrainResult``;
    returns the provenance block that went into it."""
    # shape: (result: obj, out_path: str) -> obj
    cfg = result.config
    provenance = {
        "objective_version": OBJECTIVE_VERSION,
        "search": asdict(cfg) if cfg is not None else {},
        "vector": list(result.vector),
        "improved": bool(result.improved),
        "train_objective": result.train_objective,
        "default_train_objective": result.default_train_objective,
        "held_out": dict(result.held_out),
        "default_held_out": dict(result.default_held_out),
        "history": list(result.history),
    }
    result.profile.to_file(out_path, provenance)
    return provenance


def load_profile(path: str) -> SchedulingProfile:
    """Load any profile artifact (tuned or the checked-in default) —
    strict: schema-version and unknown-key violations raise."""
    # shape: (path: str) -> obj
    return SchedulingProfile.from_file(path)
