"""Scheduling profiles — named policy configurations (copy of
``tpu_scheduler/models/profiles.py``, with its JSON artifact I/O).

Policy is data: score weights, the auction-round cap, the choose block
size, pool routing and preemption.  Profiles are the "models" of the
scheduler; the ``throughput`` profile drives the flagship cycle.  The tuned
profile artifacts of the JAX package (``tpu_scheduler/learn/profiles/``)
load here unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields, replace

import numpy as np

__all__ = ["PROFILE_SCHEMA_VERSION", "SchedulingProfile", "DEFAULT_PROFILE", "PROFILES"]

# Version of the tuned-profile JSON artifact (learn/profiles/*.json).
# ``from_file`` rejects any other version — a schema change must bump this
# and ship a migration, never silently reinterpret old artifacts.
PROFILE_SCHEMA_VERSION = 1

# The closed top-level schema of a profile artifact.  ``provenance`` is
# free-form (training config echo, held-out scores) and never read back
# into the profile; unknown top-level or profile keys are rejected.
ARTIFACT_FIELDS = ("schema_version", "profile", "provenance")


@dataclass(frozen=True)
class SchedulingProfile:
    name: str = "default"
    # Score weights (kube-scheduler defaults both at 1).
    least_requested_weight: float = 1.0
    balanced_allocation_weight: float = 1.0
    # Deterministic tie-spreading jitter (score points); spreads identical-
    # request pods across near-tied nodes so auction rounds don't herd.
    spread_jitter: float = 0.5
    # Auction-round safety cap (rounds needed ≈ max per-node contention).
    max_rounds: int = 32
    # Pods per choose-block (caps peak [block, N] tile memory on device).
    pod_block: int = 4096
    # Soft-term weights (ops/score.py):
    #   preferred_affinity_weight — scale of preferredDuringScheduling node-
    #     affinity points (pods declare 1-100 per term, kube-style);
    #   soft_taint_weight — score subtracted per untolerated PreferNoSchedule
    #     taint;
    #   topology_weight — penalty per matching pod already in the node's
    #     domain for ScheduleAnyway spread constraints (0 = off).
    preferred_affinity_weight: float = 1.0
    soft_taint_weight: float = 10.0
    topology_weight: float = 1.0
    # Rank-aware gang co-placement (topology/locality.py): score points per
    # interconnect-distance unit between a candidate node and the gang's
    # already-placed members, and the scale of the whole-gang-fits domain
    # bonus.  DELIBERATELY dominant over the ~200-point packing score at its
    # default: for tightly-coupled TPU workloads placement locality IS
    # communication performance, so a gang member prefers a worse-packed
    # node in the right slice over a better-packed node a rack away.
    # 0 disables the term (topology-blind gang scoring).
    gang_locality_weight: float = 64.0
    # Auction driver of the JAX package ("auto"/"monolithic"/"epochs").
    # The port has one eager driver; every value maps to it, since the JAX
    # drivers are bit-identical in results.
    driver: str = "auto"
    # Expert-parallel routing (parallel/routing.py): node label whose values
    # partition the cluster into per-pool scheduling shards; None = off.
    pool_key: str | None = None
    # Priority preemption (runtime/controller.py): pods the cycle could not
    # place for lack of RESOURCES may evict strictly-lower-priority victims
    # (kube PostFilter semantics).  Off by default: the synthetic cluster
    # has no controllers to recreate evicted pods.
    preemption: bool = False

    def __post_init__(self):
        if self.driver not in ("auto", "monolithic", "epochs"):
            raise ValueError(f"unknown driver {self.driver!r} (expected 'auto', 'monolithic' or 'epochs')")

    def weights(self) -> np.ndarray:
        return np.array(
            [
                self.least_requested_weight,
                self.balanced_allocation_weight,
                self.spread_jitter,
                self.preferred_affinity_weight,
                self.soft_taint_weight,
                self.topology_weight,
                self.gang_locality_weight,
            ],
            dtype=np.float32,
        )

    def with_(self, **kw) -> "SchedulingProfile":
        return replace(self, **kw)

    # -- JSON artifact round-trip (learn/profiles/*.json) -------------------

    def to_file(self, path: str, provenance: dict | None = None) -> None:
        """Write the versioned tuned-profile artifact.  Every dataclass
        field serializes (the artifact is the FULL policy, not a weight
        diff); ``provenance`` carries the training config echo and scores
        and is never read back into the profile."""
        doc = {
            "schema_version": PROFILE_SCHEMA_VERSION,
            "profile": {f.name: getattr(self, f.name) for f in fields(self)},
            "provenance": provenance or {},
        }
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=False)
            fh.write("\n")

    @classmethod
    def from_file(cls, path: str) -> "SchedulingProfile":
        """Load a tuned-profile artifact, strictly: wrong schema version,
        unknown top-level keys, or unknown profile keys all raise — a typo'd
        weight name must never silently fall back to the default."""
        with open(path) as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict):
            raise ValueError(f"profile artifact {path!r}: expected a JSON object")
        version = doc.get("schema_version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ValueError(
                f"profile artifact {path!r}: schema_version {version!r} "
                f"(this build reads version {PROFILE_SCHEMA_VERSION})"
            )
        unknown = sorted(set(doc) - set(ARTIFACT_FIELDS))
        if unknown:
            raise ValueError(f"profile artifact {path!r}: unknown top-level keys {unknown}")
        payload = doc.get("profile")
        if not isinstance(payload, dict):
            raise ValueError(f"profile artifact {path!r}: missing 'profile' object")
        known = {f.name for f in fields(cls)}
        bad = sorted(set(payload) - known)
        if bad:
            raise ValueError(f"profile artifact {path!r}: unknown profile keys {bad}")
        return cls(**payload)


DEFAULT_PROFILE = SchedulingProfile()

PROFILES: dict[str, SchedulingProfile] = {
    "default": DEFAULT_PROFILE,
    # Bin-packing flavour: prefer fuller nodes (negative least-requested).
    "most-requested": SchedulingProfile(name="most-requested", least_requested_weight=-1.0),
    # Pure spread on balanced allocation.
    "balanced-only": SchedulingProfile(name="balanced-only", least_requested_weight=0.0),
    # Mass-admission flavour — the flagship profile: a wide tie-break jitter
    # spreads each auction round's claims across many near-tied nodes,
    # cutting rounds at the cost of ±32 points of scoring noise.
    "throughput": SchedulingProfile(name="throughput", spread_jitter=32.0),
}
