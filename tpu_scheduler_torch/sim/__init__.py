"""Deterministic cluster simulator + chaos harness — the port of
``tpu_scheduler/sim/``.

A seeded discrete-event simulation around the port's real ``Scheduler``
over ``CudaBackend`` (on the card by default; ``CudaBackend(device="cpu")``
on the CPU), driven by virtual time.  Held against the JAX sim over
NativeBackend, scorecard for scorecard.

Modules (each a copy of its JAX twin unless said otherwise):
  • ``clock``     — ``VirtualClock``: virtual time that advances to the next
                    scheduled event instead of sleeping
  • ``workload``  — seeded workload generator: Poisson/burst pod arrivals,
                    gang jobs, priority tiers, pod lifetimes, node churn
  • ``chaos``     — ``ChaosApiServer``: the programmable fault layer over
                    ``FakeApiServer``
  • ``trace``     — JSONL record/replay (the same format: traces replay
                    across the two packages)
  • ``scorecard`` — the invariants I1–I4 plus virtual-time SLOs, one JSON
                    verdict
  • ``scenarios`` — the named scenario registry (all 25)
  • ``multi``     — the replica harness: N replicas over lease-owned
                    shards, the kill schedule and the takeover verdict,
                    the rebalancer and the autoscaler's shared provider
  • ``harness``   — the discrete-event loop; runs all 25 scenarios
  • ``fuzz``      — the coverage-guided chaos fuzzer over fault plans
                    (two replicas over four shards per base workload)
  • ``cli``       — ``python -m tpu_scheduler_torch.cli sim --scenario X
                    --seed N [--device cpu]``, ``sim fuzz`` and ``sim
                    train`` (``learn/cli.py``)
"""

from .chaos import ChaosApiServer, ChaosConfig, ChaosWindow
from .clock import VirtualClock
from .harness import run_scenario
from .scenarios import SCENARIOS, Scenario
from .workload import WorkloadSpec

__all__ = [
    "ChaosApiServer",
    "ChaosConfig",
    "ChaosWindow",
    "VirtualClock",
    "run_scenario",
    "SCENARIOS",
    "Scenario",
    "WorkloadSpec",
]
