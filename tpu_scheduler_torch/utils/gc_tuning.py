"""CPython GC tuning for daemon workloads.

The scheduler's steady state holds millions of long-lived objects (pods,
nodes, packed-tensor host buffers) while each cycle allocates hundreds of
thousands of short-lived ones (evolved API objects, watch events, bindings).
CPython's default gen-0 threshold of 700 allocations makes every ~700
allocations scan the young generation and periodically walk the WHOLE heap
(gen-2), which measured ~2x on the binding hot path at flagship scale
(90 µs -> 48 µs per FakeApiServer.create_binding with tuning; the same
effect Go servers get from GOGC tuning).  ``enable_daemon_gc_tuning``
raises the thresholds so collections amortize over real work; reference
counting still reclaims the non-cyclic majority immediately, and the API
objects are plain dataclasses with no reference cycles, so the delayed
cycle detection affects only genuinely cyclic garbage (rare here).

Opt out with TPU_SCHED_NO_GC_TUNING=1 (e.g. when embedding the scheduler
in a process whose GC cadence is owned elsewhere).

Port: a copy of ``tpu_scheduler/utils/gc_tuning.py``, unchanged (pure host code).
"""

from __future__ import annotations

import gc
import os

__all__ = ["enable_daemon_gc_tuning"]

_THRESHOLDS = (50_000, 20, 20)


def enable_daemon_gc_tuning() -> bool:
    """Raise the GC thresholds for daemon/throughput workloads; returns
    whether tuning was applied (False under the env opt-out)."""
    if os.environ.get("TPU_SCHED_NO_GC_TUNING"):
        return False
    gc.set_threshold(*_THRESHOLDS)
    return True
