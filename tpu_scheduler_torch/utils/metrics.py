"""Cycle metrics — pods-bound/sec and cycle wall-clock are the north-star
numbers (BASELINE.md); the reference exposes no metrics at all (SURVEY.md §5).

The registry is a real (if minimal) Prometheus-style registry: unlabeled and
LABELED counters, bucketed histograms (phase latencies, binding latency,
rounds-per-cycle), and last-cycle gauges, exported in valid text exposition
(version 0.0.4) by ``to_prometheus``.  Labeled counters live in the same
``counters`` dict as unlabeled ones under pre-formatted
``name{label="value"}`` keys — one flat dict keeps the checkpoint format
(runtime/checkpoint.py persists ``counters`` verbatim) and the CLI summary
line unchanged while the exposition groups series into families.

Thread-safety contract: every mutation AND every read path goes through
``_lock``; ``to_prometheus`` is derived strictly from one locked
``_snapshot_full()`` so a worker-thread ``inc`` can never race the /metrics
scrape mid-iteration (dict-resize under iteration was a real crash class).

Port: a copy of ``tpu_scheduler/utils/metrics.py`` (pure host code), with
``CycleMetrics``' fields beyond the phases: ``spans``, ``constraint_widths``,
``gc_*``, ``bind_*``.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from dataclasses import dataclass, field, fields

__all__ = ["CycleMetrics", "MetricsRegistry", "cycle_phases", "format_labels", "escape_label_value"]

# Latency buckets (seconds): sub-ms host phases through multi-second
# constrained cycles at flagship shapes.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Auction rounds per cycle: the round-5 work holds the flagship at 2.
ROUNDS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# Requeue backoff delays (seconds): sub-second fast-class retries through
# the reference's 5-minute flat delay and the long no-node escalation cap.
BACKOFF_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 150.0, 300.0, 600.0, 1200.0)
# Worst pairwise interconnect distance of an admitted gang's placement
# (topology/ levels differing, weighted): 0 = one slice, through a few
# hierarchy levels — fractional bounds cover non-unit level weights.
DISTANCE_BUCKETS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0)
# Final pending age (first-seen to bind/exit) per SLO tier: sub-second
# same-cycle binds through multi-minute backlog pain past every tier target
# (utils/profiler.SLO_TIERS tops out at 1200 s).
PENDING_AGE_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1200.0, 3600.0)
# Dirty-set size per delta cycle (tpu_scheduler/delta): single-pod watch
# ripples through flagship-scale churn waves.
DIRTY_BUCKETS = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0)
# Per-segment time-to-bind attribution (utils/events.SEGMENTS): zero-width
# same-cycle segments through multi-minute backoff/backlog residency — the
# low end needs sub-cadence resolution (one cycle interval ~ 1 s).
TTB_SEGMENT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

# Histogram name -> bucket bounds; the one registration point the README
# drift gate (scripts/lint.py) and to_prometheus share.
HISTOGRAM_BUCKETS = {
    "scheduler_cycle_seconds": LATENCY_BUCKETS,
    "scheduler_phase_seconds": LATENCY_BUCKETS,
    "scheduler_binding_seconds": LATENCY_BUCKETS,
    "scheduler_cycle_rounds": ROUNDS_BUCKETS,
    "scheduler_backoff_seconds": BACKOFF_BUCKETS,
    "scheduler_gang_placement_distance": DISTANCE_BUCKETS,
    "scheduler_pending_age_seconds": PENDING_AGE_BUCKETS,
    "scheduler_delta_dirty_pods": DIRTY_BUCKETS,
    "scheduler_ttb_segment_seconds": TTB_SEGMENT_BUCKETS,
}


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_labels(labels: dict[str, str] | None) -> str:
    """``{a="x",b="y"}`` (sorted, escaped) — "" for no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Histogram:
    """One histogram series: cumulative-at-export bucket counts, sum, count."""

    __slots__ = ("bounds", "counts", "sum")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value

    @property
    def count(self) -> int:
        return sum(self.counts)


@dataclass
class CycleMetrics:
    cycle: int
    backend: str
    pending: int
    bound: int
    unschedulable: int
    rounds: int
    wall_seconds: float
    pack_seconds: float = 0.0
    solve_seconds: float = 0.0
    bind_seconds: float = 0.0
    # Host-side phases that can dominate constrained cycles at scale —
    # surfaced so a slow cycle is attributable from the JSON line alone.
    sync_seconds: float = 0.0
    mopup_seconds: float = 0.0
    # The remaining cycle regions, each its own phase so the attribution
    # coverage gate (1 − other/wall ≥ 0.9, utils/profiler.py) holds on
    # steady-state cycles where loop glue rivals the solve: overlay (ledger
    # prune + shard refresh + deferred flush), noexecute (taint eviction
    # scan), queue (eligibility + snapshot rebuild + gang census),
    # constrained (host sequential fallback), preempt, gang (admission
    # accounting), slo (pending-age tracker).  Every field here except
    # wall/other MUST correspond to a depth-0 span name — cycle_phases()
    # derives the set, observe_cycle and the controller's breakdown both
    # consume it, and tests/test_profiler.py pins the exact match so a new
    # phase cannot silently land in `other`.
    overlay_seconds: float = 0.0
    noexecute_seconds: float = 0.0
    queue_seconds: float = 0.0
    # Incremental engine bookkeeping (tpu_scheduler/delta): watch-delta
    # classification, invalidation closure, residual repack, commit, and the
    # sim-only shadow parity solve.
    delta_seconds: float = 0.0
    constrained_seconds: float = 0.0
    preempt_seconds: float = 0.0
    gang_seconds: float = 0.0
    slo_seconds: float = 0.0
    # Background rebalancer tick (tpu_scheduler/rebalance): reconcile,
    # packing snapshot/solve (inline mode), batch planning, migrations —
    # its own phase so background-tier cost can never hide in `other`.
    rebalance_seconds: float = 0.0
    # Autoscaler tick (tpu_scheduler/autoscale): provider pump, catalog
    # what-if plan, scale-up requests / scale-down drains — its own phase
    # so elastic-capacity cost can never hide in `other`.
    autoscale_seconds: float = 0.0
    other_seconds: float = 0.0  # wall minus every attributed phase
    # -- not phases: none of these ends in ``_seconds`` (cycle_phases) ------
    # They nest inside the phases, or run on another thread, so they never
    # add up with them.  ``spans``: nested span seconds by path (depth 1 and
    # below, each segment at its base name: ``solve/round``), and the cycle's
    # counts beside them: ``delta/early_escalations`` (a full wave decided
    # before the fold), ``overlay/assumed_view_pods`` and
    # ``overlay/assumed_cloned_pods`` (in-flight assumed pods overlaid by
    # the view, and as bound clones), ``solve/cut_off_pods`` and, by cause,
    # ``solve/cut_off_pods/<cause>`` (pods the cycle was cut off from:
    # ``round_cap``, ``stall``, ``mopup_cap``).
    spans: dict = field(default_factory=dict)
    # The widths of kernel #2's bitmap operands as the cycle packed them
    # (L, T, A, A2, Ts: what ops/choose reads off the pod operands), on a
    # cycle that solved with inter-pod constraints; None otherwise.
    constraint_widths: list | None = None
    # Collector pauses inside the cycle, on every thread
    # (utils/profiler.install_gc_clock), and the collections by generation.
    gc_pause_s: float = 0.0
    gc_collections: list = field(default_factory=lambda: [0, 0, 0])
    # The pipelined bind worker's batches that ended during the cycle: its
    # POSTs, their failures, the seconds from first POST to last, and the
    # worker thread's CPU seconds in them (wall − cpu: time it waited).
    bind_posts: int = 0
    bind_failures: int = 0
    bind_wall_s: float = 0.0
    bind_cpu_s: float = 0.0

    @property
    def pods_per_second(self) -> float:
        return self.bound / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def to_json(self) -> str:
        d = self.__dict__.copy()
        d["pods_per_second"] = round(self.pods_per_second, 2)
        return json.dumps(d)


def cycle_phases() -> tuple[str, ...]:
    """The closed cycle-phase set, DERIVED from the CycleMetrics fields
    (every ``*_seconds`` field except ``wall``): the one source the
    ``scheduler_phase_seconds{phase=}`` series, the controller's breakdown
    construction, and the drift test all share — adding a phase field wires
    the metric and the other-subtraction automatically."""
    return tuple(
        f.name[: -len("_seconds")]
        for f in fields(CycleMetrics)
        if f.name.endswith("_seconds") and f.name != "wall_seconds"
    )


@dataclass
class MetricsRegistry:
    """Process counters + histograms (Prometheus-style, in-memory).
    Everything is locked: the routed cycle's pool shards (and backend
    fallbacks inside them) increment from worker threads, and the /metrics
    HTTP server reads concurrently."""

    counters: dict[str, int] = field(default_factory=dict)  # guarded-by: _lock
    cycles: list[CycleMetrics] = field(default_factory=list)  # guarded-by: _lock
    started_at: float = field(default_factory=time.time)
    _histograms: dict[str, dict[str, _Histogram]] = field(default_factory=dict, repr=False)  # guarded-by: _lock
    _gauges: dict[str, float] = field(default_factory=dict, repr=False)  # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    # -- writes (all under _lock) -----------------------------------------

    def _inc(self, name: str, value: int, labels: dict[str, str] | None) -> None:  # holds-lock: _lock
        key = name + format_labels(labels)
        self.counters[key] = self.counters.get(key, 0) + value

    def inc(self, name: str, value: int = 1, labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._inc(name, value, labels)

    def _observe(self, name: str, value: float, labels: dict[str, str] | None) -> None:  # holds-lock: _lock
        per = self._histograms.setdefault(name, {})
        ls = format_labels(labels)
        h = per.get(ls)
        if h is None:
            h = per[ls] = _Histogram(HISTOGRAM_BUCKETS.get(name, LATENCY_BUCKETS))
        h.observe(value)

    def observe(self, name: str, value: float, labels: dict[str, str] | None = None) -> None:
        """Record one histogram observation (bucket bounds come from
        HISTOGRAM_BUCKETS, defaulting to the latency bounds)."""
        with self._lock:
            self._observe(name, value, labels)

    def observe_many(self, name: str, values: list[float], labels: dict[str, str] | None = None) -> None:
        """``observe`` each of ``values`` in turn under one label set, with
        one hold of the lock."""
        with self._lock:
            per = self._histograms.setdefault(name, {})
            ls = format_labels(labels)
            h = per.get(ls)
            if h is None:
                h = per[ls] = _Histogram(HISTOGRAM_BUCKETS.get(name, LATENCY_BUCKETS))
            for value in values:
                h.observe(value)

    def set_gauge(self, name: str, value: float, labels: dict[str, str] | None = None) -> None:
        """Set an explicit gauge (e.g. ``scheduler_circuit_state``, or the
        per-tier ``scheduler_slo_burn_rate{tier=}`` series) —
        last-write-wins, exported beside the derived last-cycle gauges."""
        with self._lock:
            self._gauges[name + format_labels(labels)] = float(value)

    def observe_cycle(self, m: CycleMetrics) -> None:
        with self._lock:
            self.cycles.append(m)
            if len(self.cycles) > 1024:
                del self.cycles[0]  # bounded — a daemon observes unbounded cycles
            self._inc("scheduler_cycles_total", 1, None)
            self._inc("scheduler_pods_bound_total", m.bound, None)
            self._inc("scheduler_pods_unschedulable_total", m.unschedulable, None)
            self._observe("scheduler_cycle_seconds", m.wall_seconds, None)
            self._observe("scheduler_cycle_rounds", float(m.rounds), None)
            # The phase list is DERIVED from the CycleMetrics fields
            # (cycle_phases): a new breakdown field is a new {phase=} series
            # by construction, never a silent addition to `other`.
            for phase in cycle_phases():
                seconds = getattr(m, f"{phase}_seconds")
                if seconds > 0:
                    self._observe("scheduler_phase_seconds", seconds, {"phase": phase})
            if m.bind_seconds > 0:
                self._observe("scheduler_binding_seconds", m.bind_seconds, None)

    # -- reads (one locked snapshot; no iteration over live state) ---------

    def _snapshot_full(self) -> dict:
        """Everything the exposition needs, copied under ONE lock hold."""
        with self._lock:
            counters = dict(self.counters)
            hists = {
                name: {ls: (h.bounds, list(h.counts), h.sum) for ls, h in per.items()}
                for name, per in self._histograms.items()
            }
            last = self.cycles[-1] if self.cycles else None
            gauges: dict[str, float] = dict(self._gauges)
        if last is not None:
            gauges["scheduler_last_cycle_seconds"] = last.wall_seconds
            gauges["scheduler_last_pods_per_second"] = last.pods_per_second
            gauges["scheduler_last_cycle_pending"] = float(last.pending)
            gauges["scheduler_last_cycle_rounds"] = float(last.rounds)
        return {"counters": counters, "histograms": hists, "gauges": gauges}

    def snapshot(self) -> dict:
        """Flat name -> value view (labeled counters under their formatted
        keys) — the CLI summary / checkpoint-delta surface."""
        full = self._snapshot_full()
        out = dict(full["counters"])
        for k in ("scheduler_last_cycle_seconds", "scheduler_last_pods_per_second"):
            if k in full["gauges"]:
                out[k] = full["gauges"][k]
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) — counters (series
        grouped into families, one TYPE line each), histograms with
        cumulative ``_bucket``/``_sum``/``_count``, last-cycle gauges, and
        process uptime.  Derived strictly from one locked
        ``_snapshot_full()`` so a concurrent ``inc`` can never race the
        scrape (SURVEY.md §5: the reference has no metrics endpoint at
        all; this feeds the /metrics route of runtime/http_api.py)."""
        full = self._snapshot_full()
        gauges = dict(full["gauges"])
        gauges["scheduler_uptime_seconds"] = time.time() - self.started_at

        # Group counter series into families: "name{...}" -> family "name".
        families: dict[str, list[tuple[str, int]]] = {}
        for key in sorted(full["counters"]):
            fam = key.split("{", 1)[0]
            families.setdefault(fam, []).append((key, full["counters"][key]))
        lines: list[str] = []
        for fam in sorted(families):
            lines.append(f"# TYPE {fam} counter")
            for key, value in families[fam]:
                lines.append(f"{key} {value}")
        for name in sorted(full["histograms"]):
            lines.append(f"# TYPE {name} histogram")
            for ls in sorted(full["histograms"][name]):
                bounds, counts, total = full["histograms"][name][ls]
                # ls is "" or '{a="b"}'; merge the le label into it.
                base = ls[1:-1] if ls else ""
                cum = 0
                for bound, c in zip(bounds, counts):
                    cum += c
                    merged = ",".join(x for x in (base, f'le="{bound:g}"') if x)
                    lines.append(f"{name}_bucket{{{merged}}} {cum}")
                cum += counts[-1]
                merged = ",".join(x for x in (base, 'le="+Inf"') if x)
                lines.append(f"{name}_bucket{{{merged}}} {cum}")
                lines.append(f"{name}_sum{ls} {total}")
                lines.append(f"{name}_count{ls} {cum}")
        # Gauges group into families exactly like counters — set_gauge keys
        # labeled series as pre-formatted 'name{label="value"}' strings.
        gauge_families: dict[str, list[tuple[str, float]]] = {}
        for key in sorted(gauges):
            gauge_families.setdefault(key.split("{", 1)[0], []).append((key, gauges[key]))
        for fam in sorted(gauge_families):
            lines.append(f"# TYPE {fam} gauge")
            for key, value in gauge_families[fam]:
                lines.append(f"{key} {value}")
        return "\n".join(lines) + "\n"
