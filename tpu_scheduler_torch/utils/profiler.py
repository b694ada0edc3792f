"""Cycle cost-attribution profiler — the instrument behind the two headline
ROADMAP perf items ("profile the cycle" is where both the constrained-scale
and the incremental-cycle work start).

Three pieces:

  • **Attribution trees** — ``build_tree`` folds one cycle's hierarchical
    ``Trace`` (utils/tracing.py path-keyed spans) into a nested node tree
    with per-node total and SELF time (total minus children — the disjoint
    quantity that sums to the attributed wall).  ``coverage`` is
    1 − other/wall: the share of the cycle wall the tree explains.  The
    closed span vocabulary is ``SPAN_CATALOGUE`` (drift-gated against the
    README "Profiling" catalogue by the PROF analyze rule).
  • **Continuous profile ring** (``ProfileRing``) — an always-on, bounded,
    lock-disciplined aggregator: per-path count + total plus a bounded
    sample window for p50/p99, fed one trace per cycle, served at
    ``/debug/profile`` and summarized into ``/debug/shards``.
  • **Build/transfer split** — ``record_kernel_build`` counts the CUDA
    kernel builds (``ops/choose.build_library``, which ``ops/bisect`` also
    builds through) and their seconds, and lands each in the active trace
    as a ``compile`` span; ``record_transfer`` counts host→device bytes at
    the CudaBackend's upload-cache seam (its misses).
  • **Collector clock** — ``install_gc_clock`` hooks ``gc.callbacks`` once
    per process: pause seconds and collections by generation on every
    thread (``gc_totals``), and the interval of each collection of 10 ms or
    more (``gc_long_since``).  The controller folds the change over each
    cycle into ``CycleMetrics`` and the recorder's ``gc`` lane.  Pauses
    are not spans: when a collection fires depends on the heap, and the
    span census must stay a pure function of control flow.

SLO burn: ``tier_of`` maps pod priority to a closed tier set with per-tier
time-to-bind targets (``SLO_TIERS``); the controller's pending-age tracker
feeds ``scheduler_pending_age_seconds{tier=,gang=}`` and the per-tier
burn-rate gauges from it.

Determinism contract (sim): the profiler draws no randomness and influences
no scheduling decision — span *presence and counts* are pure functions of
control flow (bit-identical under record/replay), only durations vary, and
the scorecard ``profile`` block carries exclusively the deterministic parts
(span census + the coverage verdict, which holds with wide margin).

Port: a copy of ``tpu_scheduler/utils/profiler.py``.  The ``jax.monitoring``
compile listener becomes the kernel-build counter (``record_kernel_build``,
``compile_stats``); the ``compile`` span name stays.  The replica registries
serve the HTTP debug routes (``runtime/http_api.py``).
"""

from __future__ import annotations

import gc
import threading
import time

from .tracing import Trace, current_trace

__all__ = [
    "SPAN_CATALOGUE",
    "SLO_TIERS",
    "tier_of",
    "build_tree",
    "coverage",
    "ProfileRing",
    "ReplicaProfileRegistry",
    "ReplicaLatencyRegistry",
    "record_kernel_build",
    "compile_stats",
    "compile_listener_active",
    "span_cost_estimate",
    "record_transfer",
    "transfer_bytes_total",
    "install_gc_clock",
    "gc_totals",
    "gc_long_since",
]

# The closed vocabulary of span base names (indexed spans like ``round[03]``
# catalogue under their base).  Every span the package opens must use a name
# from this tuple — enforced by tests/test_profiler.py against live cycles
# and drift-gated against the README "Profiling" catalogue (PROF rule).
SPAN_CATALOGUE = (
    # cycle phases (depth 0 — the CycleMetrics breakdown fields)
    "sync",        # reflector watch fold -> fresh snapshot
    "overlay",     # ledger prune, shard/lease refresh, deferred flush/overlay, pipeline fold
    "noexecute",   # NoExecute taint eviction scan
    "queue",       # eligibility filter, backoff prune, cycle-snapshot rebuild, gang census
    "pack",        # snapshot -> device tensors (full or incremental)
    "solve",       # backend auction (rounds/epochs nest under it)
    "constrained", # host sequential phase (untensorizable constraint fallback)
    "mopup",       # stall-residue sequential completeness pass
    "bind",        # binding POSTs / deferred-bind bookkeeping
    "preempt",     # preemption pass
    "gang",        # per-gang admission accounting + locality stats
    "slo",         # pending-age tracker + burn-rate gauges
    "delta",       # incremental engine: classification/closure/commit (tpu_scheduler/delta)
    "rebalance",   # background defrag tier: reconcile/solve/plan/migrate (tpu_scheduler/rebalance)
    "autoscale",   # elastic-capacity tier: pump/plan/scale (tpu_scheduler/autoscale)
    # nested cost centers
    "index",       # delta sub-span: watch-event fold into the SolveState
    "close",       # delta sub-span: invalidation closure over standing verdicts
    "repack",      # delta sub-span: carried residual-capacity materialization
    "rebuild",     # delta/commit sub-span: SolveState rebuild after a full wave
    "constraints", # pack sub-span: the inter-pod constraint tensors (ops/constraints.pack_constraints)
    "poll",        # sync sub-span: one watch poll (each reflector, each cycle)
    "fold",        # sync sub-span: watch events into the store and index, and the batch-listener flush
    "shadow",      # delta sub-span: sim-only full-solve parity check
    "round",       # one auction round (native backend round loop)
    "mask",        # per-round constraint/topology mask build
    "score",       # per-round feasibility + scoring sweep
    "choose",      # per-round claim/accept/commit
    "filter",      # choose sub-span: within-round constraint conflict filter
    "aa",          # filter sub-span: fused anti-affinity predecessor check
    "pa",          # filter sub-span: positive-affinity bootstrap min-rank
    "spread",      # filter sub-span: spread rank-prefix admission + cascade
    "commit",      # choose sub-span: domain-state commit of accepted claims
    "snapshot",    # rebalance sub-span: consistent packing-view build / sync sub-span: reflector snapshot build
    "plan",        # rebalance sub-span: batch selection / autoscale sub-span: catalog what-if
    "migrate",     # rebalance sub-span: breaker-gated unbinds + cordons
    "pump",        # autoscale sub-span: provider lifecycle pump (joins, reclaims, kills)
    "scale",       # autoscale sub-span: scale-up requests / scale-down drains
    "epoch",       # one epoch of the host-driven size-shrinking driver
    "dispatch",    # epoch dispatch (async jit call; Python + trace time)
    "host-sync",   # the one per-epoch device fetch (device execute + transfer)
    "compile",     # CUDA kernel build (nvcc) run at a kernel's first launch
)

# Priority tier -> (floor priority, time-to-bind SLO target seconds).  The
# tier of a pod is the first row whose floor its priority reaches; the burn
# rate of a tier is oldest-pending-age / target (>1 = the SLO is burning).
SLO_TIERS = (
    ("critical", 1000, 30.0),
    ("high", 100, 60.0),
    ("default", 0, 300.0),
    ("best-effort", None, 1200.0),  # None floor = everything below "default"
)


def tier_of(priority: int) -> str:
    for name, floor, _target in SLO_TIERS:
        if floor is not None and priority >= floor:
            return name
    return SLO_TIERS[-1][0]


def tier_target(tier: str) -> float:
    for name, _floor, target in SLO_TIERS:
        if name == tier:
            return target
    return SLO_TIERS[-1][2]


# -- attribution trees --------------------------------------------------------


def build_tree(trace: Trace, wall: float) -> dict:
    """Fold a path-keyed trace into a nested attribution tree.

    Returns ``{"wall_s", "attributed_s", "other_s", "coverage", "children"}``
    where children maps span name -> ``{"count", "total_s", "self_s",
    "children"}``.  ``self_s`` (total minus direct children) is disjoint by
    construction: summed over the whole tree it equals the attributed wall.
    """
    root: dict = {"children": {}}
    for path, seconds in trace.durations.items():
        node = root
        for seg in path.split("/"):
            node = node["children"].setdefault(seg, {"count": 0, "total_s": 0.0, "self_s": 0.0, "children": {}})
        node["count"] = trace.counts.get(path, 0)
        node["total_s"] += seconds

    def finish(node: dict) -> None:
        kids = sum(c["total_s"] for c in node["children"].values())
        node["self_s"] = max(0.0, node["total_s"] - kids)
        for c in node["children"].values():
            finish(c)

    for c in root["children"].values():
        finish(c)
    attributed = sum(c["total_s"] for c in root["children"].values())
    other = max(0.0, wall - attributed)
    return {
        "wall_s": wall,
        "attributed_s": attributed,
        "other_s": other,
        "coverage": (attributed / wall) if wall > 0 else 1.0,
        "children": root["children"],
    }


def coverage(trace: Trace, wall: float) -> float:
    """1 − other/wall for one cycle (attributed = depth-0 span total)."""
    if wall <= 0:
        return 1.0
    return min(1.0, sum(trace.top_level().values()) / wall)


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ProfileRing:
    """Always-on bounded aggregator of per-cycle attribution trees.

    Per path: lifetime count/total plus a bounded window of recent per-cycle
    totals for p50/p99.  Ingest is one lock hold per cycle; snapshots are
    derived from one locked copy (the metrics-registry stance) because the
    HTTP debug thread reads while the cycle loop writes."""

    def __init__(self, window: int = 512):
        self.window = max(16, int(window))
        self._lock = threading.Lock()
        self._paths: dict[str, dict] = {}  # guarded-by: _lock — path -> {count,total_s,recent:[...]}
        self._cycles = 0  # guarded-by: _lock
        self._wall_total = 0.0  # guarded-by: _lock
        self._other_total = 0.0  # guarded-by: _lock
        self._recent_wall: list[float] = []  # guarded-by: _lock
        self._recent_spans: list[int] = []  # guarded-by: _lock — span events per cycle
        self._span_events_total = 0  # guarded-by: _lock

    def ingest(self, trace: Trace, wall: float) -> None:
        """Fold one cycle's trace.  Bounded: per-path windows and the
        cycle-level windows each trim to ``window`` entries."""
        other = max(0.0, wall - sum(trace.top_level().values()))
        with self._lock:
            self._cycles += 1
            self._wall_total += wall
            self._other_total += other
            self._recent_wall.append(wall)
            if len(self._recent_wall) > self.window:
                del self._recent_wall[0]
            self._recent_spans.append(len(trace.events))
            self._span_events_total += len(trace.events)
            if len(self._recent_spans) > self.window:
                del self._recent_spans[0]
            for path, seconds in trace.durations.items():
                ent = self._paths.get(path)
                if ent is None:
                    ent = self._paths[path] = {"count": 0, "total_s": 0.0, "recent": []}
                ent["count"] += trace.counts.get(path, 0)
                ent["total_s"] += seconds
                ent["recent"].append(seconds)
                if len(ent["recent"]) > self.window:
                    del ent["recent"][0]

    def _copy(self) -> tuple[dict, int, float, float, list[float], list[int]]:  # holds-lock: _lock
        paths = {
            p: {"count": e["count"], "total_s": e["total_s"], "recent": list(e["recent"])}
            for p, e in self._paths.items()
        }
        return paths, self._cycles, self._wall_total, self._other_total, list(self._recent_wall), list(self._recent_spans)

    def snapshot(self) -> dict:
        """The /debug/profile payload: aggregate coverage + a nested tree
        with per-node count, total, p50/p99 of per-cycle totals."""
        with self._lock:
            paths, cycles, wall_total, other_total, recent_wall, recent_spans = self._copy()
        tree: dict = {}
        for path in sorted(paths):
            ent = paths[path]
            node_children = tree
            segs = path.split("/")
            for seg in segs[:-1]:
                node_children = node_children.setdefault(seg, {"children": {}})["children"]
            rec = sorted(ent["recent"])
            node = node_children.setdefault(segs[-1], {"children": {}})
            node.update(
                count=ent["count"],
                total_s=round(ent["total_s"], 6),
                p50_s=round(_quantile(rec, 0.50), 6),
                p99_s=round(_quantile(rec, 0.99), 6),
            )
        rw = sorted(recent_wall)
        return {
            "cycles": cycles,
            "wall_total_s": round(wall_total, 6),
            "attributed_total_s": round(wall_total - other_total, 6),
            "other_total_s": round(other_total, 6),
            "coverage": round(1.0 - other_total / wall_total, 6) if wall_total > 0 else 1.0,
            "cycle_p50_s": round(_quantile(rw, 0.50), 6),
            "cycle_p99_s": round(_quantile(rw, 0.99), 6),
            "spans_per_cycle": round(sum(recent_spans) / len(recent_spans), 1) if recent_spans else 0.0,
            "tree": tree,
        }

    def brief(self) -> dict:
        """The /debug/shards perf block: cycle quantiles + coverage + the
        costliest top-level phases by lifetime total."""
        with self._lock:
            paths, cycles, wall_total, other_total, recent_wall, _ = self._copy()
        top = sorted(
            ((p, e["total_s"]) for p, e in paths.items() if "/" not in p),
            key=lambda kv: -kv[1],
        )[:5]
        rw = sorted(recent_wall)
        return {
            "cycles": cycles,
            "coverage": round(1.0 - other_total / wall_total, 6) if wall_total > 0 else 1.0,
            "cycle_p50_s": round(_quantile(rw, 0.50), 6),
            "cycle_p99_s": round(_quantile(rw, 0.99), 6),
            "top_phases": [{"phase": p, "total_s": round(s, 6)} for p, s in top],
        }

    def span_census(self) -> dict[str, int]:
        """Path -> lifetime count.  Counts are pure control-flow facts (no
        wall clock), so this is the deterministic face of the ring — the
        part the sim scorecard may carry."""
        with self._lock:
            return {p: e["count"] for p, e in sorted(self._paths.items())}

    def aggregate_coverage(self) -> float:
        with self._lock:
            if self._wall_total <= 0:
                return 1.0
            return 1.0 - self._other_total / self._wall_total

    def overhead_estimate(self) -> dict:
        """Measured profiler overhead over the run: (lifetime span events ×
        a freshly microbenched per-span cost + one ring-ingest pass per
        cycle, costed as ~one span per event) over the lifetime cycle wall.
        A model, not a subtraction of two noisy walls — the quantity the
        <2 % gate holds.  Aggregate on purpose: an idle no-op cycle costs a
        handful of spans against microseconds of wall, and judging overhead
        against idle cycles would indict the instrument for the workload's
        silence."""
        with self._lock:
            spans_total = self._span_events_total
            cycles = self._cycles
            wall_total = self._wall_total
            recent_spans = list(self._recent_spans)
        per_span = span_cost_estimate()
        spans_per_cycle = (sum(recent_spans) / len(recent_spans)) if recent_spans else 0.0
        overhead_total = spans_total * 2.0 * per_span  # span itself + its ingest pass
        return {
            "per_span_s": per_span,
            "spans_per_cycle": spans_per_cycle,
            "span_events_total": spans_total,
            "cycles": cycles,
            "overhead_total_s": overhead_total,
            "wall_total_s": wall_total,
            "overhead_frac": (overhead_total / wall_total) if wall_total > 0 else 0.0,
        }


def span_cost_estimate(n: int = 4000) -> float:
    """Median-of-3 microbench of one span enter/exit against a live Trace —
    the calibration input of the overhead gate."""
    from .tracing import span as _span

    best = []
    for _ in range(3):
        tr = Trace()
        with tr:
            t0 = time.perf_counter()
            for _i in range(n):
                with _span("probe"):
                    pass
            best.append((time.perf_counter() - t0) / n)
    best.sort()
    return best[1]


# -- multi-replica aggregation ------------------------------------------------


class ReplicaProfileRegistry:
    """Replica id -> snapshot callable; the /debug/profile route's source in
    multi-replica deployments (and the single-replica CLI registers its one
    scheduler).  ``snapshot(replica=...)`` selects one replica; without it,
    per-replica blocks plus a merged per-path sum."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas: dict[str, object] = {}  # guarded-by: _lock — id -> () -> dict

    def register(self, replica_id: str, snapshot_fn) -> None:
        with self._lock:
            self._replicas[replica_id] = snapshot_fn

    def replica_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._replicas)

    def snapshot(self, replica: str | None = None) -> dict:
        with self._lock:
            fns = dict(self._replicas)
        if replica is not None:
            fn = fns.get(replica)
            if fn is None:
                return {"error": f"unknown replica {replica!r}", "replicas": sorted(fns)}
            return {"replica": replica, **fn()}
        per = {rid: fn() for rid, fn in sorted(fns.items())}
        merged: dict = {"cycles": 0, "wall_total_s": 0.0, "other_total_s": 0.0}
        for snap in per.values():
            prof = snap.get("profile", snap)
            merged["cycles"] += prof.get("cycles", 0)
            merged["wall_total_s"] += prof.get("wall_total_s", 0.0)
            merged["other_total_s"] += prof.get("other_total_s", 0.0)
        wt = merged["wall_total_s"]
        merged["coverage"] = round(1.0 - merged["other_total_s"] / wt, 6) if wt > 0 else 1.0
        merged["wall_total_s"] = round(merged["wall_total_s"], 6)
        merged["other_total_s"] = round(merged["other_total_s"], 6)
        return {"replicas": per, "merged": merged}


class ReplicaLatencyRegistry:
    """Replica id -> latency_snapshot callable; the /debug/latency route's
    source in multi-replica deployments (same registration pattern as
    ReplicaProfileRegistry).  ``snapshot(replica=...)`` selects one replica;
    without it, per-replica blocks plus a fleet-merged per-tier sum of the
    time-to-bind decomposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas: dict[str, object] = {}  # guarded-by: _lock — id -> () -> dict

    def register(self, replica_id: str, snapshot_fn) -> None:
        with self._lock:
            self._replicas[replica_id] = snapshot_fn

    def replica_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._replicas)

    def snapshot(self, replica: str | None = None) -> dict:
        with self._lock:
            fns = dict(self._replicas)
        if replica is not None:
            fn = fns.get(replica)
            if fn is None:
                return {"error": f"unknown replica {replica!r}", "replicas": sorted(fns)}
            return {"replica": replica, **fn()}
        per = {rid: fn() for rid, fn in sorted(fns.items())}
        merged_tiers: dict[str, dict] = {}
        confirmed = 0
        awaiting = 0
        for snap in per.values():
            confirmed += snap.get("confirmed", 0)
            awaiting += snap.get("awaiting_confirm", 0)
            for tier, blk in snap.get("tiers", {}).items():
                acc = merged_tiers.setdefault(
                    tier, {"count": 0, "ttb_sum_s": 0.0, "unattributed_sum_s": 0.0, "segments_sum_s": {}}
                )
                acc["count"] += blk.get("count", 0)
                acc["ttb_sum_s"] += blk.get("ttb_sum_s", 0.0)
                acc["unattributed_sum_s"] += blk.get("unattributed_sum_s", 0.0)
                for seg, v in blk.get("segments_sum_s", {}).items():
                    acc["segments_sum_s"][seg] = acc["segments_sum_s"].get(seg, 0.0) + v
        for acc in merged_tiers.values():
            acc["mean_ttb_s"] = round(acc["ttb_sum_s"] / acc["count"], 9) if acc["count"] else 0.0
            acc["ttb_sum_s"] = round(acc["ttb_sum_s"], 9)
            acc["unattributed_sum_s"] = round(acc["unattributed_sum_s"], 9)
            acc["segments_sum_s"] = {seg: round(v, 9) for seg, v in acc["segments_sum_s"].items()}
        merged = {"confirmed": confirmed, "awaiting_confirm": awaiting, "tiers": merged_tiers}
        return {"replicas": per, "merged": merged}


# -- kernel-build/transfer accounting -----------------------------------------

_xfer_lock = threading.Lock()
_xfer_bytes = [0]  # guarded-by: _xfer_lock — lifetime host->device bytes
_build_lock = threading.Lock()
_build_stats = {"builds": 0, "build_s": 0.0}  # guarded-by: _build_lock


def record_transfer(nbytes: int) -> None:
    """Count host→device bytes (the CudaBackend upload-cache misses)."""
    with _xfer_lock:
        _xfer_bytes[0] += int(nbytes)


def transfer_bytes_total() -> int:
    with _xfer_lock:
        return _xfer_bytes[0]


def record_kernel_build(seconds: float) -> None:
    """Count one kernel build (an nvcc run) and its seconds; the build
    lands in the active trace as a ``compile`` span (inside ``solve`` for
    a cycle's first launch)."""
    with _build_lock:
        _build_stats["builds"] += 1
        _build_stats["build_s"] += float(seconds)
    tr = current_trace()
    if tr is not None:
        tr.record("compile", float(seconds))


def compile_stats() -> dict:
    """Lifetime kernel builds and their seconds (``builds``, ``build_s``)."""
    with _build_lock:
        return dict(_build_stats)


def compile_listener_active(backend=None) -> bool:
    """Whether the kernel-build counter (``record_kernel_build``, read as
    ``compile_stats()["builds"]``) counts the builds of a run over
    ``backend`` — the sim scorecard ``compile`` block's ``enabled`` bit.
    True when the backend runs on the card, whose first launches build the
    kernels with nvcc; False on the CPU, where the plain versions run and
    nothing is built, so the count is vacuously zero (as under the JAX
    package's NativeBackend)."""
    return getattr(getattr(backend, "device", None), "type", None) == "cuda"


# -- collector clock -----------------------------------------------------------

# Collections of at least this many seconds keep their interval (the
# recorder's ``gc`` lane); shorter ones are only counted.
GC_LONG_S = 0.010

# The hook's state, each a single cell replaced whole (never mutated in
# place): a reader on another thread takes one consistent value without a
# lock, and the callback takes no lock a collecting thread could hold.
_gc_start = [0.0]  # perf_counter stamp of the running collection's start
_gc_total: list = [(0.0, (0, 0, 0))]  # (pause seconds, collections by generation)
_gc_long: list = [()]  # ((generation, wall start, wall end), ...), the newest 64


def _gc_callback(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_start[0] = time.perf_counter()
        return
    dt = time.perf_counter() - _gc_start[0]
    g = info["generation"]
    pause, counts = _gc_total[0]
    _gc_total[0] = (pause + dt, tuple(c + (i == g) for i, c in enumerate(counts)))
    if dt >= GC_LONG_S:
        end = time.time()
        _gc_long[0] = (_gc_long[0] + ((g, end - dt, end),))[-64:]


def install_gc_clock() -> None:
    """Hook the collector clock into ``gc.callbacks``; a second install is a
    no-op (every scheduler of a process installs it)."""
    if _gc_callback not in gc.callbacks:
        gc.callbacks.append(_gc_callback)


def gc_totals() -> tuple[float, tuple[int, int, int]]:
    """(pause seconds, collections by generation) since the hook went in,
    over every thread of the process."""
    return _gc_total[0]


def gc_long_since(wall: float) -> list[tuple[int, float, float]]:
    """(generation, wall start, wall end) of each collection of at least
    ``GC_LONG_S`` that ended at or after ``wall``."""
    return [c for c in _gc_long[0] if c[2] >= wall]
