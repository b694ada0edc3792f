"""Scheduling flight recorder — bounded per-pod decision timelines plus a
ring buffer of recent cycles, the in-process answer to "why is this pod
Pending?" and "what did cycle N spend its time on?" without re-running
bench.py (VERDICT round 5: classify and surface unschedulable pods as a
product feature, not a bench field).

Every verdict the controller reaches about a pod — seen-pending, packed,
gang-admitted/refused, bound, requeued, unschedulable (with its typed
``InvalidNodeReason`` and per-reason candidate-node counts) — lands here as
one timeline entry.  The recorder is strictly bounded in three dimensions
(tracked pods, events per pod, retained cycles) so a daemon observing
unbounded churn holds constant memory; overflow evicts the least-recently
updated timeline (the pods an operator debugs are the ones still acting)
and is counted, never silent.

``chrome_trace`` renders the recorded per-cycle span intervals as Chrome
trace-event JSON (the ``{"traceEvents": [...]}`` object form) loadable in
Perfetto / chrome://tracing, with the device-trace directory linked when
``--profile-dir`` is set — plus one track per tracked pod (pid 2) showing
its admission waterfall as segment slices.  A cycle record's ``lanes``
hold work that is not a span of the cycle's thread: the bind worker's
batches and the collector's long pauses, each lane on a track
(``LANE_TIDS``) beside the cycle's spans.  Served by
``runtime/http_api.py`` under ``/debug/pods/<ns>/<name>``, ``/debug/cycles``
and ``/debug/trace``.

``waterfall`` is the latency reducer on top of the timelines: it attributes
one bound pod's time-to-bind to the closed ``SEGMENTS`` taxonomy (each
inter-event interval belongs to the segment named by the EARLIER event's
kind via ``SEGMENT_OF_KIND``), with anything unmapped surfaced as
``unattributed`` — the attribution leak the scorecard's sum-to-TTB audit
catches.  Latency math reads the ``t`` stamp (the injected scheduler clock:
virtual seconds in the sim, monotonic in the daemon), never wall ``ts``.

Port: a copy of ``tpu_scheduler/utils/events.py`` (pure host code), with
the cycle records' ``lanes``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

__all__ = ["FlightRecorder", "EVENT_KINDS", "SEGMENTS", "SEGMENT_OF_KIND", "LANE_TIDS", "waterfall"]

# The closed set of cycle-record lanes, each drawn on its own track (pid 1,
# beside the cycle spans on tid 1): ``bind`` the bind worker's batches
# (first POST to last), ``gc`` the collector's pauses of 10 ms or more.
LANE_TIDS = {"bind": 2, "gc": 3}

# The closed vocabulary of per-pod verdicts (one place, so the debug API and
# tests can validate timelines against it).
EVENT_KINDS = (
    "seen-pending",
    "packed",
    "gang-admitted",
    "gang-refused",
    "backend-fallback",
    "bound",
    "requeued",
    "unschedulable",
    "preempted",
    "evicted",
    # degraded-mode verdicts (runtime/resilience.py): the bind was computed
    # but POSTing waited out an open circuit breaker / flushed on recovery.
    "bind-deferred",
    "bind-flushed",
    # admission-latency waterfall: the cross-shard two-phase gang hold
    # opened (tpu_scheduler/fleet) and the binding POST confirmed by the
    # watch stream — the ``reservation-wait`` and ``confirm`` segment edges.
    "reservation-opened",
    "bind-confirmed",
)

# The closed admission-latency segment taxonomy (drift-gated against the
# README "Latency & time-to-bind" catalogue by the LATN analyze rule):
# every bound pod's time-to-bind decomposes into exactly these segments.
SEGMENTS = (
    "cadence-wait",  # arrival -> the first cycle that saw the pod
    "solve",  # cycle entry -> placement chosen
    "gang-wait",  # placed-but-gang-incomplete residency
    "reservation-wait",  # cross-shard gang two-phase hold
    "backoff",  # requeue intervals, by failure class
    "breaker-deferred",  # open-circuit flush-buffer residency
    "bind-post",  # placement committed -> binding POSTed
    "confirm",  # POST accepted -> watch-confirmed bound
)

# Interval attribution: the span between two consecutive timeline events
# belongs to the segment named by the EARLIER event's kind (what the pod
# was waiting on when that interval started).  Kinds absent here (preempted,
# evicted, migration churn) make the interval ``unattributed`` — a leak the
# scorecard's sum-to-TTB audit fails loudly instead of absorbing.
SEGMENT_OF_KIND = {
    "seen-pending": "solve",
    "packed": "solve",
    "backend-fallback": "solve",
    "gang-admitted": "bind-post",
    "gang-refused": "gang-wait",
    "reservation-opened": "reservation-wait",
    "requeued": "backoff",
    "unschedulable": "backoff",
    "bind-deferred": "breaker-deferred",
    "bind-flushed": "bind-post",
    "bound": "confirm",
}


# shape: (timeline: obj, arrival_t: obj) -> obj
def waterfall(timeline: list[dict], arrival_t: float | None = None) -> dict | None:
    """Decompose one pod's timeline into its admission-latency waterfall.

    The terminal event is the last ``bind-confirmed`` (falling back to the
    last ``bound`` when the watch-confirm was never recorded); a pod that
    never bound has no waterfall (returns None).  ``cadence-wait`` is the
    gap from ``arrival_t`` (defaulting to the first event's stamp — zero
    cadence wait) to the first event; every later inter-event interval is
    attributed via ``SEGMENT_OF_KIND``.  Segments + ``unattributed`` sum to
    ``ttb`` exactly by construction (to the 9-decimal rounding), so a
    nonzero ``unattributed`` IS the attribution leak the scorecard audit
    gates on.  Pure function of the ``t`` stamps — deterministic under the
    sim's virtual clock."""
    if not timeline:
        return None
    term = None
    for i in range(len(timeline) - 1, -1, -1):
        if timeline[i].get("kind") == "bind-confirmed":
            term = i
            break
    if term is None:
        for i in range(len(timeline) - 1, -1, -1):
            if timeline[i].get("kind") == "bound":
                term = i
                break
    if term is None:
        return None

    def t_of(ev: dict) -> float:
        return float(ev.get("t", ev.get("ts", 0.0)))

    t_first = t_of(timeline[0])
    t0 = t_first if arrival_t is None else float(arrival_t)
    segments = {seg: 0.0 for seg in SEGMENTS}
    segments["cadence-wait"] = max(0.0, t_first - t0)
    unattributed = 0.0
    for i in range(term):
        dt = max(0.0, t_of(timeline[i + 1]) - t_of(timeline[i]))
        seg = SEGMENT_OF_KIND.get(timeline[i].get("kind"))
        if seg is None:
            unattributed += dt
        else:
            segments[seg] += dt
    return {
        "ttb": round(max(0.0, t_of(timeline[term]) - t0), 9),
        "segments": {seg: round(v, 9) for seg, v in segments.items()},
        "unattributed": round(unattributed, 9),
    }


class FlightRecorder:
    """Bounded in-memory recorder of scheduling decisions.

    ``max_pods`` timelines of at most ``per_pod`` events each, plus
    ``max_cycles`` cycle records (CycleMetrics + span intervals).  All
    methods are thread-safe: the pipelined bind worker records bound/requeue
    outcomes while the HTTP debug routes read concurrently.  ``max_pods=0``
    disables recording entirely (every call is a cheap no-op) — the
    ``--events-buffer 0`` escape hatch for benchmark runs.

    ``clock`` (the scheduler's own clock callable) adds a second stamp ``t``
    to every event beside wall ``ts``: the latency-math time base —
    VIRTUAL seconds in the sim (so ``waterfall`` is deterministic under
    record/replay), monotonic in the daemon.  Without it ``t`` equals
    ``ts``."""

    def __init__(self, max_pods: int = 4096, per_pod: int = 64, max_cycles: int = 256, clock=None):
        self.max_pods = max_pods
        self.per_pod = per_pod
        self.max_cycles = max_cycles
        self.clock = clock
        self._lock = threading.Lock()
        self._timelines: OrderedDict[str, deque] = OrderedDict()  # guarded-by: _lock
        self._cycles: deque = deque(maxlen=max(1, max_cycles))  # guarded-by: _lock
        self.evicted_timelines = 0  # guarded-by: _lock — LRU overflow count; visible, never silent
        # Set by the CLI when --profile-dir is active so chrome_trace can
        # link the device trace next to the host spans.
        self.device_trace_dir: str | None = None

    @property
    def enabled(self) -> bool:
        return self.max_pods > 0

    def _now(self) -> tuple[float, float]:
        """(wall ``ts``, scheduler-clock ``t``) for one event stamp."""
        ts = time.time()
        return ts, (float(self.clock()) if self.clock is not None else ts)

    # -- per-pod timelines --------------------------------------------------

    def record(
        self,
        pod_full: str,
        kind: str,
        cycle: int,
        *,
        node: str | None = None,
        reason: str | None = None,
        counts: dict[str, int] | None = None,
        detail: str | None = None,
    ) -> None:
        """Append one verdict to a pod's timeline (creating it if needed,
        evicting the least-recently-updated timeline at capacity)."""
        if not self.enabled:
            return
        ts, t = self._now()
        ev: dict = {"ts": ts, "t": t, "cycle": cycle, "kind": kind}
        if node is not None:
            ev["node"] = node
        if reason is not None:
            ev["reason"] = reason
        if counts:
            ev["candidate_counts"] = dict(counts)
        if detail is not None:
            ev["detail"] = detail
        with self._lock:
            tl = self._timelines.get(pod_full)
            if tl is None:
                while len(self._timelines) >= self.max_pods:
                    self._timelines.popitem(last=False)
                    self.evicted_timelines += 1
                tl = self._timelines[pod_full] = deque(maxlen=self.per_pod)
            else:
                self._timelines.move_to_end(pod_full)
            tl.append(ev)

    def seen(self, pod_full: str, cycle: int) -> None:
        """Record ``seen-pending`` once — only for pods with no timeline yet
        (O(1) dict probe; called for every pending pod every cycle).

        One lock hold for probe AND append: the old probe-unlock-record
        shape was a TOCTOU — two threads racing the same new pod could both
        miss the probe and double-record ``seen-pending`` (surfaced by the
        THRD lock-discipline review; regression-pinned in test_analyze)."""
        if not self.enabled:
            return
        with self._lock:
            if pod_full in self._timelines:
                return
            while len(self._timelines) >= self.max_pods:
                self._timelines.popitem(last=False)
                self.evicted_timelines += 1
            tl = self._timelines[pod_full] = deque(maxlen=self.per_pod)
            ts, t = self._now()
            tl.append({"ts": ts, "t": t, "cycle": cycle, "kind": "seen-pending"})

    def seen_many(self, pod_fulls, cycle: int) -> None:
        """Batch ``seen``: ONE lock hold for a whole cycle's pending set —
        the controller calls this with up to 100k names per cycle, and a
        per-name lock acquisition would tax the hot loop measurably."""
        if not self.enabled:
            return
        ts, t = self._now()
        with self._lock:
            for pf in pod_fulls:
                if pf in self._timelines:
                    continue
                while len(self._timelines) >= self.max_pods:
                    self._timelines.popitem(last=False)
                    self.evicted_timelines += 1
                tl = self._timelines[pf] = deque(maxlen=self.per_pod)
                tl.append({"ts": ts, "t": t, "cycle": cycle, "kind": "seen-pending"})

    def record_packed(self, pod_fulls, cycle: int, backend: str) -> None:
        """Record ``packed`` for ALREADY-TRACKED pods only — the batch path
        packs 100k pods per cycle, and growing timelines here would churn
        the LRU; a pod enters via ``seen`` and keeps its batch membership
        from then on."""
        if not self.enabled:
            return
        ts, t = self._now()
        ev_base = {"ts": ts, "t": t, "cycle": cycle, "kind": "packed", "detail": backend}
        with self._lock:
            for pf in pod_fulls:
                tl = self._timelines.get(pf)
                if tl is not None:
                    tl.append(dict(ev_base))

    def timeline(self, pod_full: str) -> list[dict]:
        with self._lock:
            tl = self._timelines.get(pod_full)
            return [dict(ev) for ev in tl] if tl is not None else []

    def tracked_pods(self) -> list[str]:
        with self._lock:
            return list(self._timelines)

    # -- per-cycle records ---------------------------------------------------

    def record_cycle(
        self,
        metrics: dict,
        spans: list[tuple[str, float, float]],
        notes: list[str] | None = None,
        lanes: list[dict] | None = None,
    ) -> None:
        """Retain one cycle: its CycleMetrics dict, its span INTERVALS
        (name, wall_start, wall_end — the chrome_trace source), any
        cycle-level annotations (backend-fallback etc.), and its ``lanes``:
        intervals off the cycle's thread (``{"lane", "name", "start",
        "end", ...}``, the lane one of ``LANE_TIDS``), kept apart from
        ``spans``, whose slash-free entries are the cycle's phases."""
        if not self.enabled:
            return
        rec = {
            "wall_end": time.time(),
            "metrics": dict(metrics),
            "spans": [(name, t0, t1) for name, t0, t1 in spans],
        }
        if notes:
            rec["notes"] = list(notes)
        if lanes:
            rec["lanes"] = [dict(x) for x in lanes]
        with self._lock:
            self._cycles.append(rec)

    def cycles(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._cycles)
        if n is not None:
            out = out[-n:]
        return [
            {
                **rec,
                "spans": [{"name": s[0], "start": s[1], "end": s[2]} for s in rec["spans"]],
                **({"lanes": [dict(x) for x in rec["lanes"]]} if "lanes" in rec else {}),
            }
            for rec in out
        ]

    # -- Chrome trace-event export ------------------------------------------

    def chrome_trace(self, n_cycles: int | None = None) -> dict:
        """The recorded cycles as a Chrome trace-event JSON object
        (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
        — ``ph: "X"`` complete events in microseconds, one per recorded span,
        loadable in Perfetto or chrome://tracing.  When a device trace was
        captured (``--profile-dir``), its directory is linked in
        ``otherData`` so the host and device timelines can be opened side by
        side.  Tracked pods get their own process (pid 2, one thread per
        pod — the most recently updated 64): each timeline renders as its
        admission-waterfall segments, so a pod's journey reads as a lane of
        named slices under the cycle spans.  Lane intervals (the bind
        worker's batches, long collector pauses) draw on their own tids of
        pid 1 (``LANE_TIDS``), named by ``thread_name`` metadata."""
        with self._lock:
            recs = list(self._cycles)
            pod_tls = [(pf, list(tl)) for pf, tl in list(self._timelines.items())[-64:]]
        if n_cycles is not None:
            recs = recs[-n_cycles:]
        events: list[dict] = []
        lanes_seen: set[str] = set()
        for rec in recs:
            cycle = rec["metrics"].get("cycle")
            for lane in rec.get("lanes", ()):
                lanes_seen.add(lane["lane"])
                t0, t1 = lane["start"], lane["end"]
                events.append(
                    {
                        "name": lane["name"],
                        "cat": "scheduler",
                        "ph": "X",
                        "ts": round(t0 * 1e6, 3),
                        "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                        "pid": 1,
                        "tid": LANE_TIDS[lane["lane"]],
                        "args": {k: v for k, v in lane.items() if k not in ("lane", "name", "start", "end")},
                    }
                )
            for name, t0, t1 in rec["spans"]:
                # Span names are hierarchical PATHS (utils/tracing.py:
                # ``solve/round[03]/score``); Perfetto nests ``X`` slices on
                # one tid by time containment, so the slice carries the leaf
                # name and the full path rides in args.  Endpoint rounding
                # is monotone, so child slices never overhang their parent.
                ev = {
                    "name": name.rsplit("/", 1)[-1],
                    "cat": "scheduler",
                    "ph": "X",
                    "ts": round(t0 * 1e6, 3),
                    "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                    "pid": 1,
                    "tid": 1,
                    "args": {"cycle": cycle},
                }
                if "/" in name:
                    ev["args"]["path"] = name
                events.append(ev)
            # One instant event marking the cycle boundary keeps cycles
            # countable even when a cycle recorded no spans (idle standby).
            events.append(
                {
                    "name": f"cycle {cycle}",
                    "cat": "scheduler",
                    "ph": "i",
                    "ts": round(rec.get("wall_end", 0.0) * 1e6, 3),
                    "pid": 1,
                    "tid": 1,
                    "s": "g",
                }
            )
        for lane in sorted(lanes_seen, key=LANE_TIDS.get):
            events.append(
                {"name": "thread_name", "ph": "M", "pid": 1, "tid": LANE_TIDS[lane], "args": {"name": f"{lane} lane"}}
            )
        # Per-pod waterfall tracks (pid 2): each inter-event interval that
        # maps to a segment becomes one X slice on the pod's own tid.  Wall
        # ``ts`` keeps the pod lanes aligned with the cycle spans above;
        # unmapped intervals (eviction churn) are simply not drawn.
        if pod_tls:
            events.append({"name": "process_name", "ph": "M", "pid": 2, "args": {"name": "pod admission waterfall"}})
            for tid, (pf, tl) in enumerate(pod_tls, start=1):
                events.append({"name": "thread_name", "ph": "M", "pid": 2, "tid": tid, "args": {"name": pf}})
                for i in range(len(tl) - 1):
                    seg = SEGMENT_OF_KIND.get(tl[i].get("kind"))
                    if seg is None:
                        continue
                    t0 = tl[i].get("ts", 0.0)
                    events.append(
                        {
                            "name": seg,
                            "cat": "pod",
                            "ph": "X",
                            "ts": round(t0 * 1e6, 3),
                            "dur": round(max(0.0, tl[i + 1].get("ts", 0.0) - t0) * 1e6, 3),
                            "pid": 2,
                            "tid": tid,
                            "args": {"pod": pf, "kind": tl[i].get("kind")},
                        }
                    )
        trace = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"recorded_cycles": len(recs)},
        }
        if self.device_trace_dir:
            trace["otherData"]["device_trace_dir"] = self.device_trace_dir
        return trace
