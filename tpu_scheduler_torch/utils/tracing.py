"""Structured tracing — the build-side answer to the reference's flat
``tracing_subscriber::fmt()`` INFO logging (``src/main.rs:129``; SURVEY.md §5
calls for per-cycle spans + optional device profiler traces).

``span("name")`` times a block and records it into the active ``Trace`` (if
any) as a node of a HIERARCHICAL attribution tree: spans nest, and every
recorded duration is keyed by its full ``parent/child`` path (e.g.
``solve/round[03]/score``), so a cycle decomposes into a tree whose leaves
are the real cost centers (utils/profiler.py aggregates the trees; the
flight recorder's Chrome trace renders them as nested slices).  Depth-0
paths are the cycle PHASES the ``CycleMetrics`` breakdown is built from —
anything the phases don't cover is exactly ``other_seconds``.

The active-trace stack is THREAD-LOCAL: a worker thread (routed per-pool
solves, the pipelined bind worker) sees no active trace and its spans
degrade to two clock reads — never a concurrent mutation of the main
thread's tree (the THRD stance: no shared mutable state, no lock needed).

``device_profile(dir)`` wraps ``torch.profiler``: a Chrome trace of the
host and (when CUDA is up) the card, written into ``dir``; inert when
``dir`` is None, and it raises when a trace was asked for but cannot start.
While any ``torch.profiler`` records, each depth-0 span (a cycle phase)
also opens a profiler range of its own name (``profiler_range``), so the
profiler's trace holds the phases on its own clock beside the kernels;
the recorder's intervals stay on the wall clock.  ``configure_logging`` grows a
``--log-format json`` path: one JSON object per line (ts, level, logger,
msg, cycle) so the daemon's logs are machine-parseable; ``set_log_cycle``
tags every line emitted during a cycle with its number.

Port: a copy of ``tpu_scheduler/utils/tracing.py``; ``device_profile`` wraps
``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time

logger = logging.getLogger("tpu_scheduler_torch")

__all__ = [
    "span",
    "Trace",
    "current_trace",
    "base_name",
    "device_profile",
    "profiler_range",
    "configure_logging",
    "JsonLogFormatter",
    "set_log_cycle",
]

# Per-THREAD active-trace stack.  Only the thread that entered a Trace sees
# it; spans on other threads no-op (two perf_counter reads) instead of racing
# the owner's tree.
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def base_name(segment: str) -> str:
    """A path segment's catalogue name: indexed spans (``round[03]``,
    ``epoch[1]``) aggregate under their base (``round``, ``epoch``)."""
    i = segment.find("[")
    return segment if i < 0 else segment[:i]


# The cycle number logs emitted "now" belong to — set by the controller at
# the top of each cycle so the JSON formatter can stamp every line without
# threading `extra=` through every logging call site.  A plain mutable cell:
# one scheduler loop per process owns the write side.
_log_cycle: list[int | None] = [None]


def set_log_cycle(cycle: int | None) -> None:
    _log_cycle[0] = cycle


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: ts (epoch seconds), level, logger, msg,
    and the current scheduling cycle when one is active (``set_log_cycle``).
    A record carrying its own ``cycle`` attribute (``extra={"cycle": n}``)
    wins over the ambient one."""

    def format(self, record: logging.LogRecord) -> str:
        obj: dict = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        cycle = getattr(record, "cycle", None)
        if cycle is None:
            cycle = _log_cycle[0]
        if cycle is not None:
            obj["cycle"] = cycle
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj)


def configure_logging(level: str = "INFO", fmt: str = "text") -> None:
    """Process-wide log init (the main.rs:129 equivalent), level configurable
    — the reference hard-codes both level and format.  ``fmt="json"`` emits
    one JSON object per line for log pipelines; ``"text"`` keeps the
    human-readable default."""
    lvl = getattr(logging, level.upper(), logging.INFO)
    if fmt == "json":
        handler = logging.StreamHandler()
        handler.setFormatter(JsonLogFormatter())
        logging.basicConfig(level=lvl, handlers=[handler], force=True)
    elif fmt == "text":
        logging.basicConfig(
            level=lvl,
            format="%(asctime)s %(levelname)s %(name)s %(message)s",
        )
    else:
        raise ValueError(f"unknown log format {fmt!r} (expected 'text' or 'json')")


class Trace:
    """Accumulates named span durations (seconds) for one scope (e.g. one
    scheduling cycle), plus the span INTERVALS in wall-clock time — the
    flight recorder's Chrome-trace source.  Intervals are derived from
    perf_counter deltas re-anchored to wall time at construction, so they
    are monotonic within the trace and meaningful across cycles.

    Spans NEST: while a span is open, spans (and ``record`` calls) inside it
    key under ``parent/child`` paths.  ``durations``/``counts``/``events``
    are therefore PATH-keyed; depth-0 paths (no ``/``) are the cycle phases.
    Single-threaded by design — only the entering thread's spans land here
    (see the module docstring)."""

    __slots__ = ("durations", "counts", "events", "_wall0", "_perf0", "_path")

    def __init__(self):
        self.durations: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.events: list[tuple[str, float, float]] = []  # (path, wall_start, wall_end)
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()
        self._path = ""  # the currently open span path ("" = top level)

    def wall(self, perf_t: float) -> float:
        """A ``perf_counter`` stamp on this trace's wall clock (the clock of
        its span intervals)."""
        return self._wall0 + (perf_t - self._perf0)

    def record(self, name: str, seconds: float, perf_start: float | None = None) -> None:
        """Record a span as a child of the currently open path.  ``perf_start``
        (a perf_counter stamp) gives the exact interval; without it the
        interval is synthesized as ending now (a kernel build, or work timed
        elsewhere that ended just before the call)."""
        path = f"{self._path}/{name}" if self._path else name
        self._record_path(path, seconds, perf_start)

    def _record_path(self, path: str, seconds: float, perf_start: float | None) -> None:
        self.durations[path] = self.durations.get(path, 0.0) + seconds
        self.counts[path] = self.counts.get(path, 0) + 1
        end = time.perf_counter() if perf_start is None else perf_start + seconds
        self.events.append((path, self.wall(end - seconds), self.wall(end)))

    def __enter__(self) -> "Trace":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        s = _stack()
        if self in s:
            s.remove(self)

    def summary(self) -> dict[str, float]:
        """Path -> accumulated seconds (depth-0 paths are plain names)."""
        return dict(self.durations)

    def top_level(self) -> dict[str, float]:
        """Depth-0 durations only — the disjoint cycle phases whose sum is
        the attributed share of the cycle wall."""
        return {p: s for p, s in self.durations.items() if "/" not in p}


def current_trace() -> Trace | None:
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


# The Python-side flag every ``torch.profiler`` session sets while it
# records (``torch.autograd.profiler._is_profiler_enabled``): unlike
# ``torch._C._autograd._profiler_enabled()``, which reads the profiler's
# thread-local state, it reads True on every thread, so the bind worker sees
# a session its own thread did not start.  Resolved at the first depth-0
# span, so importing this module never imports torch.
_profiler_module: list = [None]


def _profiling() -> bool:
    mod = _profiler_module[0]
    if mod is None:
        import torch.autograd.profiler as mod

        _profiler_module[0] = mod
    return mod._is_profiler_enabled


def profiler_range(name: str):
    """An open profiler range named ``name`` while a ``torch.profiler``
    records, else None; the caller closes it with ``__exit__(None, None,
    None)``.  The range is a plain CPU op (``_RecordFunctionFast``), not a
    user annotation: the profiler mirrors user annotations onto the device
    timeline as device events, and a phase must not read as device work."""
    if not _profiling():
        return None
    import torch

    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class span:
    """Time a block into the active trace (hierarchically).  A plain class
    context manager, not @contextmanager: this sits on the per-round hot
    path and the generator protocol costs ~2 µs per use that a __slots__
    class does not (the <2 % profiler-overhead budget is built from this).
    A depth-0 span (a cycle phase) also opens a profiler range while a
    ``torch.profiler`` records; nested spans never check."""

    __slots__ = ("name", "_t0", "_tr", "_prev", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        s = getattr(_tls, "stack", None)
        tr = self._tr = s[-1] if s else None
        self._range = None
        if tr is not None:
            prev = tr._path
            self._prev = prev
            if prev:
                tr._path = f"{prev}/{self.name}"
            else:
                tr._path = self.name
                self._range = profiler_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        tr = self._tr
        if tr is not None:
            path = tr._path
            tr._path = self._prev
            tr._record_path(path, dt, self._t0)
            if self._range is not None:
                self._range.__exit__(None, None, None)


@contextlib.contextmanager
def device_profile(log_dir: str | None):
    """``torch.profiler`` trace around a block, exported as a Chrome trace
    (``device_trace.json``) into ``log_dir``; inert when ``log_dir`` is
    None.  A trace that was asked for and cannot start raises.  It records
    every thread, so the bind worker's batches (``bind`` ranges) sit in it
    beside the main thread's phases and the kernels."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
    )
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))
