"""One run of one cell: set-up, the measured window, the check, the result.

The driver is the benchmark's own loop around ``Scheduler.run_cycle``, as
the CLI daemon runs it back to back while there is work.  The traffic file
describes waves (a closed loop): a wave of pending pods lands at once;
cycles run until the API server has accepted a binding for each; the wave
is deleted (the job finished) and the next lands under new names.  The
window is made of whole waves: from the first wave's API calls until the
first wave boundary after ``seconds`` of wave time.  Building the next
wave's API objects (the clients' work) is outside it; the API server's
creates and deletes, every cycle and the bind drain are inside.  A wave
that stalls (``grace_s``) ends the window.

After the window the run frees the program and hands the API server's log
to the plain reference (``reference/check.py``), whose numbers decide
``correct``; ``failed`` counts the measured pods never bound and each
guarantee a binding broke.  Standard error gets each phase of set-up, and
each wave's seconds split by the cycle's phases and the interpreter's
garbage collections.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import cluster as gen
from . import devtrace
from .reference.check import INTERPOD, LIMITS, Cluster, Kind, replay
from .spec import Cell, load_reader
from .stats import rate

__all__ = ["FORBIDDEN", "forbidden_modules", "run"]

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_scheduler")
# How often the loop looks for accepted bindings while the binds drain.
_POLL_S = 0.002
# CycleMetrics phases each wave's line on standard error splits.
_PHASES = ("sync", "pack", "slo", "delta", "overlay", "solve", "queue", "mopup", "other")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class GcClock:
    """Seconds the interpreter spends in garbage collections, by generation
    (``gc.callbacks``), while installed."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t0
            self.count[g] += 1

    def snapshot(self) -> tuple[list[float], list[int]]:
        return list(self.seconds), list(self.count)


class Run:
    """State of one run: the generated inputs, the API server, the system
    and what the loops recorded."""

    def __init__(self, cell: Cell, seed: int, device: str, driver: str, fault: str | None, scale: dict | None,
                 traced: bool):
        from . import system

        self.system = system
        self.seed = seed
        self.traced = traced
        self.device = device
        self.dep = gen.load_deployment(cell.config_file)
        self.traffic = gen.load_traffic(cell.traffic_file)
        for key, value in (scale or {}).items():  # smaller sizes for the harness's own tests
            if key == "nodes":
                self.dep = gen.Deployment(**{**self.dep.__dict__, "nodes": value})
            else:
                self.traffic[key] = value
        self.kinds = gen.pod_types(self.dep)
        self.type_rows: dict[str, np.ndarray] = {}  # pod name prefix -> each pod's index into ``kinds``
        self.driver_kind = driver
        self.fault = fault
        self.api = system.StampingApiServer()
        self.gc = GcClock()
        self.cycles: list[dict] = []  # traced cycles
        self.host_spans: list[tuple[str, float, float]] = []  # wall-clock (name, start, end)
        self.tracing = False
        self.prof = None

    # -- inputs ------------------------------------------------------------

    def make_pods(self, prefix: str, n: int, nodes=None) -> tuple[list, list[str]]:
        """``n`` pods named ``<prefix>-<i>``; of the deployment's kinds, drawn
        from the seed, unless they are plain (no kinds, or the pods bound at
        the start, on ``nodes``)."""
        names = [f"{prefix}-{i}" for i in range(n)]
        rows = None
        if self.dep.kinds and nodes is None:
            rows = self.type_rows[prefix] = gen.type_rows(self.dep, n, gen.rng_for(self.seed, f"kinds/{prefix}"))
        return self.system.make_pods(self.dep, names, nodes, rows), names

    def kind_of(self, pod: str) -> int:
        prefix, i = pod.rsplit("-", 1)
        rows = self.type_rows.get(prefix)
        return 0 if rows is None else int(rows[int(i)])

    def reference_cluster(self) -> Cluster:
        dep = self.dep
        names = [self.system.node_name(i) for i in range(dep.nodes)]
        extra = {}
        if dep.kinds:
            rows = [gen.labels_of_node(dep, i, name) for i, name in enumerate(names)]
            labels = {key: [row[key] for row in rows] for key in rows[0]}
            kinds = [Kind(gen.cpu_milli(k.cpu), gen.mem_bytes(k.memory), dict(k.labels), k.terms) for k in self.kinds]
            extra = {"node_labels": labels, "kinds": kinds, "kind_of": self.kind_of}
        return Cluster(
            node_index={name: i for i, name in enumerate(names)},
            alloc_cpu=np.full(dep.nodes, gen.cpu_milli(dep.node_cpu)),
            alloc_mem=np.full(dep.nodes, gen.mem_bytes(dep.node_memory)),
            pod_cpu=gen.cpu_milli(dep.pod_cpu),
            pod_mem=gen.mem_bytes(dep.pod_memory),
            **extra,
        )

    def load_cluster(self) -> None:
        """The nodes and the pods bound at the start."""
        dep = self.dep
        for node in self.system.make_nodes(dep):
            self.api.create_node(node)
        n = int(self.traffic["bound_at_start"])
        rows = gen.base_placement(n, dep.nodes, gen.rng_for(self.seed, "base"))
        pods, _ = self.make_pods("base", n, [self.system.node_name(r) for r in rows])
        for p in pods:
            self.api.create_pod(p)

    # -- the system ----------------------------------------------------------

    def start_driver(self) -> None:
        if self.driver_kind == "program":
            self.sched = self.system.make_scheduler(self.api, self.dep, self.seed, self.device, self.fault)
        else:
            from .control import ControlDriver

            breaks = None if self.driver_kind == "reference" else self.driver_kind
            self.sched = ControlDriver(self.api, self.reference_cluster(), breaks)

    def cycle(self):
        before = self.system.counters() if self.tracing else None
        t0 = time.time()
        m = self.sched.run_cycle()
        t1 = time.time()
        if self.tracing:
            after = self.system.counters()
            rec = {k: getattr(m, k) for k in m.__dataclass_fields__}
            rec.update(t0=t0, t1=t1, launches={k: after[k] - before[k] for k in ("launches", "launches_constrained")})
            self.cycles.append(rec)
            spans = self.sched.recorder.cycles(1)
            if spans:
                self.host_spans.extend((s["name"], s["start"], s["end"])
                                       for s in spans[-1]["spans"] if "/" not in s["name"])
        return m

    # -- tracing -----------------------------------------------------------

    def start_trace(self) -> None:
        """Open the measured window (a profiled one in a traced run)."""
        self.wall_offset = time.time() - time.perf_counter()
        if not self.traced:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.upload0 = self.system.counters()["upload_bytes"]
        self.tracing = True
        if self.device == "cuda":
            torch.cuda.synchronize()

    def stop_trace(self, windows) -> None:
        """Close it; ``windows`` are the measured (start, end) wall-clock spans."""
        if self.prof is None:
            return
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        self.tracing = False
        self.upload1 = self.system.counters()["upload_bytes"]
        self.prof.__exit__(None, None, None)
        self.trace_windows = windows

    def harness_span(self, name: str, t0: float) -> None:
        if self.tracing:
            self.host_spans.append((name, t0, time.time()))

    def bound_since(self, i: int) -> tuple[int, list]:
        new = self.api.log_since(i)
        return i + len(new), [e for e in new if e[0] == "B"]


# -- the loop ----------------------------------------------------------------


def _wave(run: Run, label: str, pods: list, names: list[str], prev: list[str], stall_s: float
          ) -> tuple[float, float, bool]:
    """Delete ``prev``, land the wave, cycle until every pod of it is bound.
    Returns (start, last binding's stamp, complete); logs the wave's split."""
    api, ns = run.api, run.system.NAMESPACE
    gc0, n0 = run.gc.snapshot()
    phases = dict.fromkeys(_PHASES, 0.0)
    cycles = 0
    t0 = time.perf_counter()
    w0 = time.time()
    for n in prev:
        api.delete_pod(ns, n)
    for p in pods:
        api.create_pod(p)
    t_api = time.perf_counter() - t0
    run.harness_span("bench.api", w0)
    idx = len(api.log)
    want, got, last, ok = len(names), 0, t0, True
    while got < want:
        m = run.cycle()
        cycles += 1
        for ph in _PHASES:
            phases[ph] += getattr(m, f"{ph}_seconds", 0.0)
        idx, new = run.bound_since(idx)
        got += len(new)
        if new:
            last = new[-1][3]
        if got >= want:
            break
        if m.pending == 0:
            # Nothing left to solve: the pipelined binds are in flight.
            w0 = time.time()
            deadline = time.perf_counter() + 1.0
            while time.perf_counter() < deadline:
                time.sleep(_POLL_S)
                idx, new = run.bound_since(idx)
                got += len(new)
                if new:
                    last = new[-1][3]
                if got >= want:
                    break
            run.harness_span("bench.wait", w0)
        if time.perf_counter() - t0 > stall_s:
            ok = False
            break
    if ok:
        api.mark()
    gc1, n1 = run.gc.snapshot()
    split = " ".join(f"{ph} {v:.4f}" for ph, v in phases.items())
    log(f"# wave {label}: {last - t0:.4f} s, {cycles} cycles; api {t_api:.4f}; {split}; "
        f"gc seconds {[round(b - a, 4) for a, b in zip(gc0, gc1)]} collections {[b - a for a, b in zip(n0, n1)]}")
    return t0, last, ok


def waves_loop(run: Run, seconds: float) -> dict:
    t = run.traffic
    size, stall = int(t["wave"]), float(t["grace_s"])
    prev: list[str] = []
    for k in range(int(t["warmup_waves"])):
        pods, names = run.make_pods(f"w{k}", size)
        _, _, ok = _wave(run, f"w{k} (warm-up)", pods, names, prev, stall)
        prev = names
        if not ok:
            break
    run.setup_waves_end = time.perf_counter()
    gc.collect()  # the window starts from a collected heap
    run.setup_end = time.perf_counter()
    run.start_trace()
    spans, measured, k = [], [], int(t["warmup_waves"])
    while sum(e - s for s, e in spans) < seconds:
        pods, names = run.make_pods(f"w{k}", size)  # the clients' work: outside the window
        s, e, ok = _wave(run, f"w{k}", pods, names, prev, stall)
        k += 1
        prev = names
        spans.append((s, e))
        measured.extend(names)
        if not ok:
            break
    run.stop_trace([(s + run.wall_offset, e + run.wall_offset) for s, e in spans])
    bound = sum(1 for n in measured if n in run.api.bound_at)
    log(f"# waves: {len(spans)} measured, seconds each {[round(e - s, 4) for s, e in spans]}")
    return {"attempted": len(measured), "bound": bound, "e2e": {"backlog_pods_per_s": rate(bound, spans)}}


# -- the traced run's record ---------------------------------------------------


def _trace_record(run: Run, bound: int) -> dict:
    """What the per-layer readers read: the traced cycles (``CycleMetrics``
    fields, the program's counters, each choose kernel's device seconds),
    the pods bound, the device's busy and window seconds."""
    events = devtrace.device_events(run.prof)
    windows = run.trace_windows
    choose = devtrace.choose_events(events)
    for c in run.cycles:
        c["choose_s"] = devtrace.kernel_seconds(choose, c["t0"], c["t1"])
    busy = devtrace.busy_union(events, windows)
    window_s = devtrace.length(devtrace.merge(windows))
    idle = devtrace.idle_by_phase(busy, windows, run.host_spans)
    return {
        "nodes": run.dep.nodes,
        "bound": bound,
        "cycles": run.cycles,
        "upload_bytes": run.upload1 - run.upload0,
        "busy_s": devtrace.length(busy),
        "window_s": window_s,
        "breakdown": {
            "device_ops": devtrace.top_ops(events, windows),
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda x: -x[1])[:10]],
        },
    }


# -- a run -------------------------------------------------------------------


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda", driver: str = "program",
        fault: str | None = None, scale: dict | None = None) -> dict:
    """Run ``cell`` once; the result line's fields plus ``checks``."""
    t_setup = time.perf_counter()
    r = Run(cell, seed, device, driver, fault, scale, trace)
    t_imported = time.perf_counter()
    # The CLI daemon tunes the collector first thing; so does the run.
    r.system.enable_daemon_gc_tuning()
    gc.callbacks.append(r.gc)
    try:
        if device == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats()
        r.load_cluster()
        t_loaded = time.perf_counter()
        r.start_driver()
        t_started = time.perf_counter()
        out = waves_loop(r, seconds)
    finally:
        gc.callbacks.remove(r.gc)
    setup_s = r.setup_end - t_setup
    log(f"# set-up: {setup_s:.4f} s; imports {t_imported - t_setup:.4f}, cluster and API server "
        f"{t_loaded - t_imported:.4f}, system "
        f"{t_started - t_loaded:.4f}, warm-up {r.setup_waves_end - t_started:.4f}, collection "
        f"{r.setup_end - r.setup_waves_end:.4f}")
    if hasattr(r.sched, "close"):
        r.sched.close()
    peak = 0
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    record = _trace_record(r, out["bound"]) if trace else None
    del r.sched
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    marks: list = []
    counts = replay(r.reference_cluster(), r.api.log, marks)
    log(f"# reference replay over {len(r.api.log)} events: {time.perf_counter() - t_check:.3f} s")
    log(f"# bindings per node at each mark (least, median, most, nodes passed over): {marks}")
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in counts.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = (out["attempted"] - out["bound"]) + sum(counts.get(k, 0) for k in ("bad_binds", "overcommitted_binds",
                                                                              *INTERPOD))
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.bench_dir)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": v, "unit": units[name]} for name, v in out["e2e"].items() if name in units}
        metrics["setup_s"] = {"value": setup_s, "unit": units.get("setup_s", "s")}
    result = {"correct": correct, "attempted": out["attempted"], "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device, "kind": _device_kind(device),
                         "count": 1, "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["checks"] = checks
    return result


def _device_kind(device: str) -> str:
    if device == "cuda":
        import torch

        return torch.cuda.get_device_name(0)
    return device
