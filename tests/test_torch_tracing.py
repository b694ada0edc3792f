"""The port's critical-path tracing on the CPU: the cycle's nested span
seconds, the pipelined bind worker's batches, the collector's pauses, the
flight recorder's lanes, and the phase ranges a running ``torch.profiler``
holds beside the recorder's intervals."""

import dataclasses
import gc
import random
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_scheduler_torch.backends.cuda import CudaBackend
from tpu_scheduler_torch.runtime.controller import Scheduler
from tpu_scheduler_torch.runtime.fake_api import FakeApiServer
from tpu_scheduler_torch.testing import make_node, make_pod
from tpu_scheduler_torch.utils import profiler
from tpu_scheduler_torch.utils.events import LANE_TIDS
from tpu_scheduler_torch.utils.metrics import CycleMetrics, cycle_phases

torch.set_num_threads(1)

# The CycleMetrics fields beyond the phases.
OFF_PHASE_FIELDS = ("spans", "constraint_widths", "gc_pause_s", "gc_collections", "bind_posts", "bind_failures",
                    "bind_wall_s", "bind_cpu_s")
# The phases, as they were before the fields above: none of those may read as one.
PHASES = ("pack", "solve", "bind", "sync", "mopup", "overlay", "noexecute", "queue", "delta", "constrained",
          "preempt", "gang", "slo", "rebalance", "autoscale", "other")


class CountingApiServer(FakeApiServer):
    """The in-process API server, counting the bindings it accepted."""

    def __init__(self):
        super().__init__()
        self.accepted = 0

    def create_binding(self, namespace, pod_name, target):
        super().create_binding(namespace, pod_name, target)
        with self._lock:
            self.accepted += 1


def _api(n_nodes=8, n_pending=60):
    api = CountingApiServer()
    for i in range(n_nodes):
        api.create_node(make_node(f"n{i}"))
    for i in range(n_pending):
        api.create_pod(make_pod(f"p{i}"))
    return api


def _scheduler(api, **kw):
    return Scheduler(api, CudaBackend(device="cpu"), rng=random.Random(0), **kw)


def _pipelined_run(n_pending=60):
    """A pipelined scheduler's first cycle, then, once the worker finished
    its batch, one more cycle: the batch is folded by the first, or else by
    the second."""
    api = _api(n_pending=n_pending)
    sched = _scheduler(api, pipeline=True)
    ms = [sched.run_cycle()]
    # The worker records its batch for the next cycle before it signals
    # the batch done.
    assert sched._bind_inflight[1].wait(timeout=30)
    ms.append(sched.run_cycle())
    return api, sched, ms


def test_off_phase_fields_are_not_phases():
    names = {f.name for f in dataclasses.fields(CycleMetrics)}
    assert set(OFF_PHASE_FIELDS) <= names
    assert not [n for n in OFF_PHASE_FIELDS if n.endswith("_seconds")]
    assert set(cycle_phases()) == set(PHASES)
    m = CycleMetrics(cycle=1, backend="b", pending=0, bound=0, unschedulable=0, rounds=0, wall_seconds=0.0)
    assert m.spans == {} and m.gc_collections == [0, 0, 0] and m.bind_posts == 0


def test_pipelined_cycles_fill_every_field_and_count_every_post():
    api, sched, ms = _pipelined_run()
    try:
        first = ms[0]
        assert first.bound == 60 and api.accepted == 60
        for path in ("sync/poll", "sync/fold", "sync/snapshot", "delta/commit", "delta/commit/rebuild"):
            assert first.spans[path] > 0.0, path
        assert first.spans["sync/poll"] + first.spans["sync/fold"] + first.spans["sync/snapshot"] <= \
            first.sync_seconds
        assert sum(m.bind_posts for m in ms) == api.accepted
        assert sum(m.bind_failures for m in ms) == 0
        batch = max(ms, key=lambda m: m.bind_posts)
        assert batch.bind_wall_s > 0.0 and 0.0 <= batch.bind_cpu_s
        assert all(len(m.gc_collections) == 3 and m.gc_pause_s >= 0.0 for m in ms)
        # The worker's batch sits on its own lane of the cycle that folded it.
        lanes = [lane for rec in sched.recorder.cycles() for lane in rec.get("lanes", ()) if lane["lane"] == "bind"]
        assert [lane["posts"] for lane in lanes] == [60] and lanes[0]["cycle"] == 1
        assert lanes[0]["end"] - lanes[0]["start"] == pytest.approx(batch.bind_wall_s, abs=1e-6)
    finally:
        sched.close()


def test_the_drain_records_no_made_up_bind_span():
    """The overlay's fold of a finished batch records no ``overlay/bind``
    (nor a depth-0 ``bind``): the batch's time is on the worker's lane."""
    _api_, sched, ms = _pipelined_run()
    try:
        assert sum(m.bind_posts for m in ms) == 60  # folded by the cycle running when it ended
        census = sched.profile_ring.span_census()
        assert "overlay/bind" not in census and "bind" not in census
        assert all("overlay/bind" not in m.spans and m.bind_seconds == 0.0 for m in ms)
    finally:
        sched.close()


def test_chrome_trace_draws_each_lane_on_its_own_track():
    _api_, sched, _ms = _pipelined_run()
    try:
        events = sched.recorder.chrome_trace()["traceEvents"]
        bind = [e for e in events if e.get("ph") == "X" and e["pid"] == 1 and e["tid"] == LANE_TIDS["bind"]]
        assert len(bind) == 1 and bind[0]["args"]["posts"] == 60 and bind[0]["pid"] == 1
        names = [e for e in events if e.get("ph") == "M" and e.get("pid") == 1]
        assert names == [{"name": "thread_name", "ph": "M", "pid": 1, "tid": LANE_TIDS["bind"],
                          "args": {"name": "bind lane"}}]
    finally:
        sched.close()


def test_gc_clock_installs_once_and_counts_a_forced_collection():
    profiler.install_gc_clock()
    profiler.install_gc_clock()
    assert gc.callbacks.count(profiler._gc_callback) == 1
    pause0, counts0 = profiler.gc_totals()
    garbage = [[i] for i in range(100_000)]
    gc.collect()
    pause1, counts1 = profiler.gc_totals()
    assert len(garbage) == 100_000  # alive through the collection
    assert pause1 > pause0 and counts1[2] > counts0[2]


class IndependentGcClock:
    """Collector seconds and collections by generation, on its own hook."""

    def __init__(self):
        self.seconds, self.count, self._t0 = 0.0, [0, 0, 0], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.count[info["generation"]] += 1


def test_cycle_pauses_match_an_independent_clock_and_reach_the_gc_lane():
    """A full collection inside one cycle (planted in the reflector's sync)
    reads the same on the cycle's ``gc_pause_s`` as on an independent
    ``gc.callbacks`` clock around ``run_cycle``, within 1 %; it is long
    enough for the recorder's ``gc`` lane.  A collection before the cycle
    stays out of it."""
    api = _api()
    sched = _scheduler(api)
    garbage = [[i] for i in range(300_000)]
    sync = sched.reflector.sync

    def sync_with_collection():
        gc.collect()
        return sync()

    sched.reflector.sync = sync_with_collection
    gc.collect()  # between cycles: not the cycle's
    clock = IndependentGcClock()
    # Only the planted collection: an automatic one could fall between the
    # cycle's last clock read and the removal of the independent hook.
    gc.disable()
    gc.callbacks.append(clock)
    try:
        m = sched.run_cycle()
    finally:
        gc.callbacks.remove(clock)
        gc.enable()
    assert len(garbage) == 300_000  # alive through the collection
    assert clock.count[2] >= 1 and clock.seconds >= profiler.GC_LONG_S
    assert m.gc_pause_s == pytest.approx(clock.seconds, rel=0.01)
    assert m.gc_collections == clock.count == [0, 0, 1]
    rec = sched.recorder.cycles(1)[-1]
    first_span = min(s["start"] for s in rec["spans"])
    gc_lane = [lane for lane in rec["lanes"] if lane["lane"] == "gc"]
    assert gc_lane and all(lane["end"] >= first_span for lane in gc_lane)
    assert any(lane["generation"] == 2 for lane in gc_lane)


def test_phase_ranges_sit_on_the_recorders_intervals():
    """Under ``torch.profiler`` each depth-0 span opens a range of its name;
    each range of the cycle matches the recorder's interval for that phase
    within 1 ms, on the profiler's own clock."""
    api = _api()
    sched = _scheduler(api)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.run_cycle()
    phases = [s for s in sched.recorder.cycles(1)[-1]["spans"] if "/" not in s["name"]]
    names = {s["name"] for s in phases}
    assert {"sync", "pack", "solve", "delta", "slo"} <= names
    ranges = sorted(
        ((e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
         for e in prof.profiler.kineto_results.events() if e.name() in names),
    )
    spans = sorted((s["start"], s["end"], s["name"]) for s in phases)
    assert [r[2] for r in ranges] == [s[2] for s in spans]
    for (r0, r1, _), (s0, s1, name) in zip(ranges, spans):
        assert abs(r0 - s0) < 1e-3 and abs(r1 - s1) < 1e-3, name


def test_nested_spans_open_no_range_and_no_profiler_means_no_range():
    from tpu_scheduler_torch.utils.tracing import Trace, profiler_range, span

    assert profiler_range("sync") is None
    tr = Trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr:
            with span("sync"):
                with span("poll"):
                    pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sync") == 1 and "poll" not in names


def test_bind_worker_range_under_an_all_threads_profiler():
    """``device_profile`` records every thread: the bind worker's batch is a
    ``bind`` range of the worker's thread, inside the profiler's trace."""
    from tpu_scheduler_torch.utils.tracing import profiler_range

    seen = {}

    def worker():
        rng = profiler_range("bind")
        seen["open"] = rng is not None
        if rng is not None:
            rng.__exit__(None, None, None)

    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["open"]
    assert [e.name() for e in prof.profiler.kineto_results.events()].count("bind") == 1


def test_every_post_is_folded_once_under_fast_thread_switching():
    """The worker hands its batches to the cycles under a lock: with the
    interpreter switching threads every microsecond and a wave of pods
    landing before every cycle, the cycles' ``bind_posts`` (and a last
    fold after the worker drained) add up to the bindings the server
    accepted, each batch folded once."""
    import sys

    api = _api(n_nodes=20, n_pending=0)  # room for all 300 pods
    sched = _scheduler(api, pipeline=True)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        posts = 0
        for k in range(25):
            for i in range(12):
                api.create_pod(make_pod(f"w{k}-{i}"))
            posts += sched.run_cycle().bind_posts
        sched.close()  # joins the batch in flight
        posts += sum(b[3] for b in sched._take_bind_batches())
    finally:
        sys.setswitchinterval(saved)
    assert api.accepted == 25 * 12 and posts == api.accepted


def test_constraint_widths_are_what_the_constrained_choose_reads(monkeypatch):
    """A constrained cycle records kernel #2's bitmap widths as ops/choose
    reads them off the pod operands (L, T, A, A2, Ts) and times the
    constraint packing under ``pack/constraints``; a plain cycle records
    neither."""
    import tpu_scheduler_torch.ops.assign as assign_mod
    from tpu_scheduler_torch.testing import synth_cluster

    seen = set()
    real = assign_mod.choose_block_constrained

    def spy(*args, **kw):
        seen.add(tuple(int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)))
        return real(*args, **kw)

    monkeypatch.setattr(assign_mod, "choose_block_constrained", spy)
    snap = synth_cluster(n_nodes=12, n_pending=60, n_bound=12, seed=4, selector_fraction=0.3, tainted_fraction=0.3,
                         soft_taint_fraction=0.3, preferred_affinity_fraction=0.3, anti_affinity_fraction=0.2,
                         spread_fraction=0.2)
    api = FakeApiServer()
    api.load(snap.nodes, snap.pods)
    m = _scheduler(api).run_cycle()
    assert seen == {tuple(m.constraint_widths)} and m.spans["pack/constraints"] > 0.0
    plain = _scheduler(_api()).run_cycle()
    assert plain.constraint_widths is None and "pack/constraints" not in plain.spans
