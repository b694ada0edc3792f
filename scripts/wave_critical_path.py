"""Where a backlog wave's end comes from: one traced run of a benchmark cell
with the flight recorder's spans and lanes, and the profiler's ranges and
kernels, read per wave.

    python3 scripts/wave_critical_path.py --workload basic-5k.backlog --seed 7 --seconds 51 \
        --out chiprun_out/critical_path_7.json

Runs ``benchmark.harness.run`` with ``--trace 1`` unchanged and watches it
from outside: each measured wave's start and last accepted binding, each
cycle's recorder record (depth-0 spans, the ``bind`` and ``gc`` lanes), the
harness's own collector clock around each wave, and the profiler's events.
For each wave it writes where the bind worker's first and last POST fall
among the main thread's phases, whether ``slo`` starts after the wave's
last accepted binding, and how much the delta commit and the bind drain
overlap.  Besides: the coverage of ``sync`` and ``delta`` by their nested
spans, the POSTs the traced cycles folded against the bindings accepted in
the window, the program's collector seconds against the harness's, and the
profiler's phase ranges against the recorder's intervals and the choose
kernels they hold.  Prints the harness's result line, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _phase_at(spans: list[tuple[str, float, float]], t: float) -> str:
    """The main-thread phase (depth-0 span) open at wall time ``t``, or
    ``between`` when none is."""
    for name, s, e in spans:
        if s <= t <= e:
            return name
    return "between"


def _overlap(a: tuple[float, float], b: tuple[float, float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def _clock_check(prof, records: list[dict]) -> dict:
    """The profiler's depth-0 phase ranges against the recorder's intervals
    (start offsets), and where each choose kernel starts among the ``solve``
    ranges: the kernels outside every range, and the largest gap between a
    range's edges and the first and last kernel it holds."""
    from benchmark import devtrace

    phases = sorted((s["start"], s["end"], s["name"]) for r in records for s in r["spans"] if "/" not in s["name"])
    names = {p[2] for p in phases}
    ranges = sorted(((e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name() in names and not str(e.device_type()).endswith("CUDA")))
    by_name: dict[str, list] = {}
    for s, e, n in ranges:
        by_name.setdefault(n, []).append((s, e))
    offsets = []
    for name in names:
        rec = [(s, e) for s, e, n in phases if n == name]
        got = by_name.get(name, [])
        if len(got) == len(rec):
            offsets += [(gs - rs, ge - re) for (gs, ge), (rs, re) in zip(got, rec)]
    device = devtrace.device_events(prof)
    kernels = devtrace.choose_events(device)
    solve = by_name.get("solve", [])

    def held_by_solve(ops):
        """(ops starting outside every solve range, {range: [(start, end)]})."""
        outside, held = 0, {}
        for os_, oe in ops:
            i = next((j for j, (s, e) in enumerate(solve) if s <= os_ <= e), None)
            if i is None:
                outside += 1
            else:
                held.setdefault(i, []).append((os_, oe))
        return outside, held

    def edges(held):
        """The largest gap from a range's start to its first op, and from
        its last op's end to the range's end."""
        lead = max((min(k[0] for k in ks) - solve[i][0] for i, ks in held.items()), default=0.0)
        tail = max((solve[i][1] - max(k[1] for k in ks) for i, ks in held.items()), default=0.0)
        return lead, tail

    outside, held = held_by_solve([(ks, ke) for ks, ke, _ in kernels])
    lead, tail = edges(held)
    _, held_any = held_by_solve([(s, e) for _, s, e in device])
    lead_any, tail_any = edges(held_any)
    annotations = sorted({e.name() for e in prof.profiler.kineto_results.events()
                          if str(e.device_type()).endswith("CUDA") and e.name() in names | {"bind"}})
    return {
        "phase_ranges": len(ranges),
        "recorder_phases": len(phases),
        "matched": len(offsets),
        "start_offset_ms_max_abs": 1e3 * max((abs(o[0]) for o in offsets), default=0.0),
        "end_offset_ms_max_abs": 1e3 * max((abs(o[1]) for o in offsets), default=0.0),
        "choose_kernels": len(kernels),
        "choose_kernels_outside_solve": outside,
        "solve_ranges_with_kernels": len(held),
        "solve_lead_ms_max": 1e3 * lead,
        "solve_tail_ms_max": 1e3 * tail,
        "solve_lead_ms_max_any_op": 1e3 * lead_any,
        "solve_tail_ms_max_any_op": 1e3 * tail_any,
        "device_events_named_as_phases": annotations,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="basic-5k.backlog")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at the size below, no card")
    p.add_argument("--small", action="store_true", help="the benchmark tests' size (120 nodes, waves of 2,400)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark.spec import Cell, load_spec

    records: list[dict] = []  # the recorder's record of every traced cycle
    waves: list[dict] = []
    extra: dict = {}
    cycle0, wave0, trace_record0 = harness.Run.cycle, harness._wave, harness._trace_record

    def cycle(run):
        m = cycle0(run)
        if run.tracing:
            records.append(run.sched.recorder.cycles(1)[-1])
        return m

    def wave(run, label, *a):
        gc0 = run.gc.snapshot()
        n_records = len(records)
        t0, last, ok = wave0(run, label, *a)
        gc1 = run.gc.snapshot()
        if run.tracing:
            waves.append({"label": label, "start": t0 + run.wall_offset, "end": last + run.wall_offset, "ok": ok,
                          "records": (n_records, len(records)),
                          "harness_gc_s": sum(b - a for a, b in zip(gc0[0], gc1[0])),
                          "harness_gc_collections": [b - a for a, b in zip(gc0[1], gc1[1])]})
        return t0, last, ok

    def trace_record(run, bound):
        out = trace_record0(run, bound)
        # Batches that ended after the last traced cycle folded, on the
        # same wall clock (the harness's own perf_counter offset).
        extra["unfolded_batches"] = [(run.wall_offset + b0, run.wall_offset + b1, posts)
                                     for _tag, b0, b1, posts, _f, _c in run.sched._take_bind_batches()]
        extra["clock"] = _clock_check(run.prof, records)
        extra["bound"] = bound
        return out

    harness.Run.cycle, harness._wave, harness._trace_record = cycle, wave, trace_record
    cell = Cell(load_spec(ROOT), args.workload)
    scale = {"nodes": 120, "bound_at_start": 1200, "wave": 2400, "grace_s": 4.0} if args.small else None
    result = harness.run(cell, args.seed, args.seconds, True, device=args.device, scale=scale)
    print(json.dumps(result), flush=True)

    bind_lanes = [(ln["start"], ln["end"], ln["posts"]) for r in records for ln in r.get("lanes", ())
                  if ln["lane"] == "bind"] + extra["unfolded_batches"]
    per_wave = []
    for w in waves:
        recs = records[w["records"][0]:w["records"][1]]
        spans = sorted(((s["name"], s["start"], s["end"]) for r in recs for s in r["spans"] if "/" not in s["name"]),
                       key=lambda x: x[1])
        commits = [(s["start"], s["end"]) for r in recs for s in r["spans"] if s["name"] == "delta/commit"]
        slo = [s for s in spans if s[0] == "slo"]
        batches = [b for b in bind_lanes if w["start"] <= b[1] and b[0] <= w["end"]]
        cycles = [r["metrics"] for r in recs]
        row = {"wave": w["label"], "seconds": w["end"] - w["start"], "cycles": len(recs),
               "harness_gc_s": w["harness_gc_s"], "program_gc_s": sum(c["gc_pause_s"] for c in cycles),
               "program_gc_collections": [sum(c["gc_collections"][g] for c in cycles) for g in range(3)],
               "harness_gc_collections": w["harness_gc_collections"]}
        if batches:
            first = min(batches)
            lastb = max(batches, key=lambda b: b[1])
            before: dict[str, float] = {}
            for name, s0, s1 in spans:
                if s1 <= first[0]:
                    before[name] = before.get(name, 0.0) + s1 - s0
            row.update(first_post_in=_phase_at(spans, first[0]), last_post_in=_phase_at(spans, lastb[1]),
                       first_post_after_start_s=first[0] - w["start"], last_post_to_window_end_s=lastb[1] - w["end"],
                       bind_drain_s=lastb[1] - first[0], phases_before_first_post_s=before)
        if commits:
            c = max(commits, key=lambda x: x[1] - x[0])
            drain = (min(b[0] for b in batches), max(b[1] for b in batches)) if batches else (0.0, 0.0)
            # The window ends at the last accepted binding, the drain's last
            # POST: the commit either ended before it (the drain finished
            # last) or was still running (the commit finished last, its
            # tail outside the window).
            row.update(delta_commit_s=c[1] - c[0], commit_drain_overlap_s=_overlap(c, drain),
                       commit_end_to_window_end_s=c[1] - w["end"],
                       finishes_last="bind drain" if c[1] < w["end"] else "delta commit")
        if slo:
            main_slo = max(slo, key=lambda s: s[2] - s[1])
            row.update(slo_start_to_window_end_s=main_slo[1] - w["end"], slo_s=main_slo[2] - main_slo[1],
                       slo_share_outside_window=max(0.0, main_slo[2] - max(main_slo[1], w["end"]))
                       / (main_slo[2] - main_slo[1])
                       if main_slo[2] > main_slo[1] else 0.0)
        per_wave.append(row)

    cycles = [r["metrics"] for r in records]
    sync = sum(c["sync_seconds"] for c in cycles)
    delta = sum(c["delta_seconds"] for c in cycles)
    nested = lambda *ps: sum(c["spans"].get(p, 0.0) for c in cycles for p in ps)  # noqa: E731
    summary = {
        "seed": args.seed,
        "waves": per_wave,
        "sync_coverage": nested("sync/poll", "sync/fold", "sync/snapshot") / sync if sync else None,
        "delta_coverage": nested("delta/index", "delta/close", "delta/repack", "delta/commit") / delta if delta else None,
        "bind_posts_traced": sum(c["bind_posts"] for c in cycles),
        "bindings_in_window": extra["bound"],
        "batch_sizes": sorted(b[2] for b in bind_lanes),
        "program_gc_s": sum(c["gc_pause_s"] for c in cycles),
        "harness_gc_s": sum(w["harness_gc_s"] for w in waves),
        "clock": extra["clock"],
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"result": result, "summary": summary}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
