"""Hold the topology (gang-locality) path of several checkouts against each
other in one process, to compare a change of the gang term with its parent
on the same card in the same call:

    python -m tpu_scheduler_torch.experiments.bench_topology_trees NAME=ROOT [NAME=ROOT ...] [--rounds R] [--reps N] [--cycles C]

Each ROOT is a checkout's root (for the parent, ``git archive`` unpacked
into an ignored directory such as ``build/``), imported under a name of its
own (``bench_choose_trees.load_tree``), so every tree runs its own wrapper,
its own build of ``choose.cu`` and its own term.  The inputs are made once,
by this checkout: bench.py's ``topology_row`` cluster at 100,000 pods x
8,192 nodes (gangs of 4-8, slices of 4 nodes, racks of 16) and the
constrained topology cell (8,192 x 512, the constrained row's fractions,
gangs of 2-4).  Per tree:

* ``term_prep``: the host clock (synchronised) of one round's term
  preparation at the flagship's round 0, median of 5 — the dense [G+1, N]
  term for a tree that builds it, the small per-round inputs for one that
  does not;
* ``choose_topology`` (#1t, the flagship's first 8,192-pod block at round 0)
  and ``choose_constrained_topology`` (#2t, the constrained cell's round-0
  block): every tree's (choice, has, best) held bit for bit against the
  first tree's, then CUDA events around ``--reps`` launches in ``--rounds``
  rounds that visit the trees forwards and backwards in turn;
* ``topology_flagship``: ``--cycles`` warm cycles (cache hits) per tree
  through ``CudaBackend.schedule``, in the same alternating order, each with
  its host clock ending in a synchronise and its peak device memory above
  the memory held before it; rounds, bound pods, the bindings held against
  the first tree's, and gangs placed across racks.

Prints the card's name and power limit, one JSON line per tree (build
seconds, ptxas registers and spills of a build made in this call) and one
per phase.  Needs
a CUDA device: without one it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import random
import statistics
import sys
import time

import numpy as np
import torch

from ..convert import constraints_to_device, to_device
from ..core.snapshot import ClusterSnapshot
from ..models.profiles import PROFILES
from ..ops.constraints import augment_round_state, pack_constraints, round_blocked_masks
from ..ops.pack import pack_snapshot
from ..testing import make_node, make_pod, synth_cluster
from ..topology.locality import gang_placement_stats, pack_topology
from ..topology.model import DEFAULT_LEVEL_KEYS, TopologyModel
from . import card, ptxas_resources, time_cuda
from .bench_choose_builds import _block
from .bench_choose_trees import load_tree

__all__ = ["main", "topology_cluster"]

SLICE_KEY, RACK_KEY = DEFAULT_LEVEL_KEYS[0][1], DEFAULT_LEVEL_KEYS[1][1]
CONSTRAINT_POD_KEYS = (
    "pod_aa_carries", "pod_aa_matched", "pod_sp_declares", "pod_pa_declares", "pod_pa_matched",
    "pod_sps_declares", "pod_ppa_w",
)
# bench.py's constrained row: every inter-pod constraint family and extended
# resources on 10 % of the pending pods each.
_CONS = dict(
    anti_affinity_fraction=0.1, spread_fraction=0.1, schedule_anyway_fraction=0.1, pod_affinity_fraction=0.1,
    preferred_pod_affinity_fraction=0.1, extended_fraction=0.1,
)


def topology_cluster(pods: int, nodes: int, seed: int):
    """(packed cluster with its TopologySet, compiled topology, {gang: member
    full names}) of bench.py's ``topology_row``: ``nodes`` nodes of 32 CPU /
    128 Gi in slices of 4 and racks of 16; 35 % of draws open a gang of 4-8
    members at 2 CPU / 4 Gi, the others are single pods at 1 CPU / 2 Gi."""
    rng = random.Random(seed)
    node_objs = [
        make_node(f"tn{i:05d}", cpu="32", memory="128Gi",
                  labels={SLICE_KEY: f"s{i // 4}", RACK_KEY: f"r{i // 16}", "name": f"tn{i:05d}"})
        for i in range(nodes)
    ]
    pod_objs, gangs, gi = [], {}, 0
    while len(pod_objs) < pods:
        if rng.random() < 0.35:
            members = []
            for m in range(rng.randrange(4, 9)):
                pod_objs.append(make_pod(f"g{gi}-m{m}", cpu="2", memory="4Gi", gang=f"gang-{gi}"))
                members.append(f"default/g{gi}-m{m}")
            gangs[f"gang-{gi}"] = members
            gi += 1
        else:
            pod_objs.append(make_pod(f"tp{len(pod_objs)}", cpu="1", memory="2Gi"))
    snap = ClusterSnapshot.build(node_objs, pod_objs)
    compiled = TopologyModel.detect(node_objs).compile(node_objs)
    packed = pack_snapshot(snap)
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    return dataclasses.replace(packed, topology=topo), compiled, gangs


def constrained_topology_cell(device):
    """(packed, block args, constraint pod rows, round-0 masks) of the
    constrained topology cell's first 8,192-pod block."""
    snap = synth_cluster(n_nodes=512, n_pending=8192, seed=0, gang_fraction=0.35, **_CONS)
    packed = pack_snapshot(snap, pod_block=8192, node_block=128)
    cons = pack_constraints(snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes,
                            max_aa_terms=256, max_spread=256)
    for i, node in enumerate(snap.nodes):
        node.metadata.labels.update({SLICE_KEY: f"s{i // 4}", RACK_KEY: f"r{i // 16}"})
    compiled = TopologyModel.detect(snap.nodes).compile(snap.nodes)
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    packed = dataclasses.replace(packed, constraints=cons, topology=topo)
    cpods, meta, state = constraints_to_device(cons, device)
    masks = round_blocked_masks(augment_round_state(state, meta), meta, soft_spread=cons.n_spread_soft > 0,
                                soft_pa=cons.n_ppa_terms > 0, hard_pa=cons.n_pa_terms > 0)
    arrays = to_device(packed, device)
    cons_pod = {k: cpods[k][:8192].contiguous() for k in CONSTRAINT_POD_KEYS}
    return packed, _block(arrays, 0, 8192, 0, packed.padded_nodes), cons_pod, masks


def tree_term(alias: str, packed, device, weight: float, lo: int, hi: int):
    """(the tree's gang-term operand for pod rows [lo, hi) at round 0, the
    tree's per-round preparation as a function).  A tree whose locality has
    ``GangTerm`` builds the small per-round inputs; an older one the dense
    [G+1, N] term."""
    loc = importlib.import_module(f"{alias}.topology.locality")
    conv = importlib.import_module(f"{alias}.convert")
    arrays = conv.to_device(packed, device)
    tpods, tmeta, tstate = conv.topology_to_device(packed.topology, device)
    args = (arrays["node_avail"], tpods["pod_gang_id"], arrays["pod_req"], arrays["pod_valid"])
    gid = tpods["pod_gang_id"][lo:hi].contiguous()
    if hasattr(loc, "GangTerm"):
        cyc = loc.gang_cycle_operands(tmeta)

        def prep():
            return loc.gang_round_operands(cyc, tstate, tmeta, *args, weight)

        return prep()._replace(gang_id=gid), prep

    def prep():
        return loc.gang_topology_term(tstate["gang_nodes"], tmeta, *args, np.float32(weight))

    return (gid, prep()), prep


def host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn`` between two synchronises."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def same_outputs(a: tuple, b: tuple) -> bool:
    return (torch.equal(a[1], b[1]) and torch.equal(a[0][a[1]], b[0][b[1]])
            and torch.equal(a[2].view(torch.int32), b[2].view(torch.int32)))


def cross_rack(result, compiled, gangs: dict) -> int:
    """Gangs admitted whole with a member pair in different racks."""
    node_of = dict(result.bindings)
    dists = compiled.level_distances()
    cross = 0
    for members in gangs.values():
        placed = [node_of.get(m) for m in members]
        if all(n is not None for n in placed):
            cross += bool(gang_placement_stats([compiled.domains_of(n) for n in placed], dists)["cross_edges"])
    return cross


def alternate(names: list, rounds: int):
    """The tree names in turn, forwards then backwards, ``rounds`` times."""
    for r in range(rounds):
        yield from (names if r % 2 == 0 else names[::-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cycles", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_topology_trees: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    roots = dict(t.split("=", 1) for t in args.trees)
    print(card(), flush=True)
    choose = {name: load_tree(name, root) for name, root in roots.items()}
    for name, mod in choose.items():
        _, seconds, log = mod.build_library()
        print(json.dumps({"tree": name, "root": roots[name], "build_seconds": seconds,
                          "ptxas": {k: v for k, v in ptxas_resources(log).items() if "choose" in k}}), flush=True)
    names = list(choose)
    first = names[0]
    device = torch.device("cuda")
    profile = PROFILES["throughput"]
    w = profile.weights()

    t0 = time.perf_counter()
    packed, compiled, gangs = topology_cluster(100_000, 8_192, seed=0)
    ct_packed, ct_args, ct_cons, ct_masks = constrained_topology_cell(device)
    print(json.dumps({"phase": "setup", "seconds": time.perf_counter() - t0, "gangs": packed.topology.n_gangs}),
          flush=True)
    arrays = to_device(packed, device)
    block = _block(arrays, 0, 8192, 0, packed.padded_nodes)

    ops, preps = {}, {}
    for name in names:
        ops[name], preps[name] = tree_term(f"_tree_{name}", packed, device, float(w[6]), 0, 8192)
    print(json.dumps({"phase": "term_prep", "ms": {n: host_ms(preps[n]) for n in names}}), flush=True)
    del preps

    def timed_case(case: str, calls: dict, extra: dict) -> bool:
        outs = {name: fn() for name, fn in calls.items()}
        equal = {name: same_outputs(outs[name], outs[first]) for name in names}
        runs = {name: [] for name in names}
        for name in alternate(names, args.rounds):
            runs[name].append(time_cuda(calls[name], args.reps))
        print(json.dumps({"phase": case, **extra, "equal": equal, "ms": {k: statistics.median(v) for k, v in
                                                                           runs.items()},
                          "min_max": {k: [min(v), max(v)] for k, v in runs.items()}, "runs": runs}), flush=True)
        return all(equal.values())

    words = choose[first].pack_node_words(*block[13:18])
    ok = timed_case("choose_topology", {
        name: (lambda name=name: choose[name].choose_block(*block, w, 1, node_words=words, topo=ops[name]))
        for name in names}, {"B": 8192, "N": packed.padded_nodes})
    del ops
    ct_ops = {name: tree_term(f"_tree_{name}", ct_packed, device, float(w[6]), 0, 8192)[0] for name in names}
    ct_words = choose[first].pack_node_words(*ct_args[13:18])
    ok &= timed_case("choose_constrained_topology", {
        name: (lambda name=name: choose[name].choose_block_constrained(
            *ct_args, ct_cons, ct_masks, w, 1, node_words=ct_words, topo=ct_ops[name]))
        for name in names}, {"B": 8192, "N": ct_packed.padded_nodes})
    del ct_ops
    torch.cuda.empty_cache()

    backends = {name: importlib.import_module(f"_tree_{name}.backends.cuda").CudaBackend() for name in names}
    results = {name: backends[name].schedule(packed, profile) for name in names}  # warm-up: uploads, builds
    seconds = {name: [] for name in names}
    peak = {name: 0 for name in names}
    for name in alternate(names, args.cycles):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        results[name] = backends[name].schedule(packed, profile)
        torch.cuda.synchronize()
        seconds[name].append(time.perf_counter() - t0)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated() - held)
    ref = results[first]
    same = {name: bool(np.array_equal(r.assigned, ref.assigned) and r.rounds == ref.rounds)
            for name, r in results.items()}
    print(json.dumps({
        "phase": "topology_flagship", "pods": packed.num_pods, "nodes": packed.num_nodes,
        "gangs": packed.topology.n_gangs, "cache_hit_seconds": seconds,
        "median_seconds": {k: statistics.median(v) for k, v in seconds.items()},
        "cycle_peak_bytes": peak, "rounds": {k: r.rounds for k, r in results.items()},
        "bound": {k: len(r.bindings) for k, r in results.items()},
        "cross_rack_gangs": {k: cross_rack(r, compiled, gangs) for k, r in results.items()}, "equal": same,
    }), flush=True)
    ok &= all(same.values())
    if not ok:
        print("bench_topology_trees: the trees disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
