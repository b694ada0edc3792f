"""Time kernels #1 and #2 without the gang term from the package of several
checkouts in one process, to hold a change of ``csrc/choose.cu`` or its
wrapper against its parent on the same card in the same call:

    python -m tpu_scheduler_torch.experiments.bench_choose_trees NAME=ROOT [NAME=ROOT ...] [--rounds R] [--reps N]

Each ROOT is a checkout's root (for the parent, ``git archive`` unpacked
into an ignored directory such as ``build/``); its ``tpu_scheduler_torch``
is imported under a name of its own, so every tree launches through its own
wrapper and its own build of ``choose.cu`` (into that tree's
``build/torch_kernels/``), while the inputs are made once, by this
checkout: the flagship block (8192 pods of the 100k x 10k flagship against
its 10,112 nodes, the ``throughput`` profile, salt 1), kernel #2b's shard
shape of it (53,248 x 5,056, node_offset 5,056) and the constrained
flagship's round-0 block (8192 x 10,112 with every constraint family).
Each tree's output is held bit for bit against this checkout's plain
version; then CUDA events time ``--reps`` launches per round, in
``--rounds`` rounds that visit the trees forwards and backwards in turn.
Prints the card's name and power limit, one JSON line per tree (build
seconds, ptxas registers and spills) and one per case (median and every
round's ms per tree).  Needs a CUDA device: without one it exits 1 and
measures nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import statistics
import sys

import torch

from ..convert import constraints_to_device, to_device
from ..models.profiles import PROFILES
from ..ops import choose as choose_mod
from ..ops.constraints import augment_round_state, pack_constraints, round_blocked_masks
from ..ops.pack import pack_snapshot
from ..testing import synth_cluster
from . import card, ptxas_resources, time_cuda
from .bench_choose_builds import _block

__all__ = ["load_tree", "main"]

# bench.py's constrained row: every constraint family and extended resources
# on 10 % of the pending pods each.
_CONS = dict(
    anti_affinity_fraction=0.1, spread_fraction=0.1, schedule_anyway_fraction=0.1, pod_affinity_fraction=0.1,
    preferred_pod_affinity_fraction=0.1, extended_fraction=0.1,
)


def load_tree(name: str, root: str):
    """The ``ops.choose`` module of the ``tpu_scheduler_torch`` under
    ``root``, imported as package ``_tree_<name>``."""
    pkg = pathlib.Path(root).resolve() / "tpu_scheduler_torch"
    alias = f"_tree_{name}"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.choose")


def _cases(device) -> list[tuple[str, list, dict | None, dict | None, int]]:
    """(name, block args, constraint pod bitmaps, round masks, node_offset)."""
    snap = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0)
    packed = pack_snapshot(snap, pod_block=8192, node_block=128)
    arrays = to_device(packed, device)
    n = packed.padded_nodes
    cases = [("flagship_block", _block(arrays, 0, 8192, 0, n), None, None, 0),
             ("shard_53248x5056", _block(arrays, 0, packed.padded_pods // 2, n // 2, 2 * (n // 2)), None, None,
              n // 2)]
    del snap, packed, arrays
    csnap = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0, **_CONS)
    cpacked = pack_snapshot(csnap, pod_block=8192, node_block=128)
    cons = pack_constraints(csnap, csnap.pending_pods(), cpacked.padded_pods, cpacked.node_names,
                            cpacked.padded_nodes, max_aa_terms=256, max_spread=256)
    cpacked = dataclasses.replace(cpacked, constraints=cons)
    cpods, meta, state = constraints_to_device(cons, device)
    masks = round_blocked_masks(augment_round_state(state, meta), meta, soft_spread=cons.n_spread_soft > 0,
                                soft_pa=cons.n_ppa_terms > 0, hard_pa=cons.n_pa_terms > 0)
    carrays = to_device(cpacked, device)
    cons_pod = {k: cpods[k][:8192].contiguous() for k in choose_mod.CONSTRAINT_POD_KEYS}
    cases.append(("constrained_block_round0", _block(carrays, 0, 8192, 0, cpacked.padded_nodes), cons_pod, masks, 0))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=ROOT")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_choose_trees: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    roots = dict(t.split("=", 1) for t in args.trees)
    print(card(), flush=True)
    trees = {}
    for name, root in roots.items():
        mod = load_tree(name, root)
        _, seconds, log = mod.build_library()
        trees[name] = mod
        print(json.dumps({"tree": name, "root": root, "build_seconds": seconds, "ptxas": ptxas_resources(log)}),
              flush=True)

    device = torch.device("cuda")
    w = PROFILES["throughput"].weights()
    for case, a, cons_pod, masks, off in _cases(device):
        if cons_pod is None:
            want = choose_mod.choose_block_plain(*a, w, 1, node_offset=off)
        else:
            want = choose_mod.choose_block_constrained_plain(*a, cons_pod, masks, w, 1, node_offset=off)
        words = choose_mod.pack_node_words(*a[13:18])
        calls = {}
        for name, mod in trees.items():
            if cons_pod is None:
                calls[name] = lambda mod=mod: mod.choose_block(*a, w, 1, node_offset=off, node_words=words)  # noqa: B023
            else:
                calls[name] = lambda mod=mod: mod.choose_block_constrained(  # noqa: B023
                    *a, cons_pod, masks, w, 1, node_offset=off, node_words=words)
        equal = {}
        for name, fn in calls.items():
            got = fn()
            equal[name] = (torch.equal(got[1], want[1]) and torch.equal(got[0][got[1]], want[0][want[1]])
                           and torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)))
        runs = {name: [] for name in trees}
        for r in range(args.rounds):
            for name in list(trees) if r % 2 == 0 else list(trees)[::-1]:
                runs[name].append(time_cuda(calls[name], args.reps))
        print(json.dumps({
            "case": case, "B": int(a[0].shape[0]), "N": int(a[10].shape[0]), "node_offset": off, "equal": equal,
            "ms": {k: statistics.median(v) for k, v in runs.items()}, "runs": runs,
        }), flush=True)
        if not all(equal.values()):
            print(f"bench_choose_trees: a tree disagrees with the plain version on {case}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
