"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from tpu_scheduler_torch/csrc/ (one nvcc call per
source, started together: choose.cu holds the choose kernels, bisect.cu the
bisection kernels) and, for each main path:

* unconstrained — holds the kernel bit for bit against its plain torch
  version on the card (word boundaries at vocabulary widths 31, 32 and 33,
  wide vocabularies, ties, a jitter that is not a power of two, the
  flagship block), times it beside the per-cycle cost of checking the
  bitmaps and packing the node words, holds a mid-size cycle on the card against the same
  cycle on the CPU, then runs the flagship unconstrained cycle (100k
  pending pods × 10k nodes × 20k bound, seed 0, ``throughput`` profile,
  pod_block 8192, max_rounds 64) through ``CudaBackend.schedule`` and checks
  its invariants;
* constrained — the same for the constrained kernel and the flagship
  constrained cycle: the same cluster with anti-affinity, hard and soft
  topology spread, positive and preferred pod affinity and extended
  resources at 10 % each, packed with ``pack_constraints`` (bench.py's
  constrained row at its on-chip shape).  The kernel is held where its
  per-tile live-column lists could go wrong (tiles without an active pod,
  lists at the full width, −0.0 preferred products, a dense mid-cycle
  state) and timed at the shapes the cycles launch, the late sharded round
  included, with each shape's live-column histogram;
* sharded — the dp × tp cycle (``parallel/sharded.ShardedBackend``) on
  virtual shards of the one card (``make_mesh([cuda:0] * k, tp)``): the
  per-shard choose with ``node_offset`` (kernel #2b) held against its plain
  version and, merged over the node slices, against the unsplit launch; the
  mid and constrained-row cycles held against ``CudaBackend``; the flagship
  on (2, 2) and the constrained flagship on (1, 2), timed, held against the
  unsharded cycles;
* topology — kernels #1 and #2 with the gang co-placement term held bit
  for bit against their plain versions (the flagship block at round 0 and
  mid-cycle, tiles mixing gangless and several gangs, ties the term makes,
  term magnitudes from 1e-3 to 1e9, constrained rounds), timed with and
  without the term; bench.py's topology row at its CPU shape (8,192 ×
  512), unconstrained and with the constrained row's fractions, on the
  card against the CPU; then the topology flagship — bench.py's
  ``topology_row`` at its on-chip shape (100,000 pending pods × 8,192
  nodes in slices of 4 and racks of 16, ~35 % of draws a gang of 4-8,
  seed 0, ``throughput``) — through ``CudaBackend.schedule``, three cycles
  on fresh copies of the cluster (upload-cache misses) and three on one
  (hits), with its gang quality against the topology-blind solve and a
  profiler breakdown;
* bisection — the experiments ``tpu_scheduler_torch/experiments/
  bench_kernel_parts.py`` (kernel #4, every variant) and
  ``bench_wide_kernel.py`` (kernel #3) at their full shape, and each kernel
  held bit for bit against its plain version.

Each phase prints one JSON line; any failure exits non-zero.  The last
line is the device summary.  Exits 1 without a result when CUDA is not
available.
"""

from __future__ import annotations

import dataclasses
import json
import random
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

import tpu_scheduler_torch.backends.cuda as cuda_backend_mod
import tpu_scheduler_torch.ops.assign as assign_mod
import tpu_scheduler_torch.ops.bisect as bisect_mod
import tpu_scheduler_torch.ops.choose as choose_mod
import tpu_scheduler_torch.parallel.sharded as sharded_mod
from tpu_scheduler_torch.backends.cuda import CudaBackend
from tpu_scheduler_torch.convert import constraints_to_device, to_device, topology_to_device
from tpu_scheduler_torch.core.snapshot import ClusterSnapshot
from tpu_scheduler_torch.models.profiles import PROFILES
from tpu_scheduler_torch.ops.assign import assign_cycle, split_device_arrays
from tpu_scheduler_torch.ops.choose import (
    CONSTRAINT_POD_KEYS,
    NODE_WORD_KEYS,
    POD_BITMAP_KEYS,
    check_pod_bitmaps,
    choose_block,
    choose_block_constrained,
    choose_block_constrained_plain,
    choose_block_plain,
    constrained_node_operands,
    constrained_pod_operands,
    pack_node_words,
    tile_live_mask,
)
from tpu_scheduler_torch.ops.constraints import augment_round_state, pack_constraints, round_blocked_masks
from tpu_scheduler_torch.experiments import bench_kernel_parts, bench_wide_kernel, ptxas_resources, time_cuda
from tpu_scheduler_torch.experiments import card as nvidia_smi
from tpu_scheduler_torch.ops.pack import pack_snapshot
from tpu_scheduler_torch.parallel.mesh import make_mesh
from tpu_scheduler_torch.parallel.sharded import ShardedBackend
from tpu_scheduler_torch.testing import make_node, make_pod, synth_cluster
from tpu_scheduler_torch.topology.locality import _add_rows as locality_add_rows
from tpu_scheduler_torch.topology.locality import gang_placement_stats, gang_topology_term, pack_topology
from tpu_scheduler_torch.topology.model import DEFAULT_LEVEL_KEYS, TopologyModel

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

POD_KEYS = (
    "pod_req", "pod_sel", "pod_sel_count", "pod_ntol", "pod_aff", "pod_has_aff", "pod_pref_w", "pod_ntol_soft",
)
NODE_KEYS = (
    "node_avail", "node_alloc", "node_valid", "node_labels", "node_taints", "node_aff", "node_pref",
    "node_taints_soft",
)
# bench.py's constrained row: every inter-pod constraint family and extended
# resources on 10 % of the pending pods each.
CONS_FRACTIONS = dict(
    anti_affinity_fraction=0.1, spread_fraction=0.1, schedule_anyway_fraction=0.1, pod_affinity_fraction=0.1,
    preferred_pod_affinity_fraction=0.1, extended_fraction=0.1,
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def block_args(arrays: dict, lo: int, hi: int) -> list:
    """choose_block's positional tensors for pod rows [lo, hi) against all
    nodes (ranks = row index, active = pod_valid)."""
    d = arrays["pod_req"].device
    pods = [arrays[k][lo:hi].contiguous() for k in POD_KEYS]
    active = arrays["pod_valid"][lo:hi].contiguous()
    ranks = torch.arange(lo, hi, dtype=torch.int32, device=d)
    return pods + [active, ranks] + [arrays[k] for k in NODE_KEYS]


def compare(name: str, args: list, weights, salt: int = 0) -> tuple[dict, tuple]:
    """Kernel vs plain on the same CUDA tensors: has and choice equal
    everywhere, best equal bit for bit where has holds."""
    kc, kh, kb = choose_block(*args, weights, salt)
    pc, ph, pb = choose_block_plain(*args, weights, salt)
    torch.cuda.synchronize()
    same_has = torch.equal(kh, ph)
    equal = same_has and torch.equal(kc, pc) and torch.equal(kb[kh].view(torch.int32), pb[kh].view(torch.int32))
    err = float((kb[kh] - pb[kh]).abs().max()) if same_has and bool(kh.any()) else 0.0
    rec = {
        "phase": "kernel_vs_plain", "case": name, "B": int(args[0].shape[0]), "N": int(args[10].shape[0]),
        "R": int(args[0].shape[1]), "widths": [int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)], "salt": salt,
        "jitter": float(np.asarray(weights, dtype=np.float32)[2]), "feasible_pods": int(ph.sum()),
        "equal": bool(equal), "max_abs_err": err,
    }
    emit(rec)
    if not equal:
        raise SystemExit(f"kernel and plain disagree on case {name}")
    return rec, (kc, kh, kb)


def random_wide_case(device, seed: int = 5) -> list:
    """Vocabulary widths above 255 (the JAX kernel's banding limit) with R = 5."""
    rng = np.random.default_rng(seed)
    b, n, r = 300, 777, 5
    widths = {"L": 264, "T": 300, "A": 260, "A2": 8, "Ts": 8}
    req = rng.integers(0, 400, size=(b, r), dtype=np.int32)
    alloc = rng.integers(200, 4000, size=(n, r), dtype=np.int32)
    avail = (alloc - rng.integers(0, 200, size=(n, r))).astype(np.int32)
    sel = np.zeros((b, widths["L"]), np.float32)
    for i in range(b):
        sel[i, rng.choice(widths["L"], size=rng.integers(0, 3), replace=False)] = 1.0
    labels = (rng.random((n, widths["L"])) < 0.8).astype(np.float32)
    ntol = (rng.random((b, widths["T"])) < 0.05).astype(np.float32)
    taints = (rng.random((n, widths["T"])) < 0.01).astype(np.float32)
    aff = (rng.random((b, widths["A"])) < 0.02).astype(np.float32)
    has_aff = (rng.random(b) < 0.5).astype(np.float32)
    node_aff = (rng.random((n, widths["A"])) < 0.5).astype(np.float32)
    pref_w = (rng.integers(0, 101, size=(b, widths["A2"])) * (rng.random((b, widths["A2"])) < 0.3)).astype(np.float32)
    node_pref = (rng.random((n, widths["A2"])) < 0.5).astype(np.float32)
    ntol_soft = (rng.random((b, widths["Ts"])) < 0.5).astype(np.float32)
    taints_soft = (rng.random((n, widths["Ts"])) < 0.2).astype(np.float32)
    active = rng.random(b) < 0.9
    valid = rng.random(n) < 0.95
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [
        t(req), t(sel), t(sel.sum(1).astype(np.float32)), t(ntol), t(aff), t(has_aff), t(pref_w), t(ntol_soft),
        t(active), torch.arange(b, dtype=torch.int32, device=device),
        t(avail), t(alloc), t(valid), t(labels), t(taints), t(node_aff), t(node_pref), t(taints_soft),
    ]


def word_boundary_case(device, width: int, seed: int = 6) -> list:
    """All five vocabularies ``width`` wide (31, 32, 33: one word, one full
    word, a second word with one column), R = 2, random 0/1 bitmaps dense
    enough that the last columns decide predicates: the last column is set
    for a third of the pods and half of the nodes."""
    rng = np.random.default_rng(seed + width)
    b, n = 77, 1031
    bits = lambda shape, p: (rng.random(shape) < p).astype(np.float32)  # noqa: E731
    sel = bits((b, width), 0.04)
    sel[::3, -1] = 1.0
    labels = bits((n, width), 0.7)
    labels[:, -1] = bits((n,), 0.5)
    ntol, taints = bits((b, width), 0.1), bits((n, width), 0.02)
    ntol[1::4, -1] = 1.0
    taints[::7, -1] = 1.0
    aff, node_aff = bits((b, width), 0.1), bits((n, width), 0.3)
    aff[2::5, :] = 0.0
    aff[2::5, -1] = 1.0
    pref_w = (rng.integers(1, 101, size=(b, width)) * bits((b, width), 0.2)).astype(np.float32)
    pref_w[::2, -1] = 77.0
    ntol_soft, taints_soft = bits((b, width), 0.5), bits((n, width), 0.3)
    alloc = rng.integers(2000, 64000, size=(n, 2), dtype=np.int32)
    avail = (alloc - rng.integers(0, 1500, size=(n, 2))).astype(np.int32)
    req = rng.integers(0, 1000, size=(b, 2), dtype=np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [
        t(req), t(sel), t(sel.sum(1).astype(np.float32)), t(ntol), t(aff), t((rng.random(b) < 0.6).astype(np.float32)),
        t(pref_w), t(ntol_soft), t(rng.random(b) < 0.9), torch.arange(b, dtype=torch.int32, device=device),
        t(avail), t(alloc), t(rng.random(n) < 0.95), t(labels), t(taints), t(node_aff), t(bits((n, width), 0.5)),
        t(taints_soft),
    ]


def tie_case(device, b: int = 13) -> list:
    """Every node identical except two with equal, larger free capacity at
    indices 261 and 300 (different threads and warps): with zero jitter
    every pod must pick 261."""
    n = 700
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    req = torch.tensor([[100, 131072]] * b, dtype=torch.int32, device=device)
    alloc = torch.tensor([[8000, 16777216]] * n, dtype=torch.int32, device=device)
    avail = torch.tensor([[2000, 4194304]] * n, dtype=torch.int32, device=device)
    avail[261] = avail[300] = torch.tensor([6000, 12582912], dtype=torch.int32, device=device)
    return [
        req, z(b, 8), z(b), z(b, 8), z(b, 8), z(b), z(b, 8), z(b, 8),
        torch.ones(b, dtype=torch.bool, device=device), torch.arange(b, dtype=torch.int32, device=device),
        avail, alloc, torch.ones(n, dtype=torch.bool, device=device), z(n, 8), z(n, 8), z(n, 8), z(n, 8), z(n, 8),
    ]


def choose_bound_ms(
    b: int, n: int, r: int, widths: list[int], cons_widths: list[int] | None = None, cons_products: int = 0,
    active: int | None = None, topo_rows: int | None = None,
) -> tuple[float, str]:
    """Least time for one choose launch: the bytes it must move over HBM
    bandwidth, and the operations it does over the float32 peak (integer
    ops counted at that rate too).  An inactive pod's outputs are fixed, so
    only the ``active`` pods of the ``b`` (all of them when None) need their
    rows read (req, features, selc, has_aff, rank and, constrained, the
    constraint rows) and their pair work; every pod's active flag is read
    and every output written; each node row is read once.  Per (active pod,
    node) pair: r fit compares, 2 ops per dot-product term, and 45 scalar ops (3
    predicate compares + 2 masks, 4 integer ops and 2 conversions for
    used_after, 2 divisions, 8 for LR/BA, 3 to combine, 2 + 2 for the soft
    terms, 6 for the hash, 3 to quantize, 3 for the jitter term, 1
    conversion, 1 argmax compare, 3 selects).

    The constrained kernel adds its four [B, W]·[W, N] operand pairs
    (``cons_widths``) to the bytes, 8 scalar ops per pair (blocked compare
    and mask, 2 for the soft-spread term, 3 for the level term, 1 for the
    preferred term, 1 select), and 2 ops for each product whose two factors
    are both non-zero (``cons_products``, :func:`constrained_products`):
    every other product is ±0 and adds nothing, so this run's data needs
    only those.

    The gang term (``topo_rows`` given: Σ over the 8-pod tiles of the
    distinct T rows their active pods read) adds each active pod's gang id
    and those rows, ``topo_rows`` · N · 4 bytes, and one add per active
    pair."""
    a = b if active is None else active
    w = sum(widths)
    wc = sum(cons_widths or [])
    nbytes = a * (4 * r + 4 * w + 12 + 4 * wc) + b * (1 + 4 + 1 + 4) + n * (8 * r + 1 + 4 * w + 4 * wc)
    ops = a * n * (r + 2 * w + 45) + (a * n * 8 + 2 * cons_products if cons_widths else 0)
    if topo_rows is not None:
        nbytes += 4 * a + 4 * n * topo_rows
        ops += a * n
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def constrained_products(pod_ops, node_ops, active: torch.Tensor) -> int:
    """Σ over the four constrained operand pairs and their columns k of
    (active pods with pod[p, k] ≠ 0) · (nodes with node[k, n] ≠ 0): the
    products with both factors non-zero."""
    return sum(
        int((((po != 0) & active[:, None]).sum(0) * (no != 0).sum(1)).sum()) for po, no in zip(pod_ops, node_ops)
    )


def live_histogram(pod_ops, active: torch.Tensor) -> dict:
    """What the constrained kernel walks: per 8-pod tile with an active pod,
    its live-list length (``tile_live_mask``) summed over the four operands
    — mean, p99 and max — beside the full width."""
    per_tile = sum(tile_live_mask(po, active).sum(dim=1) for po in pod_ops)
    tiles = per_tile.shape[0]
    has_active = tile_live_mask(active[:, None], active)[:, 0]  # the tiles with an active pod
    x = per_tile[has_active].double().cpu()
    return {"tiles": tiles, "active_tiles": int(x.shape[0]), "mean": float(x.mean()) if len(x) else 0.0,
            "p99": float(torch.quantile(x, 0.99)) if len(x) else 0.0, "max": int(x.max()) if len(x) else 0,
            "full_width": sum(int(po.shape[1]) for po in pod_ops)}


def check_bindings(packed, assigned: np.ndarray) -> None:
    """No node oversubscribed in any resource column, and every binding
    feasible under the plain predicates on the packed tensors."""
    placed = np.flatnonzero(assigned >= 0)
    nodes = assigned[placed]
    committed = np.zeros(packed.node_avail.shape, dtype=np.int64)
    np.add.at(committed, nodes, packed.pod_req[placed].astype(np.int64))
    remaining = packed.node_avail.astype(np.int64) - committed
    if not (remaining >= np.minimum(packed.node_avail, 0)).all():
        raise SystemExit("flagship: a node is oversubscribed")
    fit = (packed.pod_req[placed] <= packed.node_avail[nodes]).all(1)
    sel = (packed.pod_sel[placed] * packed.node_labels[nodes]).sum(1) == packed.pod_sel_count[placed]
    taint = (packed.pod_ntol[placed] * packed.node_taints[nodes]).sum(1) == 0
    aff = ((packed.pod_aff[placed] * packed.node_aff[nodes]).sum(1) > 0) | (packed.pod_has_aff[placed] == 0)
    if not (fit & sel & taint & aff & packed.node_valid[nodes]).all():
        raise SystemExit("flagship: a binding violates a predicate")


def flagship_breakdown(backend, packed, profile) -> dict:
    """Where one warm flagship cycle's time goes: the device time of each
    kernel (torch.profiler over the cycle), the device's idle share of the
    cycle's wall time, and the host-clock split of upload / auction /
    result fetch / binding construction (``schedule`` minus ``assign``)."""
    wall_ms, rows = profiled(lambda: backend.schedule(packed, profile))
    busy_ms = sum(r[1] for r in rows)
    choose_ms = sum(r[1] for r in rows if "choose_kernel" in r[0])
    copy_ms = sum(r[1] for r in rows if "Memcpy" in r[0] or "memcpy" in r[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nodes, pods = split_device_arrays(to_device(packed, backend.device))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    assigned, rounds, _, acc_round, rank_of = assign_cycle(
        nodes, pods, profile.weights(), max_rounds=profile.max_rounds, block=profile.pod_block
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.stack([assigned, acc_round, rank_of, torch.full_like(assigned, rounds)]).cpu()
    t3 = time.perf_counter()
    backend.assign(packed, profile)  # the whole cycle minus binding construction
    t4 = time.perf_counter()
    backend.schedule(packed, profile)
    t5 = time.perf_counter()
    return {
        "phase": "flagship_breakdown", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else "not measured",
        "choose_kernel_ms": choose_ms, "copy_ms": copy_ms, "other_device_ms": busy_ms - choose_ms - copy_ms,
        "top_device": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:8]],
        "host_upload_ms": (t1 - t0) * 1e3, "host_auction_ms": (t2 - t1) * 1e3, "host_fetch_ms": (t3 - t2) * 1e3,
        "host_bindings_ms": ((t5 - t4) - (t4 - t3)) * 1e3,
    }


def with_constraints(snap, packed):
    """(packed with its ConstraintSet attached, pack_constraints seconds) at
    bench.py's constrained-row budgets."""
    t0 = time.perf_counter()
    cons = pack_constraints(
        snap, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes,
        max_aa_terms=256, max_spread=256,
    )
    return dataclasses.replace(packed, constraints=cons), time.perf_counter() - t0


def constrained_round(packed, device, seed: int | None = None, kill_pa: bool = False):
    """(device arrays with the constraint pod bitmaps, round masks) for one
    constrained round: the cycle-start state, or — with ``seed`` — a state
    randomised from it (domain marks, counts; ``kill_pa``: every positive-
    affinity term globally inactive, the bootstrap-gate round)."""
    cons = packed.constraints
    cpods, meta, state = constraints_to_device(cons, device)
    if seed is not None:
        rng = np.random.default_rng(seed)
        host = {}
        for k, v in cons.state_arrays().items():
            if k.endswith(("_cnt", "counts")):
                host[k] = rng.integers(0, 4, v.shape).astype(np.float32)
            else:
                host[k] = (rng.random(v.shape) < (0.0 if kill_pa and k.startswith("pa_") else 0.1)).astype(np.float32)
        host["sp_counts"] *= cons.sp_uses_dom
        state = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    flags = dict(soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0, hard_pa=cons.n_pa_terms > 0)
    masks = round_blocked_masks(augment_round_state(state, meta), meta, **flags)
    arrays = to_device(packed, device)
    arrays.update(cpods)
    return arrays, masks


def compare_constrained(name: str, args: list, cons_pod: dict, masks: dict, weights, salt: int = 0, **extra) -> tuple:
    """Constrained kernel vs its plain version on the same CUDA tensors:
    has and choice equal everywhere, best equal bit for bit where has
    holds.  ``extra`` joins the printed record."""
    kc, kh, kb = choose_block_constrained(*args, cons_pod, masks, weights, salt)
    pc, ph, pb = choose_block_constrained_plain(*args, cons_pod, masks, weights, salt)
    torch.cuda.synchronize()
    same_has = torch.equal(kh, ph)
    equal = same_has and torch.equal(kc, pc) and torch.equal(kb[kh].view(torch.int32), pb[kh].view(torch.int32))
    err = float((kb[kh] - pb[kh]).abs().max()) if same_has and bool(kh.any()) else 0.0
    cons_widths = [int(t.shape[1]) for t in constrained_pod_operands(cons_pod, masks)]
    fc, fh, _ = choose_block_plain(*args, weights, salt)  # the same block without the constraints
    rec = {
        "phase": "kernel_vs_plain_constrained", "case": name, "B": int(args[0].shape[0]), "N": int(args[10].shape[0]),
        "R": int(args[0].shape[1]), "widths": [int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)],
        "cons_widths": cons_widths, "salt": salt, "feasible_pods": int(kh.sum()),
        "changed_by_constraints": int(((fh != ph) | (fh & (fc != pc))).sum()),
        "equal": bool(equal), "max_abs_err": err, **extra,
    }
    emit(rec)
    if not equal:
        raise SystemExit(f"constrained kernel and plain disagree on case {name}")
    return rec, (kc, kh, kb)


def block_cons(arrays: dict, lo: int, hi: int) -> dict:
    return {k: arrays[k][lo:hi].contiguous() for k in CONSTRAINT_POD_KEYS}


def budget_widths_case(device, seed: int = 11, k: int = 256) -> tuple:
    """Every constraint width at its budget (by default 256 anti-affinity,
    spread, soft spread, positive and preferred terms: a 1024-wide blocked
    band and a ~58 KB pod tile plus 7 KB of live lists, over the 48 KB
    default) with R = 3, random operands; ``k`` terms per family."""
    rng = np.random.default_rng(seed)
    b, n = 300, 777
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    bits = lambda shape, p: t((rng.random(shape) < p).astype(np.float32))  # noqa: E731
    ints = lambda shape, lo, hi: t(rng.integers(lo, hi, shape).astype(np.float32))  # noqa: E731
    req = rng.integers(0, 400, size=(b, 3), dtype=np.int32)
    alloc = rng.integers(200, 4000, size=(n, 3), dtype=np.int32)
    avail = (alloc - rng.integers(0, 200, size=(n, 3))).astype(np.int32)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    args = [
        t(req), z(b, 8), z(b), z(b, 8), z(b, 8), z(b), ints((b, 8), 0, 3), bits((b, 8), 0.5),
        t(rng.random(b) < 0.95), torch.arange(b, dtype=torch.int32, device=device),
        t(avail), t(alloc), t(rng.random(n) < 0.97), z(n, 8), z(n, 8), z(n, 8), bits((n, 8), 0.5), bits((n, 8), 0.3),
    ]
    cons_pod = {
        "pod_aa_carries": bits((b, k), 0.01), "pod_aa_matched": bits((b, k), 0.01),
        "pod_sp_declares": bits((b, k), 0.01), "pod_pa_declares": bits((b, k), 0.005),
        "pod_pa_matched": bits((b, k), 0.01), "pod_sps_declares": bits((b, k), 0.02),
        "pod_ppa_w": t((rng.integers(-100, 101, (b, k)) * (rng.random((b, k)) < 0.03)).astype(np.float32)),
    }
    masks = {
        "aa_m_node": bits((k, n), 0.05), "aa_c_node": bits((k, n), 0.05), "sp_node": bits((k, n), 0.05),
        "sp_level_node": ints((k, n), 0, 4), "pa_unmatched_node": bits((k, n), 0.3), "pa_inactive": bits((k,), 0.3),
        "sp_penalty_node": ints((k, n), 0, 6), "ppa_cnt_node": ints((k, n), 0, 20),
    }
    return args, cons_pod, masks


def mixed_activity_case(device, seed: int = 12) -> tuple:
    """budget_widths_case at 64 terms per family where every third 8-pod
    tile has no active pod and the next has one active pod whose constraint
    columns are disjoint from every column its inactive neighbours carry
    (it carries, per family, the first column none of them does)."""
    args, cons_pod, masks = budget_widths_case(device, seed, k=64)
    b = int(args[0].shape[0])
    active = args[8].clone()
    for t in range(-(-b // 8)):
        lo, hi = 8 * t, min(b, 8 * t + 8)
        if t % 3 == 0:
            active[lo:hi] = False
        elif t % 3 == 1 and hi - lo > 1:
            keep = lo + t % (hi - lo)
            active[lo:hi] = False
            active[keep] = True
            others = [i for i in range(lo, hi) if i != keep]
            for key, v in cons_pod.items():
                free = (v[others] == 0).all(dim=0)
                v[keep] *= free
                v[keep, int(torch.nonzero(free)[0])] = -7.0 if key == "pod_ppa_w" else 1.0
    args[8] = active
    return args, cons_pod, masks


def dense_union_case(device, seed: int = 13) -> tuple:
    """Every pod carries several terms of every family (24 per family, pod
    densities 0.4–0.5) and tile 0's pods share every column out among them,
    so the live lists reach the full width; the node band is sparse enough
    that pods stay feasible."""
    args, cons_pod, masks = budget_widths_case(device, seed, k=24)
    rng = np.random.default_rng(seed)
    b, n, k = int(args[0].shape[0]), int(args[10].shape[0]), 24
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    bits = lambda shape, p: t((rng.random(shape) < p).astype(np.float32))  # noqa: E731
    cover = t(np.arange(k)[None, :] % 8 == np.arange(8)[:, None])  # pod i of tile 0: the columns ≡ i mod 8
    for key in cons_pod:
        v = bits((b, k), 0.4) if key != "pod_ppa_w" else t(
            (rng.integers(-100, 101, (b, k)) * (rng.random((b, k)) < 0.5)).astype(np.float32))
        if key == "pod_pa_matched":
            v[:8] = 0.0  # keep tile 0's positive-affinity columns ungated
        elif key == "pod_ppa_w":
            v[:8] = torch.where(cover & (v[:8] == 0), 9.0, v[:8])
        else:
            v[:8] = torch.maximum(v[:8], cover.float())
        cons_pod[key] = v
    args[8][:8] = True
    for key in ("aa_m_node", "aa_c_node", "sp_node"):
        masks[key] = bits((k, n), 0.005)
    masks["pa_unmatched_node"] = bits((k, n), 0.01)
    return args, cons_pod, masks


def negative_ppa_case(device, seed: int = 14) -> tuple:
    """Preferred weights negative wherever present, against counts that are
    zero on ~90 % of (term, node) cells: many preferred products are −0.0."""
    args, cons_pod, masks = budget_widths_case(device, seed, k=64)
    rng = np.random.default_rng(seed)
    b, n, k = int(args[0].shape[0]), int(args[10].shape[0]), 64
    cons_pod["pod_ppa_w"] = torch.from_numpy(
        (-rng.integers(1, 101, (b, k)) * (rng.random((b, k)) < 0.1)).astype(np.float32)).to(device)
    masks["ppa_cnt_node"] = torch.from_numpy(
        (rng.integers(1, 20, (k, n)) * (rng.random((k, n)) < 0.1)).astype(np.float32)).to(device)
    return args, cons_pod, masks


def constrained_timing(phase: str, args: list, cons_pod: dict, masks: dict, weights, node_offset: int,
                       reps: int, plain_reps: int, smi: str, salt: int = 1, **extra) -> dict:
    """Kernel #2 at one launch shape: kernel and plain timed and their last
    outputs held bit for bit (``timed_and_held``), the bound from this run's
    inputs (active pods, products with both factors non-zero) and the
    live-column histogram of the tiles.  The kernel gets the node words
    built once, as the cycles pass them."""
    words = pack_node_words(*args[13:18])
    ms, plain_ms, err = timed_and_held(
        phase, lambda: choose_block_constrained(
            *args, cons_pod, masks, weights, salt, node_offset=node_offset, node_words=words),
        lambda: choose_block_constrained_plain(*args, cons_pod, masks, weights, salt, node_offset=node_offset),
        reps=reps, plain_reps=plain_reps,
    )
    pod_ops, node_ops = constrained_pod_operands(cons_pod, masks), constrained_node_operands(masks)
    active = args[8]
    b, n, n_active = int(args[0].shape[0]), int(args[10].shape[0]), int(active.sum())
    cons_widths = [int(t.shape[1]) for t in pod_ops]
    products = constrained_products(pod_ops, node_ops, active)
    bound_ms, bound_by = choose_bound_ms(
        b, n, int(args[0].shape[1]), [int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)], cons_widths, products,
        n_active,
    )
    rec = {"phase": phase, "B": b, "N": n, "active_pods": n_active, "node_offset": node_offset, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "cons_widths": cons_widths,
           "cons_products": products, "live_columns": live_histogram(pod_ops, active), "equal": True,
           "max_abs_err": err, **extra, "nvidia_smi": smi}
    emit(rec)
    return rec


def late_round_launch(packed, profile, mesh, share: float = 0.03) -> dict:
    """One ``ShardedBackend(mesh).schedule`` of a constrained cycle with
    kernel #2b's launches on the shard at ``node_offset`` > 0 recorded: the
    operands (cloned), weights, salt and round of the first round whose
    active pods are at most ``share`` of the rows — else of the last round —
    and that shard's active count in every round."""
    orig, counts, kept = sharded_mod.choose_block_constrained, [], {}

    def record(*args, node_offset=0, node_words=None):
        if node_offset > 0:
            counts.append(int(args[8].sum()))
            if not kept.get("late"):
                kept.update(
                    args=[a.clone() for a in args[:18]], cons_pod={k: v.clone() for k, v in args[18].items()},
                    masks={k: v.clone() for k, v in args[19].items()}, weights=args[20], salt=args[21],
                    node_offset=node_offset, round=len(counts) - 1, late=counts[-1] <= share * args[8].shape[0],
                )
        return orig(*args, node_offset=node_offset, node_words=node_words)

    sharded_mod.choose_block_constrained = record
    try:
        ShardedBackend(mesh).schedule(packed, profile)
    finally:
        sharded_mod.choose_block_constrained = orig
    return dict(kept, active_by_round=counts)


def ppa_partial_sum_bound(cons_pod: dict, masks: dict) -> float:
    """Upper bound on |every partial sum| of the preferred inter-pod dot
    products of one block: max over pods of Σ_t |w_t| · max_n cnt[t, n].
    The float32 sums are exact (order-free) while it stays below 2^24."""
    if "ppa_cnt_node" not in masks:
        return 0.0
    return float((cons_pod["pod_ppa_w"].abs() @ masks["ppa_cnt_node"].abs().amax(dim=1)).max())


def cycle_ppa_partial_sum_bound(packed, assigned: np.ndarray) -> float:
    """ppa_partial_sum_bound for the preferred-term counts at the END of a
    cycle (they only grow during it, so this bounds every round): the
    cycle-start counts plus every pod placed this cycle, in its node's
    domain or, where the node lacks the term's key, on the node itself."""
    c = packed.constraints
    placed = np.flatnonzero(assigned >= 0)
    nodes = assigned[placed]
    nd = c.node_dom_c[nodes]  # [placed, D]
    matched = c.pod_ppa_matched[placed]  # [placed, Tp]
    dom_cnt = c.ppa_dom_cnt + (matched.T @ nd) * c.ppa_uses_dom  # [Tp, D]
    node_cnt = c.ppa_node_cnt.T.copy()  # [N, Tp]
    np.add.at(node_cnt, nodes, matched * ((nd @ c.ppa_uses_dom.T) == 0))
    cnt_node = dom_cnt @ c.node_dom_c.T + node_cnt.T  # [Tp, N]
    return float((np.abs(c.pod_ppa_w) @ np.abs(cnt_node).max(axis=1)).max())


def check_anti_affinity(packed, assigned: np.ndarray) -> int:
    """Anti-affinity from the ConstraintSet tensors: no pod placed this
    cycle shares a (term, cell) with a carrier (if it matches the term) or a
    matched pod (if it carries the term) — another pod placed this cycle or
    a placed pod of the cycle-start state.  A cell is the node's coarse
    domain under the term's key, else the node itself.  Returns the number
    of terms checked."""
    c = packed.constraints
    t, d = c.term_uses_dom.shape
    n = c.node_dom_c.shape[0]
    placed = np.flatnonzero(assigned >= 0)
    nd = c.node_dom_c[assigned[placed]]  # [placed, D]
    has = nd @ c.term_uses_dom.T  # [placed, T]
    cc = nd @ (c.term_uses_dom * np.arange(d, dtype=np.float32)[None, :]).T
    cell = np.where(has > 0, cc, d + assigned[placed][:, None]).astype(np.int64)  # [placed, T]
    flat = (np.arange(t)[None, :] * (d + n) + cell).ravel()
    carr = c.pod_aa_carries[placed].ravel() > 0
    matc = c.pod_aa_matched[placed].ravel() > 0
    size = t * (d + n)
    n_c = np.bincount(flat[carr], minlength=size)
    n_m = np.bincount(flat[matc], minlength=size)
    n_cm = np.bincount(flat[carr & matc], minlength=size)
    init_m = np.concatenate([c.aa_dom_m, c.aa_node_m], axis=1).ravel() > 0
    init_c = np.concatenate([c.aa_dom_c, c.aa_node_c], axis=1).ravel() > 0
    bad = (n_c * n_m - n_cm > 0) | ((n_c > 0) & init_m) | ((n_m > 0) & init_c)
    if bad.any():
        raise SystemExit(f"constrained flagship: {int(bad.sum())} anti-affinity cells hold a conflicting pair")
    return int(((n_c > 0) | (n_m > 0)).reshape(t, -1).any(axis=1).sum())


def constrained_breakdown(backend, packed, profile) -> dict:
    """Where one warm constrained flagship cycle's time goes: device time of
    each kernel (torch.profiler), the device's idle share of the cycle, and
    the host-clock split of upload / auction, with the constraint engine's
    mask build and filter + commit timed inside the auction by
    synchronising wrappers (a separate, instrumented cycle)."""
    wall_ms, rows = profiled(lambda: backend.schedule(packed, profile))
    busy_ms = sum(r[1] for r in rows)
    cons_choose_ms = sum(r[1] for r in rows if "choose_kernel<true," in r[0])
    copy_ms = sum(r[1] for r in rows if "Memcpy" in r[0] or "memcpy" in r[0])

    spent = {"masks": 0.0, "filter_commit": 0.0}

    def timed(key, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out

        return wrapped

    originals = (assign_mod.round_blocked_masks, assign_mod.constraint_filter, assign_mod.constraint_commit)
    assign_mod.round_blocked_masks = timed("masks", originals[0])
    assign_mod.constraint_filter = timed("filter_commit", originals[1])
    assign_mod.constraint_commit = timed("filter_commit", originals[2])
    try:
        cons = packed.constraints
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, pods = split_device_arrays(to_device(packed, backend.device))
        cpods, cmeta, cstate = constraints_to_device(cons, backend.device)
        pods.update(cpods)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        assign_cycle(
            nodes, pods, profile.weights(), max_rounds=profile.max_rounds, block=profile.pod_block, cmeta=cmeta,
            cstate=cstate, soft_spread=cons.n_spread_soft > 0, soft_pa=cons.n_ppa_terms > 0,
            hard_pa=cons.n_pa_terms > 0,
        )
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        assign_mod.round_blocked_masks, assign_mod.constraint_filter, assign_mod.constraint_commit = originals
    return {
        "phase": "constrained_breakdown", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else "not measured",
        "choose_constrained_kernel_ms": cons_choose_ms, "copy_ms": copy_ms,
        "other_device_ms": busy_ms - cons_choose_ms - copy_ms,
        "top_device": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:10]],
        "host_upload_ms": (t1 - t0) * 1e3, "host_auction_ms": (t2 - t1) * 1e3,
        "host_masks_ms": spent["masks"] * 1e3, "host_filter_commit_ms": spent["filter_commit"] * 1e3,
    }


def build_kernels() -> tuple[dict, dict]:
    """Build every kernel library at once, one nvcc per source started
    together; prints each library's ptxas resource lines.  Returns
    ({library: build seconds}, ptxas_resources of every kernel)."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {"choose": pool.submit(choose_mod.build_library), "bisect": pool.submit(bisect_mod.build_bisect_library)}
        built = {name: f.result() for name, f in futures.items()}
    resources = {}
    for name, (_, _, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                print(f"# ptxas ({name}): {line.strip()}", flush=True)
        resources.update(ptxas_resources(log))
    return {name: seconds for name, (_, seconds, _) in built.items()}, resources


def profiled(fn) -> tuple[float, list]:
    """(wall ms, [(name, device ms, count)] sorted by device time) of one
    call of ``fn`` ending in a synchronise, under torch.profiler: device-side
    events only (kernels, copies) — host aten rows also carry their
    kernels' time."""
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, rows


def device_split(wall_ms: float, rows: list, kernel_tag: str) -> dict:
    busy_ms = sum(r[1] for r in rows)
    kernel_ms = sum(r[1] for r in rows if kernel_tag in r[0])
    copy_ms = sum(r[1] for r in rows if "Memcpy" in r[0] or "memcpy" in r[0])
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else "not measured",
        "kernel_ms": kernel_ms, "copy_ms": copy_ms, "other_device_ms": busy_ms - kernel_ms - copy_ms,
        "top_device": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:8]],
    }


def node_slice(args: list, lo: int, hi: int) -> list:
    """choose_block's positional tensors with the node tensors (positions
    10-17) cut to rows [lo, hi)."""
    return args[:10] + [t[lo:hi] for t in args[10:]]


def mask_slice(masks: dict, lo: int, hi: int) -> dict:
    """A round's node masks cut to columns [lo, hi) (``pa_inactive`` is
    per term and stays whole)."""
    return {k: v if k == "pa_inactive" else v[:, lo:hi].contiguous() for k, v in masks.items()}


def outputs_equal(k_out: tuple, p_out: tuple) -> tuple[bool, float]:
    """(equal, max_abs_err) of two (choice, has, best) triples: has equal,
    choice equal where has holds, best bit-equal as int32 everywhere (-inf
    included).  The error is the largest |best| difference over the
    feasible pods (inf when has differs)."""
    (kc, kh, kb), (pc, ph, pb) = k_out, p_out
    torch.cuda.synchronize()
    if not torch.equal(kh, ph):
        return False, float("inf")
    equal = torch.equal(kc[kh], pc[kh]) and torch.equal(kb.view(torch.int32), pb.view(torch.int32))
    return bool(equal), float((kb[kh] - pb[kh]).abs().max()) if bool(kh.any()) else 0.0


def sharded_offsets(name: str, args: list, weights, salt: int, cons_pod=None, masks=None) -> dict:
    """Kernel #2b on one block: for tp = 2 and 4, each node slice's launch
    with its global base as ``node_offset`` is bit-equal to its plain
    version, and the slices merged on (score desc, index asc) are
    bit-equal to the unsplit launch (choice, has, best)."""

    def launch(fn, a, off, lm):
        if cons_pod is None:
            return fn(*a, weights, salt, node_offset=off)
        return fn(*a, cons_pod, lm, weights, salt, node_offset=off)

    kernel = choose_block if cons_pod is None else choose_block_constrained
    plain = choose_block_plain if cons_pod is None else choose_block_constrained_plain
    n = int(args[10].shape[0])
    whole = launch(kernel, args, 0, masks)
    rec = {"phase": "sharded_offsets", "kernel": kernel.__name__, "case": name, "B": int(args[0].shape[0]), "N": n,
           "salt": salt, "slices": {}, "max_abs_err": 0.0}
    for tp in (2, 4):
        step = -(-n // tp)
        best = choice = None
        slices_equal = True
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            sl, lm = node_slice(args, lo, hi), (mask_slice(masks, lo, hi) if masks is not None else None)
            kc, kh, kb = launch(kernel, sl, lo, lm)
            equal, err = outputs_equal((kc, kh, kb), launch(plain, sl, lo, lm))
            slices_equal &= equal
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            kc = kc + lo
            if best is None:
                best, choice = kb, kc
            else:
                take = (kb > best) | ((kb == best) & (kc < choice))
                best, choice = torch.where(take, kb, best), torch.where(take, kc, choice)
        merged_equal, _ = outputs_equal((choice, torch.isfinite(best), best), whole)
        rec["slices"][str(tp)] = {"slice_vs_plain_equal": bool(slices_equal), "merged_vs_unsplit_equal": merged_equal,
                                  "max_offset": (tp - 1) * step}
        if not (slices_equal and merged_equal):
            emit(rec)
            raise SystemExit(f"kernel #2b ({name}, tp={tp}): a slice or the merge disagrees")
    rec["feasible_pods"] = int(whole[1].sum())
    emit(rec)
    return rec


def timed_and_held(phase: str, kernel_fn, plain_fn, reps: int, plain_reps: int) -> tuple[float, float, float]:
    """(kernel ms, plain ms, max_abs_err): both timed by ``time_cuda``, and
    the last output of each held against the other by ``outputs_equal``;
    exits on a mismatch."""
    last = {}
    ms = time_cuda(lambda: last.__setitem__("kernel", kernel_fn()), reps=reps)
    plain_ms = time_cuda(lambda: last.__setitem__("plain", plain_fn()), reps=plain_reps)
    equal, err = outputs_equal(last["kernel"], last["plain"])
    if not equal:
        raise SystemExit(f"{phase}: the kernel and its plain version disagree at the timed shape")
    return ms, plain_ms, err


def cuda_mesh(k: int, tp: int):
    """A (k / tp, tp) mesh of virtual shards on card 0."""
    return make_mesh([torch.device("cuda", 0)] * k, tp=tp)


def sharded_cycles(phase: str, packed, profile, mesh, reps: int, reference) -> tuple[dict, list]:
    """``reps + 1`` cycles of ``ShardedBackend(mesh).schedule`` (the first
    a warm-up), each timed on the host clock ending in a synchronise; the
    launch counts of the run; every result held against ``reference``
    (assigned, rounds)."""
    backend = ShardedBackend(mesh)
    torch.cuda.reset_peak_memory_stats()
    choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
    times, results = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(backend.schedule(packed, profile))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, launches_c = choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED
    equal = all(np.array_equal(r.assigned, reference.assigned) and r.rounds == reference.rounds for r in results)
    res = results[-1]
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    per_cycle = (launches + launches_c) / (reps + 1)
    rec = {
        "phase": phase, "mesh": [dp, tp], "pods": packed.num_pods, "nodes": packed.num_nodes,
        "rounds": res.rounds, "bound": len(res.bindings), "unschedulable": len(res.unschedulable),
        "equal_to_unsharded": bool(equal), "warmup_seconds": times[0], "seconds": times[1:],
        "median_seconds": statistics.median(times[1:]) if reps else None,
        "choose_launches": launches, "choose_constrained_launches": launches_c,
        "launches_per_cycle": per_cycle, "expected_launches_per_cycle": dp * tp * res.rounds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    if not equal or per_cycle != dp * tp * res.rounds:
        emit(rec)
        raise SystemExit(f"{phase}: the sharded cycle disagrees with the unsharded one, or launched "
                         f"{per_cycle} kernels per cycle against dp·tp·rounds = {dp * tp * res.rounds}")
    check_bindings(packed, res.assigned)
    return rec, results


def bisect_bound_ms(p: int, n: int, k: int, variant: int, node_nnz: int) -> tuple[float, str]:
    """Least time for one bisection launch (kernel #4 variants 0-3, #3 as
    variant 4): each input byte read once and the [P] int32 output written
    once over HBM bandwidth; and the operations over the float32 peak
    (integer ops at that rate too), per pair — v0: 2 fit compares, 1 and,
    1 conversion, 1 argmax compare; v1: + compare, select, add; v2: + 4
    integer ops, 2 conversions, 2 divisions, 8 for LR/BA, 2 adds; v3: + 6
    for the hash, 1 conversion, 1 division, 1 add; the wide kernel: the v3
    terms less the fit add, plus 3 for the mask and 1 select — and 2 ops per
    pod for each NON-ZERO node entry of the count operand (``node_nnz``; a
    zero adds nothing), none for v0."""
    per_pair = {0: 5, 1: 8, 2: 26, 3: 35, 4: 38}[variant]
    pod_bytes = 8 * 4 + k * 4 if variant == 4 else 2 * 4 + k * 4 + 4 + 4
    nbytes = p * pod_bytes + n * (8 * 4 + k * 4) + p * 4
    ops = p * n * per_pair + (2 * p * node_nnz if variant >= 1 else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tie_parts_inputs(p: int, n: int, device) -> tuple:
    """Kernel #4's inputs with capacities drawn from {0, 500, 1000} and the
    first 5 nodes full: v0's score ties across most nodes, and the first
    fitting node varies with the request."""
    req, sel, selc, ranks, info, labels = bench_kernel_parts.make_inputs(p, n, seed=7)
    g = torch.Generator().manual_seed(7)
    info[0:4] = torch.randint(0, 3, (4, n), generator=g, dtype=torch.int32) * 500
    info[0:2, :5] = 0
    return tuple(t.to(device) for t in (req, sel, selc, ranks, info, labels))


def bisect_phase(device) -> list[dict]:
    """Kernels #3 and #4: the experiments' entry points at full size with
    the launch counts set to 0 just before and read just after; then each
    kernel against its plain version, bit for bit, on a remainder case (P,
    N multiples of no tile), a tie-heavy case and the full size, with the
    plain version's time and the bound."""
    bisect_mod.LAUNCHES_PARTS = [0, 0, 0, 0]
    bisect_mod.LAUNCHES_WIDE = 0
    parts = bench_kernel_parts.measure(device, reps=10)
    wide = bench_wide_kernel.measure(device, reps=10)
    launches = list(bisect_mod.LAUNCHES_PARTS) + [bisect_mod.LAUNCHES_WIDE]
    emit({"phase": "bisect_experiments", "parts": parts, "wide": wide, "launches": launches})
    if min(launches) == 0:
        raise SystemExit(f"bisection experiments: a kernel never launched ({launches})")

    full_parts = bench_kernel_parts.make_inputs(device=device)
    full_wide = bench_wide_kernel.make_inputs(device=device)
    cases = {
        "remainder_1003x2049": (bench_kernel_parts.make_inputs(1003, 2049, seed=3, device=device),
                                bench_wide_kernel.make_inputs(1003, 2049, seed=3, device=device)),
        "ties_v0_4099x3001": (tie_parts_inputs(4099, 3001, device), None),
        "full": (full_parts, full_wide),
    }
    records = []
    for variant in range(5):
        name = NAMES_BISECT[variant]
        equal, max_abs_err = {}, 0.0
        for case, (pi, wi) in cases.items():
            if variant == 4:
                if wi is None:
                    continue
                k_out, p_out = bisect_mod.choose_wide(*wi), bisect_mod.choose_wide_plain(*wi)
            else:
                if case.startswith("ties") and variant not in (0, 2):
                    continue
                k_out = bisect_mod.choose_parts(*pi, variant=variant)
                p_out = bisect_mod.choose_parts_plain(*pi, variant=variant)
            torch.cuda.synchronize()
            equal[case] = bool(torch.equal(k_out, p_out))
            max_abs_err = max(max_abs_err, float((k_out - p_out).abs().max()))
        if variant == 4:
            p, n, k = full_wide[0].shape[0], full_wide[2].shape[1], full_wide[1].shape[1]
            nnz = int((full_wide[3] != 0).sum())
            kernel_ms = wide["ms"]
            plain_ms = time_cuda(lambda: bisect_mod.choose_wide_plain(*full_wide), reps=2)
        else:
            p, n, k = full_parts[0].shape[0], full_parts[4].shape[1], full_parts[1].shape[1]
            nnz = int((full_parts[5] != 0).sum())
            kernel_ms = parts[variant]["ms"]
            plain_ms = time_cuda(lambda: bisect_mod.choose_parts_plain(*full_parts, variant=variant), reps=2)  # noqa: B023
        bound_ms, bound_by = bisect_bound_ms(p, n, k, variant, nnz)
        rec = {"phase": "bisect_kernels", "kernel": name, "P": p, "N": n, "equal": equal, "max_abs_err": max_abs_err,
               "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "gpair_per_s": p * n / kernel_ms / 1e6,
               "launches": launches[variant]}
        emit(rec)
        records.append(rec)
        if not all(equal.values()):
            raise SystemExit(f"bisection kernel {name}: kernel and plain disagree on {equal}")
    return records


# ---- the topology (gang-locality) path -------------------------------------

SLICE_KEY, RACK_KEY = DEFAULT_LEVEL_KEYS[0][1], DEFAULT_LEVEL_KEYS[1][1]


def topology_cluster(pods: int, nodes: int, seed: int) -> dict:
    """bench.py's ``topology_row`` cluster, built inline as bench.py does:
    ``nodes`` nodes of 32 CPU / 128 Gi, slices of 4 nodes and racks of 16;
    35 % of draws open a gang of 4-8 members at 2 CPU / 4 Gi, the others are
    single pods at 1 CPU / 2 Gi.  Packed with ``pack_snapshot``'s defaults
    and the TopologySet attached; the set-up seconds split into synth +
    pack and ``pack_topology``."""
    t0 = time.perf_counter()
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
    t1 = time.perf_counter()
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    t2 = time.perf_counter()
    return {"packed": dataclasses.replace(packed, topology=topo), "compiled": compiled, "gangs": gangs,
            "synth_pack_seconds": t1 - t0, "pack_topology_seconds": t2 - t1}


def with_topology(snap, packed):
    """``packed`` with the TopologySet of ``snap``'s nodes attached, after
    labelling node i into slice i // 4 and rack i // 16 (for clusters from
    ``synth_cluster``, which carry no topology labels)."""
    for i, node in enumerate(snap.nodes):
        node.metadata.labels.update({SLICE_KEY: f"s{i // 4}", RACK_KEY: f"r{i // 16}"})
    compiled = TopologyModel.detect(snap.nodes).compile(snap.nodes)
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    return dataclasses.replace(packed, topology=topo)


def round_term(packed, device, weights, placed_share: float = 0.0, seed: int = 0) -> tuple[dict, torch.Tensor]:
    """(device arrays with ``pod_gang_id``, the [G+1, N] gang term) of one
    round: the cycle-start state, or ``placed_share`` of the gangs with a
    random member count placed on random nodes (a mid-cycle state: the
    anchor term is live)."""
    arrays = to_device(packed, device)
    tpods, tmeta, tstate = topology_to_device(packed.topology, device)
    arrays.update(tpods)
    gang_nodes = tstate["gang_nodes"]
    if placed_share:
        rng = np.random.default_rng(seed)
        g1, n1 = gang_nodes.shape
        rows = np.flatnonzero(rng.random(g1) < placed_share)
        rows = rows[rows > 0]
        cols = rng.integers(0, n1 - 1, rows.shape[0])
        gang_nodes[torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)] = torch.from_numpy(
            rng.integers(1, 5, rows.shape[0]).astype(np.float32)).to(device)
    t = gang_topology_term(gang_nodes, tmeta, arrays["node_avail"], arrays["pod_gang_id"], arrays["pod_req"],
                           arrays["pod_valid"], np.float32(weights[6]))
    return arrays, t


def term_card_vs_cpu(packed, device, weights) -> dict:
    """The gang term on the card against the same term on the CPU, bit for
    bit: the topology flagship's cycle-start state and a mid-cycle one; and
    the per-gang demand's pod-order adds (``locality._add_rows``) on
    inexact float32 values, where another order would round differently."""
    rec = {"phase": "topology_term_card_vs_cpu"}
    for name, share in (("round0", 0.0), ("mid_cycle", 0.5)):
        t_card = round_term(packed, device, weights, placed_share=share, seed=31)[1]
        t_cpu = round_term(packed, torch.device("cpu"), weights, placed_share=share, seed=31)[1]
        rec[name] = torch.equal(t_card.cpu().view(torch.int32), t_cpu.view(torch.int32))
        del t_card, t_cpu
    rng = np.random.default_rng(5)
    idx = np.sort(rng.integers(0, 4096, 200_000))
    vals = (rng.random((200_000, 2)) * 1e7).astype(np.float32)
    on = {d: locality_add_rows(torch.zeros((4096, 2), device=d), torch.from_numpy(idx).to(d),
                               torch.from_numpy(vals).to(d)).cpu() for d in (device, torch.device("cpu"))}
    rec["pod_order_adds"] = torch.equal(on[device].view(torch.int32), on[torch.device("cpu")].view(torch.int32))
    emit(rec)
    if not all(v for k, v in rec.items() if k != "phase"):
        raise SystemExit(f"the gang term differs between the card and the CPU: {rec}")
    return rec


def random_topo(b: int, n: int, device, seed: int, gangs: int = 6, zero_share: float = 0.3, scale=None):
    """(gang ids [b] int32, T [gangs+1, n] float32) drawn from ``seed``: ids
    in 1..gangs, ``zero_share`` of them 0; T normal rows times ``scale[g]``
    (default 100), row 0 zero."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(1, gangs + 1, b).astype(np.int32)
    gid[rng.random(b) < zero_share] = 0
    t = rng.normal(size=(gangs + 1, n)).astype(np.float32)
    t *= np.asarray(scale if scale is not None else [100.0] * (gangs + 1), dtype=np.float32)[:, None]
    t[0] = 0.0
    return torch.from_numpy(gid).to(device), torch.from_numpy(t).to(device)


def tile_rows(gid: torch.Tensor, active: torch.Tensor, pods: int = 8) -> int:
    """Σ over the 8-pod tiles of the distinct gang ids among the tile's
    active pods: the T rows the topology instances read."""
    b = gid.shape[0]
    tiles = -(-b // pods)
    g = torch.full((tiles * pods,), -1, dtype=torch.int64, device=gid.device)
    g[:b] = torch.where(active, gid.long(), -1)
    s = g.view(tiles, pods).sort(dim=1).values
    return int(((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum() + (s[:, 0] >= 0).sum())


def compare_topology(name: str, args: list, weights, salt: int, topo, cons_pod=None, masks=None, **extra) -> dict:
    """Kernel #1 (or #2, given ``cons_pod``/``masks``) with the gang term
    against its plain version on the same CUDA tensors, held by
    ``outputs_equal``; also how many pods the term moved."""
    if cons_pod is None:
        k_out = choose_block(*args, weights, salt, topo=topo)
        p_out = choose_block_plain(*args, weights, salt, topo=topo)
        blind = choose_block_plain(*args, weights, salt)
    else:
        k_out = choose_block_constrained(*args, cons_pod, masks, weights, salt, topo=topo)
        p_out = choose_block_constrained_plain(*args, cons_pod, masks, weights, salt, topo=topo)
        blind = choose_block_constrained_plain(*args, cons_pod, masks, weights, salt)
    equal, err = outputs_equal(k_out, p_out)
    rec = {"phase": "kernel_vs_plain_topology", "case": name, "family": "constrained" if cons_pod else "plain",
           "B": int(args[0].shape[0]), "N": int(args[10].shape[0]), "gang_rows": int(topo[1].shape[0]),
           "salt": salt, "feasible_pods": int(p_out[1].sum()),
           "moved_by_term": int((p_out[1] & (p_out[0] != blind[0])).sum()), "equal": equal, "max_abs_err": err,
           **extra}
    emit(rec)
    if not equal:
        raise SystemExit(f"topology kernel and plain disagree on case {name}")
    return rec


def topology_tie_case(device, b: int = 45) -> tuple[list, tuple]:
    """Every node identical (no jitter: every base score ties); gang g's T
    row holds its maximum 100 at two nodes of one slice, 4·g + 1 and
    4·g + 3, and at node 640 + g (another warp); each gang's pods must pick
    4·g + 1, the gangless pods node 0."""
    n = 700
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    req = torch.tensor([[100, 131072]] * b, dtype=torch.int32, device=device)
    alloc = torch.tensor([[8000, 16777216]] * n, dtype=torch.int32, device=device)
    avail = torch.tensor([[2000, 4194304]] * n, dtype=torch.int32, device=device)
    args = [
        req, z(b, 8), z(b), z(b, 8), z(b, 8), z(b), z(b, 8), z(b, 8),
        torch.ones(b, dtype=torch.bool, device=device), torch.arange(b, dtype=torch.int32, device=device),
        avail, alloc, torch.ones(n, dtype=torch.bool, device=device), z(n, 8), z(n, 8), z(n, 8), z(n, 8), z(n, 8),
    ]
    gangs = 5
    t = z(gangs + 1, n)
    for g in range(1, gangs + 1):
        t[g, [4 * g + 1, 4 * g + 3, 640 + g]] = 100.0
    gid = torch.arange(b, dtype=torch.int32, device=device) % (gangs + 1)
    return args, (gid, t)


def topology_bound_ms(args: list, topo, cons_widths=None, cons_products: int = 0) -> tuple[float, str]:
    """``choose_bound_ms`` with the gang term: its ids and the distinct T
    rows each 8-pod tile reads (``tile_rows``) in the bytes, one add per
    active pair in the operations."""
    active = args[8]
    return choose_bound_ms(
        int(args[0].shape[0]), int(args[10].shape[0]), int(args[0].shape[1]),
        [int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)], cons_widths, cons_products, int(active.sum()),
        topo_rows=tile_rows(topo[0], active),
    )


def fresh_copy(packed):
    """``packed`` with every host array copied (the TopologySet's too): to
    the backends' upload cache a new cluster."""
    t = packed.topology
    topo = dataclasses.replace(t, pod_gang_id=t.pod_gang_id.copy(), meta={k: v.copy() for k, v in t.meta.items()})
    return dataclasses.replace(packed, topology=topo, **{k: v.copy() for k, v in packed.device_arrays().items()})


def gang_quality(result, compiled, gangs: dict) -> dict:
    """bench.py's topology quality verdict: gangs admitted whole, the worst
    pairwise placement distance among them, and the cross-rack ones."""
    node_of = dict(result.bindings)
    dists = compiled.level_distances()
    worst, cross, admitted = 0.0, 0, 0
    for _g, members in sorted(gangs.items()):
        placed = [node_of.get(m) for m in members]
        if any(n is None for n in placed):
            continue
        admitted += 1
        stats = gang_placement_stats([compiled.domains_of(n) for n in placed], dists)
        worst = max(worst, stats["max_distance"])
        cross += bool(stats["cross_edges"])
    return {"gangs": len(gangs), "admitted_whole": admitted, "worst_gang_distance": worst, "cross_rack_gangs": cross}


def topology_cycles(backend, packed, profile, reps: int, fresh: bool) -> tuple[list, list, int]:
    """``reps`` timed cycles (host clock ending in a synchronise) through
    ``backend.schedule``; with ``fresh`` each on a new copy of ``packed``
    (made outside the clock: every upload misses the cache), else all on
    ``packed`` itself.  Returns (seconds, results, upload-cache miss bytes)."""
    cuda_backend_mod.UPLOAD_BYTES = 0
    times, results = [], []
    for _ in range(reps):
        p = fresh_copy(packed) if fresh else packed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(backend.schedule(p, profile))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del p
    return times, results, cuda_backend_mod.UPLOAD_BYTES


def topology_breakdown(backend, packed, profile) -> dict:
    """Where one warm topology flagship cycle's time goes: device time by
    kernel (torch.profiler) split into the choose kernels, the gang term's
    matrix products (cuBLAS), copies and the rest (the term's and the
    auction's elementwise ops); the idle share; and the host clock of the
    term's construction per cycle, timed by a synchronising wrapper in a
    separate cycle."""
    wall_ms, rows = profiled(lambda: backend.schedule(packed, profile))
    split = device_split(wall_ms, rows, "choose_kernel")
    gemm_ms = sum(r[1] for r in rows if any(s in r[0].lower() for s in ("gemm", "xmma", "cutlass")))
    spent = [0.0, 0]
    original = assign_mod.gang_topology_term

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = original(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return out

    assign_mod.gang_topology_term = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend.schedule(packed, profile)
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t0) * 1e3
    finally:
        assign_mod.gang_topology_term = original
    return dict(split, phase="topology_breakdown", term_matmul_ms=gemm_ms,
                term_elementwise_and_other_ms=split["other_device_ms"] - gemm_ms,
                instrumented_cycle_ms=cycle_ms, host_term_ms=spent[0] * 1e3, term_calls=spent[1])


NAMES_BISECT = ("bisect_parts_v0", "bisect_parts_v1", "bisect_parts_v2", "bisect_parts_v3", "bisect_wide")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s, resources = build_kernels()
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_seconds": build_s,
        "build_wall_seconds": time.perf_counter() - t0, "ptxas": resources,
    })

    # Flagship cluster on the host (set-up, not timed as a cycle).
    t0 = time.perf_counter()
    snap = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0)
    flagship = pack_snapshot(snap, pod_block=8192, node_block=128)
    emit({
        "phase": "flagship_setup", "synth_pack_seconds": time.perf_counter() - t0,
        "padded": [flagship.padded_pods, flagship.padded_nodes], "R": flagship.node_avail.shape[1],
        "widths": [flagship.pod_sel.shape[1], flagship.pod_ntol.shape[1], flagship.pod_aff.shape[1],
                   flagship.pod_pref_w.shape[1], flagship.pod_ntol_soft.shape[1]],
    })
    throughput = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
    w_thr = throughput.weights()
    w_default = PROFILES["default"].weights()

    # Phase 2: kernel vs plain on the card.
    small = pack_snapshot(
        synth_cluster(
            n_nodes=1001, n_pending=37, n_bound=1500, seed=3, tainted_fraction=0.2, cordoned_fraction=0.05,
            node_affinity_fraction=0.3, soft_taint_fraction=0.3, preferred_affinity_fraction=0.3,
            extended_fraction=0.3,
        ),
        pod_block=1, node_block=1,
    )
    a_small = to_device(small, device)
    recs = [compare("remainders_R3", block_args(a_small, 0, small.padded_pods), w_default)[0]]
    zeroed = dict(a_small, node_avail=torch.zeros_like(a_small["node_avail"]))
    rec, (_, kh, _) = compare("all_infeasible", block_args(zeroed, 0, small.padded_pods), w_default)
    recs.append(rec)
    inactive = dict(a_small, pod_valid=torch.zeros_like(a_small["pod_valid"]))
    rec2, (_, kh2, _) = compare("inactive_pods", block_args(inactive, 0, small.padded_pods), w_default)
    recs.append(rec2)
    if bool(kh.any()) or bool(kh2.any()):
        raise SystemExit("infeasible or inactive pods reported a feasible node")
    no_jitter = PROFILES["default"].with_(spread_jitter=0.0).weights()
    for b in (13, 45):  # two tiles and six, the last with a remainder
        rec, (kc, kh, _) = compare("exact_two_node_tie" if b == 13 else f"exact_two_node_tie_{b}", tie_case(device, b),
                                   no_jitter)
        recs.append(rec)
        if not bool(kh.all()) or not bool((kc == 261).all()):
            raise SystemExit("tie did not resolve to the lower node index")
    recs.append(compare("salt_7_throughput", block_args(a_small, 0, small.padded_pods), w_thr, salt=7)[0])
    # A jitter that is not a power of two: the quantization divides.
    w_div = PROFILES["throughput"].with_(spread_jitter=0.3).weights()
    recs.append(compare("jitter_0.3_division", block_args(a_small, 0, small.padded_pods), w_div, salt=5)[0])
    recs.append(compare("wide_vocab_R5", random_wide_case(device), w_thr, salt=3)[0])
    for width in (31, 32, 33):  # the word boundaries
        recs.append(compare(f"word_boundary_{width}", word_boundary_case(device, width), w_thr, salt=width)[0])
    a_flag = to_device(flagship, device)
    flag_args = block_args(a_flag, 0, 8192)
    recs.append(compare("flagship_block", flag_args, w_thr, salt=1)[0])
    recs.append(compare("flagship_block_jitter_0.3", flag_args, w_div, salt=1)[0])
    max_abs_err = max(r["max_abs_err"] for r in recs)

    # What assign_cycle adds once per cycle for the kernels: the pod
    # bitmaps checked to be 0/1, the node bitmaps checked and packed.
    flag_words = pack_node_words(*flag_args[13:18])
    check_ms = time_cuda(lambda: check_pod_bitmaps(*(a_flag[k] for k in POD_BITMAP_KEYS)), reps=10)
    words_ms = time_cuda(lambda: pack_node_words(*(a_flag[k] for k in NODE_WORD_KEYS)), reps=10)
    kernel_ms = time_cuda(lambda: choose_block(*flag_args, w_thr, 1, node_words=flag_words), reps=20)
    plain_ms = time_cuda(lambda: choose_block_plain(*flag_args, w_thr, 1), reps=3)
    widths = [int(flag_args[i].shape[1]) for i in (1, 3, 4, 6, 7)]
    bound_ms, bound_by = choose_bound_ms(8192, flagship.padded_nodes, flagship.node_avail.shape[1], widths,
                                         active=int(flag_args[8].sum()))
    emit({"phase": "choose_timing", "B": 8192, "N": flagship.padded_nodes, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms,
          "check_pod_bitmaps_ms_per_cycle": check_ms, "pack_node_words_ms_per_cycle": words_ms, "nvidia_smi": smi})

    # Kernel #2b: the flagship block split into tp node slices.
    offsets_rec = sharded_offsets("flagship_block", flag_args, w_thr, 1)
    # ... and timed at the (2, 2) mesh's shard shape: half the pod rows
    # against the second node column.
    p_local, n_local = flagship.padded_pods // 2, flagship.padded_nodes // 2
    shard_args = node_slice(block_args(a_flag, 0, p_local), n_local, 2 * n_local)
    shard_words = pack_node_words(*shard_args[13:18])
    shard_ms, shard_plain_ms, shard_err = timed_and_held(
        "choose_sharded_timing",
        lambda: choose_block(*shard_args, w_thr, 1, node_offset=n_local, node_words=shard_words),
        lambda: choose_block_plain(*shard_args, w_thr, 1, node_offset=n_local), reps=10, plain_reps=2,
    )
    shard_max_abs_err = max(offsets_rec["max_abs_err"], shard_err)
    shard_bound_ms, shard_bound_by = choose_bound_ms(p_local, n_local, flagship.node_avail.shape[1], widths,
                                                     active=int(shard_args[8].sum()))
    emit({"phase": "choose_sharded_timing", "B": p_local, "N": n_local, "node_offset": n_local, "ms": shard_ms,
          "plain_ms": shard_plain_ms, "bound_ms": shard_bound_ms,
          "bound_by": shard_bound_by, "share_of_bound": shard_bound_ms / shard_ms, "equal": True,
          "max_abs_err": shard_err, "nvidia_smi": smi})
    del a_flag, flag_args, shard_args
    torch.cuda.empty_cache()

    # Phase 3: a mid cluster with every unconstrained feature, card vs CPU.
    mid_snap = synth_cluster(
        n_nodes=2000, n_pending=20_000, n_bound=4000, seed=1, selector_fraction=0.2, tainted_fraction=0.2,
        cordoned_fraction=0.05, node_affinity_fraction=0.2, soft_taint_fraction=0.2,
        preferred_affinity_fraction=0.3, extended_fraction=0.1,
    )
    mid = pack_snapshot(mid_snap, pod_block=4096, node_block=128)
    mid_profile = PROFILES["throughput"].with_(pod_block=4096, max_rounds=64)
    choose_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    r_gpu = CudaBackend("cuda").schedule(mid, mid_profile)
    gpu_s = time.perf_counter() - t0
    mid_launches = choose_mod.LAUNCHES
    t0 = time.perf_counter()
    r_cpu = CudaBackend(device="cpu").schedule(mid, mid_profile)
    cpu_s = time.perf_counter() - t0
    parity = (
        np.array_equal(r_gpu.assigned, r_cpu.assigned) and r_gpu.rounds == r_cpu.rounds
        and np.array_equal(r_gpu.stats["acc_round"], r_cpu.stats["acc_round"])
        and np.array_equal(r_gpu.stats["rank"], r_cpu.stats["rank"])
    )
    emit({"phase": "cycle_parity", "pods": mid.num_pods, "nodes": mid.num_nodes, "R": mid.node_avail.shape[1],
          "rounds": r_gpu.rounds, "bound": len(r_gpu.bindings), "choose_launches": mid_launches,
          "gpu_seconds": gpu_s, "cpu_seconds": cpu_s, "equal": bool(parity)})
    if not parity or mid_launches == 0:
        raise SystemExit("mid-cluster cycle: card and CPU disagree, or the kernel never ran")
    check_bindings(mid, r_gpu.assigned)
    for k, tp in ((2, 2), (4, 2)):  # (1, 2) and (2, 2) meshes of virtual shards
        rec, _ = sharded_cycles("sharded_cycle_parity", mid, mid_profile, cuda_mesh(k, tp), 0, r_gpu)
        emit(rec)

    # Phase 4: the flagship cycle through the user's entry point.
    backend = CudaBackend()
    torch.cuda.reset_peak_memory_stats()
    choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
    cuda_backend_mod.UPLOAD_BYTES = 0
    times, results = [], []
    # One warm-up (it fills the upload cache), then three timed cycles on
    # the same cluster (cache hits).
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(backend.schedule(flagship, throughput))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, stray = choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED
    res = results[-1]
    if any(not np.array_equal(r.assigned, res.assigned) for r in results):
        raise SystemExit("flagship: cycles are not deterministic")
    check_bindings(flagship, res.assigned)
    if launches == 0 or launches % 4 or stray:
        raise SystemExit(f"flagship: choose launches {launches}, constrained {stray} (expected a multiple of 4, 0)")
    emit({"phase": "flagship", "pods": flagship.num_pods, "nodes": flagship.num_nodes, "bound_pods": 20_000,
          "warmup_seconds": times[0], "median_seconds": statistics.median(times[1:]), "seconds": times[1:],
          "rounds": res.rounds, "bound": len(res.bindings), "unschedulable": len(res.unschedulable),
          "choose_launches_per_cycle": launches // 4, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "upload_bytes_4_cycles": cuda_backend_mod.UPLOAD_BYTES, "invariants": "ok", "nvidia_smi": smi})

    emit(flagship_breakdown(backend, flagship, throughput))

    # The sharded flagship: the user's entry point on a (2, 2) mesh.
    mesh22 = cuda_mesh(4, 2)
    rec, _ = sharded_cycles("sharded_flagship", flagship, throughput, mesh22, 3, res)
    sharded_launches = rec["choose_launches"]
    emit(dict(rec, bound_pods=20_000, unsharded_median_seconds=statistics.median(times[1:]), nvidia_smi=smi))
    wall_ms, rows = profiled(lambda: ShardedBackend(mesh22).schedule(flagship, throughput))
    emit(dict(device_split(wall_ms, rows, "choose_kernel"), phase="sharded_flagship_breakdown", mesh=[2, 2]))
    del flagship, snap, results, res
    torch.cuda.empty_cache()

    # ---- the constrained main path ---------------------------------------
    t0 = time.perf_counter()
    csnap = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0, **CONS_FRACTIONS)
    cflag = pack_snapshot(csnap, pod_block=8192, node_block=128)
    synth_pack_s = time.perf_counter() - t0
    cflag, pack_cons_s = with_constraints(csnap, cflag)
    c = cflag.constraints
    cpod_bytes = sum(v.nbytes for v in c.pod_arrays().values())
    emit({
        "phase": "constrained_setup", "synth_pack_seconds": synth_pack_s, "pack_constraints_seconds": pack_cons_s,
        "padded": [cflag.padded_pods, cflag.padded_nodes], "R": cflag.node_avail.shape[1],
        "terms": {"Tc": c.n_terms, "Ta": c.n_pa_terms, "Tp": c.n_ppa_terms, "S": c.n_spread, "Ss": c.n_spread_soft},
        "padded_widths": {k: int(v.shape[1]) for k, v in c.pod_arrays().items()},
        "domains": [int(c.node_dom_c.shape[1]), int(c.sp_dom_sel.shape[1])], "pod_bitmap_bytes": cpod_bytes,
    })

    # Constrained kernel vs plain on the card.
    csmall_snap = synth_cluster(
        n_nodes=1001, n_pending=37, n_bound=1500, seed=3, tainted_fraction=0.2, node_affinity_fraction=0.3,
        soft_taint_fraction=0.3, preferred_affinity_fraction=0.3, **{k: 0.3 for k in CONS_FRACTIONS},
    )
    csmall, _ = with_constraints(csmall_snap, pack_snapshot(csmall_snap, pod_block=1, node_block=1))
    crecs = []
    b_small = csmall.padded_pods
    arrays, masks = constrained_round(csmall, device, seed=3)
    crecs.append(compare_constrained("remainders_R3_all_families", block_args(arrays, 0, b_small),
                                     block_cons(arrays, 0, b_small), masks, w_thr, salt=2)[0])
    hard_snap = synth_cluster(n_nodes=1001, n_pending=61, n_bound=1500, seed=4, anti_affinity_fraction=0.4,
                              spread_fraction=0.4)
    hard, _ = with_constraints(hard_snap, pack_snapshot(hard_snap, pod_block=1, node_block=1))
    arrays, masks = constrained_round(hard, device, seed=4)
    if set(masks) & {"pa_unmatched_node", "sp_penalty_node", "ppa_cnt_node"}:
        raise SystemExit("hard-only case carries a soft or positive-affinity feature")
    crecs.append(compare_constrained("hard_only", block_args(arrays, 0, hard.padded_pods),
                                     block_cons(arrays, 0, hard.padded_pods), masks, w_default)[0])
    arrays, masks = constrained_round(csmall, device, seed=5, kill_pa=True)
    if not bool((masks["pa_inactive"] == 1.0).all()):
        raise SystemExit("bootstrap-gate case: a positive-affinity term is active")
    crecs.append(compare_constrained("bootstrap_gate", block_args(arrays, 0, b_small),
                                     block_cons(arrays, 0, b_small), masks, w_default)[0])
    crecs.append(compare_constrained("budget_widths_256", *budget_widths_case(device), w_thr, salt=9)[0])
    # Where the live-column lists could go wrong: tiles with no active pod,
    # and single active pods whose columns their neighbours do not carry;
    # lists at the full width; preferred products that are −0.0.
    mixed = mixed_activity_case(device)
    crecs.append(compare_constrained("mixed_activity", *mixed, w_thr, salt=4)[0])
    dense = dense_union_case(device)
    dense_hist = live_histogram(constrained_pod_operands(dense[1], dense[2]), dense[0][8])
    crecs.append(compare_constrained("dense_union", *dense, w_thr, salt=6, live_columns=dense_hist)[0])
    if dense_hist["max"] != dense_hist["full_width"]:
        raise SystemExit(f"dense_union: no tile's live lists reach the full width ({dense_hist})")
    crecs.append(compare_constrained("negative_ppa_zero_counts", *negative_ppa_case(device), w_default, salt=8)[0])
    offsets_recs = [sharded_offsets("mixed_activity", mixed[0], w_thr, 4, mixed[1], mixed[2])]
    del mixed, dense
    # A mid-cycle state of the flagship (randomised domain marks and counts):
    # the node operands are dense.
    arrays, masks = constrained_round(cflag, device, seed=21)
    mid_args, mid_cons = block_args(arrays, 0, 8192), block_cons(arrays, 0, 8192)
    crecs.append(compare_constrained("flagship_block_mid_cycle", mid_args, mid_cons, masks, w_thr, salt=17)[0])
    offsets_recs.append(sharded_offsets("flagship_block_mid_cycle", mid_args, w_thr, 17, mid_cons, masks))
    del arrays, masks, mid_args, mid_cons
    arrays, masks = constrained_round(cflag, device)
    cflag_args, cflag_cons = block_args(arrays, 0, 8192), block_cons(arrays, 0, 8192)
    rec, _ = compare_constrained("flagship_block_round0", cflag_args, cflag_cons, masks, w_thr, salt=1)
    crecs.append(rec)
    cons_max_abs_err = max(r["max_abs_err"] for r in crecs)
    offsets_recs.append(sharded_offsets("flagship_block_round0", cflag_args, w_thr, 1, cflag_cons, masks))

    ctiming = constrained_timing("choose_constrained_timing", cflag_args, cflag_cons, masks, w_thr, 0, reps=20,
                                 plain_reps=3, smi=smi, ppa_partial_sum_bound=ppa_partial_sum_bound(cflag_cons, masks))
    del cflag_args, cflag_cons
    # Kernel #2b constrained, timed at the (1, 2) mesh's shard shape: every
    # pod row against the second node column, round-0 masks.
    cn_local = cflag.padded_nodes // 2
    cshard_args = node_slice(block_args(arrays, 0, cflag.padded_pods), cn_local, 2 * cn_local)
    cshard_cons, cshard_masks = block_cons(arrays, 0, cflag.padded_pods), mask_slice(masks, cn_local, 2 * cn_local)
    cshard = constrained_timing("choose_constrained_sharded_timing", cshard_args, cshard_cons, cshard_masks, w_thr,
                                cn_local, reps=5, plain_reps=1, smi=smi)
    del arrays, masks, cshard_args, cshard_cons, cshard_masks
    torch.cuda.empty_cache()

    # bench.py's constrained row at its CPU shape, card vs CPU.  The JAX
    # package's CPU record of that row (PERF_JAX_TPU.md, "Measured (CPU jax
    # path)") reads 18 rounds and 24,445 bound: the port must agree.
    cmid_snap = synth_cluster(n_nodes=2500, n_pending=25_000, n_bound=5000, seed=0, **CONS_FRACTIONS)
    cmid, _ = with_constraints(cmid_snap, pack_snapshot(cmid_snap, pod_block=8192, node_block=128))
    choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
    t0 = time.perf_counter()
    r_gpu = CudaBackend("cuda").schedule(cmid, throughput)
    gpu_s = time.perf_counter() - t0
    cmid_launches = choose_mod.LAUNCHES_CONSTRAINED
    t0 = time.perf_counter()
    r_cpu = CudaBackend(device="cpu").schedule(cmid, throughput)
    cpu_s = time.perf_counter() - t0
    parity = (
        np.array_equal(r_gpu.assigned, r_cpu.assigned) and r_gpu.rounds == r_cpu.rounds
        and np.array_equal(r_gpu.stats["acc_round"], r_cpu.stats["acc_round"])
        and np.array_equal(r_gpu.stats["rank"], r_cpu.stats["rank"])
    )
    jax_record = (r_gpu.rounds, len(r_gpu.bindings)) == (18, 24_445)
    emit({"phase": "constrained_cycle_parity", "pods": cmid.num_pods, "nodes": cmid.num_nodes,
          "R": cmid.node_avail.shape[1], "rounds": r_gpu.rounds, "bound": len(r_gpu.bindings),
          "choose_constrained_launches": cmid_launches, "gpu_seconds": gpu_s, "cpu_seconds": cpu_s,
          "equal": bool(parity), "matches_jax_record": jax_record})
    if not parity or cmid_launches == 0 or not jax_record:
        raise SystemExit("mid constrained cycle: card, CPU and the JAX record disagree, or the kernel never ran")
    check_bindings(cmid, r_gpu.assigned)
    check_anti_affinity(cmid, r_gpu.assigned)
    for k, tp in ((2, 2), (4, 2)):
        rec, results = sharded_cycles("sharded_cycle_parity", cmid, throughput, cuda_mesh(k, tp), 0, r_gpu)
        rec["matches_jax_record"] = (results[-1].rounds, len(results[-1].bindings)) == (18, 24_445)
        emit(rec)
        if not rec["matches_jax_record"]:
            raise SystemExit("sharded constrained row: not the JAX record's 18 rounds and 24,445 bound")
        check_anti_affinity(cmid, results[-1].assigned)

    # The flagship constrained cycle through the user's entry point.
    torch.cuda.reset_peak_memory_stats()
    choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
    cuda_backend_mod.UPLOAD_BYTES = 0
    times, results = [], []
    for _ in range(4):  # one warm-up (fills the upload cache), then three timed cycles (hits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(backend.schedule(cflag, throughput))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    claunches, cstray = choose_mod.LAUNCHES_CONSTRAINED, choose_mod.LAUNCHES
    res = results[-1]
    if any(not np.array_equal(r.assigned, res.assigned) or r.rounds != res.rounds for r in results):
        raise SystemExit("constrained flagship: cycles are not deterministic")
    check_bindings(cflag, res.assigned)
    terms_checked = check_anti_affinity(cflag, res.assigned)
    if claunches == 0 or claunches % 4 or cstray:
        raise SystemExit(
            f"constrained flagship: constrained launches {claunches}, plain {cstray} (expected a multiple of 4, 0)"
        )
    emit({"phase": "constrained_flagship", "pods": cflag.num_pods, "nodes": cflag.num_nodes, "bound_pods": 20_000,
          "warmup_seconds": times[0], "median_seconds": statistics.median(times[1:]), "seconds": times[1:],
          "rounds": res.rounds, "bound": len(res.bindings), "unschedulable": len(res.unschedulable),
          "choose_constrained_launches_per_cycle": claunches // 4,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), "pack_constraints_seconds_setup": pack_cons_s,
          "aa_terms_checked": terms_checked,
          "ppa_partial_sum_bound": cycle_ppa_partial_sum_bound(cflag, res.assigned),
          "upload_bytes_4_cycles": cuda_backend_mod.UPLOAD_BYTES, "invariants": "ok", "nvidia_smi": smi})
    emit(constrained_breakdown(backend, cflag, throughput))

    # The sharded constrained flagship on a (1, 2) mesh: one warm-up, two
    # timed cycles, each equal to the unsharded cycle.
    mesh12 = cuda_mesh(2, 2)
    rec, sresults = sharded_cycles("sharded_constrained_flagship", cflag, throughput, mesh12, 2, res)
    sharded_claunches = rec["choose_constrained_launches"]
    if (sresults[-1].rounds, len(sresults[-1].bindings)) != (55, 97_637):
        raise SystemExit("sharded constrained flagship: not 55 rounds and 97,637 bound")
    check_anti_affinity(cflag, sresults[-1].assigned)
    emit(dict(rec, unsharded_median_seconds=statistics.median(times[1:]), nvidia_smi=smi))
    wall_ms, rows = profiled(lambda: ShardedBackend(mesh12).schedule(cflag, throughput))
    emit(dict(device_split(wall_ms, rows, "choose_kernel<true,"), phase="sharded_constrained_breakdown", mesh=[1, 2]))
    # Kernel #2b at a late round of that cycle, which launches over every
    # row: the second shard's operands at the first round with <= 3 % of
    # the rows active, recorded from one more cycle.
    late = late_round_launch(cflag, throughput, mesh12)
    tail = constrained_timing("choose_constrained_tail_timing", late["args"], late["cons_pod"], late["masks"],
                              late["weights"], late["node_offset"], reps=10, plain_reps=1, smi=smi, salt=late["salt"],
                              round=late["round"], active_by_round=late["active_by_round"])
    cshard_max_abs_err = max([r["max_abs_err"] for r in offsets_recs] + [cshard["max_abs_err"], tail["max_abs_err"]])
    del late
    del cflag, csnap, results, sresults, res
    torch.cuda.empty_cache()

    # ---- the topology (gang-locality) main path ----------------------------
    tcl = topology_cluster(100_000, 8_192, seed=0)
    tflag, tcompiled, tgangs = tcl["packed"], tcl["compiled"], tcl["gangs"]
    tset = tflag.topology
    emit({"phase": "topology_setup", "synth_pack_seconds": tcl["synth_pack_seconds"],
          "pack_topology_seconds": tcl["pack_topology_seconds"], "pods": tflag.num_pods, "nodes": tflag.num_nodes,
          "padded": [tflag.padded_pods, tflag.padded_nodes], "gangs": tset.n_gangs,
          "gang_members": int((tset.pod_gang_id > 0).sum()),
          "domains": [int(d) for d in tcompiled.dom_counts], "term_bytes": (tset.n_gangs + 1) * tflag.padded_nodes * 4})

    term_card_vs_cpu(tflag, device, w_thr)

    # Kernels #1 and #2 with the gang term against their plain versions.
    trecs = []
    t_arrays, t_term = round_term(tflag, device, w_thr)
    first = block_args(t_arrays, 0, 8192)
    first_topo = (t_arrays["pod_gang_id"][:8192].contiguous(), t_term)
    trecs.append(compare_topology("flagship_block_round0", first, w_thr, 1, first_topo))
    m_arrays, m_term = round_term(tflag, device, w_thr, placed_share=0.5, seed=31)
    trecs.append(compare_topology("flagship_block_mid_cycle", block_args(m_arrays, 0, 8192), w_thr, 7,
                                  (m_arrays["pod_gang_id"][:8192].contiguous(), m_term)))
    del m_arrays, m_term
    small_args = block_args(a_small, 0, small.padded_pods)
    trecs.append(compare_topology("mixed_tiles", small_args, w_thr, 3,
                                  random_topo(small.padded_pods, small.padded_nodes, device, seed=41)))
    tie_args, tie_topo = topology_tie_case(device)
    trecs.append(compare_topology("term_ties", tie_args, no_jitter, 0, tie_topo))
    tie_choice = choose_block(*tie_args, no_jitter, 0, topo=tie_topo)[0]
    want = torch.where(tie_topo[0] > 0, 4 * tie_topo[0] + 1, 0)
    if not torch.equal(tie_choice, want):
        raise SystemExit("term_ties: a tie made by the gang term did not resolve to the lowest node index")
    scales = [0.0, 1e-3, 1e-1, 1e1, 1e3, 1e5, 1e7, 1e9]
    trecs.append(compare_topology("term_magnitudes", small_args, w_thr, 5,
                                  random_topo(small.padded_pods, small.padded_nodes, device, seed=42, gangs=7,
                                              zero_share=0.1, scale=scales)))
    c_arrays, c_masks = constrained_round(csmall, device, seed=3)
    trecs.append(compare_topology("constrained_mixed_tiles", block_args(c_arrays, 0, b_small), w_thr, 2,
                                  random_topo(b_small, csmall.padded_nodes, device, seed=43),
                                  block_cons(c_arrays, 0, b_small), c_masks))
    del c_arrays, c_masks
    # The constrained + topology cell (bench.py's topology CPU shape with the
    # constrained row's fractions, gangs of 2-4): round 0 with its real term.
    ct_snap = synth_cluster(n_nodes=512, n_pending=8192, seed=0, gang_fraction=0.35, **CONS_FRACTIONS)
    ct, _ = with_constraints(ct_snap, pack_snapshot(ct_snap, pod_block=8192, node_block=128))
    ct = with_topology(ct_snap, ct)
    ct_arrays, ct_masks = constrained_round(ct, device)
    ct_term_arrays, ct_term = round_term(ct, device, w_thr)
    ct_args, ct_cons = block_args(ct_arrays, 0, 8192), block_cons(ct_arrays, 0, 8192)
    ct_topo = (ct_term_arrays["pod_gang_id"][:8192].contiguous(), ct_term)
    trecs.append(compare_topology("constrained_topology_round0", ct_args, w_thr, 1, ct_topo, ct_cons, ct_masks))
    topo_max_abs_err = max(r["max_abs_err"] for r in trecs if r["family"] == "plain")
    ctopo_max_abs_err = max(r["max_abs_err"] for r in trecs if r["family"] == "constrained")

    # Timed: the full-shape first block with the term, without it, plain.
    first_words = pack_node_words(*first[13:18])
    topo_ms, topo_plain_ms, err = timed_and_held(
        "choose_topology_timing", lambda: choose_block(*first, w_thr, 1, node_words=first_words, topo=first_topo),
        lambda: choose_block_plain(*first, w_thr, 1, topo=first_topo), reps=20, plain_reps=3,
    )
    topo_max_abs_err = max(topo_max_abs_err, err)
    no_term_ms = time_cuda(lambda: choose_block(*first, w_thr, 1, node_words=first_words), reps=20)
    topo_bound, topo_bound_by = topology_bound_ms(first, first_topo)
    emit({"phase": "choose_topology_timing", "B": 8192, "N": tflag.padded_nodes, "gang_rows": int(t_term.shape[0]),
          "tile_rows": tile_rows(first_topo[0], first[8]), "ms": topo_ms, "ms_without_term": no_term_ms,
          "plain_ms": topo_plain_ms, "bound_ms": topo_bound, "bound_by": topo_bound_by,
          "share_of_bound": topo_bound / topo_ms, "equal": True, "max_abs_err": err, "nvidia_smi": smi})
    ct_words = pack_node_words(*ct_args[13:18])
    ctopo_ms, ctopo_plain_ms, err = timed_and_held(
        "choose_constrained_topology_timing",
        lambda: choose_block_constrained(*ct_args, ct_cons, ct_masks, w_thr, 1, node_words=ct_words, topo=ct_topo),
        lambda: choose_block_constrained_plain(*ct_args, ct_cons, ct_masks, w_thr, 1, topo=ct_topo),
        reps=20, plain_reps=3,
    )
    ctopo_max_abs_err = max(ctopo_max_abs_err, err)
    ct_no_term_ms = time_cuda(
        lambda: choose_block_constrained(*ct_args, ct_cons, ct_masks, w_thr, 1, node_words=ct_words), reps=20)
    ct_pod_ops, ct_node_ops = constrained_pod_operands(ct_cons, ct_masks), constrained_node_operands(ct_masks)
    ctopo_bound, ctopo_bound_by = topology_bound_ms(
        ct_args, ct_topo, [int(t.shape[1]) for t in ct_pod_ops], constrained_products(ct_pod_ops, ct_node_ops,
                                                                                   ct_args[8]))
    emit({"phase": "choose_constrained_topology_timing", "B": 8192, "N": ct.padded_nodes,
          "gang_rows": int(ct_term.shape[0]), "ms": ctopo_ms, "ms_without_term": ct_no_term_ms,
          "plain_ms": ctopo_plain_ms, "bound_ms": ctopo_bound, "bound_by": ctopo_bound_by,
          "share_of_bound": ctopo_bound / ctopo_ms, "equal": True, "max_abs_err": err, "nvidia_smi": smi})
    del t_arrays, t_term, first, first_topo, first_words, ct_arrays, ct_masks, ct_term_arrays, ct_term, ct_args
    del ct_cons, ct_topo, ct_words, ct_pod_ops, ct_node_ops
    torch.cuda.empty_cache()

    # bench.py's topology row at its CPU shape, unconstrained and with the
    # constrained row's fractions: card vs CPU.
    tmid = topology_cluster(8192, 512, seed=0)["packed"]
    ctopo_launches = 0
    for name, packed in (("topology", tmid), ("constrained_topology", ct)):
        choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
        choose_mod.LAUNCHES_TOPO = choose_mod.LAUNCHES_CONSTRAINED_TOPO = 0
        t0 = time.perf_counter()
        r_gpu = CudaBackend("cuda").schedule(packed, throughput)
        gpu_s = time.perf_counter() - t0
        counts = [choose_mod.LAUNCHES_TOPO, choose_mod.LAUNCHES_CONSTRAINED_TOPO, choose_mod.LAUNCHES,
                  choose_mod.LAUNCHES_CONSTRAINED]
        t0 = time.perf_counter()
        r_cpu = CudaBackend(device="cpu").schedule(packed, throughput)
        cpu_s = time.perf_counter() - t0
        parity = (
            np.array_equal(r_gpu.assigned, r_cpu.assigned) and r_gpu.rounds == r_cpu.rounds
            and np.array_equal(r_gpu.stats["acc_round"], r_cpu.stats["acc_round"])
            and np.array_equal(r_gpu.stats["rank"], r_cpu.stats["rank"])
        )
        constrained = packed.constraints is not None
        emit({"phase": "topology_cycle_parity", "case": name, "pods": packed.num_pods, "nodes": packed.num_nodes,
              "gangs": packed.topology.n_gangs, "rounds": r_gpu.rounds, "bound": len(r_gpu.bindings),
              "launches": dict(zip(("topo", "constrained_topo", "plain", "constrained"), counts)),
              "gpu_seconds": gpu_s, "cpu_seconds": cpu_s, "equal": bool(parity)})
        used = counts[1] if constrained else counts[0]
        if not parity or used == 0 or counts[2] or counts[3] or counts[0 if constrained else 1]:
            raise SystemExit(f"{name} cycle: card and CPU disagree, or it launched {counts} (topology instances only)")
        check_bindings(packed, r_gpu.assigned)
        if constrained:
            check_anti_affinity(packed, r_gpu.assigned)
            ctopo_launches = counts[1]
    del tmid, ct, ct_snap
    torch.cuda.empty_cache()

    # The topology flagship through the user's entry point: three cycles on a
    # fresh copy of the cluster each (every upload misses the cache), then
    # three on one cluster (every upload hits).
    tbackend = CudaBackend()
    tbackend.schedule(tflag, throughput)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    choose_mod.LAUNCHES = choose_mod.LAUNCHES_CONSTRAINED = 0
    choose_mod.LAUNCHES_TOPO = choose_mod.LAUNCHES_CONSTRAINED_TOPO = 0
    miss_s, miss_res, miss_bytes = topology_cycles(tbackend, tflag, throughput, 3, fresh=True)
    hit_s, hit_res, hit_bytes = topology_cycles(tbackend, tflag, throughput, 3, fresh=False)
    tlaunches = choose_mod.LAUNCHES_TOPO
    tstray = [choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED, choose_mod.LAUNCHES_CONSTRAINED_TOPO]
    res = hit_res[-1]
    if any(not np.array_equal(r.assigned, res.assigned) or r.rounds != res.rounds for r in miss_res + hit_res):
        raise SystemExit("topology flagship: cycles are not deterministic")
    check_bindings(tflag, res.assigned)
    if tlaunches == 0 or tlaunches % 6 or any(tstray) or miss_bytes == 0 or hit_bytes != 0:
        raise SystemExit(f"topology flagship: topology launches {tlaunches}, others {tstray} (expected a multiple "
                         f"of 6 and none); upload bytes {miss_bytes} on misses, {hit_bytes} on hits")
    blind = CudaBackend().schedule(dataclasses.replace(tflag, topology=None), throughput)
    emit({"phase": "topology_flagship", "pods": tflag.num_pods, "nodes": tflag.num_nodes, "gangs": tset.n_gangs,
          "cache_miss_seconds": miss_s, "cache_miss_median_seconds": statistics.median(miss_s),
          "cache_miss_min_seconds": min(miss_s), "cache_miss_upload_bytes_per_cycle": miss_bytes // 3,
          "cache_hit_seconds": hit_s, "cache_hit_median_seconds": statistics.median(hit_s),
          "cache_hit_min_seconds": min(hit_s), "cache_hit_upload_bytes": hit_bytes,
          "rounds": res.rounds, "bound": len(res.bindings), "unschedulable": len(res.unschedulable),
          "choose_topology_launches_per_cycle": tlaunches // 6, "quality": gang_quality(res, tcompiled, tgangs),
          "blind": dict(gang_quality(blind, tcompiled, tgangs), rounds=blind.rounds, bound=len(blind.bindings)),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), "invariants": "ok", "nvidia_smi": smi})
    emit(topology_breakdown(tbackend, tflag, throughput))
    del tcl, tflag, tset, miss_res, hit_res, res, blind, tbackend
    torch.cuda.empty_cache()

    # ---- the bisection kernels (experiments) -------------------------------
    brecs = bisect_phase(device)

    emit({"kernels": [
        {
            "name": "choose", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/pallas_choose.py:356", "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        },
        {
            "name": "choose_constrained", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/pallas_choose.py:172", "launches": claunches,
            "max_abs_err": cons_max_abs_err, "ms": ctiming["ms"], "plain_ms": ctiming["plain_ms"],
            "bound_ms": ctiming["bound_ms"], "bound_by": ctiming["bound_by"], "library_ms": None,
        },
        {
            "name": "choose_sharded", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/parallel/sharded.py:264", "launches": sharded_launches,
            "max_abs_err": shard_max_abs_err,
            "ms": shard_ms, "plain_ms": shard_plain_ms, "bound_ms": shard_bound_ms, "bound_by": shard_bound_by,
            "library_ms": None,
        },
        {
            "name": "choose_constrained_sharded", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/parallel/sharded.py:264", "launches": sharded_claunches,
            "max_abs_err": cshard_max_abs_err,
            "ms": cshard["ms"], "plain_ms": cshard["plain_ms"], "bound_ms": cshard["bound_ms"],
            "bound_by": cshard["bound_by"], "library_ms": None,
        },
        {
            "name": "choose_topology", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/assign.py:229-233 + tpu_scheduler/ops/score.py:141-150",
            "launches": tlaunches, "max_abs_err": topo_max_abs_err, "ms": topo_ms, "plain_ms": topo_plain_ms,
            "bound_ms": topo_bound, "bound_by": topo_bound_by, "library_ms": None,
        },
        {
            "name": "choose_constrained_topology", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/assign.py:229-233 + tpu_scheduler/ops/score.py:141-150",
            "launches": ctopo_launches, "max_abs_err": ctopo_max_abs_err, "ms": ctopo_ms,
            "plain_ms": ctopo_plain_ms, "bound_ms": ctopo_bound, "bound_by": ctopo_bound_by, "library_ms": None,
        },
    ] + [
        {
            "name": r["kernel"], "route": "cuda", "source": "tpu_scheduler_torch/csrc/bisect.cu",
            "replaces": "scripts/bench_wide_kernel.py:88" if r["kernel"] == "bisect_wide"
            else "scripts/bench_kernel_parts.py:78",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        }
        for r in brecs
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
