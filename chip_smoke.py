"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from tpu_scheduler_torch/csrc/ (one nvcc call per
source, started together: choose.cu holds the choose kernels, bisect.cu the
bisection kernels) and, for each main path:

* unconstrained — holds the kernel bit for bit against its plain torch
  version on the card, holds a mid-size cycle on the card against the same
  cycle on the CPU, then runs the flagship unconstrained cycle (100k
  pending pods × 10k nodes × 20k bound, seed 0, ``throughput`` profile,
  pod_block 8192, max_rounds 64) through ``CudaBackend.schedule`` and checks
  its invariants;
* constrained — the same for the constrained kernel and the flagship
  constrained cycle: the same cluster with anti-affinity, hard and soft
  topology spread, positive and preferred pod affinity and extended
  resources at 10 % each, packed with ``pack_constraints`` (bench.py's
  constrained row at its on-chip shape);
* sharded — the dp × tp cycle (``parallel/sharded.ShardedBackend``) on
  virtual shards of the one card (``make_mesh([cuda:0] * k, tp)``): the
  per-shard choose with ``node_offset`` (kernel #2b) held against its plain
  version and, merged over the node slices, against the unsplit launch; the
  mid and constrained-row cycles held against ``CudaBackend``; the flagship
  on (2, 2) and the constrained flagship on (1, 2), timed, held against the
  unsharded cycles;
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
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

import tpu_scheduler_torch.ops.assign as assign_mod
import tpu_scheduler_torch.ops.bisect as bisect_mod
import tpu_scheduler_torch.ops.choose as choose_mod
from tpu_scheduler_torch.backends.cuda import CudaBackend
from tpu_scheduler_torch.convert import constraints_to_device, to_device
from tpu_scheduler_torch.models.profiles import PROFILES
from tpu_scheduler_torch.ops.assign import assign_cycle, split_device_arrays
from tpu_scheduler_torch.ops.choose import (
    CONSTRAINT_POD_KEYS,
    choose_block,
    choose_block_constrained,
    choose_block_constrained_plain,
    choose_block_plain,
    constrained_node_operands,
    constrained_pod_operands,
)
from tpu_scheduler_torch.ops.constraints import augment_round_state, pack_constraints, round_blocked_masks
from tpu_scheduler_torch.experiments import bench_kernel_parts, bench_wide_kernel, time_cuda
from tpu_scheduler_torch.experiments import card as nvidia_smi
from tpu_scheduler_torch.ops.pack import pack_snapshot
from tpu_scheduler_torch.parallel.mesh import make_mesh
from tpu_scheduler_torch.parallel.sharded import ShardedBackend
from tpu_scheduler_torch.testing import synth_cluster

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
        "feasible_pods": int(kh.sum()), "equal": bool(equal), "max_abs_err": err,
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


def tie_case(device) -> list:
    """Every node identical except two with equal, larger free capacity at
    indices 261 and 300 (different threads and warps): with zero jitter
    every pod must pick 261."""
    b, n = 13, 700
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
    b: int, n: int, r: int, widths: list[int], cons_widths: list[int] | None = None, cons_node_nnz: int = 0
) -> tuple[float, str]:
    """Least time for one choose launch: each input byte read once, each
    output written once, over HBM bandwidth; and the operations it does
    over the float32 peak (integer ops counted at that rate too).  Per
    (pod, node) pair: r fit compares, 2 ops per dot-product term, and 45
    scalar ops (3 predicate compares + 2 masks, 4 integer ops and 2
    conversions for used_after, 2 divisions, 8 for LR/BA, 3 to combine,
    2 + 2 for the soft terms, 6 for the hash, 3 to quantize, 3 for the
    jitter term, 1 conversion, 1 argmax compare, 3 selects).

    The constrained kernel adds its four [B, W]·[W, N] operand pairs
    (``cons_widths``) to the bytes, 8 scalar ops per pair (blocked compare
    and mask, 2 for the soft-spread term, 3 for the level term, 1 for the
    preferred term, 1 select), and 2 ops per pod for each NON-ZERO entry of
    the node-side operands (``cons_node_nnz``): a product with a zero node
    value adds nothing, so this run's data needs only those."""
    w = sum(widths)
    wc = sum(cons_widths or [])
    nbytes = b * (4 * r + 4 * w + 4 + 4 + 1 + 4) + n * (8 * r + 1 + 4 * w) + b * (4 + 1 + 4) + 4 * wc * (b + n)
    ops = b * n * (r + 2 * w + 45) + (b * n * 8 + 2 * b * cons_node_nnz if cons_widths else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def compare_constrained(name: str, args: list, cons_pod: dict, masks: dict, weights, salt: int = 0) -> tuple:
    """Constrained kernel vs its plain version on the same CUDA tensors:
    has and choice equal everywhere, best equal bit for bit where has
    holds."""
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
        "equal": bool(equal), "max_abs_err": err,
    }
    emit(rec)
    if not equal:
        raise SystemExit(f"constrained kernel and plain disagree on case {name}")
    return rec, (kc, kh, kb)


def block_cons(arrays: dict, lo: int, hi: int) -> dict:
    return {k: arrays[k][lo:hi].contiguous() for k in CONSTRAINT_POD_KEYS}


def budget_widths_case(device, seed: int = 11) -> tuple:
    """Every constraint width at its budget (256 anti-affinity, spread, soft
    spread, positive and preferred terms: a 1024-wide blocked band and a
    ~58 KB pod tile, over the 48 KB default) with R = 3, random operands."""
    rng = np.random.default_rng(seed)
    b, n, k = 300, 777, 256
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
    cons_choose_ms = sum(r[1] for r in rows if "choose_kernel<true>" in r[0])
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


def build_kernels() -> dict:
    """Build every kernel library at once, one nvcc per source started
    together; prints each library's ptxas resource lines.  Returns
    {library: build seconds}."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {"choose": pool.submit(choose_mod.build_library), "bisect": pool.submit(bisect_mod.build_bisect_library)}
        built = {name: f.result() for name, f in futures.items()}
    for name, (_, _, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                print(f"# ptxas ({name}): {line.strip()}", flush=True)
    return {name: seconds for name, (_, seconds, _) in built.items()}


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
        raise SystemExit(f"{phase}: the kernel and its plain version disagree at the shard shape")
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


NAMES_BISECT = ("bisect_parts_v0", "bisect_parts_v1", "bisect_parts_v2", "bisect_parts_v3", "bisect_wide")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = build_kernels()
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_seconds": build_s,
        "build_wall_seconds": time.perf_counter() - t0,
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
    rec, (kc, kh, _) = compare("exact_two_node_tie", tie_case(device), PROFILES["default"].with_(spread_jitter=0.0).weights())
    recs.append(rec)
    if not bool(kh.all()) or not bool((kc == 261).all()):
        raise SystemExit("tie did not resolve to the lower node index")
    recs.append(compare("salt_7_throughput", block_args(a_small, 0, small.padded_pods), w_thr, salt=7)[0])
    recs.append(compare("wide_vocab_R5", random_wide_case(device), w_thr, salt=3)[0])
    a_flag = to_device(flagship, device)
    flag_args = block_args(a_flag, 0, 8192)
    recs.append(compare("flagship_block", flag_args, w_thr, salt=1)[0])
    max_abs_err = max(r["max_abs_err"] for r in recs)

    kernel_ms = time_cuda(lambda: choose_block(*flag_args, w_thr, 1), reps=20)
    plain_ms = time_cuda(lambda: choose_block_plain(*flag_args, w_thr, 1), reps=3)
    widths = [int(flag_args[i].shape[1]) for i in (1, 3, 4, 6, 7)]
    bound_ms, bound_by = choose_bound_ms(8192, flagship.padded_nodes, flagship.node_avail.shape[1], widths)
    emit({"phase": "choose_timing", "B": 8192, "N": flagship.padded_nodes, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "nvidia_smi": smi})

    # Kernel #2b: the flagship block split into tp node slices.
    offsets_rec = sharded_offsets("flagship_block", flag_args, w_thr, 1)
    # ... and timed at the (2, 2) mesh's shard shape: half the pod rows
    # against the second node column.
    p_local, n_local = flagship.padded_pods // 2, flagship.padded_nodes // 2
    shard_args = node_slice(block_args(a_flag, 0, p_local), n_local, 2 * n_local)
    shard_ms, shard_plain_ms, shard_err = timed_and_held(
        "choose_sharded_timing", lambda: choose_block(*shard_args, w_thr, 1, node_offset=n_local),
        lambda: choose_block_plain(*shard_args, w_thr, 1, node_offset=n_local), reps=10, plain_reps=2,
    )
    shard_max_abs_err = max(offsets_rec["max_abs_err"], shard_err)
    shard_bound_ms, shard_bound_by = choose_bound_ms(p_local, n_local, flagship.node_avail.shape[1], widths)
    emit({"phase": "choose_sharded_timing", "B": p_local, "N": n_local, "node_offset": n_local, "ms": shard_ms,
          "plain_ms": shard_plain_ms, "bound_ms": shard_bound_ms, "bound_by": shard_bound_by, "equal": True,
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
    times, results = [], []
    for _ in range(4):  # one warm-up, then three timed cycles
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
          "invariants": "ok", "nvidia_smi": smi})

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
    del arrays, masks
    arrays, masks = constrained_round(cflag, device)
    cflag_args, cflag_cons = block_args(arrays, 0, 8192), block_cons(arrays, 0, 8192)
    rec, _ = compare_constrained("flagship_block_round0", cflag_args, cflag_cons, masks, w_thr, salt=1)
    crecs.append(rec)
    cons_max_abs_err = max(r["max_abs_err"] for r in crecs)
    coffsets_rec = sharded_offsets("flagship_block_round0", cflag_args, w_thr, 1, cflag_cons, masks)

    ckernel_ms = time_cuda(lambda: choose_block_constrained(*cflag_args, cflag_cons, masks, w_thr, 1), reps=10)
    cplain_ms = time_cuda(lambda: choose_block_constrained_plain(*cflag_args, cflag_cons, masks, w_thr, 1), reps=3)
    cons_widths = [int(t.shape[1]) for t in constrained_pod_operands(cflag_cons, masks)]
    nnz = sum(int((t != 0).sum()) for t in constrained_node_operands(masks))
    cwidths = [int(cflag_args[i].shape[1]) for i in (1, 3, 4, 6, 7)]
    cbound_ms, cbound_by = choose_bound_ms(
        8192, cflag.padded_nodes, cflag.node_avail.shape[1], cwidths, cons_widths, nnz
    )
    emit({"phase": "choose_constrained_timing", "B": 8192, "N": cflag.padded_nodes, "ms": ckernel_ms,
          "plain_ms": cplain_ms, "bound_ms": cbound_ms, "bound_by": cbound_by, "cons_widths": cons_widths,
          "cons_node_nnz": nnz, "ppa_partial_sum_bound": ppa_partial_sum_bound(cflag_cons, masks),
          "nvidia_smi": smi})
    del cflag_args, cflag_cons
    # Kernel #2b constrained, timed at the (1, 2) mesh's shard shape: every
    # pod row against the second node column, round-0 masks.
    cn_local = cflag.padded_nodes // 2
    cshard_args = node_slice(block_args(arrays, 0, cflag.padded_pods), cn_local, 2 * cn_local)
    cshard_cons, cshard_masks = block_cons(arrays, 0, cflag.padded_pods), mask_slice(masks, cn_local, 2 * cn_local)
    cshard_ms, cshard_plain_ms, cshard_err = timed_and_held(
        "choose_constrained_sharded_timing",
        lambda: choose_block_constrained(*cshard_args, cshard_cons, cshard_masks, w_thr, 1, node_offset=cn_local),
        lambda: choose_block_constrained_plain(
            *cshard_args, cshard_cons, cshard_masks, w_thr, 1, node_offset=cn_local),
        reps=3, plain_reps=1,
    )
    cshard_max_abs_err = max(coffsets_rec["max_abs_err"], cshard_err)
    cshard_nnz = sum(int((t != 0).sum()) for t in constrained_node_operands(cshard_masks))
    cshard_bound_ms, cshard_bound_by = choose_bound_ms(
        cflag.padded_pods, cn_local, cflag.node_avail.shape[1], cwidths,
        [int(t.shape[1]) for t in constrained_pod_operands(cshard_cons, cshard_masks)], cshard_nnz,
    )
    emit({"phase": "choose_constrained_sharded_timing", "B": cflag.padded_pods, "N": cn_local,
          "node_offset": cn_local, "ms": cshard_ms, "plain_ms": cshard_plain_ms, "bound_ms": cshard_bound_ms,
          "bound_by": cshard_bound_by, "cons_node_nnz": cshard_nnz, "equal": True, "max_abs_err": cshard_err,
          "nvidia_smi": smi})
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
    times, results = [], []
    for _ in range(4):  # one warm-up, then three timed cycles
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
          "invariants": "ok", "nvidia_smi": smi})
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
    emit(dict(device_split(wall_ms, rows, "choose_kernel<true>"), phase="sharded_constrained_breakdown", mesh=[1, 2]))
    del cflag, csnap, results, sresults, res
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
            "max_abs_err": cons_max_abs_err, "ms": ckernel_ms, "plain_ms": cplain_ms, "bound_ms": cbound_ms,
            "bound_by": cbound_by, "library_ms": None,
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
            "ms": cshard_ms, "plain_ms": cshard_plain_ms, "bound_ms": cshard_bound_ms,
            "bound_by": cshard_bound_by, "library_ms": None,
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
