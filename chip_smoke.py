"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both choose kernels (unconstrained and constrained) from
tpu_scheduler_torch/csrc/ with one nvcc call and, for each main path:

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
  constrained row at its on-chip shape).

Each phase prints one JSON line; any failure exits non-zero.  The last
line is the device summary.  Exits 1 without a result when CUDA is not
available.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

import tpu_scheduler_torch.ops.assign as assign_mod
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
from tpu_scheduler_torch.ops.pack import pack_snapshot
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around ``reps`` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.schedule(packed, profile)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only (kernels, copies): host ops also carry their kernels' time
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
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
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.schedule(packed, profile)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing measured", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi()
    lib_path, build_s, build_log = choose_mod.build_library()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"# ptxas: {line.strip()}", flush=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_seconds": build_s,
        "library": str(lib_path.name),
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
    del a_flag, flag_args
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
    del arrays, masks, cflag_args, cflag_cons
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
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
