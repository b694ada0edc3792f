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
* multi-process — ``multihost``: the sharded flagship and the sharded
  constrained flagship across two processes
  (``parallel/multihost.py``): two ranks of ``experiments/multihost_cards``
  on one free 127.0.0.1 port, each ``init_distributed`` with
  ``[cuda:0] * 2`` as its tp row (gloo: the ranks share the card), so the
  (2, 2) mesh's dp crosses them; each rank's bindings and rounds held
  against the single-process sharded cycles, its #2b launches counted, its
  exchange's time a round against #2b's; #2b held against its plain
  version at rank 1's shard (``kernel_vs_plain_multihost_shard``);
  ``native_ext``: the packing shim (``ops/native_ext``, built with g++) on
  the flagship's 100,000 pending pods against the Python quantity path,
  and the share of a fresh pack spent in request sums and parses;
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
* controller — the port's Scheduler over ``CudaBackend`` against an
  in-process API server: ``controller_e2e`` is bench.py's ``e2e_row`` at the
  flagship size (a cold cycle, three fresh 100,000-pod waves, one more
  under torch.profiler, three 10,000-pod churn cycles; pipelined binds,
  full-wave cycles), each cycle's phases, bind drain, upload bytes and
  choose launches, checked against ``CudaBackend.schedule`` of the same
  cluster, for oversubscription and for fallbacks; ``controller_parity``
  runs the CLI's mixed workload at 20,000 × 2,000 and bench.py's topology
  cluster at 8,192 × 512 (alone and with the constrained row's fractions)
  to settlement on the card and on the CPU and holds the pod → node maps
  and cycle counts equal; ``cli`` runs ``python -m tpu_scheduler_torch.cli``
  on the card on the mixed workload and holds its bound total to the card
  run's (these three run full waves, ``delta=False``);
* delta engine — ``controller_delta`` is bench.py's ``incremental_row`` on
  the port at the flagship size (a cold full wave, 10 steady delta cycles
  of 1,000 fresh pods, 3 bursts of 10,000, one more steady cycle under
  torch.profiler), each cycle's phases, dirty set, kernel #1 launches,
  upload bytes and solved node axis, checked for oversubscription,
  fallbacks and a delta solve that launched no kernel; ``delta_shadow``
  and ``controller_delta_parity`` share two runs at 5,000 × 500 with
  500-pod churn and ``delta_shadow_every=1`` (the CLI's mixed workload,
  whose constrained delta cycles the shadow check skips by its contract,
  and that workload less its cross-node constraints) on the card (zero
  shadow mismatches) and on the CPU in the parity child (the same bindings
  and ``delta.stats()`` every cycle);
  ``kernel_vs_plain_delta`` replays kernels #1 and #2 on operands captured
  from those delta cycles;
* HTTP boundary — ``controller_http`` serves bench.py's CPU e2e cluster
  (10,000 × 1,000, 2,000 bound) over ``HttpApiServer`` on 127.0.0.1, runs
  the CLI on the card through a kubeconfig with a bearer token until
  settled and holds its bindings to an in-process Scheduler's; then a
  ``--checkpoint-dir`` run of one cycle and a restarted run that restores
  (one "restore" escalation) and ends with the same bindings;
* simulator — ``sim`` drives the port's ``sim/harness.scenario_episode``
  on the card: bench.py's sim rows at their own sizes (``sim_row``:
  sim-smoke seed 0 through the harness's default backend;
  ``sim_sweep_row``: sim-smoke and api-brownout-recovery, seeds 0-2;
  ``latency_row``: the arrival-rate-sweep family at 5, 15 and 40 pods/s),
  churn-steady-state (the delta gate: shadow parity, full-solve fraction
  <= 0.10), slice-fragmented-cluster (the locality gate, kernel #1t),
  steady-state (the profile and compile gates) and sim-smoke scaled ×25 to
  5,000 nodes; each episode's card held against the same episode on the
  CPU (two child processes beside the card runs, on cores of their own):
  fingerprints equal, scorecards equal but for the compile block's
  ``enabled``, both passing; a card-recorded trace replayed on the CPU and
  a CPU-recorded one on the card; one sim-smoke episode under
  torch.profiler (device idle share, the controller's share of the wall);
* fleet — the sharded control plane and the multi-mesh fleet over
  ``CudaBackend``, each phase against a CPU child run beside it:
  ``multi_replica`` and ``multi_mesh`` are bench.py's ``multi_replica_row``
  and ``multi_mesh_row`` at 8,192 × 512, K = 1, 2, 4 replicas over 4
  lease-owned shards (bound, cycles and the virtual takeover equal to the
  CPU's; a mesh rebind where K > 1); ``sim_multi`` the five multi-replica
  scenarios at seed 0 (cards equal but for ``compile.enabled``); ``fuzz``
  the corpus replay and a seed-0 campaign of 24 plans through ``sim fuzz``
  (the run log byte-equal to the CPU's; plans on the ``elastic`` base, the
  autoscaler's, run like the rest); ``fleet_e2e`` four replicas over
  four shards at ``controller_e2e``'s 100k × 10k with the nodes in racks of
  32, one FakeApiServer and one VirtualClock: ownership warmed up, the wave
  settled, replica 0 crash-killed, the survivors' takeover with a mesh
  rebind within 2 × the 5 s lease, no double bind, no node oversubscribed,
  every binding feasible, each replica's launches, a survivor's cycle under
  torch.profiler; ``kernel_vs_plain_fleet`` kernel #1 on a replica's
  node-sliced operands from ``fleet_e2e`` and #1t on a sliced topology
  cycle of cross-shard-gang-admission;
* rebalancer, autoscaler, learned policy — each phase against a CPU child
  run beside it where it names one: ``rebalance_row`` is bench.py's
  ``rebalance_row`` (8,192 bound pods round-robin on 512 nodes, seed 0,
  ``RebalanceConfig(every=1, batch=256, max_plan=1024, max_pending=512)``,
  until two ``no-gain`` skips; migrations, drained nodes, packing before
  and after, cycles, churn and the final placements equal to the CPU's;
  solve and cycle walls, phases, one cycle's idle share); ``rebalance_e2e``
  the flagship's cluster fragmented (100,000 pods bound round-robin on
  10,000 nodes), 8 ticked cycles (4 solves of up to 256 migrations): the
  solve walls, the re-placement cycles through #1, no node newly
  oversubscribed, no orphaned or infeasible migration, no preemption, #1
  held against its plain version at the first re-placement block;
  ``sim_item9`` the 3 rebalancer, 4 autoscaler scenarios and
  rebalance-under-chaos at seed 0 (cards equal but for
  ``compile.enabled``); ``policy`` bench.py's ``policy_row`` (the tuned
  artifact against the default on its provenance scenarios at the first
  held-out seed, objectives equal to the CPU's; the delta cycle at
  10,000 × 1,000 under each profile, ``policy_latency_ratio``; #1t held
  against its plain version on a train-smoke cycle under the tuned
  weights); ``train`` ``sim train`` on train-smoke (2 generations of 4,
  2 worker threads), its artifact byte-equal to the CPU's and, but for
  the echoed ``workers``, to a one-worker run on the card;
* bisection — the experiments ``tpu_scheduler_torch/experiments/
  bench_kernel_parts.py`` (kernel #4, every variant) and
  ``bench_wide_kernel.py`` (kernel #3) at their full shape (the whole
  call, and the launch alone on the prepared node side), and each kernel held
  bit for bit against its plain version: remainders, ties, wrapping
  capacities with ranks over the whole uint32 range, wide layouts whose
  live count rows take one word or two, the full size; then the wrappers'
  refusal of non-0/1 live count entries and of a non-finite pod_f32.

Each phase prints one JSON line; any failure exits non-zero.  The last
line is the device summary.  Exits 1 without a result when CUDA is not
available.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import random
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import tpu_scheduler_torch.backends.cuda as cuda_backend_mod
import tpu_scheduler_torch.cli as cli_mod
import tpu_scheduler_torch.ops.assign as assign_mod
import tpu_scheduler_torch.ops.bisect as bisect_mod
import tpu_scheduler_torch.ops.choose as choose_mod
import tpu_scheduler_torch.parallel.sharded as sharded_mod
import tpu_scheduler_torch.sim.harness as sim_harness
from tpu_scheduler_torch.backends.cuda import CudaBackend
from tpu_scheduler_torch.convert import constraints_to_device, to_device, topology_to_device
from tpu_scheduler_torch.core.snapshot import ClusterSnapshot, node_net_available
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
from tpu_scheduler_torch.experiments import (
    bench_kernel_parts,
    bench_wide_kernel,
    multihost_cards,
    profiled,
    ptxas_resources,
    time_cuda,
)
from tpu_scheduler_torch.experiments import card as nvidia_smi
from tpu_scheduler_torch.ops.pack import pack_snapshot
from tpu_scheduler_torch.parallel.mesh import make_mesh
from tpu_scheduler_torch.parallel.sharded import ShardedBackend
from tpu_scheduler_torch.runtime.controller import Scheduler
from tpu_scheduler_torch.runtime.fake_api import FakeApiServer
from tpu_scheduler_torch.sim.scenarios import SCENARIOS, arrival_rate_variant
from tpu_scheduler_torch.testing import make_node, make_pod, synth_cluster
from tpu_scheduler_torch.topology.locality import _add_rows as locality_add_rows
import tpu_scheduler_torch.topology.locality as locality_mod
from tpu_scheduler_torch.topology.locality import (
    GangTerm,
    gang_cycle_operands,
    gang_placement_stats,
    gang_round_operands,
    gang_state_update,
    gang_topology_term,
    pack_topology,
)
from tpu_scheduler_torch.topology.model import DEFAULT_LEVEL_KEYS, TopologyModel
from tpu_scheduler_torch.utils.gc_tuning import enable_daemon_gc_tuning

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


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 3)}
    print(json.dumps(obj), flush=True)


def block_args(arrays: dict, lo: int, hi: int) -> list:
    """choose_block's positional tensors for pod rows [lo, hi) against all
    nodes (ranks = row index, active = pod_valid)."""
    d = arrays["pod_req"].device
    pods = [arrays[k][lo:hi].contiguous() for k in POD_KEYS]
    active = arrays["pod_valid"][lo:hi].contiguous()
    ranks = torch.arange(lo, hi, dtype=torch.int32, device=d)
    return pods + [active, ranks] + [arrays[k] for k in NODE_KEYS]


def compare(name: str, args: list, weights, salt: int = 0, **extra) -> tuple[dict, tuple]:
    """Kernel vs plain on the same CUDA tensors: has and choice equal
    everywhere, best equal bit for bit where has holds.  ``extra`` joins
    the printed record."""
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
        "equal": bool(equal), "max_abs_err": err, **extra,
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
    active: int | None = None, extra_bytes: int = 0, extra_ops: int = 0,
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

    ``extra_bytes`` and ``extra_ops`` add a further term's work (the gang
    term: :func:`topology_bound_ms`)."""
    a = b if active is None else active
    w = sum(widths)
    wc = sum(cons_widths or [])
    nbytes = a * (4 * r + 4 * w + 12 + 4 * wc) + b * (1 + 4 + 1 + 4) + n * (8 * r + 1 + 4 * w + 4 * wc)
    ops = a * n * (r + 2 * w + 45) + (a * n * 8 + 2 * cons_products if cons_widths else 0)
    nbytes += extra_bytes
    ops += extra_ops
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


def wrap_parts_inputs(p: int, n: int, device, seed: int = 8) -> tuple:
    """Kernel #4's inputs as the tests make them (``tests/
    test_torch_bisect.py::_parts_inputs``): uint32 ranks over the whole
    range and 16 nodes whose capacities are INT32_MAX, so the used sum
    wraps."""
    rng = np.random.default_rng(seed)
    req = rng.integers(1, 1000, (p, 2), dtype=np.int32)
    sel = (rng.random((p, 8)) < 0.2).astype(np.float32)
    ranks = rng.integers(0, 2**32, (p, 1), dtype=np.uint32).view(np.int32)
    info = np.concatenate([rng.integers(500, 100_000, (4, n), dtype=np.int32), np.ones((1, n), np.int32),
                           np.zeros((3, n), np.int32)])
    info[2:4, rng.choice(n, 16, replace=False)] = np.iinfo(np.int32).max
    labels = (rng.random((8, n)) < 0.5).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (req, sel, sel.sum(-1, keepdims=True), ranks, info, labels))


def wide_live_inputs(p: int, n: int, rows: list, device, seed: int) -> tuple:
    """Kernel #3's wide layout with the count operand's live rows ``rows``
    (as ``tests/test_torch_bisect.py::_wide_inputs`` makes rows 0-47): node
    entries 0/1 at 60 %, the pods' columns of them at 4 %, the selector count
    in column 40 (node row 40 zero unless live) and on 10 % of the pods one
    more than any node gives, 20 % of the pods inactive, uint32 ranks over
    the whole range, 16 nodes at INT32_MAX capacity (the used sum wraps)."""
    rng = np.random.default_rng(seed)
    f = bench_wide_kernel.F
    node_f32 = np.zeros((f, n), np.float32)
    node_f32[rows] = rng.random((len(rows), n)) < 0.6
    pod_f32 = np.zeros((p, f), np.float32)
    pod_f32[:, rows] = rng.random((p, len(rows))) < 0.04
    if bisect_mod.WIDE_SELC_COL not in rows:
        pod_f32[:, bisect_mod.WIDE_SELC_COL] = pod_f32.sum(-1) + (rng.random(p) < 0.1)
    pod_i32 = np.zeros((p, 8), np.int32)
    pod_i32[:, 0:2] = rng.integers(1, 1000, (p, 2))
    pod_i32[:, 2] = rng.random(p) < 0.8
    pod_i32[:, 3] = rng.integers(0, 2**32, p, dtype=np.uint32).view(np.int32)
    info = np.concatenate([rng.integers(500, 100_000, (4, n), dtype=np.int32), np.ones((1, n), np.int32),
                           np.zeros((3, n), np.int32)])
    info[2:4, rng.choice(n, 16, replace=False)] = np.iinfo(np.int32).max
    return tuple(torch.from_numpy(x).to(device) for x in (pod_i32, pod_f32, info, node_f32))


def bisect_refusals(device) -> dict:
    """Case (e): a value other than 0.0 or 1.0 in a live entry of a count
    operand, or a non-finite pod_f32 value, must raise ValueError from the
    wrapper on CUDA tensors before any launch; a non-0/1 value in a dead
    column (column 50 here; the count column 40 holds counts in every case)
    must not.  Exits if one is not refused."""
    parts = bench_kernel_parts.make_inputs(64, 300, seed=9, device=device)
    wide = bench_wide_kernel.make_inputs(64, 300, seed=9, device=device)
    bad = {}
    labels = parts[5].clone()
    labels[3, 7] = 0.5
    bad["labels_0.5"] = lambda: bisect_mod.choose_parts(*parts[:5], labels, variant=1)
    sel = parts[1].clone()
    sel[5, 2] = 2.0
    bad["sel_2.0"] = lambda: bisect_mod.choose_parts(parts[0], sel, *parts[2:], variant=3)
    pod_live = wide[1].clone()
    pod_live[4, 3] = 2.0
    bad["pod_f32_live_2.0"] = lambda: bisect_mod.choose_wide(wide[0], pod_live, *wide[2:])
    pod_nan = wide[1].clone()
    pod_nan[6, 50] = float("nan")
    bad["pod_f32_dead_nan"] = lambda: bisect_mod.choose_wide(wide[0], pod_nan, *wide[2:])
    node_bad = wide[3].clone()
    node_bad[1, 11] = 3.0
    bad["node_f32_live_3.0"] = lambda: bisect_mod.choose_wide(*wide[:3], node_bad)
    before = list(bisect_mod.LAUNCHES_PARTS) + [bisect_mod.LAUNCHES_WIDE]
    refused = {}
    for name, call in bad.items():
        try:
            call()
            refused[name] = False
        except ValueError:
            refused[name] = True
    after = list(bisect_mod.LAUNCHES_PARTS) + [bisect_mod.LAUNCHES_WIDE]
    pod_dead = wide[1].clone()
    pod_dead[:, 50] = 0.5  # a dead column besides the count column's counts
    dead_ok = torch.equal(bisect_mod.choose_wide(wide[0], pod_dead, *wide[2:]),
                          bisect_mod.choose_wide_plain(wide[0], pod_dead, *wide[2:]))
    rec = {"phase": "bisect_refusals", "refused": refused, "dead_column_accepted_and_equal": dead_ok,
           "launches_of_refused_calls": sum(after) - sum(before)}
    emit(rec)
    if not all(refused.values()) or not dead_ok or rec["launches_of_refused_calls"] != 0:
        raise SystemExit(f"bisection wrappers: a bad count operand was not refused, or a dead column was: {rec}")
    return rec


def bisect_phase(device, resources: dict) -> list[dict]:
    """Kernels #3 and #4: the experiments' entry points at full size with
    the launch counts set to 0 just before and read just after; then each
    kernel against its plain version, bit for bit, on a remainder case (P,
    N multiples of no tile), a tie-heavy case, wrapping capacities with
    ranks over the whole uint32 range, wide layouts with 47, 22 (rows 0-7
    and 50-63) and 64 live rows, count operands with no live row, and the
    full size, with the plain version's time and the bound; then the
    refusals of bad count operands.  ``resources``: the build's ptxas
    lines by kernel."""
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
    no_40 = [r for r in range(48) if r != bisect_mod.WIDE_SELC_COL]
    cases = {
        "remainder_1003x2049": (bench_kernel_parts.make_inputs(1003, 2049, seed=3, device=device),
                                bench_wide_kernel.make_inputs(1003, 2049, seed=3, device=device)),
        "ties_4099x3001": (tie_parts_inputs(4099, 3001, device), None),
        "wrap_ranks_1003x2049": (wrap_parts_inputs(1003, 2049, device), None),
        "wide_47_live_1003x2049": (None, wide_live_inputs(1003, 2049, no_40, device, seed=4)),
        "wide_rows_0-7_50-63_1003x2049": (None, wide_live_inputs(1003, 2049, list(range(8)) + list(range(50, 64)),
                                                                 device, seed=5)),
        "wide_64_live_517x1031": (None, wide_live_inputs(517, 1031, list(range(64)), device, seed=6)),
        "no_live_count_rows_517x1031": (bench_kernel_parts.make_inputs(517, 1031, seed=10, device=device)[:5]
                                        + (torch.zeros((8, 1031), device=device),),
                                        wide_live_inputs(517, 1031, [], device, seed=10)),
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
                if pi is None:
                    continue
                k_out = bisect_mod.choose_parts(*pi, variant=variant)
                p_out = bisect_mod.choose_parts_plain(*pi, variant=variant)
            torch.cuda.synchronize()
            equal[case] = bool(torch.equal(k_out, p_out))
            max_abs_err = max(max_abs_err, float((k_out - p_out).abs().max()))
        if variant == 4:
            p, n, k = full_wide[0].shape[0], full_wide[2].shape[1], full_wide[1].shape[1]
            nnz = int((full_wide[3] != 0).sum())
            timed = wide
            plain_ms = time_cuda(lambda: bisect_mod.choose_wide_plain(*full_wide), reps=2)
        else:
            p, n, k = full_parts[0].shape[0], full_parts[4].shape[1], full_parts[1].shape[1]
            nnz = int((full_parts[5] != 0).sum())
            timed = parts[variant]
            plain_ms = time_cuda(lambda: bisect_mod.choose_parts_plain(*full_parts, variant=variant), reps=2)  # noqa: B023
        bound_ms, bound_by = bisect_bound_ms(p, n, k, variant, nnz)
        rec = {"phase": "bisect_kernels", "kernel": name, "P": p, "N": n, "equal": equal, "max_abs_err": max_abs_err,
               "ms": timed["ms"], "kernel_ms": timed["kernel_ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "gpair_per_s": p * n / timed["ms"] / 1e6, "launches": launches[variant],
               "pods_per_tile": timed["pods_per_tile"],
               "ptxas": {kn: r for kn, r in resources.items() if kn.startswith(f"bisect_kernel<{variant},")}}
        emit(rec)
        records.append(rec)
        if not all(equal.values()):
            raise SystemExit(f"bisection kernel {name}: kernel and plain disagree on {equal}")
    bisect_refusals(device)
    return records


# ---- the topology (gang-locality) path -------------------------------------

SLICE_KEY, RACK_KEY = DEFAULT_LEVEL_KEYS[0][1], DEFAULT_LEVEL_KEYS[1][1]


def topology_objects(pods: int, nodes: int, seed: int) -> tuple[list, list, dict]:
    """(nodes, pods, {gang: member full names}) of bench.py's
    ``topology_row`` cluster, built inline as bench.py does: ``nodes`` nodes
    of 32 CPU / 128 Gi, slices of 4 nodes and racks of 16; 35 % of draws
    open a gang of 4-8 members at 2 CPU / 4 Gi, the others are single pods
    at 1 CPU / 2 Gi."""
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
    return node_objs, pod_objs, gangs


def topology_cluster(pods: int, nodes: int, seed: int) -> dict:
    """bench.py's ``topology_row`` cluster (:func:`topology_objects`) packed
    with ``pack_snapshot``'s defaults and the TopologySet attached; the
    set-up seconds split into synth + pack and ``pack_topology``."""
    t0 = time.perf_counter()
    node_objs, pod_objs, gangs = topology_objects(pods, nodes, seed)
    snap = ClusterSnapshot.build(node_objs, pod_objs)
    compiled = TopologyModel.detect(node_objs).compile(node_objs)
    packed = pack_snapshot(snap)
    t1 = time.perf_counter()
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    t2 = time.perf_counter()
    return {"packed": dataclasses.replace(packed, topology=topo), "compiled": compiled, "gangs": gangs,
            "synth_pack_seconds": t1 - t0, "pack_topology_seconds": t2 - t1}


def label_topology(nodes) -> None:
    """Label node i into slice i // 4 and rack i // 16, in place (for
    clusters from ``synth_cluster``, which carry no topology labels)."""
    for i, node in enumerate(nodes):
        node.metadata.labels.update({SLICE_KEY: f"s{i // 4}", RACK_KEY: f"r{i // 16}"})


def with_topology(snap, packed):
    """``packed`` with the TopologySet of ``snap``'s nodes attached, after
    :func:`label_topology`."""
    label_topology(snap.nodes)
    compiled = TopologyModel.detect(snap.nodes).compile(snap.nodes)
    topo = pack_topology(compiled, snap.pending_pods(), packed.padded_pods, packed.node_names, packed.padded_nodes)
    return dataclasses.replace(packed, topology=topo)


def add_placements(state: dict, dom_col: torch.Tensor, gangs, nodes, counts) -> None:
    """Place ``counts[i]`` members of gang ``gangs[i]`` on node ``nodes[i]``
    in the per-domain state (``locality.gang_state_update`` with the counts
    in place of its 0/1 accepted flags), in place."""
    dev = dom_col.device
    gang_state_update(state, dom_col, torch.as_tensor(counts, dtype=torch.float32, device=dev),
                      torch.as_tensor(nodes, dtype=torch.int64, device=dev),
                      torch.as_tensor(gangs, dtype=torch.int32, device=dev))


def round_term(packed, device, weights, placed_share: float = 0.0, seed: int = 0) -> tuple[dict, GangTerm]:
    """(device arrays with ``pod_gang_id``, the round's GangTerm over every
    pod row, its gang ids those of all P rows) of one round: the
    cycle-start state, or ``placed_share`` of the gangs with a random member
    count placed on random nodes (a mid-cycle state: the anchor term is
    live)."""
    arrays = to_device(packed, device)
    tpods, tmeta, tstate = topology_to_device(packed.topology, device)
    arrays.update(tpods)
    cyc = gang_cycle_operands(tmeta)
    if placed_share:
        rng = np.random.default_rng(seed)
        g1 = tstate["total"].shape[0]
        rows = np.flatnonzero(rng.random(g1) < placed_share)
        rows = rows[rows > 0]
        add_placements(tstate, cyc["dom_col"], rows, rng.integers(0, packed.padded_nodes, rows.shape[0]),
                       rng.integers(1, 5, rows.shape[0]))
    op = gang_round_operands(cyc, tstate, tmeta, arrays["node_avail"], arrays["pod_gang_id"], arrays["pod_req"],
                             arrays["pod_valid"], weights[6])
    return arrays, op._replace(gang_id=arrays["pod_gang_id"])


def block_term(op: GangTerm, lo: int, hi: int) -> GangTerm:
    """``op`` with the gang ids of pod rows [lo, hi)."""
    return op._replace(gang_id=op.gang_id[lo:hi].contiguous())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def term_card_vs_cpu(packed, device, weights) -> dict:
    """The gang term's round inputs (remaining demand, domain capacities)
    and the dense term built from them (the kernels' plain version) on the
    card against the same on the CPU, bit for bit: the topology flagship's
    cycle-start state and a mid-cycle one; and the per-gang demand's
    pod-order adds (``locality._add_rows``) on inexact float32 values, where
    another order would round differently."""
    rec = {"phase": "topology_term_card_vs_cpu"}
    for name, share in (("round0", 0.0), ("mid_cycle", 0.5)):
        op_card = round_term(packed, device, weights, placed_share=share, seed=31)[1]
        op_cpu = round_term(packed, torch.device("cpu"), weights, placed_share=share, seed=31)[1]
        rec[f"{name}_inputs"] = all(bits_equal(getattr(op_card, k), getattr(op_cpu, k))
                                    for k in ("placed", "total", "rem", "dom_free", "herd"))
        rec[name] = bits_equal(gang_topology_term(op_card), gang_topology_term(op_cpu))
        del op_card, op_cpu
    rng = np.random.default_rng(5)
    idx = np.sort(rng.integers(0, 4096, 200_000))
    vals = (rng.random((200_000, 2)) * 1e7).astype(np.float32)
    on = {d: locality_add_rows(torch.zeros((4096, 2), device=d), torch.from_numpy(idx).to(d),
                               torch.from_numpy(vals).to(d)).cpu() for d in (device, torch.device("cpu"))}
    rec["pod_order_adds"] = bits_equal(on[device], on[torch.device("cpu")])
    emit(rec)
    if not all(v for k, v in rec.items() if k != "phase"):
        raise SystemExit(f"the gang term differs between the card and the CPU: {rec}")
    return rec


def random_gang_term(b: int, n: int, device, seed: int, gangs: int = 6, zero_share: float = 0.3,
                     levels=((1.0, 64), (2.0, 16)), weight: float = 64.0) -> GangTerm:
    """A GangTerm drawn from ``seed``: gang ids in 1..gangs, ``zero_share``
    of them 0; per level (distance, domains) random node domains (the
    sentinel included); random placed counts and totals, demands and
    domain capacities in 64 Ki units (so fits varies), herd values
    1 + 4·U[0, 1)."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(1, gangs + 1, b).astype(np.int32)
    gid[rng.random(b) < zero_share] = 0
    cols, off = [], 0
    for _dist, d in levels:
        cols.append(rng.integers(0, d + 1, n) + off)
        off += d + 1
    placed = (rng.integers(0, 4, (gangs + 1, off)) * (rng.random((gangs + 1, off)) < 0.3)).astype(np.float32)
    total = (placed.sum(axis=1) + rng.integers(0, 3, gangs + 1)).astype(np.float32)
    rem = (rng.integers(0, 40, (gangs + 1, 2)) * 65536).astype(np.float32)
    dom_free = (rng.integers(0, 64, (off, 2)) * 65536).astype(np.float32)
    herd = (1.0 + 4.0 * rng.random((gangs + 1, off))).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return GangTerm(t(gid), t(np.stack(cols).astype(np.int32)), t(np.float32([d for d, _ in levels])), t(placed),
                    t(total), t(rem), t(dom_free), t(herd), float(np.float32(weight)))


def distinct_gangs(gid: torch.Tensor, active: torch.Tensor) -> int:
    """The distinct gang ids among the active pods of a block."""
    return int(torch.unique(gid[active]).numel())


def tile_rows(gid: torch.Tensor, active: torch.Tensor, pods: int = 8) -> int:
    """Σ over the 8-pod tiles of the distinct gang ids among the tile's
    active pods: the dense term's rows the instances before the redesign
    read (the old bound)."""
    b = gid.shape[0]
    tiles = -(-b // pods)
    g = torch.full((tiles * pods,), -1, dtype=torch.int64, device=gid.device)
    g[:b] = torch.where(active, gid.long(), -1)
    s = g.view(tiles, pods).sort(dim=1).values
    return int(((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum() + (s[:, 0] >= 0).sum())


def compare_topology(name: str, args: list, weights, salt: int, topo: GangTerm, cons_pod=None, masks=None,
                     **extra) -> dict:
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
           "B": int(args[0].shape[0]), "N": int(args[10].shape[0]), "gang_rows": int(topo.placed.shape[0]),
           "levels": int(topo.dom_col.shape[0]), "domain_columns": int(topo.placed.shape[1]),
           "weight": topo.weight, "salt": salt, "feasible_pods": int(p_out[1].sum()),
           "moved_by_term": int((p_out[1] & (p_out[0] != blind[0])).sum()), "equal": equal, "max_abs_err": err,
           **extra}
    emit(rec)
    if not equal:
        raise SystemExit(f"topology kernel and plain disagree on case {name}")
    return rec


def topology_tie_case(device, b: int = 45, n: int = 700, gangs: int = 5) -> tuple[list, GangTerm]:
    """Every node identical (no jitter: every base score ties).  One level
    of 4-node slices; gang g has one member placed in slice g and one in
    slice 160 + g (nodes 640 + 4·g .. +3, another warp), so the term ties
    the 8 nodes of those two slices at its maximum.  Node 4·g is invalid:
    each gang's pods must pick 4·g + 1, the gangless pods node 0."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    req = torch.tensor([[100, 131072]] * b, dtype=torch.int32, device=device)
    alloc = torch.tensor([[8000, 16777216]] * n, dtype=torch.int32, device=device)
    avail = torch.tensor([[2000, 4194304]] * n, dtype=torch.int32, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    valid[[4 * g for g in range(1, gangs + 1)]] = False
    args = [
        req, z(b, 8), z(b), z(b, 8), z(b, 8), z(b), z(b, 8), z(b, 8),
        torch.ones(b, dtype=torch.bool, device=device), torch.arange(b, dtype=torch.int32, device=device),
        avail, alloc, valid, z(n, 8), z(n, 8), z(n, 8), z(n, 8), z(n, 8),
    ]
    d = n // 4 + 1  # the slices and the sentinel
    placed = z(gangs + 1, d)
    for g in range(1, gangs + 1):
        placed[g, g] = placed[g, 160 + g] = 1.0
    gid = torch.arange(b, dtype=torch.int32, device=device) % (gangs + 1)
    dom = (torch.arange(n, dtype=torch.int32, device=device) // 4)[None, :].contiguous()
    op = GangTerm(gid, dom, torch.ones(1, device=device), placed, placed.sum(dim=1),
                  torch.full((gangs + 1, 2), 100.0, device=device), torch.full((d, 2), 1e6, device=device),
                  torch.ones((gangs + 1, d), device=device), 64.0)
    return args, op


def topology_bound_ms(args: list, topo: GangTerm, cons_widths=None, cons_products: int = 0) -> dict:
    """``choose_bound_ms`` of the fused function with the gang term, whatever
    implements it: the term's ~10 float ops per level once per (distinct
    gang among the block's active pods, node) and one add per active pair;
    in the bytes each active pod's gang id, those gangs' per-domain rows
    (placed and herd) and totals and demands, every node's domain columns,
    the domain capacities and the level distances.  Beside it the bound
    before the redesign, which took the dense [G+1, N] term as given and
    counted its rows each tile reads (``tile_rows``) and one add per active
    pair."""
    active = args[8]
    a = int(active.sum())
    b, n, r = int(args[0].shape[0]), int(args[10].shape[0]), int(args[0].shape[1])
    widths = [int(args[i].shape[1]) for i in (1, 3, 4, 6, 7)]
    lv, dt = int(topo.dom_col.shape[0]), int(topo.placed.shape[1])
    gangs = distinct_gangs(topo.gang_id, active)
    new_bytes = 4 * a + 4 * lv * n + 8 * dt + 4 * lv + gangs * (8 * dt + 12)
    new_ops = a * n + gangs * n * 10 * lv
    bound, by = choose_bound_ms(b, n, r, widths, cons_widths, cons_products, a, new_bytes, new_ops)
    dense, dense_by = choose_bound_ms(b, n, r, widths, cons_widths, cons_products, a,
                                      4 * a + 4 * n * tile_rows(topo.gang_id, active), a * n)
    return {"bound_ms": bound, "bound_by": by, "distinct_gangs": gangs, "bound_ms_dense_term": dense,
            "bound_by_dense_term": dense_by}


def interleaved_ms(fns: dict, rounds: int = 5, reps: int = 50) -> dict:
    """{name: [ms per call in each round]}: CUDA events around ``reps``
    back-to-back calls of each function, the functions in turn, forwards
    and backwards in alternate rounds, after one warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {name: [] for name in fns}
    names = list(fns)
    for i in range(rounds):
        for name in names if i % 2 == 0 else names[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            out[name].append(start.elapsed_time(end) / reps)
    return out


def spread(times: list) -> dict:
    return {"median": statistics.median(times), "min": min(times), "max": max(times), "rounds": times}


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
    kernel (torch.profiler) split into the choose kernels, the matrix
    products (cuBLAS: only the domains' ``onehot @ free`` now), copies and
    the rest; the idle share; and the host clock of the term's per-round
    preparation (``gang_round_operands``: the demand adds and the domain
    capacities) and of the state update, timed by synchronising wrappers in
    a separate cycle."""
    wall_ms, rows = profiled(lambda: backend.schedule(packed, profile))
    split = device_split(wall_ms, rows, "choose_kernel")
    gemm_ms = sum(r[1] for r in rows if any(s in r[0].lower() for s in ("gemm", "xmma", "cutlass")))
    spent = {"gang_round_operands": [0.0, 0], "gang_state_update": [0.0, 0]}
    originals = {name: getattr(assign_mod, name) for name in spent}

    def timed(name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[name](*a, **k)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t
            spent[name][1] += 1
            return out
        return run

    for name in spent:
        setattr(assign_mod, name, timed(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend.schedule(packed, profile)
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(assign_mod, name, fn)
    prep_s, rounds = spent["gang_round_operands"]
    return dict(split, phase="topology_breakdown", term_matmul_ms=gemm_ms,
                term_elementwise_and_other_ms=split["other_device_ms"] - gemm_ms,
                instrumented_cycle_ms=cycle_ms, host_term_ms=prep_s * 1e3, term_calls=rounds,
                host_term_ms_per_round=prep_s * 1e3 / max(rounds, 1),
                host_state_update_ms=spent["gang_state_update"][0] * 1e3)


NAMES_BISECT = ("bisect_parts_v0", "bisect_parts_v1", "bisect_parts_v2", "bisect_parts_v3", "bisect_wide")


# ---- the controller (Scheduler over CudaBackend) ---------------------------

CHOOSE_COUNTERS = ("LAUNCHES", "LAUNCHES_CONSTRAINED", "LAUNCHES_TOPO", "LAUNCHES_CONSTRAINED_TOPO")


def zero_launches() -> None:
    for name in CHOOSE_COUNTERS:
        setattr(choose_mod, name, 0)


def read_launches() -> dict:
    """The choose wrappers' launch counts: #1, #2, #1t, #2t."""
    return {name.lower(): getattr(choose_mod, name) for name in CHOOSE_COUNTERS}


def oversubscribed_set(api) -> set:
    """Names of the nodes whose bound pods request more than the node
    allocates on some resource.  ``synth_cluster``'s round-robin binding
    starts some nodes so; a run must add none."""
    snap = ClusterSnapshot.build(api.list_nodes(), api.list_pods())
    out = set()
    for node in snap.nodes:
        net = node_net_available(snap, node)
        if net.cpu < 0 or net.memory < 0 or any(v < 0 for v in (net.extended or {}).values()):
            out.add(node.name)
    return out


def oversubscribed_nodes(api) -> int:
    """Nodes of the API's state whose bound pods request more than the node
    allocates on some resource."""
    return len(oversubscribed_set(api))


def renamed(pods: list, prefix: str) -> list:
    """Copies of ``pods`` named ``<prefix>-<name>`` (a fresh wave)."""
    return [dataclasses.replace(p, metadata=dataclasses.replace(p.metadata, name=f"{prefix}-{p.metadata.name}"))
            for p in pods]


def timed_cycle(sched, label: str, drain_s: float) -> tuple[dict, object]:
    """One ``run_cycle`` with its phase seconds, the upload bytes and the
    choose launches of the cycle; fails if a solve launched no kernel."""
    cuda_backend_mod.UPLOAD_BYTES = 0
    before = read_launches()
    t0 = time.perf_counter()
    m = sched.run_cycle()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in read_launches().items()}
    if m.pending and m.solve_seconds > 0 and launches["launches"] == 0:
        raise SystemExit(f"controller_e2e: cycle {label} solved without launching kernel #1 ({launches})")
    row = {
        "phase": "controller_e2e_cycle", "cycle": label, "wall_s": wall, "sync_s": m.sync_seconds,
        "overlay_s": m.overlay_seconds, "queue_s": m.queue_seconds, "pack_s": m.pack_seconds,
        "solve_s": m.solve_seconds, "bind_s": m.bind_seconds, "gang_s": m.gang_seconds, "slo_s": m.slo_seconds,
        "other_s": m.other_seconds, "pending": m.pending, "bound": m.bound, "unschedulable": m.unschedulable,
        "rounds": m.rounds, "prior_bind_drain_s": drain_s, "upload_bytes": cuda_backend_mod.UPLOAD_BYTES,
        "choose_launches": launches,
    }
    emit(row)
    return row, m


def join_timed(sched) -> float:
    t0 = time.perf_counter()
    sched._join_binds()
    return time.perf_counter() - t0


def controller_e2e(smi: str) -> dict:
    """bench.py's ``e2e_row`` on the port: the real Scheduler over
    ``CudaBackend`` against an in-process FakeApiServer at the flagship's
    size, pipelined binds, full-wave cycles.  A cold cycle, three fresh
    100,000-pod waves (template seed 1; the previous wave deleted off the
    clock after its binds drain), one more wave under torch.profiler, then
    three churn cycles of 10,000 pods that retire as many bound pods."""
    t0 = time.perf_counter()
    base = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=20_000, seed=0)
    template = synth_cluster(n_nodes=10_000, n_pending=100_000, n_bound=0, seed=1).pending_pods()
    api = FakeApiServer()
    api.load(base.nodes, base.pods)
    profile = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
    reference = CudaBackend().schedule(pack_snapshot(base), profile)
    setup_s = time.perf_counter() - t0
    enable_daemon_gc_tuning()  # what the CLI daemon runs with
    sched = Scheduler(api, CudaBackend(), profile=profile, requeue_seconds=0.0, pipeline=True, delta=False)
    metrics, rows = [], []
    zero_launches()
    row, m = timed_cycle(sched, "cold", 0.0)
    rows.append(row)
    metrics.append(m)
    if m.bound != len(reference.bindings):
        raise SystemExit(f"controller_e2e: the cold cycle bound {m.bound}, CudaBackend.schedule "
                         f"{len(reference.bindings)} on the same cluster")
    prev: list = []
    waves = []
    for w in range(3):
        drain = join_timed(sched)
        for p in prev:
            api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        prev = renamed(template, f"w{w}")
        for p in prev:
            api.create_pod(p)
        row, m = timed_cycle(sched, f"wave{w}", drain)
        waves.append(row)
        metrics.append(m)
    # One more wave under torch.profiler: the device's idle share.
    drain = join_timed(sched)
    for p in prev:
        api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
    prev = renamed(template, "w3")
    for p in prev:
        api.create_pod(p)
    before = read_launches()
    wall_ms, dev_rows = profiled(lambda: metrics.append(sched.run_cycle()))
    prof_launches = {k: v - before[k] for k, v in read_launches().items()}
    split = device_split(wall_ms, dev_rows, "choose_kernel")
    churn = 10_000
    churn_rows: list = []
    prev_churn: list = []
    for w in range(3):
        drain = join_timed(sched)
        for p in prev_churn + prev[w * churn:(w + 1) * churn]:
            api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        prev_churn = renamed(template[:churn], f"c{w}")
        for p in prev_churn:
            api.create_pod(p)
        row, m = timed_cycle(sched, f"churn{w}", drain)
        churn_rows.append(row)
        metrics.append(m)
    final_drain = join_timed(sched)
    launches = read_launches()
    coverage = sched.profile_ring.snapshot()["coverage"]
    counters = sched.metrics.snapshot()
    sched.close()
    bad = oversubscribed_nodes(api)
    fallbacks = counters.get("scheduler_backend_fallbacks_total", 0)
    backends = sorted({m.backend for m in metrics})
    if bad or fallbacks or backends != ["cuda"]:
        raise SystemExit(f"controller_e2e: {bad} oversubscribed nodes, {fallbacks} fallbacks, backends {backends}")
    drains = [r["prior_bind_drain_s"] for r in waves[1:]] + [drain]
    med = statistics.median
    return {
        "phase": "controller_e2e", "pods_per_wave": len(template), "nodes": len(base.nodes),
        "bound_pods": 20_000, "setup_s": setup_s, "cold_wall_s": rows[0]["wall_s"], "cold_bound": rows[0]["bound"],
        "reference_bound": len(reference.bindings),
        "wave_wall_median_s": med(r["wall_s"] for r in waves), "wave_wall_min_s": min(r["wall_s"] for r in waves),
        "wave_sync_median_s": med(r["sync_s"] for r in waves), "wave_pack_median_s": med(r["pack_s"] for r in waves),
        "wave_solve_median_s": med(r["solve_s"] for r in waves), "wave_bind_median_s": med(r["bind_s"] for r in waves),
        "wave_bind_drain_median_s": med(drains), "wave_bound": [r["bound"] for r in waves],
        "wave_upload_bytes": [r["upload_bytes"] for r in waves],
        "churn_pods": churn, "churn_wall_median_s": med(r["wall_s"] for r in churn_rows),
        "churn_bound": [r["bound"] for r in churn_rows], "churn_upload_bytes": [r["upload_bytes"] for r in churn_rows],
        "final_bind_drain_s": final_drain, "attribution_coverage": coverage,
        "profiled_wave": dict(split, choose_launches=prof_launches), "choose_launches_all_cycles": launches,
        "cycles": len(metrics), "oversubscribed_nodes": bad, "backend_fallbacks": fallbacks, "backends": backends,
        "nvidia_smi": smi,
    }


def run_settled(api, make_sched) -> dict:
    """Run the Scheduler ``make_sched(api)`` makes until settled, as the CLI
    does; the pod → node map, the cycle count, the bound count, the choose
    launches and the backends the cycles report."""
    sched = make_sched(api)
    zero_launches()
    t0 = time.perf_counter()
    try:
        metrics = sched.run(until_settled=True)
    finally:
        sched.close()
    seconds = time.perf_counter() - t0
    placement = {f"{p.metadata.namespace or 'default'}/{p.metadata.name}": p.spec.node_name if p.spec else None
                 for p in api.list_pods()}
    return {"placement": placement, "cycles": len(metrics), "bound": sum(m.bound for m in metrics),
            "launches": read_launches(), "seconds": seconds, "backends": sorted({m.backend for m in metrics})}


def loaded_api(nodes: list, pods: list):
    api = FakeApiServer()
    api.load(nodes, pods)
    return api


PARITY_CASES = ("mixed", "topology", "constrained_topology")
# The choose instance each case's cycles launch on the card: #2, #1t, #2t.
PARITY_KERNEL = {"mixed": "launches_constrained", "topology": "launches_topo",
                 "constrained_topology": "launches_constrained_topo"}
PARITY_PROFILE = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)


def parity_case(name: str, device: str) -> tuple:
    """(loaded API server, scheduler factory) of one ``controller_parity``
    case on ``device``: the CLI's mixed workload at 20,000 × 2,000 built as
    the CLI builds it (its defaults for ``--bound-pods``, ``--seed``,
    ``--profile`` and ``--policy``); bench.py's topology cluster at 8,192 ×
    512; that shape with the constrained row's fractions and gangs
    (synth, topology-labelled)."""
    if name == "mixed":
        args = cli_mod.build_parser().parse_args(
            ["--device", device, "--nodes", "2000", "--pods", "20000", "--workload", "mixed", "--no-delta"])
        return cli_mod.synthetic_api(args), lambda api: cli_mod.make_scheduler(args, api, cli_mod.make_cli_backend(args))
    if name == "topology":
        nodes, pods, _ = topology_objects(8192, 512, seed=0)
    else:
        snap = synth_cluster(n_nodes=512, n_pending=8192, seed=0, gang_fraction=0.35, **CONS_FRACTIONS)
        label_topology(snap.nodes)
        nodes, pods = snap.nodes, snap.pods
    return loaded_api(nodes, pods), lambda api: Scheduler(api, CudaBackend(device=device), profile=PARITY_PROFILE,
                                                          delta=False)


def cpu_reference() -> None:
    """The CPU half of ``controller_parity``, run in a child process beside
    the card half: prints one JSON line of each case's placement, cycles,
    bound count and seconds."""
    logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)
    torch.set_num_threads(4)
    out = {}
    for name in PARITY_CASES:
        run = run_settled(*parity_case(name, "cpu"))
        out[name] = {k: run[k] for k in ("placement", "cycles", "bound", "seconds", "backends")}
    for w in DELTA_RUNS:
        run = delta_churn_run("cpu", w)
        out[f"delta_{w}"] = {k: run[k] for k in ("cycles", "placement", "seconds")}
    print(json.dumps(out), flush=True)


def controller_parity(smi: str):
    """Card against CPU through the controller, to settlement, on
    :data:`PARITY_CASES`, and through the delta engine on
    :func:`delta_churn_run` (``delta_shadow`` and ``controller_delta_parity``);
    the CPU half runs in a child process (without a visible card) while the
    card half and the ``cli`` phase run here.  Returns the packed cluster
    of a constrained delta cycle's solve on the card."""
    with tempfile.TemporaryFile("w+") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.cpu_reference()"],
            cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=err, text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        )
        try:
            card = {name: run_settled(*parity_case(name, "cuda")) for name in PARITY_CASES}
            cli_rec = cli_phase(smi, card["mixed"]["bound"])
            delta_card = {w: delta_churn_run("cuda", w, keep=lambda packed: packed.constraints is not None)
                          for w in DELTA_RUNS}
            out, _ = child.communicate(timeout=900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if child.returncode != 0:
            err.seek(0)
            raise SystemExit(f"controller_parity: the CPU run failed ({child.returncode}): {err.read()[-3000:]}")
    cpu_runs = json.loads(out.strip().splitlines()[-1])
    for name in PARITY_CASES:
        c, r = card[name], cpu_runs[name]
        equal = c["placement"] == r["placement"] and c["cycles"] == r["cycles"]
        rec = {"phase": "controller_parity", "case": name, "pods": len(c["placement"]), "equal": equal,
               "cycles": c["cycles"], "bound": c["bound"], "card_seconds": c["seconds"],
               "cpu_seconds": r["seconds"], "card_launches": c["launches"], "backends": c["backends"],
               "nvidia_smi": smi}
        emit(rec)
        if not equal or c["backends"] != ["cuda"]:
            raise SystemExit(f"controller_parity {name}: card and CPU differ (cycles {c['cycles']} / "
                             f"{r['cycles']}, bound {c['bound']} / {r['bound']})")
        if c["launches"][PARITY_KERNEL[name]] == 0:
            raise SystemExit(f"controller_parity {name}: the card run launched no {PARITY_KERNEL[name]} "
                             f"({c['launches']})")
    emit(cli_rec)
    delta_parity_check(delta_card, cpu_runs, smi)
    return delta_card["mixed"]["kept"]


def cli_phase(smi: str, expected_bound: int) -> dict:
    """The port's CLI on the card in a subprocess, on the mixed workload of
    ``controller_parity``; its summary's ``bound_total`` must equal that
    phase's card run."""
    cmd = [sys.executable, "-m", "tpu_scheduler_torch.cli", "--backend", "cuda", "--nodes", "2000", "--pods",
           "20000", "--workload", "mixed", "--no-delta", "--log-level", "ERROR"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not summary.get("summary") or summary.get("bound_total") != expected_bound:
        raise SystemExit(f"cli: rc {proc.returncode}, bound_total {summary.get('bound_total')} (expected "
                         f"{expected_bound}); stderr tail: {proc.stderr[-2000:]}")
    return {"phase": "cli", "command": " ".join(cmd[1:]), "seconds": seconds, "cycles": summary["cycles"],
            "bound_total": summary["bound_total"], "unschedulable_last": summary["unschedulable_last"],
            "nvidia_smi": smi}


# ---- the delta engine, checkpoints and the HTTP boundary -----------------


class RecordingBackend(CudaBackend):
    """``CudaBackend`` that notes the shape of every packed cluster it
    solves, counts the choose launches of its own solves (a fleet
    replica's), and keeps the first packed cluster that ``keep(packed)``
    accepts (the operands of ``kernel_vs_plain_delta`` and
    ``kernel_vs_plain_fleet``); the solve is CudaBackend's."""

    def __init__(self, keep=None, **kw):
        super().__init__(**kw)
        self.keep = keep
        self.kept = None
        self.shapes: list = []
        self.launches = {name.lower(): 0 for name in CHOOSE_COUNTERS}

    def assign(self, packed, profile):
        self.shapes.append((packed.padded_pods, packed.padded_nodes, len(packed.node_names)))
        if self.kept is None and self.keep is not None and self.keep(packed):
            self.kept = packed
        before = read_launches()
        try:
            return super().assign(packed, profile)
        finally:
            for k, v in read_launches().items():
                self.launches[k] += v - before[k]


def delta_row(sched, label: str, seconds: float, m, before: dict, node_axes: list) -> dict:
    """One delta-phase cycle's record: wall, the phases, the engine's plan,
    kernel #1 launches, upload bytes and the solved node axes."""
    launches = {k: v - before[k] for k, v in read_launches().items()}
    stats = sched.delta.stats()
    return {
        "phase": "controller_delta_cycle", "cycle": label, "wall_s": seconds, "sync_s": m.sync_seconds,
        "delta_s": m.delta_seconds, "pack_s": m.pack_seconds, "solve_s": m.solve_seconds,
        "bind_s": m.bind_seconds, "slo_s": m.slo_seconds, "other_s": m.other_seconds, "pending": m.pending,
        "bound": m.bound, "unschedulable": m.unschedulable, "rounds": m.rounds,
        "dirty": stats["dirty_sizes"][-1] if stats["dirty_sizes"] and sched._delta_plan is not None else None,
        "full_solve": sched._delta_plan is None, "choose_launches": launches,
        "upload_bytes": cuda_backend_mod.UPLOAD_BYTES, "node_axes": node_axes,
    }


def controller_delta(smi: str) -> tuple[dict, object]:
    """bench.py's ``incremental_row`` on the port at the flagship size: the
    Scheduler over ``CudaBackend`` with the delta engine (the default), a
    cold full wave over 100,000 pending pods × 10,000 nodes × 20,000 bound,
    then 10 steady cycles of 1,000 fresh pods (template seed 1, renamed; as
    many pods of the first wave and the previous arrivals retired off the
    clock), 3 bursts of 10,000, and one more steady cycle under
    torch.profiler.  Returns the record and the packed cluster of a steady
    cycle's solve (its compacted node axis when compaction paid)."""
    from tpu_scheduler_torch.utils.profiler import compile_stats

    t0 = time.perf_counter()
    pods, nodes = 100_000, 10_000
    base = synth_cluster(n_nodes=nodes, n_pending=pods, n_bound=20_000, seed=0)
    wave = synth_cluster(n_nodes=nodes, n_pending=pods, n_bound=0, seed=1).pending_pods()
    api = FakeApiServer()
    api.load(base.nodes, base.pods)
    retire_pool = [p for p in base.pods if p.spec is not None and p.spec.node_name is None]
    setup_s = time.perf_counter() - t0
    profile = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
    steady_n = 5  # the steady cycle whose solve kernel_vs_plain_delta replays
    backend = RecordingBackend()
    sched = Scheduler(api, backend, profile=profile, requeue_seconds=0.0)
    if sched.delta is None:
        raise SystemExit("controller_delta: the Scheduler runs without the delta engine")
    zero_launches()
    state = {"prev": [], "retire_from": 0, "wave_n": 0}
    rows: list = []

    def churn(n: int) -> None:
        """Off the clock: retire the previous arrivals and ``n`` pods of the
        first wave, arrive ``n`` fresh pods."""
        w = state["wave_n"] = state["wave_n"] + 1
        for p in state["prev"]:
            api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        rf = state["retire_from"]
        for p in retire_pool[rf:rf + n]:
            api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        state["retire_from"] = rf + n
        state["prev"] = renamed(wave[:n], f"i{w}")
        for p in state["prev"]:
            api.create_pod(p)

    def cycle(label: str):
        cuda_backend_mod.UPLOAD_BYTES = 0
        before = read_launches()
        n0 = len(backend.shapes)
        c0 = time.perf_counter()
        m = sched.run_cycle()
        row = delta_row(sched, label, time.perf_counter() - c0, m, before, backend.shapes[n0:])
        emit(row)
        rows.append(row)
        if row["dirty"] and m.solve_seconds > 0 and row["choose_launches"]["launches"] == 0:
            raise SystemExit(f"controller_delta: cycle {label} solved {row['dirty']} dirty pods without "
                             f"launching kernel #1 ({row['choose_launches']})")
        return m

    cycle("cold")
    builds_cold = compile_stats()["builds"]
    for i in range(10):
        churn(1_000)
        if i == steady_n:
            backend.keep = lambda packed: packed.constraints is None
        cycle(f"steady{i}")
        backend.keep = None
    for i in range(3):
        churn(10_000)
        cycle(f"burst{i}")
    churn(1_000)
    before = read_launches()
    holder: list = []
    wall_ms, dev_rows = profiled(lambda: holder.append(sched.run_cycle()))
    split = device_split(wall_ms, dev_rows, "choose_kernel")
    prof_launches = {k: v - before[k] for k, v in read_launches().items()}
    launches = read_launches()
    stats = sched.delta.stats()
    counters = sched.metrics.snapshot()
    sched.close()
    bad = oversubscribed_nodes(api)
    fallbacks = counters.get("scheduler_backend_fallbacks_total", 0)
    if bad or fallbacks:
        raise SystemExit(f"controller_delta: {bad} oversubscribed nodes, {fallbacks} fallbacks")
    if launches["launches"] == 0:
        raise SystemExit("controller_delta: the run launched kernel #1 no time")
    steady = [r for r in rows if r["cycle"].startswith("steady")]
    burst = [r for r in rows if r["cycle"].startswith("burst")]
    sizes = sorted(stats["dirty_sizes"])
    total = stats["delta_cycles"] + stats["full_solves"]
    med = statistics.median

    def pct(q: float) -> int:
        return sizes[min(len(sizes) - 1, int(q * (len(sizes) - 1)))] if sizes else 0

    rec = {
        "phase": "controller_delta", "pods": pods, "nodes": nodes, "bound_pods": 20_000, "setup_s": setup_s,
        "cold_wall_s": rows[0]["wall_s"], "cold_bound": rows[0]["bound"],
        "steady_wall_median_s": med(r["wall_s"] for r in steady), "steady_wall_min_s": min(r["wall_s"] for r in steady),
        "burst_wall_median_s": med(r["wall_s"] for r in burst),
        "steady_phases_median_s": {ph: med(r[f"{ph}_s"] for r in steady)
                                   for ph in ("sync", "delta", "pack", "solve", "bind", "slo", "other")},
        "burst_phases_median_s": {ph: med(r[f"{ph}_s"] for r in burst)
                                  for ph in ("sync", "delta", "pack", "solve", "bind", "slo", "other")},
        "full_solve_fraction": stats["full_solves"] / total if total else None,
        "escalations": stats["full_solve_reasons"], "dirty_p50": pct(0.50), "dirty_p95": pct(0.95),
        "kernel_builds_after_cold": compile_stats()["builds"] - builds_cold,
        "steady_launches": [r["choose_launches"]["launches"] for r in steady],
        "steady_upload_bytes": [r["upload_bytes"] for r in steady],
        "burst_upload_bytes": [r["upload_bytes"] for r in burst],
        "steady_node_axes": [sorted({a[1] for a in r["node_axes"]}) for r in steady],
        "node_compactions": counters.get("scheduler_delta_node_compactions_total", 0),
        "profiled_cycle": dict(split, choose_launches=prof_launches, wall_s=wall_ms / 1e3,
                               bound=holder[0].bound if holder else None),
        "choose_launches_all_cycles": launches, "oversubscribed_nodes": bad, "backend_fallbacks": fallbacks,
        "nvidia_smi": smi,
    }
    return rec, backend.kept


# The two delta parity runs, at 5,000 pending pods × 500 nodes with 500-pod
# churn of the same workload less its cross-node constraints: "mixed" is
# the CLI's mixed workload, whose delta cycles are constrained (kernel #2),
# and whose shadow checks the engine skips by its contract (the stall
# mop-up runs outside the solver); "node_local" keeps every term that is
# local to a node — selectors, taints, node affinity hard and soft, soft
# taints, gangs, extended resources — so its delta cycles run kernel #1 and
# every one is held against the full solve.
DELTA_RUNS = ("mixed", "node_local")
NODE_LOCAL = dict(selector_fraction=0.25, tainted_fraction=0.15, node_affinity_fraction=0.15,
                  soft_taint_fraction=0.15, preferred_affinity_fraction=0.15, gang_fraction=0.1,
                  extended_fraction=0.15)
DELTA_KERNEL = {"mixed": "launches_constrained", "node_local": "launches"}


def delta_churn_run(device: str, workload: str, keep=None) -> dict:
    """One delta parity run on ``device`` through the CLI's Scheduler
    (delta on, ``delta_shadow_every=1``): a cold cycle, then 5 churn cycles
    that retire 500 pods of the first wave and the previous arrivals and
    arrive 500 fresh pods.  Per cycle the bindings made (as a digest and a
    count) and ``delta.stats()``; the final pod → node map."""
    import hashlib

    args = cli_mod.build_parser().parse_args(
        ["--device", device, "--nodes", "500", "--pods", "5000", "--workload", "mixed" if workload == "mixed"
         else "plain", "--log-level", "ERROR"])
    if workload == "mixed":
        api = cli_mod.synthetic_api(args)
    else:
        snap = synth_cluster(n_nodes=500, n_pending=5_000, seed=0, **NODE_LOCAL)
        api = loaded_api(snap.nodes, snap.pods)
    backend = RecordingBackend(device=device)
    sched = cli_mod.make_scheduler(args, api, backend)
    sched.delta_shadow_every = 1
    template = synth_cluster(n_nodes=500, n_pending=2_500, seed=1, **NODE_LOCAL).pending_pods()
    retire = [p for p in api.list_pods() if p.spec is not None and p.spec.node_name is None]
    zero_launches()
    prev: list = []
    cycles = []
    t0 = time.perf_counter()

    def placed() -> dict:
        return {f"{p.metadata.namespace or 'default'}/{p.metadata.name}": p.spec.node_name
                for p in api.list_pods() if p.spec is not None and p.spec.node_name}

    try:
        for c in range(6):
            if c:
                backend.keep = keep  # the delta cycles' solves, not the cold wave's
                for p in prev + retire[(c - 1) * 500:c * 500]:
                    api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
                prev = renamed(template[(c - 1) * 500:c * 500], f"d{c}")
                for p in prev:
                    api.create_pod(p)
            before = placed()
            m = sched.run_cycle()
            made = sorted((k, v) for k, v in placed().items() if before.get(k) != v)
            cycles.append({"bound": m.bound, "unschedulable": m.unschedulable, "made": len(made),
                           "digest": hashlib.sha256(json.dumps(made).encode()).hexdigest()[:16],
                           "stats": sched.delta.stats()})
    finally:
        sched.close()
    return {"cycles": cycles, "placement": placed(), "seconds": time.perf_counter() - t0,
            "launches": read_launches(), "fallbacks": sched.metrics.snapshot().get(
                "scheduler_backend_fallbacks_total", 0), "kept": backend.kept}


def delta_parity_check(card: dict, cpu: dict, smi: str) -> None:
    """``delta_shadow`` from the card runs, ``controller_delta_parity`` of
    each card run against the CPU child's."""
    finals = {w: card[w]["cycles"][-1]["stats"] for w in DELTA_RUNS}
    checks = sum(f["shadow_checks"] for f in finals.values())
    mismatches = sum(f["shadow_mismatches"] for f in finals.values())
    emit({"phase": "delta_shadow", "pods": 5000, "nodes": 500, "cycles": 6,
          "runs": {w: {k: f[k] for k in ("shadow_checks", "shadow_mismatches", "shadow_skipped", "delta_cycles",
                                         "full_solve_reasons")} for w, f in finals.items()},
          "shadow_checks": checks, "shadow_mismatches": mismatches, "nvidia_smi": smi})
    if mismatches or not checks:
        raise SystemExit(f"delta_shadow: {mismatches} mismatches in {checks} checks")
    for w in DELTA_RUNS:
        c, r = card[w], cpu[f"delta_{w}"]
        equal = c["cycles"] == r["cycles"] and c["placement"] == r["placement"]
        emit({"phase": "controller_delta_parity", "workload": w, "pods": 5000, "nodes": 500, "equal": equal,
              "per_cycle_bound": [x["bound"] for x in c["cycles"]], "dirty_sizes": finals[w]["dirty_sizes"],
              "card_seconds": c["seconds"], "cpu_seconds": r["seconds"], "card_launches": c["launches"],
              "backend_fallbacks": c["fallbacks"], "nvidia_smi": smi})
        if not equal or c["fallbacks"]:
            diff = [i for i, (a, b) in enumerate(zip(c["cycles"], r["cycles"])) if a != b]
            raise SystemExit(f"controller_delta_parity {w}: card and CPU differ at cycles {diff}")
        if c["launches"][DELTA_KERNEL[w]] == 0:
            raise SystemExit(f"controller_delta_parity {w}: the card run launched no {DELTA_KERNEL[w]} "
                             f"({c['launches']})")


def kernel_vs_plain_delta(plain_packed, cons_packed, profile, device) -> None:
    """Kernels #1 and #2 held bit for bit against their plain versions on
    operands captured from delta cycles: #1 at a steady cycle of
    ``controller_delta`` (its dirty pod block against its compacted node
    axis), #2 at a constrained delta cycle of ``delta_shadow``."""
    if plain_packed is None or cons_packed is None:
        raise SystemExit("kernel_vs_plain_delta: a delta cycle's solve was not captured")
    arrays = to_device(plain_packed, device)
    b = min(8192, plain_packed.padded_pods)
    compare("delta_steady_block", block_args(arrays, 0, b), profile.weights(), salt=1, phase="kernel_vs_plain_delta",
            kernel="choose", nodes_real=len(plain_packed.node_names), active=int(plain_packed.pod_valid[:b].sum()))
    carrays, masks = constrained_round(cons_packed, device)
    cb = min(8192, cons_packed.padded_pods)
    compare_constrained("delta_constrained_block", block_args(carrays, 0, cb), block_cons(carrays, 0, cb), masks,
                        PROFILES["default"].weights(), salt=1, phase="kernel_vs_plain_delta",
                        kernel="choose_constrained", active=int(cons_packed.pod_valid[:cb].sum()))


def write_kubeconfig(path: pathlib.Path, server: str, token: str) -> None:
    """A kubeconfig for ``server`` with a bearer token, written as JSON — a
    subset of YAML that kubectl reads, and that the port reads without
    PyYAML."""
    path.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "local", "user": "smoke"}}],
        "clusters": [{"name": "local", "cluster": {"server": server}}],
        "users": [{"name": "smoke", "user": {"token": token}}],
    }))


def http_cluster():
    """bench.py's CPU e2e shape: 10,000 pending pods × 1,000 nodes × 2,000
    bound, seed 0, in a fresh FakeApiServer."""
    snap = synth_cluster(n_nodes=1_000, n_pending=10_000, n_bound=2_000, seed=0)
    return loaded_api(snap.nodes, snap.pods)


def placement_of(api) -> dict:
    return {f"{p.metadata.namespace or 'default'}/{p.metadata.name}": p.spec.node_name if p.spec else None
            for p in api.list_pods()}


def cli_over_http(*flags: str) -> dict:
    """``python -m tpu_scheduler_torch.cli`` on the card in a child process
    with ``flags``: its summary, per-cycle lines and wall seconds."""
    cmd = [sys.executable, "-m", "tpu_scheduler_torch.cli", "--log-level", "ERROR", *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines or not lines[-1].get("summary"):
        raise SystemExit(f"controller_http: the CLI failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    return {"summary": lines[-1], "cycles": lines[:-1], "seconds": seconds}


def controller_http(smi: str, tmp: pathlib.Path) -> dict:
    """The port's CLI on the card against an HTTP API server through a
    kubeconfig with a bearer token, until settled with delta on: its
    bindings, read back from the server, equal an in-process Scheduler's
    with the CLI's profile and settings.  Then ``--checkpoint-dir``: a run
    of one cycle saves at exit, a second restores (first cycle "restore")
    and ends with the uninterrupted run's bindings."""
    import importlib.util

    from tpu_scheduler_torch.runtime.http_api import HttpApiServer

    pyyaml = importlib.util.find_spec("yaml") is not None

    api = http_cluster()
    server = HttpApiServer(api).start()
    cfg = tmp / "kubeconfig"
    write_kubeconfig(cfg, server.base_url, "smoke-token")
    try:
        run = cli_over_http("--kubeconfig", str(cfg))
        remote = placement_of(api)
    finally:
        server.stop()
    args = cli_mod.build_parser().parse_args(["--log-level", "ERROR"])
    local_api = http_cluster()
    t0 = time.perf_counter()
    sched = cli_mod.make_scheduler(args, local_api, CudaBackend())
    try:
        local_cycles = sched.run(until_settled=True)
    finally:
        sched.close()
    local_s = time.perf_counter() - t0
    equal = remote == placement_of(local_api)
    ck = tmp / "checkpoint"
    api2 = http_cluster()
    server2 = HttpApiServer(api2).start()
    write_kubeconfig(cfg, server2.base_url, "smoke-token")
    try:
        first = cli_over_http("--kubeconfig", str(cfg), "--checkpoint-dir", str(ck), "--cycles", "1")
        second = cli_over_http("--kubeconfig", str(cfg), "--checkpoint-dir", str(ck))
        restarted = placement_of(api2)
    finally:
        server2.stop()
    restore = second["summary"]["counters"].get('scheduler_full_solves_total{reason="restore"}', 0)
    restart_equal = restarted == remote
    cyc = run["cycles"]
    bind_s = sum(c["bind_seconds"] for c in cyc)
    rec = {
        "phase": "controller_http", "pods": 10_000, "nodes": 1_000, "bound_pods": 2_000, "pyyaml": pyyaml,
        "kubeconfig_format": "json", "cli_seconds": run["seconds"], "cli_cycles": run["summary"]["cycles"],
        "cli_bound": run["summary"]["bound_total"], "http_sync_first_s": cyc[0]["sync_seconds"] if cyc else None,
        "http_sync_later_s": [c["sync_seconds"] for c in cyc[1:]], "bind_s": bind_s,
        "bind_posts_per_s": run["summary"]["bound_total"] / bind_s if bind_s else None,
        "cycle_walls_s": [c["wall_seconds"] for c in cyc], "in_process_seconds": local_s,
        "in_process_cycles": len(local_cycles), "equal": equal,
        "checkpoint_first_seconds": first["seconds"], "checkpoint_second_seconds": second["seconds"],
        "checkpoint_first_cycles": first["summary"]["cycles"], "restart_cycles": second["summary"]["cycles"],
        "restart_restore_escalations": restore, "restart_equal": restart_equal,
        "fallbacks": [r["summary"]["counters"].get("scheduler_backend_fallbacks_total", 0)
                      for r in (run, first, second)],
        "nvidia_smi": smi,
    }
    if not equal or not restart_equal or restore != 1 or any(rec["fallbacks"]) or not run["summary"]["bound_total"]:
        emit(rec)
        raise SystemExit(f"controller_http: equal {equal}, restart_equal {restart_equal}, restore {restore}")
    return rec


# ---- the simulator ---------------------------------------------------------

# bench.py's sim rows at their own sizes (sim_row: sim-smoke seed 0;
# sim_sweep_row: sim-smoke and api-brownout-recovery, seeds 0-2;
# latency_row: the arrival-rate-sweep family at 5, 15 and 40 pods/s, seed
# 0), the delta engine's gate scenario, a topology scenario, and
# steady-state (whose pass holds the profile block's >= 90 % attribution
# and the compile block's zero kernel builds after warm-up): (row, scenario
# key, seed).
SIM_EPISODES = (
    ("sim_row", "sim-smoke", 0),
    ("sim_sweep_row", "sim-smoke", 1),
    ("sim_sweep_row", "sim-smoke", 2),
    ("sim_sweep_row", "api-brownout-recovery", 0),
    ("sim_sweep_row", "api-brownout-recovery", 1),
    ("sim_sweep_row", "api-brownout-recovery", 2),
    ("latency_row", "arrival-rate-5", 0),
    ("latency_row", "arrival-rate-15", 0),
    ("latency_row", "arrival-rate-40", 0),
    ("delta_gate", "churn-steady-state", 0),
    ("topology", "slice-fragmented-cluster", 0),
    ("profile_gate", "steady-state", 0),
)
# sim-smoke at a real cluster size: 5,000 nodes, the upper bound of a
# cluster in Kubernetes' "Considerations for large clusters".
SIM_SCALE = 25
SIM_SCALED = ("scaled", f"sim-smoke-x{SIM_SCALE}", 0)
# Scorecard fields that may differ between a card run and the same run on
# the CPU, each with its reason.
SIM_CARD_VS_CPU = {
    "/compile/enabled": "the card run counts its kernel builds (compile_listener_active); the CPU builds none",
}


def sim_scenario(key: str):
    """The scenario a key names: a registered one, an arrival-rate-sweep
    variant (``arrival-rate-<rate>``), or sim-smoke scaled ×k
    (``sim-smoke-x<k>``: initial nodes, arrival rate, the burst and the node
    churn rates ×k; the chaos window, the other fields and the seed as
    registered)."""
    if key in SCENARIOS:
        return SCENARIOS[key]
    if key.startswith("arrival-rate-"):
        return arrival_rate_variant(float(key.rpartition("-")[2]))
    k = int(key.rpartition("-x")[2])
    base = SCENARIOS["sim-smoke"]
    w = base.workload
    return dataclasses.replace(base, name=key, description=f"sim-smoke x{k}", workload=dataclasses.replace(
        w, initial_nodes=w.initial_nodes * k, arrival_rate=w.arrival_rate * k,
        bursts=tuple((t, n * k) for t, n in w.bursts), node_flap_rate=w.node_flap_rate * k,
        node_fail_rate=w.node_fail_rate * k, node_add_rate=w.node_add_rate * k))


def sim_episode(key: str | None, seed: int, backend=None, record=None, replay=None) -> dict:
    """One episode through ``sim.harness.scenario_episode`` (``backend``
    None: the harness's default, ``CudaBackend()`` on the card): its card,
    wall seconds, the seconds inside the controller's ``run_cycle`` (the
    rest of the wall is the harness's own: op application and folding each
    cycle, then the verdict), the verdict's seconds (the scorecard after the
    last cycle), the device the scheduler ran on, and the API server's last
    resourceVersion (the events the watches carried)."""
    gen = sim_harness.scenario_episode(None if key is None else sim_scenario(key), seed=seed, backend=backend,
                                       record=record, replay=replay)
    t0 = time.perf_counter()
    ctx = next(gen)
    sched = ctx.fleet.primary
    run_cycle, spent = sched.run_cycle, [0.0]

    def timed_cycle():
        t = time.perf_counter()
        try:
            return run_cycle()
        finally:
            spent[0] += time.perf_counter() - t

    sched.run_cycle = timed_cycle
    try:
        while True:
            t_send, spent_before = time.perf_counter(), spent[0]
            gen.send(None)
    except StopIteration as stop:
        card = stop.value
    t_end = time.perf_counter()
    return {"card": card, "wall_s": t_end - t0, "controller_s": spent[0],
            "verdict_s": t_end - t_send - (spent[0] - spent_before), "device": sched.backend.device.type,
            "api_events": ctx.api.list_pods_with_rv()[1]}


def sim_cores() -> tuple[set, set]:
    """(the card episodes' cores, the CPU references' cores): two cores for
    the card's host-bound episodes and the rest for the two CPU children,
    so that the two sides run at once without sharing a core; all cores
    for both on a host with fewer than six."""
    cores = sorted(os.sched_getaffinity(0))
    return (set(cores[:2]), set(cores[2:])) if len(cores) >= 6 else (set(cores), set(cores))


def sim_cpu_reference(which: str, trace_dir: str) -> None:
    """The CPU half of the ``sim`` phase, in a child process without a
    visible card, on :func:`sim_cores`' second set: ``small`` runs
    :data:`SIM_EPISODES` (recording sim-smoke seed 0's trace under
    ``trace_dir``), ``scaled`` the ×25 episode.  Prints one JSON line: each
    episode's card, wall and controller seconds."""
    logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)
    os.sched_setaffinity(0, sim_cores()[1])
    torch.set_num_threads(4 if which == "scaled" else 2)
    out = {}
    for _row, key, seed in (SIM_EPISODES if which == "small" else (SIM_SCALED,)):
        record = os.path.join(trace_dir, "cpu.jsonl") if (key, seed) == ("sim-smoke", 0) else None
        run = sim_episode(key, seed, CudaBackend(device="cpu"), record=record)
        out[f"{key}:{seed}"] = {k: run[k] for k in ("card", "wall_s", "controller_s", "verdict_s", "device")}
    print(json.dumps(out), flush=True)


def sim_diff(a, b, path: str = "") -> list:
    """Paths where two scorecards differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [q for k in sorted(set(a) | set(b))
                for q in ([f"{path}/{k}"] if k not in a or k not in b else sim_diff(a[k], b[k], f"{path}/{k}"))]
    return [] if a == b else [path]


def sim_phase(smi: str, tmp: pathlib.Path) -> dict:
    """The port's simulator on the card: every episode of
    :data:`SIM_EPISODES` and the ×25 episode, each held against the same
    episode on the CPU (two child processes, run beside the card episodes
    on cores of their own, :func:`sim_cores`):
    fingerprints equal, scorecards equal outside :data:`SIM_CARD_VS_CPU`,
    both passing; the delta gate and the locality gate; a card-recorded
    trace replayed on the CPU and a CPU-recorded one on the card; the
    harness's default backend on the card; one sim-smoke episode under
    torch.profiler.
    Returns the phase's kernel launches on the card (#1, #1t)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    root = pathlib.Path(__file__).resolve().parent
    children, errs = {}, {}
    for which in ("scaled", "small"):
        errs[which] = tempfile.TemporaryFile("w+")
        children[which] = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.sim_cpu_reference({which!r}, {str(tmp)!r})"],
            cwd=root, stdout=subprocess.PIPE, stderr=errs[which], text=True, env=env,
        )
    card_cores, _ = sim_cores()
    all_cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, card_cores)
    try:
        card_runs, launches = {}, {}
        for row, key, seed in SIM_EPISODES + (SIM_SCALED,):
            zero_launches()
            backend = None if row == "sim_row" else CudaBackend()  # sim_row: the harness's default
            record = str(tmp / "card.jsonl") if (key, seed) == ("sim-smoke", 0) else None
            run = sim_episode(key, seed, backend, record=record)
            launches[f"{key}:{seed}"] = read_launches()
            if run["device"] != "cuda":
                raise SystemExit(f"sim {key} seed {seed}: the scheduler ran on {run['device']}, not the card")
            card_runs[f"{key}:{seed}"] = run
        cpu_runs = {}
        for which, child in children.items():
            out, _ = child.communicate(timeout=900)
            if child.returncode != 0:
                errs[which].seek(0)
                raise SystemExit(f"sim: the CPU run ({which}) failed ({child.returncode}): {errs[which].read()[-3000:]}")
            cpu_runs.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        os.sched_setaffinity(0, all_cores)
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
        for f in errs.values():
            f.close()

    totals = {"launches": 0, "launches_topo": 0, "launches_constrained": 0, "launches_constrained_topo": 0}
    for row, key, seed in SIM_EPISODES + (SIM_SCALED,):
        name = f"{key}:{seed}"
        c, r, n = card_runs[name], cpu_runs[name], launches[name]
        cc, rc = c["card"], r["card"]
        for k in totals:
            totals[k] += n[k]
        differing = [q for q in sim_diff(cc, rc) if q not in SIM_CARD_VS_CPU]
        rec = {"phase": "sim_episode", "row": row, "scenario": key, "seed": seed, "device": c["device"],
               "wall_s": c["wall_s"], "cpu_wall_s": r["wall_s"], "cycles": cc["cycles"],
               "cycles_per_s": cc["cycles"] / c["wall_s"], "virtual_s": cc["virtual_seconds"], "pass": cc["pass"],
               "cpu_pass": rc["pass"], "controller_s": c["controller_s"],
               "controller_share": c["controller_s"] / c["wall_s"], "verdict_s": c["verdict_s"],
               "cpu_controller_s": r["controller_s"], "cpu_verdict_s": r["verdict_s"],
               "launches_choose": n["launches"], "launches_choose_topology": n["launches_topo"],
               "launches_constrained": n["launches_constrained"] + n["launches_constrained_topo"],
               "bound": cc["pods"]["bound_total"], "p99_ttb_s": cc["slo"]["p99_time_to_bind_s"],
               "full_solve_fraction": cc["incremental"]["full_solve_fraction"], "api_events": c["api_events"],
               "fingerprint": cc["fingerprint"][:16], "fingerprint_equal": cc["fingerprint"] == rc["fingerprint"],
               "differing_fields": differing, "nvidia_smi": smi}
        emit(rec)
        if not (rec["fingerprint_equal"] and not differing and cc["pass"] and rc["pass"]):
            raise SystemExit(f"sim {name}: card and CPU differ ({differing}) or a verdict failed "
                             f"(card pass {cc['pass']}, CPU pass {rc['pass']})")
        if n["launches"] + n["launches_topo"] == 0:
            raise SystemExit(f"sim {name}: the card episode launched no choose kernel ({n})")
        if row == "delta_gate":
            inc = cc["incremental"]
            if not (inc["ok"] and inc["shadow_checks"] > 0 and inc["shadow_mismatches"] == 0
                    and inc["full_solve_fraction"] <= 0.10):
                raise SystemExit(f"sim {name}: the delta gate failed on the card: {inc}")
        if row == "profile_gate" and not (cc["profile"]["coverage_ok"] and cc["compile"]["enabled"]
                                         and cc["compile"]["ok"]):
            raise SystemExit(f"sim {name}: the profile or compile gate failed on the card: "
                             f"{cc['profile']['coverage_ok']}, {cc['compile']}")
        if row == "topology":
            loc = cc["locality"]
            if not (loc["required"] and loc["gangs_scored"] > 0 and loc["cross_rack_gangs"] == 0):
                raise SystemExit(f"sim {name}: the locality gate failed on the card: {loc}")
            if n["launches_topo"] == 0:
                raise SystemExit(f"sim {name}: the topology episode launched no #1t ({n})")

    # Traces across devices: the card's recording replayed on the CPU, the
    # CPU's on the card.
    on_cpu = sim_episode(None, 0, CudaBackend(device="cpu"), replay=str(tmp / "card.jsonl"))
    zero_launches()
    on_card = sim_episode(None, 0, CudaBackend(), replay=str(tmp / "cpu.jsonl"))
    replay_launches = read_launches()
    recorded = card_runs["sim-smoke:0"]["card"]["fingerprint"]
    replays = {"card_trace_on_cpu": on_cpu["card"]["fingerprint"] == recorded,
               "cpu_trace_on_card": on_card["card"]["fingerprint"] == recorded}
    emit({"phase": "sim_replay", **replays, "card_replay_wall_s": on_card["wall_s"],
          "cpu_replay_wall_s": on_cpu["wall_s"], "launches": replay_launches, "nvidia_smi": smi})
    if not all(replays.values()):
        raise SystemExit(f"sim replay across devices diverged: {replays}")

    # One sim-smoke episode under torch.profiler: the device's idle share.
    zero_launches()
    prof_run = {}
    wall_ms, rows = profiled(lambda: prof_run.update(sim_episode("sim-smoke", 0, CudaBackend())))
    split = device_split(wall_ms, rows, "choose_kernel")
    emit({"phase": "sim_profile", "scenario": "sim-smoke", "seed": 0, **split,
          "controller_share": prof_run["controller_s"] / prof_run["wall_s"], "launches": read_launches(),
          "fingerprint_equal": prof_run["card"]["fingerprint"] == recorded, "nvidia_smi": smi})
    if prof_run["card"]["fingerprint"] != recorded:
        raise SystemExit("sim: the profiled sim-smoke episode departed from the unprofiled one")
    return totals


# ---- the sharded control plane and the fleet -------------------------------

# bench.py's multi-replica rows and the fleet phase: 4 lease-owned shards,
# 5 s leases, racks of 32 nodes (``multi_mesh_row``'s labelling).
FLEET_SHARDS, FLEET_LEASE, FLEET_RACK = 4, 5.0, 32
# The five scenarios with more than one replica.
MULTI_SCENARIOS = ("replica-kill-mid-cycle", "mesh-rebind-on-takeover", "cross-shard-gang-admission",
                   "replica-kill-during-brownout", "lease-brownout-during-takeover")
# The pinned campaign of ``make fuzz-smoke``: seed 0, 24 plans.
FUZZ_BUDGET = 24


def rack_label(nodes) -> None:
    """Racks of :data:`FLEET_RACK` contiguous nodes — what the fleet keyer
    shards a cluster by."""
    for i, node in enumerate(nodes):
        node.metadata.labels[RACK_KEY] = f"rack-{i // FLEET_RACK}"


def fleet_rebinds(scheds) -> int:
    return sum(int(s.metrics.snapshot().get("scheduler_mesh_rebinds_total", 0)) for s in scheds)


def multi_rows(device: str, pods: int = 8192, nodes: int = 512, seed: int = 0) -> dict:
    """bench.py's ``multi_replica_row`` and ``multi_mesh_row`` on the port
    over ``CudaBackend(device)``: K in {1, 2, 4} replicas (one backend each)
    split :data:`FLEET_SHARDS` lease-owned shards of one FakeApiServer on a
    VirtualClock and settle an 8,192 × 512 wave; ``multi_mesh`` labels the
    nodes in racks and warms ownership up for 6 rounds before the wave
    lands, so the topology keyer slices each replica's solve.  Then replica
    0 is crash-killed and the virtual takeover latency (``multi_mesh``: with
    a mesh rebind) is measured.  Settle wall, the critical path (the
    slowest replica's accumulated cycle wall) and pods/s per K."""
    from tpu_scheduler_torch.sim.clock import VirtualClock

    out: dict = {"multi_replica": {}, "multi_mesh": {}}
    for row in ("multi_replica", "multi_mesh"):
        mesh_row = row == "multi_mesh"
        k1_walls = []
        for k in (1, 2, 4):
            for _rep in range(2 if k == 1 else 1):
                clock = VirtualClock()
                api = FakeApiServer(clock=clock)
                snap = synth_cluster(n_nodes=nodes, n_pending=pods, seed=seed)
                if mesh_row:
                    rack_label(snap.nodes)
                    api.load(snap.nodes)
                else:
                    api.load(snap.nodes, snap.pods)
                backends = [RecordingBackend(device=device) for _ in range(k)]
                scheds = [Scheduler(api, backends[i], clock=clock, shards=FLEET_SHARDS if k > 1 else 1,
                                    identity=f"bench-{'m' if mesh_row else 'r'}{i}", lease_duration=FLEET_LEASE)
                          for i in range(k)]
                if mesh_row:
                    for _ in range(6):
                        for s in scheds:
                            s.run_cycle()
                        clock.advance(1.0)
                    for p in snap.pods:
                        api.create_pod(p)
                t0 = time.perf_counter()
                cycles = 0
                per_replica = [0.0] * k
                while api.list_pods("status.phase=Pending") and cycles < 64:
                    for i, s in enumerate(scheds):
                        t1 = time.perf_counter()
                        s.run_cycle()
                        per_replica[i] += time.perf_counter() - t1
                    clock.advance(1.0)
                    cycles += 1
                wall = time.perf_counter() - t0
                critical = max(per_replica)
                bound = api.binding_count
                takeover_s, rebinds = None, 0
                if k > 1:
                    orphans = set(scheds[0].shard_set.owned)
                    t_kill = clock.now
                    survivors = scheds[1:]
                    rebinds_before = fleet_rebinds(survivors)
                    while clock.now - t_kill <= 4 * FLEET_LEASE:
                        clock.advance(1.0)
                        for s in survivors:
                            s.run_cycle()
                        owned = set().union(*(s.shard_set.owned for s in survivors))
                        rebinds = fleet_rebinds(survivors) - rebinds_before
                        if orphans <= owned and (rebinds > 0 or not mesh_row):
                            takeover_s = round(clock.now - t_kill, 3)
                            break
                for s in scheds:
                    s.close()
                if k == 1:
                    k1_walls.append(wall)
                launches = {n: sum(b.launches[n] for b in backends) for n in backends[0].launches}
                out[row][str(k)] = {
                    "replicas": k, "shards": FLEET_SHARDS if k > 1 else 1, "settle_wall_seconds": wall,
                    "critical_path_seconds": critical, "pods_per_second": bound / critical if critical else 0.0,
                    "pods_per_second_sequential": bound / wall if wall else 0.0, "bound": bound, "cycles": cycles,
                    "takeover_virtual_s": takeover_s, "takeover_bound_s": 2 * FLEET_LEASE, "mesh_rebinds": rebinds,
                    "node_axes": sorted({shape[2] for b in backends for shape in b.shapes}), "launches": launches,
                }
        out[f"{row}_wall_seconds_min"] = min(k1_walls)
    return out


def sim_multi_cards(device: str, keep=None) -> dict:
    """The five multi-replica scenarios at seed 0 over one
    ``RecordingBackend(device)`` each (the replicas share it, as the
    harness does): each card, wall seconds and choose launches, and the
    first packed cluster of cross-shard-gang-admission that ``keep``
    accepts."""
    out, kept = {}, None
    for name in MULTI_SCENARIOS:
        backend = RecordingBackend(device=device, keep=keep if name == "cross-shard-gang-admission" else None)
        t0 = time.perf_counter()
        card = sim_harness.run_scenario(name, seed=0, backend=backend)
        out[name] = {"card": card, "wall_s": time.perf_counter() - t0, "launches": backend.launches}
        kept = kept or backend.kept
    return {"cards": out, "kept": kept}


def fuzz_command(device: str, runlog: str) -> list:
    """``sim fuzz``: the corpus replay and the pinned seed-0 campaign."""
    corpus = str(pathlib.Path(__file__).resolve().parent / "tests" / "fuzz_corpus")
    return ["fuzz", "--device", device, "--budget", str(FUZZ_BUDGET), "--seed", "0", "--corpus", corpus,
            "--runlog", runlog]


def run_fuzz(device: str, runlog: str) -> tuple[int, float]:
    """``sim fuzz`` through the port's sim CLI, its printed run log kept off
    this script's output: exit code and seconds."""
    import contextlib
    import io

    from tpu_scheduler_torch.sim.cli import main as sim_cli_main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = sim_cli_main(fuzz_command(device, runlog))
    return rc, time.perf_counter() - t0


def off_card_cores() -> None:
    """Pin this process (a CPU reference) off the card's two cores where
    the host has six or more, with two torch threads."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 6:
        os.sched_setaffinity(0, set(cores[2:]))
    torch.set_num_threads(2)


def fleet_cpu_reference(which: str, tmp: str) -> None:
    """A CPU half of the fleet phases, in a child process without a
    visible card, over ``CudaBackend(device="cpu")``: ``rows`` runs
    ``multi_rows`` and the five multi-replica scenarios, ``fuzz`` the fuzz
    campaign (its run log under ``tmp``).  Each step is stamped on stderr;
    prints one JSON line."""
    logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)
    off_card_cores()
    t0 = time.perf_counter()
    if which == "rows":
        rows = multi_rows("cpu")
        print(f"fleet_cpu_reference: rows {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        sims = sim_multi_cards("cpu")["cards"]
        print(f"fleet_cpu_reference: sims {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        out = {"rows": rows, "sims": {k: {"card": v["card"], "wall_s": v["wall_s"]} for k, v in sims.items()}}
    else:
        fuzz_rc, fuzz_s = run_fuzz("cpu", os.path.join(tmp, "cpu.jsonl"))
        print(f"fleet_cpu_reference: fuzz {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        out = {"fuzz_rc": fuzz_rc, "fuzz_s": fuzz_s}
    print(json.dumps(out), flush=True)


def multi_rows_check(card: dict, cpu: dict, smi: str) -> dict:
    """``multi_replica`` and ``multi_mesh`` on the card against the CPU
    child: bound, cycles and the virtual takeover equal; a mesh rebind
    where K > 1 in ``multi_mesh``; every K launched kernel #1.  Returns
    the launches of the card rows."""
    totals = {name.lower(): 0 for name in CHOOSE_COUNTERS}
    for row in ("multi_replica", "multi_mesh"):
        for k, c in card[row].items():
            r = cpu[row][k]
            equal = all(c[f] == r[f] for f in ("bound", "cycles", "takeover_virtual_s"))
            rec = {"phase": row, "K": int(k), **{f: c[f] for f in c if f != "launches"}, "launches": c["launches"],
                   "cpu_settle_wall_seconds": r["settle_wall_seconds"], "equal_to_cpu": equal, "nvidia_smi": smi}
            emit(rec)
            for n, v in c["launches"].items():
                totals[n] += v
            if not equal:
                raise SystemExit(f"{row} K={k}: card and CPU differ ({c}, {r})")
            if c["launches"]["launches"] == 0:
                raise SystemExit(f"{row} K={k}: no choose kernel launched ({c['launches']})")
            if int(k) > 1 and (c["takeover_virtual_s"] is None or c["takeover_virtual_s"] > 2 * FLEET_LEASE):
                raise SystemExit(f"{row} K={k}: takeover {c['takeover_virtual_s']} s over {2 * FLEET_LEASE} s")
            if row == "multi_mesh" and int(k) > 1 and c["mesh_rebinds"] < 1:
                raise SystemExit(f"multi_mesh K={k}: the takeover rebound no mesh")
    return totals


def bound_pods_feasible(api) -> int:
    """Bound pods of the API's state that fail a node-local predicate
    (selector, node affinity, cordon, taints) on their node."""
    from tpu_scheduler_torch.core.predicates import NODE_LOCAL_PREDICATES

    snap = ClusterSnapshot.build(api.list_nodes(), api.list_pods())
    by_name = {n.name: n for n in snap.nodes}
    bad = 0
    for p in snap.pods:
        node = by_name.get(p.spec.node_name) if p.spec is not None and p.spec.node_name else None
        if node is not None and not all(pred(p, node, snap) for _reason, pred in NODE_LOCAL_PREDICATES):
            bad += 1
    return bad


def fleet_e2e(smi: str, n_nodes: int = 10_000, n_pending: int = 100_000, n_bound: int = 20_000,
              second_wave: int = 10_000) -> tuple[dict, object]:
    """The slice at a size users run: ``synth_cluster(n_nodes=10_000,
    n_pending=100_000, n_bound=20_000, seed=0)`` (``controller_e2e``'s
    cluster) with every node in racks of 32, four replicas over four shards
    (5 s leases) against one FakeApiServer on one VirtualClock, each over
    its own ``CudaBackend`` on the one card.  Ownership warms up for 6
    rounds (``multi_mesh_row``), the 100,000-pod wave lands and the fleet
    cycles until a round binds nothing; then replica 0 is crash-killed and
    the survivors cycle until they own its shards with a mesh rebind; a
    last 10,000-pod wave (template seed 1) is solved by the survivors, one
    cycle under torch.profiler.  Returns the record and one replica's
    node-sliced packed cluster (``kernel_vs_plain_fleet``)."""
    from tpu_scheduler_torch.sim.clock import VirtualClock

    t0 = time.perf_counter()
    snap = synth_cluster(n_nodes=n_nodes, n_pending=n_pending, n_bound=n_bound, seed=0)
    rack_label(snap.nodes)
    wave = [p for p in snap.pods if p.spec is None or p.spec.node_name is None]
    clock = VirtualClock()
    api = FakeApiServer(clock=clock)
    api.load(snap.nodes, [p for p in snap.pods if p.spec is not None and p.spec.node_name])
    profile = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
    sliced = lambda packed: packed.num_pods > 0 and len(packed.node_names) < n_nodes  # noqa: E731
    backends = [RecordingBackend(keep=sliced if i == 1 else None) for i in range(4)]
    scheds = [Scheduler(api, backends[i], profile=profile, clock=clock, shards=FLEET_SHARDS,
                        identity=f"fleet-r{i}", lease_duration=FLEET_LEASE) for i in range(4)]
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(6):
        for s in scheds:
            s.run_cycle()
        clock.advance(1.0)
    warm_s = time.perf_counter() - t0
    owned_warm = [sorted(s.shard_set.owned) for s in scheds]
    for p in wave:
        api.create_pod(p)
    bound_before = sum(1 for p in api.list_pods() if p.spec is not None and p.spec.node_name)
    bindings_before = api.binding_count
    cuda_backend_mod.UPLOAD_BYTES = 0
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    per_replica = [0.0] * 4
    phases = [{"sync": [], "overlay": [], "queue": [], "pack": [], "solve": [], "bind": [], "wall": [], "bound": []}
              for _ in range(4)]
    rounds = 0
    t0 = time.perf_counter()
    while rounds < 20:
        round_bound = 0
        for i, s in enumerate(scheds):
            t1 = time.perf_counter()
            m = s.run_cycle()
            w = time.perf_counter() - t1
            per_replica[i] += w
            for key, v in (("sync", m.sync_seconds), ("overlay", m.overlay_seconds), ("queue", m.queue_seconds),
                           ("pack", m.pack_seconds), ("solve", m.solve_seconds), ("bind", m.bind_seconds),
                           ("wall", w), ("bound", m.bound)):
                phases[i][key].append(v)
            round_bound += m.bound
        clock.advance(1.0)
        rounds += 1
        if round_bound == 0:
            break
    settle_wall = time.perf_counter() - t0
    upload_bytes = cuda_backend_mod.UPLOAD_BYTES
    wave_launches = [dict(b.launches) for b in backends]
    bound = sum(1 for p in api.list_pods() if p.spec is not None and p.spec.node_name) - bound_before
    pending_left = len(api.list_pods("status.phase=Pending"))
    bindings = api.binding_count - bindings_before
    infos = [b.mesh_bindings_info() for b in backends]

    # Crash-kill replica 0: it never cycles again and never releases a lease.
    orphans = set(scheds[0].shard_set.owned)
    survivors = scheds[1:]
    t_kill = clock.now
    rebinds_before = fleet_rebinds(survivors)
    takeover_s = None
    t0 = time.perf_counter()
    while clock.now - t_kill <= 4 * FLEET_LEASE:
        clock.advance(1.0)
        for s in survivors:
            s.run_cycle()
        owned = set().union(*(s.shard_set.owned for s in survivors))
        if orphans <= owned and fleet_rebinds(survivors) > rebinds_before:
            takeover_s = clock.now - t_kill
            break
    takeover_wall = time.perf_counter() - t0
    for s in survivors:  # the rebind's escalated full wave
        s.run_cycle()
    reasons = [dict(s.delta.full_solve_reasons) for s in survivors]
    rebinds = fleet_rebinds(survivors) - rebinds_before

    # A fresh 10,000-pod wave on the survivors; one cycle profiled.
    for p in renamed(synth_cluster(n_nodes=n_nodes, n_pending=second_wave, n_bound=0, seed=1).pending_pods(), "w2"):
        api.create_pod(p)
    before = [dict(b.launches) for b in backends[1:]]
    holder: list = []
    wall_ms, dev_rows = profiled(lambda: holder.append(survivors[0].run_cycle()))
    split = device_split(wall_ms, dev_rows, "choose_kernel")
    for s in survivors[1:]:
        s.run_cycle()
    after_launches = [{k: b.launches[k] - before[i][k] for k in b.launches} for i, b in enumerate(backends[1:])]
    peak_mem = torch.cuda.max_memory_allocated()
    for s in survivors:
        s.close()
    bad_nodes = oversubscribed_nodes(api)
    infeasible = bound_pods_feasible(api)
    double = (api.binding_count - bindings_before) - (
        sum(1 for p in api.list_pods() if p.spec is not None and p.spec.node_name) - bound_before)
    med = statistics.median
    rec = {
        "phase": "fleet_e2e", "pods": len(wave), "nodes": n_nodes, "bound_pods": n_bound, "replicas": 4,
        "shards": FLEET_SHARDS, "lease_s": FLEET_LEASE, "racks": -(-n_nodes // FLEET_RACK), "setup_s": setup_s,
        "warmup_s": warm_s, "owned_after_warmup": owned_warm, "settle_rounds": rounds, "settle_wall_s": settle_wall,
        "critical_path_s": max(per_replica), "per_replica_wall_s": per_replica,
        "pods_per_second": bound / max(per_replica), "pods_per_second_sequential": bound / settle_wall,
        "bound": bound, "pending_left": pending_left, "binding_posts": bindings,
        "replica_phases_median_s": [{k: med(v) for k, v in ph.items() if k != "bound"} for ph in phases],
        "replica_first_cycle_s": [{k: v[0] for k, v in ph.items()} for ph in phases],
        "replica_node_axes": [sorted({shape[2] for shape in b.shapes}) for b in backends],
        "upload_bytes": upload_bytes, "peak_mem_bytes": peak_mem, "wave_launches": wave_launches,
        "takeover_virtual_s": takeover_s, "takeover_bound_s": 2 * FLEET_LEASE, "takeover_wall_s": takeover_wall,
        "orphan_shards": sorted(orphans), "mesh_rebinds": rebinds, "survivor_full_solve_reasons": reasons,
        "mesh_bindings": infos[1], "second_wave_launches": after_launches,
        "profiled_cycle": dict(split, bound=holder[0].bound if holder else None, wall_s=wall_ms / 1e3),
        "oversubscribed_nodes": bad_nodes, "infeasible_bindings": infeasible, "double_binds": double,
        "nvidia_smi": smi,
    }
    if takeover_s is None or takeover_s > 2 * FLEET_LEASE:
        raise SystemExit(f"fleet_e2e: takeover {takeover_s} s, bound {2 * FLEET_LEASE} s")
    if rebinds < 1 or not any(r.get("mesh-rebind", 0) >= 1 for r in reasons):
        raise SystemExit(f"fleet_e2e: no mesh rebind ({rebinds}) or no mesh-rebind full wave ({reasons})")
    if bad_nodes or infeasible or double:
        raise SystemExit(f"fleet_e2e: {bad_nodes} oversubscribed nodes, {infeasible} infeasible bindings, "
                         f"{double} double binds")
    if any(w["launches"] == 0 for w in wave_launches):
        raise SystemExit(f"fleet_e2e: a replica launched no choose kernel in the wave ({wave_launches})")
    if not all(info and all(not b["dedicated"] for b in info.values()) for info in infos):
        raise SystemExit(f"fleet_e2e: mesh bindings are not the shared one-card set: {infos}")
    if bound == 0 or backends[1].kept is None:
        raise SystemExit("fleet_e2e: nothing bound, or no node-sliced solve was captured")
    rec["launches"] = {k: sum(w[k] for w in wave_launches) + sum(a[k] for a in after_launches)
                       for k in wave_launches[0]}
    return rec, backends[1].kept


def kernel_vs_plain_fleet(fleet_packed, gang_packed, profile, device) -> dict:
    """Kernel #1 held bit for bit against its plain version on one fleet
    replica's node-sliced operands (its owned pods against its N/K slice,
    captured in ``fleet_e2e``); kernel #1t on a sliced topology cycle of
    cross-shard-gang-admission (the gangs the fleet reserves peer shards
    for), at the cycle-start and a mid-cycle gang state."""
    arrays = to_device(fleet_packed, device)
    b = min(8192, fleet_packed.padded_pods)
    rec1, _ = compare("fleet_slice_block", block_args(arrays, 0, b), profile.weights(), salt=3,
                      phase="kernel_vs_plain_fleet", kernel="choose", nodes_real=len(fleet_packed.node_names),
                      active=int(fleet_packed.pod_valid[:b].sum()))
    errs = {"choose": rec1["max_abs_err"], "choose_topology": 0.0}
    if gang_packed is not None:
        w = PROFILES["default"].weights()
        for name, share in (("gang_slice_round0", 0.0), ("gang_slice_mid_cycle", 0.5)):
            garrays, op = round_term(gang_packed, device, w, placed_share=share, seed=17)
            gb = gang_packed.padded_pods
            rec = compare_topology(name, block_args(garrays, 0, gb), w, 3, block_term(op, 0, gb),
                                   phase="kernel_vs_plain_fleet", kernel="choose_topology",
                                   nodes_real=len(gang_packed.node_names))
            errs["choose_topology"] = max(errs["choose_topology"], rec["max_abs_err"])
    return {"max_abs_err": errs, "topology": gang_packed is not None}


def sim_multi_check(card: dict, cpu: dict, smi: str) -> dict:
    """The five multi-replica scenarios on the card against the CPU child:
    fingerprints equal, cards equal outside :data:`SIM_CARD_VS_CPU`, the
    availability block enabled and passing.  Returns the card launches."""
    totals = {name.lower(): 0 for name in CHOOSE_COUNTERS}
    for name in MULTI_SCENARIOS:
        c, r = card[name], cpu[name]
        cc, rc = c["card"], r["card"]
        differing = [q for q in sim_diff(cc, rc) if q not in SIM_CARD_VS_CPU]
        av = cc["availability"]
        rec = {"phase": "sim_multi", "scenario": name, "seed": 0, "wall_s": c["wall_s"], "cpu_wall_s": r["wall_s"],
               "cycles": cc["cycles"], "replicas": av["replicas"], "shards": av["shards"], "kills": len(av["kills"]),
               "max_takeover_latency_s": av["max_takeover_latency_s"], "takeover_bound_s": av["takeover_bound_s"],
               "availability_ok": av["ok"], "pass": cc["pass"], "fingerprint": cc["fingerprint"][:16],
               "fingerprint_equal": cc["fingerprint"] == rc["fingerprint"], "differing_fields": differing,
               "launches": c["launches"], "nvidia_smi": smi}
        emit(rec)
        for n, v in c["launches"].items():
            totals[n] += v
        if not (rec["fingerprint_equal"] and not differing and cc["pass"] and av["enabled"] and av["ok"]):
            raise SystemExit(f"sim_multi {name}: card and CPU differ ({differing}) or the verdict failed")
        if c["launches"]["launches"] + c["launches"]["launches_topo"] == 0:
            raise SystemExit(f"sim_multi {name}: no choose kernel launched on the card ({c['launches']})")
    return totals


def fuzz_check(rc: int, seconds: float, launches: dict, tmp: pathlib.Path, cpu: dict, smi: str) -> None:
    """The card's fuzz run log against the CPU child's, byte for byte;
    both exit 0 (corpus green, no violation)."""
    card_log = (tmp / "card.jsonl").read_bytes()
    cpu_log = (tmp / "cpu.jsonl").read_bytes()
    lines = [json.loads(ln) for ln in card_log.decode().splitlines()]
    summary = lines[-1]
    rec = {"phase": "fuzz", "budget": FUZZ_BUDGET, "seed": 0, "rc": rc, "seconds": seconds,
           "corpus_replayed": summary["corpus_replayed"], "corpus_ok": summary["corpus_ok"],
           "plans_run": sum(1 for ln in lines if "plan" in ln and "fingerprint" in ln),
           "plans_refused": sum(1 for ln in lines if "refused" in ln),
           "plans_elastic": sum(1 for ln in lines if ln.get("base") == "elastic"),
           "violations_found": summary["violations_found"],
           "coverage_pairs": summary["coverage_pairs"], "runlog_bytes": len(card_log),
           "runlog_equal_to_cpu": card_log == cpu_log, "cpu_rc": cpu["fuzz_rc"], "cpu_seconds": cpu["fuzz_s"],
           "launches": launches, "nvidia_smi": smi}
    emit(rec)
    if rc != 0 or cpu["fuzz_rc"] != 0 or not rec["runlog_equal_to_cpu"] or not summary["corpus_ok"] \
            or summary["violations_found"] or rec["plans_refused"] or not rec["plans_elastic"]:
        raise SystemExit(f"fuzz: rc {rc}, run logs equal {rec['runlog_equal_to_cpu']}, summary {summary}")
    if launches["launches"] + launches["launches_topo"] == 0:
        raise SystemExit(f"fuzz: no choose kernel launched on the card ({launches})")


def fleet_phases(smi: str, device, tmp: pathlib.Path) -> dict:
    """The sharded control plane and the fleet on the card, each phase
    against its CPU reference (two children started first, running beside
    the card phases): ``multi_replica`` and ``multi_mesh``, ``sim_multi``,
    ``fuzz``, ``fleet_e2e`` and ``kernel_vs_plain_fleet``.  Returns the
    card launches of the phases' main paths per choose instance and the
    fleet kernel check's error."""
    children, errs = {}, {}
    for which in ("rows", "fuzz"):
        errs[which] = tempfile.TemporaryFile("w+")
        children[which] = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.fleet_cpu_reference({which!r}, {str(tmp)!r})"],
            cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=errs[which], text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        )
    cpu: dict = {}
    try:
        rows = multi_rows("cuda")
        # A sliced topology cycle with two gangs or more: the 32-node
        # fleet's solve against a replica's slice (a peer's reserved too).
        gang_sliced = lambda packed: (packed.topology is not None  # noqa: E731
                                      and packed.topology.n_gangs >= 2 and len(packed.node_names) < 32)
        sims = sim_multi_cards("cuda", keep=gang_sliced)
        zero_launches()
        fuzz_rc, fuzz_s = run_fuzz("cuda", str(tmp / "card.jsonl"))
        fuzz_launches = read_launches()
        fleet_rec, fleet_packed = fleet_e2e(smi)
        for which, child in children.items():
            try:
                out, _ = child.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
                out = None
            errs[which].seek(0)
            if child.returncode != 0 or out is None:
                raise SystemExit(f"fleet: the CPU run ({which}) failed or timed out ({child.returncode}): "
                                 f"{errs[which].read()[-3000:]}")
            cpu.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
        for f in errs.values():
            f.close()
    row_launches = multi_rows_check(rows, cpu["rows"], smi)
    sim_launches = sim_multi_check(sims["cards"], cpu["sims"], smi)
    fuzz_check(fuzz_rc, fuzz_s, fuzz_launches, tmp, cpu, smi)
    emit(fleet_rec)
    check = kernel_vs_plain_fleet(fleet_packed, sims["kept"], PROFILES["throughput"].with_(pod_block=8192),
                                  device)
    launches = {k: row_launches[k] + sim_launches[k] + fuzz_launches[k] + fleet_rec["launches"][k]
                for k in row_launches}
    emit({"phase": "fleet", "launches": launches, "kernel_vs_plain_fleet": check, "nvidia_smi": smi})
    return {"launches": launches, "max_abs_err": check["max_abs_err"], "topology_checked": check["topology"]}


# ---- the rebalancer, the autoscaler and the learned policy -----------------

# The scenarios of the rebalancer (3), the autoscaler (4) and both under
# chaos with two replicas.
ITEM9_SCENARIOS = ("defrag-smoke", "fragmentation-long-horizon", "autoscaler-backlog-whatif", "diurnal-traffic",
                   "flash-crowd-provisioning-lag", "spot-reclaim-storm", "quota-capped-surge",
                   "rebalance-under-chaos")
# bench.py's profile: throughput at its pod block and round cap.
BENCH_PROFILE = PROFILES["throughput"].with_(pod_block=8192, max_rounds=64)
# The checked-in tuned artifact the policy phase holds against the default.
TUNED_ARTIFACT = pathlib.Path(__file__).resolve().parent / "tpu_scheduler_torch" / "learn" / "profiles" / "tuned.json"
# ``sim train`` at a small budget: 2 generations of 4 candidates on
# train-smoke, train seeds 0-1, held-out seeds 101-102 (the defaults).
TRAIN_ARGS = ("--scenario-set", "train-smoke", "--seed", "0", "--generations", "2", "--population", "4")
REBALANCE_RESULT_FIELDS = ("migrations", "nodes_drained", "efficiency_before", "efficiency_after",
                           "stranded_before", "stranded_after", "cycles", "preemption_churn", "placement_digest")


def track_unbinds(sched) -> list:
    """Wrap the scheduler's migration unbind so that every pod it unbinds
    is listed (full names) in the returned list."""
    unbound: list = []
    unbind = sched._unbind

    def recorded(pod_full: str, node_name: str) -> bool:
        ok = unbind(pod_full, node_name)
        if ok:
            unbound.append(pod_full)
        return ok

    sched._unbind = recorded
    return unbound


def migration_audit(api, unbound: list, over_before: set) -> dict:
    """Where the migrated pods ended: orphaned (gone), still pending, or on
    a node that is oversubscribed; and the oversubscribed nodes the run
    added to those it started with."""
    from tpu_scheduler_torch.api.objects import full_name, is_pod_bound

    by_name = {full_name(p): p for p in api.list_pods()}
    over_after = oversubscribed_set(api)
    moved = [by_name[pf] for pf in unbound if pf in by_name and is_pod_bound(by_name[pf])]
    return {
        "unbound_pods": len(unbound), "orphaned_migrations": sum(1 for pf in unbound if pf not in by_name),
        "still_pending": sum(1 for pf in unbound if pf in by_name and not is_pod_bound(by_name[pf])),
        "rebound_onto_oversubscribed": sum(1 for p in moved if p.spec.node_name in over_after),
        "oversubscribed_at_start": len(over_before), "oversubscribed_at_end": len(over_after),
        "oversubscribed_added": len(over_after - over_before),
    }


def placement_digest(api) -> str:
    """A digest of the API's pod -> node map."""
    import hashlib

    pairs = sorted((p.metadata.name, p.spec.node_name or "") for p in api.list_pods() if p.spec is not None)
    return hashlib.sha256(json.dumps(pairs).encode()).hexdigest()[:16]


def cycle_phases_of(m) -> dict:
    """A cycle's ``CycleMetrics`` phase seconds by phase name."""
    from tpu_scheduler_torch.utils.metrics import cycle_phases

    return {ph: getattr(m, f"{ph}_seconds") for ph in cycle_phases()}


def rebalance_row(device: str) -> dict:
    """bench.py's ``rebalance_row`` on the port over ``CudaBackend(device)``:
    ``synth_cluster(n_nodes=512, n_pending=0, n_bound=8_192, seed=0)``
    (round-robin bound, so every node is lightly filled) in a FakeApiServer,
    a Scheduler with ``RebalanceConfig(every=1, batch=256, max_plan=1024,
    max_pending=512)`` (inline solve) run until two ``no-gain`` skips, at
    most 80 cycles.  The scheduler's clock is a VirtualClock advanced 1 s a
    cycle, so the SLO burn the throttle reads is the same on every device.
    On the card the second cycle (the first re-placement, and a tick) runs
    under torch.profiler.  Packing before and after, migrations, drained
    nodes, cycles, preemption churn, the final placements' digest; solve
    and cycle walls with the cycles' phases, #1 launches."""
    from tpu_scheduler_torch.rebalance import RebalanceConfig, RebalanceSnapshot, packing_stats
    from tpu_scheduler_torch.sim.clock import VirtualClock

    base = synth_cluster(n_nodes=512, n_pending=0, n_bound=8192, seed=0)
    api = FakeApiServer()
    api.load(base.nodes, base.pods)
    rs0 = RebalanceSnapshot.build(ClusterSnapshot.build(api.list_nodes(), api.list_pods()))
    before = packing_stats(rs0.alloc, rs0.used)
    over_before = oversubscribed_set(api)
    clock = VirtualClock()
    backend = RecordingBackend(device=device)
    sched = Scheduler(api, backend, profile=BENCH_PROFILE, requeue_seconds=0.0, clock=clock,
                      rebalance=RebalanceConfig(every=1, batch=256, max_plan=1024, max_pending=512))
    unbound = track_unbinds(sched)
    idle, walls, phases, split = 0, [], [], None
    try:
        for cycle in range(80):
            holder: list = []
            t0 = time.perf_counter()
            if cycle == 1 and device == "cuda":
                wall_ms, rows = profiled(lambda: holder.append(sched.run_cycle()))
                split = device_split(wall_ms, rows, "choose_kernel")
            else:
                holder.append(sched.run_cycle())
            walls.append(time.perf_counter() - t0)
            phases.append(cycle_phases_of(holder[0]))
            clock.advance(1.0)
            s = sched.rebalancer.stats()
            if s["skips"].get("no-gain", 0) > idle:
                idle = s["skips"]["no-gain"]
                if idle >= 2:
                    break  # two dry solves: the drain converged
        s = sched.rebalancer.stats()
        solve_walls = list(sched.rebalancer.solve_walls)
        counters = sched.metrics.snapshot()
    finally:
        sched.close()
    rs1 = RebalanceSnapshot.build(ClusterSnapshot.build(api.list_nodes(), api.list_pods()))
    after = packing_stats(rs1.alloc, rs1.used)
    return {
        "shape": "8192x512", "migrations": s["executed"], "nodes_drained": s["nodes_drained"],
        "efficiency_before": before["efficiency"], "efficiency_after": after["efficiency"],
        "stranded_before": before["stranded_frac"], "stranded_after": after["stranded_frac"],
        "cycles": len(walls), "preemption_churn": int(counters.get("scheduler_preemption_victims_total", 0)),
        "placement_digest": placement_digest(api), "solves": s["solves"], "skips": s["skips"],
        "solve_walls_s": solve_walls, "cycle_walls_s": walls, "cycle_wall_total_s": sum(walls),
        "phases_median_s": {ph: statistics.median(p[ph] for p in phases) for ph in phases[0]},
        "phases_total_s": {ph: sum(p[ph] for p in phases) for ph in phases[0]},
        **migration_audit(api, unbound, over_before), "launches": backend.launches, "profiled_cycle": split,
    }


def rebalance_e2e(smi: str, device, nodes: int = 10_000, bound: int = 100_000) -> tuple[dict, float]:
    """The rebalancer at the flagship's cluster, on the card:
    ``synth_cluster(n_nodes=10_000, n_pending=0, n_bound=100_000, seed=0)``
    (round-robin bound: every node fragmented) in a FakeApiServer, a
    Scheduler with ``RebalanceConfig(every=1, batch=256)`` on a VirtualClock
    (1 s a cycle), 8 cycles, each ending in a tick.  A tick reconciles
    against the cycle's starting snapshot, so the ticks alternate: one
    solves and unbinds up to 256 pods, the next cycle re-places them
    through the delta engine and its tick stands down (``inflight``) — 4
    solves.  The fourth cycle (a re-placement) runs under torch.profiler.  Checks: no node oversubscribed that was not at the
    start (the round-robin binding starts some so) and no migrated pod
    re-bound onto one, every unbound pod re-bound (no orphan, none left
    pending), preemption churn 0, every binding feasible, the drained
    nodes cordoned.  #1 is held against its plain
    version at the first re-placement cycle's block.  Returns the record
    and that check's error."""
    from tpu_scheduler_torch.rebalance import REBALANCE_CORDON_LABEL, RebalanceConfig
    from tpu_scheduler_torch.sim.clock import VirtualClock

    t0 = time.perf_counter()
    base = synth_cluster(n_nodes=nodes, n_pending=0, n_bound=bound, seed=0)
    api = FakeApiServer()
    api.load(base.nodes, base.pods)
    over_before = oversubscribed_set(api)
    setup_s = time.perf_counter() - t0
    clock = VirtualClock()
    backend = RecordingBackend(device=device.type, keep=lambda packed: int(packed.pod_valid.sum()) > 0)
    sched = Scheduler(api, backend, profile=BENCH_PROFILE, requeue_seconds=0.0, clock=clock,
                      rebalance=RebalanceConfig(every=1, batch=256))
    rebalancer = sched.rebalancer
    unbound = track_unbinds(sched)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    rows, split = [], None
    try:
        for cycle in range(8):
            cuda_backend_mod.UPLOAD_BYTES = 0
            before = read_launches()
            holder: list = []
            solves_before = len(rebalancer.solve_walls)
            c0 = time.perf_counter()
            if cycle == 3:
                wall_ms, dev_rows = profiled(lambda: holder.append(sched.run_cycle()))
                split = device_split(wall_ms, dev_rows, "choose_kernel")
            else:
                holder.append(sched.run_cycle())
            m = holder[0]
            launches = {k: v - before[k] for k, v in read_launches().items()}
            row = {"cycle": cycle, "wall_s": time.perf_counter() - c0, **{f"{k}_s": v for k, v in
                                                                          cycle_phases_of(m).items()},
                   "pending": m.pending, "replaced": m.bound, "unschedulable": m.unschedulable,
                   "solve_wall_s": rebalancer.solve_walls[solves_before:], "upload_bytes": cuda_backend_mod.UPLOAD_BYTES,
                   "choose_launches": launches, "migrations_total": rebalancer.executed}
            rows.append(row)
            if m.pending and m.solve_seconds > 0 and launches["launches"] == 0:
                raise SystemExit(f"rebalance_e2e: cycle {cycle} re-placed {m.pending} pods without kernel #1")
            clock.advance(1.0)
        peak_mem = torch.cuda.max_memory_allocated()
        stats = rebalancer.stats()
        counters = sched.metrics.snapshot()
    finally:
        sched.close()
    drained = sorted(n.name for n in api.list_nodes() if (n.metadata.labels or {}).get(REBALANCE_CORDON_LABEL))
    cordoned = all(n.spec is not None and n.spec.unschedulable for n in api.list_nodes() if n.name in set(drained))
    rec = {
        "phase": "rebalance_e2e", "nodes": nodes, "bound_pods": bound, "setup_s": setup_s, "ticks": stats["ticks"],
        "solves": stats["solves"], "migrations": stats["executed"], "completed": stats["completed"],
        "nodes_drained": stats["nodes_drained"], "drained_labeled": len(drained), "last_plan": stats["last_plan"],
        "skips": stats["skips"], "solve_walls_s": list(rebalancer.solve_walls),
        "replaced_through_choose": sum(r["replaced"] for r in rows[1:]), "cycles": rows,
        "choose_launches": read_launches(), "peak_mem_bytes": peak_mem, "profiled_cycle": split,
        **migration_audit(api, unbound, over_before), "infeasible_bindings": bound_pods_feasible(api),
        "preemption_churn": int(counters.get("scheduler_preemption_victims_total", 0)),
        "backend_fallbacks": counters.get("scheduler_backend_fallbacks_total", 0), "nvidia_smi": smi,
    }
    emit(rec)
    if rec["oversubscribed_added"] or rec["rebound_onto_oversubscribed"] or rec["orphaned_migrations"] \
            or rec["still_pending"] or rec["infeasible_bindings"] or rec["preemption_churn"] \
            or rec["backend_fallbacks"] or not cordoned:
        raise SystemExit(f"rebalance_e2e: a check failed ({rec}, cordoned {cordoned})")
    if rec["migrations"] == 0 or rec["solves"] != 4 or rec["choose_launches"]["launches"] == 0:
        raise SystemExit(f"rebalance_e2e: {rec['solves']} solves, {rec['migrations']} migrations, "
                         f"launches {rec['choose_launches']}")
    if backend.kept is None:
        raise SystemExit("rebalance_e2e: no re-placement solve was captured")
    arrays = to_device(backend.kept, device)
    b = min(8192, backend.kept.padded_pods)
    crec, _ = compare("rebalance_replace_block", block_args(arrays, 0, b), BENCH_PROFILE.weights(), salt=1,
                      phase="kernel_vs_plain_rebalance", kernel="choose", nodes_real=len(backend.kept.node_names),
                      active=int(backend.kept.pod_valid[:b].sum()))
    return rec, crec["max_abs_err"]


def sim_item9_cards(device: str) -> dict:
    """The 8 scenarios of :data:`ITEM9_SCENARIOS` at seed 0 over
    ``CudaBackend(device)``: each card, wall, controller and verdict
    seconds, and the choose launches."""
    out = {}
    for name in ITEM9_SCENARIOS:
        zero_launches()
        run = sim_episode(name, 0, CudaBackend(device=device))
        out[name] = {k: run[k] for k in ("card", "wall_s", "controller_s", "verdict_s", "device")}
        out[name]["launches"] = read_launches()
    return out


def policy_objectives(device: str) -> dict:
    """bench.py's ``policy_row`` objectives on the port: each provenance
    scenario of the checked-in tuned artifact on its first held-out seed,
    under the tuned and the default profile, over ``CudaBackend(device)``:
    per-scenario objectives, their means, and whether every gate passed
    under the tuned weights; the choose launches."""
    from tpu_scheduler_torch.learn.distill import load_profile
    from tpu_scheduler_torch.learn.objective import OBJECTIVE_VERSION

    prov = json.loads(TUNED_ARTIFACT.read_text())["provenance"]
    if prov["objective_version"] != OBJECTIVE_VERSION:
        raise SystemExit(f"policy: the artifact was trained against objective v{prov['objective_version']}")
    tuned = load_profile(str(TUNED_ARTIFACT))
    scenarios = tuple(prov["search"]["scenarios"])
    hseed = int(prov["search"]["held_out_seeds"][0])
    per, gates_green = {}, True
    zero_launches()
    for name in scenarios:
        ct = sim_harness.run_scenario(name, seed=hseed, profile=tuned, backend=CudaBackend(device=device))
        cd = sim_harness.run_scenario(name, seed=hseed, backend=CudaBackend(device=device))
        per[name] = {"tuned": ct["policy"]["objective"], "default": cd["policy"]["objective"]}
        gates_green = gates_green and bool(ct["pass"])
    t = round(sum(v["tuned"] for v in per.values()) / len(per), 6)
    d = round(sum(v["default"] for v in per.values()) / len(per), 6)
    return {"held_out_seed": hseed, "scenarios": per, "objective_tuned": t, "objective_default": d,
            "objective_delta": round(t - d, 6), "gates_green_under_tuned": gates_green, "launches": read_launches()}


def policy_latency(profile, pods: int = 10_000, nodes: int = 1_000, seed: int = 0, cycles: int = 6) -> dict:
    """bench.py's ``incremental_row`` at ``policy_row``'s shape on the card:
    a cold full wave over ``synth_cluster(nodes, pods, 2 * nodes bound,
    seed)``, then ``cycles`` steady delta cycles of pods/100 fresh pods and
    3 bursts of pods/10 (template seed + 1, renamed; as many bound pods
    retired), all off the clock but the cycle."""
    base = synth_cluster(n_nodes=nodes, n_pending=pods, n_bound=2 * nodes, seed=seed)
    api = FakeApiServer()
    api.load(base.nodes, base.pods)
    sched = Scheduler(api, CudaBackend(), profile=profile, requeue_seconds=0.0)
    wave = synth_cluster(n_nodes=nodes, n_pending=pods, n_bound=0, seed=seed + 1).pending_pods()
    pool = [p for p in base.pods if p.spec is not None and p.spec.node_name is None]
    state = {"prev": [], "retire_from": 0, "w": 0}
    before = read_launches()

    def churn_cycle(n: int) -> float:
        state["w"] += 1
        for p in state["prev"] + pool[state["retire_from"]:state["retire_from"] + n]:
            api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        state["retire_from"] += n
        state["prev"] = renamed(wave[:n], f"i{state['w']}")
        for p in state["prev"]:
            api.create_pod(p)
        t0 = time.perf_counter()
        sched.run_cycle()
        return time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        sched.run_cycle()
        cold = time.perf_counter() - t0
        steady = [churn_cycle(max(1, pods // 100)) for _ in range(cycles)]
        burst = [churn_cycle(max(1, pods // 10)) for _ in range(3)]
    finally:
        sched.close()
    return {"shape": f"{pods}x{nodes}", "cold_s": cold, "steady_s": steady, "burst_s": burst,
            "delta_cycle_seconds_min": min(steady), "delta_cycle_seconds": statistics.median(steady),
            "launches": {k: v - before[k] for k, v in read_launches().items()}}


def train_run(device: str, workers: int, out: str) -> dict:
    """``sim train`` (:data:`TRAIN_ARGS`) through the port's sim CLI on
    ``device`` with ``workers`` threads: exit code, seconds, the artifact's
    bytes (text) and the report line."""
    import contextlib
    import io

    from tpu_scheduler_torch.sim.cli import main as sim_cli_main

    buf, errbuf = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(errbuf):
        rc = sim_cli_main(["train", *TRAIN_ARGS, "--device", device, "--workers", str(workers), "--out", out])
    seconds = time.perf_counter() - t0
    report = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else None
    return {"rc": rc, "seconds": seconds, "artifact": pathlib.Path(out).read_text() if rc == 0 else None,
            "report": report, "stderr": errbuf.getvalue()[-2000:]}


def item9_cpu_reference(tmp: str) -> None:
    """The CPU half of the item-9 phases, in a child process without a
    visible card, over ``CudaBackend(device="cpu")``: ``rebalance_row``,
    the 8 scenarios, the policy objectives and ``sim train`` with 2
    workers (its artifact under ``tmp``).  Each step is stamped on stderr;
    prints one JSON line."""
    logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)
    off_card_cores()
    t0 = time.perf_counter()
    out = {"rebalance_row": rebalance_row("cpu")}
    print(f"item9_cpu_reference: rebalance_row {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    out["sims"] = sim_item9_cards("cpu")
    print(f"item9_cpu_reference: sims {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    out["policy"] = policy_objectives("cpu")
    print(f"item9_cpu_reference: policy {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    out["train"] = train_run("cpu", 2, os.path.join(tmp, "train_cpu.json"))
    print(f"item9_cpu_reference: train {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def without_workers(artifact: str) -> dict:
    """A profile artifact with its provenance's ``search.workers`` taken
    out: the one field a run with another thread count writes differently."""
    doc = json.loads(artifact)
    doc["provenance"]["search"].pop("workers")
    return doc


def item9_phases(smi: str, device, tmp: pathlib.Path) -> dict:
    """The rebalancer, the autoscaler and the learned policy on the card,
    each phase against its CPU reference where it names one (one child,
    started first, running beside the card phases): ``rebalance_row``,
    ``rebalance_e2e`` (card only), ``sim_item9``, ``policy`` and
    ``train``.  Returns the card launches of the phases' main paths per
    choose instance and the kernel checks' errors."""
    errf = tempfile.TemporaryFile("w+")
    child = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.item9_cpu_reference({str(tmp)!r})"],
        cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=errf, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    totals = {name.lower(): 0 for name in CHOOSE_COUNTERS}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            totals[k] += v

    try:
        t0 = time.perf_counter()
        row = rebalance_row("cuda")
        row_s = time.perf_counter() - t0
        e2e_rec, e2e_err = rebalance_e2e(smi, device)
        add(e2e_rec["choose_launches"])
        torch.cuda.empty_cache()
        sims = sim_item9_cards("cuda")
        objectives = policy_objectives("cuda")
        add(objectives["launches"])
        tuned = json.loads(TUNED_ARTIFACT.read_text())
        from tpu_scheduler_torch.learn.distill import load_profile
        from tpu_scheduler_torch.models.profiles import DEFAULT_PROFILE

        tuned_profile = load_profile(str(TUNED_ARTIFACT))
        lat_tuned = policy_latency(tuned_profile)
        lat_default = policy_latency(DEFAULT_PROFILE)
        add(lat_tuned["launches"])
        add(lat_default["launches"])
        # #1t under the tuned weights, on a train-smoke cycle with gangs.
        gang_backend = RecordingBackend(keep=lambda packed: packed.topology is not None
                                        and packed.topology.n_gangs >= 2)
        zero_launches()
        sim_harness.run_scenario("train-smoke", seed=0, profile=tuned_profile, backend=gang_backend)
        add(read_launches())
        if gang_backend.kept is None:
            raise SystemExit("policy: no train-smoke cycle with gangs was captured")
        w = tuned_profile.weights()
        gp = gang_backend.kept
        topo_err = 0.0
        for name, share in (("train_smoke_tuned_round0", 0.0), ("train_smoke_tuned_mid_cycle", 0.5)):
            garrays, op = round_term(gp, device, w, placed_share=share, seed=19)
            rec = compare_topology(name, block_args(garrays, 0, gp.padded_pods), w, 3,
                                   block_term(op, 0, gp.padded_pods), phase="kernel_vs_plain_policy",
                                   kernel="choose_topology", nodes_real=len(gp.node_names))
            topo_err = max(topo_err, rec["max_abs_err"])
        zero_launches()
        train2 = train_run("cuda", 2, str(tmp / "train_card_w2.json"))
        train_launches = read_launches()
        train1 = train_run("cuda", 1, str(tmp / "train_card_w1.json"))
        add(train_launches)
        out, _ = child.communicate(timeout=900)
        errf.seek(0)
        if child.returncode != 0:
            raise SystemExit(f"item9: the CPU run failed ({child.returncode}): {errf.read()[-3000:]}")
        cpu = json.loads(out.strip().splitlines()[-1])
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        errf.close()

    # rebalance_row: the card against the CPU.
    ref = cpu["rebalance_row"]
    equal = {f: row[f] == ref[f] for f in REBALANCE_RESULT_FIELDS}
    add(row["launches"])
    emit({"phase": "rebalance_row", **{k: v for k, v in row.items() if k != "launches"},
          "launches": row["launches"], "seconds": row_s, "cpu_cycle_wall_total_s": ref["cycle_wall_total_s"],
          "cpu_solve_walls_s": ref["solve_walls_s"], "equal_to_cpu": equal, "nvidia_smi": smi})
    if not all(equal.values()) or row["preemption_churn"] or row["oversubscribed_added"] \
            or row["rebound_onto_oversubscribed"] or row["orphaned_migrations"] or row["launches"]["launches"] == 0 \
            or row["migrations"] == 0:
        raise SystemExit(f"rebalance_row: card and CPU differ ({equal}), or a check failed: {row}")

    # The 8 scenarios: the card against the CPU.
    for name in ITEM9_SCENARIOS:
        c, r = sims[name], cpu["sims"][name]
        cc, rc = c["card"], r["card"]
        differing = [q for q in sim_diff(cc, rc) if q not in SIM_CARD_VS_CPU]
        n = c["launches"]
        add(n)
        el, rb = cc["elasticity"], cc["rebalance"]
        emit({"phase": "sim_item9", "scenario": name, "seed": 0, "device": c["device"], "wall_s": c["wall_s"],
              "cpu_wall_s": r["wall_s"], "cycles": cc["cycles"], "controller_s": c["controller_s"],
              "controller_share": c["controller_s"] / c["wall_s"], "verdict_s": c["verdict_s"],
              "cpu_controller_s": r["controller_s"], "pass": cc["pass"], "cpu_pass": rc["pass"],
              "migrations": rb["migrations"], "packing_efficiency": rb["packing_efficiency"],
              "scale_ups": el["scale_ups"], "scale_downs": el["scale_downs"], "reclaims": el["reclaims"],
              "reclaim_orphans": el["reclaim_orphans"], "joint_objective": el["joint_objective"],
              "launches_choose": n["launches"], "launches_choose_topology": n["launches_topo"],
              "launches_constrained": n["launches_constrained"] + n["launches_constrained_topo"],
              "fingerprint": cc["fingerprint"][:16], "fingerprint_equal": cc["fingerprint"] == rc["fingerprint"],
              "differing_fields": differing, "nvidia_smi": smi})
        if c["device"] != "cuda" or differing or cc["fingerprint"] != rc["fingerprint"] or not cc["pass"]:
            raise SystemExit(f"sim_item9 {name}: card and CPU differ ({differing}) or the verdict failed")
        if n["launches"] + n["launches_topo"] + n["launches_constrained"] == 0:
            raise SystemExit(f"sim_item9 {name}: the card episode launched no choose kernel ({n})")

    # policy: objectives equal to the CPU's, the latency ratio on the card.
    pref = cpu["policy"]
    obj_equal = all(objectives[k] == pref[k] for k in ("scenarios", "objective_tuned", "objective_default",
                                                         "gates_green_under_tuned"))
    ratio = lat_tuned["delta_cycle_seconds_min"] / lat_default["delta_cycle_seconds_min"]
    emit({"phase": "policy", **objectives, "cpu_objectives_equal": obj_equal, "latency_tuned": lat_tuned,
          "latency_default": lat_default, "policy_latency_ratio": ratio, "tuned_name": tuned["profile"]["name"],
          "kernel_vs_plain_topology_max_abs_err": topo_err, "nvidia_smi": smi})
    if not obj_equal or not objectives["gates_green_under_tuned"]:
        raise SystemExit(f"policy: objectives differ from the CPU's ({objectives['scenarios']} vs "
                         f"{pref['scenarios']}) or a gate failed under the tuned weights")
    if lat_tuned["launches"]["launches"] == 0 or lat_default["launches"]["launches"] == 0:
        raise SystemExit("policy: a latency run launched kernel #1 no time")

    # train: the card's artifact against the CPU's and the one-worker run's.
    ctrain = cpu["train"]
    same_cpu = train2["rc"] == 0 and ctrain["rc"] == 0 and train2["artifact"] == ctrain["artifact"]
    same_w1 = train1["rc"] == 0 and without_workers(train1["artifact"]) == without_workers(train2["artifact"])
    emit({"phase": "train", "args": list(TRAIN_ARGS), "rc": train2["rc"], "seconds_workers_2": train2["seconds"],
          "seconds_workers_1": train1["seconds"], "cpu_seconds_workers_2": ctrain["seconds"],
          "report": train2["report"], "artifact_bytes": len(train2["artifact"] or ""),
          "artifact_equal_to_cpu": same_cpu, "artifact_equal_to_workers_1": same_w1, "launches": train_launches,
          "nvidia_smi": smi})
    if not (same_cpu and same_w1):
        raise SystemExit(f"train: artifacts differ (CPU {same_cpu}, workers 1 {same_w1}): {train2['stderr']}")
    if train_launches["launches"] + train_launches["launches_topo"] == 0:
        raise SystemExit(f"train: the card run launched no choose kernel ({train_launches})")
    emit({"phase": "item9", "launches": totals, "nvidia_smi": smi})
    return {"launches": totals, "max_abs_err": {"choose": e2e_err, "choose_topology": topo_err}}


# ---- the multi-process sharded cycle and the packing shim -----------------

# Two ranks, each a tp row of [cuda:0] * 2, so dp = 2 crosses them; gloo,
# because NCCL does not put two ranks on one card.  Each rank is killed
# past the timeout; every collective fails after the group's.
MULTIHOST_RANKS = 2
MULTIHOST_TIMEOUT_S = 300


def multihost_phase(smi: str, refs: dict, tmp: pathlib.Path) -> dict:
    """Two ranks of ``experiments/multihost_cards`` sharing card 0, each
    rank's bindings and rounds held against the single-process sharded
    results ``refs`` (case -> (assigned, rounds)), and launches = tp ·
    rounds a cycle.  A rank that fails, outlives its timeout or disagrees
    ends the script.  Returns the ranks' #2b launches."""
    t0 = time.perf_counter()
    try:
        records = multihost_cards.spawn(MULTIHOST_RANKS, [0, 0], True, tmp, MULTIHOST_TIMEOUT_S)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e
    wall = time.perf_counter() - t0
    launches = {"launches": 0, "launches_constrained": 0}
    for r, rec in enumerate(records):
        for case, (ref_assigned, ref_rounds) in refs.items():
            c = rec[case]
            c["equal_to_single_process"] = bool(np.array_equal(c.pop("assigned"), ref_assigned)
                                                and c["rounds"] == ref_rounds)
            per_cycle = sum(c["launches"].values()) / (len(c["seconds"]) + 1)
            c["launches_per_cycle"], c["expected_launches_per_cycle"] = per_cycle, 2 * c["rounds"]
            if not (c["equal_to_single_process"] and c["deterministic"]) or per_cycle != 2 * c["rounds"]:
                emit(dict(rec, phase="multihost"))
                raise SystemExit(f"multihost: rank {r}'s {case} disagrees with the single-process sharded cycle, "
                                 f"or launched {per_cycle} kernels a cycle against tp · rounds = {2 * c['rounds']}")
            launches["launches"] += c["launches"]["launches"]
            launches["launches_constrained"] += c["launches"]["launches_constrained"]
        if rec["backend"] != "gloo" or rec["row_offset"] != r or rec["mesh"] != [2, 2]:
            raise SystemExit(f"multihost: rank {r} ran {rec['backend']} on {rec['mesh']} from row {rec['row_offset']}")
        emit(dict(rec, phase="multihost"))
    emit({"phase": "multihost_seconds", "seconds": wall, "launches": launches, "nvidia_smi": smi})
    return launches


def native_ext_phase(snap, smi: str) -> dict:
    """The packing shim (``ops/native_ext``, built here with g++) on the
    flagship's 100,000 pending pods' cpu and memory strings against the
    port's Python quantity path (``api/quantity``): rows equal, both times;
    then a fresh pack of the whole snapshot with the time spent in the
    request sums and quantity parses it makes (cold parse caches), and that
    share of the pack."""
    import tpu_scheduler_torch.ops.pack as pack_mod
    from tpu_scheduler_torch.api.quantity import cpu_to_millis, memory_to_bytes
    from tpu_scheduler_torch.core.snapshot import ClusterSnapshot
    from tpu_scheduler_torch.ops import native_ext

    t0 = time.perf_counter()
    if not native_ext.available():
        raise SystemExit("native_ext: the shim did not build from tpu_scheduler_torch/csrc/pack.cpp")
    build_s = time.perf_counter() - t0
    requests = [p.spec.containers[0].resources.requests for p in snap.pending_pods()]
    cpu = [r.get("cpu") for r in requests]
    mem = [r.get("memory") for r in requests]

    def python_rows() -> np.ndarray:
        rows = np.empty((len(cpu), 2), dtype=np.int64)
        for i, (c, m) in enumerate(zip(cpu, mem)):
            rows[i, 0] = cpu_to_millis(c) if c is not None else 0
            rows[i, 1] = -(-(memory_to_bytes(m) if m is not None else 0) // 1024)
        return np.clip(rows, -(2**31 - 1), 2**31 - 1).astype(np.int32)

    def cold(fn):
        cpu_to_millis.cache_clear()
        memory_to_bytes.cache_clear()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    py_out, py_cold_s = cold(python_rows)
    py_warm_s = min(_timed(python_rows) for _ in range(3))
    native_out = native_ext.pack_requests(cpu, mem)
    native_s = min(_timed(lambda: native_ext.pack_requests(cpu, mem)) for _ in range(3))
    equal = bool(np.array_equal(native_out, py_out))
    # A fresh wave's pack, with the request sums and the allocatable
    # parses it calls timed in place (cold parse caches).
    spent = [0.0]

    def timing(fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t
        return wrapped

    names = ("total_pod_resources", "cpu_to_millis", "memory_to_bytes")
    saved = {n: getattr(pack_mod, n) for n in names}
    fresh = ClusterSnapshot.build(snap.nodes, snap.pods)
    try:
        for n in names:
            setattr(pack_mod, n, timing(saved[n]))
        _, pack_s = cold(lambda: pack_snapshot(fresh, pod_block=8192, node_block=128))
    finally:
        for n, fn in saved.items():
            setattr(pack_mod, n, fn)
    rec = {"phase": "native_ext", "pods": len(cpu), "equal": equal, "shim_build_or_load_seconds": build_s,
           "python_cold_seconds": py_cold_s, "python_warm_seconds": py_warm_s, "native_seconds": native_s,
           "python_over_native": py_warm_s / native_s, "fresh_pack_seconds": pack_s,
           "pack_quantity_seconds": spent[0], "pack_quantity_share": spent[0] / pack_s, "nvidia_smi": smi}
    emit(rec)
    if not equal:
        raise SystemExit("native_ext: the shim's request rows differ from the Python quantity path")
    return rec


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


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
    # ... and held at the multihost phase's shard of rank 1: the second half
    # of the pod rows against the second node column.
    mh_args = node_slice(block_args(a_flag, p_local, 2 * p_local), n_local, 2 * n_local)
    mh_equal, mh_err = outputs_equal(choose_block(*mh_args, w_thr, 1, node_offset=n_local),
                                     choose_block_plain(*mh_args, w_thr, 1, node_offset=n_local))
    emit({"phase": "kernel_vs_plain_multihost_shard", "kernel": "choose_block", "B": p_local, "N": n_local,
          "rows": [p_local, 2 * p_local], "node_offset": n_local, "equal": mh_equal, "max_abs_err": mh_err})
    if not mh_equal:
        raise SystemExit("kernel #2b disagrees with its plain version at the multihost shard of rank 1")
    shard_max_abs_err = max(offsets_rec["max_abs_err"], shard_err, mh_err)
    del mh_args
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
    rec, sresults = sharded_cycles("sharded_flagship", flagship, throughput, mesh22, 3, res)
    sharded_launches = rec["choose_launches"]
    multihost_refs = {"flagship": (sresults[-1].assigned, sresults[-1].rounds)}
    emit(dict(rec, bound_pods=20_000, unsharded_median_seconds=statistics.median(times[1:]), nvidia_smi=smi))
    wall_ms, rows = profiled(lambda: ShardedBackend(mesh22).schedule(flagship, throughput))
    emit(dict(device_split(wall_ms, rows, "choose_kernel"), phase="sharded_flagship_breakdown", mesh=[2, 2]))
    native_ext_phase(snap, smi)
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
    # ... and held at the multihost phase's shard of rank 1: the second half
    # of the pod rows against the second node column.
    half = cflag.padded_pods // 2
    mh_args = node_slice(block_args(arrays, half, cflag.padded_pods), cn_local, 2 * cn_local)
    mh_cons = block_cons(arrays, half, cflag.padded_pods)
    mh_equal, mh_err = outputs_equal(
        choose_block_constrained(*mh_args, mh_cons, cshard_masks, w_thr, 0, node_offset=cn_local),
        choose_block_constrained_plain(*mh_args, mh_cons, cshard_masks, w_thr, 0, node_offset=cn_local),
    )
    emit({"phase": "kernel_vs_plain_multihost_shard", "kernel": "choose_block_constrained", "B": half,
          "N": cn_local, "rows": [half, cflag.padded_pods], "node_offset": cn_local, "equal": mh_equal,
          "max_abs_err": mh_err})
    if not mh_equal:
        raise SystemExit("constrained kernel #2b disagrees with its plain version at the multihost shard of rank 1")
    cshard_mh_err = mh_err
    del mh_args, mh_cons
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
    # The same two cycles across two processes (parallel/multihost.py):
    # (2, 2) meshes whose dp rows are the two ranks.
    multihost_refs["constrained_flagship"] = (sresults[-1].assigned, sresults[-1].rounds)
    mh_dir = pathlib.Path(__file__).resolve().parent / "build"
    mh_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=mh_dir) as tmp:
        mh_launches = multihost_phase(smi, multihost_refs, pathlib.Path(tmp))
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
          "domains": [int(d) for d in tcompiled.dom_counts],
          "state_bytes": sum(int(v.nbytes) for v in tset.state_arrays().values()),
          "dense_term_bytes": (tset.n_gangs + 1) * tflag.padded_nodes * 4})

    term_card_vs_cpu(tflag, device, w_thr)

    # Kernels #1 and #2 with the gang term against their plain versions.
    trecs = []
    t_arrays, t_term = round_term(tflag, device, w_thr)
    first = block_args(t_arrays, 0, 8192)
    first_topo = block_term(t_term, 0, 8192)
    trecs.append(compare_topology("flagship_block_round0", first, w_thr, 1, first_topo))
    m_arrays, m_term = round_term(tflag, device, w_thr, placed_share=0.5, seed=31)
    trecs.append(compare_topology("flagship_block_mid_cycle", block_args(m_arrays, 0, 8192), w_thr, 7,
                                  block_term(m_term, 0, 8192)))
    del m_arrays, m_term
    small_args = block_args(a_small, 0, small.padded_pods)
    trecs.append(compare_topology("mixed_tiles", small_args, w_thr, 3,
                                  random_gang_term(small.padded_pods, small.padded_nodes, device, seed=41)))
    tie_args, tie_topo = topology_tie_case(device)
    trecs.append(compare_topology("term_ties", tie_args, no_jitter, 0, tie_topo))
    tie_choice = choose_block(*tie_args, no_jitter, 0, topo=tie_topo)[0]
    want = torch.where(tie_topo.gang_id > 0, 4 * tie_topo.gang_id + 1, 0)
    if not torch.equal(tie_choice, want.to(torch.int32)):
        raise SystemExit("term_ties: a tie made by the gang term did not resolve to the lowest node index")
    # Term magnitudes through the weight (0 and −0.0 included) and the level
    # distances: four levels from 1e-3 to 1e5.
    for k, weight in enumerate([0.0, -0.0, 1e-3, 1e-1, 1e1, 1e3, 1e5, 1e7, 1e9, -64.0]):
        trecs.append(compare_topology(
            "term_magnitudes", small_args, w_thr, 5,
            random_gang_term(small.padded_pods, small.padded_nodes, device, seed=42 + k, gangs=7, zero_share=0.1,
                             levels=((1e-3, 300), (1.0, 75), (1e2, 20), (1e5, 4)), weight=weight)))
    c_arrays, c_masks = constrained_round(csmall, device, seed=3)
    trecs.append(compare_topology("constrained_mixed_tiles", block_args(c_arrays, 0, b_small), w_thr, 2,
                                  random_gang_term(b_small, csmall.padded_nodes, device, seed=43),
                                  block_cons(c_arrays, 0, b_small), c_masks))
    del c_arrays, c_masks
    # The constrained + topology cell (bench.py's topology CPU shape with the
    # constrained row's fractions, gangs of 2-4): round 0 with its real term.
    ct_snap = synth_cluster(n_nodes=512, n_pending=8192, seed=0, gang_fraction=0.35, **CONS_FRACTIONS)
    ct, _ = with_constraints(ct_snap, pack_snapshot(ct_snap, pod_block=8192, node_block=128))
    ct = with_topology(ct_snap, ct)
    ct_arrays, ct_masks = constrained_round(ct, device)
    ct_term = round_term(ct, device, w_thr)[1]
    ct_args, ct_cons = block_args(ct_arrays, 0, 8192), block_cons(ct_arrays, 0, 8192)
    ct_topo = block_term(ct_term, 0, 8192)
    trecs.append(compare_topology("constrained_topology_round0", ct_args, w_thr, 1, ct_topo, ct_cons, ct_masks))
    topo_max_abs_err = max(r["max_abs_err"] for r in trecs if r["family"] == "plain")
    ctopo_max_abs_err = max(r["max_abs_err"] for r in trecs if r["family"] == "constrained")

    # Timed: the full-shape first block with the term and without it, in
    # interleaved rounds; the plain version apart.
    first_words = pack_node_words(*first[13:18])
    topo_ms, topo_plain_ms, err = timed_and_held(
        "choose_topology_timing", lambda: choose_block(*first, w_thr, 1, node_words=first_words, topo=first_topo),
        lambda: choose_block_plain(*first, w_thr, 1, topo=first_topo), reps=20, plain_reps=3,
    )
    topo_max_abs_err = max(topo_max_abs_err, err)
    tms = interleaved_ms({
        "term": lambda: choose_block(*first, w_thr, 1, node_words=first_words, topo=first_topo),
        "no_term": lambda: choose_block(*first, w_thr, 1, node_words=first_words),
    })
    topo_ms = statistics.median(tms["term"])
    topo_bound = topology_bound_ms(first, first_topo)
    emit({"phase": "choose_topology_timing", "B": 8192, "N": tflag.padded_nodes, "gang_rows": int(t_term.placed.shape[0]),
          "tile_rows": tile_rows(first_topo.gang_id, first[8]), "ms": topo_ms, "ms_spread": spread(tms["term"]),
          "ms_without_term": statistics.median(tms["no_term"]), "ms_without_term_spread": spread(tms["no_term"]),
          "plain_ms": topo_plain_ms, **topo_bound, "share_of_bound": topo_bound["bound_ms"] / topo_ms,
          "equal": True, "max_abs_err": err, "nvidia_smi": smi})
    ct_words = pack_node_words(*ct_args[13:18])
    _ctopo_ms, ctopo_plain_ms, err = timed_and_held(
        "choose_constrained_topology_timing",
        lambda: choose_block_constrained(*ct_args, ct_cons, ct_masks, w_thr, 1, node_words=ct_words, topo=ct_topo),
        lambda: choose_block_constrained_plain(*ct_args, ct_cons, ct_masks, w_thr, 1, topo=ct_topo),
        reps=20, plain_reps=3,
    )
    ctopo_max_abs_err = max(ctopo_max_abs_err, err)
    # #2t's time at this shape read 0.21-0.42 ms across earlier runs: 5
    # interleaved rounds of 50 launches with and without the term.
    cms = interleaved_ms({
        "term": lambda: choose_block_constrained(*ct_args, ct_cons, ct_masks, w_thr, 1, node_words=ct_words,
                                                 topo=ct_topo),
        "no_term": lambda: choose_block_constrained(*ct_args, ct_cons, ct_masks, w_thr, 1, node_words=ct_words),
    })
    ctopo_ms = statistics.median(cms["term"])
    ct_pod_ops, ct_node_ops = constrained_pod_operands(ct_cons, ct_masks), constrained_node_operands(ct_masks)
    ctopo_bound = topology_bound_ms(
        ct_args, ct_topo, [int(t.shape[1]) for t in ct_pod_ops], constrained_products(ct_pod_ops, ct_node_ops,
                                                                                   ct_args[8]))
    emit({"phase": "choose_constrained_topology_timing", "B": 8192, "N": ct.padded_nodes,
          "gang_rows": int(ct_term.placed.shape[0]), "ms": ctopo_ms, "ms_spread": spread(cms["term"]),
          "ms_without_term": statistics.median(cms["no_term"]), "ms_without_term_spread": spread(cms["no_term"]),
          "plain_ms": ctopo_plain_ms, **ctopo_bound, "share_of_bound": ctopo_bound["bound_ms"] / ctopo_ms,
          "equal": True, "max_abs_err": err, "nvidia_smi": smi})
    del t_arrays, t_term, first, first_topo, first_words, ct_arrays, ct_masks, ct_term, ct_args
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
    locality_mod.DENSE_TERMS_CUDA = 0
    miss_s, miss_res, miss_bytes = topology_cycles(tbackend, tflag, throughput, 3, fresh=True)
    hit_s, hit_res, hit_bytes = topology_cycles(tbackend, tflag, throughput, 3, fresh=False)
    tlaunches = choose_mod.LAUNCHES_TOPO
    tstray = [choose_mod.LAUNCHES, choose_mod.LAUNCHES_CONSTRAINED, choose_mod.LAUNCHES_CONSTRAINED_TOPO]
    dense_terms = locality_mod.DENSE_TERMS_CUDA
    peak_mem = torch.cuda.max_memory_allocated()
    if dense_terms:
        raise SystemExit(f"topology flagship: {dense_terms} dense [G+1, N] gang terms built on the card")
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
          "dense_terms_on_card": dense_terms, "peak_mem_bytes": peak_mem, "invariants": "ok", "nvidia_smi": smi})
    emit(topology_breakdown(tbackend, tflag, throughput))
    del tcl, tflag, tset, miss_res, hit_res, res, blind, tbackend
    torch.cuda.empty_cache()

    # ---- the controller over CudaBackend -----------------------------------
    logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)  # per-pod requeue lines
    emit(controller_e2e(smi))
    torch.cuda.empty_cache()
    delta_rec, steady_packed = controller_delta(smi)
    emit(delta_rec)
    torch.cuda.empty_cache()
    cons_packed = controller_parity(smi)
    torch.cuda.empty_cache()
    kernel_vs_plain_delta(steady_packed, cons_packed, throughput, device)
    del steady_packed, cons_packed
    build_dir = pathlib.Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        emit(controller_http(smi, pathlib.Path(tmp)))

    # ---- the simulator over CudaBackend ------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        sim_launches = sim_phase(smi, pathlib.Path(tmp))
    emit({"phase": "sim", "episodes": len(SIM_EPISODES) + 1, "seconds": time.perf_counter() - t0,
          "launches": sim_launches, "nvidia_smi": smi})

    # ---- the sharded control plane and the fleet ---------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        fleet = fleet_phases(smi, device, pathlib.Path(tmp))
    emit({"phase": "fleet_seconds", "seconds": time.perf_counter() - t0})

    # ---- the rebalancer, the autoscaler and the learned policy -------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        item9 = item9_phases(smi, device, pathlib.Path(tmp))
    emit({"phase": "item9_seconds", "seconds": time.perf_counter() - t0})

    # ---- the bisection kernels (experiments) -------------------------------
    brecs = bisect_phase(device, resources)

    emit({"kernels": [
        {
            "name": "choose", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/pallas_choose.py:356",
            "launches": launches + sim_launches["launches"] + fleet["launches"]["launches"]
            + item9["launches"]["launches"],
            "max_abs_err": max(max_abs_err, fleet["max_abs_err"]["choose"], item9["max_abs_err"]["choose"]),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        },
        {
            "name": "choose_constrained", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/pallas_choose.py:172",
            "launches": claunches + fleet["launches"]["launches_constrained"]
            + item9["launches"]["launches_constrained"],
            "max_abs_err": cons_max_abs_err, "ms": ctiming["ms"], "plain_ms": ctiming["plain_ms"],
            "bound_ms": ctiming["bound_ms"], "bound_by": ctiming["bound_by"], "library_ms": None,
        },
        {
            "name": "choose_sharded", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/parallel/sharded.py:264",
            "launches": sharded_launches + mh_launches["launches"],
            "max_abs_err": shard_max_abs_err,
            "ms": shard_ms, "plain_ms": shard_plain_ms, "bound_ms": shard_bound_ms, "bound_by": shard_bound_by,
            "library_ms": None,
        },
        {
            "name": "choose_constrained_sharded", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/parallel/sharded.py:264",
            "launches": sharded_claunches + mh_launches["launches_constrained"],
            "max_abs_err": max(cshard_max_abs_err, cshard_mh_err),
            "ms": cshard["ms"], "plain_ms": cshard["plain_ms"], "bound_ms": cshard["bound_ms"],
            "bound_by": cshard["bound_by"], "library_ms": None,
        },
        {
            "name": "choose_topology", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/assign.py:229-233 + tpu_scheduler/ops/score.py:141-150",
            "launches": tlaunches + sim_launches["launches_topo"] + fleet["launches"]["launches_topo"]
            + item9["launches"]["launches_topo"],
            "max_abs_err": max(topo_max_abs_err, fleet["max_abs_err"]["choose_topology"],
                               item9["max_abs_err"]["choose_topology"]), "ms": topo_ms,
            "plain_ms": topo_plain_ms,
            "bound_ms": topo_bound["bound_ms"], "bound_by": topo_bound["bound_by"], "library_ms": None,
        },
        {
            "name": "choose_constrained_topology", "route": "cuda", "source": "tpu_scheduler_torch/csrc/choose.cu",
            "replaces": "tpu_scheduler/ops/assign.py:229-233 + tpu_scheduler/ops/score.py:141-150",
            "launches": ctopo_launches + fleet["launches"]["launches_constrained_topo"]
            + item9["launches"]["launches_constrained_topo"],
            "max_abs_err": ctopo_max_abs_err, "ms": ctopo_ms,
            "plain_ms": ctopo_plain_ms, "bound_ms": ctopo_bound["bound_ms"], "bound_by": ctopo_bound["bound_by"],
            "library_ms": None,
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
