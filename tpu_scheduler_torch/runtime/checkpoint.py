"""Checkpoint/resume of scheduler-local state.

The reference has no checkpointing at all: on restart it rebuilds everything
from API-server watches (SURVEY.md §5 — "the API server *is* the
checkpoint").  This framework keeps that property for cluster state, and
additionally snapshots the two things a restart would otherwise lose or have
to recompute:

  • the requeue ledger — without it, a restarted scheduler immediately
    retries pods that had failed moments earlier (the reference's behavior:
    its 5-minute error_policy backoff, ``src/main.rs:122-125``, evaporates
    on restart);
  • the packed node-side tensors + selector vocabulary — the device-resident
    cache (ops/pack.py) that lets the first post-restart cycle take the
    cheap incremental path instead of a full repack.

Requeue deadlines are stored as *remaining seconds* because the scheduler
clock is monotonic (not wall) time; metric counters ride along so
``*_total`` series survive restarts, as Prometheus counters should.

Port: a copy of ``tpu_scheduler/runtime/checkpoint.py``.  The files are the
same — the same JSON keys, the same ``.npz`` array names — so a checkpoint
written by either package restores into the other.  A sharded scheduler
groups its entries under their stable-hash shards (``runtime/shards.
shard_for_name``), and a fleet that adopted a resized shard map writes the
v5 ``shard_map``, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..ops.pack import PackedCluster
from .shards import shard_for_name

__all__ = ["save_scheduler", "restore_scheduler", "CHECKPOINT_VERSION"]

# v2: soft-term (PreferNoSchedule / preferred-affinity) tensors + vocabs
# v3: sharded control plane (runtime/shards.py) — requeue state grouped by
#     stable-hash shard and the deferred-flush buffer persisted (each entry
#     tagged with its shard), so a replica restoring an orphaned shard's
#     checkpoint rebuilds exactly the per-pod state it now owns, flushes
#     each deferred bind at most once, and never resets a backoff
#     escalation.  v1/v2 checkpoints still restore (flat requeue fields;
#     deferred entries simply absent — those pods are still Pending on the
#     API server and get re-placed).
# v4: incremental delta engine (tpu_scheduler/delta) — the SolveState
#     GENERATION and escalation counters persist so the series survive
#     restarts, but the residual tensors/ledgers themselves deliberately do
#     NOT: restore always invalidates the engine ("restore"), forcing one
#     full-wave solve that rebuilds them from live watch state — stale
#     residuals are never trusted.  v1-v3 restore unchanged (no delta key;
#     the engine just starts cold, which forces the same full wave).
# v5: multi-mesh fleet (tpu_scheduler/fleet) — the adopted shard-map
#     (generation, count) persists so a restarted replica resumes the
#     RESIZED shard count instead of its constructed ``--shards`` (and never
#     re-adopts an older generation).  The topology keyer itself is NOT
#     persisted: it recompiles from the live node labels on the first
#     cycle, the same trust-nothing stance as the delta residuals.  v4
#     restores unchanged — no shard_map key, so the replica starts on its
#     constructed count and the existing ``invalidate("restore")`` full
#     wave doubles as the one-wave migration.
CHECKPOINT_VERSION = 5


_STATE_FILE = "state.json"
_TENSORS_FILE = "node_tensors.npz"


def save_scheduler(scheduler, path: str) -> None:
    """Write a checkpoint directory atomically (tmp + rename)."""
    os.makedirs(path, exist_ok=True)
    now = scheduler.clock()
    num_shards = max(1, getattr(scheduler, "num_shards", 1))
    meta = scheduler.requeue_at.meta()
    # v3 layout: per-pod requeue state grouped by stable-hash shard (name
    # hash; gang pods may SCHEDULE via their gang's shard, but the grouping
    # here is storage layout, not eligibility — restore flattens and the
    # controller's shard filter re-derives ownership live).  Remaining
    # seconds ride inside each entry because the scheduler clock is
    # monotonic, exactly as v2's flat field did.
    shard_state: dict[str, dict] = {}
    for k in scheduler.requeue_at:
        s = str(shard_for_name(k, num_shards))
        cls, n = meta.get(k, ("other", 0))
        shard_state.setdefault(s, {"requeue": {}})["requeue"][k] = [
            max(0.0, scheduler.requeue_at[k] - now),
            cls,
            int(n),
        ]
    state = {
        "version": CHECKPOINT_VERSION,
        "cycle_count": scheduler._cycle_count,
        "counters": dict(scheduler.metrics.counters),
        "shard_count": num_shards,
        "shards": shard_state,
        # The deferred-flush buffer, in flush (insertion) order, each entry
        # tagged with its shard.  Persisting it means a restart inside a
        # brownout keeps its decided placements and flushes each at most
        # once on recovery — a flushed-then-crashed entry is already bound
        # on the API server and drops as stale instead of re-POSTing.
        "deferred_binds": [
            [pf, node, shard_for_name(pf, num_shards)] for pf, node in scheduler.deferred_binds.items()
        ],
        # NoExecute tolerationSeconds clocks as ELAPSED time per
        # (pod, taint-key, taint-value): restarts/leader hand-offs must not
        # grant affected pods a fresh grace window (round-3 advisor) — under
        # periodic restarts a tolerating pod would otherwise never be
        # evicted.
        "noexecute_elapsed": [
            [list(key), max(0.0, now - first)] for key, first in scheduler._noexecute_seen.items()
        ],
        # PDB never-violate ledger: a successor baselining a crashed
        # workload at its degraded count would spend budget kube (desired-
        # replica accounting) forbids — peaks and disruption debt survive
        # restarts just like the NoExecute clocks.  Peak ages are stored as
        # cycles-since-met (cycle counters restore with the checkpoint).
        "pdb_peaks": {
            k: [peak, max(0, scheduler._cycle_count - met_at)]
            for k, (peak, met_at) in scheduler._pdb_peak_healthy.items()
        },
        "pdb_disruptions": {k: list(v) for k, v in scheduler._pdb_disruptions.items()},
        "node_sig": [list(pair) for pair in scheduler._node_sig] if scheduler._node_sig else None,
        # v5: the adopted fleet shard map (generation + count + keyer mode);
        # None for unsharded schedulers and fleets that never resized.
        "shard_map": (
            {
                "generation": scheduler.shard_set.map_generation,
                "num_shards": scheduler.shard_set.num_shards,
                "keyer": scheduler.shard_set.keyer.mode if scheduler.shard_set.keyer is not None else "hash",
            }
            if getattr(scheduler, "shard_set", None) is not None and scheduler.shard_set.map_generation > 0
            else None
        ),
        # Delta-engine continuity (counters only — residuals rebuild live).
        "delta": (
            {
                "generation": scheduler.delta.generation,
                "delta_cycles": scheduler.delta.delta_cycles,
                "skipped_total": scheduler.delta.skipped_total,
                "full_solve_reasons": dict(scheduler.delta.full_solve_reasons),
            }
            if getattr(scheduler, "delta", None) is not None
            else None
        ),
    }
    packed = scheduler._packed
    if packed is not None:
        state["vocab"] = [[k, v, i] for (k, v), i in packed.vocab.items()]
        state["taint_vocab"] = [[k, v, e, i] for (k, v, e), i in packed.taint_vocab.items()]
        state["soft_taint_vocab"] = [[k, v, e, i] for (k, v, e), i in packed.soft_taint_vocab.items()]
        # affinity-term keys are tuples of (key, op, values-tuple) triples
        state["aff_vocab"] = [
            [[[k, op, list(vals)] for k, op, vals in key], i] for key, i in packed.aff_vocab.items()
        ]
        state["pref_vocab"] = [
            [[[k, op, list(vals)] for k, op, vals in key], i] for key, i in packed.pref_vocab.items()
        ]
        state["node_names"] = list(packed.node_names)
        state["res_vocab"] = list(packed.res_vocab)
        state["res_scales"] = list(packed.res_scales)
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:  # file object: savez can't append ".npz"
            np.savez(
                f,
                node_alloc=packed.node_alloc,
                node_avail=packed.node_avail,
                node_labels=packed.node_labels,
                node_taints=packed.node_taints,
                node_aff=packed.node_aff,
                node_valid=packed.node_valid,
                node_taints_soft=packed.node_taints_soft,
                node_pref=packed.node_pref,
            )
        os.replace(tmp, os.path.join(path, _TENSORS_FILE))
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(state, f)
    os.replace(tmp, os.path.join(path, _STATE_FILE))


def restore_scheduler(scheduler, path: str) -> bool:
    """Fold a checkpoint into a freshly constructed Scheduler.

    Returns False (scheduler untouched) when no checkpoint exists; raises
    ``ValueError`` on a version mismatch.  The packed node tensors are only
    adopted as a *cache seed*: the controller's own signature check
    (Scheduler._pack) still verifies the node set before reusing them, so a
    stale checkpoint can cost one full repack but never a wrong decision.
    """
    state_path = os.path.join(path, _STATE_FILE)
    if not os.path.exists(state_path):
        return False
    with open(state_path) as f:
        state = json.load(f)
    # v1/v2 checkpoints (pre-soft-terms / pre-sharding) restore fine: v1's
    # soft vocab fields default to empty below and the tensor-consistency
    # gate skips its cache (one full repack); v2's flat requeue fields fold
    # into the queue exactly as before — shard assignment is re-derived
    # live by the controller's stable hash, never read from the file.
    if state.get("version") not in (1, 2, 3, 4, CHECKPOINT_VERSION):
        raise ValueError(f"checkpoint version {state.get('version')} != {CHECKPOINT_VERSION}")

    scheduler._cycle_count = state.get("cycle_count", 0)
    # v5: resume the adopted shard map.  The generation guard in
    # ShardSet._adopt_shard_map still lets a NEWER published map win on the
    # first refresh round; restoring here only prevents the restart from
    # racing the old count against peers that already adopted the resize.
    sm = state.get("shard_map")
    if sm is not None and getattr(scheduler, "shard_set", None) is not None:
        try:
            gen, count = int(sm.get("generation", 0)), int(sm.get("num_shards", 0))
        except (TypeError, ValueError):
            gen, count = 0, 0
        if gen > scheduler.shard_set.map_generation and count >= 1:
            scheduler.shard_set.map_generation = gen
            scheduler.shard_set.num_shards = count
            scheduler.num_shards = count
    if getattr(scheduler, "delta", None) is not None:
        # The escalation/generation series survive the restart; the
        # residual ledgers never do — force one full-wave rebuild.
        d = state.get("delta") or {}
        scheduler.delta.generation = int(d.get("generation", 0))
        scheduler.delta.delta_cycles = int(d.get("delta_cycles", 0))
        scheduler.delta.skipped_total = int(d.get("skipped_total", 0))
        scheduler.delta.full_solve_reasons = {
            str(k): int(v) for k, v in (d.get("full_solve_reasons") or {}).items()
        }
        scheduler.delta.invalidate("restore")
    for name, value in state.get("counters", {}).items():
        scheduler.metrics.counters[name] = value
    now = scheduler.clock()
    # Fold into the BackoffQueue IN PLACE (never replace it with a plain
    # dict — the controller's failure-class escalation lives on it); old
    # checkpoints without requeue_meta restore with attempts reset to 0.
    if state.get("version", 0) >= 3:
        deadlines: dict[str, float] = {}
        meta: dict[str, tuple] = {}
        for s in sorted(state.get("shards", {}), key=int):
            for k, (rem, cls, n) in state["shards"][s].get("requeue", {}).items():
                deadlines[k] = now + rem
                meta[k] = (str(cls), int(n))
        scheduler.requeue_at.restore(deadlines, meta)
        # Deferred-flush entries re-enter the buffer in flush order; the
        # controller's stale-drop (pod gone / already bound / node gone)
        # guarantees at-most-once flushing across the restart.
        for pf, node, _shard in state.get("deferred_binds", []):
            scheduler.deferred_binds[pf] = node
    else:
        scheduler.requeue_at.restore(
            {k: now + rem for k, rem in state.get("requeue_remaining", {}).items()},
            {k: (cls, int(n)) for k, (cls, n) in state.get("requeue_meta", {}).items()},
        )
    scheduler._noexecute_seen = {
        tuple(key): now - elapsed for key, elapsed in state.get("noexecute_elapsed", [])
    }
    scheduler._pdb_peak_healthy = {
        k: (int(peak), scheduler._cycle_count - int(age)) for k, (peak, age) in state.get("pdb_peaks", {}).items()
    }
    scheduler._pdb_disruptions = {k: tuple(v) for k, v in state.get("pdb_disruptions", {}).items()}
    if state.get("node_sig"):
        scheduler._node_sig = tuple((name, rv) for name, rv in state["node_sig"])

    tensors_path = os.path.join(path, _TENSORS_FILE)
    if state.get("vocab") is not None and os.path.exists(tensors_path):
        with np.load(tensors_path) as z:
            vocab = {(k, v): i for k, v, i in state["vocab"]}
            taint_vocab = {(k, v, e): i for k, v, e, i in state.get("taint_vocab", [])}
            soft_taint_vocab = {(k, v, e): i for k, v, e, i in state.get("soft_taint_vocab", [])}
            aff_vocab = {
                tuple((k, op, tuple(vals)) for k, op, vals in key): i for key, i in state.get("aff_vocab", [])
            }
            pref_vocab = {
                tuple((k, op, tuple(vals)) for k, op, vals in key): i for key, i in state.get("pref_vocab", [])
            }
            n_pad = z["node_alloc"].shape[0]
            res_vocab = tuple(state.get("res_vocab", ("cpu", "memory")))
            res_scales = tuple(state.get("res_scales", (1, 1024)))
            consistent = (
                z["node_avail"].shape == z["node_alloc"].shape == (n_pad, len(res_vocab))
                and len(res_scales) == len(res_vocab)
                and z["node_labels"].shape[0] == n_pad
                and "node_taints" in z
                and z["node_taints"].shape[0] == n_pad
                and "node_aff" in z
                and z["node_aff"].shape[0] == n_pad
                and len(aff_vocab) <= z["node_aff"].shape[1]
                and "node_taints_soft" in z
                and z["node_taints_soft"].shape[0] == n_pad
                and len(soft_taint_vocab) <= z["node_taints_soft"].shape[1]
                and "node_pref" in z
                and z["node_pref"].shape[0] == n_pad
                and len(pref_vocab) <= z["node_pref"].shape[1]
                and z["node_valid"].shape == (n_pad,)
                and len(vocab) <= z["node_labels"].shape[1]
                and len(taint_vocab) <= z["node_taints"].shape[1]
                and len(state.get("node_names", [])) <= n_pad
            )
            if not consistent:
                # A mismatched npz/state pair (e.g. partial write of an old
                # checkpoint) must never seed the cache — the scheduler just
                # does one full repack instead.
                return True
            p = scheduler.pod_block
            scheduler._packed = PackedCluster(
                node_alloc=z["node_alloc"],
                node_avail=z["node_avail"],
                node_labels=z["node_labels"],
                node_taints=z["node_taints"],
                node_aff=z["node_aff"],
                node_valid=z["node_valid"],
                node_taints_soft=z["node_taints_soft"],
                node_pref=z["node_pref"],
                node_names=tuple(state.get("node_names", [])),
                pod_req=np.zeros((p, len(res_vocab)), np.int32),
                pod_sel=np.zeros((p, z["node_labels"].shape[1]), np.float32),
                pod_sel_count=np.zeros((p,), np.float32),
                pod_ntol=np.zeros((p, z["node_taints"].shape[1]), np.float32),
                pod_aff=np.zeros((p, z["node_aff"].shape[1]), np.float32),
                pod_has_aff=np.zeros((p,), np.float32),
                pod_ntol_soft=np.zeros((p, z["node_taints_soft"].shape[1]), np.float32),
                pod_pref_w=np.zeros((p, z["node_pref"].shape[1]), np.float32),
                pod_prio=np.zeros((p,), np.int32),
                pod_valid=np.zeros((p,), bool),
                pod_names=(),
                vocab=vocab,
                res_vocab=res_vocab,
                res_scales=res_scales,
                taint_vocab=taint_vocab,
                aff_vocab=aff_vocab,
                soft_taint_vocab=soft_taint_vocab,
                pref_vocab=pref_vocab,
            )
    return True
