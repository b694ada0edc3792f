"""SolveState — the solve's memory between cycles.

A full-wave cycle derives node residual capacity from scratch (an O(bound
pods) sweep in ``ops/pack._alloc_and_used64``) and re-solves every eligible
pending pod.  The SolveState keeps both across cycles:

  • ``alloc64``/``used64`` — the exact int64 (allocatable, committed-usage)
    tensors over the packed node axis, updated by O(deltas) scatter work per
    cycle; ``residual_avail`` turns them into the same conservative int32
    ``node_avail`` a fresh pack would compute (identical math —
    ``ops/pack._avail_i32`` — so delta and full cycles see the same
    capacities).
  • ``placements`` — every committed placement (bound, dispatched, or
    breaker-deferred) with its exact request vector, so a later watch DELETE
    frees precisely what the commit consumed and a flushed deferred bind can
    never commit twice.
  • ``unsched`` — the skipped-verdict ledger: pods the solve proved
    unschedulable, skipped on later cycles until the invalidation closure
    (delta/index.py) retires the proof.

Capacity semantics mirror ``_alloc_and_used64`` exactly: requests are raw
int64 (cpu millicores, memory bytes, extended raw), pods bound to unknown
nodes consume nothing we track, and a request naming a resource outside the
packed vocabulary is a full-pack event (the engine escalates).

Port: a copy of ``tpu_scheduler/delta/state.py``, unchanged (NumPy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..api.objects import Pod, total_pod_resources
from ..ops.pack import _avail_i32

__all__ = ["SolveState", "req64_of"]


def req64_of(pod: Pod, res_vocab: tuple[str, ...], res_memo: dict | None = None):
    """The pod's exact request vector over ``res_vocab`` as [R] i64, or
    ``None`` when the pod names an extended resource outside the vocabulary
    (the caller must escalate — a new resource column is a full-pack
    event).  ``res_memo`` is the controller's id-keyed request memo
    (ops/pack semantics: identity-keyed with the object held)."""
    if res_memo is not None:
        hit = res_memo.get(id(pod))
        if hit is not None and hit[0] is pod:
            res = hit[1]
        else:
            res = total_pod_resources(pod)
            res_memo[id(pod)] = (pod, res)
    else:
        res = total_pod_resources(pod)
    out = np.zeros((len(res_vocab),), dtype=np.int64)
    out[0] = res.cpu
    out[1] = res.memory
    if res.extended:
        for name, v in res.extended.items():
            if not v:
                continue  # zero entries are vacuous, exactly as in fits_in
            try:
                out[res_vocab.index(name)] = v
            except ValueError:
                return None
    return out


@dataclass
class SolveState:
    """Persisted solve state, aligned to one packed node axis.

    Valid only while the node set/order (and therefore ``node_sig``) holds;
    any node-set change escalates to a full-wave rebuild rather than trying
    to remap rows.

    A deferred-bind flush and the watch event confirming our own POST both
    re-deliver ``commit``; the ``placements`` membership guard makes the
    duplicate a no-op, so capacity is consumed exactly once per committed
    pod and returned exactly once on release, whatever the delivery
    interleaving.
    """

    node_names: tuple[str, ...]
    node_sig: tuple
    res_vocab: tuple[str, ...]
    res_scales: tuple[int, ...]
    # Exact int64 capacity pair over the PADDED node axis ([N_pad, R]) —
    # the same layout ops/pack._alloc_and_used64 produces.
    alloc64: np.ndarray
    used64: np.ndarray
    # node name -> row in the padded axis.
    row: dict[str, int]
    # pod full name -> (node row or -1 for untracked nodes, node name,
    # [R] i64 request) for every committed placement.
    placements: dict[str, tuple[int, str, np.ndarray]] = field(default_factory=dict)
    # pod full name -> (has_pod_affinity, gang name or None, blocking node
    # set or None, constrained): the skipped-verdict ledger.  Membership
    # means "proven unschedulable and the proof still stands";
    # delta/index.py retires entries.  The BLOCKING SET is the pod's
    # node-locally-feasible node names — the only nodes where freed
    # capacity could cure a plain pod's verdict (None = unknown, treated
    # coarsely: any free retires).  ``constrained`` marks verdicts whose
    # feasibility entangles cross-node state (anti-affinity / pod-affinity
    # / spread / gang): a placed-pod deletion ANYWHERE can shift their
    # domain counts, so they always retire on any freed capacity.
    unsched: dict[str, tuple[bool, str | None, frozenset | None, bool]] = field(default_factory=dict)
    generation: int = 0
    delta_cycles_since_full: int = 0

    def residual_avail(self) -> np.ndarray:
        """The carried ``node_avail`` tensor — identical to what a fresh
        ``_alloc_and_used64`` + ``_avail_i32`` pass over the same committed
        state would produce (same floor-divide conservatism)."""
        return _avail_i32(self.alloc64, self.used64, self.res_scales)

    def commit(self, pod_full: str, node_name: str, req64: np.ndarray) -> bool:
        """Record one placement and consume its capacity EXACTLY ONCE: a pod
        already in the ledger (e.g. a deferred bind being flushed, or a
        watch event confirming our own POST) is a no-op.  Returns True when
        the entry was new."""
        if pod_full in self.placements:
            return False
        r = self.row.get(node_name, -1)
        if r >= 0:
            self.used64[r] += req64
        self.placements[pod_full] = (r, node_name, req64)
        self.unsched.pop(pod_full, None)
        return True

    def release(self, pod_full: str):
        """Retire one placement, freeing its capacity (watch DELETE, requeue
        after a failed async bind, out-of-band rebind adjustments).  Returns
        the freed NODE NAME (the invalidation closure's per-node blocking
        key), "" for a placement on an untracked node (freed, but outside
        the packed axis — callers treat it coarsely), or None when there
        was nothing to free."""
        ent = self.placements.pop(pod_full, None)
        if ent is None:
            return None
        r, node, req64 = ent
        if r >= 0:
            self.used64[r] -= req64
            return node
        return ""
