"""The delta engine of the port (``tpu_scheduler_torch/delta``) against the
JAX package's (``tpu_scheduler/delta``): the watch-event fold and the
invalidation closure on the same event streams, node compaction on the same
packed clusters, and the port's ``Scheduler(delta=True)`` over
``CudaBackend(device="cpu")`` against the JAX ``Scheduler(delta=True)`` over
``NativeBackend``, cycle by cycle, in the scenarios of the JAX package's
delta tests — per-cycle counts, ``delta.stats()``, the verdict ledger and
the placement ledger, the capacity audit against a fresh sweep, and the
final pod → node map, all exactly.  Every escalation reason the port can
raise is driven; ``delta_shadow_every=1`` holds the delta cycle to the full
solve with zero mismatches."""

import random
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.core.snapshot as jax_snapshot  # noqa: E402
import tpu_scheduler.delta.index as jax_index  # noqa: E402
import tpu_scheduler.delta.repack as jax_repack  # noqa: E402
import tpu_scheduler.delta.state as jax_state  # noqa: E402
import tpu_scheduler.ops.pack as jax_pack  # noqa: E402
import tpu_scheduler.runtime.checkpoint as jax_checkpoint  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.testing as jt  # noqa: E402
from conftest import FakeClock  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
from tpu_scheduler.models.profiles import PROFILES as JAX_PROFILES  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.core.snapshot as snapshot_mod  # noqa: E402
import tpu_scheduler_torch.delta.index as index_mod  # noqa: E402
import tpu_scheduler_torch.delta.repack as repack_mod  # noqa: E402
import tpu_scheduler_torch.delta.state as state_mod  # noqa: E402
import tpu_scheduler_torch.ops.pack as pack_mod  # noqa: E402
import tpu_scheduler_torch.runtime.checkpoint as checkpoint_mod  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from tpu_scheduler_torch.cli import MIXED_WORKLOAD  # noqa: E402
from tpu_scheduler_torch.core.predicates import make_spread_checker  # noqa: E402
from tpu_scheduler_torch.delta import ESCALATION_REASONS  # noqa: E402
from tpu_scheduler_torch.models.profiles import PROFILES  # noqa: E402


def _pod(port, p):
    return objects.Pod.from_dict(jax_objects.pod_to_dict(p)) if port else p


def _node(port, n):
    return objects.Node.from_dict(jax_objects.node_to_dict(n)) if port else n


class World:
    """One package's delta world: its API server and clock, its schedulers,
    and the record of every cycle (counts, engine stats, ledgers)."""

    def __init__(self, port: bool, tmp=None):
        self.port = port
        self.tmp = tmp
        self.clock = FakeClock()
        self.api = (fake_api if port else jax_fake_api).FakeApiServer(clock=self.clock)
        self.rows = []
        self.scheds = []

    def pod(self, p):
        return _pod(self.port, p)

    def node(self, n):
        return _node(self.port, n)

    def load(self, nodes, pods):
        self.api.load([self.node(n) for n in nodes], [self.pod(p) for p in pods])

    def create_pod(self, p):
        self.api.create_pod(self.pod(p))

    def bind_out_of_band(self, namespace, name, node):
        """Another binder's POST, past any hold on this world's own."""
        mod = objects if self.port else jax_objects
        type(self.api).create_binding(self.api, namespace, name, mod.ObjectReference(name=node))

    def scheduler(self, profile_kw=None, requeue_seconds=0.0, seed=7, **kw):
        profile = (PROFILES if self.port else JAX_PROFILES)["default"].with_(**(profile_kw or {}))
        mod = controller if self.port else jax_controller
        backend = CudaBackend(device="cpu") if self.port else NativeBackend()
        sched = mod.Scheduler(self.api, backend, profile=profile, clock=self.clock, rng=random.Random(seed),
                              requeue_seconds=requeue_seconds, **kw)
        self.scheds.append(sched)
        return sched

    def checkpoint(self):
        return checkpoint_mod if self.port else jax_checkpoint

    def cycle(self, sched, audit=True, read=True):
        """One cycle and its row; ``read=False`` leaves the ledgers unread
        (and unaudited) after it, as a cycle of the daemon does."""
        m = sched.run_cycle()
        st = sched.delta.state if sched.delta is not None else None
        ledger = None
        if st is not None and read:
            ledger = (sorted(st.unsched.items()),
                      sorted((pf, r, node, tuple(int(x) for x in req)) for pf, (r, node, req) in st.placements.items()))
            if audit:
                _audit_capacity(self.port, sched)
        self.rows.append(((m.pending, m.bound, m.unschedulable, m.rounds),
                          sched.delta.stats() if sched.delta is not None else None, ledger))
        return m

    def placement(self):
        return sorted((f"{p.metadata.namespace or 'default'}/{p.metadata.name}", p.spec.node_name if p.spec else None)
                      for p in self.api.list_pods())


def _audit_capacity(port, sched) -> None:
    """The engine's carried used64 equals a fresh exact sweep over the live
    API state (plus the deferred and assumed commitments the API does not
    show yet) — the ledger-truth invariant of the JAX package's delta tests."""
    snap_mod, pack, state = (snapshot_mod, pack_mod, state_mod) if port else (jax_snapshot, jax_pack, jax_state)
    st = sched.delta.state
    snap = snap_mod.ClusterSnapshot.build(sched.api.list_nodes(), sched.api.list_pods())
    extra = dict(sched.deferred_binds)
    extra.update(sched._assumed)
    alloc64, used64, row = pack._alloc_and_used64(snap, st.alloc64.shape[0], None, st.res_vocab)
    by_full = {f"{q.metadata.namespace or 'default'}/{q.metadata.name}": q for q in snap.pods}
    for pf, node in extra.items():
        p = by_full.get(pf)
        if p is not None and (p.spec is None or p.spec.node_name is None) and node in row:
            used64[row[node]] += state.req64_of(p, st.res_vocab)
    assert (st.alloc64 == alloc64).all(), "alloc drifted from the live truth"
    assert (st.used64 == used64).all(), "used64 drifted from the live truth"


# --- scenarios (the JAX package's tests/test_delta.py, driven on both sides) ---


def sc_standing_verdict(w):
    """A verdict stands (its re-solve is skipped) until capacity frees."""
    w.load([jt.make_node("n1", cpu="4", memory="8Gi")], [jt.make_pod("filler", cpu="3", memory="1Gi")])
    s = w.scheduler()
    w.cycle(s)
    w.create_pod(jt.make_pod("big", cpu="3", memory="1Gi"))
    w.cycle(s)
    w.cycle(s)
    w.api.delete_pod("default", "filler")
    w.cycle(s)
    return s


def sc_unrelated_node_churn(w):
    """Per-node blocking sets: a free on a selector-excluded node leaves the
    verdict standing, a free on a blocking node retires it."""
    w.load([jt.make_node("a1", cpu="4", memory="8Gi", labels={"zone": "zone-a"}),
            jt.make_node("b1", cpu="8", memory="16Gi", labels={"zone": "zone-b"})],
           [jt.make_pod("fill-a", cpu="3", memory="1Gi", node_selector={"zone": "zone-a"}),
            jt.make_pod("fill-b", cpu="2", memory="1Gi", node_selector={"zone": "zone-b"})])
    s = w.scheduler()
    w.cycle(s)
    w.create_pod(jt.make_pod("pinned", cpu="3", memory="1Gi", node_selector={"zone": "zone-a"}))
    w.cycle(s)
    assert s.delta.state.unsched["default/pinned"][2] == frozenset({"a1"})
    w.api.delete_pod("default", "fill-b")
    w.cycle(s)
    w.api.delete_pod("default", "fill-a")
    w.cycle(s)
    return s


def sc_constrained_verdict(w):
    """An anti-affinity verdict retires on any freed capacity."""
    w.load([jt.make_node("n1", cpu="4", memory="8Gi", labels={"zone": "zone-a"}),
            jt.make_node("n2", cpu="4", memory="8Gi", labels={"zone": "zone-a"})],
           [jt.make_pod("carrier", cpu="1", memory="1Gi", labels={"app": "x"})])
    s = w.scheduler()
    w.cycle(s)
    w.create_pod(jt.make_pod("anti", cpu="1", memory="1Gi", anti_affinity=[
        jax_objects.PodAntiAffinityTerm(topology_key="zone", match_labels={"app": "x"})]))
    w.cycle(s)
    assert s.delta.state.unsched["default/anti"][3] is True
    w.api.delete_pod("default", "carrier")
    w.cycle(s)
    return s


def sc_modified_pod(w):
    """A re-created pod re-dirties its own verdict."""
    w.load([jt.make_node("n1", cpu="2", memory="4Gi")], [jt.make_pod("wants-too-much", cpu="8", memory="1Gi")])
    s = w.scheduler()
    w.cycle(s)
    w.api.delete_pod("default", "wants-too-much")
    w.create_pod(jt.make_pod("wants-too-much", cpu="1", memory="1Gi"))
    w.cycle(s)
    return s


def sc_gang_closure(w):
    """A fresh gang member retires its mates' verdicts; pending deletes
    shrink the gang until it fits."""
    w.load([jt.make_node("n1", cpu="5", memory="16Gi")],
           [jt.make_pod("g-0", cpu="3", memory="1Gi", gang="g"), jt.make_pod("g-1", cpu="3", memory="1Gi", gang="g")])
    s = w.scheduler(requeue_seconds=5.0)
    w.cycle(s)
    w.clock.t = 1.0
    w.create_pod(jt.make_pod("g-2", cpu="3", memory="1Gi", gang="g"))
    w.cycle(s)
    w.clock.t = 200.0
    w.cycle(s)
    w.api.delete_pod("default", "g-1")
    w.api.delete_pod("default", "g-2")
    w.clock.t = 600.0
    w.cycle(s)
    return s


def sc_pod_affinity_seeker(w):
    """A fresh placement retires a positive pod-affinity seeker's verdict."""
    term = [jax_objects.PodAffinityTerm(match_labels={"app": "anchor"}, topology_key="zone")]
    w.load([jt.make_node("n1", cpu="8", memory="16Gi", labels={"zone": "a"})], [])
    s = w.scheduler()
    w.cycle(s, audit=False)  # an empty first cycle stays cold: no SolveState to audit
    w.create_pod(jt.make_pod("seeker", cpu="1", memory="1Gi", labels={"app": "web"}, pod_affinity=term))
    w.cycle(s)
    w.create_pod(jt.make_pod("anchor", cpu="1", memory="1Gi", labels={"app": "anchor"}))
    w.cycle(s)
    w.cycle(s)
    return s


def sc_capacity_ledger_churn(w):
    """Completions and fresh arrivals over ten delta cycles; the ledger is
    audited after each."""
    base = jt.synth_cluster(n_nodes=20, n_pending=100, n_bound=40, seed=3)
    w.load(base.nodes, base.pods)
    s = w.scheduler()
    w.cycle(s)
    bound = sorted((p for p in w.api.list_pods() if p.spec is not None and p.spec.node_name),
                   key=lambda p: p.metadata.name)
    for i, p in enumerate(bound[:10]):
        w.api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        if i % 2 == 0:
            w.create_pod(jt.make_pod(f"fresh-{i}", cpu="1", memory="1Gi"))
        w.cycle(s)
    return s


def sc_breaker_recovery(w):
    """A brownout defers a placement (committed once), the flush confirms it
    without double counting, and the recovery escalates."""
    w.load([jt.make_node("n1", cpu="16", memory="32Gi")], [])
    s = w.scheduler()
    w.cycle(s, audit=False)
    w.api.fail_next_bindings = 10
    for i in range(6):
        w.create_pod(jt.make_pod(f"fail-{i}", cpu="1", memory="1Gi"))
        w.clock.t += 1.0
        w.cycle(s)
    assert s.breaker.state == "open"
    w.create_pod(jt.make_pod("held", cpu="2", memory="2Gi"))
    w.clock.t += 0.1
    w.cycle(s)
    assert "default/held" in s.deferred_binds and "default/held" in s.delta.state.placements
    w.api.fail_next_bindings = 0
    w.clock.t += 120.0
    for _ in range(8):
        w.clock.t += 10.0
        w.cycle(s)
    assert not s.deferred_binds
    return s


def sc_failed_async_bind(w):
    """A pipelined bind that fails releases its capacity (uncommit)."""
    w.load([jt.make_node("n1", cpu="4", memory="8Gi")], [])
    s = w.scheduler(pipeline=True)
    w.cycle(s, audit=False)
    w.api.fail_next_bindings = 1
    w.create_pod(jt.make_pod("p1", cpu="1", memory="1Gi"))
    w.cycle(s)
    s._join_binds()
    w.cycle(s)
    w.cycle(s)
    s._join_binds()
    w.cycle(s)
    s.close()
    return s


def sc_node_change(w):
    """A node joins: the next cycle escalates to a full wave."""
    w.load([jt.make_node("n1", cpu="4", memory="8Gi")], [jt.make_pod("p1", cpu="1", memory="1Gi")])
    s = w.scheduler()
    w.cycle(s)
    w.api.create_node(w.node(jt.make_node("n2", cpu="4", memory="8Gi")))
    w.create_pod(jt.make_pod("p2", cpu="1", memory="1Gi"))
    w.cycle(s)
    return s


def sc_epoch_refresh(w):
    """Every third delta cycle escalates (``epoch_refresh = 3``)."""
    w.load([jt.make_node("n1", cpu="64", memory="128Gi")], [])
    s = w.scheduler()
    s.delta.epoch_refresh = 3
    w.cycle(s, audit=False)
    for i in range(12):
        w.create_pod(jt.make_pod(f"p-{i}", cpu="100m", memory="64Mi"))
        w.cycle(s)
    return s


def sc_closure_overflow(w):
    """A dirty wave above the overflow threshold escalates."""
    w.load([jt.make_node("n1", cpu="64", memory="128Gi")], [])
    s = w.scheduler()
    s.delta.OVERFLOW_MIN = 2
    w.cycle(s, audit=False)
    w.create_pod(jt.make_pod("a", cpu="100m", memory="64Mi"))
    w.cycle(s)
    for i in range(8):
        w.create_pod(jt.make_pod(f"wave-{i}", cpu="100m", memory="64Mi"))
    w.cycle(s)
    return s


def sc_vocab_change(w):
    """A dirty pod names an extended resource outside the packed
    vocabulary: a full-pack event."""
    w.load([jt.make_node("n1", cpu="8", memory="16Gi", extended={"example.com/fpga": "2"})],
           [jt.make_pod("p0", cpu="1", memory="1Gi")])
    s = w.scheduler()
    w.cycle(s)
    w.create_pod(jt.make_pod("p1", cpu="1", memory="1Gi", extended={"example.com/fpga": "1"}))
    w.cycle(s)
    w.create_pod(jt.make_pod("p2", cpu="1", memory="1Gi"))
    w.cycle(s)
    return s


def sc_preempting_profile(w):
    """Under preemption no verdict is skipped."""
    w.load([jt.make_node("n1", cpu="2", memory="4Gi")], [jt.make_pod("low", cpu="2", memory="1Gi", priority=0)])
    s = w.scheduler(profile_kw=dict(preemption=True))
    w.cycle(s)
    w.create_pod(jt.make_pod("high", cpu="2", memory="1Gi", priority=100))
    # No capacity audit: the eviction's DELETE folds on the next cycle.
    w.cycle(s, audit=False)
    w.cycle(s, audit=False)
    return s


def sc_takeover(w):
    """Leader election: the standby takes over when the leader hands off
    and its first owned cycle escalates."""
    nodes, pods = [jt.make_node(f"n{i}", cpu="4", memory="8Gi") for i in range(3)], \
        [jt.make_pod(f"p{i}", cpu="1", memory="1Gi") for i in range(6)]
    w.load(nodes, pods)
    a = w.scheduler(leader_elect=True, identity="replica-a", lease_duration=15.0, seed=1)
    b = w.scheduler(leader_elect=True, identity="replica-b", lease_duration=15.0, seed=2)
    w.cycle(a)
    w.cycle(b, audit=False)
    w.create_pod(jt.make_pod("late", cpu="1", memory="1Gi"))
    a.close()
    w.clock.t += 1.0
    w.cycle(b)
    w.create_pod(jt.make_pod("later", cpu="1", memory="1Gi"))
    w.cycle(b)
    return b


def sc_restore(w):
    """A checkpoint restore forces one full wave ("restore") and keeps the
    engine's counters."""
    w.load([jt.make_node("n1", cpu="8", memory="16Gi")], [jt.make_pod("p1", cpu="1", memory="1Gi")])
    s = w.scheduler()
    w.cycle(s)
    w.create_pod(jt.make_pod("p2", cpu="1", memory="1Gi"))
    w.cycle(s)
    path = str(w.tmp / ("port" if w.port else "jax"))
    w.checkpoint().save_scheduler(s, path)
    s2 = w.scheduler()
    assert w.checkpoint().restore_scheduler(s2, path) is True
    w.create_pod(jt.make_pod("p3", cpu="1", memory="1Gi"))
    w.cycle(s2)
    w.create_pod(jt.make_pod("p4", cpu="1", memory="1Gi"))
    w.cycle(s2)
    return s2


# The CLI's mixed workload less its cross-node constraints (anti-affinity,
# spread, pod affinity): the shadow check skips constrained batches, whose
# stall mop-up runs outside the solver.
SHADOW_WORKLOAD = {k: v for k, v in MIXED_WORKLOAD.items()
                   if k not in ("anti_affinity_fraction", "spread_fraction", "schedule_anyway_fraction",
                                "pod_affinity_fraction", "preferred_pod_affinity_fraction")}


def sc_shadow(w):
    """Selectors, taints, node affinity hard and soft, gangs and extended
    resources with churn under ``delta_shadow_every=1``: every delta cycle
    is held against the full solve."""
    snap = jt.synth_cluster(n_nodes=30, n_pending=240, n_bound=40, seed=4, **SHADOW_WORKLOAD)
    w.load(snap.nodes, snap.pods)
    s = w.scheduler(delta_shadow_every=1)
    w.cycle(s)
    tmpl = jt.synth_cluster(n_nodes=30, n_pending=60, seed=5).pending_pods()
    for c in range(4):
        bound = sorted((p for p in w.api.list_pods() if p.spec is not None and p.spec.node_name),
                       key=lambda p: p.metadata.name)
        for p in bound[c * 8:(c + 1) * 8]:
            w.api.delete_pod(p.metadata.namespace or "default", p.metadata.name)
        for p in tmpl[c * 15:(c + 1) * 15]:
            w.create_pod(jt.make_pod(f"c{c}-{p.metadata.name}", cpu="500m", memory="512Mi"))
        w.clock.t += 1.0
        w.cycle(s)
    return s


def sc_mesh_rebind(w):
    """The fleet: two replicas split four rack-keyed shards (a node slice
    each), replica a crashes without releasing its leases, and the
    survivor's takeover rebinds the absorbed shards' meshes and escalates
    one "mesh-rebind" full wave.  (The capacity audit reads the whole
    cluster; a sliced replica's ledger holds its slice, so it is off.)"""
    rack = "topology.tpu-scheduler/rack"
    w.load([jt.make_node(f"n{i}", cpu="4", memory="8Gi", labels={rack: f"rack-{i // 2}"}) for i in range(8)],
           [jt.make_pod(f"p{i}", cpu="1", memory="1Gi") for i in range(6)])
    a = w.scheduler(shards=4, identity="replica-a", lease_duration=5.0, seed=1)
    b = w.scheduler(shards=4, identity="replica-b", lease_duration=5.0, seed=2)
    for _ in range(4):
        w.cycle(a, audit=False)
        w.cycle(b, audit=False)
        w.clock.t += 1.0
    for i in range(8):
        w.create_pod(jt.make_pod(f"late{i}", cpu="1", memory="1Gi"))
    for _ in range(9):
        w.clock.t += 1.0
        w.cycle(b, audit=False)
    return b


def _hold_binds(w, s):
    """Hold the bind worker's POSTs until the returned event is set; a
    dispatch while a held batch is in flight sets it first, so the batch
    completes before the next is handed over."""
    gate = threading.Event()
    post = w.api.create_binding
    dispatch = s._dispatch_binds

    def held_post(namespace, name, target):
        gate.wait(30.0)
        return post(namespace, name, target)

    def dispatch_releasing(result):
        if s._bind_inflight is not None and not s._bind_inflight[1].is_set():
            gate.set()
        dispatch(result)

    w.api.create_binding = held_post
    s._dispatch_binds = dispatch_releasing
    return gate


def sc_cycle_beside_inflight_binds(w):
    """Cycles while a pipelined bind batch is held in flight: first with
    nothing but its assumed pods pending (the port overlays them through a
    view of the snapshot), then with new pods pending beside them (bound
    clones); the batch's confirmations then fold against a ledger no one
    has read since the wave (the port's is still deferred)."""
    w.load([jt.make_node(f"n{i}", cpu="4", memory="8Gi") for i in range(3)], [jt.make_pod("b0", cpu="1", memory="1Gi")])
    s = w.scheduler(pipeline=True)
    w.cycle(s)
    s._join_binds()
    gate = _hold_binds(w, s)
    w.cycle(s)  # warm: a delta cycle with nothing to do
    for i in range(4):
        w.create_pod(jt.make_pod(f"a{i}", cpu="1", memory="1Gi"))
    w.cycle(s, read=False)
    assert not gate.is_set()
    m = w.cycle(s, read=False)
    if w.port:
        assert m.spans.get("overlay/assumed_view_pods") == 4 and "overlay/assumed_cloned_pods" not in m.spans
        assert s.metrics.snapshot().get("scheduler_assumed_overlay_view_pods_total") == 4
    gate.clear()
    for i in range(3):
        w.create_pod(jt.make_pod(f"c{i}", cpu="500m", memory="512Mi"))
    m = w.cycle(s)
    if w.port:
        assert m.spans.get("overlay/assumed_cloned_pods") == 4 and "overlay/assumed_view_pods" not in m.spans
    gate.set()
    s._join_binds()
    w.cycle(s)
    w.cycle(s)
    return s


def sc_early_overflow(w):
    """A wave whose pending pods without a standing verdict already pass
    the overflow threshold escalates before the fold; the ledgers after the
    rebuild (left unread through the wave's drain) and the next delta
    cycle hold."""
    w.load([jt.make_node("n1", cpu="64", memory="128Gi"), jt.make_node("n2", cpu="64", memory="128Gi")],
           [jt.make_pod("b0", cpu="1", memory="1Gi")])
    s = w.scheduler(pipeline=True)
    s.delta.OVERFLOW_MIN = 2
    w.cycle(s)
    s._join_binds()
    w.api.delete_pod("default", "b0")
    for i in range(8):
        w.create_pod(jt.make_pod(f"wave-{i}", cpu="100m", memory="64Mi"))
    m = w.cycle(s, read=False)
    if w.port:
        assert m.spans.get("delta/early_escalations") == 1 and s.delta.state._deferred is not None
        assert s.metrics.snapshot().get("scheduler_delta_early_escalations_total") == 1
    s._join_binds()
    w.cycle(s, read=False)  # folds the wave's confirmations
    if w.port:
        assert s.delta.state._deferred is not None
    w.create_pod(jt.make_pod("late", cpu="100m", memory="64Mi"))
    w.cycle(s)
    s._join_binds()
    w.cycle(s)
    return s


def sc_deferred_rebind(w):
    """While a wave's ledger is still unread, one of its pods is bound out
    of band to another node than the wave chose (the wave's own POST then
    meets a 409): the fold of the wave's bindings moves that pod's mass."""
    w.load([jt.make_node("n1", cpu="64", memory="128Gi"), jt.make_node("n2", cpu="64", memory="128Gi")],
           [jt.make_pod("b0", cpu="1", memory="1Gi")])
    s = w.scheduler(pipeline=True)
    s.delta.OVERFLOW_MIN = 2
    w.cycle(s)
    s._join_binds()
    gate = _hold_binds(w, s)
    for i in range(8):
        w.create_pod(jt.make_pod(f"wave-{i}", cpu=f"{i + 1}00m", memory="64Mi"))
    w.cycle(s, read=False)
    chosen = s._assumed["default/wave-3"]
    other = "n1" if chosen == "n2" else "n2"
    w.bind_out_of_band("default", "wave-3", other)
    gate.set()
    s._join_binds()
    w.cycle(s, read=False)
    if w.port:
        assert s.delta.state._deferred is None  # the rebind was no confirmation
    w.cycle(s)
    return s


def sc_early_overflow_vocab(w):
    """A wave that overflows and also binds a pod naming an extended
    resource outside the vocabulary escalates as "vocab-change", decided
    before the fold as well."""
    w.load([jt.make_node("n1", cpu="64", memory="128Gi", extended={"example.com/fpga": "4"})],
           [jt.make_pod("p0", cpu="1", memory="1Gi")])
    s = w.scheduler()
    s.delta.OVERFLOW_MIN = 2
    w.cycle(s)
    w.create_pod(jt.make_pod("pinned", cpu="1", memory="1Gi", extended={"example.com/fpga": "1"}, node_name="n1",
                             phase="Running"))
    for i in range(8):
        w.create_pod(jt.make_pod(f"wave-{i}", cpu="100m", memory="64Mi"))
    m = w.cycle(s)
    if w.port:
        assert m.spans.get("delta/early_escalations") == 1
    assert s.delta.stats()["full_solve_reasons"] == {"cold": 1, "vocab-change": 1}
    w.create_pod(jt.make_pod("late", cpu="100m", memory="64Mi"))
    w.cycle(s)
    return s


SCENARIOS = {
    "standing_verdict": (sc_standing_verdict, None),
    "unrelated_node_churn": (sc_unrelated_node_churn, None),
    "constrained_verdict": (sc_constrained_verdict, None),
    "modified_pod": (sc_modified_pod, None),
    "gang_closure": (sc_gang_closure, None),
    "pod_affinity_seeker": (sc_pod_affinity_seeker, None),
    "capacity_ledger_churn": (sc_capacity_ledger_churn, None),
    "breaker_recovery": (sc_breaker_recovery, "breaker-recovery"),
    "failed_async_bind": (sc_failed_async_bind, None),
    "node_change": (sc_node_change, "node-change"),
    "epoch_refresh": (sc_epoch_refresh, "epoch-refresh"),
    "closure_overflow": (sc_closure_overflow, "closure-overflow"),
    "vocab_change": (sc_vocab_change, "vocab-change"),
    "preempting_profile": (sc_preempting_profile, None),
    "takeover": (sc_takeover, "takeover"),
    "restore": (sc_restore, "restore"),
    "shadow": (sc_shadow, None),
    "mesh_rebind": (sc_mesh_rebind, "mesh-rebind"),
    "cycle_beside_inflight_binds": (sc_cycle_beside_inflight_binds, None),
    "early_overflow": (sc_early_overflow, "closure-overflow"),
    "early_overflow_vocab": (sc_early_overflow_vocab, "vocab-change"),
    "deferred_rebind": (sc_deferred_rebind, "closure-overflow"),
}


def _drive(name, port, tmp_path):
    w = World(port, tmp_path)
    sched = SCENARIOS[name][0](w)
    for s in w.scheds:
        s.close()
    return w, sched


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_delta_controller_matches_jax(name, tmp_path):
    """The port's delta cycles against the JAX package's, exactly: per
    cycle the counts, ``delta.stats()`` and both ledgers; the final pod →
    node map; every escalation reason the scenario is about."""
    pw, ps = _drive(name, True, tmp_path)
    jw, js = _drive(name, False, tmp_path)
    assert len(pw.rows) == len(jw.rows)
    for i, (p_row, j_row) in enumerate(zip(pw.rows, jw.rows)):
        assert p_row == j_row, f"cycle {i}"
    assert pw.placement() == jw.placement()
    stats = ps.delta.stats()
    assert stats["delta_cycles"] > 0 or name in ("node_change", "closure_overflow")
    assert stats["shadow_mismatches"] == 0
    reason = SCENARIOS[name][1]
    if reason is not None:
        assert stats["full_solve_reasons"].get(reason, 0) >= 1, stats
    if name == "shadow":
        assert stats["shadow_checks"] >= 4 and stats["shadow_skipped"] == 0
    if name == "standing_verdict":
        assert stats["skipped_total"] >= 1 and stats["full_solves"] == 1
    if name == "preempting_profile":
        assert stats["skipped_total"] == 0


def test_every_escalation_reason_but_mesh_rebind_is_driven():
    """The scenarios above cover the closed vocabulary, "mesh-rebind" (the
    fleet's takeover) included."""
    driven = {r for _fn, r in SCENARIOS.values() if r is not None} | {"cold"}
    assert driven == set(ESCALATION_REASONS)
    with pytest.raises(ValueError):
        controller.Scheduler(fake_api.FakeApiServer(), CudaBackend(device="cpu")).delta.invalidate("bogus")


def test_scheduler_defaults_to_delta():
    sched = controller.Scheduler(fake_api.FakeApiServer(), CudaBackend(device="cpu"))
    assert sched.delta is not None and sched.delta.stats()["enabled"]
    assert controller.Scheduler(fake_api.FakeApiServer(), CudaBackend(device="cpu"), policy="sample").delta is None


def test_backend_failure_in_a_delta_cycle_propagates():
    """A BackendUnavailable inside a delta cycle leaves run_cycle: nothing
    retries on the CPU."""
    from tpu_scheduler_torch.errors import BackendUnavailable

    class Failing(CudaBackend):
        fail = False

        def assign(self, packed, profile):
            if self.fail:
                raise BackendUnavailable("card lost")
            return super().assign(packed, profile)

    api = fake_api.FakeApiServer()
    api.create_node(_node(True, jt.make_node("n1")))
    api.create_pod(_pod(True, jt.make_pod("p1")))
    backend = Failing(device="cpu")
    sched = controller.Scheduler(api, backend, requeue_seconds=0.0)
    sched.run_cycle()
    api.create_pod(_pod(True, jt.make_pod("p2")))
    backend.fail = True
    with pytest.raises(BackendUnavailable, match="card lost"):
        sched.run_cycle()
    assert sched.delta.stats()["delta_cycles"] == 0  # the plan was a delta plan; nothing committed
    assert sched.metrics.snapshot().get("scheduler_backend_fallbacks_total", 0) == 0


# --- the fold and the closure on the same event streams -------------------------


def _ledger_state(port, snap, packed):
    pack, state = (pack_mod, state_mod) if port else (jax_pack, jax_state)
    alloc64, used64, row = pack._alloc_and_used64(snap, packed.padded_nodes, None, packed.res_vocab)
    st = state.SolveState(node_names=tuple(packed.node_names), node_sig=(), res_vocab=packed.res_vocab,
                          res_scales=packed.res_scales, alloc64=alloc64, used64=used64, row=row)
    for pod in snap.pods:
        if pod.spec is not None and pod.spec.node_name:
            pf = f"{pod.metadata.namespace or 'default'}/{pod.metadata.name}"
            st.placements[pf] = (row.get(pod.spec.node_name, -1), pod.spec.node_name,
                                 state.req64_of(pod, packed.res_vocab))
    return st


def _event_stream(seed, pods, node_names, n_events, duplicates):
    """A seeded stream of (key, prev, new) JAX events over ``pods``:
    deletes of bound and pending pods, rebinds, re-pendings, fresh bound
    arrivals on known and unknown nodes, and (with ``duplicates``) several
    events for one key."""
    rng = random.Random(seed)
    out = []
    keys = set()
    for i in range(n_events):
        p = rng.choice(pods)
        key = (p.metadata.namespace, p.metadata.name)
        if not duplicates and key in keys:
            continue
        keys.add(key)
        kind = rng.random()
        if kind < 0.3:
            out.append((key, p, None))
        elif kind < 0.55:
            out.append((key, p, jt.make_pod(p.metadata.name, cpu=f"{rng.randint(1, 3)}", memory="1Gi",
                                             node_name=rng.choice(node_names + ["ghost"]), phase="Running")))
        elif kind < 0.8:
            out.append((key, p, jt.make_pod(p.metadata.name, cpu="1", memory="1Gi")))
        else:
            fresh = jt.make_pod(f"new-{seed}-{i}", cpu="2", memory="2Gi", node_name=rng.choice(node_names),
                                phase="Running")
            out.append(((fresh.metadata.namespace, fresh.metadata.name), None, fresh))
    return out


def _port_event(ev):
    key, prev, new = ev
    return key, (None if prev is None else _pod(True, prev)), (None if new is None else _pod(True, new))


@pytest.mark.parametrize("seed,duplicates", [(0, False), (1, False), (2, True), (3, True)])
def test_fold_and_close_match_jax_on_event_streams(seed, duplicates):
    """The vectorized fold (unique keys) and the scalar fold (duplicates),
    then the closure with and without fresh placements: the same freed
    nodes, dirty sets, retired counts, verdict ledgers, placement ledgers
    and capacity tensors on both sides."""
    snap = jt.synth_cluster(n_nodes=12, n_pending=40, n_bound=50, seed=seed, selector_fraction=0.3,
                            gang_fraction=0.2, anti_affinity_fraction=0.1)
    p_snap = snapshot_mod.ClusterSnapshot.build([_node(True, n) for n in snap.nodes],
                                                [_pod(True, p) for p in snap.pods])
    packed = jax_pack.pack_snapshot(snap)
    p_packed = pack_mod.pack_snapshot(p_snap)
    node_names = list(packed.node_names)
    events = _event_stream(seed, list(snap.pods), node_names, 60, duplicates)
    p_events = [_port_event(e) for e in events]
    results = []
    for port, s, pk, evs in ((True, p_snap, p_packed, p_events), (False, snap, packed, events)):
        st = _ledger_state(port, s, pk)
        idx_mod = index_mod if port else jax_index
        rng = random.Random(seed)
        pending = s.pending_pods()
        for p in pending[: len(pending) // 2]:  # standing verdicts: plain, constrained, blocked and coarse
            pf = f"{p.metadata.namespace or 'default'}/{p.metadata.name}"
            blocked = idx_mod.blocking_nodes(p, s) if rng.random() < 0.5 else None
            st.unsched[pf] = (bool(p.spec.pod_affinity), p.spec.gang or None, blocked,
                              idx_mod.verdict_constrained(p))
        index = idx_mod.DeltaIndex()
        index.on_pod_events(evs)
        fold = index.fold(st, index.take())
        retired = index.close(st, fold, placements_made=bool(seed % 2), pending_all=pending)
        results.append((fold.ok, sorted(fold.freed_nodes), fold.freed_unknown, fold.carrier_deleted,
                        sorted(fold.dirty), retired, sorted(st.unsched.items()),
                        sorted((pf, r, n, tuple(int(x) for x in q)) for pf, (r, n, q) in st.placements.items()),
                        st.used64.tolist(), st.residual_avail().tolist()))
    assert results[0] == results[1]


@pytest.mark.parametrize("case", ["saturated", "pays_not", "constrained"])
def test_compact_candidate_nodes_matches_jax(case):
    """Node compaction gives equal arrays (every node-side tensor and the
    names) on the same packed cluster, or returns the cluster untouched on
    both sides."""
    if case == "saturated":
        nodes = [jt.make_node(f"full-{i}", cpu="1", memory="1Gi") for i in range(150)]
        nodes += [jt.make_node(f"open-{i}", cpu="16", memory="32Gi", labels={"zone": "z"}) for i in range(5)]
        pods = [jt.make_pod(f"p-{i}", cpu="2", memory="2Gi", node_selector={"zone": "z"} if i % 2 else None)
                for i in range(8)]
    elif case == "pays_not":
        nodes = [jt.make_node(f"n-{i}", cpu="16", memory="32Gi") for i in range(8)]
        pods = [jt.make_pod("p", cpu="1", memory="1Gi")]
    else:
        nodes = [jt.make_node(f"full-{i}", cpu="1", memory="1Gi") for i in range(16)]
        nodes += [jt.make_node("open", cpu="16", memory="32Gi")]
        pods = [jt.make_pod("p", cpu="2", memory="2Gi")]
    snap = jax_snapshot.ClusterSnapshot.build(nodes, pods)
    packed = jax_pack.pack_snapshot(snap)
    p_packed = pack_mod.pack_snapshot(snapshot_mod.ClusterSnapshot.build([_node(True, n) for n in nodes],
                                                                         [_pod(True, p) for p in pods]))
    if case == "constrained":
        packed = packed.__class__(**{**packed.__dict__, "constraints": object()})
        p_packed = p_packed.__class__(**{**p_packed.__dict__, "constraints": object()})
    out, p_out = jax_repack.compact_candidate_nodes(packed), repack_mod.compact_candidate_nodes(p_packed)
    assert (out is packed) == (p_out is p_packed)
    assert (out is packed) == (case != "saturated")
    assert p_out.node_names == out.node_names
    for field in ("node_alloc", "node_avail", "node_labels", "node_taints", "node_aff", "node_valid",
                  "node_taints_soft", "node_pref"):
        np.testing.assert_array_equal(getattr(p_out, field), getattr(out, field), err_msg=field)
    if case == "saturated":
        assert p_out.padded_nodes == 128 and len(p_out.node_names) == 5
        for b in (1, 100, 128, 129, 300):
            assert repack_mod._bucket(b, 128) == jax_repack._bucket(b, 128)


def test_reduced_view_shares_placed_state():
    api = fake_api.FakeApiServer()
    base = jt.synth_cluster(n_nodes=5, n_pending=10, n_bound=10, seed=1)
    api.load([_node(True, n) for n in base.nodes], [_pod(True, p) for p in base.pods])
    snap = snapshot_mod.ClusterSnapshot.build(api.list_nodes(), api.list_pods())
    sub = snap.pending_pods()[:3]
    view = controller.Scheduler._reduced_view(snap, sub)
    assert view.pending_pods() == sub
    assert view.placed_pods() is snap.placed_pods()
    assert view.pods_on_node(snap.nodes[0].name) == snap.pods_on_node(snap.nodes[0].name)


# --- pods the cycle was cut off from: the port's stated departure ---------------
#
# The JAX package marks every pod its auction left unplaced "no feasible node",
# and its delta engine keeps that verdict standing.  The port does so only for
# pods shown to fit no node: a pod the auction's round cap or stall rule, or
# the stall mop-up's work cap, cut off is requeued as cut off, with no backoff
# and no standing verdict, and the next cycle solves it again.  A stop that
# leaves more pods than the stall mop-up takes first runs a bout of rounds
# under the water-fill steering, and the mop-up leaves the pods the auction
# was cut off from to the next cycle's auction.


def _cut_off_cluster(w, spread_pods=6, plain_pods=12, max_rounds=1, mopup_max=2, n_nodes=9, spread_cpu="100m"):
    """``n_nodes`` nodes of 8 CPUs in 3 zones; three Deployments of
    ``spread_pods`` hard-spread pods each (max_skew 1 on the zone: one
    round admits one pod a zone) and ``plain_pods`` plain pods of 3 CPUs
    that herd onto the same nodes.  A one-round auction is cut off from
    some of both kinds; the stall mop-up, and so the residue that runs the
    bout, is capped at ``mopup_max`` pods."""
    nodes = [jt.make_node(f"n{i}", cpu="8", memory="32Gi", labels={"zone": f"z{i % 3}"}) for i in range(n_nodes)]
    pods = []
    for d in range(3):
        spread = [jax_objects.TopologySpreadConstraint(topology_key="zone", max_skew=1,
                                                       match_labels={"app": f"web-{d}"})]
        pods += [jt.make_pod(f"web-{d}-{i}", cpu=spread_cpu, memory="128Mi", labels={"app": f"web-{d}"},
                             topology_spread=spread) for i in range(spread_pods)]
    pods += [jt.make_pod(f"plain-{i}", cpu="3", memory="1Gi") for i in range(plain_pods)]
    w.load(nodes, pods)
    # A no-node verdict waits out a 5 s backoff on the frozen clock; a cut-off pod does not.
    s = w.scheduler(profile_kw={"max_rounds": max_rounds}, requeue_seconds=5.0)
    s.MOPUP_MAX = mopup_max
    return s


def _unbound(w):
    return {f"default/{p.metadata.name}" for p in w.api.list_pods() if p.spec.node_name is None}


def _spread_kept(w) -> bool:
    """Every bound pod's hard spread in the port's world ``w``, judged by the
    port's host sequential chain against the final state less the pod."""
    snap = snapshot_mod.ClusterSnapshot.build(w.api.list_nodes(), w.api.list_pods())
    by_name = {n.metadata.name: n for n in snap.nodes}
    return all(
        make_spread_checker(p, snap, exclude=frozenset({objects.full_name(p)}))(by_name[p.spec.node_name])
        for p in snap.pods if p.spec.topology_spread and p.spec.node_name
    )


def test_cut_off_pods_get_no_standing_verdict_and_bind_in_later_cycles():
    """Twelve pods of 1 CPU a Deployment on 12 nodes: the bout after the
    round cap (one round more) still leaves pods of both kinds active."""
    w = World(True)
    s = _cut_off_cluster(w, spread_pods=12, n_nodes=12, spread_cpu="1")
    m = w.cycle(s)
    cut = dict(s._cycle_cut_off)
    assert m.rounds == 2  # max_rounds, then the bout's max_rounds more
    assert set(cut.values()) == {"round_cap"} and {pf.split("-")[0] for pf in cut} == {"default/web", "default/plain"}
    assert m.spans["solve/cut_off_pods"] == m.spans["solve/cut_off_pods/round_cap"] == len(cut)
    assert _unbound(w) == set(cut) and m.unschedulable == 0  # counted apart from the unschedulable
    assert not set(cut) & set(s.delta.state.unsched)
    counters = s.metrics.snapshot()
    assert counters.get("scheduler_stall_mopup_attempted_total", 0) == 0  # left to the next cycle
    assert counters['scheduler_requeues_by_reason_total{reason="cut-off"}'] == len(cut)
    assert counters['scheduler_auction_cut_off_pods_total{cause="round_cap"}'] == len(cut)
    assert not [k for k in counters if k.startswith("scheduler_unschedulable_total")]
    for pf in cut:
        assert pf not in s.requeue_at
        assert [(e["kind"], e.get("reason")) for e in s.recorder.timeline(pf)][-1] == ("requeued", "cut-off")
    m2 = w.cycle(s)
    assert s.delta.stats()["delta_cycles"] == 1 and m2.pending == len(cut)
    assert s._retry_names == set(cut)  # the retry steers by water filling
    for _ in range(4):
        w.cycle(s)
    assert not _unbound(w) and _spread_kept(w)


def test_pods_beyond_the_mopup_cap_are_retried_not_skipped():
    """An auction that places nothing and cuts nothing off (every pod left
    as if no node fit it) hands the mop-up the whole residue; capped at 2
    pods, it places two, and the rest are cut off as ``mopup_cap``, which
    the next plan keeps dirty."""

    class PlacingNothingOnce(CudaBackend):
        fail = True

        def assign(self, packed, profile):
            if self.fail and packed.constraints is not None:
                self.fail = False
                return np.full((packed.padded_pods,), -1, np.int32), 3
            return super().assign(packed, profile)

    w = World(True)
    s = _cut_off_cluster(w, plain_pods=0, max_rounds=32)
    s.backend = PlacingNothingOnce(device="cpu")
    m = w.cycle(s)
    capped = {pf for pf, c in s._cycle_cut_off.items() if c == "mopup_cap"}
    assert m.bound == 2 and len(capped) == 16 and set(s._cycle_cut_off) == capped
    assert _unbound(w) == capped and not capped & set(s.delta.state.unsched)
    assert s.metrics.snapshot()["scheduler_stall_mopup_attempted_total"] == 2
    w.cycle(s)
    assert s.delta.stats()["dirty_sizes"] == [len(capped)] and s.delta.stats()["skipped_total"] == 0
    for _ in range(4):
        w.cycle(s)
    assert not _unbound(w) and _spread_kept(w)


def test_a_pod_no_node_can_hold_keeps_its_standing_verdict():
    """Required anti-affinity on the zone for three pods of one app, two
    zones: the third fits no node.  Nothing cuts it off, so its verdict
    stands and the plan skips it, exactly as in the JAX package."""
    rows = []
    for port in (True, False):
        w = World(port)
        w.load([jt.make_node(f"n{i}", cpu="8", memory="32Gi", labels={"zone": f"z{i}"}) for i in range(2)],
               [jt.make_pod(f"x-{i}", cpu="100m", memory="128Mi", labels={"app": "x"}, anti_affinity=[
                   jax_objects.PodAntiAffinityTerm(topology_key="zone", match_labels={"app": "x"})]) for i in range(3)])
        s = w.scheduler()
        for _ in range(3):
            w.cycle(s)
        if port:
            assert s._cycle_cut_off == {} and list(s.delta.state.unsched) == ["default/x-2"]
            assert s.delta.state.unsched["default/x-2"][3] is True
            assert s.delta.stats()["skipped_total"] == 2 and w.rows[-1][0][0] == 0
            assert _unbound(w) == {"default/x-2"}
        rows.append(w.rows)
    assert rows[0] == rows[1]


@pytest.mark.parametrize("mopup_max", [16, 2])
def test_the_departure_begins_after_the_auction(mopup_max):
    """On the scenario whose auction hits its round cap, with seven pods
    still active after its one round.  With the stall mop-up's cap above
    that residue (16) the auction is the JAX package's: both mop-ups place
    the same spread pods by the host's chain, and the first cycle's
    bindings and placement ledger are equal; the verdict ledger differs by
    exactly the pods cut off (plain pods, which the mop-up does not take),
    and so does what follows: the JAX package leaves them pending, the port
    binds them.  With the cap below the residue (2) the departure begins in
    the auction: a bout of max_rounds more rounds binds every pod the JAX
    package's cycle binds and every pod it left unplaced."""
    pw, jw = World(True), World(False)
    ps, js = _cut_off_cluster(pw, mopup_max=mopup_max), _cut_off_cluster(jw, mopup_max=mopup_max)
    mp, mj = pw.cycle(ps), jw.cycle(js)
    cut = set(ps._cycle_cut_off)
    p_bound = {pf for pf, node in pw.placement() if node}
    j_bound = {pf for pf, node in jw.placement() if node}
    p_counts, _p_stats, (p_unsched, p_placements) = pw.rows[0]
    j_counts, _j_stats, (j_unsched, j_placements) = jw.rows[0]
    assert not {pf for pf, _ in p_unsched} & cut
    if mopup_max == 16:
        assert (mp.rounds, mj.rounds) == (1, 1)
        assert pw.placement() == jw.placement() and p_placements == j_placements
        assert cut and {pf.split("-")[0] for pf in cut} == {"default/plain"}
        assert p_counts[1] == j_counts[1] and p_counts[2] + len(cut) == j_counts[2]
        assert {pf for pf, _ in j_unsched} == {pf for pf, _ in p_unsched} | cut
        left = cut
    else:
        assert (mp.rounds, mj.rounds) == (2, 1) and not cut and not p_unsched
        assert j_bound < p_bound and {pf for pf, _ in j_unsched} == p_bound - j_bound
        left = p_bound - j_bound
    for _ in range(3):
        pw.cycle(ps)
        jw.cycle(js)
    assert _unbound(jw) == left and not _unbound(pw)


def test_an_infeasible_residue_beyond_the_mopup_cap_is_proven_over_cycles():
    """Ten pods with required anti-affinity on the hostname, four nodes:
    six fit no node, more than the stall mop-up's cap of 2, while two new
    plain pods bind in every cycle.  Nothing cuts the six off (no node
    passes their filters), so the chain proves two a cycle, and within
    three cycles each has its standing verdict and the plan skips it."""
    w = World(True)
    anti = [jax_objects.PodAntiAffinityTerm(topology_key="kubernetes.io/hostname", match_labels={"app": "x"})]
    w.load([jt.make_node(f"n{i}", cpu="32", memory="64Gi") for i in range(4)],
           [jt.make_pod(f"x-{i}", cpu="100m", memory="128Mi", labels={"app": "x"}, anti_affinity=anti)
            for i in range(10)])
    s = w.scheduler(requeue_seconds=5.0)
    s.MOPUP_MAX = 2
    proven = []
    for c in range(3):
        for i in range(2):
            w.create_pod(jt.make_pod(f"plain-{c}-{i}", cpu="1", memory="1Gi"))
        m = w.cycle(s)
        assert m.bound >= 2 and not s._cycle_cut_off.keys() - {f"default/x-{i}" for i in range(10)}
        assert set(s._cycle_cut_off.values()) <= {"mopup_cap"}
        proven.append(len(s.delta.state.unsched))
    infeasible = _unbound(w)
    assert len(infeasible) == 6 and {pf.split("-")[0] for pf in infeasible} == {"default/x"}
    assert proven == [2, 4, 6] and set(s.delta.state.unsched) == infeasible
    assert s.metrics.snapshot()["scheduler_stall_mopup_attempted_total"] == 6
    w.create_pod(jt.make_pod("plain-last", cpu="1", memory="1Gi"))
    m = w.cycle(s)
    assert m.bound == 1 and not s._cycle_cut_off and s.delta.stats()["dirty_sizes"][-1] == 1
