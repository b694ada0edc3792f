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

    def cycle(self, sched, audit=True):
        m = sched.run_cycle()
        st = sched.delta.state if sched.delta is not None else None
        ledger = None
        if st is not None:
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
    """The scenarios above cover the closed vocabulary; only the fleet
    (not ported) raises "mesh-rebind"."""
    driven = {r for _fn, r in SCENARIOS.values() if r is not None} | {"cold"}
    assert driven == set(ESCALATION_REASONS) - {"mesh-rebind"}
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
