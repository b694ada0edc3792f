"""The background rebalancer on the port: ``tpu_scheduler_torch.rebalance``
and the controller's rebalance tick, held against the JAX package.

Every case of ``tests/test_rebalance.py`` runs on both packages from the
same inputs — the port's ``Scheduler`` over ``CudaBackend(device="cpu")``,
the JAX one over ``NativeBackend`` — with the JAX test's own assertions
holding on both sides, and the observations (victim verdicts, packing
stats, plans, batches, throttle reasons, tick outcomes and counters, the
API's placements, ``stats()``, the ``/debug/rebalance`` payload, whole
scorecards) equal, exactly.  Then the solve on seeded fragmented clusters
with and without racks, and the three rebalancer scenarios plus
rebalance-under-chaos: cards byte-equal to the JAX sim's at seed 0, and
at seed 1 under ``slow``."""

import dataclasses
import json
import logging
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.core.snapshot as jax_core_snapshot  # noqa: E402
import tpu_scheduler.ops.pack as jax_pack  # noqa: E402
import tpu_scheduler.rebalance as jax_rebalance  # noqa: E402
import tpu_scheduler.rebalance.planner as jax_planner  # noqa: E402
import tpu_scheduler.rebalance.snapshot as jax_rsnapshot  # noqa: E402
import tpu_scheduler.rebalance.solver as jax_solver  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.http_api as jax_http_api  # noqa: E402
import tpu_scheduler.sim.harness as jax_harness  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
import tpu_scheduler.topology.model as jax_topology  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.core.snapshot as core_snapshot  # noqa: E402
import tpu_scheduler_torch.ops.pack as pack  # noqa: E402
import tpu_scheduler_torch.rebalance as rebalance  # noqa: E402
import tpu_scheduler_torch.rebalance.planner as planner  # noqa: E402
import tpu_scheduler_torch.rebalance.snapshot as rsnapshot  # noqa: E402
import tpu_scheduler_torch.rebalance.solver as solver  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.http_api as http_api  # noqa: E402
import tpu_scheduler_torch.sim.harness as harness  # noqa: E402
import tpu_scheduler_torch.testing as testing  # noqa: E402
import tpu_scheduler_torch.topology.model as topology  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from test_torch_sim import port_card_of  # noqa: E402

logging.getLogger("tpu_scheduler").setLevel(logging.ERROR)
logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)

PORT = types.SimpleNamespace(
    name="port", objects=objects, core_snapshot=core_snapshot, pack=pack, rebalance=rebalance, planner=planner,
    rsnapshot=rsnapshot, solver=solver, controller=controller, fake_api=fake_api, http_api=http_api,
    harness=harness, testing=testing, topology=topology, backend=lambda: CudaBackend(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", objects=jax_objects, core_snapshot=jax_core_snapshot, pack=jax_pack, rebalance=jax_rebalance,
    planner=jax_planner, rsnapshot=jax_rsnapshot, solver=jax_solver, controller=jax_controller,
    fake_api=jax_fake_api, http_api=jax_http_api, harness=jax_harness, testing=jax_testing, topology=jax_topology,
    backend=NativeBackend,
)

# The rebalancer's scenarios and the one that composes it with chaos and
# two replicas.
REBALANCE_SCENARIOS = ("defrag-smoke", "fragmentation-long-horizon", "autoscaler-backlog-whatif",
                       "rebalance-under-chaos")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _jax_compile_listener_off():
    """The JAX sim's ``compile.enabled`` reads a process-wide flag that any
    ``TpuBackend`` built earlier in the process turns on; the cards held
    here are NativeBackend runs, for which the flag is off."""
    import tpu_scheduler.utils.profiler as jax_profiler

    saved = jax_profiler._hooks_installed[0]
    jax_profiler._hooks_installed[0] = False
    yield
    jax_profiler._hooks_installed[0] = saved


def _both(case, *args):
    """Run ``case`` on each package; the observations must be equal."""
    port, jax = case(PORT, *args), case(JAX, *args)
    assert port == jax
    return port


def _snap(pk, nodes, pods):
    return pk.core_snapshot.ClusterSnapshot.build(nodes, pods)


def _plan_obs(plan) -> dict:
    return {"migrations": [dataclasses.asdict(m) for m in plan.migrations], "drained": list(plan.drained),
            "before": plan.before, "after": plan.after}


def _placements(api) -> list:
    return sorted((p.metadata.name, p.spec.node_name if p.spec is not None else None) for p in api.list_pods())


def _drained_nodes(pk, api):
    return sorted(
        n.name for n in api.list_nodes() if (n.metadata.labels or {}).get(pk.rebalance.REBALANCE_CORDON_LABEL)
    )


def _card(pk, name, seed, **kw):
    """A scenario's card on ``pk``: the JAX card with its span census
    carried over to the port's (``test_torch_sim.port_card_of``)."""
    backend = pk.backend()
    card = pk.harness.run_scenario(name, seed=seed, backend=backend, **kw)
    return port_card_of(card) if pk is JAX else card


# -- victim taxonomy ----------------------------------------------------------


def test_movable_taxonomy_pins_constrained_pods():
    def case(pk):
        mp, is_movable = pk.testing.make_pod, pk.rsnapshot.is_movable
        out = [
            is_movable(mp("plain", node_name="n1", phase="Running")),
            is_movable(mp("g", node_name="n1", gang="team")),
            is_movable(mp("sel", node_name="n1", node_selector={"zone": "a"})),
            is_movable(mp("aa", node_name="n1", anti_affinity=[
                pk.objects.PodAntiAffinityTerm(topology_key="zone", match_labels={"a": "b"})])),
            is_movable(mp("ext", node_name="n1", extended={"acme.com/gpu": 1})),
            is_movable(mp("vetoed", node_name="n1"), victim_ok=lambda pf: False),
        ]
        assert out == [True, False, False, False, False, False]
        return out

    _both(case)


def test_movable_taxonomy_respects_pdbs():
    def case(pk):
        o = pk.objects
        pdb = o.PodDisruptionBudget(metadata=o.ObjectMeta(name="guard"), match_labels={"app": "db"}, min_available=1)
        protected = pk.testing.make_pod("db-0", node_name="n1", labels={"app": "db"})
        free = pk.testing.make_pod("web-0", node_name="n1", labels={"app": "web"})
        out = [pk.rsnapshot.is_movable(protected, pdbs=[pdb]), pk.rsnapshot.is_movable(free, pdbs=[pdb])]
        assert out == [False, True]
        return out

    _both(case)


# -- packing stats + solver ---------------------------------------------------


def test_packing_stats_exact_math():
    def case(pk):
        alloc = np.array([[8000, 100], [8000, 100], [8000, 100]], dtype=np.int64)
        used = np.array([[4000, 10], [2000, 10], [0, 0]], dtype=np.int64)
        s = pk.rebalance.packing_stats(alloc, used)
        assert s["occupied_nodes"] == 2 and s["empty_nodes"] == 1
        assert s["efficiency"] == 0.375 and s["stranded_frac"] == 0.625
        empty = pk.rebalance.packing_stats(alloc, np.zeros_like(used))
        assert empty["efficiency"] == 1.0 and empty["occupied_nodes"] == 0
        return s, empty

    _both(case)


def test_solver_drains_whole_nodes_only_and_is_deterministic():
    def case(pk):
        mn, mp = pk.testing.make_node, pk.testing.make_pod
        nodes = [mn(f"n{i}", cpu="8", memory="32Gi") for i in range(4)]
        pods = [
            mp("a1", node_name="n0", cpu="1", memory="1Gi", phase="Running"),
            mp("a2", node_name="n1", cpu="1", memory="1Gi", phase="Running"),
            mp("pin", node_name="n2", cpu="1", memory="1Gi", gang="team", phase="Running"),
            mp("b1", node_name="n2", cpu="1", memory="1Gi", phase="Running"),
            mp("big", node_name="n3", cpu="6", memory="4Gi", phase="Running"),
        ]
        plan = pk.rebalance.solve_packing(pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods)))
        assert all(m.src != "n2" for m in plan.migrations)
        for src in plan.drained:
            assert [m for m in plan.migrations if m.src == src], src
        assert plan.after["occupied_nodes"] < plan.before["occupied_nodes"]
        plan2 = pk.rebalance.solve_packing(pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods)))
        assert plan.migrations == plan2.migrations and plan.drained == plan2.drained
        return _plan_obs(plan)

    _both(case)


def test_solver_respects_receiver_headroom_and_budget():
    def case(pk):
        mn, mp, solve = pk.testing.make_node, pk.testing.make_pod, pk.rebalance.solve_packing
        nodes = [mn("n0", cpu="4", memory="8Gi"), mn("n1", cpu="4", memory="8Gi")]
        pods = [mp("x", node_name="n0", cpu="2", memory="1Gi", phase="Running"),
                mp("y", node_name="n1", cpu="3", memory="1Gi", phase="Running")]
        rs = pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods))
        assert not solve(rs, headroom=0.9).migrations
        assert not solve(rs, headroom=1.0).migrations
        pods2 = [mp("x", node_name="n0", cpu="1", memory="1Gi", phase="Running"),
                 mp("y", node_name="n1", cpu="1", memory="1Gi", phase="Running")]
        rs2 = pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods2))
        assert solve(rs2).migrations
        assert not solve(rs2, max_migrations=0).migrations
        return [_plan_obs(solve(rs, headroom=1.0)), _plan_obs(solve(rs2)), _plan_obs(solve(rs2, max_migrations=0))]

    _both(case)


def test_solver_topology_prefers_emptiest_rack_and_tags_rack_defrag():
    def case(pk):
        mn, mp = pk.testing.make_node, pk.testing.make_pod
        labels = lambda r: {"topology.tpu-scheduler/rack": r}  # noqa: E731
        nodes = [mn("a0", cpu="8", memory="32Gi", labels=labels("rack-a")),
                 mn("a1", cpu="8", memory="32Gi", labels=labels("rack-a")),
                 mn("b0", cpu="8", memory="32Gi", labels=labels("rack-b"))]
        pods = [mp("a0-1", node_name="a0", cpu="4", memory="4Gi", phase="Running"),
                mp("a1-1", node_name="a1", cpu="4", memory="4Gi", phase="Running"),
                mp("b0-1", node_name="b0", cpu="1", memory="1Gi", phase="Running")]
        topo = pk.topology.TopologyModel.detect(nodes).compile(nodes)
        plan = pk.rebalance.solve_packing(pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods)), topo=topo)
        assert plan.migrations and plan.migrations[0].src == "b0"
        assert plan.migrations[0].reason == "rack-defrag"
        assert plan.migrations[0].reason in pk.rebalance.MIGRATION_REASONS
        return _plan_obs(plan)

    _both(case)


def _fragmented(pk, n_nodes: int, seed: int, racks: int = 0):
    """A seeded cluster: nodes of three shapes, 1-4 movable pods each of
    random size (some gang-pinned), optionally labelled in racks."""
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for i in range(n_nodes):
        labels = {"topology.tpu-scheduler/rack": f"r{i % racks}"} if racks else None
        cpu = int(rng.choice([4, 8, 16]))
        nodes.append(pk.testing.make_node(f"n{i}", cpu=str(cpu), memory=f"{4 * cpu}Gi", labels=labels))
        for j in range(int(rng.integers(0, 5))):
            c = int(rng.integers(100, 1500))
            gang = "g" if rng.random() < 0.05 else None
            pods.append(pk.testing.make_pod(f"p{i}-{j}", node_name=f"n{i}", cpu=f"{c}m", memory=f"{c}Mi",
                                            gang=gang, phase="Running"))
    return nodes, pods


@pytest.mark.parametrize("seed,racks", [(0, 0), (1, 0), (2, 4), (3, 7)])
def test_solver_matches_on_seeded_fragmented_clusters(seed, racks):
    """The packing solve on seeded clusters of 60 nodes, with and without
    racks (the rack-aware order and the ``rack-defrag`` tag), at three
    headrooms and two plan bounds: every plan equal."""

    def case(pk):
        nodes, pods = _fragmented(pk, 60, seed, racks)
        rs = pk.rebalance.RebalanceSnapshot.build(_snap(pk, nodes, pods))
        topo = pk.topology.TopologyModel.detect(nodes).compile(nodes) if racks else None
        out = []
        for headroom in (0.7, 0.9, 1.0):
            for bound in (8, 256):
                out.append(_plan_obs(pk.rebalance.solve_packing(rs, topo, max_migrations=bound, headroom=headroom)))
        assert any(o["migrations"] for o in out)
        return out

    _both(case)


# -- planner ------------------------------------------------------------------


def test_select_batch_takes_whole_node_groups():
    def case(pk):
        def mig(i, src):
            return pk.solver.Migration(pod_full=f"default/p{i}", src=src, dst="r", cpu=1, mem=1,
                                       reason="defrag-drain")

        plan = pk.solver.PackingPlan(
            migrations=(mig(0, "n0"), mig(1, "n0"), mig(2, "n0"), mig(3, "n1"), mig(4, "n1"), mig(5, "n2")),
            drained=("n0", "n1", "n2"), before={}, after={},
        )
        out = []
        for batch, budget in ((4, 0), (2, 0), (8, 2), (8, 0), (5, 6)):
            out.append([[dataclasses.asdict(m) for m in g] for g in pk.planner.select_batch(plan, batch, budget)])
        assert [g[0]["src"] for g in out[0]] == ["n0"]
        assert [g[0]["src"] for g in out[1]] == ["n0"]
        assert out[2] == []
        return out

    _both(case)


def test_throttle_reasons_precedence():
    def case(pk):
        cfg = pk.rebalance.RebalanceConfig(burn_limit=0.5, max_pending=4, max_migrations=10)
        tr = pk.planner.throttle_reason
        out = [tr("open", 0.0, 0, 0, 0, cfg), tr("closed", 0.9, 0, 0, 0, cfg), tr("closed", 0.0, 5, 0, 0, cfg),
               tr("closed", 0.0, 0, 3, 0, cfg), tr("closed", 0.0, 0, 0, 10, cfg), tr("closed", 0.0, 0, 0, 0, cfg)]
        assert out == ["breaker-open", "slo-burn", "backlog", "inflight", "budget", None]
        for r in out[:-1]:
            assert r in pk.rebalance.SKIP_REASONS
        return out, pk.rebalance.SKIP_REASONS, pk.rebalance.MIGRATION_REASONS, dataclasses.asdict(cfg)

    _both(case)


# -- executor unit ------------------------------------------------------------


def _frag_api(pk, n_nodes=6, pods_per=2):
    api = pk.fake_api.FakeApiServer()
    for i in range(n_nodes):
        api.create_node(pk.testing.make_node(f"n{i}", cpu="8", memory="32Gi"))
    k = 0
    for i in range(n_nodes):
        for _ in range(pods_per):
            api.create_pod(pk.testing.make_pod(f"p{k}", node_name=f"n{i}", cpu="1", memory="1Gi", phase="Running"))
            k += 1
    return api


def test_executor_unbind_failure_aborts_group_without_cordon():
    def case(pk):
        api = _frag_api(pk)
        reb = pk.rebalance.Rebalancer(pk.rebalance.RebalanceConfig(every=1, batch=64))
        cordoned = []
        issued = reb.tick(_snap(pk, api.list_nodes(), api.list_pods()), unbind=lambda pf, node: False,
                          cordon=lambda name: cordoned.append(name) or True)
        assert issued == 0 and cordoned == []
        assert reb.skips.get("unbind-failed", 0) >= 1
        return issued, reb.stats()

    _both(case)


def test_executor_victim_moved_abandons_stale_background_plan():
    def case(pk):
        api = _frag_api(pk, n_nodes=3)
        snap = _snap(pk, api.list_nodes(), api.list_pods())
        reb = pk.rebalance.Rebalancer(pk.rebalance.RebalanceConfig(every=1, batch=64, background=True))
        calls = []
        try:
            assert reb.tick(snap, unbind=lambda pf, n: calls.append(pf) or True, cordon=lambda n: True) == 0
            for _ in range(500):
                with reb._bg_lock:
                    if reb._bg_plan is not None:
                        break
                time.sleep(0.01)
            for i in range(3):
                api.create_pod(pk.testing.make_pod(f"late{i}", node_name=f"n{i}", cpu="1", memory="1Gi",
                                                   phase="Running"))
            live = _snap(pk, api.list_nodes(), api.list_pods())
            issued = reb.tick(live, unbind=lambda pf, n: calls.append(pf) or True, cordon=lambda n: True)
        finally:
            reb.close()
        assert issued == 0 and calls == []
        assert reb.skips.get("victim-moved", 0) >= 1
        assert reb._bg_thread is None
        return issued, reb.stats()

    _both(case)


def test_executor_reconcile_completions_and_vanished():
    def case(pk):
        api = _frag_api(pk, n_nodes=2, pods_per=1)
        reb = pk.rebalance.Rebalancer(pk.rebalance.RebalanceConfig(every=1, batch=8))
        unbound = []

        def unbind(pf, node):
            ns, _, name = pf.rpartition("/")
            api.unbind_pod(ns or "default", name, expect_node=node)
            unbound.append((pf, node))
            return True

        issued = reb.tick(_snap(pk, api.list_nodes(), api.list_pods()), unbind=unbind, cordon=lambda n: True)
        assert issued >= 1 and len(reb.inflight) == issued
        pf0, node0 = unbound[0]
        ns, _, name0 = pf0.rpartition("/")
        api.create_binding(ns or "default", name0, pk.objects.ObjectReference(name="n1" if node0 == "n0" else "n0"))
        for pf, _n in unbound[1:]:
            ns1, _, n1 = pf.rpartition("/")
            api.delete_pod(ns1 or "default", n1)
        reb.reconcile(_snap(pk, api.list_nodes(), api.list_pods()))
        assert reb.completed == 1 and reb.vanished == len(unbound) - 1 and not reb.inflight
        return unbound, reb.stats()

    _both(case)


# -- the unbind CAS seam ------------------------------------------------------


def test_unbind_pod_cas_and_watch_event():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        api.create_node(pk.testing.make_node("n0", cpu="8", memory="32Gi"))
        api.create_node(pk.testing.make_node("n1", cpu="8", memory="32Gi"))
        api.create_pod(pk.testing.make_pod("p", node_name="n0", phase="Running"))
        w = api.watch_pods(send_initial=False)
        codes = []
        with pytest.raises(pk.fake_api.ApiError) as e:
            api.unbind_pod("default", "p", expect_node="n1")
        codes.append(e.value.code)
        with pytest.raises(pk.fake_api.ApiError) as e:
            api.unbind_pod("default", "ghost")
        codes.append(e.value.code)
        api.unbind_pod("default", "p", expect_node="n0")
        events = w.poll()
        assert [ev.type for ev in events] == ["MODIFIED"]
        assert events[0].object.spec.node_name is None and events[0].object.status.phase == "Pending"
        with pytest.raises(pk.fake_api.ApiError) as e:
            api.unbind_pod("default", "p")
        codes.append(e.value.code)
        assert codes[0] == 409 and codes[2] == 409
        return codes, [ev.type for ev in events]

    _both(case)


# -- controller integration ---------------------------------------------------


def test_controller_defrag_converges_and_audits_clean():
    def case(pk):
        api = _frag_api(pk, n_nodes=8, pods_per=2)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0,
                                        rebalance=pk.rebalance.RebalanceConfig(every=2, batch=16))
        counts = [sched.run_cycle().bound for _ in range(24)]
        s = sched.rebalancer.stats()
        assert s["executed"] > 0 and s["completed"] == s["executed"] and s["nodes_drained"] >= 5
        rs = pk.rebalance.RebalanceSnapshot.build(_snap(pk, api.list_nodes(), api.list_pods()))
        stats = pk.rebalance.packing_stats(rs.alloc, rs.used)
        assert stats["occupied_nodes"] <= 3
        assert len(_drained_nodes(pk, api)) == s["nodes_drained"]
        assert not [p for p in api.list_pods() if p.spec is None or not p.spec.node_name]
        st = sched.delta.state
        snap = _snap(pk, api.list_nodes(), api.list_pods())
        _alloc64, used64, _row = pk.pack._alloc_and_used64(snap, st.alloc64.shape[0], None, st.res_vocab)
        assert (st.used64 == used64).all()
        counters = {k: v for k, v in sched.metrics.snapshot().items() if "rebalance" in k}
        return counts, s, stats, _placements(api), _drained_nodes(pk, api), counters, sched.delta.stats()

    _both(case)


def test_pressure_release_uncordons_on_backlog():
    def case(pk):
        api = _frag_api(pk, n_nodes=6, pods_per=1)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0,
                                        rebalance=pk.rebalance.RebalanceConfig(every=1, batch=16, max_pending=4))
        for _ in range(12):
            sched.run_cycle()
        drained_before = _drained_nodes(pk, api)
        assert drained_before
        for i in range(10):
            api.create_pod(pk.testing.make_pod(f"wave{i}", cpu="3", memory="4Gi"))
        for _ in range(4):
            sched.run_cycle()
        assert _drained_nodes(pk, api) == []
        assert sched.rebalancer.pressure_releases >= 1 and sched.rebalancer.skips.get("backlog", 0) >= 1
        for _ in range(4):
            sched.run_cycle()
        assert not [p for p in api.list_pods() if p.spec is None or not p.spec.node_name]
        return drained_before, sched.rebalancer.stats(), _placements(api)

    _both(case)


def test_background_thread_mode_migrates():
    """The worker's timing decides which tick consumes its plan, so the
    observations held equal are the outcome's: a migration executed and
    the worker joined by ``close``."""

    def case(pk):
        api = _frag_api(pk, n_nodes=6, pods_per=2)
        sched = pk.controller.Scheduler(api, pk.backend(), requeue_seconds=0.0,
                                        rebalance=pk.rebalance.RebalanceConfig(every=1, batch=16, background=True))
        try:
            for _ in range(40):
                sched.run_cycle()
                if sched.rebalancer.stats()["executed"]:
                    break
                time.sleep(0.01)
            executed = sched.rebalancer.stats()["executed"]
            assert executed > 0
        finally:
            sched.close()
        assert sched.rebalancer._bg_thread is None
        return executed > 0, sched.rebalancer._bg_thread is None, sched.rebalancer.config.background

    _both(case)


def test_debug_rebalance_route_and_snapshot():
    def case(pk):
        api = _frag_api(pk, n_nodes=4, pods_per=1)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0,
                                        rebalance=pk.rebalance.RebalanceConfig(every=1, batch=8))
        for _ in range(6):
            sched.run_cycle()
        snap = sched.rebalance_snapshot()
        assert snap["enabled"] and snap["solves"] >= 1
        assert snap["config"]["every"] == 1 and "drained_nodes" in snap
        srv = pk.http_api.HttpApiServer(api, rebalance=sched.rebalance_snapshot).start()
        try:
            with urllib.request.urlopen(f"{srv.base_url}/debug/rebalance") as r:
                body = json.loads(r.read())
            assert body == snap
            bare = pk.http_api.HttpApiServer(api).start()
            try:
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(f"{bare.base_url}/debug/rebalance")
                code = e.value.code
            finally:
                bare.stop()
        finally:
            srv.stop()
        assert code == 404
        off = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock()).rebalance_snapshot()
        return body, code, off

    _both(case)


def test_sharded_only_shard0_owner_rebalances():
    def case(pk):
        api = _frag_api(pk, n_nodes=4, pods_per=1)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0, shards=2,
                                        identity="r0", lease_duration=30.0,
                                        rebalance=pk.rebalance.RebalanceConfig(every=1, batch=8))
        for _ in range(6):
            sched.run_cycle()
        assert 0 in sched.shard_set.owned and sched.rebalancer.stats()["solves"] >= 1
        return sorted(sched.shard_set.owned), sched.rebalancer.stats(), _placements(api)

    _both(case)


def test_unported_policy_leaves_the_rebalancer_off():
    """The tier is batch-policy only on both packages: the sample policy
    builds no rebalancer, and the debug payload says so."""

    def case(pk):
        api = _frag_api(pk, n_nodes=2, pods_per=1)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), policy="sample",
                                        rebalance=pk.rebalance.RebalanceConfig(every=1))
        return sched.rebalancer is None, sched.rebalance_snapshot()

    assert _both(case) == (True, {"enabled": False})


# -- scenario family (pass gates, baselines, chaos, replay) -------------------


def test_defrag_smoke_scenario_recovers_gate_and_baseline_fails():
    def case(pk):
        cards = []
        for seed in (0, 1):
            card = _card(pk, "defrag-smoke", seed)
            r = card["rebalance"]
            assert card["pass"] and r["ok"], r
            assert r["packing_efficiency"] >= r["efficiency_gate"]
            assert 0 < r["migrations"] <= r["migration_budget"]
            assert r["orphaned_migrations"] == 0 and r["unbinds_while_open"] == 0
            assert card["pods"]["double_bound"] == 0 and card["pods"]["lost"] == 0
            cards.append(card)
        off = _card(pk, "defrag-smoke", 0, rebalance=False)
        assert not off["pass"] and not off["rebalance"]["ok"]
        assert off["rebalance"]["packing_efficiency"] < off["rebalance"]["efficiency_gate"]
        assert off["rebalance"]["migrations"] == 0
        return cards, off

    _both(case)


def test_defrag_smoke_record_replay_bit_identical(tmp_path):
    """Each package replays its own trace and the other's."""
    paths = {"port": str(tmp_path / "port.jsonl"), "jax": str(tmp_path / "jax.jsonl")}
    live = {pk.name: _card(pk, "defrag-smoke", 0, record=paths[pk.name]) for pk in (PORT, JAX)}
    assert live["port"] == live["jax"]
    for pk in (PORT, JAX):
        for trace in paths.values():
            replayed = _card(pk, "defrag-smoke", 0, replay=trace)
            assert replayed["fingerprint"] == live["jax"]["fingerprint"]
            assert {**replayed, "mode": "live"} == live["jax"]


def test_rebalance_under_chaos_zero_orphans_and_breaker_compose():
    def case(pk):
        card = _card(pk, "rebalance-under-chaos", 0)
        r = card["rebalance"]
        assert card["pass"], json.dumps(card["invariants"])[:500]
        assert r["orphaned_migrations"] == 0 and r["unbinds_while_open"] == 0
        assert card["pods"]["double_bound"] == 0 and card["availability"]["ok"]
        assert card["resilience"]["breaker_opened"] >= 1 and r["skips"].get("breaker-open", 0) >= 1
        assert r["migrations"] > 0 and r["completed"] == r["migrations"]
        return card

    _both(case)


def test_autoscaler_whatif_recommends_node_adds():
    def case(pk):
        card = _card(pk, "autoscaler-backlog-whatif", 0)
        r = card["rebalance"]
        assert card["pass"] and r["ok"]
        w = r["whatif"]
        assert w is not None and w["pending_pods"] > 0 and w["nodes_needed"] >= 1
        assert r["skips"].get("backlog", 0) >= 1 and r["migrations"] == 0
        return card

    _both(case)


def test_whatif_matches_on_a_seeded_backlog():
    """``autoscaler_whatif`` on a seeded fragmented cluster with a pending
    backlog and a drained-node count, with and without racks."""

    def case(pk):
        nodes, pods = _fragmented(pk, 40, 5, racks=4)
        rng = np.random.default_rng(9)
        pending = [pk.testing.make_pod(f"w{i}", cpu=f"{int(rng.integers(500, 9000))}m", memory="2Gi")
                   for i in range(30)]
        snap = _snap(pk, nodes, pods)
        topo = pk.topology.TopologyModel.detect(nodes).compile(nodes)
        return [pk.rebalance.autoscaler_whatif(snap, pending, drained_labeled=d, topo=t)
                for d, t in ((0, None), (3, topo))]

    out = _both(case)
    assert out[0]["pending_unplaceable"] > 0 and out[0]["nodes_needed"] >= 1


@pytest.mark.slow
def test_fragmentation_long_horizon_both_seeds():
    def case(pk):
        cards = []
        for seed in (0, 1):
            card = _card(pk, "fragmentation-long-horizon", seed)
            r = card["rebalance"]
            assert card["pass"] and r["ok"], (seed, r)
            assert r["packing_efficiency"] >= r["efficiency_gate"] and r["migrations"] <= r["migration_budget"]
            cards.append(card)
        off = _card(pk, "fragmentation-long-horizon", 0, rebalance=False)
        assert not off["pass"] and not off["rebalance"]["ok"]
        return cards, off

    _both(case)


@pytest.mark.parametrize("name", REBALANCE_SCENARIOS)
def test_rebalance_scenario_card_matches_the_jax_sim(name):
    port, jax = _card(PORT, name, 0), _card(JAX, name, 0)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    assert port["pass"] and port["rebalance"]["enabled"]


@pytest.mark.slow
@pytest.mark.parametrize("name", REBALANCE_SCENARIOS)
def test_rebalance_scenario_card_matches_the_jax_sim_seed_1(name):
    port, jax = _card(PORT, name, 1), _card(JAX, name, 1)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    assert port["pass"]
