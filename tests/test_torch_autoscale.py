"""The closed-loop autoscaler on the port: ``tpu_scheduler_torch.autoscale``
and the controller's autoscale tick, held against the JAX package.

Every case of ``tests/test_autoscale.py`` runs on both packages from the
same inputs — the port's ``Scheduler`` over ``CudaBackend(device="cpu")``,
the JAX one over ``NativeBackend`` — with the JAX test's own assertions
holding on both sides, and the observations (provider records and their
seeded draws, quota and stockout refusals, catalog plans, tick outcomes and
skip counters, the API's nodes and placements, ``stats()``, the
``/debug/autoscale`` payload, whole scorecards) equal, exactly.  Then the
four elasticity scenarios: cards byte-equal to the JAX sim's and each
package's trace replayed through the other."""

import dataclasses
import json
import logging
import random
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.autoscale as jax_autoscale  # noqa: E402
import tpu_scheduler.autoscale.policy as jax_policy  # noqa: E402
import tpu_scheduler.core.snapshot as jax_core_snapshot  # noqa: E402
import tpu_scheduler.rebalance.whatif as jax_whatif  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.http_api as jax_http_api  # noqa: E402
import tpu_scheduler.sim.harness as jax_harness  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.autoscale as autoscale  # noqa: E402
import tpu_scheduler_torch.autoscale.policy as policy  # noqa: E402
import tpu_scheduler_torch.core.snapshot as core_snapshot  # noqa: E402
import tpu_scheduler_torch.rebalance.whatif as whatif  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.http_api as http_api  # noqa: E402
import tpu_scheduler_torch.sim.harness as harness  # noqa: E402
import tpu_scheduler_torch.testing as testing  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402
from test_torch_sim import port_card_of  # noqa: E402

logging.getLogger("tpu_scheduler").setLevel(logging.ERROR)
logging.getLogger("tpu_scheduler_torch").setLevel(logging.ERROR)

PORT = types.SimpleNamespace(
    name="port", autoscale=autoscale, policy=policy, core_snapshot=core_snapshot, whatif=whatif,
    controller=controller, fake_api=fake_api, http_api=http_api, harness=harness, testing=testing,
    backend=lambda: CudaBackend(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", autoscale=jax_autoscale, policy=jax_policy, core_snapshot=jax_core_snapshot, whatif=jax_whatif,
    controller=jax_controller, fake_api=jax_fake_api, http_api=jax_http_api, harness=jax_harness,
    testing=jax_testing, backend=NativeBackend,
)

ELASTICITY_SCENARIOS = (
    "diurnal-traffic",
    "flash-crowd-provisioning-lag",
    "spot-reclaim-storm",
    "quota-capped-surge",
)


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


def _sku(pk, **kw):
    return pk.autoscale.InstanceSKU(**kw)


def _provider(pk, api=None, seed=7, catalog=None, **kw):
    return pk.autoscale.SimCloudProvider(
        api if api is not None else pk.fake_api.FakeApiServer(),
        clock=FakeClock(),
        rng=random.Random(seed),
        catalog=catalog if catalog is not None else pk.autoscale.DEFAULT_CATALOG,
        **kw,
    )


def _nodes(api) -> list:
    return sorted((n.name, dict(n.metadata.labels or {}), bool(n.spec is not None and n.spec.unschedulable))
                  for n in api.list_nodes())


def _placements(api) -> list:
    return sorted((p.metadata.name, p.spec.node_name if p.spec is not None else None) for p in api.list_pods())


def _catalog(catalog) -> list:
    return [dataclasses.asdict(s) for s in catalog]


# -- provider semantics -------------------------------------------------------


def test_provider_determinism_same_seed_same_records():
    def case(pk):
        def drive(seed):
            prov = _provider(pk, seed=seed, reclaim_rate=0.05)
            for t in range(12):
                try:
                    prov.request("spot-16" if t % 2 else "std-8", float(t))
                except pk.autoscale.Stockout:
                    pass
                prov.pump(float(t) + 0.5)
            return prov.records

        a, b, other = drive(3), drive(3), drive(4)
        assert a == b and a != other
        return a, other

    _both(case)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_provider_seeded_lifecycle_matches(seed):
    """A seeded stream of requests over a catalog with stockouts, quotas
    and spot reclaims, pumped through joins, notices and kills with bound
    pods on the condemned nodes: the records, the API's nodes and pods, the
    lags, the cost integral and ``stats()`` equal."""

    def case(pk):
        api = pk.fake_api.FakeApiServer()
        catalog = (
            _sku(pk, name="a", cpu=8, mem_gi=32, hourly_cost=1.0, quota=3, stockout_rate=0.3),
            _sku(pk, name="s", cpu=16, mem_gi=64, hourly_cost=0.5, spot=True, provision_s=2.0),
            _sku(pk, name="b", cpu=32, mem_gi=128, hourly_cost=3.0, provision_jitter_s=0.0),
        )
        prov = _provider(pk, api, seed=seed, catalog=catalog, total_quota=6, reclaim_rate=0.2, reclaim_grace_s=1.5)
        rng = np.random.default_rng(seed)
        errors = []
        for step in range(40):
            t = step * 0.5
            if rng.random() < 0.4:
                try:
                    prov.request(["a", "s", "b"][int(rng.integers(0, 3))], t)
                except pk.autoscale.ProviderError as e:
                    errors.append(type(e).__name__)
            prov.pump(t)
            for name in sorted(prov.ready_nodes()):
                if rng.random() < 0.2:
                    api.create_pod(pk.testing.make_pod(f"t{step}-{name}", node_name=name, cpu="1", memory="1Gi",
                                                       phase="Running"))
        return (prov.records, errors, prov.quota_left(), prov.provision_lags(), prov.cost_node_hours(20.0),
                prov.stats(), list(prov.reclaim_unbound), _nodes(api), _placements(api))

    _both(case)


def test_provisioning_lag_gates_the_join():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=1.0, provision_s=6.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        name = prov.request("lab", now=0.0)
        assert prov.pending_provisions() == 1 and not api.list_nodes()
        prov.pump(5.9)
        assert not api.list_nodes()
        prov.pump(6.0)
        nodes = api.list_nodes()
        assert [n.name for n in nodes] == [name]
        assert nodes[0].metadata.labels[pk.autoscale.PROVIDER_SKU_LABEL] == "lab"
        assert prov.ready_nodes() == {name: "lab"} and prov.provision_lags() == [6.0]
        return name, _nodes(api), prov.records

    _both(case)


def test_quota_per_sku_and_account_wide():
    def case(pk):
        capped = _sku(pk, name="cap", cpu=8, mem_gi=32, hourly_cost=1.0, quota=1, provision_jitter_s=0.0)
        free = _sku(pk, name="free", cpu=8, mem_gi=32, hourly_cost=1.0, provision_jitter_s=0.0)
        prov = _provider(pk, catalog=(capped, free), total_quota=2)
        prov.request("cap", 0.0)
        with pytest.raises(pk.autoscale.QuotaExceeded):
            prov.request("cap", 0.0)
        assert prov.quota_left()["cap"] == 0
        prov.request("free", 0.0)
        with pytest.raises(pk.autoscale.QuotaExceeded):
            prov.request("free", 0.0)
        assert prov.quota_errors == 2 and prov.quota_left()["free"] == 0
        return prov.quota_left(), prov.records

    _both(case)


def test_stockout_surfaces_as_live_error():
    def case(pk):
        dry = _sku(pk, name="dry", cpu=8, mem_gi=32, hourly_cost=1.0, stockout_rate=1.0)
        prov = _provider(pk, catalog=(dry,))
        with pytest.raises(pk.autoscale.Stockout):
            prov.request("dry", 0.0)
        assert prov.stockout_errors == 1 and not prov.records
        return prov.stats()

    _both(case)


def test_reclaim_cordons_then_kills_after_grace_without_orphans():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        spot = _sku(pk, name="s16", cpu=16, mem_gi=64, hourly_cost=1.0, provision_s=1.0, provision_jitter_s=0.0,
                    spot=True)
        prov = _provider(pk, api, catalog=(spot,), reclaim_rate=1e9, reclaim_grace_s=5.0)
        name = prov.request("s16", 0.0)
        prov.pump(1.0)
        api.create_pod(pk.testing.make_pod("victim", node_name=name, cpu="1", memory="1Gi", phase="Running"))
        prov.pump(1.1)
        rec = prov.records[0]
        assert rec["state"] == "reclaiming" and rec["kill_at"] == pytest.approx(6.0)
        assert api.list_nodes()[0].spec.unschedulable and api.list_pods("spec.nodeName=" + name)
        prov.pump(5.9)
        assert rec["state"] == "reclaiming"
        out = prov.pump(6.0)
        assert out["reclaim_kills"] == 1 and rec["state"] == "deleted" and not api.list_nodes()
        pods = api.list_pods()
        assert len(pods) == 1 and pods[0].spec.node_name is None
        assert prov.reclaim_unbound == ["default/victim"]
        return out, prov.records, _placements(api)

    _both(case)


def test_delete_refuses_nonempty_node():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=1.0, provision_s=1.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        name = prov.request("lab", 0.0)
        prov.pump(1.0)
        api.create_pod(pk.testing.make_pod("tenant", node_name=name, cpu="1", memory="1Gi", phase="Running"))
        refused = prov.delete(name, 2.0)
        assert refused is False and [n.name for n in api.list_nodes()] == [name]
        api.delete_pod("default", "tenant")
        deleted = prov.delete(name, 3.0)
        assert deleted is True and not api.list_nodes()
        return refused, deleted, prov.records

    _both(case)


def test_cost_node_hours_integrates_joined_time():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=3.6, provision_s=0.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        name = prov.request("lab", 0.0)
        prov.pump(0.0)
        prov.delete(name, 1800.0)
        cost = prov.cost_node_hours(7200.0)
        assert cost == pytest.approx(1.8)
        return cost

    _both(case)


# -- catalog policy -----------------------------------------------------------


def test_pack_catalog_picks_cheapest_per_request_served():
    def case(pk):
        small = _sku(pk, name="small", cpu=8, mem_gi=32, hourly_cost=2.4)
        big = _sku(pk, name="big", cpu=16, mem_gi=64, hourly_cost=4.0)
        plan, unplaceable = pk.autoscale.pack_catalog([(4000, 8 << 30)] * 4, (small, big))
        assert plan == {"big": 1} and unplaceable == 0
        return plan, unplaceable

    _both(case)


def test_pack_catalog_respects_quota_and_reports_unplaceable():
    def case(pk):
        small = _sku(pk, name="small", cpu=8, mem_gi=32, hourly_cost=2.4)
        a = pk.autoscale.pack_catalog([(4000, 8 << 30)] * 4, (small,), quota_left={"small": 1})
        b = pk.autoscale.pack_catalog([(64_000, 8 << 30)], (small,))
        assert a == ({"small": 1}, 2) and b == ({}, 1)
        return a, b

    _both(case)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pack_catalog_matches_on_seeded_backlogs(seed):
    """The cost-aware FFD on seeded overflow lists over the default catalog
    and a seeded one, with and without quotas."""

    def case(pk):
        rng = np.random.default_rng(seed)
        overflow = [(int(rng.integers(100, 40_000)), int(rng.integers(1, 100)) << 28) for _ in range(60)]
        seeded = tuple(_sku(pk, name=f"k{i}", cpu=int(c), mem_gi=int(4 * c), hourly_cost=float(h))
                       for i, (c, h) in enumerate(zip(rng.choice([4, 8, 16, 32], 5), rng.random(5) * 5 + 0.5)))
        quota = {f"k{i}": int(q) for i, q in enumerate(rng.integers(0, 4, 5))}
        return [pk.autoscale.pack_catalog(overflow, cat, q)
                for cat, q in ((pk.autoscale.DEFAULT_CATALOG, None), (seeded, None), (seeded, quota))]

    _both(case)


def test_load_catalog_round_trips_json(tmp_path):
    path = tmp_path / "catalog.json"
    path.write_text(json.dumps([
        {"name": "x-8", "cpu": 8, "mem_gi": 32, "hourly_cost": 1.5, "quota": 3, "spot": True},
        {"name": "g-4", "cpu": 4, "mem_gi": 16, "hourly_cost": 9.0, "ext": {"acme.com/gpu": 2}},
    ]))

    def case(pk):
        skus = pk.autoscale.load_catalog(str(path))
        assert skus[0] == pk.autoscale.InstanceSKU(name="x-8", cpu=8, mem_gi=32, hourly_cost=1.5, quota=3, spot=True)
        return _catalog(skus)

    _both(case)
    dup = tmp_path / "dup.json"
    dup.write_text(json.dumps([{"name": "a", "cpu": 1, "mem_gi": 1, "hourly_cost": 1.0}] * 2))
    for pk in (PORT, JAX):
        with pytest.raises(ValueError, match="repeats a SKU name"):
            pk.autoscale.load_catalog(str(dup))


def test_whatif_catalog_extension_prices_the_plan():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        api.create_node(pk.testing.make_node("n0", cpu="2", memory="4Gi"))
        snap = pk.core_snapshot.ClusterSnapshot.build(api.list_nodes(), [])
        pending = [pk.testing.make_pod(f"p{i}", cpu="4", memory="8Gi") for i in range(4)]
        out = pk.whatif.autoscaler_whatif(snap, pending, catalog=pk.autoscale.DEFAULT_CATALOG)
        assert out["sku_plan"] and out["nodes_needed"] == sum(out["sku_plan"].values())
        assert out["plan_cost_per_hour"] > 0 and out["plan_unplaceable"] == 0
        return out

    _both(case)


# -- the controller loop ------------------------------------------------------


def _saturated_world(pk):
    api = pk.fake_api.FakeApiServer()
    api.create_node(pk.testing.make_node("tiny", cpu="1", memory="1Gi"))
    api.create_pod(pk.testing.make_pod("filler", node_name="tiny", cpu="1", memory="1Gi", phase="Running"))
    snap = pk.core_snapshot.ClusterSnapshot.build(api.list_nodes(), api.list_pods())
    pending = [pk.testing.make_pod("wide", cpu="4", memory="8Gi")]
    return api, snap, pending


def test_scale_up_then_cooldown_then_inflight_skips():
    def case(pk):
        api, snap, pending = _saturated_world(pk)
        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1, cooldown=1), _provider(pk, api))
        issued = auto.tick(snap, pending, burn=1.0, now=0.0)
        assert issued >= 1 and auto.provider.pending_provisions() >= 1 and auto.scale_ups
        auto.tick(snap, pending, burn=1.0, now=1.0)
        assert auto.skips.get("cooldown") == 1
        auto.tick(snap, pending, burn=1.0, now=2.0)
        assert auto.skips.get("inflight") == 1
        return issued, auto.stats(), auto.provider.records

    _both(case)


def test_no_scale_up_below_burn_trigger():
    def case(pk):
        api, snap, pending = _saturated_world(pk)
        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1, burn_trigger=0.5), _provider(pk, api))
        auto.tick(snap, pending, burn=0.0, now=0.0)
        assert not auto.scale_ups and not auto.provider.records
        return auto.stats()

    _both(case)


def test_breaker_open_throttles_the_tick():
    def case(pk):
        api, snap, pending = _saturated_world(pk)
        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1), _provider(pk, api))
        auto.tick(snap, pending, burn=1.0, breaker_mode="open", now=0.0)
        assert auto.skips == {"breaker-open": 1} and not auto.provider.records
        assert set(auto.skips) <= set(pk.policy.SKIP_REASONS)
        return auto.stats(), pk.policy.SKIP_REASONS, dataclasses.asdict(pk.autoscale.AutoscaleConfig())

    _both(case)


def test_scale_down_reserve_counts_rebalancer_drained_nodes():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=1.0, provision_s=0.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        for t in (0.0, 0.1):
            prov.request("lab", t)
        prov.pump(1.0)
        snap = pk.core_snapshot.ClusterSnapshot.build(api.list_nodes(), [])
        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1, reserve=2), prov)
        auto.tick(snap, [], burn=0.0, drained_labeled=0, now=2.0)
        assert auto.skips.get("reserve") == 1 and len(prov.ready_nodes()) == 2
        auto.tick(snap, [], burn=0.0, drained_labeled=1, now=3.0)
        assert sum(auto.scale_downs.values()) == 1 and len(prov.ready_nodes()) == 1
        return auto.stats(), prov.records, _nodes(api)

    _both(case)


def test_scale_down_drains_loaded_node_through_unbind_with_zero_orphans():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        api.create_node(pk.testing.make_node("static-big", cpu="32", memory="128Gi"))
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=1.0, provision_s=0.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        name = prov.request("lab", 0.0)
        prov.pump(0.0)
        for i in range(2):
            api.create_pod(pk.testing.make_pod(f"tenant{i}", node_name=name, cpu="1", memory="1Gi", phase="Running"))
        snap = pk.core_snapshot.ClusterSnapshot.build(api.list_nodes(), api.list_pods())

        def unbind(pod_full, node):
            ns, _, pod = pod_full.rpartition("/")
            api.unbind_pod(ns or "default", pod, expect_node=node)
            return True

        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1, reserve=0, drain_max_pods=4), prov)
        assert auto.tick(snap, [], burn=0.0, drained_labeled=0, unbind=unbind, now=1.0) == 1
        assert sum(auto.scale_downs.values()) == 1 and len(auto.drain_unbound) == 2
        assert name not in {n.name for n in api.list_nodes()}
        assert sorted(p.metadata.name for p in api.list_pods()) == ["tenant0", "tenant1"]
        assert all(p.spec.node_name is None for p in api.list_pods())
        return auto.stats(), list(auto.drain_unbound), _nodes(api), _placements(api)

    _both(case)


def test_scale_down_refuses_undrainable_node():
    def case(pk):
        api = pk.fake_api.FakeApiServer()
        sku = _sku(pk, name="lab", cpu=8, mem_gi=32, hourly_cost=1.0, provision_s=0.0, provision_jitter_s=0.0)
        prov = _provider(pk, api, catalog=(sku,))
        name = prov.request("lab", 0.0)
        prov.pump(0.0)
        api.create_pod(pk.testing.make_pod("tenant", node_name=name, cpu="1", memory="1Gi", phase="Running"))
        snap = pk.core_snapshot.ClusterSnapshot.build(api.list_nodes(), api.list_pods())
        auto = pk.autoscale.Autoscaler(pk.autoscale.AutoscaleConfig(every=1, reserve=0), prov)
        auto.tick(snap, [], burn=0.0, drained_labeled=0, unbind=lambda *a: True, now=1.0)
        assert auto.skips.get("not-empty") == 1 and not auto.scale_downs
        assert api.list_pods("spec.nodeName=" + name)
        return auto.stats(), _placements(api)

    _both(case)


def test_scheduler_wires_autoscale_phase_and_metrics():
    def case(pk):
        api, _, _ = _saturated_world(pk)
        api.create_pod(pk.testing.make_pod("wide", cpu="4", memory="8Gi"))
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0,
                                        autoscale=pk.autoscale.AutoscaleConfig(every=1),
                                        autoscale_provider=_provider(pk, api))
        m = sched.run_cycle()
        assert m.autoscale_seconds >= 0.0 and sched.autoscaler.stats()["ticks"] == 1
        counters = {k: v for k, v in sched.metrics.snapshot().items() if "autoscale" in k}
        assert any(k.startswith("scheduler_autoscale_skips_total") for k in counters)
        gauges = sched.metrics._snapshot_full()["gauges"]
        assert "scheduler_autoscale_pending_provisions" in gauges
        return sched.autoscaler.stats(), counters, gauges["scheduler_autoscale_pending_provisions"]

    _both(case)


def test_debug_autoscale_route_and_snapshot():
    def case(pk):
        api, _, _ = _saturated_world(pk)
        sched = pk.controller.Scheduler(api, pk.backend(), clock=FakeClock(), requeue_seconds=0.0,
                                        autoscale=pk.autoscale.AutoscaleConfig(every=1),
                                        autoscale_provider=_provider(pk, api))
        sched.run_cycle()
        snap = sched.autoscale_snapshot()
        assert snap["enabled"] and snap["ticks"] >= 1 and snap["provider"]["requested"] == 0 and snap["catalog"]
        srv = pk.http_api.HttpApiServer(api, autoscale=sched.autoscale_snapshot).start()
        try:
            with urllib.request.urlopen(f"{srv.base_url}/debug/autoscale") as r:
                body = json.loads(r.read())
            assert body == snap
            bare = pk.http_api.HttpApiServer(api).start()
            try:
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(f"{bare.base_url}/debug/autoscale")
                code = e.value.code
            finally:
                bare.stop()
        finally:
            srv.stop()
        assert code == 404
        # Without a provider the tier stays off, as in the JAX controller.
        off = pk.controller.Scheduler(api, pk.backend(), autoscale=pk.autoscale.AutoscaleConfig())
        return body, code, off.autoscaler is None, off.autoscale_snapshot()

    _both(case)


def test_sharded_only_shard0_owner_autoscales_and_takeover_inherits_provider():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        api.create_node(pk.testing.make_node("tiny", cpu="1", memory="1Gi"))
        provider = _provider(pk, api)
        scheds = [
            pk.controller.Scheduler(api, pk.backend(), clock=clock, requeue_seconds=0.0, shards=2,
                                    identity=f"r{i}", lease_duration=10.0,
                                    autoscale=pk.autoscale.AutoscaleConfig(every=1), autoscale_provider=provider)
            for i in range(2)
        ]
        for _ in range(4):
            for sched in scheds:
                sched.run_cycle()
        owner = next(s for s in scheds if 0 in s.shard_set.owned)
        standby = next(s for s in scheds if s is not owner)
        assert owner.autoscaler.stats()["ticks"] >= 1
        before, owner_before = standby.autoscaler.stats()["ticks"], owner.autoscaler.stats()["ticks"]
        for _ in range(3):
            for sched in scheds:
                sched.run_cycle()
        assert standby.autoscaler.stats()["ticks"] == before
        assert owner.autoscaler.stats()["ticks"] > owner_before
        clock.t += 25.0
        for _ in range(6):
            standby.run_cycle()
        assert 0 in standby.shard_set.owned and standby.autoscaler.stats()["ticks"] >= 1
        assert standby.autoscaler.provider is provider
        return owner.identity, owner.autoscaler.stats(), standby.autoscaler.stats(), provider.stats()

    _both(case)


# -- the elasticity scenario family ------------------------------------------


def _card(pk, name, seed, **kw):
    """A scenario's card on ``pk``: the JAX card with its span census
    carried over to the port's (``test_torch_sim.port_card_of``)."""
    card = pk.harness.run_scenario(name, seed=seed, backend=pk.backend(), **kw)
    return port_card_of(card) if pk is JAX else card


@pytest.mark.parametrize("name", ELASTICITY_SCENARIOS)
@pytest.mark.parametrize("seed", (0, 1))
def test_elasticity_scenarios_pass_and_static_baselines_fail(name, seed):
    def case(pk):
        card = _card(pk, name, seed)
        e = card["elasticity"]
        assert card["pass"] and e["ok"], json.dumps(e)
        assert e["joint_objective"] <= e["objective_gate"] and sum(e["scale_ups"].values()) > 0
        assert e["reclaim_orphans"] == 0
        assert card["pods"]["double_bound"] == 0 and card["pods"]["lost"] == 0
        if name == "spot-reclaim-storm":
            assert e["reclaims"] > 0 and set(e["scale_ups"]) == {"spot-16"}
        if name == "quota-capped-surge":
            assert e["quota_errors"] > 0 and sum(e["scale_ups"].values()) <= 2
        if name == "diurnal-traffic":
            assert sum(e["scale_downs"].values()) > 0
        off = _card(pk, name, seed, autoscale=False)
        eo = off["elasticity"]
        assert not off["pass"] and not eo["ok"] and eo["joint_objective"] > eo["objective_gate"]
        assert not eo["scale_ups"] and eo["cost_node_hours"] == 0.0
        return json.dumps(card, sort_keys=True), json.dumps(off, sort_keys=True)

    _both(case)


@pytest.mark.parametrize("name", ELASTICITY_SCENARIOS)
@pytest.mark.parametrize("seed", (0, 1))
def test_elasticity_record_replay_bit_identical(name, seed, tmp_path):
    """Each package records; each replays its own trace and the other's
    (the provider's adds and deletes are not in the trace: each replay
    re-derives them from its own seeded provider)."""
    paths = {pk.name: str(tmp_path / f"{pk.name}.jsonl") for pk in (PORT, JAX)}
    live = {pk.name: _card(pk, name, seed, record=paths[pk.name]) for pk in (PORT, JAX)}
    assert live["port"] == live["jax"]
    for pk in (PORT, JAX):
        for trace in paths.values():
            replayed = _card(pk, name, seed, replay=trace)
            assert replayed["fingerprint"] == live["jax"]["fingerprint"]
            assert {**replayed, "mode": "live"} == live["jax"]


def test_ttb_clock_restarts_for_reclaim_and_drain_unbinds():
    """The harness restarts the time-to-bind clock of pods a spot reclaim
    or a scale-down drain unbound: spot-reclaim-storm's provider unbinds
    pods, and the card's SLO and elasticity blocks equal the JAX sim's.
    The same run with the restart taken out of the port's fold changes
    them, so the check sees it."""
    port, jax = _card(PORT, "spot-reclaim-storm", 0), _card(JAX, "spot-reclaim-storm", 0)
    assert port == jax and port["elasticity"]["reclaims"] > 0 and port["pods"]["migrated"] > 0
    import unittest.mock as mock

    sched_cls = PORT.controller.Scheduler
    orig = sched_cls.__init__

    def no_autoscaler_unbound(self, *a, **kw):
        orig(self, *a, **kw)
        if self.autoscaler is not None:
            self.autoscaler.drain_unbound = _Forgetful()

    class _Forgetful(list):
        def append(self, _x):
            pass

    # Only the provider's reclaim unbinds remain restarts; dropping those
    # too (an empty reclaim list) must move the card.
    with mock.patch.object(sched_cls, "__init__", no_autoscaler_unbound):
        provider_cls = autoscale.SimCloudProvider
        porig = provider_cls.__init__

        def forgetful_provider(self, *a, **kw):
            porig(self, *a, **kw)
            self.reclaim_unbound = _Forgetful()

        with mock.patch.object(provider_cls, "__init__", forgetful_provider):
            drifted = _card(PORT, "spot-reclaim-storm", 0)
    assert drifted["fingerprint"] == port["fingerprint"]
    assert (drifted["slo"], drifted["elasticity"]) != (port["slo"], port["elasticity"])
