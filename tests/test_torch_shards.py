"""The sharded control plane on the port: ``tpu_scheduler_torch.runtime.
shards`` and the controller's sharded cycle, held against the JAX package.

Every case of ``tests/test_shards.py`` runs on both packages from the same
inputs — the port's ``Scheduler`` over ``CudaBackend(device="cpu")``, the
JAX one over ``NativeBackend`` — and the observations (owned shards, leases
held, bound counts, backoff ledgers, checkpoint files, the ``/debug/shards``
payload) must be equal, exactly.  The JAX test's own assertions hold on both
sides.  Then ``shard_for_name`` on seeded names."""

import json
import random
import types

import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.runtime.checkpoint as jax_checkpoint  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.http_api as jax_http_api  # noqa: E402
import tpu_scheduler.runtime.shards as jax_shards  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.runtime.checkpoint as checkpoint  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.http_api as http_api  # noqa: E402
import tpu_scheduler_torch.runtime.shards as shards  # noqa: E402
import tpu_scheduler_torch.testing as testing  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402

PORT = types.SimpleNamespace(
    name="port", objects=objects, checkpoint=checkpoint, controller=controller, fake_api=fake_api,
    http_api=http_api, shards=shards, testing=testing, backend=lambda: CudaBackend(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", objects=jax_objects, checkpoint=jax_checkpoint, controller=jax_controller, fake_api=jax_fake_api,
    http_api=jax_http_api, shards=jax_shards, testing=jax_testing, backend=NativeBackend,
)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _fleet(pk, api, nodes=4, pods=0):
    api.load(
        nodes=[pk.testing.make_node(f"n{i}", cpu="64", memory="256Gi") for i in range(nodes)],
        pods=[pk.testing.make_pod(f"p{i}") for i in range(pods)],
    )


def _sched(pk, api, clock=None, **kw):
    if clock is not None:
        kw["clock"] = clock
    return pk.controller.Scheduler(api, pk.backend(), rng=random.Random(7), **kw)


def _leases(api, names):
    out = {}
    for name in names:
        info = api.get_lease(name)
        out[name] = None if info is None else (info["holder"], info.get("expires"))
    return out


def _both(case, *args):
    """Run ``case`` on each package; the observations must be equal."""
    port, jax = case(PORT, *args), case(JAX, *args)
    assert port == jax
    return port


# --- hashing -------------------------------------------------------------------


def test_shard_hash_is_stable_and_in_range():
    rng = random.Random(0)
    keys = [f"ns{rng.randrange(5)}/p{rng.randrange(10**6)}" for _ in range(500)] + ["", "gang-7", "ü/ß"]
    for k in (1, 2, 3, 4, 7, 16):
        assert [shards.shard_for_name(key, k) for key in keys] == [jax_shards.shard_for_name(key, k) for key in keys]
    assert {shards.shard_for_name(f"default/p{i}", 4) for i in range(200)} == {0, 1, 2, 3}
    assert shards.shard_for_name("anything", 1) == 0
    assert checkpoint.shard_for_name is shards.shard_for_name
    assert shards.SHARD_LEASE_PREFIX == jax_shards.SHARD_LEASE_PREFIX
    assert shards.REPLICA_LEASE_PREFIX == jax_shards.REPLICA_LEASE_PREFIX
    assert [shards.shard_lease_name(i) for i in range(4)] == [jax_shards.shard_lease_name(i) for i in range(4)]


def test_gang_members_pin_to_one_shard():
    def case(pk):
        members = [pk.testing.make_pod(f"g{i}", gang="train-job-7") for i in range(8)]
        got = {pk.shards.shard_of_pod(p, 4) for p in members}
        assert got == {pk.shards.shard_for_name("train-job-7", 4)}
        solo = pk.testing.make_pod("solo")
        other = pk.testing.make_pod("x", namespace="team-a")
        return got, pk.shards.shard_of_pod(solo, 4), pk.shards.shard_of_pod(other, 4)

    _both(case)


# --- lease ownership -------------------------------------------------------------


def _refresh_obs(delta):
    return (sorted(delta.owned), sorted(delta.gained), sorted(delta.lost), sorted(delta.released),
            sorted(delta.holders.items()), delta.resized)


def test_single_replica_claims_every_shard():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        s = pk.shards.ShardSet(api, 4, "r1", 6.0, clock)
        delta = s.refresh()
        assert sorted(delta.owned) == [0, 1, 2, 3] and sorted(delta.gained) == [0, 1, 2, 3]
        assert api.get_lease(pk.shards.REPLICA_LEASE_PREFIX + "r1")["holder"] == "r1"
        return _refresh_obs(delta), _leases(api, [pk.shards.shard_lease_name(i) for i in range(4)])

    _both(case)


def test_two_replicas_rebalance_to_even_split():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        s1 = pk.shards.ShardSet(api, 4, "r1", 6.0, clock)
        s2 = pk.shards.ShardSet(api, 4, "r2", 6.0, clock)
        rounds = [_refresh_obs(s1.refresh()), _refresh_obs(s2.refresh())]
        clock.t += 1.0
        rounds += [_refresh_obs(s1.refresh()), _refresh_obs(s2.refresh())]
        assert len(s1.owned) == len(s2.owned) == 2 and not set(s1.owned) & set(s2.owned)
        clock.t += 1.0
        d1, d2 = s1.refresh(), s2.refresh()
        assert not d1.gained and not d1.released and not d2.gained and not d2.released
        return rounds, s1.debug(clock.t), s2.debug(clock.t)

    _both(case)


def test_crash_takeover_within_ttl():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        s1 = pk.shards.ShardSet(api, 4, "r1", 6.0, clock)
        s2 = pk.shards.ShardSet(api, 4, "r2", 6.0, clock)
        for _ in range(3):
            s1.refresh()
            s2.refresh()
            clock.t += 1.0
        orphans = set(s1.owned)
        clock.t += 3.0
        early = _refresh_obs(s2.refresh())
        assert not orphans & set(s2.owned)
        clock.t += 6.0
        delta = s2.refresh()
        assert set(delta.owned) == {0, 1, 2, 3} and orphans <= set(delta.gained)
        return sorted(orphans), early, _refresh_obs(delta)

    _both(case)


def test_clean_release_hands_over_without_ttl_wait():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        s1 = pk.shards.ShardSet(api, 4, "r1", 60.0, clock)
        s2 = pk.shards.ShardSet(api, 4, "r2", 60.0, clock)
        s1.refresh()
        s1.release_all()
        assert s1.owned == frozenset()
        delta = s2.refresh()
        assert set(s2.owned) == {0, 1, 2, 3}
        return _refresh_obs(delta)

    _both(case)


# --- controller wiring -------------------------------------------------------------


def test_two_replicas_schedule_disjoint_and_conflict_free():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        _fleet(pk, api, nodes=4, pods=0)
        s1 = _sched(pk, api, clock, shards=4, identity="r1", lease_duration=6.0)
        s2 = _sched(pk, api, clock, shards=4, identity="r2", lease_duration=6.0)
        for _ in range(3):
            s1.run_cycle()
            s2.run_cycle()
            clock.t += 1.0
        assert set(s1.shard_set.owned) | set(s2.shard_set.owned) == {0, 1, 2, 3}
        for i in range(40):
            api.create_pod(pk.testing.make_pod(f"w{i}"))
        m1, m2 = s1.run_cycle(), s2.run_cycle()
        assert m1.bound + m2.bound == 40 and m1.bound > 0 and m2.bound > 0
        assert len(api.list_pods("status.phase=Pending")) == 0
        placement = sorted((p.metadata.name, p.spec.node_name) for p in api.list_pods())
        return (sorted(s1.shard_set.owned), sorted(s2.shard_set.owned), m1.bound, m2.bound, placement,
                s1.metrics.snapshot().get("scheduler_shard_acquisitions_total"),
                s2.metrics.snapshot().get("scheduler_shard_releases_total"))

    _both(case)


def test_zero_owned_shards_is_standby():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        _fleet(pk, api, nodes=2, pods=4)
        s1 = _sched(pk, api, clock, shards=2, identity="r1", lease_duration=6.0)
        s2 = _sched(pk, api, clock, shards=2, identity="r2", lease_duration=6.0)
        m1, m2 = s1.run_cycle(), s2.run_cycle()
        assert m1.bound == 4 and m2.bound == 0 and s1.is_leader and not s2.is_leader
        return m1.bound, m2.bound, s1.is_leader, s2.is_leader, m2.pending

    _both(case)


def test_standby_prune_spares_unowned_shard_backoff():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        _fleet(pk, api, nodes=2, pods=0)
        s = _sched(pk, api, clock, shards=4, identity="r1", lease_duration=6.0)
        s.run_cycle()
        other = pk.shards.ShardSet(api, 4, "r2", 6.0, clock)
        s.shard_set.owned = frozenset({0, 1})
        other.owned = frozenset({2, 3})
        for sh in (2, 3):
            api.release_lease(pk.shards.shard_lease_name(sh), "r1")
            api.acquire_lease(pk.shards.shard_lease_name(sh), "r2", 6.0)
        api.acquire_lease(pk.shards.REPLICA_LEASE_PREFIX + "r2", "r2", 6.0)
        entries = {}
        for i in range(40):
            pf = f"default/gone{i}"
            entries.setdefault(pk.shards.shard_for_name(pf, 4), pf)
            if len(entries) == 4:
                break
        for pf in entries.values():
            s.requeue_at.fail(pf, "no-node", clock.t)
        clock.t += 1.0
        s.run_cycle()
        for sh, pf in sorted(entries.items()):
            assert (pf in s.requeue_at) == (sh not in s.shard_set.owned), (sh, pf)
        return sorted(s.shard_set.owned), sorted(s.requeue_at)

    _both(case)


def test_takeover_revalidates_assumed_overlay():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        api.load(nodes=[pk.testing.make_node("n1", cpu="8", memory="32Gi")],
                 pods=[pk.testing.make_pod("live"), pk.testing.make_pod("confirmed")])
        api.create_binding("default", "confirmed", pk.objects.ObjectReference(name="n1"))
        s = _sched(pk, api, clock, shards=2, identity="r1", lease_duration=6.0)
        s._assumed = {"default/ghost": "n1", "default/live": "n-gone", "default/confirmed": "n1"}
        m = s.run_cycle()
        assert s._assumed == {}
        assert s.metrics.snapshot().get("scheduler_assumed_stale_total") == 2
        return m.bound, sorted((p.metadata.name, p.spec.node_name) for p in api.list_pods())

    _both(case)


def test_sharded_ownership_over_http():
    """The port's replica against the port's HTTP server and the JAX
    package's (each client against the other's server too): the same
    ownership, bindings and clean release."""

    def case(pk, server_pk):
        api = server_pk.fake_api.FakeApiServer()
        _fleet(server_pk, api, nodes=2, pods=6)
        server = server_pk.http_api.HttpApiServer(api).start()
        try:
            s1 = _sched(pk, pk.http_api.RemoteApiAdapter(pk.http_api.KubeApiClient(server.base_url)),
                        shards=2, identity="r1", lease_duration=15.0)
            m1 = s1.run_cycle()
            assert s1.is_leader and sorted(s1.shard_set.owned) == [0, 1] and m1.bound == 6
            held = api.get_lease(pk.shards.shard_lease_name(0))["holder"]
            s1.close()
            return m1.bound, held, api.get_lease(pk.shards.shard_lease_name(0))
        finally:
            server.stop()

    for server_pk in (PORT, JAX):
        assert case(PORT, server_pk) == case(JAX, server_pk) == (6, "r1", None)


# --- checkpoint v3 -----------------------------------------------------------------


def _v3_checkpoint(pk, path):
    clock = FakeClock()
    api = pk.fake_api.FakeApiServer(clock=clock)
    _fleet(pk, api, nodes=2, pods=0)
    s = _sched(pk, api, clock, shards=4, identity="r1", lease_duration=6.0)
    s.run_cycle()
    s.requeue_at.fail("default/a", "no-node", clock.t)
    s.requeue_at.fail("default/a", "no-node", clock.t)
    s.requeue_at.fail("default/b", "api-error", clock.t)
    s.deferred_binds["default/d1"] = "n0"
    s.deferred_binds["default/d2"] = "n1"
    pk.checkpoint.save_scheduler(s, str(path))
    state = json.load(open(path / "state.json"))
    # Host-to-device bytes: the port's CudaBackend copies, NativeBackend does not.
    state["counters"].pop("scheduler_device_transfer_bytes_total", None)
    return state


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_checkpoint_v3_roundtrips_shard_grouped_requeue_and_deferred(writer, reader, tmp_path):
    """The shard-grouped file is the JAX package's, and it restores across
    the packages both ways."""
    wpk, rpk = (PORT if writer == "port" else JAX), (PORT if reader == "port" else JAX)
    state = _v3_checkpoint(wpk, tmp_path / "w")
    other = _v3_checkpoint(JAX if writer == "port" else PORT, tmp_path / "o")
    assert state == other
    assert state["version"] == 5 and state["shard_count"] == 4
    for pf in ("default/a", "default/b"):
        assert pf in state["shards"][str(shards.shard_for_name(pf, 4))]["requeue"]
    assert state["shards"][str(shards.shard_for_name("default/a", 4))]["requeue"]["default/a"][1:] == ["no-node", 2]
    assert [(e[0], e[1]) for e in state["deferred_binds"]] == [("default/d1", "n0"), ("default/d2", "n1")]
    assert all(e[2] == shards.shard_for_name(e[0], 4) for e in state["deferred_binds"])

    clock2 = FakeClock(5.0)
    api2 = rpk.fake_api.FakeApiServer(clock=clock2)
    _fleet(rpk, api2, nodes=2, pods=0)
    s2 = _sched(rpk, api2, clock2, shards=4, identity="r1", lease_duration=6.0)
    assert rpk.checkpoint.restore_scheduler(s2, str(tmp_path / "w")) is True
    assert s2.requeue_at.attempts("default/a") == 2
    assert s2.requeue_at.meta()["default/b"] == ("api-error", 1)
    assert list(s2.deferred_binds.items()) == [("default/d1", "n0"), ("default/d2", "n1")]


def test_restored_deferred_binds_flush_exactly_once(tmp_path):
    def case(pk):
        path = tmp_path / pk.name
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        api.load(nodes=[pk.testing.make_node("n0", cpu="8", memory="32Gi")],
                 pods=[pk.testing.make_pod("held"), pk.testing.make_pod("flushed")])
        s = _sched(pk, api, clock, shards=2, identity="r1", lease_duration=6.0)
        s.deferred_binds["default/held"] = "n0"
        s.deferred_binds["default/flushed"] = "n0"
        pk.checkpoint.save_scheduler(s, str(path))
        api.create_binding("default", "flushed", pk.objects.ObjectReference(name="n0"))
        before = api.binding_count
        s2 = _sched(pk, api, clock, shards=2, identity="r2", lease_duration=6.0)
        pk.checkpoint.restore_scheduler(s2, str(path))
        assert set(s2.deferred_binds) == {"default/held", "default/flushed"}
        s2.run_cycle()
        assert api.binding_count == before + 1 and not s2.deferred_binds
        assert len(api.list_pods("status.phase=Pending")) == 0
        return api.binding_count - before, json.load(open(path / "state.json"))["deferred_binds"]

    _both(case)


# --- /debug/shards -------------------------------------------------------------------


def _debug_body(pk, server_pk):
    clock = FakeClock()
    api = pk.fake_api.FakeApiServer(clock=clock)
    _fleet(pk, api, nodes=2, pods=2)
    s = _sched(pk, api, clock, shards=2, identity="r1", lease_duration=6.0)
    s.run_cycle()
    server = server_pk.http_api.HttpApiServer(api, metrics=s.metrics, shards=s.shards_snapshot).start()
    try:
        code, body = server_pk.http_api.KubeApiClient(server.base_url)._request_json("GET", "/debug/shards")
    finally:
        server.stop()
    assert code == 200
    assert body["enabled"] is True and body["replica_id"] == "r1"
    assert body["owned"] == [0, 1] and body["num_shards"] == 2
    lease = body["leases"][shards.SHARD_LEASE_PREFIX + "0"]
    assert lease["holder"] == "r1" and lease["expires_in_s"] > 0
    body.pop("perf")  # wall-clock cycle quantiles
    return body


def test_debug_shards_route():
    """The payload over each package's own server equals the JAX one's but
    for ``fleet.mesh_bindings``: NativeBackend has no bindings to report
    (None), the port's CudaBackend reports its bindings — none under hash
    keying.  ``tests/test_torch_fleet.py`` holds the bindings against the
    JAX TpuBackend's."""
    port, jax = _debug_body(PORT, PORT), _debug_body(JAX, JAX)
    assert port["fleet"].pop("mesh_bindings") == {} and jax["fleet"].pop("mesh_bindings") is None
    assert port == jax
    bare = http_api.HttpApiServer(fake_api.FakeApiServer()).start()
    try:
        code, _ = http_api.KubeApiClient(bare.base_url)._request_json("GET", "/debug/shards")
        assert code == 404
    finally:
        bare.stop()


def test_unsharded_snapshot_matches_jax():
    def case(pk):
        body = _sched(pk, pk.fake_api.FakeApiServer(), identity="r0").shards_snapshot()
        body.pop("perf")
        return body

    assert _both(case) == {"enabled": False, "num_shards": 1, "replica_id": "r0"}
