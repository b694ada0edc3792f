"""The multi-mesh fleet on the port: ``tpu_scheduler_torch.fleet`` (the
topology keyer, cross-replica gang reservations, the live shard map), the
mesh bindings of ``parallel/mesh.py`` and ``CudaBackend``, checkpoint v5,
and the controller's fleet cycle — held against the JAX package.

Every case of ``tests/test_fleet.py`` (but the wall-clock gate
``test_vectorized_fold_microbench``) runs on both packages from the same
inputs, and the observations must be equal, exactly; the JAX test's own
assertions hold on both sides.  The checkpoint files cross the packages both
ways.  Then the keyer's outputs over seeded names and compiled topologies, a
rack-keyed fleet of replicas cycle by cycle (bindings, reservations, mesh
rebinds, the "mesh-rebind" escalation), and ``shards_snapshot()`` against
the JAX ``TpuBackend``'s on the CPU."""

import json
import random
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_scheduler.delta.index as jax_index  # noqa: E402
import tpu_scheduler.delta.state as jax_state  # noqa: E402
import tpu_scheduler.fleet.keyer as jax_keyer  # noqa: E402
import tpu_scheduler.fleet.reservation as jax_reservation  # noqa: E402
import tpu_scheduler.fleet.resize as jax_resize  # noqa: E402
import tpu_scheduler.runtime.checkpoint as jax_checkpoint  # noqa: E402
import tpu_scheduler.runtime.controller as jax_controller  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.shards as jax_shards  # noqa: E402
import tpu_scheduler.testing as jax_testing  # noqa: E402
import tpu_scheduler.topology.model as jax_topo_model  # noqa: E402
from tpu_scheduler.backends.native import NativeBackend  # noqa: E402
import tpu_scheduler_torch.delta.index as index  # noqa: E402
import tpu_scheduler_torch.delta.state as state_mod  # noqa: E402
import tpu_scheduler_torch.fleet as fleet  # noqa: E402
import tpu_scheduler_torch.fleet.keyer as keyer  # noqa: E402
import tpu_scheduler_torch.fleet.reservation as reservation  # noqa: E402
import tpu_scheduler_torch.fleet.resize as resize  # noqa: E402
import tpu_scheduler_torch.parallel.mesh as mesh  # noqa: E402
import tpu_scheduler_torch.runtime.checkpoint as checkpoint  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.shards as shards  # noqa: E402
import tpu_scheduler_torch.testing as testing  # noqa: E402
import tpu_scheduler_torch.topology.model as topo_model  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402

PORT = types.SimpleNamespace(
    name="port", keyer=keyer, reservation=reservation, resize=resize, checkpoint=checkpoint, controller=controller,
    fake_api=fake_api, shards=shards, testing=testing, topo=topo_model, index=index, state=state_mod,
    backend=lambda: CudaBackend(device="cpu"),
)
JAX = types.SimpleNamespace(
    name="jax", keyer=jax_keyer, reservation=jax_reservation, resize=jax_resize, checkpoint=jax_checkpoint,
    controller=jax_controller, fake_api=jax_fake_api, shards=jax_shards, testing=jax_testing, topo=jax_topo_model,
    index=jax_index, state=jax_state, backend=NativeBackend,
)
RACK_KEY = "topology.tpu-scheduler/rack"


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(case, *args):
    """Run ``case`` on each package; the observations must be equal."""
    port, jax = case(PORT, *args), case(JAX, *args)
    assert port == jax
    return port


def _racked_nodes(pk, n, rack_size):
    return [pk.testing.make_node(f"n{i:03d}", cpu="64", memory="256Gi", labels={RACK_KEY: f"rack-{i // rack_size}"})
            for i in range(n)]


def _topo(pk, nodes):
    return pk.topo.TopologyModel.detect(nodes).compile(nodes)


def _dm_obs(dm):
    return None if dm is None else (dm.num_shards, dm.domains, dm.domain_shard, dm.shard_nodes,
                                     sorted(dm.node_shard.items()))


# --- topology-keyed sharding (fleet/keyer.py) -------------------------------------


def test_domain_map_partitions_contiguous_and_balanced():
    def case(pk):
        dm = pk.keyer.DomainShardMap.compile(_topo(pk, _racked_nodes(pk, 8, 2)), 2)
        assert dm.domains == ("rack-0", "rack-1", "rack-2", "rack-3") and dm.domain_shard == (0, 0, 1, 1)
        assert dm.shard_nodes[0] == tuple(f"n{i:03d}" for i in range(4))
        assert dm.domains_of_shard(1) == ("rack-2", "rack-3")
        return _dm_obs(dm), dm.domains_of_shard(0), dm.domains_of_shard(1)

    _both(case)


def test_domain_map_never_splits_a_rack_and_stays_contiguous_when_uneven():
    def case(pk):
        nodes = _racked_nodes(pk, 10, 3)
        dm = pk.keyer.DomainShardMap.compile(_topo(pk, nodes), 3)
        for dom, shard in zip(dm.domains, dm.domain_shard):
            owners = {dm.node_shard[n.metadata.name] for n in nodes if n.metadata.labels[RACK_KEY] == dom}
            assert owners == {shard}, (dom, owners)
        assert tuple(name for slice_ in dm.shard_nodes for name in slice_) == tuple(n.metadata.name for n in nodes)
        return _dm_obs(dm)

    _both(case)


def test_domain_map_is_deterministic_across_compiles():
    def case(pk):
        nodes = _racked_nodes(pk, 12, 4)
        a = pk.keyer.DomainShardMap.compile(_topo(pk, nodes), 4)
        assert a == pk.keyer.DomainShardMap.compile(_topo(pk, nodes), 4)
        return _dm_obs(a)

    _both(case)


def test_domain_map_degenerate_inputs_return_none():
    def case(pk):
        topo = _topo(pk, _racked_nodes(pk, 4, 2))
        empty = pk.topo.TopologyModel.from_node_labels().compile([])
        return [pk.keyer.DomainShardMap.compile(t, k) for t, k in ((None, 4), (topo, 1), (topo, 0), (empty, 4))]

    assert _both(case) == [None] * 4


def test_hash_mode_is_bit_identical_to_flat_crc32():
    def case(pk):
        k = pk.keyer.ShardKeyer(4)
        assert k.mode == pk.keyer.KEYER_MODES[1] == "hash"
        keys = [k.shard_for_key(f"default/p{i}") for i in range(200)]
        assert keys == [pk.shards.shard_for_name(f"default/p{i}", 4) for i in range(200)]
        pods = [pk.testing.make_pod(f"p{i}") for i in range(50)]
        pods += [pk.testing.make_pod(f"g{i}", gang="train-job-7") for i in range(8)]
        pods += [pk.testing.make_pod("other-ns", namespace="team-a")]
        of_pod = [k.shard_of_pod(p) for p in pods]
        assert of_pod == [pk.shards.shard_of_pod(p, 4) for p in pods]
        assert k.node_set([0, 1, 2, 3]) == set()
        return keys, of_pod

    _both(case)


def test_topology_keyer_gang_atomicity_and_locality():
    def case(pk):
        dm = pk.keyer.DomainShardMap.compile(_topo(pk, _racked_nodes(pk, 16, 4)), 4)
        k = pk.keyer.ShardKeyer(4, dm)
        assert k.mode == "topology"
        members = [pk.testing.make_pod(f"m{i}", gang="train-7") for i in range(12)]
        assert {k.shard_of_pod(p) for p in members} == {k.shard_for_key("train-7")}
        assert k.shard_of_pod(pk.testing.make_pod("solo")) == k.shard_for_key("default/solo")
        spread = [k.shard_for_key(f"default/p{i}") for i in range(400)]
        assert set(spread) == set(range(4))
        assert k.node_set([0]) == set(dm.shard_nodes[0])
        assert k.node_set([99, -1]) == set()
        return spread, sorted(k.node_set([0, 3]))

    _both(case)


@pytest.mark.parametrize("n_nodes,rack,k", [(37, 5, 3), (64, 8, 4), (100, 7, 6), (33, 32, 4)])
def test_keyer_outputs_match_on_seeded_names_and_topologies(n_nodes, rack, k):
    """Seeded names (pods, gangs, namespaces) through both keyers over the
    same compiled topology (a slice level above the racks too)."""
    rng = random.Random(n_nodes * 31 + k)

    def nodes_of(pk):
        return [pk.testing.make_node(f"node-{i}", labels={RACK_KEY: f"r{i // rack}",
                                                          "topology.tpu-scheduler/slice": f"s{i // (2 * rack)}"})
                for i in range(n_nodes)]

    keys = [f"ns{rng.randrange(4)}/pod-{rng.randrange(10**6)}" for _ in range(300)]
    gangs = [f"gang-{rng.randrange(10**4)}" for _ in range(40)]

    def case(pk):
        dm = pk.keyer.DomainShardMap.compile(_topo(pk, nodes_of(pk)), k)
        kk = pk.keyer.ShardKeyer(k, dm)
        pods = [pk.testing.make_pod(f"m{i}", gang=g) for i, g in enumerate(gangs)]
        pods += [pk.testing.make_pod(key.split("/")[1], namespace=key.split("/")[0]) for key in keys[:60]]
        return (_dm_obs(dm), [kk.shard_for_key(x) for x in keys + gangs], [kk.shard_of_pod(p) for p in pods],
                [sorted(kk.node_set([s])) for s in range(k)])

    _both(case)


def test_keyer_single_shard_degenerates_to_zero():
    def case(pk):
        dm = pk.keyer.DomainShardMap.compile(_topo(pk, _racked_nodes(pk, 4, 2)), 2)
        return pk.keyer.ShardKeyer(1, dm).shard_for_key("anything")

    assert _both(case) == 0


# --- cross-replica gang reservations (fleet/reservation.py) -------------------------


def _lease(api, name):
    info = api.get_lease(name)
    return None if info is None else (info["holder"], info.get("expires"))


def test_reserve_is_all_or_nothing_with_rollback():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        r = pk.reservation
        led = r.GangReservationLedger(api, "r1", 6.0, clock)
        obs = [led.reserve("g1", [1, 2]), _lease(api, r.reservation_lease_name("g1", 1)), led.active(),
               sorted(led.active_shards()), led.reserve("g1", [1, 2]), dict(led.counts)]
        api.acquire_lease(r.reservation_lease_name("g2", 3), "r2", 60.0)
        obs += [led.reserve("g2", [1, 3]), _lease(api, r.reservation_lease_name("g2", 1)), led.active(),
                dict(led.counts), led.commit("g1"), _lease(api, r.reservation_lease_name("g1", 1)),
                led.commit("g1"), dict(led.counts)]
        assert obs[0] is True and obs[6] is False and obs[12] is False
        assert set(led.counts) == set(r.RESERVATION_STATES)
        return obs

    _both(case)


def test_crashed_owner_reservations_expire_within_one_ttl():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        r = pk.reservation
        led1 = r.GangReservationLedger(api, "r1", 6.0, clock)
        obs = [led1.reserve("wide", [0, 1])]
        clock.t += 3.0
        led2 = r.GangReservationLedger(api, "r2", 6.0, clock)
        obs += [r.count_orphaned_reservations(api, clock.t, {"r2"}), led2.reserve("wide", [0])]
        clock.t += 4.0
        obs += [r.count_orphaned_reservations(api, clock.t, {"r2"}), led2.reserve("wide", [0, 1]), led1.renew(),
                led1.active(), dict(led1.counts), r.count_orphaned_reservations(api, clock.t, {"r2"})]
        return obs

    assert _both(case) == [True, 2, False, 0, True, 1, {}, {"reserved": 1, "committed": 0, "aborted": 0,
                                                              "expired": 1}, 0]


def test_partial_lease_loss_expires_once_and_releases_survivors():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        r = pk.reservation
        led = r.GangReservationLedger(api, "r1", 6.0, clock)
        obs = [led.reserve("wide", [0, 1, 2])]
        api.release_lease(r.reservation_lease_name("wide", 1), "r1")
        api.acquire_lease(r.reservation_lease_name("wide", 1), "r2", 60.0)
        obs += [led.renew(), dict(led.counts), led.active(), _lease(api, r.reservation_lease_name("wide", 0)),
                _lease(api, r.reservation_lease_name("wide", 2)), led.renew(), dict(led.counts)]
        return obs

    obs = _both(case)
    assert obs[1] == 1 and obs[2]["expired"] == 1 and obs[4] is None and obs[5] is None and obs[6] == 0


def test_abort_and_release_all_hand_rows_back_immediately():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        r = pk.reservation
        led = r.GangReservationLedger(api, "r1", 60.0, clock)
        obs = [led.reserve("a", [1]), led.reserve("b", [2, 3]), led.debug(), led.abort("a"),
               _lease(api, r.reservation_lease_name("a", 1))]
        led.release_all()
        obs += [led.active(), _lease(api, r.reservation_lease_name("b", 2)), dict(led.counts),
                r.count_orphaned_reservations(api, clock.t, set())]
        return obs

    obs = _both(case)
    assert obs[7]["aborted"] == 2 and obs[8] == 0


def test_orphan_count_is_vacuous_without_a_lease_collection_route():
    class NoListApi:
        pass

    assert reservation.count_orphaned_reservations(NoListApi(), 0.0, set()) == 0
    assert reservation.GANG_RESERVATION_PREFIX == jax_reservation.GANG_RESERVATION_PREFIX
    assert reservation.RESERVATION_STATES == jax_reservation.RESERVATION_STATES
    assert reservation.reservation_lease_name("g", 3) == jax_reservation.reservation_lease_name("g", 3)
    import tpu_scheduler.fleet as jax_fleet

    assert fleet.__all__ == jax_fleet.__all__
    assert fleet.KEYER_MODES == jax_fleet.KEYER_MODES and fleet.SHARD_MAP_LEASE == jax_fleet.SHARD_MAP_LEASE


# --- live shard resizing (fleet/resize.py + ShardSet) -------------------------------


def test_shard_map_holder_string_encoding():
    for gen, count in ((3, 8), (0, 1), (12, 2)):
        assert resize.encode_shard_map(gen, count) == jax_resize.encode_shard_map(gen, count)
    for holder in ("3:8", None, "", "x", "3", "a:b", "-1:4", "2:0", "1:2:3x", 7, "0:1"):
        assert resize.decode_shard_map(holder) == jax_resize.decode_shard_map(holder), holder
    assert resize.decode_shard_map("3:8") == (3, 8)


def test_publish_is_monotonic_and_read_ignores_expiry():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        z = pk.resize
        obs = [z.read_shard_map(api), z.publish_shard_map(api, 1, 8, 2.0), z.read_shard_map(api),
               api.get_lease(z.SHARD_MAP_LEASE)["holder"], z.publish_shard_map(api, 1, 2, 2.0),
               z.publish_shard_map(api, 0, 16, 2.0), z.publish_shard_map(api, 2, 2, 2.0)]
        clock.t += 100.0
        obs += [z.read_shard_map(api), z.publish_shard_map(api, 3, 16, 2.0), z.read_shard_map(api)]
        return obs

    assert _both(case) == [None, True, (1, 8), "1:8", False, False, True, (2, 2), True, (3, 16)]


def test_live_split_and_merge_keep_ownership_disjoint_without_restart():
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        s1 = pk.shards.ShardSet(api, 4, "r1", 6.0, clock)
        s2 = pk.shards.ShardSet(api, 4, "r2", 6.0, clock)
        trail = []

        def settle(rounds=4):
            for _ in range(rounds):
                s1.refresh()
                s2.refresh()
                clock.t += 1.0
                assert not (set(s1.owned) & set(s2.owned)), (s1.owned, s2.owned)
                trail.append((sorted(s1.owned), sorted(s2.owned), s1.num_shards, s2.num_shards))

        settle()
        coord, other = (s1, s2) if 0 in s1.owned else (s2, s1)
        trail.append((other.publish_resize(8), coord.publish_resize(8)))
        settle()
        assert s1.num_shards == s2.num_shards == 8 and set(s1.owned) | set(s2.owned) == set(range(8))
        coord = s1 if 0 in s1.owned else s2
        trail.append(coord.publish_resize(2))
        settle()
        assert s1.num_shards == s2.num_shards == 2 and set(s1.owned) | set(s2.owned) == {0, 1}
        trail.append([api.get_lease(pk.shards.shard_lease_name(s)) for s in range(2, 8)])
        return trail, s1.map_generation, s2.map_generation

    _both(case)


# --- checkpoint v5 / v4 migration ---------------------------------------------------


def _sched(pk, api, clock, identity="r1", shards=4, **kw):
    return pk.controller.Scheduler(api, pk.backend(), shards=shards, identity=identity, clock=clock,
                                   lease_duration=6.0, rng=random.Random(3), **kw)


def _load(pk, api, nodes=2):
    api.load(nodes=[pk.testing.make_node(f"n{i}", cpu="64", memory="256Gi") for i in range(nodes)], pods=[])


def _v5_write(pk, path):
    clock = FakeClock()
    api = pk.fake_api.FakeApiServer(clock=clock)
    _load(pk, api)
    s = _sched(pk, api, clock)
    s.run_cycle()
    assert pk.resize.publish_shard_map(api, 1, 8, 6.0) is True
    clock.t += 1.0
    s.run_cycle()
    assert s.shard_set.num_shards == 8 and s.shard_set.map_generation == 1
    pk.checkpoint.save_scheduler(s, str(path))
    state = json.load(open(path / "state.json"))
    state["counters"].pop("scheduler_device_transfer_bytes_total", None)
    return state


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_checkpoint_v5_roundtrips_adopted_shard_map(writer, reader, tmp_path):
    wpk, rpk = (PORT, JAX) if writer == "port" else (JAX, PORT)
    state = _v5_write(wpk, tmp_path / "w")
    assert state == _v5_write(rpk, tmp_path / "o")
    assert state["version"] == 5 and state["shard_map"] == {"generation": 1, "num_shards": 8, "keyer": "hash"}
    clock2 = FakeClock(5000.0)
    api2 = rpk.fake_api.FakeApiServer(clock=clock2)
    _load(rpk, api2)
    s2 = _sched(rpk, api2, clock2)
    assert rpk.checkpoint.restore_scheduler(s2, str(tmp_path / "w")) is True
    assert s2.shard_set.num_shards == 8 and s2.shard_set.map_generation == 1 and s2.num_shards == 8
    assert rpk.resize.publish_shard_map(api2, 2, 2, 6.0) is True
    s2.run_cycle()
    assert s2.shard_set.num_shards == 2 and s2.shard_set.map_generation == 2


def test_checkpoint_without_resize_omits_shard_map(tmp_path):
    def case(pk):
        clock = FakeClock()
        api = pk.fake_api.FakeApiServer(clock=clock)
        _load(pk, api)
        s = _sched(pk, api, clock)
        s.run_cycle()
        pk.checkpoint.save_scheduler(s, str(tmp_path / pk.name))
        state = json.load(open(tmp_path / pk.name / "state.json"))
        return state["version"], state["shard_map"], state["shard_count"]

    assert _both(case) == (5, None, 4)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_checkpoint_v4_migrates_with_one_full_wave(writer, reader, tmp_path):
    wpk, rpk = (PORT if writer == "port" else JAX), (PORT if reader == "port" else JAX)
    clock = FakeClock()
    api = wpk.fake_api.FakeApiServer(clock=clock)
    _load(wpk, api)
    s = _sched(wpk, api, clock)
    s.run_cycle()
    wpk.checkpoint.save_scheduler(s, str(tmp_path))
    state = json.load(open(tmp_path / "state.json"))
    state["version"] = 4
    state.pop("shard_map", None)
    json.dump(state, open(tmp_path / "state.json", "w"))
    clock2 = FakeClock(5000.0)
    api2 = rpk.fake_api.FakeApiServer(clock=clock2)
    _load(rpk, api2)
    s2 = _sched(rpk, api2, clock2)
    assert rpk.checkpoint.restore_scheduler(s2, str(tmp_path)) is True
    assert s2.shard_set.num_shards == 4 and s2.shard_set.map_generation == 0
    s2.run_cycle()
    assert s2.delta.full_solve_reasons.get("restore", 0) >= 1


# --- the reflector event fold (delta/index.py) ----------------------------------------


def _mk_state(pk, n_nodes=6):
    names = tuple(f"fn{i}" for i in range(n_nodes))
    return pk.state.SolveState(
        node_names=names, node_sig=("sig",), res_vocab=("cpu", "memory"), res_scales=(1, 1),
        alloc64=np.full((n_nodes, 2), 10**12, dtype=np.int64), used64=np.zeros((n_nodes, 2), dtype=np.int64),
        row={nm: i for i, nm in enumerate(names)},
    )


def _seed_and_events(pk, state, n=30):
    mk = pk.testing.make_pod
    names = state.node_names
    for i in range(n // 2):
        node = names[i % len(names)]
        pod = mk(f"old{i}", cpu="500m", memory="1Gi", node_name=node)
        state.commit(f"default/old{i}", node, pk.state.req64_of(pod, state.res_vocab))
    state.unsched["default/old1"] = (False, None, None, False)
    events = []
    for i in range(n // 2):
        prev = mk(f"old{i}", node_name=names[i % len(names)])
        if i % 3 == 0:
            events.append((("default", f"old{i}"), prev, None))
        elif i % 3 == 1:
            events.append((("default", f"old{i}"), prev, mk(f"old{i}")))
        else:
            events.append((("default", f"old{i}"), prev, mk(f"old{i}", node_name=names[(i + 1) % len(names)])))
    for i in range(n - n // 2):
        events.append((("default", f"new{i}"), None,
                       mk(f"new{i}", cpu="250m", memory="512Mi", node_name=names[(i * 3) % len(names)])))
    events.append((("default", "ghost"), mk("ghost"), None))
    return events


def _fold_obs(st, out):
    return (st.used64.tolist(), sorted((pf, e[0], e[1], e[2].tolist()) for pf, e in st.placements.items()),
            sorted(st.unsched.items()), out.ok, sorted(out.freed_nodes), out.freed_unknown, out.carrier_deleted,
            sorted(out.dirty))


def test_vectorized_fold_matches_scalar_bit_for_bit():
    def case(pk):
        fast, slow = _mk_state(pk), _mk_state(pk)
        ev_fast, ev_slow = _seed_and_events(pk, fast), _seed_and_events(pk, slow)
        out_fast = pk.index.DeltaIndex().fold(fast, ev_fast)
        out_slow = pk.index.DeltaIndex()._fold_scalar(slow, ev_slow)
        assert _fold_obs(fast, out_fast) == _fold_obs(slow, out_slow)
        assert out_fast.carrier_deleted is True and out_fast.ok is True
        return _fold_obs(fast, out_fast)

    _both(case)


def test_fold_dispatch_fast_path_vs_fallbacks(monkeypatch):
    def case(pk):
        calls = []
        orig = pk.index.DeltaIndex._fold_scalar
        monkeypatch.setattr(pk.index.DeltaIndex, "_fold_scalar",
                            lambda self, st, ev: calls.append(len(ev)) or orig(self, st, ev))
        st = _mk_state(pk)
        out = pk.index.DeltaIndex().fold(st, _seed_and_events(pk, st, n=20))
        obs = [out.ok, list(calls)]
        st2 = _mk_state(pk)
        ev2 = _seed_and_events(pk, st2, n=20)
        pk.index.DeltaIndex().fold(st2, ev2 + [ev2[0]])
        obs.append(list(calls))
        calls.clear()
        st3 = _mk_state(pk)
        pk.index.DeltaIndex().fold(st3, _seed_and_events(pk, st3, n=4)[:3])
        obs.append(list(calls))
        return obs

    assert _both(case) == [True, [], [22], [3]]


# --- the fleet cycle ------------------------------------------------------------------


def _fleet_run(pk, backend=None, kill_at=6, rounds=14, resize_at=None):
    """A rack-keyed fleet: 2 replicas over 4 shards on 16 nodes in racks of
    4, gangs wider than a shard's slice, replica 0 crash-killed mid-run."""
    clock = FakeClock()
    api = pk.fake_api.FakeApiServer(clock=clock)
    nodes = [pk.testing.make_node(f"n{i:02d}", cpu="4", memory="16Gi", labels={RACK_KEY: f"rack-{i // 4}"})
             for i in range(16)]
    api.load(nodes=nodes, pods=[])
    scheds = [pk.controller.Scheduler(api, backend if backend is not None else pk.backend(), shards=4,
                                      identity=f"replica-{i}", clock=clock, lease_duration=5.0,
                                      rng=random.Random(f"0:sched{i}"), requeue_seconds=1.0) for i in range(2)]
    rows = []
    alive = [True, True]
    for r in range(rounds):
        if r == 2:
            for i in range(24):
                api.create_pod(pk.testing.make_pod(f"solo{i}", cpu="500m", memory="1Gi"))
            for g in range(3):
                for m in range(10):
                    api.create_pod(pk.testing.make_pod(f"g{g}-{m}", cpu="1", memory="2Gi", gang=f"gang-{g}"))
        if resize_at is not None and r == resize_at:
            coord = next(s for i, s in enumerate(scheds) if alive[i] and 0 in s.shard_set.owned)
            rows.append(("resize", coord.identity, coord.resize_shards(8)))
        if r == kill_at:
            alive[0] = False
        for i, s in enumerate(scheds):
            if alive[i]:
                m = s.run_cycle()
                rows.append((r, i, m.pending, m.bound, m.unschedulable, sorted(s.shard_set.owned),
                             s.shard_set.num_shards, s.shard_set.keyer.mode if s.shard_set.keyer else None,
                             s._fleet_sliced, s._fleet_reservations.active(), sorted(s._mesh_shards)))
        clock.t += 1.0
    placement = sorted((p.metadata.name, p.spec.node_name) for p in api.list_pods())
    counters = []
    for s in scheds:
        snap = s.metrics.snapshot()
        counters.append({k: v for k, v in snap.items() if k.startswith(("scheduler_shard", "scheduler_mesh",
                                                                        "scheduler_gang_reserv", "scheduler_pods_bound"))})
    reasons = [dict(s.delta.full_solve_reasons) for s in scheds]
    debug = []
    for s in scheds:
        body = s.shards_snapshot()
        body.pop("perf")
        debug.append(body)
    for s in scheds[1:]:
        s.close()
    return rows, placement, counters, reasons, debug, api, scheds


def _strip_bindings(debug):
    return [{**d, "fleet": {k: v for k, v in d["fleet"].items() if k != "mesh_bindings"}} for d in debug]


def test_fleet_cycle_matches_jax():
    """Cycle by cycle the same pending, bound, owned shards, slicing,
    reservations and mesh shards; the same final placement, counters and
    escalation reasons; the survivor's takeover rebinds and escalates one
    "mesh-rebind" full wave; no node is oversubscribed."""
    port, jax = _fleet_run(PORT), _fleet_run(JAX)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[2] == jax[2] and port[3] == jax[3]
    assert _strip_bindings(port[4]) == _strip_bindings(jax[4])
    assert port[2][1].get("scheduler_mesh_rebinds_total", 0) >= 1
    assert port[3][1].get("mesh-rebind", 0) >= 1
    assert any(row[8] for row in port[0] if isinstance(row[0], int))  # a sliced solve ran
    assert sum(c.get("scheduler_gang_reservations_total", 0) for c in port[2]) >= 1
    api = port[5]
    used = {}
    for p in api.list_pods():
        if p.spec.node_name:
            used[p.spec.node_name] = used.get(p.spec.node_name, 0) + (1000 if p.spec.gang else 500)
    assert max(used.values()) <= 4000
    bindings = port[4][1]["fleet"]["mesh_bindings"]
    assert bindings and all(b["dedicated"] is False and b["devices"] == ["cpu"] for b in bindings.values())


def test_fleet_live_resize_matches_jax():
    port, jax = _fleet_run(PORT, kill_at=99, rounds=10, resize_at=5), _fleet_run(JAX, kill_at=99, rounds=10,
                                                                                  resize_at=5)
    assert port[0] == jax[0] and port[1] == jax[1] and port[3] == jax[3]
    assert any(r[0] == "resize" and r[2] is True for r in port[0])
    assert {row[6] for row in port[0] if isinstance(row[0], int) and row[0] >= 7} == {8}
    assert all(r.get("mesh-rebind", 0) >= 1 for r in port[3])


def test_shards_snapshot_matches_jax_tpu_backend():
    """``shards_snapshot()`` of the port over CudaBackend on the CPU against
    the JAX controller over ``TpuBackend`` on the CPU: equal but for each
    binding's ``devices`` (torch device strings where JAX lists device ids)
    and ``node_sharding`` (the port's plain layout where JAX prints a
    NamedSharding), as ``parallel/mesh.py`` documents."""
    import tpu_scheduler.utils.profiler as jax_profiler
    from tpu_scheduler.backends.tpu import TpuBackend

    # One backend shared by the replicas, as the sim shares it: its binding
    # dict holds every replica's shards.  TpuBackend turns on the JAX
    # profiler's process-wide compile listener flag, which later
    # NativeBackend sim cards in this process would read: restored after.
    port = _fleet_run(PORT, backend=CudaBackend(device="cpu"), kill_at=99, rounds=5)[4]
    saved = jax_profiler._hooks_installed[0]
    try:
        jax = _fleet_run(JAX, backend=TpuBackend(), kill_at=99, rounds=5)[4]
    finally:
        jax_profiler._hooks_installed[0] = saved
    excepted = ("devices", "node_sharding")
    seen = 0
    for p, j in zip(port, jax):
        pb, jb = p["fleet"]["mesh_bindings"], j["fleet"]["mesh_bindings"]
        assert sorted(pb) == sorted(jb) and pb
        for shard in pb:
            seen += 1
            assert {k: v for k, v in pb[shard].items() if k not in excepted} == \
                   {k: v for k, v in jb[shard].items() if k not in excepted}
            assert pb[shard]["devices"] == ["cpu"] and len(jb[shard]["devices"]) == 1
            assert pb[shard]["node_sharding"].startswith("NodeSharding(") and "tp" in jb[shard]["node_sharding"]
    assert seen == 8
    assert _strip_bindings(port) == _strip_bindings(jax)


def test_mesh_binding_slices_devices_like_jax():
    """With at least as many devices as shards each shard gets its own
    contiguous chunk (the last absorbs the remainder); with fewer, every
    shard binds the whole set — the JAX layout, over torch devices."""
    devs = [torch.device("cpu")] * 8
    shapes = [(mesh.mesh_binding(s, 3, devices=devs).mesh.shape, len(mesh.mesh_binding(s, 3, devices=devs).device_ids))
              for s in range(3)]
    assert shapes == [({"dp": 2, "tp": 1}, 2), ({"dp": 2, "tp": 1}, 2), ({"dp": 4, "tp": 1}, 4)]
    b = mesh.mesh_binding(1, 4, devices=devs, tp=2)
    assert b.dedicated and b.mesh.shape == {"dp": 1, "tp": 2}
    one = mesh.mesh_binding(3, 4, devices=[torch.device("cpu")])
    assert one.dedicated is False and one.device_ids == ("cpu",)
    assert str(mesh.node_sharding(b)) == "NodeSharding(mesh_shape=(1, 2), axis='tp', devices=(('cpu', 'cpu'),))"
    backend = CudaBackend(device="cpu")
    first = backend.bind_shard_mesh(2, 4)
    assert backend.bind_shard_mesh(2, 4) is first  # idempotent per (shard, K)
    assert backend.bind_shard_mesh(2, 8) is not first  # a new K rebinds
    assert backend.release_shard_mesh(2) is True and backend.release_shard_mesh(2) is False
    assert backend.mesh_bindings_info() == {}
