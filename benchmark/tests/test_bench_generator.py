"""The generator is deterministic from the seed, and every seed does the
same work in another order."""

import json

import numpy as np
import pytest

from benchmark import cluster as gen
from benchmark.spec import BENCH_DIR


def test_same_seed_same_inputs():
    a = gen.base_placement(1000, 30, gen.rng_for(2**31 + 17, "base"))
    assert (a == gen.base_placement(1000, 30, gen.rng_for(2**31 + 17, "base"))).all()


def test_other_seed_same_counts_other_order():
    a = gen.base_placement(1000, 30, gen.rng_for(1, "base"))
    b = gen.base_placement(1000, 30, gen.rng_for(2, "base"))
    assert not (a == b).all()
    assert (np.bincount(a, minlength=30) == np.bincount(b, minlength=30)).all()


def test_base_placement_fills_nodes_evenly():
    rows = gen.base_placement(50_000, 5_000, gen.rng_for(3, "base"))
    assert np.bincount(rows, minlength=5000).tolist() == [10] * 5000


def test_deployment_and_traffic_parse():
    dep = gen.load_deployment(BENCH_DIR / "configs" / "basic-5k.json")
    assert (dep.nodes, gen.cpu_milli(dep.node_cpu), gen.cpu_milli(dep.pod_cpu)) == (5000, 4000, 100)
    assert gen.load_traffic(BENCH_DIR / "traffic" / "backlog.json")["wave"] == 100_000


def test_quantities():
    assert gen.cpu_milli("100m") == 100 and gen.cpu_milli("4") == 4000
    assert gen.mem_bytes("500Mi") == 500 * 2**20 and gen.mem_bytes("32Gi") == 32 * 2**30


FIXTURE = BENCH_DIR / "tests" / "interpod-300.json"


def test_plain_deployment_has_no_kinds():
    dep = gen.load_deployment(BENCH_DIR / "configs" / "basic-5k.json")
    assert dep.kinds == () and dep.node_labels == {} and len(gen.pod_types(dep)) == 1


def test_kinds_same_counts_other_order():
    dep = gen.load_deployment(FIXTURE)
    kinds = gen.pod_types(dep)
    assert len(kinds) == 1 + 5 * 100 and kinds[1].labels == (("app", "anti-0"),)
    a = gen.type_rows(dep, 6000, gen.rng_for(2**31 + 3, "kinds/w1"))
    b = gen.type_rows(dep, 6000, gen.rng_for(2**31 + 4, "kinds/w1"))
    assert not (a == b).all()
    counts = np.bincount(a, minlength=len(kinds))
    assert (counts == np.bincount(b, minlength=len(kinds))).all()
    assert counts[0] == 3000 and (counts[1:] == 6).all()  # a tenth a kind, 6 pods a Deployment


def test_kinds_build_the_ports_objects():
    from benchmark import system

    dep = gen.load_deployment(FIXTURE)
    nodes = system.make_nodes(dep)
    assert [n.metadata.labels["topology.kubernetes.io/zone"] for n in nodes[:4]] == ["zone-0", "zone-1", "zone-2",
                                                                                    "zone-0"]
    assert nodes[7].metadata.labels["kubernetes.io/hostname"] == "node-7"
    kinds = gen.pod_types(dep)
    rows = [0] + [1 + 100 * k for k in range(5)]  # plain, then each kind's first Deployment
    pods = system.make_pods(dep, [f"p-{i}" for i in range(6)], None, rows)
    plain, anti, aff, pref, pref_anti, spread = (p.spec for p in pods)
    assert pods[0].metadata.labels is None and plain.anti_affinity is None and plain.topology_spread is None
    assert pods[1].metadata.labels == {"app": "anti-0"}
    assert [(t.match_labels, t.topology_key) for t in anti.anti_affinity] == [({"app": "anti-0"},
                                                                               "kubernetes.io/hostname")]
    assert [(t.match_labels, t.topology_key) for t in aff.pod_affinity] == [({"app": "affinity-0"},
                                                                              "topology.kubernetes.io/zone")]
    assert [(w.weight, w.term.match_labels) for w in pref.preferred_pod_affinity] == [(1, {"app": "pref-affinity-0"})]
    assert [(w.weight, w.term.topology_key) for w in pref_anti.preferred_pod_anti_affinity] == [
        (1, "kubernetes.io/hostname")]
    assert [(s.when_unsatisfiable, s.max_skew, s.match_labels) for s in spread.topology_spread] == [
        ("DoNotSchedule", 1, {"app": "spread-0"}), ("ScheduleAnyway", 1, {"app": "spread-0"})]
    assert kinds[rows[5]].terms[0].hard and not kinds[rows[5]].terms[1].hard


def test_bad_kinds_are_refused(tmp_path):
    raw = json.loads(FIXTURE.read_text())
    for change in ({"terms": {"anti_affinity": {"topology_key": "rack"}}}, {"share": 0.9},
                   {"terms": {"spread": {"topology_key": "kubernetes.io/hostname", "when_unsatisfiable": "Never"}}},
                   {"terms": {"affinty": {"topology_key": "kubernetes.io/hostname"}}}):
        bad = json.loads(json.dumps(raw))
        bad["pod_kinds"][0].update(change)
        (tmp_path / "bad.json").write_text(json.dumps(bad))
        with pytest.raises((ValueError, KeyError)):
            gen.load_deployment(tmp_path / "bad.json")


def test_pods_bound_at_the_start_are_plain():
    from benchmark import harness
    from benchmark.spec import Cell

    spec = {"configs": [{"name": "k", "file": str(FIXTURE)}],
            "workloads": [{"name": "k.backlog", "config": "k", "traffic": "backlog", "chips": 1}],
            "end_to_end": [], "per_layer": []}
    run = harness.Run(Cell(spec, "k.backlog"), 5, "cpu", "program", None, {"bound_at_start": 600}, False)
    base, _ = run.make_pods("base", 600, ["node-0"] * 600)
    wave, _ = run.make_pods("w1", 600)
    assert sum(p.metadata.labels is not None for p in base) == 0
    assert sum(p.metadata.labels is not None for p in wave) == 300
    assert run.kind_of("w1-7") == run.type_rows["w1"][7] and run.kind_of("base-3") == 0
