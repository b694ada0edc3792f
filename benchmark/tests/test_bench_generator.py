"""The generator is deterministic from the seed, and every seed does the
same work in another order."""

import numpy as np

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
