"""The inter-pod fixture on the seed whose measured wave the auction's round
cap used to leave partly unbound: the program now retries the pods a cycle
was cut off from, and binds the whole wave with every guarantee kept."""

import pathlib

from benchmark import harness
from benchmark.spec import Cell

CONFIG = pathlib.Path(__file__).resolve().parent / "interpod-300.json"
SPEC = {
    "configs": [{"name": "interpod-300", "file": str(CONFIG)}],
    "workloads": [{"name": "interpod-300.backlog", "config": "interpod-300", "traffic": "backlog", "chips": 1}],
    "end_to_end": [{"name": "backlog_pods_per_s", "unit": "pods/s"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}
SEED = 77777


def test_every_pod_of_the_wave_is_bound_on_the_seed_the_round_cap_cut():
    cell = Cell(SPEC, "interpod-300.backlog")
    out = harness.run(cell, SEED, 0.5, False, device="cpu",
                      scale={"bound_at_start": 3000, "wave": 6000, "grace_s": 60.0})
    checks = out["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, checks
    assert checks["unbound_pods"]["value"] == 0 and all(c["value"] == 0 for c in checks.values()), checks
