"""BENCHMARK.json and every file it names parse, and every name and unit
keeps to the allowed characters."""

import json

import pytest

from benchmark import cluster as gen
from benchmark.reference.greedy import GUARANTEES
from benchmark.spec import BENCH_DIR, ROOT, Cell, load_reader, load_spec, valid_name, valid_unit

SPEC = load_spec()


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(valid_name(n) for n in names), [n for n in names if not valid_name(n)]
    assert len(set(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert all(valid_unit(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    assert not valid_name("a b") and not valid_name("a/b") and not valid_unit("tokens per second")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_config_files_parse(path):
    raw = json.loads(path.read_text())
    dep = gen.load_deployment(path)
    assert dep.name == path.stem and raw["reduced"] == []
    for entry in SPEC["configs"]:
        if entry["name"] == dep.name:
            assert entry["reduced"] == raw["reduced"] and ROOT / entry["file"] == path
    assert dep.controller["delta"] is True and dep.controller["pipeline"] is True
    assert len(raw["source"]) <= 200 and raw["assumed"]
    assert raw["control"] in GUARANTEES


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_files_parse(path):
    raw = gen.load_traffic(path)
    assert raw["name"] == path.stem and raw["grace_s"] > 0 and valid_name(raw["name"])
    assert raw["wave"] > 0 and raw["warmup_waves"] >= 1


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = Cell(SPEC, workload)
    assert cell.config_file.exists() and cell.traffic_file.exists()
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_bounds_within_the_contract():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= SPEC["run_seconds"] <= 51
