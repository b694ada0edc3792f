"""A later change adds a configuration, a traffic mix and a per-layer metric
as new files and entries: the harness finds each by name, with no edit to
a file that is there."""

import json
import shutil

from benchmark import harness
from benchmark.spec import BENCH_DIR, Cell

METRIC = '''
def read(trace):
    return float(len(trace["cycles"])) if trace["cycles"] else None
'''


def test_new_files_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    config = json.loads((BENCH_DIR / "configs" / "basic-5k.json").read_text())
    config.update(name="tiny-1", nodes=60)
    (bench / "configs" / "tiny-1.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH_DIR / "traffic" / "backlog.json").read_text())
    traffic.update(name="mini", bound_at_start=300, wave=600, grace_s=4.0)
    (bench / "traffic" / "mini.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "cycles_seen.mini.py").write_text(METRIC)
    shutil.copy(BENCH_DIR / "metrics" / "solve_ms_per_kpod.backlog.py", bench / "metrics")
    spec = {
        "configs": [{"name": "tiny-1", "file": "benchmark/configs/tiny-1.json"}],
        "workloads": [{"name": "tiny-1.mini", "config": "tiny-1", "traffic": "mini", "chips": 1}],
        "end_to_end": [{"name": "backlog_pods_per_s", "unit": "pods/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "cycles_seen.mini", "unit": "cycles", "moves": "backlog_pods_per_s"},
                      {"name": "solve_ms_per_kpod.backlog", "unit": "ms/kpod", "moves": "backlog_pods_per_s",
                       "workloads": ["basic-5k.backlog"]}],
    }
    cell = Cell(spec, "tiny-1.mini", root=tmp_path, bench_dir=bench)
    assert [m["name"] for m in cell.per_layer] == ["cycles_seen.mini"]
    traced = harness.run(cell, 3, 0.5, trace=True, device="cpu")
    assert traced["correct"] and traced["metrics"]["cycles_seen.mini"]["value"] >= 1
    assert traced["metrics"]["cycles_seen.mini"]["unit"] == "cycles"
    plain = harness.run(cell, 3, 0.5, trace=False, device="cpu")
    assert set(plain["metrics"]) == {"backlog_pods_per_s", "setup_s"}
