"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is ``configs/<config>.json`` (as ``configs[].file``
says), the traffic's ``traffic/<traffic>.json``, and each per-layer metric's
reader ``metrics/<metric name>.py``.  A later change adds a cell, a mix or a
metric as new files plus new entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

__all__ = ["BENCH_DIR", "Cell", "load_spec", "load_reader", "valid_name", "valid_unit"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
_UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(s: str) -> bool:
    return isinstance(s, str) and _NAME.fullmatch(s) is not None


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and _UNIT.fullmatch(s) is not None


class Cell:
    """One ``workloads`` entry with the files and metrics it resolves to."""

    def __init__(self, spec: dict, name: str, root: pathlib.Path = ROOT, bench_dir: pathlib.Path = BENCH_DIR):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config_file = root / config["file"]
        self.traffic_file = bench_dir / "traffic" / f"{self.entry['traffic']}.json"
        self.bench_dir = bench_dir
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The ``read(trace) -> float | None`` function of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{abs(hash(metric))}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
