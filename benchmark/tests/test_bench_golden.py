"""``basic-5k.backlog`` is built and judged as it was before configuration
files could describe zones and pod kinds: at a small size and a fixed seed,
the nodes and pods the harness builds, and the reference's numbers and marks
over a planted log, equal what the benchmark gave before that change."""

import dataclasses
import hashlib
import json

from benchmark import harness
from benchmark.reference.check import replay
from benchmark.spec import Cell, load_spec

SCALE = {"nodes": 50, "bound_at_start": 500, "wave": 1000, "grace_s": 4.0}
SEED = 2**31 + 11

# sha256 of the objects as JSON, less their uids, from the benchmark before
# the schema grew.
DIGESTS = {
    "nodes": "47e7b7eb8dcf52ca0eb5088d01574ad80d076a2352b2509dbb367ffa7b0d6863",
    "bound": "ad2c044cfde3bf65afd8def906232127c90bc816cd240af470f18ac333ad2319",
    "wave": "cc897f2ed65b0469ab9fbb7517327306f7dcf43bf9a64c1808bbfd89334ffcc8",
}
# The reference's numbers and marks over ``planted_log``, from the same.
NUMBERS = {"bad_binds": 3, "overcommitted_binds": 100, "unbound_pods": 5, "passed_over_pct": 50.0}
MARKS = [[18, 18.0, 118, 0], [0, 5.5, 12, 25]]


def objects_digest(objs) -> str:
    rows = []
    for obj in objs:
        row = dataclasses.asdict(obj)
        row["metadata"].pop("uid")
        rows.append(row)
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()


def loaded_run() -> harness.Run:
    run = harness.Run(Cell(load_spec(), "basic-5k.backlog"), SEED, "cpu", "program", None, dict(SCALE), False)
    run.load_cluster()
    return run


def planted_log(run: harness.Run) -> list:
    """The loaded cluster's creates, then a wave bound by a plain rule: most
    pods spread by a stride, the last hundred on the first node (past its
    CPU), a rebinding, a binding to no node and one for no pod, a mark; then
    half the wave deleted and a second, smaller wave bound and marked."""
    n = run.dep.nodes
    log = [(op, pod, node, 0.0) for op, pod, node, _t in run.api.log]
    wave = [f"w0-{i}" for i in range(1000)]
    log += [("C", p, None, 1.0) for p in wave]
    log += [("B", p, f"node-{(7 * i) % n if i < 900 else 0}", 2.0) for i, p in enumerate(wave)]
    log += [("B", "w0-3", "node-1", 2.0), ("B", "w0-4", "node-9999", 2.0), ("B", "nobody", "node-2", 2.0),
            ("M", None, None, 3.0)]
    log += [("D", p, None, 4.0) for p in wave[::2]]
    second = [f"w1-{i}" for i in range(300)]
    log += [("C", p, None, 5.0) for p in second]
    log += [("B", p, f"node-{(3 * i) % (n // 2)}", 6.0) for i, p in enumerate(second[:-5])]
    log.append(("M", None, None, 7.0))
    return log


def test_nodes_and_pods_as_before():
    run = loaded_run()
    wave, names = run.make_pods("w0", int(run.traffic["wave"]))
    assert names[:2] == ["w0-0", "w0-1"]
    got = {"nodes": objects_digest(run.api.list_nodes()), "bound": objects_digest(run.api.list_pods()),
           "wave": objects_digest(wave)}
    assert got == DIGESTS


def test_reference_reads_as_before():
    run = loaded_run()
    marks: list = []
    assert replay(run.reference_cluster(), planted_log(run), marks) == NUMBERS
    assert [list(m) for m in marks] == MARKS
