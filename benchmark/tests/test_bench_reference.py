"""The plain reference on a tiny cluster checked by hand, and the control
it drives."""

from benchmark.reference.check import Cluster, replay
from benchmark.reference.greedy import GreedyScheduler

NODES = {"n0": 0, "n1": 1, "n2": 2, "n3": 3}


def tiny(cpu=(2000,) * 4, mem=(1000,) * 4) -> Cluster:
    return Cluster(NODES, cpu, mem, pod_cpu=1000, pod_mem=100)


def test_a_sound_log_counts_nothing():
    log = [("C", "p", "n0", 0)] + [("C", n, None, 0) for n in ("q", "a", "b", "c", "d")]
    log += [("B", "q", "n1", 1), ("B", "a", "n2", 1), ("B", "b", "n3", 1), ("B", "c", "n3", 1), ("B", "d", "n0", 1),
            ("M", None, None, 2),
            ("D", "q", None, 3), ("C", "r", None, 3), ("B", "r", "n1", 4)]
    assert replay(tiny(), log) == dict.fromkeys(replay(tiny(), []), 0)


def test_each_broken_guarantee_counts():
    log = [("C", n, None, 0) for n in ("p", "q", "x", "u")]
    log += [("B", "p", "n0", 1), ("B", "q", "n0", 1), ("B", "x", "n0", 1),  # the third overcommits n0's CPU
            ("B", "p", "n3", 3), ("B", "nobody", "n3", 3), ("B", "u", "n9", 3)]
    assert replay(tiny(), log) == {"bad_binds": 3, "overcommitted_binds": 1, "unbound_pods": 1,
                                   "passed_over_pct": 0}


def test_passed_over_nodes_at_each_mark():
    log = [("C", n, None, 0) for n in ("a", "b", "c", "d")]
    # A packer: n0 and n1 full, n2 and n3 passed over with room.
    log += [("B", "a", "n0", 1), ("B", "b", "n0", 1), ("B", "c", "n1", 1), ("B", "d", "n1", 1), ("M", None, None, 2)]
    marks = []
    assert replay(tiny(), log, marks)["passed_over_pct"] == 50.0
    assert marks == [(0, 1.0, 2, 2)]
    # A full node that got nothing is not passed over; a mark with no
    # binding since the last one reads nothing; the most at a mark counts.
    full = [("C", "f1", "n2", 0), ("C", "f2", "n2", 0)] + log[:4] + [
        ("B", "a", "n0", 1), ("B", "b", "n1", 1), ("B", "c", "n3", 1), ("M", None, None, 2), ("M", None, None, 3),
        ("C", "e", None, 4), ("B", "e", "n0", 5), ("M", None, None, 6)]
    assert replay(tiny(), full)["passed_over_pct"] == 50.0


def test_greedy_packs_and_its_control_breaks_fit():
    for breaks in (None, "fit"):
        pods = [f"p{i}" for i in range(6)]
        log = [("C", n, None, 0) for n in pods]
        g = GreedyScheduler(tiny(cpu=(4000,) * 4), breaks=breaks)
        log += [("B", p, f"n{row}", 1) for p, row in g.cycle(log)]
        log.append(("M", None, None, 2))
        out = replay(tiny(cpu=(4000,) * 4), log)
        if breaks is None:
            assert out == {"bad_binds": 0, "overcommitted_binds": 0, "unbound_pods": 0, "passed_over_pct": 50.0}
        else:
            assert out["overcommitted_binds"] == 2 and out["passed_over_pct"] == 75.0, out
