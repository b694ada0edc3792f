"""The plain reference on a tiny cluster checked by hand, and the control
it drives."""

import pytest

from benchmark.cluster import Term
from benchmark.reference.check import Cluster, Kind, replay
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


# -- inter-pod terms ----------------------------------------------------------

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
SIX = {f"n{i}": i for i in range(6)}  # zones a b c a b c


def term(kind, key, app, hard=True, max_skew=1, weight=0):
    return Term(kind, key, (("app", app),), weight, max_skew, hard)


KINDS = {
    "plain": Kind(100, 100, {}),
    "anti": Kind(100, 100, {"app": "x"}, (term("anti_affinity", HOST, "x"),)),
    "x": Kind(100, 100, {"app": "x"}),  # matched by anti's term, carries none
    "aff": Kind(100, 100, {"app": "y"}, (term("affinity", ZONE, "y"),)),
    "follow": Kind(100, 100, {"app": "q"}, (term("affinity", ZONE, "y"),)),  # does not match its own term
    "spread": Kind(100, 100, {"app": "z"}, (term("spread", ZONE, "z", max_skew=1),)),
    "soft": Kind(100, 100, {"app": "w"}, (term("spread", ZONE, "w", hard=False),
                                          term("preferred_affinity", ZONE, "nobody", hard=False, weight=5),
                                          term("preferred_anti_affinity", HOST, "w", hard=False, weight=5))),
}


def six(*kinds) -> Cluster:
    """Six roomy nodes in zones a b c a b c; a pod ``<kind>-<i>`` is of that kind."""
    names = list(KINDS)
    order = [KINDS[k] for k in names]
    labels = {HOST: list(SIX), ZONE: ["a", "b", "c"] * 2}
    return Cluster(SIX, (10_000,) * 6, (10_000,) * 6, 100, 100, node_labels=labels, kinds=order,
                   kind_of=lambda pod: names.index(pod.split("-")[0]))


def bursts(*groups):
    """Each group of bindings its own burst: a create of an unrelated pod
    between them ends the one before.  A group is [(pod, node)]; every pod
    is created pending first."""
    log = [("C", p, None, 0) for g in groups for p, _ in g]
    for k, g in enumerate(groups):
        log += [("B", p, n, 1) for p, n in g] + [("C", f"plain-sep{k}", None, 1)]
    return log


INTER = ("anti_affinity_violations", "affinity_violations", "spread_skew_excess")


def inter(out):
    return tuple(out.get(k) for k in INTER)


def test_anti_affinity_counted_once_each_way():
    # anti-2 beside anti-1 breaks both rules: one count.
    assert inter(replay(six(), bursts([("anti-1", "n0")], [("anti-2", "n0")]))) == (1, 0, 0)
    # The symmetric rule: a pod that carries no term, matched by a bound pod's.
    assert inter(replay(six(), bursts([("anti-1", "n1")], [("x-1", "n1"), ("x-2", "n2")]))) == (1, 0, 0)
    # ... and the other way round: the term arrives second.
    assert inter(replay(six(), bursts([("x-1", "n1")], [("anti-1", "n1")]))) == (1, 0, 0)
    # One burst: no order separates the pair.
    assert inter(replay(six(), bursts([("anti-1", "n3"), ("anti-2", "n3"), ("anti-3", "n4")]))) == (1, 0, 0)


def test_affinity_and_the_first_of_a_series():
    # The first pod of a series goes anywhere, the next to its zone.
    ok = bursts([("aff-1", "n1")], [("aff-2", "n4"), ("aff-3", "n4")])
    assert inter(replay(six(), ok)) == (0, 0, 0)
    # Another zone than the first's: counted.
    assert inter(replay(six(), bursts([("aff-1", "n1")], [("aff-2", "n2")]))) == (0, 1, 0)
    # Two firsts in one burst: only one of them can be first.
    assert inter(replay(six(), bursts([("aff-1", "n0"), ("aff-2", "n1"), ("aff-3", "n3")]))) == (0, 1, 0)
    # A pod that does not match its own term has no waiver ...
    assert inter(replay(six(), bursts([("follow-1", "n0")]))) == (0, 1, 0)
    # ... and is fine where its term finds a pod.
    assert inter(replay(six(), bursts([("aff-1", "n2")], [("follow-1", "n5")]))) == (0, 0, 0)


def test_spread_skew():
    assert inter(replay(six(), bursts([("spread-1", "n0")], [("spread-2", "n3")]))) == (0, 0, 1)
    assert inter(replay(six(), bursts([("spread-1", "n0")], [("spread-2", "n1")], [("spread-3", "n2")],
                                      [("spread-4", "n3")]))) == (0, 0, 0)
    # One burst is judged in the order that keeps it: a a b c is a b c a.
    burst = [("spread-1", "n0"), ("spread-2", "n3"), ("spread-3", "n1"), ("spread-4", "n2")]
    assert inter(replay(six(), bursts(burst))) == (0, 0, 0)
    assert inter(replay(six(), bursts(*([b] for b in burst)))) == (0, 0, 1)
    # No order keeps a a a b: the two pods past the skew count.
    burst = [("spread-1", "n0"), ("spread-2", "n3"), ("spread-3", "n0"), ("spread-4", "n1")]
    assert inter(replay(six(), bursts(burst))) == (0, 0, 2)


def test_soft_terms_never_count():
    log = bursts([(f"soft-{i}", "n0") for i in range(5)])
    out = replay(six(), log)
    assert inter(out) == (0, 0, 0)
    only_soft = Cluster(SIX, (10_000,) * 6, (10_000,) * 6, 100, 100, node_labels={ZONE: ["a", "b", "c"] * 2},
                        kinds=[KINDS["plain"], KINDS["soft"]], kind_of=lambda pod: int(pod.startswith("soft")))
    assert list(replay(only_soft, log)) == ["bad_binds", "overcommitted_binds", "unbound_pods", "passed_over_pct"]


@pytest.mark.parametrize("only, log, count", [
    ("anti", bursts([("anti-1", "n0")], [("anti-2", "n0"), ("x-1", "n0")]), "anti_affinity_violations"),
    ("aff", bursts([("aff-1", "n1")], [("aff-2", "n2"), ("aff-3", "n4")]), "affinity_violations"),
    ("spread", bursts([("spread-1", "n0"), ("spread-2", "n3"), ("spread-3", "n1")]), "spread_skew_excess"),
])
def test_kinds_that_carry_one_required_term(only, log, count):
    # Only the count of the term some kind carries is judged and printed.
    names = ["plain", only, "x"]
    cluster = Cluster(SIX, (10_000,) * 6, (10_000,) * 6, 100, 100, node_labels={HOST: list(SIX), ZONE: ["a", "b", "c"] * 2},
                      kinds=[KINDS[k] for k in names], kind_of=lambda pod: names.index(pod.split("-")[0]))
    out = replay(cluster, log)
    assert list(out) == ["bad_binds", "overcommitted_binds", "unbound_pods", "passed_over_pct", count], out
    assert out[count] == (2 if only == "anti" else 1), out


def test_deletes_free_a_domain():
    log = bursts([("anti-1", "n0")]) + [("D", "anti-1", None, 2), ("C", "anti-2", None, 2), ("B", "anti-2", "n0", 3)]
    assert inter(replay(six(), log)) == (0, 0, 0)
    # a b c a, then a fifth in a: past the skew, unless the fourth left.
    log = bursts(*([(f"spread-{i}", f"n{i}")] for i in range(4)))
    fifth = [("C", "spread-5", None, 2), ("B", "spread-5", "n0", 3)]
    assert inter(replay(six(), log + fifth)) == (0, 0, 1)
    assert inter(replay(six(), log + [("D", "spread-3", None, 2)] + fifth)) == (0, 0, 0)


@pytest.mark.parametrize("breaks", [None, "fit", "affinity"])
def test_greedy_filters_and_its_controls(breaks):
    pods = [f"{k}-{i}" for i in range(6) for k in ("aff", "spread")]
    pods += [f"{k}-{i}" for i in range(3) for k in ("anti", "x")]
    log = [("C", p, None, 0) for p in pods]
    g = GreedyScheduler(six(), breaks=breaks)
    log += [("B", p, f"n{row}", 1) for p, row in g.cycle(log)]
    out = replay(six(), log)
    if breaks == "affinity":  # MostAllocated piles them up on the first node
        assert out["anti_affinity_violations"] > 0 and out["spread_skew_excess"] > 0, out
    else:
        assert inter(out) == (0, 0, 0) and out["unbound_pods"] == 0 and out["overcommitted_binds"] == 0, out
