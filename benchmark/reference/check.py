"""The plain reference: Kubernetes' scheduling guarantees and the profile's
spread, replayed over the API server's log.

It imports nothing of the program and takes nothing the program made: it is
handed the benchmark's own description of the nodes and pods (allocatable
CPU and memory, each node's labels, each pod's requests, labels and
inter-pod terms, as plain numbers and strings) and the log of creates,
deletes and accepted bindings in the order the API server applied them, and
it works out the cluster's state again, event by event.

A scheduler's answer is a binding, and many placements are valid, so each
binding is judged by what it says, against the state the API server held
when it accepted it (its bound pods; pending pods count for nothing):

* ``bad_binds``: a binding for a pod that did not exist, was already bound,
  or names no node of the cluster.
* ``overcommitted_binds``: the node's bound requests plus this pod's exceed
  its allocatable CPU or memory.
* ``unbound_pods``: pods created and never bound by the end of the log.

and, where a pod kind of the configuration carries the required term each
judges (all three in Kubernetes' own form: a term sees the pods its
selector matches, in the topology domain of the node under its key):

* ``anti_affinity_violations``: the node's domain already holds a pod that
  one of the pod's required anti-affinity terms matches, or a pod whose own
  required anti-affinity term matches this pod (the symmetric rule).
* ``affinity_violations``: a required affinity term finds no matching pod
  in the node's domain, or the node lacks its key.  The term is waived, as
  Kubernetes waives it, when no bound pod matches all of the pod's affinity
  terms and the pod matches them itself: the first of a series.
* ``spread_skew_excess``: for a ``DoNotSchedule`` constraint, the matching
  pods in the node's domain, plus one where the pod matches its own
  selector, less the fewest matching pods of any domain, exceed
  ``max_skew``; or the node lacks the key.

The bindings the server accepted with no other event between them (a
burst: a scheduler's batch, posted concurrently) are judged on these three
as a set, the way Kubernetes' own scheduler makes them: it decides pod
after pod, each against the bound pods and those it assumed before it, and
posts the bindings concurrently, so the server may accept them in another
order than the one in which they were decided.  A burst keeps a guarantee
when some order of its bindings keeps it at every step: the reference
places, pass after pass, each binding that breaks nothing against the
state so far, and counts each one it never can, against the state the
others left (``InterPod.settle``).  An anti-affinity conflict reads in
every order; a spread or an affinity that only the order breaks does not.
Each binding counts at most once in each of the three.  Preferred terms
and ``ScheduleAnyway`` spreads are scores, not guarantees, and count
nowhere.
Each of these is an exact count: its limit is 0.  The placement is judged
too, at each quiescent mark (every pod of a batch bound):

* ``passed_over_pct``: the nodes that received none of the batch's
  bindings though they still have room at the mark for the smallest of the
  configuration's pods, as a share of the cluster's nodes, %, the most at
  any mark.  The default profile's LeastRequested and BalancedAllocation
  scores rank an emptier node higher, so a batch that averages many pods a
  node reaches every node with room; a bin-packing policy (MostAllocated,
  or the first node that fits) fills some nodes and passes the rest over.
  Its limit is set from readings (``PASSED_OVER_LIMIT``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Cluster", "InterPod", "Kind", "replay", "NUMBERS", "INTERPOD", "LIMITS"]

NUMBERS = (
    "bad_binds",
    "overcommitted_binds",
    "unbound_pods",
    "passed_over_pct",
)
# The inter-pod counts, each with the required term kind that makes it apply.
INTERPOD = {"anti_affinity_violations": "anti_affinity", "affinity_violations": "affinity",
            "spread_skew_excess": "spread"}
# The largest share of the nodes one batch may pass over, %: between the
# program's readings and a bin-packing scheduler's (PERF.md, section 2).
PASSED_OVER_LIMIT = 20.0
LIMITS = {"bad_binds": 0, "overcommitted_binds": 0, "unbound_pods": 0, "passed_over_pct": PASSED_OVER_LIMIT,
          **dict.fromkeys(INTERPOD, 0)}


class Kind(NamedTuple):
    """What the pods of one kind share: requests (millicores, bytes), labels
    and inter-pod terms (each with ``kind``, ``topology_key``, ``selector``
    as (key, value) pairs, ``max_skew`` and ``hard``:
    ``benchmark.cluster.Term``)."""

    cpu: int
    mem: int
    labels: dict
    terms: tuple = ()


class Cluster:
    """The inputs both sides were handed, as plain numbers.

    ``node_index``: node name -> row; ``alloc_cpu``/``alloc_mem`` [N]
    (millicores, bytes); ``pod_cpu``/``pod_mem``: the plain pod's requests.
    A cluster whose pods differ adds ``node_labels`` ({key: each row's value,
    None where a node lacks the key}), ``kinds`` (index 0 the plain pod) and
    ``kind_of`` (pod name -> index into ``kinds``)."""

    def __init__(self, node_index, alloc_cpu, alloc_mem, pod_cpu: int, pod_mem: int, node_labels=None,
                 kinds=None, kind_of=None):
        self.node_index = node_index
        self.alloc_cpu = np.asarray(alloc_cpu, dtype=np.int64)
        self.alloc_mem = np.asarray(alloc_mem, dtype=np.int64)
        self.pod_cpu = int(pod_cpu)
        self.pod_mem = int(pod_mem)
        self.node_labels = node_labels or {}
        self.kinds = list(kinds) if kinds else [Kind(self.pod_cpu, self.pod_mem, {})]
        self.kind_of = kind_of

    def kind(self, pod: str) -> int:
        return 0 if self.kind_of is None else self.kind_of(pod)

    def required(self) -> set[str]:
        """The required term kinds some pod kind carries."""
        return {t.kind for k in self.kinds for t in k.terms if t.hard}


def _matches(selector, labels: dict) -> bool:
    return all(labels.get(key) == value for key, value in selector)


def _affinity_selector(kind: Kind) -> tuple:
    """The selector a pod matches when it matches every one of ``kind``'s
    required affinity terms (no pod matches one with a key twice)."""
    return tuple(sorted({item for t in kind.terms if t.kind == "affinity" for item in t.selector}))


def _least(arr: np.ndarray) -> int:
    return int(arr[:-1].min()) if len(arr) > 1 else 0


class InterPod:
    """The bound pods as the required inter-pod terms see them: per
    (selector, topology key), the matching pods in each domain; per
    anti-affinity term, the pods in each domain that carry it; and the bound
    pods of each kind.  An affinity term counts the pods that match all of
    its pod's affinity terms, as Kubernetes counts them.  Domains are
    numbered per key; a count array has one slot more than the key has
    domains, always 0, which a row that lacks the key (domain -1) reads."""

    def __init__(self, cluster: Cluster):
        c = self.c = cluster
        n = len(c.alloc_cpu)
        sel = [[(_affinity_selector(k) if t.kind == "affinity" else tuple(t.selector), t) for t in k.terms if t.hard]
               for k in c.kinds]
        self.dom: dict[str, np.ndarray] = {}
        for key in sorted({t.topology_key for terms in sel for _, t in terms}):
            values = c.node_labels.get(key, [None] * n)
            ids: dict = {}
            self.dom[key] = np.array([-1 if v is None else ids.setdefault(v, len(ids)) for v in values],
                                     dtype=np.int64)

        def counts(pairs):
            return {p: np.zeros(self.dom[p[1]].max(initial=-1) + 2, dtype=np.int64) for p in sorted(pairs)}

        self.count = counts({(s, t.topology_key) for terms in sel for s, t in terms})
        self.carry = counts({(s, t.topology_key) for terms in sel for s, t in terms if t.kind == "anti_affinity"})
        self.bound = np.zeros(len(c.kinds), dtype=np.int64)
        # Per kind: the arrays a bound pod of it adds to (the counts its labels
        # match, the anti-affinity terms it carries); the carried terms that
        # match it; its required terms with their arrays.
        self.feeds = [[(arr, self.dom[p[1]]) for p, arr in self.count.items() if _matches(p[0], k.labels)]
                      + [(self.carry[(s, t.topology_key)], self.dom[t.topology_key])
                         for s, t in terms if t.kind == "anti_affinity"]
                      for k, terms in zip(c.kinds, sel)]
        self.exposed = [[(arr, self.dom[p[1]]) for p, arr in self.carry.items() if _matches(p[0], k.labels)]
                        for k in c.kinds]
        self.terms = [{kind: [(self.count[(s, t.topology_key)], self.dom[t.topology_key], t, _matches(s, k.labels))
                              for s, t in terms if t.kind == kind]
                       for kind in ("anti_affinity", "affinity", "spread")} for k, terms in zip(c.kinds, sel)]
        # Per kind with required affinity: the kinds that match all its terms.
        self.all_match = [np.array([i for i, o in enumerate(c.kinds) if _matches(_affinity_selector(k), o.labels)],
                                   dtype=np.int64) for k in c.kinds]

    def place(self, row: int, kind: int, sign: int) -> None:
        self.bound[kind] += sign
        for arr, dom in self.feeds[kind]:
            d = dom[row]
            if d >= 0:
                arr[d] += sign

    def _waived(self, kind: int) -> bool:
        """The first of a series: no bound pod matches all of the kind's
        affinity terms, and the kind matches them itself."""
        terms = self.terms[kind]["affinity"]
        return terms[0][3] and not self.bound[self.all_match[kind]].any()

    def broken(self, row: int, kind: int) -> tuple[bool, bool, bool]:
        """Whether binding a pod of ``kind`` to ``row`` breaks required
        anti-affinity, required affinity, and a hard spread."""
        terms = self.terms[kind]
        anti = any(arr[dom[row]] > 0 for arr, dom, _, _ in terms["anti_affinity"])
        anti = anti or any(arr[dom[row]] > 0 for arr, dom in self.exposed[kind])
        aff = False
        if terms["affinity"]:
            if any(dom[row] < 0 for _, dom, _, _ in terms["affinity"]):
                aff = True
            elif not all(arr[dom[row]] > 0 for arr, dom, _, _ in terms["affinity"]):
                aff = not self._waived(kind)
        spread = any(dom[row] < 0 or arr[dom[row]] + own - _least(arr) > t.max_skew
                     for arr, dom, t, own in terms["spread"])
        return anti, aff, spread

    def settle(self, burst) -> list[tuple[bool, bool, bool]]:
        """Place a burst of (row, kind) bindings that some order may make
        valid: pass after pass, each binding that breaks no required term
        against the state so far is placed, until a pass places none.
        Returns what each one left breaks (``broken``) against the state
        then, and places them too."""
        while burst:
            left = []
            for row, kind in burst:
                if any(self.broken(row, kind)):
                    left.append((row, kind))
                else:
                    self.place(row, kind, +1)
            if len(left) == len(burst):
                break
            burst = left
        out = [self.broken(row, kind) for row, kind in burst]
        for row, kind in burst:
            self.place(row, kind, +1)
        return out

    def allowed(self, kind: int) -> np.ndarray:
        """[N] bool: the rows where a pod of ``kind`` breaks no required
        term (the plain scheduler's filter)."""
        ok = np.ones(len(self.c.alloc_cpu), dtype=bool)
        terms = self.terms[kind]
        for arr, dom in [(arr, dom) for arr, dom, _, _ in terms["anti_affinity"]] + self.exposed[kind]:
            ok &= arr[dom] == 0
        if terms["affinity"]:
            waived = self._waived(kind)
            for arr, dom, _, _ in terms["affinity"]:
                ok &= (dom >= 0) if waived else (arr[dom] > 0)
        for arr, dom, t, own in terms["spread"]:
            ok &= (dom >= 0) & (arr[dom] + own - _least(arr) <= t.max_skew)
        return ok


def replay(cluster: Cluster, log, marks: list | None = None) -> dict:
    """Replay ``log`` ((op, pod, node, t) tuples) and count each way a
    binding broke a guarantee or the placement passed nodes over; see the
    module docstring.  The counts are those of ``NUMBERS`` and the
    ``INTERPOD`` counts whose term some pod kind carries.  ``marks``, when
    given, receives each mark's bindings per node (least, median, most) and
    the nodes passed over."""
    c = cluster
    n = len(c.alloc_cpu)
    used_cpu = np.zeros(n, dtype=np.int64)
    used_mem = np.zeros(n, dtype=np.int64)
    got = np.zeros(n, dtype=np.int64)  # bindings per node since the last mark
    where: dict[str, int] = {}  # existing pod -> node row, -1 while pending
    required = c.required()
    applies = [name for name, kind in INTERPOD.items() if kind in required]
    inter = InterPod(c) if applies else None
    out = dict.fromkeys((*NUMBERS, *applies), 0)
    cpu = [k.cpu for k in c.kinds]
    mem = [k.mem for k in c.kinds]
    shapes = sorted({(k.cpu, k.mem) for k in c.kinds})  # room for any of them is room for the smallest

    burst: list[tuple[int, int]] = []  # (row, kind) of the bindings since the last other event

    def place(kind: int, row: int, sign: int) -> None:
        used_cpu[row] += sign * cpu[kind]
        used_mem[row] += sign * mem[kind]
        if inter is not None:
            inter.place(row, kind, sign)

    def settle() -> None:
        for broken in inter.settle(burst):
            for name, hit in zip(INTERPOD, broken):
                if name in out:
                    out[name] += hit
        burst.clear()

    for op, pod, node, _t in log:
        if burst and op != "B":
            settle()
        if op == "M":
            if got.any():
                room = np.zeros(n, dtype=bool)
                for pc, pm in shapes:
                    room |= (used_cpu + pc <= c.alloc_cpu) & (used_mem + pm <= c.alloc_mem)
                passed = int(((got == 0) & room).sum())
                out["passed_over_pct"] = max(out["passed_over_pct"], 100.0 * passed / n)
                if marks is not None:
                    marks.append((int(got.min()), float(np.median(got)), int(got.max()), passed))
                got[:] = 0
            continue
        if op == "C":
            where[pod] = -1
            if node is not None:
                where[pod] = c.node_index[node]
                place(c.kind(pod), where[pod], +1)
            continue
        if op == "D":
            row = where.pop(pod, None)
            if row is not None and row >= 0:
                place(c.kind(pod), row, -1)
            continue
        # op == "B": a binding the server accepted.
        row = c.node_index.get(node)
        if where.get(pod, 0) != -1 or row is None:
            out["bad_binds"] += 1
            continue
        kind = c.kind(pod)
        if used_cpu[row] + cpu[kind] > c.alloc_cpu[row] or used_mem[row] + mem[kind] > c.alloc_mem[row]:
            out["overcommitted_binds"] += 1
        where[pod] = row
        got[row] += 1
        used_cpu[row] += cpu[kind]
        used_mem[row] += mem[kind]
        if inter is not None:
            burst.append((row, kind))
    if burst:
        settle()
    out["unbound_pods"] = sum(1 for row in where.values() if row < 0)
    return out
