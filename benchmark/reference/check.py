"""The plain reference: Kubernetes' scheduling guarantees and the profile's
spread, replayed over the API server's log.

It imports nothing of the program and takes nothing the program made: it is
handed the benchmark's own description of the nodes and pods (allocatable
CPU and memory, the pod's requests, as plain numbers) and the log of
creates, deletes and accepted bindings in the order the API server applied
them, and it works out the cluster's state again, event by event.

A scheduler's answer is a binding, and many placements are valid, so each
binding is judged by what it says, against the state the API server held
when it accepted it:

* ``bad_binds``: a binding for a pod that did not exist, was already bound,
  or names no node of the cluster.
* ``overcommitted_binds``: the node's bound requests plus this pod's exceed
  its allocatable CPU or memory.
* ``unbound_pods``: pods created and never bound by the end of the log.

Each of these is an exact count: its limit is 0.  The placement is judged
too, at each quiescent mark (every pod of a batch bound):

* ``passed_over_pct``: the nodes that received none of the batch's
  bindings though they still have room for a pod at the mark, as a share
  of the cluster's nodes, %, the most at any mark.  The default profile's LeastRequested and BalancedAllocation
  scores rank an emptier node higher, so a batch that averages many pods a
  node reaches every node with room; a bin-packing policy (MostAllocated,
  or the first node that fits) fills some nodes and passes the rest over.
  Its limit is set from readings (``PASSED_OVER_LIMIT``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Cluster", "replay", "NUMBERS", "LIMITS"]

NUMBERS = (
    "bad_binds",
    "overcommitted_binds",
    "unbound_pods",
    "passed_over_pct",
)
# The largest share of the nodes one batch may pass over, %: between the
# program's readings and a bin-packing scheduler's (PERF.md, section 2).
PASSED_OVER_LIMIT = 20.0
LIMITS = {"bad_binds": 0, "overcommitted_binds": 0, "unbound_pods": 0, "passed_over_pct": PASSED_OVER_LIMIT}


class Cluster:
    """The inputs both sides were handed, as plain numbers.

    ``node_index``: node name -> row; ``alloc_cpu``/``alloc_mem`` [N]
    (millicores, bytes); ``pod_cpu``/``pod_mem``: every pod's requests."""

    def __init__(self, node_index, alloc_cpu, alloc_mem, pod_cpu: int, pod_mem: int):
        self.node_index = node_index
        self.alloc_cpu = np.asarray(alloc_cpu, dtype=np.int64)
        self.alloc_mem = np.asarray(alloc_mem, dtype=np.int64)
        self.pod_cpu = int(pod_cpu)
        self.pod_mem = int(pod_mem)


def replay(cluster: Cluster, log, marks: list | None = None) -> dict:
    """Replay ``log`` ((op, pod, node, t) tuples) and count each way a
    binding broke a guarantee or the placement passed nodes over; see the
    module docstring.  ``marks``, when given, receives each mark's
    bindings per node (least, median, most) and the nodes passed over."""
    c = cluster
    n = len(c.alloc_cpu)
    used_cpu = np.zeros(n, dtype=np.int64)
    used_mem = np.zeros(n, dtype=np.int64)
    got = np.zeros(n, dtype=np.int64)  # bindings per node since the last mark
    where: dict[str, int] = {}  # existing pod -> node row, -1 while pending
    out = dict.fromkeys(NUMBERS, 0)

    def place(row: int, sign: int) -> None:
        used_cpu[row] += sign * c.pod_cpu
        used_mem[row] += sign * c.pod_mem

    for op, pod, node, _t in log:
        if op == "M":
            if got.any():
                room = (used_cpu + c.pod_cpu <= c.alloc_cpu) & (used_mem + c.pod_mem <= c.alloc_mem)
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
                place(where[pod], +1)
            continue
        if op == "D":
            row = where.pop(pod, None)
            if row is not None and row >= 0:
                place(row, -1)
            continue
        # op == "B": a binding the server accepted.
        row = c.node_index.get(node)
        if where.get(pod, 0) != -1 or row is None:
            out["bad_binds"] += 1
            continue
        if used_cpu[row] + c.pod_cpu > c.alloc_cpu[row] or used_mem[row] + c.pod_mem > c.alloc_mem[row]:
            out["overcommitted_binds"] += 1
        where[pod] = row
        got[row] += 1
        place(row, +1)
    out["unbound_pods"] = sum(1 for row in where.values() if row < 0)
    return out
