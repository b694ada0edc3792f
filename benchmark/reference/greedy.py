"""A plain sequential scheduler over the same inputs: the control.

It follows the API server's log (the same events ``check.replay`` reads),
and places each pending pod in creation order on the node that passes its
filters with the highest MostAllocated score (kube's bin-packing strategy;
the first node on ties).  Its filters are the guarantees ``GUARANTEES``
names: ``fit`` (the node's allocatable CPU and memory) and ``affinity``
(every required inter-pod term, ``check.InterPod``).  ``breaks`` leaves one
of them out: that is the control the benchmark's comparison has to fail.
With every filter on it keeps every guarantee and packs, which the spread
of the placement has to catch.
"""

from __future__ import annotations

import numpy as np

from .check import Cluster, InterPod

__all__ = ["GUARANTEES", "GreedyScheduler"]

GUARANTEES = ("fit", "affinity")


class GreedyScheduler:
    def __init__(self, cluster: Cluster, breaks: str | None = None):
        if breaks is not None and breaks not in GUARANTEES:
            raise ValueError(f"unknown guarantee {breaks!r}")
        self.c = cluster
        self.breaks = breaks
        n = len(cluster.alloc_cpu)
        self.used_cpu = np.zeros(n, dtype=np.int64)
        self.used_mem = np.zeros(n, dtype=np.int64)
        self.inter = InterPod(cluster) if cluster.required() else None
        self.where: dict[str, int] = {}
        self.pending: dict[str, None] = {}  # creation order
        self.seen = 0

    def _apply(self, pod: str, row: int, sign: int) -> None:
        kind = self.c.kind(pod)
        self.used_cpu[row] += sign * self.c.kinds[kind].cpu
        self.used_mem[row] += sign * self.c.kinds[kind].mem
        if self.inter is not None:
            self.inter.place(row, kind, sign)

    def follow(self, log) -> None:
        """Fold the log's events after the last call into the state."""
        for op, pod, node, _t in log[self.seen:]:
            if op == "C":
                if node is None:
                    self.where[pod] = -1
                    self.pending[pod] = None
                else:
                    self.where[pod] = self.c.node_index[node]
                    self._apply(pod, self.where[pod], +1)
            elif op == "D":
                row = self.where.pop(pod, None)
                self.pending.pop(pod, None)
                if row is not None and row >= 0:
                    self._apply(pod, row, -1)
            elif op == "B" and self.where.get(pod) == -1:
                self.where[pod] = self.c.node_index[node]
                self.pending.pop(pod, None)
                self._apply(pod, self.where[pod], +1)
        self.seen = len(log)

    def choose(self, kind: int) -> int:
        """The node row for the next pod, of ``kind``, or -1 when no node
        passes its filters."""
        c, k = self.c, self.c.kinds[kind]
        cpu, mem = self.used_cpu + k.cpu, self.used_mem + k.mem
        score = cpu / c.alloc_cpu + mem / c.alloc_mem
        ok = np.ones(len(score), dtype=bool)
        if self.breaks != "fit":
            ok &= (cpu <= c.alloc_cpu) & (mem <= c.alloc_mem)
        if self.inter is not None and self.breaks != "affinity":
            ok &= self.inter.allowed(kind)
        if not ok.any():
            return -1
        return int(np.argmax(np.where(ok, score, -np.inf)))

    def cycle(self, log) -> list[tuple[str, int]]:
        """Place every pending pod in creation order: [(pod, node row)].  A
        pod that no node passes waits for the next cycle, and so does every
        later pod of its kind."""
        self.follow(log)
        out = []
        stuck: set[int] = set()
        for pod in list(self.pending):
            kind = self.c.kind(pod)
            if kind in stuck:
                continue
            row = self.choose(kind)
            if row < 0:
                stuck.add(kind)
                continue
            out.append((pod, row))
            self.pending.pop(pod)
            self.where[pod] = row
            self._apply(pod, row, +1)
        return out
