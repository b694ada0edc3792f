"""A plain sequential scheduler over the same inputs: the control.

It follows the API server's log (the same events ``check.replay`` reads),
and places each pending pod in creation order on the node that fits it with
the highest MostAllocated score (kube's bin-packing strategy; the first
node on ties).  ``breaks="fit"`` leaves the fit filter out: that is the
control the benchmark's comparison has to fail.  With the filter on it keeps
every guarantee and packs, which the spread of the placement has to catch.
"""

from __future__ import annotations

import numpy as np

from .check import Cluster

__all__ = ["GUARANTEES", "GreedyScheduler"]

GUARANTEES = ("fit",)


class GreedyScheduler:
    def __init__(self, cluster: Cluster, breaks: str | None = None):
        if breaks is not None and breaks not in GUARANTEES:
            raise ValueError(f"unknown guarantee {breaks!r}")
        self.c = cluster
        self.breaks = breaks
        n = len(cluster.alloc_cpu)
        self.used_cpu = np.zeros(n, dtype=np.int64)
        self.used_mem = np.zeros(n, dtype=np.int64)
        self.where: dict[str, int] = {}
        self.pending: dict[str, None] = {}  # creation order
        self.seen = 0

    def _apply(self, row: int, sign: int) -> None:
        self.used_cpu[row] += sign * self.c.pod_cpu
        self.used_mem[row] += sign * self.c.pod_mem

    def follow(self, log) -> None:
        """Fold the log's events after the last call into the state."""
        for op, pod, node, _t in log[self.seen:]:
            if op == "C":
                if node is None:
                    self.where[pod] = -1
                    self.pending[pod] = None
                else:
                    self.where[pod] = self.c.node_index[node]
                    self._apply(self.where[pod], +1)
            elif op == "D":
                row = self.where.pop(pod, None)
                self.pending.pop(pod, None)
                if row is not None and row >= 0:
                    self._apply(row, -1)
            elif op == "B" and self.where.get(pod) == -1:
                self.where[pod] = self.c.node_index[node]
                self.pending.pop(pod, None)
                self._apply(self.where[pod], +1)
        self.seen = len(log)

    def choose(self) -> int:
        """The node row for the next pod, or -1 when no node fits it."""
        c = self.c
        cpu, mem = self.used_cpu + c.pod_cpu, self.used_mem + c.pod_mem
        score = cpu / c.alloc_cpu + mem / c.alloc_mem
        if self.breaks != "fit":
            ok = (cpu <= c.alloc_cpu) & (mem <= c.alloc_mem)
            if not ok.any():
                return -1
            score = np.where(ok, score, -np.inf)
        return int(np.argmax(score))

    def cycle(self, log) -> list[tuple[str, int]]:
        """Place every pending pod in creation order: [(pod, node row)]."""
        self.follow(log)
        out = []
        for pod in list(self.pending):
            row = self.choose()
            if row < 0:
                break
            out.append((pod, row))
            self.pending.pop(pod)
            self.where[pod] = row
            self._apply(row, +1)
        return out
