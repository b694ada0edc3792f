"""The control: the plain reference scheduler in the program's place, with one
guarantee the configuration states left unchecked (the configuration's
``control`` key names it: ``fit``, or ``affinity`` for every required
inter-pod term).  The benchmark's comparison must find it wrong.

    python3 -m benchmark.control --workload basic-5k.backlog --seeds 11 12 13 --seconds 10

runs the cell's traffic at its own size with the control as the system and
prints, a line per seed, the numbers the comparison reads beside their
limits.  ``--packer`` runs the reference scheduler with every guarantee
checked instead: it bin-packs, which the placement's spread has to catch.
The benchmark's own runs never run either.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

from .reference.check import Cluster
from .reference.greedy import GreedyScheduler

__all__ = ["ControlDriver", "main"]


@dataclass
class _Cycle:
    pending: int
    bound: int


class ControlDriver:
    """``run_cycle`` over the reference scheduler: it follows the API
    server's log, places the pending pods and posts their bindings."""

    def __init__(self, api, cluster: Cluster, breaks: str | None):
        from tpu_scheduler_torch.api.objects import ObjectReference

        self.api = api
        self.ref = ObjectReference
        self.names = {row: name for name, row in cluster.node_index.items()}
        self.greedy = GreedyScheduler(cluster, breaks=breaks)

    def run_cycle(self) -> _Cycle:
        placed = self.greedy.cycle(self.api.log_since(0))
        for pod, row in placed:
            self.api.create_binding("default", pod, self.ref(name=self.names[row]))
        return _Cycle(pending=len(placed) + len(self.greedy.pending), bound=len(placed))

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    from . import harness
    from .spec import Cell, load_spec

    p = argparse.ArgumentParser(prog="benchmark.control", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--packer", action="store_true", help="check every guarantee; only the policy differs")
    args = p.parse_args(argv)
    cell = Cell(load_spec(), args.workload)
    from .cluster import load_deployment

    breaks = "reference" if args.packer else load_deployment(cell.config_file).raw["control"]
    for seed in args.seeds:
        out = harness.run(cell, seed, args.seconds, trace=False, device="cpu", driver=breaks)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_breaks": breaks,
                          "correct": out["correct"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
