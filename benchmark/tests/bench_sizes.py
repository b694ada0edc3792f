"""The cell at a size a test run holds on the CPU: the same loop, files and
comparison as on the card, with fewer nodes and pods in the same ratio."""

from benchmark.spec import Cell, load_spec

SMALL = {"nodes": 120, "bound_at_start": 1200, "wave": 2400, "grace_s": 4.0}


def small_run(workload: str = "basic-5k.backlog", seed: int = 7, seconds: float = 1.0, **kw):
    from benchmark import harness

    cell = Cell(load_spec(), workload)
    return harness.run(cell, seed, seconds, kw.pop("trace", False), device=kw.pop("device", "cpu"),
                       scale=dict(SMALL), **kw)
