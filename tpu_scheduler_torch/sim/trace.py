"""Trace record/replay — the simulator's persistence layer.

A trace is one JSONL file carrying everything a run consumed that was not
pure computation:

  ``header``  — scenario name, seed, backend, schema version
  ``action``  — every RESOLVED cluster op the harness applied, with its
                virtual timestamp (pod creations with full specs, node
                add/remove/cordon, completions, flap returns).  This is the
                persisted WatchEvent stream: applying the ops reproduces the
                exact ADDED/MODIFIED/DELETED sequence the reflectors saw.
  ``chaos``   — the chaos layer's decision schedule, in call order
                (sim/chaos.py replays it verbatim instead of re-drawing).
  ``cycle``   — one line per scheduler cycle (virtual time, bound count) —
                the cross-link into the flight recorder's cycle ring.
  ``footer``  — the run's determinism fingerprint and scorecard, so a
                replay can verify bit-identity without a second artifact.

Replaying feeds the recorded actions and chaos decisions back through the
same harness; with the clock, workload, and faults all reproduced, the
scheduler's binding sequence — and therefore the fingerprint — must match
bit-for-bit.

Port: a copy of ``tpu_scheduler/sim/trace.py``, unchanged: the format is
the same, so a trace recorded by either package replays through the
other.  The header's ``backend`` is the port backend's ``name``
(``"cuda"``, on the card or on the CPU).
"""

from __future__ import annotations

import json

__all__ = ["TraceWriter", "load_trace", "TRACE_VERSION"]

TRACE_VERSION = 1


class TraceWriter:
    """Streaming JSONL writer (one object per line, written in run order)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def header(self, scenario: str, seed: int, backend: str) -> None:
        self._line({"type": "header", "version": TRACE_VERSION, "scenario": scenario, "seed": seed, "backend": backend})

    def action(self, t: float, op: dict) -> None:
        # Exact float, NOT rounded: replay gates ops on ``t <= clock.now``
        # against the bit-identical replayed clock, and rounding up past the
        # true boundary would defer the op a whole cycle (JSON round-trips
        # Python floats losslessly, so exactness costs nothing).
        self._line({"type": "action", "t": t, "op": op})

    def chaos(self, endpoint: str, injected: bool, latency: float) -> None:
        self._line({"type": "chaos", "ep": endpoint, "inject": injected, "lat": latency})

    def cycle(self, t: float, cycle: int, bound: int, pending: int) -> None:
        self._line({"type": "cycle", "t": t, "cycle": cycle, "bound": bound, "pending": pending})

    def footer(self, fingerprint: str, scorecard: dict) -> None:
        self._line({"type": "footer", "fingerprint": fingerprint, "scorecard": scorecard})

    def _line(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")

    def close(self) -> None:
        self._f.close()


def load_trace(path: str) -> dict:
    """Parse a trace into {header, actions, chaos, footer}.

    ``actions`` is ``[(t, op), ...]`` in recorded order; ``chaos`` is the
    decision list shaped for ``ChaosApiServer(replay_decisions=...)``."""
    header = footer = None
    actions: list[tuple[float, dict]] = []
    chaos: list[tuple[str, bool, float]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.get("type")
            if kind == "header":
                if obj.get("version") != TRACE_VERSION:
                    raise ValueError(f"{path}:{lineno}: unsupported trace version {obj.get('version')}")
                header = obj
            elif kind == "action":
                actions.append((float(obj["t"]), obj["op"]))
            elif kind == "chaos":
                chaos.append((obj["ep"], bool(obj["inject"]), float(obj.get("lat", 0.0))))
            elif kind == "footer":
                footer = obj
            # "cycle" lines are observability breadcrumbs, not replay input.
    if header is None:
        raise ValueError(f"{path}: not a sim trace (no header line)")
    return {"header": header, "actions": actions, "chaos": chaos, "footer": footer}
