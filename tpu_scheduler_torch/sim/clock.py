"""Virtual time — the simulator's clock.

A ``VirtualClock`` is a drop-in replacement for ``time.monotonic`` at every
injectable-clock seam the runtime carries (``Scheduler(clock=...)``,
``FakeApiServer(clock=...)``, ``Reflector(clock=...)``): calling it returns
the current VIRTUAL time, and ``sleep``/``advance`` move that time forward
instantly instead of blocking — a simulated hour of watch backoff and
requeue waits costs microseconds of wall clock.

It is also a minimal discrete-event engine: callbacks scheduled with
``schedule``/``schedule_in`` fire IN TIMESTAMP ORDER while the clock
advances past them (ties break by scheduling order), with ``now`` set to
each callback's own due time while it runs — the invariant every
discrete-event simulation rests on.

Port: a copy of ``tpu_scheduler/sim/clock.py``, unchanged.
"""

from __future__ import annotations

import heapq

__all__ = ["VirtualClock"]


class VirtualClock:
    """Deterministic virtual time source + event queue (single-threaded)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: list[tuple[float, int, object]] = []
        self._seq = 0  # FIFO tie-break for equal timestamps

    # -- the time.monotonic surface ----------------------------------------

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        """``time.sleep`` twin: advance virtual time (firing due events)."""
        self.advance(seconds)

    # -- event scheduling ---------------------------------------------------

    def schedule(self, at: float, fn) -> None:
        """Run ``fn()`` when the clock advances to/past virtual time ``at``.
        An ``at`` in the past fires on the next advance (at current time)."""
        self._seq += 1
        heapq.heappush(self._heap, (max(at, self._now), self._seq, fn))

    def schedule_in(self, delay: float, fn) -> None:
        self.schedule(self._now + delay, fn)

    def next_event_at(self) -> float | None:
        """Due time of the earliest scheduled event (None when idle)."""
        return self._heap[0][0] if self._heap else None

    # -- advancing ----------------------------------------------------------

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot advance virtual time by {seconds}")
        self.advance_to(self._now + seconds)

    def advance_to(self, t: float) -> None:
        """Move time forward to ``t``, firing every event due on the way (in
        timestamp order, ``now`` pinned to each event's due time while its
        callback runs — callbacks may schedule further events, including
        ones due before ``t``)."""
        if t < self._now:
            raise ValueError(f"virtual time cannot move backwards ({t} < {self._now})")
        while self._heap and self._heap[0][0] <= t:
            at, _seq, fn = heapq.heappop(self._heap)
            self._now = at
            fn()
        self._now = t
