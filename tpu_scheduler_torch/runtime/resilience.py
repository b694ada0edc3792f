"""Failure-class-aware backoff + API-brownout circuit breaker.

The reference survives faults with exactly two blunt tools — drop-and-
reconnect watches (``src/main.rs:133-139``) and a fixed-delay per-pod
requeue (``main.rs:122-125``) — so every failure, from a transient bind 500
to a permanently unsatisfiable node selector, used to retry on the same
flat ``requeue_seconds`` timer, and during an API brownout each pod's bind
failed individually with no notion that the *server* was the problem.
This module is the production-scheduler answer (kube-scheduler's backoff
queue; Borg-style admission control, PAPERS.md):

  • :class:`BackoffQueue` — per-pod exponential backoff with per-failure-
    class policies keyed on the controller's ``_requeue_reason_class``
    taxonomy.  Transient server trouble (``api-error`` / ``network-error``
    / ``binding-failed``) retries fast-then-slow; ``no-node`` (nothing to
    retry against until the cluster changes) backs off long.  Jitter draws
    from an INJECTED rng (the scheduler's — one seed reproduces a whole
    run, the simulator's determinism contract), and the first attempt of a
    class is jitter-free so restart tests can pin exact deadlines.
  • :class:`CircuitBreaker` — a closed→open→half-open state machine fed by
    bind/list/watch outcomes.  A rolling-window failure ratio trips it
    open; the open window escalates exponentially while probes keep
    failing; half-open admits a bounded number of trial binds and closes
    after consecutive probe successes.  While open the controller switches
    to DEGRADED MODE: keep snapshotting and computing placements, defer
    the binding POSTs into a bounded flush buffer, and flush on recovery —
    a brownout costs latency, never lost or double-bound pods.

Everything here is main-thread state by design: the controller calls in
from its cycle loop (the pipelined bind worker's outcomes are folded on
the main thread at drain, runtime/controller.py), so no locks are needed
and none are taken.  Clocks are injected (``time.monotonic`` by default,
``VirtualClock`` in sim runs) — this module never reads wall time itself.

Port: a copy of ``tpu_scheduler/runtime/resilience.py`` (pure host code), with
``CircuitBreaker.record_successes``, a run of successes folded at once.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

__all__ = [
    "BackoffPolicy",
    "BackoffQueue",
    "BreakerConfig",
    "CircuitBreaker",
    "DEFAULT_POLICIES",
    "STATES",
    "open_intervals",
]


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential-backoff shape for one failure class.  All delays scale on
    the scheduler's ``requeue_seconds`` base (so ``requeue_seconds=0`` —
    the tests' retry-immediately mode — zeroes every class uniformly):
    attempt ``k`` waits ``min(base·max_frac, base·initial_frac·factor^(k-1))``
    with full jitter in [d/2, d] from attempt 2 on (attempt 1 is exact, so
    a single failure keeps the reference's deterministic flat-delay shape).
    """

    initial_frac: float  # first-attempt delay as a fraction of the base
    max_frac: float  # delay cap as a fraction of the base
    factor: float = 2.0  # per-attempt growth


# The failure-class taxonomy mirrors Scheduler._requeue_reason_class — the
# same labels the ``scheduler_requeues_by_reason_total`` metric slices on.
# Server-side trouble retries fast (the server usually heals in seconds);
# "no-node" means the CLUSTER must change before a retry can succeed, so it
# starts at the full base delay and backs off long.
DEFAULT_POLICIES: dict[str, BackoffPolicy] = {
    "api-error": BackoffPolicy(initial_frac=0.125, max_frac=2.0),
    "network-error": BackoffPolicy(initial_frac=0.125, max_frac=2.0),
    "binding-failed": BackoffPolicy(initial_frac=0.125, max_frac=2.0),
    "no-node": BackoffPolicy(initial_frac=1.0, max_frac=4.0),
    "gang": BackoffPolicy(initial_frac=1.0, max_frac=4.0),
    "other": BackoffPolicy(initial_frac=1.0, max_frac=2.0),
}


class BackoffQueue(dict):
    """Per-pod retry deadlines with per-class exponential backoff.

    A ``dict`` subclass mapping pod full name -> retry deadline (the
    scheduler-clock instant the pod becomes eligible again), so every
    existing consumer of the old flat ``requeue_at`` dict — the checkpoint
    (``items()``), the gang deadline alignment (``[]``), tests (``in``,
    ``== {}``) — keeps working unchanged.  The class/attempt bookkeeping
    rides in a side table that ``pop``/``del`` clear, so a successful bind
    (or a delete-event prune) resets the pod's escalation.
    """

    def __init__(
        self,
        base_seconds: float = 300.0,
        rng: random.Random | None = None,
        policies: dict[str, BackoffPolicy] | None = None,
    ):
        super().__init__()
        self.base = float(base_seconds)
        self._rng = rng or random.Random()
        self.policies = dict(DEFAULT_POLICIES)
        if policies:
            self.policies.update(policies)
        self._meta: dict[str, tuple[str, int]] = {}  # pod -> (class, attempts)

    # -- failure / eligibility ---------------------------------------------

    def fail(self, pod_full: str, cls: str, now: float) -> float:
        """Record one failure of ``cls``; returns the delay applied.  The
        attempt counter escalates within a class and resets when the class
        changes (a bind 500 after a string of no-node verdicts is fresh
        evidence, not escalation)."""
        prev_cls, attempts = self._meta.get(pod_full, (cls, 0))
        attempts = attempts + 1 if prev_cls == cls else 1
        self._meta[pod_full] = (cls, attempts)
        pol = self.policies.get(cls) or self.policies["other"]
        delay = min(self.base * pol.max_frac, self.base * pol.initial_frac * pol.factor ** (attempts - 1))
        if attempts > 1 and delay > 0:
            # Full jitter in [d/2, d] (the reflector's band) — decorrelates
            # retry storms; drawn from the injected rng so sim runs replay.
            delay *= 0.5 + 0.5 * self._rng.random()
        self[pod_full] = now + delay
        return delay

    def eligible(self, pod_full: str, now: float) -> bool:
        deadline = self.get(pod_full)
        return deadline is None or deadline <= now

    def attempts(self, pod_full: str) -> int:
        return self._meta.get(pod_full, ("", 0))[1]

    # -- mutation overrides: meta must never outlive the deadline ----------

    def pop(self, key, *default):
        self._meta.pop(key, None)
        return super().pop(key, *default)

    def __delitem__(self, key):
        self._meta.pop(key, None)
        super().__delitem__(key)

    def clear(self):
        self._meta.clear()
        super().clear()

    def prune_deleted(self, pod_fulls) -> int:
        """Evict entries for deleted pods (the watch DELETE stream) —
        closes the leak where a pod deleted mid-backoff kept its entry (and
        its escalation state) forever.  Returns how many were pruned."""
        n = 0
        for pf in pod_fulls:
            if super().__contains__(pf):
                self.pop(pf, None)
                n += 1
            else:
                self._meta.pop(pf, None)
        return n

    # -- checkpoint + debug surfaces ---------------------------------------

    def meta(self) -> dict[str, tuple[str, int]]:
        return dict(self._meta)

    def restore(self, deadlines: dict[str, float], meta: dict[str, tuple[str, int]] | None = None) -> None:
        """Adopt a checkpoint's deadlines (+ class/attempt state when the
        checkpoint carries it; v1 checkpoints restore attempts=0)."""
        self.clear()
        self.update(deadlines)
        for k, (cls, attempts) in (meta or {}).items():
            if super().__contains__(k):
                self._meta[k] = (str(cls), int(attempts))

    def debug(self, now: float) -> dict:
        by_class: dict[str, dict] = {}
        for pf, deadline in list(self.items()):  # GIL-atomic copy: read from the /debug thread
            cls, attempts = self._meta.get(pf, ("other", 1))
            agg = by_class.setdefault(cls, {"entries": 0, "max_attempts": 0, "next_retry_in_s": None})
            agg["entries"] += 1
            agg["max_attempts"] = max(agg["max_attempts"], attempts)
            wait = max(0.0, deadline - now)
            if agg["next_retry_in_s"] is None or wait < agg["next_retry_in_s"]:
                agg["next_retry_in_s"] = round(wait, 3)
        return {"entries": len(self), "base_seconds": self.base, "by_class": by_class}


# -- circuit breaker ----------------------------------------------------------

STATES = ("closed", "open", "half-open")


@dataclass(frozen=True)
class BreakerConfig:
    """Trip/recovery knobs (see the README Resilience catalogue)."""

    window: int = 20  # rolling outcome window size
    min_samples: int = 8  # outcomes needed before the ratio can trip
    failure_ratio: float = 0.5  # trip when failures/window >= this (>1 disables)
    open_seconds: float = 5.0  # first open window
    max_open_seconds: float = 60.0  # escalation cap while probes keep failing
    probe_budget: int = 2  # trial binds allowed per half-open cycle
    probe_successes: int = 2  # consecutive probe successes that close


# protocol: machine circuit-breaker field=state states=STATES init=closed
# protocol: closed -> open
# protocol: open -> half-open
# protocol: half-open -> closed | open
# protocol: var pending: 0..1 = 1
# protocol: var overlaid: 0..1 = 0
# protocol: var placed: 0..2 = 0
# protocol: action trip: closed -> open
# protocol: env timeout: open -> half-open
# protocol: action probe-fail: half-open -> open
# protocol: action probe-ok: half-open -> closed
# protocol: action bind: closed -> closed requires pending == 1 and overlaid == 0 effect pending = 0, placed += 1
# protocol: action defer: open -> open requires pending == 1 and overlaid == 0 effect overlaid = 1, placed += 1
# protocol: action flush: half-open -> half-open requires overlaid == 1 effect pending = 0, overlaid = 0
# protocol: action flush-closed: closed -> closed requires overlaid == 1 effect pending = 0, overlaid = 0
# protocol: invariant no-double-bind: placed <= 1
# protocol: invariant overlay-pending: overlaid == 1 implies pending == 1
# protocol: progress deferred-flushable: overlaid == 1
class CircuitBreaker:
    """Closed→open→half-open breaker over API-server health.

    The ``# protocol:`` contract above is the machine's source of truth:
    the PROT pass proves every state write/compare in this class stays
    inside it (the timed open→half-open promotion in ``mode()`` is a
    DECLARED env transition, not a checker special case), and the MODL
    pass composes it with one pod's bind/defer/flush lifecycle to prove
    the assumed-overlay can never double-place (``no-double-bind``) and a
    deferred pod can always still flush (``deferred-flushable``).

    Fed every bind POST outcome, pipelined-drain outcome, and watch
    sync verdict.  ``mode()`` is the controller's per-call gate: it also
    performs the timed open→half-open promotion, so callers never see a
    stale "open" after the window elapsed.  All timestamps come from the
    injected clock — virtual in sim runs, so transitions replay
    bit-identically.
    """

    def __init__(self, clock=time.monotonic, config: BreakerConfig | None = None, on_transition=None):
        self.clock = clock
        self.config = config or BreakerConfig()
        self.state = "closed"
        self._failures = 0  # failures currently in the window
        self._window: list[bool] = []  # ring of outcome-is-failure flags
        self._window_pos = 0
        self._open_until = 0.0
        self._open_streak = 0  # consecutive opens without a recovery
        self._probe_ok = 0
        self.opened_total = 0
        # (virtual/monotonic t, from-state, to-state), in order.
        self.transitions: list[tuple[float, str, str]] = []
        self._on_transition = on_transition

    # -- state -------------------------------------------------------------

    def mode(self) -> str:
        """Current state, promoting open→half-open once the window elapsed."""
        if self.state == "open" and self.clock() >= self._open_until:
            self._probe_ok = 0
            self._transition("half-open")
        return self.state

    def seconds_until_probe(self, now: float) -> float:
        """Time until an open breaker starts admitting probes (0 otherwise)."""
        return max(0.0, self._open_until - now) if self.state == "open" else 0.0

    def _transition(self, to: str) -> None:
        frm, self.state = self.state, to
        t = self.clock()
        self.transitions.append((t, frm, to))
        if self._on_transition is not None:
            self._on_transition(t, frm, to)

    def _push(self, failure: bool) -> None:
        if len(self._window) < self.config.window:
            self._window.append(failure)
            self._failures += int(failure)
            return
        old = self._window[self._window_pos]
        self._window[self._window_pos] = failure
        self._window_pos = (self._window_pos + 1) % self.config.window
        self._failures += int(failure) - int(old)

    def _reset_window(self) -> None:
        self._window = []
        self._window_pos = 0
        self._failures = 0

    # -- outcomes ----------------------------------------------------------

    def record(self, ok: bool, n: int = 1) -> None:
        """Fold ``n`` identical outcomes.  In closed state a bad rolling
        ratio trips open; in half-open a failure re-opens (escalated
        window) and ``probe_successes`` consecutive successes close; in
        open state outcomes are window-recorded but the timer rules."""
        for _ in range(max(1, n)):
            self._push(not ok)
        st = self.mode()
        if st == "closed":
            if (
                len(self._window) >= self.config.min_samples
                and self._failures / len(self._window) >= self.config.failure_ratio
            ):
                self._trip()
        elif st == "half-open":
            if not ok:
                self._trip()
            else:
                self._probe_ok += 1
                if self._probe_ok >= self.config.probe_successes:
                    self._open_streak = 0
                    self._reset_window()
                    self._transition("closed")

    def record_successes(self, n: int) -> None:
        """``record(True)`` ``n`` times over.  A closed breaker with no
        failure in its window cannot trip on a success, so it only moves
        the window, at once; any other breaker takes them one by one."""
        if self.state != "closed" or self._failures or self.config.failure_ratio <= 0:
            for _ in range(n):
                self.record(True)
            return
        window = self.config.window
        fill = min(n, window - len(self._window))
        self._window.extend([False] * fill)
        if n > fill:
            # The window is full of successes: each push replaces one.
            self._window_pos = (self._window_pos + n - fill) % window

    def _trip(self) -> None:
        self._open_streak += 1
        dur = min(self.config.max_open_seconds, self.config.open_seconds * 2.0 ** (self._open_streak - 1))
        self._open_until = self.clock() + dur
        self.opened_total += 1
        self._reset_window()
        self._transition("open")

    # -- reporting ---------------------------------------------------------

    def open_intervals(self, until: float) -> list[tuple[float, float]]:
        """[(start, end)] spans the breaker spent OPEN, closed at ``until``
        — the scorecard's binds-while-open check (half-open is not open:
        its trial binds are sanctioned)."""
        return open_intervals(self.transitions, until)

    def debug(self, now: float) -> dict:
        return {
            "state": self.mode(),
            "opened_total": self.opened_total,
            "open_for_s": round(max(0.0, self._open_until - now), 3) if self.state == "open" else 0.0,
            "window": {"size": len(self._window), "failures": self._failures},
            "config": self.config.__dict__,
            "transitions": [[round(t, 6), frm, to] for t, frm, to in self.transitions[-32:]],
        }


def open_intervals(transitions: list[tuple[float, str, str]], until: float) -> list[tuple[float, float]]:
    """Collapse a transition log into the [start, end) spans spent open."""
    out: list[tuple[float, float]] = []
    opened_at: float | None = None
    for t, _frm, to in transitions:
        if to == "open" and opened_at is None:
            opened_at = t
        elif to != "open" and opened_at is not None:
            out.append((opened_at, t))
            opened_at = None
    if opened_at is not None:
        out.append((opened_at, until))
    return out
