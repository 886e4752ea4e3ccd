"""Shared retry/backoff + circuit-breaker policy for control-plane dials
(port of ``koordinator_tpu/transport/retry.py``).

One error-pacing policy for every component that re-dials a peer
(``cmd.binaries.ReconnectingSidecarClient`` for the koordlet's reporters
and the manager's colocation loop; any embedder wiring a
``StateSyncClient`` resync loop) — before this existed, a dead sidecar
was re-dialed with zero backoff every tick, so a 10k-node cluster's
agents would synchronously hammer a restarting scheduler.

- :class:`RetryPolicy` is the schedule: exponential backoff with
  jitter and an optional max-elapsed budget.  Frozen dataclass — share
  one instance freely.
- :class:`RetrySchedule` is one retry *session* over a policy
  (attempt counter + elapsed budget).
- :class:`CircuitBreaker` is the dial gate: CLOSED passes everything;
  a failure (threshold 1 by default — a refused dial is already a
  strong signal) OPENs it for one backoff window; the first caller
  after the window gets the HALF_OPEN probe; probe success re-CLOSEs,
  probe failure re-OPENs with the next (longer) window.  Over a
  T-second outage that is O(log T) dials until the backoff cap, then
  one dial per ``max_backoff_s`` — not one per tick.

State is observable via ``koord_transport_circuit_breaker_state``
(0=closed, 1=half-open, 2=open; label ``target``) and
``koord_transport_circuit_breaker_transitions_total``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule with jitter.

    ``jitter``: "full" draws uniform(0, raw) (AWS full-jitter — best
    for herd spread, can yield near-zero waits), "equal" draws
    uniform(raw/2, raw) (never degenerate — the breaker default),
    "none" is deterministic (tests)."""

    initial_backoff_s: float = 0.2
    max_backoff_s: float = 30.0
    multiplier: float = 2.0
    jitter: str = "equal"
    #: total budget for one RetrySchedule; None = unbounded
    max_elapsed_s: Optional[float] = None

    def backoff(self, attempt: int,
                rng: random.Random | None = None) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        raw = self.initial_backoff_s * (self.multiplier ** attempt)
        raw = min(raw, self.max_backoff_s)
        if self.jitter == "none" or rng is None:
            return raw
        if self.jitter == "full":
            return rng.uniform(0.0, raw)
        return rng.uniform(raw / 2.0, raw)


class RetrySchedule:
    """One retry session: next_delay() until None (budget exhausted)."""

    def __init__(self, policy: RetryPolicy,
                 rng: random.Random | None = None, clock=time.monotonic):
        self.policy = policy
        self.rng = rng if rng is not None else random.Random()
        self.clock = clock
        self.attempts = 0
        self._started = clock()

    def elapsed(self) -> float:
        return self.clock() - self._started

    def next_delay(self) -> Optional[float]:
        """Delay to sleep before the next attempt, or None when the
        max-elapsed budget is spent (fail for real)."""
        delay = self.policy.backoff(self.attempts, self.rng)
        self.attempts += 1
        budget = self.policy.max_elapsed_s
        if budget is not None and self.elapsed() + delay > budget:
            return None
        return delay


class CircuitBreaker:
    """Dial gate with backoff-driven open windows.

    Usage (single caller or under the owner's lock):

        if not breaker.allow():
            raise RpcError(f"circuit open: {breaker.describe()}")
        try:
            dial()
        except OSError:
            breaker.record_failure()
            raise
        breaker.record_success()
    """

    def __init__(self, target: str = "", policy: RetryPolicy | None = None,
                 failure_threshold: int = 1, clock=time.monotonic,
                 rng: random.Random | None = None):
        self.target = target
        self.policy = policy or RetryPolicy()
        self.failure_threshold = max(1, failure_threshold)
        self.clock = clock
        self.rng = rng if rng is not None else random.Random()
        self.state = CLOSED
        self.opens = 0            # consecutive open windows (backoff input)
        self.open_total = 0       # lifetime opens (observability)
        self._consecutive = 0
        self._open_until = 0.0
        self._lock = threading.Lock()
        self._publish()

    def _publish(self) -> None:
        from koordinator_tpu_torch import metrics

        metrics.breaker_state.set(_STATE_CODE[self.state],
                                  labels={"target": self.target})

    def _transition(self, state: str) -> None:
        from koordinator_tpu_torch import metrics

        if state == self.state:
            return
        self.state = state
        metrics.breaker_transitions_total.inc(
            labels={"target": self.target, "to": state})
        self._publish()

    def allow(self) -> bool:
        """May the caller dial now?  Transitions OPEN -> HALF_OPEN when
        the window has elapsed (the caller is the probe)."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN and self.clock() >= self._open_until:
                self._transition(HALF_OPEN)
                return True
            # OPEN within the window, or HALF_OPEN with a probe already
            # in flight: wait
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self.opens = 0
            self._transition(CLOSED)

    def reset(self) -> None:
        """Force-close, zeroing the backoff history.  The heal seam: a
        drill's ``FaultInjector.heal()`` resets registered breakers so
        callers probe the healed peer immediately instead of waiting out
        the remaining open window (which chaos backoff growth can have
        pushed far past the heal)."""
        with self._lock:
            self._consecutive = 0
            self.opens = 0
            self._open_until = 0.0
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if (self.state == HALF_OPEN
                    or self._consecutive >= self.failure_threshold):
                window = self.policy.backoff(self.opens, self.rng)
                self._open_until = self.clock() + window
                self.opens += 1
                self.open_total += 1
                self._transition(OPEN)

    def retry_in(self) -> float:
        """Seconds until the next probe is allowed (0 when dialable)."""
        with self._lock:
            if self.state == OPEN:
                return max(0.0, self._open_until - self.clock())
            return 0.0

    def describe(self) -> str:
        return (f"{self.state}, retry in {self.retry_in():.2f}s, "
                f"{self.open_total} opens")
