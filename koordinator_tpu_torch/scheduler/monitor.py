"""Scheduler monitor: per-round phase timing with slow-phase logging (port
of ``koordinator_tpu/scheduler/monitor.py``).

Equivalent of ``frameworkext/scheduler_monitor.go:44-100`` — records how long
each scheduling phase takes, keeps a rolling history, and flags phases that
exceed the configured timeout.  ``start_round()``/``round_timings`` expose
the CURRENT round's per-phase wall times.

Left out until the port has its observability copies: the JAX monitor's
hooks into ``metrics`` (the ``scheduling_duration_seconds`` histogram and
its trace-id exemplar), ``timeline`` (a phase segment) and ``tracing`` (a
span a phase under the round span).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict, deque

logger = logging.getLogger("koordinator_tpu_torch.scheduler")


class SchedulerMonitor:
    def __init__(self, timeout_sec: float = 1.0, history: int = 256,
                 clock=time.perf_counter):
        self.timeout_sec = timeout_sec
        self.clock = clock
        self.phase_history: dict[str, deque[float]] = defaultdict(
            lambda: deque(maxlen=history))
        self.slow_rounds = 0
        #: per-phase wall times of the round in flight (reset by
        #: start_round)
        self.round_timings: dict[str, float] = {}
        #: tenancy identity: kept for the JAX monitor's interface; it
        #: labels the metrics the port does not have yet
        self.tenant = ""

    def start_round(self) -> None:
        """Reset the per-round phase accumulator (called by the scheduler
        at round start)."""
        self.round_timings = {}

    @contextlib.contextmanager
    def phase(self, name: str, carry_s: float = 0.0):
        """Time one phase; ``carry_s`` folds wall time measured outside
        this context into the phase's one observation."""
        start = self.clock()
        try:
            yield
        finally:
            elapsed = self.clock() - start + carry_s
            self.phase_history[name].append(elapsed)
            self.round_timings[name] = (
                self.round_timings.get(name, 0.0) + elapsed)
            if elapsed > self.timeout_sec:
                self.slow_rounds += 1
                logger.warning(
                    "scheduling phase %s took %.3fs (timeout %.3fs)",
                    name, elapsed, self.timeout_sec)

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, hist in self.phase_history.items():
            if not hist:
                continue
            s = sorted(hist)
            out[name] = {
                "count": float(len(s)),
                "mean": sum(s) / len(s),
                "p50": s[len(s) // 2],
                "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                "max": s[-1],
            }
        return out
