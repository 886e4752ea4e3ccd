"""Scheduler monitor: per-round phase timing with slow-phase logging (port
of ``koordinator_tpu/scheduler/monitor.py``).

Equivalent of ``frameworkext/scheduler_monitor.go:44-100`` — records how long
each scheduling phase takes, keeps a rolling history, and flags phases that
exceed the configured timeout.  ``start_round()``/``round_timings`` expose
the CURRENT round's per-phase wall times for the flight recorder.

Each phase is also a ``phase.<name>`` trace span (a child of the round span
the scheduler opens, only when a trace is active), a timeline segment
(timed on ``time.perf_counter``, its cause from ``timeline.PHASE_CAUSES``)
and an observation of the ``scheduling_duration_seconds`` histogram
(label ``phase``, and ``tenant`` when set) with the round's trace id as
its exemplar; Solve also feeds ``solver_batch_duration_seconds``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict, deque

from koordinator_tpu_torch import metrics, timeline, tracing

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
        #: start_round; the flight recorder snapshots it at round end)
        self.round_timings: dict[str, float] = {}
        #: tenancy identity: when set, every phase observation also
        #: carries a {tenant=...} label
        self.tenant = ""

    def start_round(self) -> None:
        """Reset the per-round phase accumulator (called by the scheduler
        at round start)."""
        self.round_timings = {}

    @contextlib.contextmanager
    def phase(self, name: str, carry_s: float = 0.0):
        """Time one phase; ``carry_s`` folds wall time measured outside
        this context into the phase's one observation."""
        # a phase span only under an active trace (the scheduler's round
        # span): standalone monitor users pay nothing
        ctx = tracing.current_context()
        span_cm = (tracing.TRACER.span(f"phase.{name}") if ctx is not None
                   else contextlib.nullcontext())
        # the timeline segment is timed on perf_counter, not self.clock
        # (which tests may fake): cycle windows clip by real monotonic time
        tl_start = (time.perf_counter() if timeline.RECORDER.enabled
                    else 0.0)
        start = self.clock()
        try:
            with span_cm:
                yield
        finally:
            if timeline.RECORDER.enabled:
                timeline.RECORDER.add(
                    tl_start, time.perf_counter(),
                    timeline.PHASE_CAUSES.get(name, "host_other"),
                    f"phase.{name}", self.tenant)
            elapsed = self.clock() - start + carry_s
            self.phase_history[name].append(elapsed)
            self.round_timings[name] = (
                self.round_timings.get(name, 0.0) + elapsed)
            # the exemplar links this observation to the round's trace
            exemplar = ({"trace_id": ctx.trace_id} if ctx is not None
                        else None)
            labels = {"phase": name}
            if self.tenant:
                labels["tenant"] = self.tenant
            metrics.scheduling_latency.observe(
                elapsed, labels=labels, exemplar=exemplar)
            if name == "Solve":
                metrics.solver_batch_latency.observe(
                    elapsed, exemplar=exemplar)
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
