"""Per-cycle timeline reconstruction + host-wait attribution (port of
``koordinator_tpu/timeline.py``).

The host/wire plane is the speed ceiling, and the
only signal so far was one scalar — ``pipeline_host_wait_fraction``,
the share of a cycle's wall the host spent blocked on device solve
results.  This module is the measurement plane underneath it: every
hot spot on the host path records a typed **segment** (two
``perf_counter`` reads + one deque append), and at the end of each
TenantScheduler cycle (or standalone round) the recorder reconstructs
a gantt of the window, attributes every instant of wall time to a
cause, derives device-idle intervals from the dispatch/block edges,
and names the cycle's **critical path**.

Segment causes (also the attribution priority, highest first — at any
instant the most specific active segment wins):

====================  =====================================================
``device_block``      host blocked on a solve result (the port's blocking
                      copy of the assignments to the host) — by
                      construction this bucket equals
                      ``pipeline_host_wait_fraction`` (same intervals the
                      ``_solve_device_s`` accumulator sums)
``lock_wait``         waiting to acquire a scheduler round lock
``json_codec``        wire payload encode/decode (``transport/wire.py``)
``deltasync_apply``   a sync event batch applying onto a binding
``dispatch``          host-side solve dispatch work (``_round_dispatch``)
``build_batch``       the BatchBuild phase (``_build_batch``)
``bind_commit``       the Bind phase (``_commit_bind`` loop)
``host_other``        any other monitor phase (Reservations, Solve's
                      host share, Reserve, Diagnose, PostFilter, ...)
====================  =====================================================

Wall time covered by NO segment lands in the explicit ``unattributed``
residual — the phase-accounting invariant test asserts it stays under
5% of the cycle, so silently untimed host work can never reappear.

``device_busy`` segments are NOT host work: they mark the device
executing between a dispatch edge and its block edge, and only feed
the ``device_idle_fraction`` derivation.

**Attribution semantics.** ``host_wait_attribution{cause}`` decomposes
the WHOLE cycle wall into fractions that sum to 1.0 (including
``unattributed``).  The ``device_block`` bucket equals
``pipeline_host_wait_fraction`` (same clock, same intervals); the
remaining causes decompose its complement — the host share the
host-side speed work has to shrink.

**Kill switch.**  ``KOORD_TIMELINE=0`` in the environment (read once at
import) or ``--no-timeline`` on the scheduler binary disables the
recorder: every hook degrades to one attribute read, no segment is
stored, and scheduling decisions are bit-identical (the instrumentation
is pure host-side timing — it never touches solve inputs either way).

Everything here is stdlib-only and thread-safe: segments arrive from
the cycle thread, RPC reader threads (deltasync applies, wire codec),
and gateway threads concurrently.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

#: attribution priority, most specific first (see the module docstring)
CAUSES = ("device_block", "lock_wait", "json_codec", "deltasync_apply",
          "dispatch", "build_batch", "bind_commit", "host_other")
#: the residual bucket: wall time no segment covered
UNATTRIBUTED = "unattributed"
#: every label the host_wait_attribution family republishes per cycle
ATTRIBUTION_CAUSES = CAUSES + (UNATTRIBUTED,)
#: device-occupancy marker (feeds device_idle_fraction, not attribution)
DEVICE_BUSY = "device_busy"

_PRIORITY = {cause: i for i, cause in enumerate(CAUSES)}

#: monitor phase name -> attribution cause (anything unlisted is
#: host_other; the phase name survives on the segment for the gantt)
PHASE_CAUSES = {"BatchBuild": "build_batch", "Bind": "bind_commit"}


def _merge_intervals(intervals: list[tuple[float, float]]
                     ) -> list[tuple[float, float]]:
    """Union of [start, end) intervals, sorted and coalesced."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def sweep_attribution(segments: list[dict], t0: float, t1: float
                      ) -> tuple[dict, list[dict]]:
    """Attribute every instant of [t0, t1] to exactly one cause.

    An event sweep over the segment boundaries: at each instant the
    highest-priority active segment's cause wins (nesting puts the
    specific segment — a block wait inside the Solve phase, a codec
    call inside a deltasync apply — above its container).  Returns
    ``(seconds_by_cause, chain)`` where the chain is the covering
    sequence of maximal same-cause intervals — the cycle's critical
    path, since the cycle runs to completion and at every instant the
    chain names what the wall clock was spent on.  This runs once per
    cycle on the scheduling thread, so it is O(n log n) in segments,
    not elementary-intervals x segments.
    """
    totals = {cause: 0.0 for cause in ATTRIBUTION_CAUSES}
    if t1 <= t0:
        return totals, []
    events: list[tuple[float, int, int, str]] = []
    for s in segments:
        prio = _PRIORITY.get(s["cause"])
        if prio is None:
            continue
        start, end = max(s["start"], t0), min(s["end"], t1)
        if end <= start:
            continue
        events.append((start, 1, prio, s["name"]))
        events.append((end, -1, prio, s["name"]))
    events.sort(key=lambda e: e[0])
    counts = [0] * len(CAUSES)
    names: list[list[str]] = [[] for _ in CAUSES]
    chain: list[dict] = []

    def emit(lo: float, hi: float) -> None:
        if hi <= lo:
            return
        best = next((p for p, c in enumerate(counts) if c), None)
        if best is None:
            cause, name = UNATTRIBUTED, ""
        else:
            cause, name = CAUSES[best], names[best][-1]
        totals[cause] += hi - lo
        if chain and chain[-1]["cause"] == cause:
            chain[-1]["end"] = hi
        else:
            chain.append({"start": lo, "end": hi,
                          "cause": cause, "name": name})

    prev = t0
    i, n = 0, len(events)
    while i < n:
        now = events[i][0]
        emit(prev, now)
        while i < n and events[i][0] == now:
            _, delta, prio, name = events[i]
            if delta > 0:
                counts[prio] += 1
                names[prio].append(name)
            else:
                counts[prio] -= 1
                names[prio].remove(name)
            i += 1
        prev = now
    emit(prev, t1)
    return totals, chain


def device_idle(segments: list[dict], t0: float, t1: float
                ) -> tuple[list[tuple[float, float]], float]:
    """Idle intervals = the cycle window minus the union of
    ``device_busy`` spans (each one a dispatch edge to its block
    edge).  Returns ``(idle_intervals, busy_seconds)``."""
    busy = _merge_intervals([
        (max(s["start"], t0), min(s["end"], t1)) for s in segments
        if s["cause"] == DEVICE_BUSY and s["end"] > t0 and s["start"] < t1])
    idle: list[tuple[float, float]] = []
    cursor = t0
    for s, e in busy:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < t1:
        idle.append((cursor, t1))
    return idle, sum(e - s for s, e in busy)


class TimelineRecorder:
    """Lock-protected segment sink + per-cycle reconstruction ring.

    One module-level instance (:data:`RECORDER`) serves every
    scheduler in the process — segments carry a tenant tag, cycle
    windows clip by time, and the ring backs ``/debug/timeline``.
    """

    def __init__(self, enabled: bool = True, max_segments: int = 16384,
                 max_cycles: int = 64):
        self._enabled = enabled
        self._lock = threading.Lock()
        self._segments: deque = deque(maxlen=max_segments)
        self._cycles: deque = deque(maxlen=max_cycles)

    # -- the hot-path surface -------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """The kill switch: disabling drops pending segments so a
        re-enable can't attribute a stale window."""
        self._enabled = bool(enabled)
        with self._lock:
            self._segments.clear()

    def add(self, start: float, end: float, cause: str,
            name: str = "", tenant: str = "") -> None:
        """Record one finished segment (perf_counter timestamps)."""
        if not self._enabled or end <= start:
            return
        with self._lock:
            self._segments.append((start, end, cause, name, tenant))

    @contextlib.contextmanager
    def section(self, cause: str, name: str = "", tenant: str = ""):
        """Time a block as one segment; near-free when disabled."""
        if not self._enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(t0, time.perf_counter(), cause, name, tenant)

    # -- cycle reconstruction -------------------------------------------

    def _window(self, t0: float, t1: float) -> list[dict]:
        with self._lock:
            raw = [s for s in self._segments if s[1] > t0 and s[0] < t1]
            # prune consumed history: segments entirely before this
            # window belong to no future cycle (inter-cycle applies
            # attribute nowhere by design)
            while self._segments and self._segments[0][1] <= t1:
                self._segments.popleft()
        return [{"start": max(s, t0), "end": min(e, t1), "cause": c,
                 "name": n, "tenant": t}
                for s, e, c, n, t in raw]

    def finish_cycle(self, cycle: int, t0: float, t1: float,
                     mode: str = "cycle", publish: bool = True) -> dict | None:
        """Reconstruct the window [t0, t1]: clip segments, attribute
        wall time, derive device idle, name the critical path; append
        the cycle doc to the ring and (by default) republish the
        ``host_wait_attribution`` / ``device_idle_fraction`` /
        ``critical_path_seconds`` gauges.  Returns the doc (None when
        disabled or the window is degenerate)."""
        if not self._enabled or t1 <= t0:
            return None
        wall = t1 - t0
        segments = self._window(t0, t1)
        totals, chain = sweep_attribution(segments, t0, t1)
        idle, busy_s = device_idle(segments, t0, t1)
        attribution = {c: totals[c] / wall for c in ATTRIBUTION_CAUSES}
        named = {c: s for c, s in totals.items()
                 if c != UNATTRIBUTED and s > 0.0}
        critical_cause = (max(named, key=named.get) if named
                          else UNATTRIBUTED)
        doc = {
            "cycle": cycle,
            "mode": mode,
            "start": t0,
            "wall_s": wall,
            "segments": [
                {"start": s["start"] - t0, "end": s["end"] - t0,
                 "cause": s["cause"], "name": s["name"],
                 "tenant": s["tenant"]}
                for s in sorted(segments, key=lambda s: s["start"])],
            "attribution": attribution,
            "attribution_s": totals,
            "unattributed_fraction": attribution[UNATTRIBUTED],
            "device_busy_s": busy_s,
            "device_idle_fraction": (wall - busy_s) / wall,
            "device_idle": [(s - t0, e - t0) for s, e in idle],
            "critical_path": [
                {"start": c["start"] - t0, "end": c["end"] - t0,
                 "cause": c["cause"], "name": c["name"]}
                for c in chain],
            "critical_cause": critical_cause,
            "critical_seconds": totals.get(critical_cause, 0.0),
        }
        with self._lock:
            self._cycles.append(doc)
        if publish:
            self._publish(doc)
        return doc

    @staticmethod
    def _publish(doc: dict) -> None:
        from koordinator_tpu_torch import metrics

        for cause in ATTRIBUTION_CAUSES:
            # every cause republished each cycle so cleared ones read 0
            metrics.host_wait_attribution.set(
                doc["attribution"][cause], labels={"cause": cause})
            metrics.critical_path_seconds.set(
                doc["attribution_s"][cause], labels={"cause": cause})
        metrics.device_idle_fraction.set(doc["device_idle_fraction"])

    def cycles(self, limit: int = 8) -> list[dict]:
        """Newest-first cycle docs (the /debug/timeline body)."""
        with self._lock:
            out = list(self._cycles)[-max(limit, 0):]
        out.reverse()
        return out

    def reset_for_tests(self) -> None:
        with self._lock:
            self._segments.clear()
            self._cycles.clear()


#: process-wide recorder; KOORD_TIMELINE=0 disables at import (the env
#: half of the kill switch — --no-timeline is the CLI half)
RECORDER = TimelineRecorder(
    enabled=os.environ.get("KOORD_TIMELINE", "1") != "0")
