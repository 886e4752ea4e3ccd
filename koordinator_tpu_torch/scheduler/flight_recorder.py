"""Round flight recorder: a ring buffer of per-round telemetry (port of
``koordinator_tpu/scheduler/flight_recorder.py``).

Every scheduling round leaves one :class:`RoundRecord` — solve path,
dirty fractions, per-phase timings, the wall-vs-device solve split,
degraded/staleness state, shed/suspension counts, and the round's
trace_id — so "why was round 48213 slow" is answered from one artifact
instead of five binaries' logs.  Slow or degraded rounds are dumped to
the scheduler log automatically (bounded: one line per offending round)
and counted in ``round_flight_dumps_total``; ``snapshot()`` is the ring
the JAX package's debug service serves at ``GET /debug/rounds`` (the
port's comes with its transport), and ``tools/trace_dump.py
--slowest-round`` prints the same fields from a JSONL trace export (the
round span carries them as attributes).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections import deque
from typing import Optional

from koordinator_tpu_torch import metrics

logger = logging.getLogger("koordinator_tpu_torch.scheduler")


@dataclasses.dataclass
class RoundRecord:
    """One round's flight data (all host-side scalars; JSON-able)."""

    round: int
    trace_id: str
    start_time: float            # wall clock, cross-process comparable
    duration_s: float
    solver: str                  # greedy | batch
    solve_path: str              # incremental | full_* | degraded | none
    pods: int                    # pods the round solved over
    placed: int
    failed: int
    suspended: int               # held out by degraded-mode admission
    degraded: bool
    staleness_s: Optional[float]  # sync-feed age at round start
    dirty_node_frac: float
    dirty_pod_frac: float
    solve_wall_s: float          # the Solve phase's wall time
    solve_device_s: float        # time blocked on the solve's results
    phase_s: dict[str, float] = dataclasses.field(default_factory=dict)
    #: cumulative solve-shed counter at round end (deltas between
    #: records localize WHICH round the sheds landed in)
    sheds_total: float = 0.0
    #: {top reject reason -> unplaced pod count} from the round's
    #: placement-explanation rollup (ops/explain taxonomy); empty when
    #: nothing failed or explain accounting is off — a slow/degraded
    #: dump then answers "slow doing WHAT" and "failing WHY" in one line
    top_unschedulable: dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: tenancy attribution: which tenant's round this record
    #: covers ("" = untenanted scheduler), and which pipeline half —
    #: "round" for a serial round, "solve"/"commit" for the two records
    #: a pipelined round leaves, so /debug/rounds and soak_report
    #: attribute a slow half to a tenant
    tenant: str = ""
    half: str = "round"
    #: solve-quality mode of the scheduler: off | lp | auto —
    #: and, when the round solved on the LP path, the rounding-iteration
    #: count it used (0 on greedy rounds), so a slow quality round's
    #: dump answers "how many LP phases did that cost" in place
    quality_mode: str = "off"
    quality_iterations: int = 0
    #: critical-path join: the timeline observatory's verdict
    #: for the cycle this round ran in — which cause dominated the
    #: cycle's covering chain and for how long — annotated after the
    #: cycle reconstructs (cycle_seq = -1 until then / with the
    #: recorder disabled), so a slow round's record names what the
    #: WHOLE cycle was actually spending its wall on
    cycle_seq: int = -1
    cycle_critical_cause: str = ""
    cycle_critical_seconds: float = 0.0
    dump_reason: Optional[str] = None   # slow | degraded when dumped

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded ring of RoundRecords with automatic slow/degraded dumps.

    Single-writer (records are appended under the scheduler's round
    lock); readers take list() snapshots, which is safe against a
    concurrent append on CPython deques.
    """

    def __init__(self, capacity: int = 256,
                 slow_threshold_s: float = 1.0):
        self.capacity = capacity
        #: rounds slower than this dump their record (mirrors the
        #: monitor's slow-round warning threshold by default)
        self.slow_threshold_s = slow_threshold_s
        self.records: deque[RoundRecord] = deque(maxlen=capacity)
        self.dumps = 0
        self.overwrites = 0

    def _dump(self, rec: RoundRecord, reason: str) -> None:
        """The dump side effects — ONE home for the counter label, the
        bookkeeping, and the log line, shared by the automatic
        slow/degraded path and external triggers."""
        if rec.dump_reason is None:
            rec.dump_reason = reason
        self.dumps += 1
        metrics.round_flight_dumps.inc(labels={"reason": reason})
        logger.warning("round flight record (%s): %s", reason,
                       json.dumps(rec.to_doc(), default=str))

    def record(self, rec: RoundRecord) -> None:
        reason = None
        if rec.duration_s > self.slow_threshold_s:
            reason = "slow"
        elif rec.degraded:
            reason = "degraded"
        if reason is not None:
            self._dump(rec, reason)
        if len(self.records) == self.capacity:
            # the ring is about to evict its oldest record — dump
            # reasons are counted above, but silent eviction was
            # invisible until this counter
            self.overwrites += 1
            metrics.round_flight_overwritten.inc()
        self.records.append(rec)

    def dump_now(self, reason: str) -> bool:
        """Dump the most recent record on an external trigger (the SLO
        burn-rate engine's fast-burn breach) with the trigger's reason
        (e.g. ``slo:scheduling_latency_p99``).  False when no round has
        been recorded yet."""
        rec = self.last()
        if rec is None:
            return False
        self._dump(rec, reason)
        return True

    def annotate_round(self, round_seq: int, tenant: str,
                       **fields) -> int:
        """Back-annotate every in-ring record of one round (both halves
        of a pipelined round) with cycle-level fields — the timeline
        observatory's critical-path verdict lands here AFTER the cycle
        reconstructs.  Records already dumped to the log carry
        cycle_seq=-1; the ring (and any later dump) carries the join.
        Returns the number of records annotated."""
        n = 0
        for rec in list(self.records):
            if rec.round == round_seq and rec.tenant == tenant:
                for key, value in fields.items():
                    setattr(rec, key, value)
                n += 1
        return n

    def snapshot(self, limit: Optional[int] = None) -> list[dict]:
        """Newest-first record docs (the /debug/rounds body)."""
        records = list(self.records)[::-1]
        if limit is not None and limit >= 0:
            records = records[:limit]
        return [r.to_doc() for r in records]

    def slowest(self) -> Optional[dict]:
        records = list(self.records)
        if not records:
            return None
        return max(records, key=lambda r: r.duration_s).to_doc()

    def last(self) -> Optional[RoundRecord]:
        records = list(self.records)
        return records[-1] if records else None
