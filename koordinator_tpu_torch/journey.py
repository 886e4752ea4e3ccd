"""Pod-journey ledger: always-on e2e scheduling-latency sketches (port of
``koordinator_tpu/journey.py``).

Every latency surface before this one was round-scoped and process-local:
``scheduling_latency`` is a fixed-bucket per-round histogram, the timeline
observatory attributes wall time per *cycle*, and spans are opt-in.  None
of them can state "the p99 pod waited X ms from arrival to bind, and Y of
that was queue wait".  The journey ledger closes that gap:

* **Arrival** is stamped at the manager/ingest leg and rides deltasync as
  an optional ``arrival_ts`` doc key (a sparse-extras column on v4
  ``events_v2`` frames; a plain JSON key on v1/v3 — no proto bump).
* **Enqueue** is stamped when the pod lands in the scheduler's pending
  queue; **bind** is stamped by the (batched) bind-commit path, which
  computes the whole round's e2e latencies in one vectorized op.
* Latencies feed per-(tenant, qos, stage) **DDSketch-style log-bucketed
  quantile sketches**: fixed <=1% relative error, O(1) insert, and merge
  is bucket-wise addition — associative, commutative, and loss-free, so
  per-process JSONL snapshots merge into one fleet-wide journey table
  (``tools/latency_report.py``) without shipping raw samples.

Stages (per pod, seconds):

* ``ingest``     — manager ingest -> scheduler enqueue (deltasync hop)
* ``queue_wait`` — enqueue -> the solve round that binds the pod starts
* ``solve``      — round start -> commit (dispatch + device block)
* ``commit``     — commit bookkeeping -> bind ack
* ``e2e``        — arrival (or enqueue when no arrival stamp) -> ack

Kill switch: ``KOORD_JOURNEY=0`` or ``--no-journey`` disables recording
entirely.  The ledger never touches solve inputs, the pending-queue sort
key, or quota charges — scheduling decisions are bit-identical either way
(asserted by tests/test_journey.py).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Iterable

import numpy as np

__all__ = [
    "DDSketch",
    "JourneyLedger",
    "LEDGER",
    "STAGES",
    "RELATIVE_ACCURACY",
]

# Relative accuracy target: quantile(q) is within +/-1% of the true value
# (for values inside the representable range).  gamma is the log-bucket
# base: bucket i covers (gamma^(i-1), gamma^i].
RELATIVE_ACCURACY = 0.01
_GAMMA = (1.0 + RELATIVE_ACCURACY) / (1.0 - RELATIVE_ACCURACY)
_LOG_GAMMA = math.log(_GAMMA)

# Values below this floor land in the zero bucket: 1ns is far below any
# observable scheduling latency and keeps bucket indices bounded.
_MIN_VALUE = 1e-9

# Sentinel bucket index for zero-bucket samples inside the batched
# composite-key pass (real bucket indices stay within 32 bits).
_ZERO_IDX = -(1 << 31)

STAGES = ("e2e", "ingest", "queue_wait", "solve", "commit")


class DDSketch:
    """Mergeable log-bucketed quantile sketch (DDSketch, arXiv:1908.10693).

    Bucket ``i`` covers ``(gamma^(i-1), gamma^i]`` with
    ``gamma = (1+a)/(1-a)``, so reporting the bucket midpoint
    ``2*gamma^i/(gamma+1)`` is within relative error ``a`` of any value in
    the bucket.  Inserts are O(1); merge is bucket-wise addition, which is
    associative and commutative with the empty sketch as identity —
    exactly the algebra fleet aggregation needs.
    """

    __slots__ = ("buckets", "zero_count", "count", "_min", "_max", "_sum")

    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self._min = math.inf
        self._max = -math.inf
        self._sum = 0.0

    # -- insert ---------------------------------------------------------
    @staticmethod
    def _index(value: float) -> int:
        return int(math.ceil(math.log(value) / _LOG_GAMMA))

    def insert(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            return
        self.count += 1
        self._sum += max(value, 0.0)
        v = max(value, 0.0)
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if value <= _MIN_VALUE:
            self.zero_count += 1
            return
        idx = self._index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def insert_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.insert(v)

    def insert_repeated(self, value: float, n: int) -> None:
        """``n`` copies of the same value in O(1) — one bucket add.

        The solve/commit stages record one round-scalar for every pod
        the round carried; repeating the scalar insert n times (or
        materializing ``np.full(n, v)``) is pure waste.
        """
        if n <= 0:
            return
        value = float(value)
        if not math.isfinite(value):
            return
        v = max(value, 0.0)
        self.count += n
        self._sum += v * n
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if value <= _MIN_VALUE:
            self.zero_count += n
        else:
            idx = self._index(value)
            self.buckets[idx] = self.buckets.get(idx, 0) + n

    def insert_batch(self, values: np.ndarray) -> None:
        """Vectorized insert: one log + one unique over the whole batch
        (the bind-commit path records a full round in one call)."""
        v = np.asarray(values, np.float64).reshape(-1)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        clipped = np.maximum(v, 0.0)
        self.count += int(v.size)
        self._sum += float(clipped.sum())
        self._min = min(self._min, float(clipped.min()))
        self._max = max(self._max, float(clipped.max()))
        small = v <= _MIN_VALUE
        self.zero_count += int(small.sum())
        pos = v[~small]
        if pos.size:
            idx = np.ceil(np.log(pos) / _LOG_GAMMA).astype(np.int64)
            uniq, counts = np.unique(idx, return_counts=True)
            for i, n in zip(uniq.tolist(), counts.tolist()):
                self.buckets[i] = self.buckets.get(i, 0) + n

    # -- merge algebra --------------------------------------------------
    def merge(self, other: "DDSketch") -> "DDSketch":
        """Fold ``other`` into this sketch (bucket-wise add); returns self."""
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def copy(self) -> "DDSketch":
        out = DDSketch()
        out.buckets = dict(self.buckets)
        out.zero_count = self.zero_count
        out.count = self.count
        out._min = self._min
        out._max = self._max
        out._sum = self._sum
        return out

    # -- quantiles ------------------------------------------------------
    def quantile(self, q: float) -> float | None:
        """The q-quantile (0<=q<=1), or None for an empty sketch."""
        if self.count <= 0:
            return None
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return 0.0
        seen = float(self.zero_count)
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen > rank:
                # bucket midpoint: within RELATIVE_ACCURACY of any value
                # the bucket can hold
                return 2.0 * _GAMMA ** idx / (_GAMMA + 1.0)
        return self._max if self._max > -math.inf else 0.0

    def mean(self) -> float | None:
        return self._sum / self.count if self.count else None

    @property
    def max_value(self) -> float | None:
        return self._max if self.count else None

    @property
    def min_value(self) -> float | None:
        return self._min if self.count else None

    # -- serialization --------------------------------------------------
    def to_doc(self) -> dict:
        """Compact, byte-deterministic doc: bucket keys sorted ascending."""
        doc: dict = {
            "alpha": RELATIVE_ACCURACY,
            "count": self.count,
            "zero": self.zero_count,
            "buckets": {str(i): self.buckets[i]
                        for i in sorted(self.buckets)},
        }
        if self.count:
            doc["min"] = self._min
            doc["max"] = self._max
            doc["sum"] = self._sum
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "DDSketch":
        out = cls()
        out.zero_count = int(doc.get("zero", 0))
        out.count = int(doc.get("count", 0))
        out.buckets = {int(k): int(v)
                       for k, v in doc.get("buckets", {}).items()}
        if out.count:
            out._min = float(doc.get("min", math.inf))
            out._max = float(doc.get("max", -math.inf))
            out._sum = float(doc.get("sum", 0.0))
        return out


class JourneyLedger:
    """Per-(tenant, qos, stage) sketch registry for pod journeys.

    All recording is O(1) per pod and guarded behind :attr:`enabled`; the
    disabled ledger is a handful of attribute loads per round — cheap
    enough to leave the call sites unconditional.

    The scheduling path only STAGES work: ``record_bind_batch`` pops the
    pods' stamps and appends one tuple.  The numpy/sketch digestion —
    bucket indexing, per-series aggregation — runs on the first read
    (report / snapshot / gauges) or after :data:`_STAGED_MAX` staged
    rounds, consolidated into one composite-key pass over every staged
    batch at once.  That keeps the bind critical path to dict ops and
    amortizes the vector math onto the telemetry sampler.
    """

    #: staged rounds that force an inline digest (bounds memory when no
    #: reader ever samples the ledger)
    _STAGED_MAX = 512

    def __init__(self, enabled: bool = True) -> None:
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        # (tenant, qos, stage) -> DDSketch
        self._sketches: dict[tuple[str, int, str], DDSketch] = {}
        # pod name -> (arrival_ts wall, enqueue wall, enqueue perf)
        self._pending: dict[str, tuple[float, float, float]] = {}
        # staged bind rounds awaiting digestion:
        # (tenant, qos_list, stamps, round_start_perf, solve_s, commit_s)
        self._staged: list[tuple] = []

    # -- lifecycle ------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Flip recording; disabling clears all accumulated state."""
        with self._lock:
            self._enabled = bool(enabled)
            if not enabled:
                self._sketches.clear()
                self._pending.clear()
                self._staged.clear()

    def reset_for_tests(self) -> None:
        with self._lock:
            self._sketches.clear()
            self._pending.clear()
            self._staged.clear()

    # -- recording ------------------------------------------------------
    def note_enqueue(self, pod_name: str, arrival_ts: float = 0.0) -> None:
        """Stamp a pod's scheduler-enqueue time (and its upstream arrival
        stamp, if one rode deltasync in).

        Lock-free on purpose: this runs once per pod on the enqueue hot
        path, a single ``dict.setdefault`` is GIL-atomic, and
        first-enqueue-wins is exactly the semantics a resync replay
        needs (a replayed POD_ADD must not reset the pod's clock).
        """
        if not self._enabled:
            return
        self._pending.setdefault(
            pod_name,
            (float(arrival_ts or 0.0), time.time(), time.perf_counter()))

    def forget(self, pod_name: str) -> None:
        """Drop a pod's stamps (deleted before ever binding).

        Lock-free like ``note_enqueue``: ``dict.pop`` is GIL-atomic and
        this runs once per dequeued pod.
        """
        if not self._enabled:
            return
        self._pending.pop(pod_name, None)

    def record_bind_batch(self, tenant: str, pods, *,
                          round_start_perf: float,
                          commit_perf: float,
                          ack_perf: float | None = None) -> None:
        """Record one committed round's journeys in a single pass.

        ``pods`` is the round's bound PodSpec list; ``round_start_perf``
        is the perf_counter stamp when the binding solve round started,
        ``commit_perf`` when the commit bookkeeping began, ``ack_perf``
        when the bind callbacks acked (defaults to now).

        Scheduling-path cost is dict pops plus one list append — the
        vector math runs later in :meth:`_digest_locked`.
        """
        if not self._enabled or not pods:
            return
        if ack_perf is None:
            ack_perf = time.perf_counter()
        solve_s = max(commit_perf - round_start_perf, 0.0)
        commit_s = max(ack_perf - commit_perf, 0.0)
        with self._lock:
            if not self._enabled:
                return
            pop = self._pending.pop
            pairs = [(pod.qos, st) for pod in pods
                     if (st := pop(pod.name, None)) is not None]
            if not pairs:
                return
            self._staged.append((tenant, [q for q, _ in pairs],
                                 [st for _, st in pairs],
                                 round_start_perf, solve_s, commit_s))
            if len(self._staged) >= self._STAGED_MAX:
                self._digest_locked()

    def _digest_locked(self) -> None:
        """Fold every staged bind round into the sketches in one pass.

        Per staged round only a handful of (P,)-shaped ops run to turn
        stamps into stage latencies; bucket counting and per-series
        count/sum/min/max for ALL (tenant, qos, stage) series across
        the whole drain then happen through one composite-key
        ``np.unique`` plus one sort — the numpy fixed cost is paid per
        digest, not per round.  The per-round scalar stages (solve,
        commit) never touch numpy: n identical samples are one O(1)
        bucket add.  Caller holds ``self._lock``.
        """
        staged = self._staged
        if not staged:
            return
        self._staged = []
        seg_groups: list[int] = []
        seg_vals: list[np.ndarray] = []
        sketches: list[DDSketch] = []
        gid: dict[tuple[str, int, str], int] = {}

        def group(tenant: str, qos: int, stage: str) -> int:
            key = (tenant, qos, stage)
            g = gid.get(key)
            if g is None:
                g = gid[key] = len(sketches)
                sketches.append(self._sketch(tenant, qos, stage))
            return g

        for (tenant, qos_list, stamps, round_start_perf,
             solve_s, commit_s) in staged:
            stamp_arr = np.asarray(stamps, np.float64)    # (P, 3)
            arrival = stamp_arr[:, 0]
            queue_s = np.maximum(round_start_perf - stamp_arr[:, 2], 0.0)
            has_arrival = arrival > 0.0
            any_arrival = bool(has_arrival.any())
            # e2e closes on the same monotonic clock the stages use;
            # the ingest hop (wall-clock, cross-process) is added on
            # top when an arrival stamp rode deltasync in.  That hop
            # inherits producer↔scheduler clock offset one-for-one:
            # negative skew clamps to 0 below, positive skew inflates
            # ingest/e2e (see the clock-skew caveat in
            # docs/observability.md)
            if any_arrival:
                ingest_s = np.where(
                    has_arrival,
                    np.maximum(stamp_arr[:, 1] - arrival, 0.0), 0.0)
                e2e_s = ingest_s + queue_s + (solve_s + commit_s)
            else:
                ingest_s = None
                e2e_s = queue_s + (solve_s + commit_s)
            distinct = sorted(set(qos_list))
            for q in distinct:
                if len(distinct) == 1:
                    sel = None                      # whole round
                    n = len(qos_list)
                    ing = (ingest_s[has_arrival]
                           if any_arrival else None)
                    seg_vals.append(e2e_s)
                    seg_groups.append(group(tenant, q, "e2e"))
                    seg_vals.append(queue_s)
                else:
                    sel = np.asarray(qos_list) == q
                    n = int(sel.sum())
                    ing = (ingest_s[sel & has_arrival]
                           if any_arrival else None)
                    seg_vals.append(e2e_s[sel])
                    seg_groups.append(group(tenant, q, "e2e"))
                    seg_vals.append(queue_s[sel])
                seg_groups.append(group(tenant, q, "queue_wait"))
                if ing is not None and ing.size:
                    seg_vals.append(ing)
                    seg_groups.append(group(tenant, q, "ingest"))
                self._sketch(tenant, q, "solve").insert_repeated(
                    solve_s, n)
                self._sketch(tenant, q, "commit").insert_repeated(
                    commit_s, n)

        flat = np.concatenate(seg_vals)
        lens = np.fromiter((v.size for v in seg_vals), np.int64,
                           count=len(seg_vals))
        groups = np.repeat(np.asarray(seg_groups, np.int64), lens)
        small = flat <= _MIN_VALUE
        idx = np.ceil(np.log(np.where(small, 1.0, flat))
                      / _LOG_GAMMA).astype(np.int64)
        idx[small] = _ZERO_IDX
        # composite (group, bucket) key: bucket indices for any
        # representable latency fit comfortably in 32 bits
        composite = groups * (1 << 33) + (idx + (1 << 32))
        uniq, counts = np.unique(composite, return_counts=True)
        # per-group count/sum/min/max via one sort + reduceat
        order = np.argsort(groups, kind="stable")
        sv, sg = flat[order], groups[order]
        starts = np.concatenate(([0], np.flatnonzero(np.diff(sg)) + 1))
        g_ids = sg[starts].tolist()
        g_counts = np.diff(np.concatenate((starts, [sg.size]))).tolist()
        g_sums = np.add.reduceat(sv, starts).tolist()
        g_mins = np.minimum.reduceat(sv, starts).tolist()
        g_maxs = np.maximum.reduceat(sv, starts).tolist()
        for g, cnt, gsum, gmin, gmax in zip(
                g_ids, g_counts, g_sums, g_mins, g_maxs):
            sk = sketches[g]
            sk.count += cnt
            sk._sum += gsum
            if gmin < sk._min:
                sk._min = gmin
            if gmax > sk._max:
                sk._max = gmax
        for comp, cnt in zip(uniq.tolist(), counts.tolist()):
            g, b = divmod(comp, 1 << 33)
            b -= 1 << 32
            sk = sketches[g]
            if b == _ZERO_IDX:
                sk.zero_count += cnt
            else:
                sk.buckets[b] = sk.buckets.get(b, 0) + cnt

    def _sketch(self, tenant: str, qos: int, stage: str) -> DDSketch:
        key = (tenant, qos, stage)
        sk = self._sketches.get(key)
        if sk is None:
            sk = self._sketches[key] = DDSketch()
        return sk

    # -- reporting ------------------------------------------------------
    def tenants(self) -> list[str]:
        with self._lock:
            self._digest_locked()
            return sorted({t for (t, _q, _s) in self._sketches})

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def snapshot_doc(self, tenant: str | None = None) -> dict:
        """Serializable snapshot: ``{"series": [{tenant,qos,stage,sketch}]}``.

        Deterministic ordering (sorted keys) so identical ledgers produce
        byte-identical JSON.
        """
        with self._lock:
            self._digest_locked()
            keys = sorted(k for k in self._sketches
                          if tenant is None or k[0] == tenant)
            series = [{"tenant": t, "qos": q, "stage": s,
                       "sketch": self._sketches[(t, q, s)].to_doc()}
                      for (t, q, s) in keys]
        return {"alpha": RELATIVE_ACCURACY, "series": series}

    def report(self, tenant: str | None = None,
               quantiles: tuple[float, ...] = (0.5, 0.9, 0.99)) -> dict:
        """Human-facing journey table: per-series quantiles + counts."""
        with self._lock:
            self._digest_locked()
            keys = sorted(k for k in self._sketches
                          if tenant is None or k[0] == tenant)
            rows = []
            for (t, q, s) in keys:
                sk = self._sketches[(t, q, s)]
                row = {"tenant": t, "qos": q, "stage": s,
                       "count": sk.count,
                       "mean_s": sk.mean(), "max_s": sk.max_value}
                for quant in quantiles:
                    row[f"p{int(quant * 100)}_s"] = sk.quantile(quant)
                rows.append(row)
        return {"enabled": self._enabled, "alpha": RELATIVE_ACCURACY,
                "series": rows}

    def write_jsonl(self, path: str) -> int:
        """Append one snapshot line per (tenant, qos, stage) series."""
        doc = self.snapshot_doc()
        with open(path, "a", encoding="utf-8") as fh:
            for row in doc["series"]:
                fh.write(json.dumps(row, sort_keys=True,
                                    separators=(",", ":")) + "\n")
        return len(doc["series"])

    # -- metrics / SloMonitor bridge ------------------------------------
    def publish_gauges(self) -> None:
        """Publish per-series quantile gauges; safe as a SloMonitor
        ``pre_sample`` hook (never raises)."""
        if not self._enabled:
            return
        try:
            from koordinator_tpu_torch import metrics
            with self._lock:
                self._digest_locked()
                items = [(k, sk.copy())
                         for k, sk in self._sketches.items()]
            for (t, q, s), sk in items:
                for quant, tag in ((0.5, "0.5"), (0.99, "0.99")):
                    v = sk.quantile(quant)
                    if v is not None:
                        metrics.pod_journey_latency_seconds.set(
                            v, labels={"tenant": t, "qos": str(q),
                                       "stage": s, "q": tag})
        except Exception:
            pass


def merge_snapshot_rows(rows: Iterable[dict]) -> dict:
    """Merge JSONL snapshot rows (possibly from many processes) into one
    ``(tenant, qos, stage) -> DDSketch`` table — the fleet-aggregation
    primitive behind tools/latency_report.py and soak_report."""
    merged: dict[tuple[str, int, str], DDSketch] = {}
    for row in rows:
        key = (str(row["tenant"]), int(row["qos"]), str(row["stage"]))
        sk = DDSketch.from_doc(row["sketch"])
        if key in merged:
            merged[key].merge(sk)
        else:
            merged[key] = sk
    return merged


LEDGER = JourneyLedger(enabled=os.environ.get("KOORD_JOURNEY", "1") != "0")
