"""Node-local metric store (port of ``koordinator_tpu/koordlet/metriccache.py``,
copied whole; reference: ``pkg/koordlet/metriccache/`` — an
embedded Prometheus TSDB ``tsdb_storage.go:29`` plus an in-memory KV
``metric_cache.go:58-76``).

TPU-native redesign: instead of a general TSDB, each (metric, label-set)
series is a fixed-capacity numpy ring buffer of (ts, value). Windowed queries
return contiguous views, and the aggregators (avg/latest/count/percentiles)
are vectorized — the NodeMetric reporter's p50/p90/p95/p99 aggregation
(``statesinformer/impl/states_nodemetric.go``) is one ``np.quantile`` call.
The same buffers feed the prediction histograms without copies.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Mapping, Optional

import numpy as np

# Canonical metric names (metric_resources.go equivalents).
NODE_CPU_USAGE = "node_cpu_usage"            # cores (float)
NODE_MEMORY_USAGE = "node_memory_usage"      # bytes
POD_CPU_USAGE = "pod_cpu_usage"              # labels: pod_uid
POD_MEMORY_USAGE = "pod_memory_usage"
CONTAINER_CPU_USAGE = "container_cpu_usage"  # labels: pod_uid, container_id
CONTAINER_MEMORY_USAGE = "container_memory_usage"
CONTAINER_CPU_THROTTLED = "container_cpu_throttled_ratio"
BE_CPU_USAGE = "be_cpu_usage"
SYS_CPU_USAGE = "sys_cpu_usage"
SYS_MEMORY_USAGE = "sys_memory_usage"
NODE_PERCPU_USAGE = "node_percpu_usage"      # cores; labels: cpu
NODE_CPI_FIELD = "node_cpi"
POD_CPI = "pod_cpi"                          # labels: pod_uid
CONTAINER_CPI = "container_cpi"              # labels: pod_uid, container_id
PSI_CPU_SOME_AVG10 = "psi_cpu_some_avg10"
PSI_MEM_FULL_AVG10 = "psi_mem_full_avg10"
PSI_IO_FULL_AVG10 = "psi_io_full_avg10"
COLD_PAGE_BYTES = "cold_page_bytes"
PAGE_CACHE_BYTES = "page_cache_bytes"
HOST_APP_CPU_USAGE = "host_app_cpu_usage"    # labels: app
HOST_APP_MEMORY_USAGE = "host_app_memory_usage"
NODE_DISK_READ_RATE = "node_disk_read_bytes_rate"    # labels: device
NODE_DISK_WRITE_RATE = "node_disk_write_bytes_rate"  # labels: device
NODE_DISK_IO_UTIL = "node_disk_io_util_pct"          # labels: device
RESCTRL_LLC_OCCUPANCY = "resctrl_llc_occupancy"      # labels: group
RESCTRL_MBM_TOTAL_RATE = "resctrl_mbm_total_bytes_rate"  # labels: group
ACCEL_CORE_USAGE = "accel_core_usage_pct"    # labels: minor, uuid, type
ACCEL_MEM_USED = "accel_mem_used_bytes"      # labels: minor, uuid, type
HAMI_VGPU_CORE_USAGE = "hami_vgpu_core_usage_pct"  # labels: uuid, pod_uid
HAMI_VGPU_MEM_USED = "hami_vgpu_mem_used_bytes"    # labels: uuid, pod_uid
#: KV keys (metric_cache KV store)
KV_NODE_CPU_INFO = "node_cpu_info"
KV_NODE_NUMA_INFO = "node_numa_info"


def _series_key(metric: str, labels: Mapping[str, str] | None) -> tuple:
    return (metric, tuple(sorted((labels or {}).items())))


class _Ring:
    __slots__ = ("ts", "values", "head", "count")

    def __init__(self, capacity: int):
        self.ts = np.zeros(capacity, np.float64)
        self.values = np.zeros(capacity, np.float64)
        self.head = 0
        self.count = 0

    def append(self, ts: float, value: float) -> None:
        cap = len(self.ts)
        self.ts[self.head] = ts
        self.values[self.head] = value
        self.head = (self.head + 1) % cap
        self.count = min(self.count + 1, cap)

    def window(self, start: float, end: float) -> tuple[np.ndarray, np.ndarray]:
        ts, vals = self.chronological()
        mask = (ts >= start) & (ts <= end)
        return ts[mask], vals[mask]

    def oldest_ts(self) -> float | None:
        """O(1) timestamp of the oldest live sample; None when empty."""
        if not self.count:
            return None
        cap = len(self.ts)
        return float(self.ts[self.head] if self.count == cap
                     else self.ts[0])

    def chronological(self) -> tuple[np.ndarray, np.ndarray]:
        """Oldest-first views of the live samples."""
        cap = len(self.ts)
        if self.count < cap:
            return self.ts[: self.count], self.values[: self.count]
        idx = np.arange(self.head, self.head + cap) % cap
        return self.ts[idx], self.values[idx]

    def drain_older(self, cutoff: float) -> tuple[np.ndarray, np.ndarray]:
        """Remove and return every sample STRICTLY older than ``cutoff``
        (a sample exactly at the horizon is kept, matching the
        query-time retention boundary); the ring is repacked in place."""
        ts, vals = self.chronological()
        keep = ts >= cutoff
        if keep.all():
            return np.empty(0), np.empty(0)
        drained = ts[~keep].copy(), vals[~keep].copy()
        kept_ts, kept_vals = ts[keep].copy(), vals[keep].copy()
        n = len(kept_ts)
        self.ts[:n] = kept_ts
        self.values[:n] = kept_vals
        self.count = n
        self.head = n % len(self.ts)
        return drained


class _ColdTier:
    """Downsampled history past the hot ring's resolution horizon.

    Samples drained out of a hot ring land here as one mean-per-bin
    sample per ``downsample_resolution_sec`` — the newest (possibly
    still-filling) bin accumulates in the pending slot until a later
    bin's samples arrive, so a bin is finalized exactly once.  Memory
    stays bounded: one extra ring per series, never more.
    """

    __slots__ = ("ring", "pending_bin", "pending_sum", "pending_tsum",
                 "pending_cnt")

    def __init__(self, capacity: int):
        self.ring = _Ring(capacity)
        self.pending_bin: int | None = None
        self.pending_sum = 0.0
        self.pending_tsum = 0.0
        self.pending_cnt = 0

    def flush_pending(self) -> None:
        if self.pending_cnt:
            self.ring.append(self.pending_tsum / self.pending_cnt,
                             self.pending_sum / self.pending_cnt)
        self.pending_bin = None
        self.pending_sum = self.pending_tsum = 0.0
        self.pending_cnt = 0

    def absorb(self, ts: np.ndarray, values: np.ndarray,
               resolution_s: float) -> None:
        if len(ts) == 0:
            return
        bins = np.floor(ts / resolution_s).astype(np.int64)
        for b in np.unique(bins):          # ascending
            mask = bins == b
            if self.pending_bin is not None and b < self.pending_bin:
                # out-of-order stragglers: finalize directly rather
                # than reopening a flushed bin
                self.ring.append(float(ts[mask].mean()),
                                 float(values[mask].mean()))
                continue
            if self.pending_bin is not None and b > self.pending_bin:
                self.flush_pending()
            self.pending_bin = int(b)
            self.pending_sum += float(values[mask].sum())
            self.pending_tsum += float(ts[mask].sum())
            self.pending_cnt += int(mask.sum())

    def window(self, start: float, end: float
               ) -> tuple[np.ndarray, np.ndarray]:
        ts, vals = self.ring.window(start, end)
        if self.pending_cnt:
            pt = self.pending_tsum / self.pending_cnt
            if start <= pt <= end:
                ts = np.append(ts, pt)
                vals = np.append(vals,
                                 self.pending_sum / self.pending_cnt)
        return ts, vals


class AggregateResult:
    """Windowed aggregation over one series."""

    def __init__(self, ts: np.ndarray, values: np.ndarray):
        self.ts = ts
        self.values = values

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def empty(self) -> bool:
        return self.count == 0

    def avg(self) -> float:
        return float(self.values.mean()) if self.count else 0.0

    def latest(self) -> float:
        return float(self.values[np.argmax(self.ts)]) if self.count else 0.0

    def max(self) -> float:
        return float(self.values.max()) if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in (0,1]; lower-interpolation to match Go's sample quantiles."""
        if not self.count:
            return 0.0
        return float(np.quantile(self.values, q, method="lower"))

    def percentiles(self, qs: Iterable[float]) -> dict[float, float]:
        return {q: self.percentile(q) for q in qs}

    def duration_seconds(self) -> float:
        return float(self.ts.max() - self.ts.min()) if self.count > 1 else 0.0

    def first(self) -> float:
        """Value at the earliest timestamp in the window (the other end
        of a cumulative counter's windowed delta); 0.0 sentinel when
        empty."""
        return float(self.values[np.argmin(self.ts)]) if self.count else 0.0

    def downsample(self, resolution_s: float) -> "AggregateResult":
        """Mean-per-bin downsampling to one sample per ``resolution_s``
        (bin timestamp = mean of member timestamps).  Bounds the cost of
        long-window aggregation (the SLO engine's 1h slow window over a
        1s sample cadence) without a second storage tier.  Meant for
        gauges — averaging COUNTER samples inside a bin slightly skews
        windowed deltas, so counter paths query raw."""
        if resolution_s <= 0 or self.count == 0:
            return self
        bins = np.floor(self.ts / resolution_s).astype(np.int64)
        _, inverse = np.unique(bins, return_inverse=True)
        counts = np.bincount(inverse)
        ts = np.bincount(inverse, weights=self.ts) / counts
        values = np.bincount(inverse, weights=self.values) / counts
        order = np.argsort(ts)
        return AggregateResult(ts[order], values[order])


class MetricCache:
    """Thread-safe store of ring-buffered series + an immutable KV side table."""

    def __init__(self, capacity_per_series: int = 4096, clock=time.time,
                 retention_sec: float | None = None,
                 downsample_after_sec: float | None = None,
                 downsample_resolution_sec: float = 10.0):
        self.capacity = capacity_per_series
        #: query-time retention horizon: samples strictly older than
        #: ``now - retention_sec`` are never served (the ring already
        #: bounds memory; retention bounds what a WINDOW may claim to
        #: cover).  A sample exactly AT the horizon is still served.
        self.retention_sec = retention_sec
        #: long-horizon tier: samples aging past this horizon
        #: move out of the hot ring into a per-series cold ring at
        #: mean-per-``downsample_resolution_sec``-bin resolution, so an
        #: hours-long soak keeps a bounded TWO rings per series (full
        #: resolution recent, downsampled history) instead of either
        #: unbounded memory or silent eviction of the history the trend
        #: engine needs.  A sample exactly AT the horizon stays hot;
        #: one strictly older is downsampled.  None disables the tier
        #: (hot-ring wraparound evicts, the pre-existing behavior).
        self.downsample_after_sec = downsample_after_sec
        self.downsample_resolution_sec = downsample_resolution_sec
        self._series: dict[tuple, _Ring] = {}
        self._cold: dict[tuple, _ColdTier] = {}
        self._kv: dict[str, object] = {}
        self._lock = threading.Lock()
        self._clock = clock

    # -- samples --

    def append(self, metric: str, value: float,
               labels: Mapping[str, str] | None = None,
               ts: Optional[float] = None) -> None:
        key = _series_key(metric, labels)
        now = self._clock() if ts is None else ts
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = _Ring(self.capacity)
            if (self.downsample_after_sec is not None
                    and ring.count == len(ring.ts)):
                # the hot ring is full: this append overwrites the
                # oldest sample.  With the long-horizon tier on, a
                # wrap-evicted sample is CAPTURED (downsampled) instead
                # of silently lost — a hot ring smaller than the horizon
                # must not punch holes in the history
                evict_ts = float(ring.ts[ring.head])
                evict_val = float(ring.values[ring.head])
                tier = self._cold.get(key)
                if tier is None:
                    tier = self._cold[key] = _ColdTier(self.capacity)
                tier.absorb(np.asarray([evict_ts]),
                            np.asarray([evict_val]),
                            self.downsample_resolution_sec)
            ring.append(now, value)
            if self.downsample_after_sec is not None:
                # amortized: compact this series only once a full
                # downsample bin's worth has aged past the horizon
                # (compact() does the exact-cutoff sweep on demand)
                oldest = ring.oldest_ts()
                if oldest is not None and (
                        oldest < now - self.downsample_after_sec
                        - self.downsample_resolution_sec):
                    self._compact_series_locked(key, now)

    def append_many(self, samples: list[tuple[str, float, Mapping[str, str] | None]],
                    ts: Optional[float] = None) -> None:
        now = self._clock() if ts is None else ts
        for metric, value, labels in samples:
            self.append(metric, value, labels, ts=now)

    # koordlint: guarded-by(self._lock)
    def _compact_series_locked(self, key: tuple, now: float) -> None:
        ring = self._series.get(key)
        if ring is None or self.downsample_after_sec is None:
            return
        drained_ts, drained_vals = ring.drain_older(
            now - self.downsample_after_sec)
        if len(drained_ts) == 0:
            return
        tier = self._cold.get(key)
        if tier is None:
            tier = self._cold[key] = _ColdTier(self.capacity)
        tier.absorb(drained_ts, drained_vals,
                    self.downsample_resolution_sec)

    def compact(self, now: Optional[float] = None) -> None:
        """Move every sample older than ``downsample_after_sec`` into
        its series' downsampled cold tier right now (appends do this
        lazily per series); no-op when the tier is disabled."""
        if self.downsample_after_sec is None:
            return
        now = self._clock() if now is None else now
        with self._lock:
            for key in list(self._series):
                self._compact_series_locked(key, now)

    def query(self, metric: str, labels: Mapping[str, str] | None = None,
              start: float = 0.0, end: Optional[float] = None) -> AggregateResult:
        key = _series_key(metric, labels)
        end = self._clock() if end is None else end
        if self.retention_sec is not None:
            start = max(start, self._clock() - self.retention_sec)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                return AggregateResult(np.empty(0), np.empty(0))
            ts, vals = ring.window(start, end)
            tier = self._cold.get(key)
            if tier is not None:
                # downsampled history first (older), hot samples after —
                # aggregators don't require sorted input, but keeping
                # rough chronological order costs nothing
                cts, cvals = tier.window(start, end)
                if len(cts):
                    ts = np.concatenate([cts, ts])
                    vals = np.concatenate([cvals, vals])
        return AggregateResult(ts, vals)

    def series_labels(self, metric: str) -> list[dict[str, str]]:
        """All label-sets present for a metric (e.g. every pod_uid)."""
        with self._lock:
            return [
                dict(lbl) for m, lbl in self._series.keys() if m == metric
            ]

    def delete_series(self, metric: str, labels: Mapping[str, str]) -> None:
        with self._lock:
            key = _series_key(metric, labels)
            self._series.pop(key, None)
            self._cold.pop(key, None)

    def gc(self, keep_pod_uids: set[str]) -> int:
        """Drop series of pods that no longer exist; returns dropped count."""
        with self._lock:
            stale = [
                key for key in self._series
                if any(k == "pod_uid" and v not in keep_pod_uids for k, v in key[1])
            ]
            for key in stale:
                del self._series[key]
                self._cold.pop(key, None)
        return len(stale)

    # -- persistence (tsdb_storage.go:29 role) --
    #
    # The reference's metriccache is an embedded Prometheus TSDB persisted
    # on the node, so a koordlet restart keeps its aggregation windows; the
    # ring buffers must match that or the NodeMetric reporter publishes a
    # "p95 over the window" computed from seconds of post-restart data
    # while claiming the window's label, and suppress/evict run on cold
    # data until the window refills.

    def snapshot(self, path: str) -> None:
        """Atomically write every series (and JSON-serializable KV
        entries) to ``path`` (.npz).  Same tmp+``os.replace`` pattern as
        the prediction checkpoints (prediction_server.py)."""
        with self._lock:
            keys = [
                {"metric": m, "labels": dict(lbl)}
                for m, lbl in self._series
            ]
            rings = list(self._series.values())
            arrays = {
                "ts": (np.stack([r.ts for r in rings])
                       if rings else np.zeros((0, self.capacity))),
                "values": (np.stack([r.values for r in rings])
                           if rings else np.zeros((0, self.capacity))),
                "head": np.asarray([r.head for r in rings], np.int64),
                "count": np.asarray([r.count for r in rings], np.int64),
            }
            kv = {}
            for k, v in self._kv.items():
                try:
                    if json.loads(json.dumps(v)) != v:
                        # JSON round-trip changed the shape (int dict
                        # keys become strings, tuples become lists) — a
                        # restored value that differs from the stored one
                        # would break consumers until the next collect;
                        # skip it like the opaque objects below
                        continue
                except (TypeError, ValueError):
                    continue   # opaque objects (topology structs) rebuild
                kv[k] = v      # from collection after restart
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # unique tmp per call: the interval snapshot (tick thread) and the
        # stop() shutdown snapshot can run concurrently; a shared tmp name
        # would interleave writers and os.replace a corrupt file
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, keys=np.asarray(json.dumps(keys)),
                    kv=np.asarray(json.dumps(kv)), **arrays)
            os.replace(tmp, path)
        except BaseException:
            # a failed write (full/readonly disk) must not strand a
            # uniquely-named tmp per incarnation in var_run_root
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def restore(self, path: str) -> bool:
        """Load a snapshot written by :meth:`snapshot`; False (and start
        fresh) when absent or corrupt — a bad snapshot must never brick
        agent startup.  A capacity change across restart keeps the newest
        ``capacity`` samples per series."""
        try:
            if not os.path.exists(path):
                return False
            with np.load(path, allow_pickle=False) as z:
                keys = json.loads(str(z["keys"]))
                kv = json.loads(str(z["kv"]))
                ts, values = z["ts"], z["values"]
                head, count = z["head"], z["count"]
            series: dict[tuple, _Ring] = {}
            for i, key in enumerate(keys):
                ring = _Ring(self.capacity)
                cnt, hd = int(count[i]), int(head[i])
                cap_stored = ts.shape[1]
                # chronological order: oldest sample first
                if cnt < cap_stored:
                    idx = np.arange(cnt)
                else:
                    idx = np.arange(hd, hd + cap_stored) % cap_stored
                idx = idx[-self.capacity:]
                n = len(idx)
                ring.ts[:n] = ts[i, idx]
                ring.values[:n] = values[i, idx]
                ring.count = n
                ring.head = n % self.capacity
                series[_series_key(key["metric"], key["labels"])] = ring
        except Exception:  # noqa: BLE001 — truncated/corrupt npz (zip
            # errors, bad JSON) => start fresh
            return False
        with self._lock:
            self._series = series
            for k, v in kv.items():
                self._kv.setdefault(k, v)
        return True

    # -- KV (device info, NUMA topology, etc.) --

    def set_kv(self, key: str, value: object) -> None:
        with self._lock:
            self._kv[key] = value

    def get_kv(self, key: str, default=None):
        with self._lock:
            return self._kv.get(key, default)
