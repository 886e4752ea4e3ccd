"""Long-horizon trend engine: steady / drifting / leaking verdicts (port
of ``koordinator_tpu/trend.py``, copied whole).

The SLO burn-rate engine (slo_monitor.py) answers "are we inside budget
right now"; nothing answered "is this process leaking or drifting under
hours of churn" — the acceptance bar every scaling item (sharded solver, predictive
loop) is judged against.  This module is
that instrument:

1. **Slope fitting.**  :func:`fit_slope` runs an ordinary-least-squares
   fit over one windowed series (the same
   :class:`~koordinator_tpu_torch.koordlet.metriccache.AggregateResult`
   views the SLO engine queries).  Degenerate windows — empty, a single
   sample, zero time span — return ``None``, the no-verdict sentinel;
   a NaN must never reach a verdict table or a dashboard.

2. **Classification.**  Each :class:`TrendSpec` names one series (RSS,
   fds, threads, queue depth, deltasync backlog, ...) and two
   thresholds that BOTH must be exceeded before a series is non-steady:

   - ``abs_floor`` — absolute growth over the evaluated window below
     which the series is always ``steady`` (noise immunity: a 20-second
     smoke window must not flag 2 threads of jitter);
   - ``max_rate_per_hour`` — the fitted slope, scaled to units/hour,
     above which growth is pathological at ANY window length (a
     10-thread/hour leak is a leak whether the window is 30 minutes or
     6 hours).

   Growth past both thresholds in the spec's leak ``direction`` that is
   also *persistent* — both half-windows grow, the window ends above
   where it started, and the fit explains the data (``min_r2``) — is
   ``leaking``.  Threshold-exceeding growth that is not persistent
   (a step after a resync, a sawtooth's edge, a downward trend) is
   ``drifting``.  Everything else is ``steady``; unevaluable windows
   are ``no_data``.

3. **Engine.**  :class:`TrendEngine` layers on the SLO monitor's
   :class:`MetricCache`: every registered spec is evaluated over every
   label set present (so per-``binary`` self-telemetry series get
   per-binary verdicts), the verdicts land in the
   ``trend_verdict{series}`` / ``trend_slope_per_hour{series}`` gauges
   (dashboards), and the full report is served at ``/debug/steady`` on
   both debug surfaces and tabulated by ``tools/soak_report.py`` —
   which fails the soak on any ``leaking`` verdict.

Reference anchors: the koordlet's decaying-histogram pipeline
(prediction/histogram.py) is the in-process cheap-time-series-analysis
pattern this extends; "A Predictive Autoscaler for Elastic Batch Jobs"
(PAPERS.md) grounds the windowed-trend-as-control-signal idea.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Iterable, Mapping, Optional

import numpy as np

from koordinator_tpu_torch import metrics
from koordinator_tpu_torch.koordlet.metriccache import MetricCache

logger = logging.getLogger("koordinator_tpu_torch.trend")

VERDICT_STEADY = "steady"
VERDICT_DRIFTING = "drifting"
VERDICT_LEAKING = "leaking"
VERDICT_NO_DATA = "no_data"

#: gauge encoding of the verdicts (dashboards can threshold-color on
#: the value; the label carries the series name)
VERDICT_CODES = {
    VERDICT_NO_DATA: -1.0,
    VERDICT_STEADY: 0.0,
    VERDICT_DRIFTING: 1.0,
    VERDICT_LEAKING: 2.0,
}


@dataclasses.dataclass(frozen=True)
class SlopeFit:
    """One OLS fit over a windowed series (host scalars, JSON-able)."""

    n: int                 # samples fitted
    slope: float           # units per second
    intercept: float       # value at the window's first timestamp
    r2: float              # fraction of variance the line explains
    t_span: float          # seconds between first and last sample
    first: float           # value at the earliest timestamp
    last: float            # value at the latest timestamp
    mean: float

    @property
    def growth(self) -> float:
        """Fitted growth across the window (slope * span) — the
        quantity ``abs_floor`` bounds."""
        return self.slope * self.t_span


def fit_slope(ts, values) -> Optional[SlopeFit]:
    """OLS slope over one series; ``None`` (the no-verdict sentinel,
    never NaN) for windows that cannot support a fit: empty, a single
    sample, or all samples at one timestamp."""
    ts = np.asarray(ts, np.float64)
    values = np.asarray(values, np.float64)
    n = len(values)
    if n < 2:
        return None
    order = np.argsort(ts)
    ts, values = ts[order], values[order]
    t_span = float(ts[-1] - ts[0])
    if t_span <= 0:
        return None
    tc = ts - ts.mean()
    denom = float((tc * tc).sum())
    slope = float((tc * (values - values.mean())).sum() / denom)
    intercept = float(values.mean() - slope * (ts.mean() - ts[0]))
    fitted = intercept + slope * (ts - ts[0])
    ss_res = float(((values - fitted) ** 2).sum())
    ss_tot = float(((values - values.mean()) ** 2).sum())
    # a constant series is a PERFECT fit of its flat line, not an
    # undefined ratio — r2 must stay NaN-free for the verdict math
    r2 = 1.0 if ss_tot <= 0.0 else max(0.0, 1.0 - ss_res / ss_tot)
    return SlopeFit(n=n, slope=slope, intercept=intercept, r2=r2,
                    t_span=t_span, first=float(values[0]),
                    last=float(values[-1]), mean=float(values.mean()))


@dataclasses.dataclass(frozen=True)
class TrendSpec:
    """One series under long-horizon watch."""

    series: str                      # full exposition name in the cache
    #: None = evaluate every label set present independently (the
    #: per-binary self-telemetry series); a dict pins one label set
    labels: Optional[Mapping[str, str]] = None
    #: absolute growth across the window below which the series is
    #: always steady (in the series' own units)
    abs_floor: float = 0.0
    #: fitted slope (units/hour) above which growth is pathological
    max_rate_per_hour: float = 0.0
    #: which direction a LEAK grows ("up" for resources; "any" means
    #: the series can drift but never leak)
    direction: str = "up"
    #: below this many samples the window is no_data, not a verdict
    min_samples: int = 8
    #: a leak's fit must explain at least this much variance — a
    #: threshold-crossing slope through uncorrelated noise downgrades
    #: to drifting instead of paging as a leak
    min_r2: float = 0.25
    #: human context for the verdict table
    description: str = ""


def default_trend_specs(scale: float = 1.0) -> list[TrendSpec]:
    """The shipped leak watch: the process self-telemetry gauges every
    binary registers (selftelemetry.py) plus the queue-depth and
    deltasync-backlog series.  ``scale`` multiplies the absolute floors
    for bigger deployments (a 10k-node soak legitimately holds more
    pending pods than a 16-node smoke)."""
    mib = 1024.0 * 1024.0
    return [
        TrendSpec("koord_process_rss_bytes",
                  abs_floor=96 * mib * scale, max_rate_per_hour=256 * mib,
                  min_samples=12,
                  description="resident set size (proc statm)"),
        TrendSpec("koord_process_open_fds",
                  abs_floor=24 * scale, max_rate_per_hour=96,
                  description="open file descriptors"),
        TrendSpec("koord_process_threads",
                  abs_floor=8 * scale, max_rate_per_hour=32,
                  description="live Python threads"),
        TrendSpec("koord_process_alloc_blocks",
                  abs_floor=400_000 * scale, max_rate_per_hour=2_000_000,
                  min_samples=12,
                  description="interpreter-allocated memory blocks "
                              "(sys.getallocatedblocks)"),
        TrendSpec("koord_process_gc_objects",
                  abs_floor=200_000 * scale, max_rate_per_hour=1_000_000,
                  min_samples=12,
                  description="gc-tracked container objects"),
        TrendSpec("koord_scheduler_pending_pods",
                  abs_floor=max(64.0, 64 * scale),
                  max_rate_per_hour=600,
                  description="scheduler admission queue depth"),
        TrendSpec("koord_transport_sync_binding_backlog_peak",
                  abs_floor=max(64.0, 64 * scale), max_rate_per_hour=512,
                  description="deltasync local-binding backlog "
                              "high-water mark"),
        TrendSpec("koord_scheduler_solver_device_bytes",
                  abs_floor=128 * mib * scale, max_rate_per_hour=512 * mib,
                  description="device-resident solver tensors"),
    ]


def classify(spec: TrendSpec, fit: Optional[SlopeFit],
             half_fits: tuple[Optional[SlopeFit], Optional[SlopeFit]]
             = (None, None)) -> dict:
    """One spec's verdict over one fitted window (pure; unit-tested
    against constant/linear/noisy/step/sawtooth shapes)."""
    if fit is None or fit.n < spec.min_samples:
        return {"verdict": VERDICT_NO_DATA,
                "reason": ("no fit" if fit is None else
                           f"{fit.n} samples < min_samples "
                           f"{spec.min_samples}")}
    rate_per_hour = fit.slope * 3600.0
    doc = {
        "slope_per_sec": fit.slope,
        "rate_per_hour": rate_per_hour,
        "growth": fit.growth,
        "r2": fit.r2,
        "samples": fit.n,
        "window_span_s": fit.t_span,
        "first": fit.first,
        "last": fit.last,
    }
    exceeds = (abs(fit.growth) > spec.abs_floor
               and abs(rate_per_hour) > spec.max_rate_per_hour)
    if not exceeds:
        doc["verdict"] = VERDICT_STEADY
        return doc
    leakward = (fit.slope > 0 if spec.direction == "up"
                else fit.slope < 0 if spec.direction == "down"
                else False)
    sign = 1.0 if spec.direction != "down" else -1.0
    first_half, second_half = half_fits
    persistent = (
        leakward
        and fit.r2 >= spec.min_r2
        # the window must END displaced from where it started (a
        # sawtooth that returned home is churn, not a leak) ...
        and sign * (fit.last - fit.first) > spec.abs_floor
        # ... and BOTH halves must grow leakward: a step (resync,
        # capacity doubling) puts all its growth in one half
        and first_half is not None and second_half is not None
        and sign * first_half.slope > 0 and sign * second_half.slope > 0
    )
    doc["verdict"] = VERDICT_LEAKING if persistent else VERDICT_DRIFTING
    return doc


class TrendEngine:
    """Evaluates the registered specs' windowed slopes over a
    :class:`MetricCache` — normally the SLO monitor's, so one sampling
    pass feeds both burn rates and trends.

    Thread-safe the same way :class:`SloMonitor` is: evaluations
    serialize on one lock (on-demand ``/debug/steady`` requests arrive
    on gateway threads), and the latest report is retained for cheap
    re-reads.
    """

    def __init__(self, cache: MetricCache,
                 specs: Iterable[TrendSpec] | None = None,
                 window_s: float = 1800.0,
                 clock=time.time):
        self.cache = cache
        self.specs: list[TrendSpec] = (list(specs) if specs is not None
                                       else default_trend_specs())
        self.window_s = window_s
        self.clock = clock
        self._lock = threading.Lock()
        self._last_report: dict | None = None

    def register(self, spec: TrendSpec) -> None:
        with self._lock:
            self.specs.append(spec)

    # -- evaluation ----------------------------------------------------------

    def _evaluate_series(self, spec: TrendSpec,
                         labels: Mapping[str, str] | None,
                         start: float, end: float) -> dict:
        res = self.cache.query(spec.series, labels, start=start, end=end)
        fit = fit_slope(res.ts, res.values)
        halves: tuple[Optional[SlopeFit], Optional[SlopeFit]] = (None, None)
        if fit is not None and fit.t_span > 0:
            mid = float(np.min(res.ts)) + fit.t_span / 2.0
            lo = res.ts <= mid
            halves = (fit_slope(res.ts[lo], res.values[lo]),
                      fit_slope(res.ts[~lo], res.values[~lo]))
        doc = classify(spec, fit, halves)
        doc.update({
            "series": spec.series,
            "labels": dict(labels or {}),
            "abs_floor": spec.abs_floor,
            "max_rate_per_hour": spec.max_rate_per_hour,
            "description": spec.description,
        })
        return doc

    def evaluate(self, now: float | None = None,
                 window_s: float | None = None) -> dict:
        """Evaluate every spec over every present label set, publish the
        verdict gauges, and return (and retain) the ``/debug/steady``
        body."""
        now = self.clock() if now is None else now
        window = self.window_s if window_s is None else window_s
        start = now - window
        with self._lock:
            specs = list(self.specs)
        series_docs: list[dict] = []
        for spec in specs:
            label_sets: list = ([spec.labels] if spec.labels is not None
                                else self.cache.series_labels(spec.series)
                                or [None])
            for labels in label_sets:
                series_docs.append(
                    self._evaluate_series(spec, labels, start, now))
        counts = {v: 0 for v in VERDICT_CODES}
        for doc in series_docs:
            counts[doc["verdict"]] += 1
            # one gauge line per (series, labels): the label set rides
            # flattened so per-binary verdicts stay distinguishable
            glabels = {"series": doc["series"], **doc["labels"]}
            metrics.trend_verdict.set(VERDICT_CODES[doc["verdict"]],
                                      labels=glabels)
            metrics.trend_slope_per_hour.set(
                float(doc.get("rate_per_hour", 0.0)), labels=glabels)
            if doc["verdict"] == VERDICT_LEAKING:
                logger.warning(
                    "trend LEAK: %s%s growing %.3g/h over %.0fs "
                    "(r2=%.2f)", doc["series"], doc["labels"],
                    doc["rate_per_hour"], doc["window_span_s"], doc["r2"])
        report = {
            "evaluated_at": now,
            "window_s": window,
            "verdicts": counts,
            "leaking": [f"{d['series']}{d['labels'] or ''}"
                        for d in series_docs
                        if d["verdict"] == VERDICT_LEAKING],
            "drifting": [f"{d['series']}{d['labels'] or ''}"
                         for d in series_docs
                         if d["verdict"] == VERDICT_DRIFTING],
            "series": series_docs,
        }
        with self._lock:
            self._last_report = report
        return report

    def report(self) -> dict:
        """The latest evaluation; evaluates on demand when none is
        retained (the first ``/debug/steady`` request)."""
        with self._lock:
            last = self._last_report
        return last if last is not None else self.evaluate()
