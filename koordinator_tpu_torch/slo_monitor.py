"""SLO burn-rate engine: the scheduler evaluating its own latency SLO
(port of ``koordinator_tpu/slo_monitor.py``, copied whole).

The paper's headline target is a hard latency SLO (50k pods x 10k nodes
under 200ms p99), but until this module nothing in the tree could answer
"are we inside budget right now".  The engine is self-contained — no
external Prometheus:

1. **Sampling.** Every instrument of the in-process metric registries
   (``metrics.ALL_REGISTRIES``) is sampled on an interval into a
   :class:`~koordinator_tpu_torch.koordlet.metriccache.MetricCache` — the same
   numpy-ring/AggregateResult machinery the koordlet's metricsadvisor
   uses for NodeMetric aggregation windows, with query-time retention
   and mean-per-bin downsampling for the slow window.  Counters and
   gauges sample per label set under their exposition name; histograms
   sample ``<name>_bucket`` (per finite ``le``), ``<name>_count`` and
   ``<name>_sum``, so windowed quantiles come from cumulative-count
   deltas exactly like PromQL's ``rate()`` + ``histogram_quantile``.

2. **Burn rates.**  Each :class:`SloSpec` declares an allowed bad
   fraction (the error budget) and evaluates two windows (fast 5m,
   slow 1h by default).  ``burn = bad_fraction / objective``: 1.0 burns
   exactly the budget, 14.4 on the fast window is the classic page-now
   threshold.  Three spec kinds cover the shipped SLOs:

   - ``latency``  — histogram observations above ``threshold`` are bad
     (bucket-interpolated via ``metrics.count_at_or_below``);
   - ``gauge``    — sampled values above ``threshold`` are bad
     (time-in-state budgets: staleness, degraded mode);
   - ``ratio``    — windowed counter delta over a denominator's delta
     (event-rate budgets: solve sheds per round).

3. **Alerts.**  A fast window burning at/above its fire threshold
   flips the SLO breached: ``slo_alerts_total{slo, phase="fire"}``
   increments, ``slo_breached{slo}`` raises, the ``on_breach`` callback
   runs (the scheduler wires the flight recorder's dump there), and the
   breach is served at ``/debug/slo`` on the DebugService and the HTTP
   gateway.  The alert clears with hysteresis: only once the fast burn
   drops below ``clear_ratio * fire`` (so a burn hovering at the
   threshold cannot flap), firing ``phase="clear"``.

Reference anchors: koordinator's node-side self-monitoring treats
metricsadvisor -> metriccache -> NodeMetric aggregation windows as a
first-class subsystem; windowed percentile evaluation as the control
signal follows "A Predictive Autoscaler for Elastic Batch Jobs"
(PAPERS.md); multi-window multi-burn-rate alerting per the SRE workbook.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Iterable, Optional

from koordinator_tpu_torch import metrics
from koordinator_tpu_torch.koordlet.metriccache import MetricCache

logger = logging.getLogger("koordinator_tpu_torch.slo")

KIND_LATENCY = "latency"
KIND_GAUGE = "gauge"
KIND_RATIO = "ratio"


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One evaluation window: how far back, and the burn rate at which
    it counts as breaching."""

    window_s: float
    fire_burn: float


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative SLO over the sampled registry metrics."""

    name: str
    description: str
    kind: str                   # latency | gauge | ratio
    metric: str                 # full exposition name (with registry prefix)
    objective: float            # allowed bad fraction (the error budget)
    threshold: float = 0.0      # latency bound / gauge bound (kind-specific)
    denominator: str | None = None   # ratio kind: the total-events counter
    fast: BurnWindow = BurnWindow(window_s=300.0, fire_burn=14.4)
    slow: BurnWindow = BurnWindow(window_s=3600.0, fire_burn=1.0)
    #: hysteresis: a firing alert clears only once the fast burn drops
    #: below ``clear_ratio * fast.fire_burn``
    clear_ratio: float = 0.5
    #: mean-per-bin resolution for slow-window gauge aggregation
    #: (0 = raw samples)
    slow_resolution_s: float = 10.0
    #: label filter as sorted (key, value) pairs: only series carrying
    #: ALL of these labels count toward the spec (the per-tenant p99
    #: SLO slices one shared histogram by {tenant=...}); empty = every
    #: label set aggregates, the pre-tenancy behavior
    label_filter: tuple = ()

    def matches_labels(self, labels: dict | None) -> bool:
        if not self.label_filter:
            return True
        if not labels:
            return False
        return all(labels.get(k) == v for k, v in self.label_filter)


def default_specs(latency_threshold_s: float = 0.2,
                  staleness_threshold_s: float = 30.0) -> list[SloSpec]:
    """The shipped scheduler SLOs (the paper's target plus the PR 2
    robustness machinery's health budgets)."""
    return [
        SloSpec(
            name="scheduling_latency_p99",
            description=(f"99% of scheduling-phase observations under "
                         f"{latency_threshold_s * 1000:g}ms (the paper's "
                         "p99 target evaluated per phase observation)"),
            kind=KIND_LATENCY,
            metric="koord_scheduler_scheduling_duration_seconds",
            threshold=latency_threshold_s,
            objective=0.01,
        ),
        SloSpec(
            name="snapshot_staleness",
            description=(f"sync-feed age stays under "
                         f"{staleness_threshold_s:g}s at least 95% of "
                         "the time"),
            kind=KIND_GAUGE,
            metric="koord_scheduler_state_staleness_seconds",
            threshold=staleness_threshold_s,
            objective=0.05,
        ),
        SloSpec(
            name="degraded_time",
            description="degraded-mode time budget: under 1% of time",
            kind=KIND_GAUGE,
            metric="koord_scheduler_degraded_mode",
            threshold=0.5,
            objective=0.01,
        ),
        SloSpec(
            name="pod_e2e_p99",
            description=(f"per-pod journey e2e p99 stays under "
                         f"{latency_threshold_s * 1000:g}ms at least 99% "
                         "of the time (journey-ledger sketch quantiles — "
                         "true arrival-to-ack per-pod latency, not "
                         "round-bucket interpolation; the gauge refreshes "
                         "from the ledger each monitor sweep and the "
                         "budget burns only while it sits over the bar)"),
            kind=KIND_GAUGE,
            metric="koord_scheduler_pod_journey_latency_seconds",
            threshold=latency_threshold_s,
            objective=0.01,
            label_filter=(("q", "0.99"), ("stage", "e2e")),
        ),
        SloSpec(
            name="solve_shed_rate",
            description="under 1% of solve rounds shed on deadline",
            kind=KIND_RATIO,
            metric="koord_scheduler_solve_deadline_shed_total",
            denominator="koord_scheduler_solver_batch_duration_"
                        "seconds_count",
            objective=0.01,
        ),
    ]


def tenant_slo_specs(tenant_names, latency_threshold_s: float = 0.2
                     ) -> list[SloSpec]:
    """Per-tenant p99 latency SLOs: one spec per tenant,
    slicing the SHARED ``scheduling_duration_seconds`` histogram by its
    ``{tenant=...}`` label — so one cluster blowing its budget pages as
    that tenant, not as a mushed global p99."""
    return [
        SloSpec(
            name=f"tenant_{name}_latency_p99",
            description=(f"tenant {name}: 99% of scheduling-phase "
                         f"observations under "
                         f"{latency_threshold_s * 1000:g}ms"),
            kind=KIND_LATENCY,
            metric="koord_scheduler_scheduling_duration_seconds",
            threshold=latency_threshold_s,
            objective=0.01,
            label_filter=(("tenant", str(name)),),
        )
        for name in tenant_names
    ]


@dataclasses.dataclass
class _SloState:
    breached: bool = False
    breaches_total: int = 0
    last_fired: float | None = None
    last_cleared: float | None = None
    #: worst burn rate ever observed per window (the soak summary's
    #: "per-SLO worst burn")
    peak_burn: dict = dataclasses.field(
        default_factory=lambda: {"fast": 0.0, "slow": 0.0})


class SloMonitor:
    """Samples the metric registries into ring series and evaluates the
    SLO specs' multi-window burn rates.

    Drive it with :meth:`start` (background thread at
    ``sample_interval_s``) or manually with :meth:`tick` — tests and the
    on-demand ``/debug/slo`` path do the latter, so everything works
    with a fake clock and no thread.
    """

    def __init__(
        self,
        specs: Iterable[SloSpec] | None = None,
        registries: Iterable[metrics.Registry] = metrics.ALL_REGISTRIES,
        sample_interval_s: float = 5.0,
        clock=time.time,
        on_breach: Optional[Callable[[SloSpec, dict], None]] = None,
        cache: MetricCache | None = None,
        capacity_per_series: int = 4096,
        pre_sample: Iterable[Callable[[], None]] = (),
    ):
        self.specs = list(specs) if specs is not None else default_specs()
        self.registries = tuple(registries)
        self.sample_interval_s = sample_interval_s
        self.clock = clock
        #: called on each fire transition as ``on_breach(spec, report)``
        #: — the scheduler wires the flight recorder's dump here.  A
        #: callback exception must never kill the sampler.
        self.on_breach = on_breach
        slow_max = max((s.slow.window_s for s in self.specs), default=3600.0)
        self.cache = cache if cache is not None else MetricCache(
            capacity_per_series=capacity_per_series, clock=clock,
            retention_sec=slow_max * 1.25)
        #: hooks run at the top of every sample sweep, BEFORE the
        #: registries are read — the self-telemetry gauges (RSS, fds,
        #: threads) refresh here so even on-demand /debug/slo and
        #: /debug/steady requests sample current process state.  A hook
        #: exception must never kill the sweep.
        self.pre_sample = list(pre_sample)
        self._state = {spec.name: _SloState() for spec in self.specs}
        self._last_report: dict | None = None
        self._lock = threading.Lock()
        #: serializes the fire/clear state machine: on-demand
        #: /debug/slo requests arrive on gateway threads (ThreadingHTTP
        #: server), and two concurrent evaluations of the same burn
        #: must not both see breached=False and double-fire the alert
        #: (and its on_breach flight dump)
        self._eval_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling ------------------------------------------------------------

    def sample_once(self, now: float | None = None) -> int:
        """One sweep over every registry instrument into the ring
        cache; returns samples appended."""
        now = self.clock() if now is None else now
        for hook in self.pre_sample:
            try:
                hook()
            except Exception:  # noqa: BLE001 — observer, never fatal
                logger.exception("SLO pre-sample hook failed")
        appended = 0
        for reg in self.registries:
            for _, m in reg.items():
                if isinstance(m, metrics.Histogram):
                    for labels, counts, total, total_sum in m.state():
                        for bound, c in zip(m.buckets, counts):
                            self.cache.append(
                                f"{m.name}_bucket", float(c),
                                labels={**labels, "le": f"{bound:g}"},
                                ts=now)
                            appended += 1
                        self.cache.append(f"{m.name}_count", float(total),
                                          labels=labels, ts=now)
                        self.cache.append(f"{m.name}_sum", float(total_sum),
                                          labels=labels, ts=now)
                        appended += 2
                elif isinstance(m, metrics.Counter):   # Gauge subclasses it
                    for labels, value in m.items():
                        self.cache.append(m.name, float(value),
                                          labels=labels, ts=now)
                        appended += 1
        return appended

    # -- windowed math -------------------------------------------------------

    def _window_delta(self, metric: str, labels: dict | None,
                      start: float, end: float) -> float | None:
        """Cumulative-counter delta over [start, end]; None = fewer than
        two samples (no rate is computable).  A negative delta means the
        counter reset mid-window (tests, process restart): the post-reset
        last value is the best available estimate."""
        res = self.cache.query(metric, labels, start=start, end=end)
        if res.count < 2:
            return None
        delta = res.latest() - res.first()
        return delta if delta >= 0 else res.latest()

    def _latency_window(self, spec: SloSpec, start: float, end: float):
        """(bad_fraction, total_delta, p_est) aggregated over every
        label set of the histogram (PromQL ``sum by (le)``)."""
        bucket_metric = f"{spec.metric}_bucket"
        per_le: dict[float, float] = {}
        for labels in self.cache.series_labels(bucket_metric):
            le = labels.get("le")
            if le is None or not spec.matches_labels(labels):
                continue
            delta = self._window_delta(bucket_metric, labels, start, end)
            if delta is None:
                continue
            per_le[float(le)] = per_le.get(float(le), 0.0) + delta
        total = 0.0
        saw_count = False
        for labels in self.cache.series_labels(f"{spec.metric}_count"):
            if not spec.matches_labels(labels):
                continue
            delta = self._window_delta(f"{spec.metric}_count", labels,
                                       start, end)
            if delta is not None:
                total += delta
                saw_count = True
        if not saw_count or not per_le:
            return None, 0.0, 0.0
        bounds = sorted(per_le)
        cum = [per_le[b] for b in bounds]
        if total <= 0:
            return None, 0.0, 0.0
        good = metrics.count_at_or_below(bounds, cum, total, spec.threshold)
        bad_fraction = max(0.0, min(1.0, (total - good) / total))
        p_est = metrics.quantile_from_buckets(bounds, cum, total, 0.99)
        return bad_fraction, total, p_est

    def _gauge_window(self, spec: SloSpec, start: float, end: float,
                      resolution_s: float):
        """Fraction of sampled time above the threshold, over all label
        sets of the gauge."""
        bad = 0.0
        total = 0.0
        label_sets = self.cache.series_labels(spec.metric) or [None]
        for labels in label_sets:
            if not spec.matches_labels(labels):
                continue
            res = self.cache.query(spec.metric, labels, start=start, end=end)
            if resolution_s > 0:
                res = res.downsample(resolution_s)
            if res.empty:
                continue
            bad += float((res.values > spec.threshold).sum())
            total += res.count
        if total == 0:
            return None, 0.0
        return bad / total, total

    def _ratio_window(self, spec: SloSpec, start: float, end: float):
        num = 0.0
        saw_num = False
        for labels in self.cache.series_labels(spec.metric) or [None]:
            if not spec.matches_labels(labels):
                continue
            delta = self._window_delta(spec.metric, labels, start, end)
            if delta is not None:
                num += delta
                saw_num = True
        den = 0.0
        for labels in (self.cache.series_labels(spec.denominator or "")
                       or [None]):
            delta = self._window_delta(spec.denominator, labels, start, end)
            if delta is not None:
                den += delta
        if not saw_num or den <= 0:
            return None, den
        return max(0.0, min(1.0, num / den)), den

    def _evaluate_window(self, spec: SloSpec, window: BurnWindow,
                         which: str, now: float) -> dict:
        start = now - window.window_s
        extra: dict = {}
        if spec.kind == KIND_LATENCY:
            bad, total, p99 = self._latency_window(spec, start, now)
            extra = {"events": total, "p99_s": p99}
        elif spec.kind == KIND_GAUGE:
            resolution = (spec.slow_resolution_s if which == "slow" else 0.0)
            bad, total = self._gauge_window(spec, start, now, resolution)
            extra = {"samples": total}
        elif spec.kind == KIND_RATIO:
            bad, den = self._ratio_window(spec, start, now)
            extra = {"denominator": den}
        else:
            raise ValueError(f"unknown SLO kind {spec.kind!r}")
        burn = (bad / spec.objective) if bad is not None else 0.0
        return {
            "window_s": window.window_s,
            "fire_burn": window.fire_burn,
            "bad_fraction": bad,
            "burn_rate": burn,
            "no_data": bad is None,
            **extra,
        }

    # -- evaluation + alert state machine ------------------------------------

    def evaluate(self, now: float | None = None) -> dict:
        """Evaluate every spec's windows, run the fire/clear state
        machine, and return (and retain) the ``/debug/slo`` body."""
        now = self.clock() if now is None else now
        with self._eval_lock:
            return self._evaluate_locked(now)

    def _evaluate_locked(self, now: float) -> dict:
        slos = []
        for spec in self.specs:
            state = self._state[spec.name]
            windows = {
                "fast": self._evaluate_window(spec, spec.fast, "fast", now),
                "slow": self._evaluate_window(spec, spec.slow, "slow", now),
            }
            for which, win in windows.items():
                metrics.slo_burn_rate.set(
                    win["burn_rate"],
                    labels={"slo": spec.name, "window": which})
                state.peak_burn[which] = max(state.peak_burn[which],
                                             win["burn_rate"])
            fast = windows["fast"]
            fired_now = False
            if (not state.breached and not fast["no_data"]
                    and fast["burn_rate"] >= spec.fast.fire_burn):
                state.breached = True
                state.breaches_total += 1
                state.last_fired = now
                fired_now = True
                metrics.slo_breached.set(1.0, labels={"slo": spec.name})
                metrics.slo_alerts_total.inc(
                    labels={"slo": spec.name, "phase": "fire"})
                logger.warning(
                    "SLO %s breached: fast burn %.1f >= %.1f (%s)",
                    spec.name, fast["burn_rate"], spec.fast.fire_burn,
                    spec.description)
            elif state.breached and (fast["burn_rate"]
                                     < spec.clear_ratio
                                     * spec.fast.fire_burn):
                # hysteresis exit — also reached when the window drained
                # entirely (no_data evaluates as burn 0: no events means
                # no budget is burning)
                state.breached = False
                state.last_cleared = now
                metrics.slo_breached.set(0.0, labels={"slo": spec.name})
                metrics.slo_alerts_total.inc(
                    labels={"slo": spec.name, "phase": "clear"})
                logger.warning("SLO %s recovered: fast burn %.2f",
                               spec.name, fast["burn_rate"])
            doc = {
                "name": spec.name,
                "description": spec.description,
                "kind": spec.kind,
                "metric": spec.metric,
                "objective": spec.objective,
                "threshold": spec.threshold,
                "breached": state.breached,
                "breaches_total": state.breaches_total,
                "last_fired": state.last_fired,
                "last_cleared": state.last_cleared,
                "peak_burn": dict(state.peak_burn),
                "windows": windows,
            }
            slos.append(doc)
            if fired_now and self.on_breach is not None:
                try:
                    self.on_breach(spec, doc)
                except Exception:  # noqa: BLE001 — observer, never fatal
                    logger.exception("SLO on_breach callback failed")
        report = {
            "evaluated_at": now,
            "breached": [d["name"] for d in slos if d["breached"]],
            "slos": slos,
        }
        with self._lock:
            self._last_report = report
        return report

    def tick(self, now: float | None = None) -> dict:
        self.sample_once(now)
        return self.evaluate(now)

    def report(self) -> dict:
        """The latest evaluation; with no background sampler running,
        evaluates on demand (each request adds one sample, so repeated
        scrapes of ``/debug/slo`` build the window organically)."""
        if self._thread is None:
            return self.tick()
        with self._lock:
            report = self._last_report
        return report if report is not None else self.tick()

    # -- background sampler --------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.sample_interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — observer thread
                    logger.exception("SLO sampler tick failed")

        self._thread = threading.Thread(
            target=loop, name="slo-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)
