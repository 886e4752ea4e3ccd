"""Parity of the port's trend engine (``koordinator_tpu_torch/trend.py``)
with the JAX package's: ``fit_slope`` on the same shapes (constant, linear,
noisy, step, sawtooth, degenerate, unsorted) gives the same fits;
``classify`` the same verdicts on each shape against the same spec; the
engine over each package's MetricCache the same reports and gauges (a
leaking series, per-label-set verdicts, the cached report); both engines
flag a planted thread leak from the self-telemetry gauges and pass the
reaped one; and the default specs are the same.  Mirrors
tests/test_trend.py.
"""

import dataclasses
import threading

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def mods(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import metrics, selftelemetry, trend
        from koordinator_tpu.koordlet import metriccache
    else:
        from koordinator_tpu_torch import metrics, selftelemetry, trend
        from koordinator_tpu_torch.koordlet import metriccache
    return metrics, trend, metriccache, selftelemetry


def shapes() -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(9)
    t = np.arange(200, dtype=float) * 10.0
    return [
        (t, np.full(200, 7.0)),
        (t, 3.0 + 0.25 * t),
        (t, 3.0 + 0.25 * t + rng.normal(0, 20, 200)),
        (t, np.where(t < 1000, 5.0, 50.0)),
        (t, (np.arange(200) % 20) * 5.0),
        (t, rng.normal(100, 30, 200)),
        (t[::-1].copy(), (3.0 + 0.25 * t)[::-1].copy()),
        (t[:1], np.ones(1)),
        (np.zeros(5), np.arange(5, dtype=float)),
        (np.zeros(0), np.zeros(0)),
        (t, -0.5 * t),
    ]


def fits(pkg: str) -> list:
    _, trend, _, _ = mods(pkg)
    spec = trend.TrendSpec("s", abs_floor=10.0, max_rate_per_hour=100.0,
                           min_samples=4)
    out = []
    for ts, values in shapes():
        fit = trend.fit_slope(ts, values)
        out.append(None if fit is None else dataclasses.asdict(fit))
        if len(ts) >= 2 and ts.max() > ts.min():
            mid = ts.min() + (ts.max() - ts.min()) / 2
            lo = ts <= mid
            halves = (trend.fit_slope(ts[lo], values[lo]),
                      trend.fit_slope(ts[~lo], values[~lo]))
            out.append(trend.classify(spec, fit, halves))
        else:
            out.append(trend.classify(spec, fit, (None, None)))
    return out


def test_fit_and_classify_match():
    assert fits("torch") == fits("jax")


def engine_script(pkg: str) -> list:
    metrics, trend, mc, _ = mods(pkg)
    out = []
    now = [1000.0]
    spec = trend.TrendSpec("q_depth", abs_floor=10.0,
                           max_rate_per_hour=100.0, min_samples=4)
    cache = mc.MetricCache(clock=lambda: now[0])
    engine = trend.TrendEngine(cache, specs=[spec], window_s=600.0,
                               clock=lambda: now[0])
    for i in range(60):
        cache.append("q_depth", float(i * 5), ts=1000.0 + i * 10)
    now[0] = 1000.0 + 59 * 10
    out.append(engine.evaluate())
    out.append(engine.report() is engine.report())
    out.append(metrics.trend_verdict.items())
    out.append(metrics.trend_slope_per_hour.items())
    spec = trend.TrendSpec("rss", abs_floor=10.0, max_rate_per_hour=100.0,
                           min_samples=4)
    cache = mc.MetricCache(clock=lambda: now[0])
    engine = trend.TrendEngine(cache, specs=[spec], window_s=600.0,
                               clock=lambda: now[0])
    for i in range(30):
        ts = 1000.0 + i * 10
        cache.append("rss", 5.0, labels={"binary": "a"}, ts=ts)
        cache.append("rss", float(i * 10), labels={"binary": "b"}, ts=ts)
    now[0] = 1000.0 + 29 * 10
    out.append(engine.evaluate())
    out.append(engine.evaluate(window_s=100.0))
    out.append([dataclasses.asdict(s) for s in trend.default_trend_specs()])
    return out


def test_engine_reports_match():
    got, want = engine_script("torch"), engine_script("jax")
    for doc in got + want:
        if isinstance(doc, dict):
            doc.pop("evaluated_at", None)
    assert got == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("leak", [True, False])
def test_planted_thread_leak(pkg, leak):
    """A toy service that parks a worker a request (``leak``) or reaps it:
    the classifier over the sampled self-telemetry flags the first and
    passes the second, on both packages."""
    metrics, trend, mc, st = mods(pkg)
    release = threading.Event()
    workers = []
    try:
        telemetry = st.SelfTelemetry(f"toy-{leak}")
        spec = trend.TrendSpec("koord_process_threads", abs_floor=8.0,
                               max_rate_per_hour=32.0, min_samples=8)
        cache = mc.MetricCache()
        engine = trend.TrendEngine(cache, specs=[spec], window_s=600.0)
        for i in range(24):
            t = threading.Thread(
                target=release.wait if leak else (lambda: None),
                daemon=True)
            t.start()
            if leak:
                workers.append(t)
            else:
                t.join(timeout=5.0)
            telemetry.sample()
            cache.append(
                "koord_process_threads",
                metrics.process_threads.value(
                    labels={"binary": f"toy-{leak}"}),
                labels={"binary": f"toy-{leak}"}, ts=1000.0 + i * 30.0)
        report = engine.evaluate(now=1000.0 + 23 * 30.0)
        assert bool(report["leaking"]) is leak, report["series"]
    finally:
        release.set()
        for t in workers:
            t.join(timeout=5.0)
