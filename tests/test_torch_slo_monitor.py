"""Parity of the port's SLO burn-rate engine
(``koordinator_tpu_torch/slo_monitor.py``) with the JAX package's: the same
observations on a registry of each package, sampled and evaluated on a fake
clock, give the same reports (windowed bad fractions, burn rates, no-data
states, the fire/clear hysteresis, peak burns, breach counters) and the same
gauges; ``default_specs`` and ``tenant_slo_specs`` give the same specs, each
naming a series the port registers; ``sample_once`` caches the same series;
and the background sampler starts and stops.  Mirrors
tests/test_slo_monitor.py's cases; its end-to-end breach through a port
scheduler is in tests/test_torch_http_gateway.py.
"""

import dataclasses
import time

import pytest

from tests.torch_parity import PKGS, reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def pkg_mods(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import metrics, slo_monitor
    else:
        from koordinator_tpu_torch import metrics, slo_monitor
    return metrics, slo_monitor


class FakeClock:
    def __init__(self, t=10_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def latency_spec(slo, **kw):
    defaults = dict(
        name="lat", description="p99 latency", kind=slo.KIND_LATENCY,
        metric="t_lat_seconds", threshold=0.2, objective=0.01,
        fast=slo.BurnWindow(window_s=60.0, fire_burn=14.4),
        slow=slo.BurnWindow(window_s=600.0, fire_burn=1.0))
    defaults.update(kw)
    return slo.SloSpec(**defaults)


def window_math(pkg: str) -> list:
    """The latency spec over bucket deltas (interpolated, across label
    sets, past the last bound, single sample), the gauge spec's time above
    threshold and the ratio spec (and its zero denominator)."""
    metrics, slo = pkg_mods(pkg)
    out = []
    for buckets, seed, obs, kw in (
            ((0.1, 0.25, 1.0), [0.01] * 100, [0.05] * 90 + [0.9] * 10, {}),
            ((0.1, 0.3, 1.0), [0.15], [0.15] * 100, {}),
            ((0.1, 1.0), [0.05], [0.05, 5.0], {"threshold": 1.0}),
            ((0.1, 1.0), [0.05], [], {})):
        reg = metrics.Registry("t")
        h = reg.histogram("lat_seconds", buckets=buckets)
        clock = FakeClock()
        mon = slo.SloMonitor(specs=[latency_spec(slo, **kw)],
                             registries=(reg,), clock=clock)
        for v in seed:
            h.observe(v)
        mon.sample_once()
        for v in obs:
            h.observe(v)
        clock.tick(10.0)
        out.append(mon.tick())
    reg = metrics.Registry("t")
    h = reg.histogram("lat_seconds", buckets=(0.1, 0.2, 1.0))
    clock = FakeClock()
    mon = slo.SloMonitor(specs=[latency_spec(slo)], registries=(reg,),
                         clock=clock)
    h.observe(0.05, labels={"phase": "Solve"})
    h.observe(0.9, labels={"phase": "Bind"})
    mon.sample_once()
    h.observe(0.05, labels={"phase": "Solve"})
    h.observe(0.9, labels={"phase": "Bind"})
    clock.tick(5.0)
    out.append(mon.tick())

    reg = metrics.Registry("t")
    g = reg.gauge("staleness_seconds")
    clock = FakeClock()
    spec = slo.SloSpec(
        name="stale", description="d", kind=slo.KIND_GAUGE,
        metric="t_staleness_seconds", threshold=30.0, objective=0.05,
        fast=slo.BurnWindow(window_s=100.0, fire_burn=14.4),
        slow=slo.BurnWindow(window_s=1000.0, fire_burn=1.0))
    mon = slo.SloMonitor(specs=[spec], registries=(reg,), clock=clock)
    for value in (1.0, 1.0, 45.0, 50.0):
        g.set(value)
        mon.sample_once()
        clock.tick(10.0)
    out.append(mon.evaluate())

    for rounds_inc, shed_inc in ((50, 2), (0, 0)):
        reg = metrics.Registry("t")
        shed = reg.counter("sheds_total")
        rounds = reg.counter("rounds_total")
        clock = FakeClock()
        spec = slo.SloSpec(
            name="shed", description="d", kind=slo.KIND_RATIO,
            metric="t_sheds_total", denominator="t_rounds_total",
            objective=0.01,
            fast=slo.BurnWindow(window_s=100.0, fire_burn=14.4),
            slow=slo.BurnWindow(window_s=1000.0, fire_burn=1.0))
        mon = slo.SloMonitor(specs=[spec], registries=(reg,), clock=clock)
        shed.inc(0)
        rounds.inc(0)
        mon.sample_once()
        rounds.inc(rounds_inc)
        shed.inc(shed_inc)
        clock.tick(10.0)
        out.append(mon.tick())
    return out


def test_window_math_matches():
    assert window_math("torch") == window_math("jax")


def alert_machine(pkg: str) -> list:
    """Fire, no re-fire while burning, recovery and clear; a burn under the
    page threshold; an on_breach observer that raises; the burn gauges."""
    metrics, slo = pkg_mods(pkg)
    out = []
    for bad, good, hook in ((10, 0, "record"), (5, 95, "record"),
                            (10, 0, "raise")):
        reg = metrics.Registry("t")
        h = reg.histogram("lat_seconds", buckets=(0.1, 0.25, 1.0))
        clock = FakeClock()
        fired = []

        def on_breach(spec, doc, hook=hook, fired=fired):
            if hook == "raise":
                raise RuntimeError("observer bug")
            fired.append(spec.name)

        mon = slo.SloMonitor(specs=[latency_spec(slo)], registries=(reg,),
                             clock=clock, on_breach=on_breach)
        h.observe(0.01)
        mon.sample_once()
        for _ in range(good):
            h.observe(0.01)
        for _ in range(bad):
            h.observe(0.9)
        clock.tick(5.0)
        out.append(mon.tick())
        clock.tick(5.0)
        out.append(mon.tick())
        for _ in range(30):
            h.observe(0.01)
            clock.tick(5.0)
            report = mon.tick()
        out.append(report)
        out.append(fired)
        out.append(sorted(metrics.slo_alerts_total.items(),
                          key=lambda kv: sorted(kv[0].items())))
        out.append(sorted(metrics.slo_burn_rate.items(),
                          key=lambda kv: sorted(kv[0].items())))
        metrics.reset_all_for_tests()
    return out


def test_alert_state_machine_matches():
    assert alert_machine("torch") == alert_machine("jax")


def test_default_specs_match_and_name_port_series():
    from koordinator_tpu import slo_monitor as jslo

    from koordinator_tpu_torch import metrics
    from koordinator_tpu_torch import slo_monitor as tslo

    for kw in ({}, {"latency_threshold_s": 0.5,
                    "staleness_threshold_s": 12.0}):
        got = [dataclasses.asdict(s) for s in tslo.default_specs(**kw)]
        want = [dataclasses.asdict(s) for s in jslo.default_specs(**kw)]
        assert got == want
    assert ([dataclasses.asdict(s) for s in tslo.tenant_slo_specs(["a", "b"])]
            == [dataclasses.asdict(s)
                for s in jslo.tenant_slo_specs(["a", "b"])])
    known = set()
    for reg in metrics.ALL_REGISTRIES:
        for full, m in reg.items():
            known.add(full)
            if isinstance(m, metrics.Histogram):
                known.add(f"{full}_count")
    for spec in tslo.default_specs():
        base = (spec.metric[: -len("_count")]
                if spec.metric.endswith("_count") else spec.metric)
        assert spec.metric in known or base in known, spec.metric
        if spec.denominator:
            assert spec.denominator in known, spec.denominator


def sampled(pkg: str) -> list:
    metrics, slo = pkg_mods(pkg)
    reg = metrics.Registry("s")
    reg.counter("c_total").inc(3, {"a": "b"})
    reg.gauge("g").set(7.0)
    reg.histogram("h_seconds", buckets=(0.1, 1.0)).observe(0.05)
    mon = slo.SloMonitor(specs=[], registries=(reg,), clock=FakeClock())
    out = [mon.sample_once()]
    for name in ("s_c_total", "s_g", "s_h_seconds_bucket",
                 "s_h_seconds_count", "s_h_seconds_sum"):
        out.append((name, mon.cache.series_labels(name),
                    [mon.cache.query(name, lbl).latest()
                     for lbl in mon.cache.series_labels(name)]))
    return out


def test_sample_once_matches():
    assert sampled("torch") == sampled("jax")


@pytest.mark.parametrize("pkg", PKGS)
def test_background_sampler_start_stop(pkg):
    metrics, slo = pkg_mods(pkg)
    reg = metrics.Registry("bg")
    reg.gauge("g").set(1.0)
    mon = slo.SloMonitor(specs=[], registries=(reg,), sample_interval_s=0.01)
    mon.start()
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if not mon.cache.query("bg_g").empty:
                break
            time.sleep(0.01)
        assert not mon.cache.query("bg_g").empty
    finally:
        mon.stop()
    assert mon._thread is None
