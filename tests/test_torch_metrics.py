"""Parity of the port's ``metrics`` (``koordinator_tpu_torch/metrics.py``)
with the JAX package's: the same registries and instruments (names, types,
help texts, buckets), the same exposition text fresh and after the same
seeded observations (classic and OpenMetrics, exemplars included), and the
same bucket arithmetic (``quantile_from_buckets``, ``count_at_or_below``).

The port's help texts of ``round_flight_overwritten_total``,
``critical_path_seconds`` and ``wire_codec_duration_seconds`` drop the
reference project's work-item references; those three HELP lines are the
only lines allowed to differ.  A JAX module may register an instrument at
import (``koordlet/kubelet_stub.py``); the comparison reads the families
the port registers.
"""

import re

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_metrics():
    reset_observability()
    yield
    reset_observability()


REWORDED = ("koord_scheduler_round_flight_overwritten_total",
            "koord_scheduler_critical_path_seconds",
            "koord_transport_wire_codec_duration_seconds")


def families(body: str) -> dict[str, list[str]]:
    """{metric name -> its exposition lines} of a scrape body."""
    out: dict[str, list[str]] = {}
    name = None
    for line in body.splitlines():
        m = re.match(r"# HELP (\S+) ", line)
        if m:
            name = m.group(1)
            out[name] = []
        if name is not None:
            out[name].append(line)
    return out


def compare_bodies(got: str, want: str) -> None:
    g, w = families(got), families(want)
    assert set(g) <= set(w)
    assert [n for n in w if n in g] == list(g)   # the same order
    for name, lines in g.items():
        other = w[name]
        if name in REWORDED:
            assert lines[0].startswith(f"# HELP {name} ")
            assert lines[0] != other[0]
            lines, other = lines[1:], other[1:]
        assert lines == other, name


def test_registries_and_instruments_match():
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    assert [r.prefix for r in tm.ALL_REGISTRIES] == [
        r.prefix for r in jm.ALL_REGISTRIES]
    assert tm.DEFAULT_BUCKETS == jm.DEFAULT_BUCKETS
    for treg, jreg in zip(tm.ALL_REGISTRIES, jm.ALL_REGISTRIES):
        jitems = dict(jreg.items())
        for name, m in treg.items():
            jmet = jitems[name]
            assert (type(m).__name__, m.kind) == (type(jmet).__name__,
                                                  jmet.kind)
            if name not in REWORDED:
                assert m.help == jmet.help, name
            if isinstance(m, tm.Histogram):
                assert m.buckets == jmet.buckets
    # every module-level instrument handle of the JAX module exists
    jnames = {k for k, v in vars(jm).items() if isinstance(v, jm._Metric)}
    tnames = {k for k, v in vars(tm).items() if isinstance(v, tm._Metric)}
    assert tnames == jnames


@pytest.mark.parametrize("openmetrics", [False, True])
def test_fresh_exposition_equals_jax(openmetrics):
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    got = tm.expose_all(openmetrics=openmetrics)
    want = jm.expose_all(openmetrics=openmetrics)
    compare_bodies(got, want)
    assert got.endswith("# EOF\n") == openmetrics == want.endswith("# EOF\n")


def observe(mod, seed: int) -> None:
    """The same seeded observations into one package's instruments: label
    values needing escapes, exemplars, values past the last bucket."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        phase = str(rng.choice(["Solve", "Bind", 'odd"phase\\x\n']))
        v = float(rng.choice([rng.random() * 3, rng.random() * 30]))
        mod.scheduling_latency.observe(
            v, labels={"phase": phase},
            exemplar=({"trace_id": f"t{int(rng.integers(1e6))}"}
                      if rng.random() < 0.5 else None))
        mod.filter_reject_fraction.observe(
            float(rng.random()), labels={"reason": "fit_cpu"})
        mod.pods_enqueued_total.inc(float(rng.integers(1, 4)),
                                    labels={"tenant": f"t{seed}"})
        mod.pending_pods.set(float(rng.integers(0, 1000)))
        mod.wire_codec_seconds.observe(float(rng.random() * 1e-3),
                                       labels={"op": "encode"})
        mod.degraded_transitions_total.inc(
            labels={"phase": str(rng.choice(["enter", "exit"]))})


def mask_exemplar_times(body: str) -> str:
    return re.sub(r"( # \{[^}]*\} \S+) \d+\.\d{3}$", r"\1 <t>", body,
                  flags=re.M)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_observations_expose_equal(seed):
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    observe(jm, seed)
    observe(tm, seed)
    compare_bodies(tm.expose_all(), jm.expose_all())
    got = mask_exemplar_times(tm.expose_all(openmetrics=True))
    want = mask_exemplar_times(jm.expose_all(openmetrics=True))
    assert " # {trace_id=" in got
    compare_bodies(got, want)
    for labels in ({"phase": "Solve"}, {"phase": "Bind"}):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert tm.scheduling_latency.quantile(q, labels) == (
                jm.scheduling_latency.quantile(q, labels))
        tex = tm.scheduling_latency.exemplars(labels)
        jex = jm.scheduling_latency.exemplars(labels)
        assert {le: (e["labels"], e["value"]) for le, e in tex.items()} == {
            le: (e["labels"], e["value"]) for le, e in jex.items()}
    assert sorted(map(str, tm.scheduling_latency.state())) == sorted(
        map(str, jm.scheduling_latency.state()))
    assert sorted(map(str, tm.pods_enqueued_total.items())) == sorted(
        map(str, jm.pods_enqueued_total.items()))


@pytest.mark.parametrize("seed", range(4))
def test_bucket_arithmetic_equals_jax(seed):
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    rng = np.random.default_rng(seed)
    bounds = tuple(sorted(set(np.round(rng.random(8) * 10, 3).tolist())))
    counts = np.cumsum(rng.integers(0, 20, len(bounds))).tolist()
    total = counts[-1] + int(rng.integers(0, 5))
    for q in (-0.5, 0.0, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0, 2.0):
        assert tm.quantile_from_buckets(bounds, counts, total, q) == (
            jm.quantile_from_buckets(bounds, counts, total, q))
    for x in (-1.0, 0.0, *bounds, bounds[-1] + 1.0,
              float(rng.random() * 10)):
        assert tm.count_at_or_below(bounds, counts, total, x) == (
            jm.count_at_or_below(bounds, counts, total, x))
    assert tm.quantile_from_buckets(bounds, counts, 0, 0.5) == 0.0
    assert tm.quantile_from_buckets((), [], 5, 0.5) == 0.0


def test_instruments_behave_as_jax():
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    out = []
    for mod in (tm, jm):
        r = mod.Registry("test")
        c = r.counter("hits", "hit count")
        c.inc(3, {"path": "/x"})
        c.inc()
        g = r.gauge("temp")
        g.set(1.5, {"node": "n1"})
        h = r.histogram("lat", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v, exemplar={"trace_id": "abc"})
        with pytest.raises(ValueError):
            r.gauge("hits")
        assert r.counter("hits") is c
        body = r.expose()
        r.reset_for_tests()
        out.append((body, r.expose(), c.value(), [n for n, _ in r.items()],
                    mod.parse_openmetrics_flag("true"),
                    mod.parse_openmetrics_flag("false"),
                    mod.parse_openmetrics_flag(0)))
    assert out[0] == out[1]
