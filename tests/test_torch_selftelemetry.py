"""Parity of the port's process self-telemetry
(``koordinator_tpu_torch/selftelemetry.py``) with the JAX package's: a
sample publishes the same gauge series (RSS, fds, threads, allocation
blocks, gc objects and collections) under the binary's label, the values
within what one process can read twice, and the background sampler starts
and stops on both.  Mirrors tests/test_trend.py's TestSelfTelemetry.
"""

import time

import pytest

from tests.torch_parity import PKGS, reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def mods(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import metrics, selftelemetry
    else:
        from koordinator_tpu_torch import metrics, selftelemetry
    return metrics, selftelemetry


GAUGES = ("process_rss_bytes", "process_open_fds", "process_threads",
          "process_alloc_blocks", "process_gc_objects",
          "process_gc_collections")


def sample(pkg: str) -> dict:
    metrics, st = mods(pkg)
    telemetry = st.SelfTelemetry("test-bin")
    telemetry.sample()
    assert telemetry.samples == 1
    return {name: dict((tuple(sorted(lbl.items())), v)
                       for lbl, v in getattr(metrics, name).items())
            for name in GAUGES}


def test_sample_publishes_the_same_series():
    got, want = sample("torch"), sample("jax")
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    key = (("binary", "test-bin"),)
    for name in ("process_threads", "process_open_fds"):
        assert got[name][key] == pytest.approx(want[name][key], abs=4)
    assert got["process_rss_bytes"][key] > 0
    assert got["process_alloc_blocks"][key] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_background_sampler_stops_cleanly(pkg):
    _, st = mods(pkg)
    telemetry = st.SelfTelemetry("bg-bin")
    telemetry.start(interval_s=0.05)
    try:
        deadline = time.monotonic() + 5.0
        while telemetry.samples < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        telemetry.stop()
    assert telemetry.samples >= 1
    assert telemetry._thread is None
