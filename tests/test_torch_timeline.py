"""Parity of the port's ``timeline`` (``koordinator_tpu_torch/timeline.py``)
with the JAX package's: ``sweep_attribution``, ``device_idle`` and
``TimelineRecorder.finish_cycle`` on the same seeded segment lists give
equal results (the same float arithmetic: held exactly), the published
gauges equal, and the kill switch behaves alike.  Mirrors
tests/test_timeline.py's unit cases.
"""

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_timeline():
    reset_observability()
    yield
    reset_observability()


def both():
    from koordinator_tpu import timeline as jtl

    from koordinator_tpu_torch import timeline as ttl

    return ttl, jtl


def seeded_segments(seed: int, n: int = 60, wall: float = 1.0):
    """Random segments of every cause (device_busy and an unknown cause
    among them), some nested, some outside the window, some empty."""
    from koordinator_tpu_torch import timeline as ttl

    rng = np.random.default_rng(seed)
    causes = list(ttl.CAUSES) + [ttl.DEVICE_BUSY, "not_a_cause"]
    out = []
    for k in range(n):
        start = float(rng.uniform(-0.2, wall + 0.1))
        length = float(rng.choice([0.0, rng.exponential(0.05),
                                   rng.uniform(0, 0.5)]))
        out.append({"start": start, "end": start + length,
                    "cause": str(rng.choice(causes)), "name": f"seg{k % 7}",
                    "tenant": ""})
    return out


def test_constants_equal():
    ttl, jtl = both()
    assert ttl.CAUSES == jtl.CAUSES
    assert ttl.ATTRIBUTION_CAUSES == jtl.ATTRIBUTION_CAUSES
    assert ttl.UNATTRIBUTED == jtl.UNATTRIBUTED
    assert ttl.DEVICE_BUSY == jtl.DEVICE_BUSY
    assert ttl.PHASE_CAUSES == jtl.PHASE_CAUSES


@pytest.mark.parametrize("seed", range(6))
def test_sweep_attribution_and_device_idle_equal(seed):
    ttl, jtl = both()
    segs = seeded_segments(seed)
    for t0, t1 in ((0.0, 1.0), (0.25, 0.6), (0.5, 0.5), (1.0, 0.0)):
        got = ttl.sweep_attribution(segs, t0, t1)
        assert got == jtl.sweep_attribution(segs, t0, t1)
        if t1 > t0:
            assert sum(got[0].values()) == pytest.approx(t1 - t0)
        assert ttl.device_idle(segs, t0, t1) == jtl.device_idle(segs, t0, t1)
    assert ttl._merge_intervals([(s["start"], s["end"]) for s in segs]) == (
        jtl._merge_intervals([(s["start"], s["end"]) for s in segs]))


@pytest.mark.parametrize("seed", range(4))
def test_finish_cycle_docs_equal(seed):
    ttl, jtl = both()
    docs = []
    for mod in (ttl, jtl):
        rec = mod.TimelineRecorder(max_segments=64, max_cycles=3)
        for k, s in enumerate(seeded_segments(seed)):
            rec.add(100.0 + s["start"], 100.0 + s["end"], s["cause"],
                    s["name"], "t" if k % 2 else "")
        out = [rec.finish_cycle(c, 100.0 + lo, 100.0 + hi, publish=False)
               for c, (lo, hi) in enumerate(((0.0, 0.4), (0.4, 1.0),
                                             (1.0, 1.0), (1.0, 1.2),
                                             (1.2, 1.5)))]
        docs.append((out, rec.cycles(limit=10), rec.cycles(limit=1)))
    assert docs[0] == docs[1]
    cycle = docs[0][0][1]
    assert cycle["mode"] == "cycle"
    assert sum(cycle["attribution"].values()) == pytest.approx(1.0)
    assert 0.0 <= cycle["device_idle_fraction"] <= 1.0


def test_published_gauges_equal():
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    ttl, jtl = both()
    for mod in (ttl, jtl):
        for s in seeded_segments(7):
            mod.RECORDER.add(50.0 + s["start"], 50.0 + s["end"], s["cause"],
                             s["name"])
        mod.RECORDER.finish_cycle(1, 50.0, 51.0, mode="round")
    for name in ("host_wait_attribution", "critical_path_seconds",
                 "device_idle_fraction"):
        assert sorted(map(str, getattr(tm, name).items())) == sorted(
            map(str, getattr(jm, name).items()))
    assert len(tm.host_wait_attribution.items()) == len(
        ttl.ATTRIBUTION_CAUSES)


def test_kill_switch_and_section():
    ttl, jtl = both()
    out = []
    for mod in (ttl, jtl):
        rec = mod.TimelineRecorder()
        rec.add(1.0, 2.0, "dispatch", "a")
        rec.add(2.0, 2.0, "dispatch", "empty")      # dropped
        rec.add(3.0, 2.5, "dispatch", "backwards")  # dropped
        rec.set_enabled(False)
        disabled = (rec.enabled, rec.finish_cycle(1, 0.0, 5.0))
        rec.add(1.0, 2.0, "dispatch", "b")
        with rec.section("host_other", "off"):
            pass
        rec.set_enabled(True)
        with rec.section("bind_commit", "on"):
            pass
        doc = rec.finish_cycle(2, 0.0, 1e12, publish=False)
        out.append((disabled, [(s["cause"], s["name"])
                               for s in doc["segments"]]))
        rec.reset_for_tests()
        assert rec.cycles() == []
    assert out[0] == out[1]
    assert out[0][1] == [("bind_commit", "on")]
