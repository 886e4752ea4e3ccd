"""Parity of the port's metric store
(``koordinator_tpu_torch/koordlet/metriccache.py``) with the JAX package's:
the same appends on a cache of each package answer the same window queries
and aggregates (count, avg, latest, max, first, percentiles, duration,
downsample), under retention, ring wraparound and the long-horizon cold
tier (lazy and forced compaction); label sets, deletes, the pod gc and the
KV table agree; and a snapshot written by either package restores into the
other to the same samples.
"""

import numpy as np
import pytest

from tests.torch_parity import set_torch_threads

set_torch_threads()


def mc(pkg: str):
    if pkg == "jax":
        from koordinator_tpu.koordlet import metriccache
    else:
        from koordinator_tpu_torch.koordlet import metriccache
    return metriccache


def agg(res) -> list:
    out = [res.count, res.empty]
    if not res.empty:
        out += [res.avg(), res.latest(), res.max(), res.first(),
                res.percentile(0.9), res.percentiles([0.5, 0.95, 0.99]),
                res.duration_seconds(),
                sorted(zip(res.downsample(25.0).ts.tolist(),
                           res.downsample(25.0).values.tolist()))]
    return out


def script(pkg: str, tmp_path) -> list:
    m = mc(pkg)
    rng = np.random.default_rng(3)
    now = [1_000.0]
    out = []
    for kw in ({}, {"retention_sec": 120.0},
               {"capacity_per_series": 16},
               {"capacity_per_series": 16, "downsample_after_sec": 60.0,
                "downsample_resolution_sec": 20.0}):
        cache = m.MetricCache(clock=lambda: now[0], **kw)
        now[0] = 1_000.0
        for i in range(80):
            now[0] = 1_000.0 + 5.0 * i
            cache.append("cpu", float(rng.integers(0, 100)))
            cache.append("mem", float(i), labels={"pod_uid": f"u{i % 3}"})
            cache.append_many([("net", float(i) * 0.5, None),
                               ("net", 1.0, {"dev": "eth0"})])
        for start, end in ((0.0, None), (1_200.0, 1_300.0),
                           (1_390.0, 1_395.0), (5_000.0, 6_000.0)):
            out.append(agg(cache.query("cpu", start=start, end=end)))
            out.append(agg(cache.query("mem", {"pod_uid": "u1"},
                                       start=start, end=end)))
        cache.compact()
        out.append(agg(cache.query("cpu")))
        out.append(sorted(map(sorted, (d.items() for d in
                                       cache.series_labels("mem")))))
        cache.delete_series("net", {"dev": "eth0"})
        out.append(cache.series_labels("net"))
        out.append(cache.gc({"u0"}))
        out.append(sorted(map(sorted, (d.items() for d in
                                       cache.series_labels("mem")))))
        cache.set_kv("numa", {"nodes": 2})
        cache.set_kv("opaque", object())
        out.append(cache.get_kv("numa"))
        out.append(cache.get_kv("missing", "dflt"))
        path = str(tmp_path / f"{pkg}-{len(out)}.npz")
        cache.snapshot(path)
        out.append(("snapshot", path))
    out.append(m.MetricCache().restore(str(tmp_path / "absent.npz")))
    return out


def test_cache_script_matches(tmp_path):
    got = script("torch", tmp_path)
    want = script("jax", tmp_path)
    def snap(x):
        return isinstance(x, tuple) and x[0] == "snapshot"

    paths = [(g[1], w[1]) for g, w in zip(got, want) if snap(g)]
    assert [g for g in got if not snap(g)] == [w for w in want if not snap(w)]
    # each package restores the other's snapshot to the same samples
    for g, w in paths:
        restored = []
        for pkg, path in (("torch", w), ("jax", g)):
            cache = mc(pkg).MetricCache(clock=lambda: 2_000.0)
            assert cache.restore(path)
            restored.append((agg(cache.query("cpu")),
                             agg(cache.query("mem", {"pod_uid": "u0"})),
                             cache.get_kv("numa"),
                             cache.get_kv("opaque")))
        assert restored[0] == restored[1]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_corrupt_snapshot_starts_fresh(pkg, tmp_path):
    path = tmp_path / "bad.npz"
    path.write_bytes(b"not a zip")
    cache = mc(pkg).MetricCache()
    cache.append("x", 1.0, ts=1.0)
    assert cache.restore(str(path)) is False
    assert cache.query("x", end=2.0).count == 1
