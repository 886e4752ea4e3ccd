"""Parity of the port's ``journey`` (``koordinator_tpu_torch/journey.py``)
with the JAX package's: the same seeded values give equal ``DDSketch``
buckets, counts, quantiles and documents (scalar, repeated and batched
inserts, merges); the same seeded stamps through a ``JourneyLedger`` of
each package, on a fake clock, give equal snapshots, reports and
``merge_snapshot_rows`` tables, and the same published gauges.  Mirrors
tests/test_journey.py's sketch and ledger cases.
"""

import json

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_journey():
    reset_observability()
    yield
    reset_observability()


def both():
    from koordinator_tpu import journey as jj

    from koordinator_tpu_torch import journey as tj

    return tj, jj


def values(seed: int, n: int = 500) -> np.ndarray:
    """Latencies across six decades, with zeros, negatives, a NaN and an
    infinity among them."""
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-6, 0, n)
    v[:5] = (0.0, -1.0, 1e-10, float("nan"), float("inf"))
    return v


QUANTILES = (0.0, 0.01, 0.5, 0.9, 0.99, 1.0)


def sketch_view(sk) -> tuple:
    return (sk.to_doc(), [sk.quantile(q) for q in QUANTILES], sk.mean(),
            sk.max_value, sk.min_value, sk.count)


@pytest.mark.parametrize("seed", range(3))
def test_sketch_buckets_and_quantiles_equal(seed):
    tj, jj = both()
    assert (tj.RELATIVE_ACCURACY, tj.STAGES) == (jj.RELATIVE_ACCURACY,
                                                 jj.STAGES)
    v = values(seed)
    out = []
    for mod in (tj, jj):
        scalar, batch, rep = mod.DDSketch(), mod.DDSketch(), mod.DDSketch()
        scalar.insert_many(v.tolist())
        batch.insert_batch(v)
        rep.insert_repeated(0.0123, 7)
        rep.insert_repeated(0.0, 2)
        merged = scalar.copy().merge(rep)
        back = mod.DDSketch.from_doc(json.loads(json.dumps(merged.to_doc())))
        out.append([sketch_view(s) for s in (scalar, batch, rep, merged,
                                             back, mod.DDSketch())])
    assert out[0] == out[1]


class FakeTime:
    """A clock for ``journey``'s ``time.time`` and ``time.perf_counter``."""

    def __init__(self):
        self.wall = 1.7e9
        self.perf = 1_000.0

    def time(self):
        return self.wall

    def perf_counter(self):
        return self.perf


def drive_ledger(mod, seed: int, clock: FakeTime):
    """Seeded enqueues (some with an arrival stamp), three bind rounds of
    mixed QoS and tenants, a forget; returns the ledger."""
    rng = np.random.default_rng(seed)
    ledger = mod.JourneyLedger()

    class Pod:
        def __init__(self, name, qos):
            self.name, self.qos = name, qos

    pods = []
    for k in range(300):
        clock.wall += float(rng.uniform(0, 0.01))
        clock.perf += float(rng.uniform(0, 0.01))
        arrival = (clock.wall - float(rng.uniform(0, 0.5))
                   if rng.random() < 0.6 else 0.0)
        ledger.note_enqueue(f"p{k}", arrival)
        ledger.note_enqueue(f"p{k}", 0.0)        # a replay: no reset
        pods.append(Pod(f"p{k}", int(rng.integers(0, 4))))
    ledger.forget("p0")
    for rnd in range(3):
        start = clock.perf
        clock.perf += float(rng.uniform(0.01, 0.2))
        commit = clock.perf
        chunk = pods[rnd * 100:(rnd + 1) * 100]
        ledger.record_bind_batch("" if rnd < 2 else "tenant-b", chunk,
                                 round_start_perf=start, commit_perf=commit,
                                 ack_perf=commit + 0.003 * (rnd + 1))
    ledger.record_bind_batch("", [Pod("ghost", 0)], round_start_perf=0.0,
                             commit_perf=0.0)
    return ledger


@pytest.mark.parametrize("seed", range(3))
def test_ledger_snapshots_reports_and_merges_equal(seed, monkeypatch,
                                                    tmp_path):
    tj, jj = both()
    out = []
    for mod in (tj, jj):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        ledger = drive_ledger(mod, seed, clock)
        path = tmp_path / f"{mod.__name__}.jsonl"
        n = ledger.write_jsonl(str(path))
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        merged = mod.merge_snapshot_rows(rows + rows)
        out.append((ledger.snapshot_doc(), ledger.snapshot_doc("tenant-b"),
                    ledger.report(), ledger.tenants(),
                    ledger.pending_count(), n,
                    {k: sketch_view(v) for k, v in merged.items()}))
    assert out[0] == out[1]
    stages = {(r["stage"]) for r in out[0][2]["series"]}
    assert stages == {"e2e", "ingest", "queue_wait", "solve", "commit"}


def test_disabled_ledger_and_published_gauges(monkeypatch):
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    tj, jj = both()
    out = []
    for mod in (tj, jj):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        off = mod.JourneyLedger(enabled=False)
        off.note_enqueue("a", 1.0)
        off.record_bind_batch("", [], round_start_perf=0.0, commit_perf=0.0)
        led = drive_ledger(mod, 9, clock)
        led.set_enabled(False)
        cleared = (led.report()["series"], led.pending_count())
        led.publish_gauges()                      # disabled: a no-op
        monkeypatch.setattr(mod, "LEDGER", drive_ledger(mod, 9, clock))
        mod.LEDGER.publish_gauges()
        out.append((off.report(), cleared))
    assert out[0] == out[1]
    got = sorted(map(str, tm.pod_journey_latency_seconds.items()))
    assert got and got == sorted(
        map(str, jm.pod_journey_latency_seconds.items()))
