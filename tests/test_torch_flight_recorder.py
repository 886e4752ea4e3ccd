"""Parity of the port's round flight recorder
(``koordinator_tpu_torch/scheduler/flight_recorder.py``) with the JAX
package's: the same records through a recorder of each package leave the
same ring, the same slow and degraded dumps (their counter and log lines),
the same overwrite count, ``dump_now``, ``annotate_round`` and the same
snapshots.  Then the schedulers themselves: with a monitor whose timeout
every phase exceeds, both dump every round's record as ``slow``
(tests/test_tracing.py's slow-dump case, through both schedulers).
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_recorder():
    reset_observability()
    yield
    reset_observability()


def both():
    from koordinator_tpu.scheduler import flight_recorder as jf

    from koordinator_tpu_torch.scheduler import flight_recorder as tf

    return tf, jf


def records(mod, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(9):
        out.append(mod.RoundRecord(
            round=k + 1, trace_id=f"t{k}", start_time=float(k),
            duration_s=float(rng.choice([0.01, 0.5, 2.0])),
            solver=str(rng.choice(["greedy", "batch"])),
            solve_path=str(rng.choice(["full_cold", "incremental"])),
            pods=int(rng.integers(0, 100)), placed=int(rng.integers(0, 50)),
            failed=int(rng.integers(0, 5)), suspended=int(rng.integers(0, 3)),
            degraded=bool(rng.random() < 0.3),
            staleness_s=float(rng.random()) if k % 2 else None,
            dirty_node_frac=float(rng.random()),
            dirty_pod_frac=float(rng.random()),
            solve_wall_s=0.1, solve_device_s=0.05,
            phase_s={"Solve": 0.1, "Bind": 0.02},
            top_unschedulable={"fit_cpu": int(rng.integers(0, 9))}))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_ring_dumps_and_overwrites_equal(seed, caplog):
    from koordinator_tpu import metrics as jm

    from koordinator_tpu_torch import metrics as tm

    tf, jf = both()
    assert ([f.name for f in dataclasses.fields(tf.RoundRecord)]
            == [f.name for f in dataclasses.fields(jf.RoundRecord)])
    out = []
    for mod in (tf, jf):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            fr = mod.FlightRecorder(capacity=4, slow_threshold_s=1.0)
            empty = (fr.last(), fr.slowest(), fr.dump_now("slo:x"))
            for rec in records(mod, seed):
                fr.record(rec)
            n = fr.annotate_round(8, "", cycle_seq=8,
                                  cycle_critical_cause="dispatch",
                                  cycle_critical_seconds=0.25)
            now = fr.dump_now("slo:lat")
        logs = [json.loads(r.getMessage().split(": ", 1)[1])
                for r in caplog.records]
        out.append((empty, fr.snapshot(), fr.snapshot(limit=2), fr.slowest(),
                    fr.last().to_doc(), fr.dumps, fr.overwrites, n, now,
                    [r.getMessage().split(":", 1)[0] for r in caplog.records],
                    logs))
    assert out[0] == out[1]
    for name in ("round_flight_dumps", "round_flight_overwritten"):
        assert sorted(map(str, getattr(tm, name).items())) == sorted(
            map(str, getattr(jm, name).items()))
    assert tm.round_flight_overwritten.value() == 5.0


def test_every_round_dumps_slow_through_both_schedulers():
    from koordinator_tpu.scheduler.monitor import (
        SchedulerMonitor as JMonitor,
    )

    from koordinator_tpu_torch import metrics as tm
    from koordinator_tpu_torch.scheduler.monitor import SchedulerMonitor

    from tests.test_torch_scheduler_reservations import Twin
    from tests.test_torch_scheduler_placement import node, pod

    tw = Twin([node(f"n{i}") for i in range(4)], capacity=8)
    tw.j.monitor = JMonitor(timeout_sec=1e-9)
    tw.p.monitor = SchedulerMonitor(timeout_sec=1e-9)
    for s in (tw.j, tw.p):
        s.flight_recorder.slow_threshold_s = 1e-9
    for k in range(2):
        tw.enqueue(pod(f"a{k}"), pod(f"b{k}", cpu=90_000))
        tw.round()
    got = [(r.round, r.dump_reason, r.placed, r.failed, r.pods,
            sorted(r.phase_s), r.solve_wall_s == r.phase_s["Solve"])
           for r in tw.p.flight_recorder.records]
    want = [(r.round, r.dump_reason, r.placed, r.failed, r.pods,
             sorted(r.phase_s), r.solve_wall_s == r.phase_s["Solve"])
            for r in tw.j.flight_recorder.records]
    assert got == want
    assert [g[1] for g in got] == ["slow", "slow"]
    assert tm.round_flight_dumps.value(labels={"reason": "slow"}) == 2.0
    assert tw.p.monitor.slow_rounds == tw.j.monitor.slow_rounds > 0
