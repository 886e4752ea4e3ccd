"""The port's solver introspection (``koordinator_tpu_torch/ops/introspection.py``)
against the JAX package's: ``ProfilerCapture``'s gate, serialization, clamp
and refusal of a non-finite ``seconds`` with an injected profiler, and the
``/debug/profile`` route's statuses, alike on both packages; the real
``torch.profiler`` capture writing its Chrome trace; ``device_bytes`` and
``device_bytes_by_shard`` of both packages' ``ClusterState`` built from the
same specs, equal; and the first-call accounting: one count a shape bucket,
an ``unknown`` bucket when labeling fails, exact increments when a round's
batch bucket changes, and the device-bytes gauges equal to the live
tensors.  Mirrors tests/test_introspection.py.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    PKGS,
    reset_observability,
    rv,
    set_torch_threads,
    side,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def insp(pkg: str):
    if pkg == "jax":
        from koordinator_tpu.ops import introspection as mod
    else:
        from koordinator_tpu_torch.ops import introspection as mod
    return mod


class StubProfiler:
    def __init__(self, calls: list):
        self.calls = calls

    def start_trace(self, out_dir):
        self.calls.append(("start", out_dir))

    def stop_trace(self):
        self.calls.append(("stop", None))


def capture_script(pkg: str, out_dir: str) -> list:
    """The gate, a stubbed capture, the clamp both ways, NaN and infinity,
    a sleep that dies (stop still runs, the lock is released) and a capture
    refused while another holds the lock."""
    mod = insp(pkg)
    out = []
    try:
        mod.ProfilerCapture().capture(0.01)
    except mod.ProfileDisabled as e:
        out.append(("disabled", str(e)))
    calls: list = []
    cap = mod.ProfilerCapture(enabled=True, out_dir=out_dir, max_seconds=5.0,
                              profiler=StubProfiler(calls),
                              sleep=lambda s: calls.append(("sleep", s)))
    for seconds in (2.0, 600.0, 0.0, -3.0, "0.25"):
        out.append(cap.capture(seconds))
    for bad in (float("nan"), float("inf")):
        try:
            cap.capture(bad)
        except ValueError as e:
            out.append(("refused", str(e)))
    out.append((list(calls), cap.captures))

    def dies(s):
        raise KeyboardInterrupt

    calls.clear()
    cap._sleep = dies
    try:
        cap.capture(0.1)
    except KeyboardInterrupt:
        out.append(("interrupted", list(calls)))
    cap._sleep = lambda s: None
    out.append(cap.capture(0.1))

    entered, release = threading.Event(), threading.Event()

    def held(s):
        entered.set()
        assert release.wait(10)

    cap._sleep = held
    first: list = []
    th = threading.Thread(target=lambda: first.append(cap.capture(1.0)),
                          daemon=True)
    th.start()
    try:
        assert entered.wait(10)
        try:
            cap.capture(1.0)
        except mod.ProfileBusy as e:
            out.append(("busy", str(e)))
    finally:
        release.set()
        th.join(10)
    out.append(first)
    return out


def test_capture_gate_clamp_and_busy_match(tmp_path):
    got = capture_script("torch", str(tmp_path))
    want = capture_script("jax", str(tmp_path))
    assert got == want
    assert ("busy", "a profiler capture is already running") in got


def debug_profile(pkg: str) -> list:
    s = side(pkg)
    mod = insp(pkg)
    sched = s.scheduler(capacity=8)
    sched.snapshot.upsert_node(s.NodeSpec(name="n0",
                                          allocatable=rv(1_000, 1_000)))
    if pkg == "jax":
        from koordinator_tpu.scheduler.services import DebugService
    else:
        from koordinator_tpu_torch.scheduler.services import DebugService
    service = DebugService(sched)
    out = [service.handle("/debug/profile", {"seconds": 0.01})]
    sched.profile_capture = mod.ProfilerCapture(
        enabled=True, out_dir="/nonexistent/x", profiler=StubProfiler([]),
        sleep=lambda s: None)
    for seconds in (0.25, "nope", "nan", "inf", None):
        out.append(service.handle("/debug/profile", {"seconds": seconds}))
    entered, release = threading.Event(), threading.Event()

    def held(s):
        entered.set()
        assert release.wait(10)

    sched.profile_capture._sleep = held
    th = threading.Thread(target=lambda: service.handle(
        "/debug/profile", {"seconds": 1.0}), daemon=True)
    th.start()
    try:
        assert entered.wait(10)
        out.append(service.handle("/debug/profile", {"seconds": 1.0}))
    finally:
        release.set()
        th.join(10)
    return out


def test_debug_profile_route_matches():
    got = debug_profile("torch")
    assert got == debug_profile("jax")
    assert [status for status, _ in got] == [403, 200, 400, 400, 400, 400,
                                             409]


def test_torch_profiler_writes_a_chrome_trace(tmp_path):
    """The real capture (host ops only on the CPU): its directory holds a
    Chrome trace after the call."""
    mod = insp("torch")
    cap = mod.ProfilerCapture(enabled=True, out_dir=str(tmp_path / "p"),
                              max_seconds=1.0)
    assert not cap.recording
    out = cap.capture(0.01)
    assert out == {"dir": str(tmp_path / "p"), "seconds": 0.01}
    assert not cap.recording and cap.captures == 1
    with open(os.path.join(out["dir"], mod.TRACE_FILE)) as f:
        doc = json.load(f)
    assert "traceEvents" in doc


def specs(pkg: str, seed: int):
    rng = np.random.default_rng(seed)
    s = side(pkg)
    snap = s.ClusterSnapshot(capacity=24, **s.dev)
    for i in range(17):
        snap.upsert_node(s.NodeSpec(
            name=f"n{i}", allocatable=rv(int(rng.integers(1_000, 9_000)),
                                         int(rng.integers(1_000, 9_000))),
            labels={"zone": f"z{i % 3}"}))
    snap.flush()
    return snap.state


@pytest.mark.parametrize("seed", [0, 1])
def test_device_bytes_of_cluster_state_match(seed):
    from koordinator_tpu_torch.state.cluster_state import ClusterState

    got, want = specs("torch", seed), specs("jax", seed)
    assert insp("torch").device_bytes(got) == insp("jax").device_bytes(want)
    assert insp("torch").device_bytes(got) == sum(
        int(getattr(got, f).nbytes) for f in ClusterState.__dataclass_fields__)
    assert (insp("torch").device_bytes_by_shard(got)
            == insp("jax").device_bytes_by_shard(want))
    for pkg in PKGS:
        assert insp(pkg).device_bytes(None) == 0
        assert insp(pkg).device_bytes_by_shard(None) == {}


def test_instrument_counts_first_call_per_bucket():
    from koordinator_tpu_torch import metrics

    mod = insp("torch")
    fn = mod.instrument(lambda x: x + 1, "plus_one",
                        shape_of=lambda a, k: f"N{a[0].shape[0]}")
    assert fn(torch.zeros(4)).shape == (4,)
    fn(torch.ones(4))
    fn(torch.zeros(8))
    assert fn.misses == 2
    assert metrics.solver_recompiles.value(
        {"fn": "plus_one", "shape": "N4"}) == 1
    assert metrics.solver_recompiles.value(
        {"fn": "plus_one", "shape": "N8"}) == 1
    assert metrics.solver_jit_cache_size.value({"fn": "plus_one"}) == 2.0

    def broken(a, k):
        raise RuntimeError("labeling bug")

    twice = mod.instrument(lambda x: x * 2, "twice", shape_of=broken)
    assert int(twice(torch.ones(2)).sum()) == 4
    assert metrics.solver_recompiles.value(
        {"fn": "twice", "shape": "unknown"}) == 1

    def boom(x):
        raise ValueError("solve failed")

    failing = mod.instrument(boom, "failing")
    with pytest.raises(ValueError):
        failing(torch.ones(2))
    assert failing.misses == 0
    label = mod.default_shape_of((torch.zeros(4, 2), torch.zeros(3)), {})
    assert label == insp("jax").default_shape_of(
        (np.zeros((4, 2)), np.zeros(3)), {}) == "4x2/3"


def metrics_and_pod(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import metrics
        from koordinator_tpu.scheduler.snapshot import PodSpec
    else:
        from koordinator_tpu_torch import metrics
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec
    return metrics, PodSpec


def recompile_deltas(pkg: str) -> list:
    """A full-path scheduler: the first round of each new pod bucket adds
    exactly one count a kit entry it runs, a same-bucket round none."""
    s = side(pkg)
    metrics, pod = metrics_and_pod(pkg)
    kw = {} if pkg == "torch" else {"mesh": "off"}
    sched = s.scheduler(capacity=64, batch_solver_threshold=1,
                        incremental_solve=False, zero_thresholds=False, **kw)
    sched.snapshot.upsert_node(s.NodeSpec(
        name="n0", allocatable=rv(10_000_000, 10_000_000)))
    out = []
    before: dict = {}
    for n, prefix in ((20, "a"), (20, "b"), (40, "c")):
        for i in range(n):
            sched.enqueue(pod(name=f"{prefix}{i}", requests=rv(100, 64)))
        sched.schedule_round()
        now = {(lbl["fn"], lbl["shape"]): v
               for lbl, v in metrics.solver_recompiles.items()}
        out.append(sorted(k for k, v in now.items()
                          if v != before.get(k, 0)))
        before = now
    out.append(metrics.solver_device_bytes.value(
        {"kind": "cluster_state"}) == float(
            insp(pkg).device_bytes(sched.snapshot.state)))
    out.append(metrics.solver_shard_count.value())
    out.append(sched.sharding_report()["recompiles_by_shape"].keys()
               == {f"{fn}[{shape}]" for fn, shape in before})
    return out


def test_recompile_increments_match():
    got = recompile_deltas("torch")
    assert got == recompile_deltas("jax")
    assert got[0] == [("capacity_slack", "N64"), ("gang_assign", "P32xN64")]
    assert got[1] == []
    assert got[2] == [("gang_assign", "P64xN64")]


def test_device_bytes_gauges_match_live_tensors():
    from koordinator_tpu_torch import metrics
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    s = side("torch")
    sched = s.scheduler(capacity=64, batch_solver_threshold=1)
    sched.snapshot.upsert_node(s.NodeSpec(
        name="n0", allocatable=rv(10_000_000, 10_000_000)))
    for i in range(20):
        sched.enqueue(PodSpec(name=f"a{i}", requests=rv(100, 64)))
    sched.schedule_round()
    mod = insp("torch")
    assert metrics.solver_device_bytes.value({"kind": "cluster_state"}) == (
        float(mod.device_bytes(sched.snapshot.state)))
    cache = sched._cand_cache["cache"]
    assert metrics.solver_device_bytes.value(
        {"kind": "candidate_cache"}) == float(mod.device_bytes(cache)) > 0
    assert metrics.solver_shard_count.value() == 1.0
    assert metrics.solver_axis_shard_count.value({"axis": "nodes"}) == 1.0
    assert metrics.solver_axis_shard_count.value({"axis": "pods"}) == 1.0
    assert metrics.solver_batch_padding_waste.value() == pytest.approx(
        1.0 - 20 / 32)
