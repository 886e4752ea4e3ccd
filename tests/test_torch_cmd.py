"""The port's scheduler binary (``koordinator_tpu_torch/cmd/binaries.py``)
against the JAX package's: the parser has every flag with the same default
and help; the scheduler cases of tests/test_cmd.py hold on the port
(assembly with a lease and a socket, leader election off, the full sidecar
over STATE_PUSH frames and POST /v1/state, a clean stop releasing the lease
to a follower); both binaries fed the same frames and HTTP pushes bind
alike round by round over the socket and over POST /v1/solve; every flag
whose module the port lacks exits naming it; and stopping an assembly
stops its SLO sampler, telemetry thread, gateway, server and lease.
"""

import json
import shutil
import tempfile
import threading
import urllib.request

import numpy as np
import pytest

from tests.torch_parity import (
    R,
    reset_observability,
    set_torch_threads,
    side,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def binaries(pkg: str):
    if pkg == "jax":
        from koordinator_tpu.cmd import binaries
    else:
        from koordinator_tpu_torch.cmd import binaries
    return binaries


def assemble(pkg: str, argv: list[str], **kw):
    """The package's scheduler binary; the port's on the CPU."""
    if pkg == "torch":
        kw["device"] = "cpu"
    return binaries(pkg).main_koord_scheduler(argv, **kw)


def test_mains_names_the_scheduler():
    assert sorted(binaries("torch").MAINS) == ["koord-scheduler"]


def test_parser_flags_match():
    def flags(pkg):
        parser = binaries(pkg).build_scheduler_parser()
        return [(tuple(a.option_strings), a.dest, a.default, a.help,
                 a.choices, a.type, a.nargs, a.const)
                for a in parser._actions]

    assert flags("torch") == flags("jax")


def test_scheduler_assembly_with_lease_and_socket():
    from koordinator_tpu_torch.ha import InMemoryLeaseStore
    from koordinator_tpu_torch.transport import RpcClient
    from koordinator_tpu_torch.transport.services import solve_remote

    d = tempfile.mkdtemp(prefix="kc")
    store = InMemoryLeaseStore()
    out = assemble("torch", ["--node-capacity", "32", "--gang-passes", "3",
                             "--identity", "sched-a",
                             "--listen-socket", f"{d}/sched.sock"],
                   lease_store=store)
    try:
        sched = out.component
        assert sched.snapshot.capacity == 32
        assert sched.gang_passes == 3
        assert sched.explanations is not None and sched.auditor is not None
        assert sched.cpu_manager is not None
        assert sched.device_manager is not None
        assert out.elector.identity == "sched-a"
        assert out.elector.lease_name == "koordinator-system/koord-scheduler"
        assert out.elector.tick() is True
        assert sched.slo_monitor is not None
        assert sched.trend_engine is not None
        assert sched.profile_capture is None
        client = RpcClient(out.server.path, timeout=10.0)
        client.connect()
        try:
            result = solve_remote(client)
            assert result["assignments"] == {} and result["round_pods"] == 0
        finally:
            client.close()
    finally:
        out.stop()
        shutil.rmtree(d, ignore_errors=True)


def test_scheduler_leader_election_disable():
    out = assemble("torch", ["--disable-leader-election"])
    try:
        assert out.elector is None and out.server is None
        assert out.component.device.type == "cpu"
    finally:
        out.stop()


def test_stop_releases_leadership_for_fast_failover():
    from koordinator_tpu_torch.ha import InMemoryLeaseStore

    store = InMemoryLeaseStore()
    a = assemble("torch", ["--identity", "a"], lease_store=store)
    b = assemble("torch", ["--identity", "b"], lease_store=store)
    try:
        assert a.elector.tick() is True
        assert b.elector.tick() is False
        a.stop()
        assert b.elector.tick() is True
    finally:
        b.stop()


def test_stop_ends_what_the_assembly_opened():
    before = set(threading.enumerate())
    asm = assemble("torch", ["--listen-socket", "tcp://127.0.0.1:0",
                             "--http-port", "0", "--disable-leader-election",
                             "--slo-sample-interval-seconds", "0.01",
                             "--self-telemetry-interval-seconds", "0.01"])
    assert asm.component.slo_monitor._thread is not None
    assert asm.telemetry._thread is not None
    asm.stop()
    assert asm.component.slo_monitor._thread is None
    assert asm.telemetry._thread is None
    pause = threading.Event()
    for _ in range(500):
        if not set(threading.enumerate()) - before:
            break
        pause.wait(0.01)
    assert not set(threading.enumerate()) - before


@pytest.mark.parametrize("argv,module", [
    (["--tenants", "2"], "scheduler/tenancy.py"),
    (["--quality-mode", "lp"], "quality/lp_pack.py"),
    (["--quality-mode", "auto"], "quality/lp_pack.py"),
    (["--forecast-mode", "admit"], "forecast/plane.py"),
    (["--forecast-mode", "full"], "forecast/plane.py"),
    (["--checkpoint-path", "ckpt.json"], "drills/checkpoint.py"),
])
def test_unported_flags_exit_naming_the_module(argv, module):
    with pytest.raises(SystemExit, match=module):
        assemble("torch", ["--disable-leader-election", *argv])


def test_preemption_flag_requires_an_evictor():
    with pytest.raises(SystemExit, match="no eviction transport"):
        assemble("torch", ["--enable-preemption",
                           "--disable-leader-election"])


def test_gates_and_kill_switches():
    from koordinator_tpu_torch import journey, timeline
    from koordinator_tpu_torch.features import SCHEDULER_GATES

    before = (timeline.RECORDER.enabled, journey.LEDGER.enabled,
              SCHEDULER_GATES.enabled("MultiQuotaTree"))
    try:
        out = assemble("torch", ["--disable-leader-election", "--no-explain",
                                 "--no-timeline", "--no-journey",
                                 "--trace-pods", "--flight-ring-size", "8",
                                 "--feature-gates", "MultiQuotaTree=true",
                                 "--enable-profile-endpoint",
                                 "--profile-dir", "/nonexistent/p"])
        try:
            sched = out.component
            assert sched.explain is False and sched.trace_pods is True
            assert sched.flight_recorder.capacity == 8
            assert sched.profile_capture.enabled
            assert sched.profile_capture.out_dir == "/nonexistent/p"
            assert timeline.RECORDER.enabled is False
            assert journey.LEDGER.enabled is False
            assert SCHEDULER_GATES.enabled("MultiQuotaTree") is True
        finally:
            out.stop()
    finally:
        timeline.RECORDER.set_enabled(before[0])
        journey.LEDGER.set_enabled(before[1])
        SCHEDULER_GATES.set("MultiQuotaTree", before[2])


def sidecar_script(pkg: str, monkeypatch) -> list:
    """The same STATE_PUSH frames, HTTP pushes and rounds against one
    package's binary: nodes and pods over the socket, more over POST
    /v1/state, rounds alternating solve_remote and POST /v1/solve."""
    monkeypatch.setenv("KOORD_SOLVER_MESH", "off")
    s = side(pkg)
    rng = np.random.default_rng(5)
    asm = assemble(pkg, ["--node-capacity", "16",
                         "--listen-socket", "tcp://127.0.0.1:0",
                         "--http-port", "0", "--disable-leader-election",
                         "--batch-solver-threshold", "24"])
    client = s.RpcClient(asm.server.address, timeout=30.0)
    out = []
    try:
        client.connect()
        for i in range(12):
            alloc = np.zeros(R, np.int32)
            alloc[0] = rng.integers(4_000, 32_000)
            alloc[1] = rng.integers(8_192, 65_536)
            _, doc, _ = client.call(
                s.FrameType.STATE_PUSH,
                {"kind": "node_upsert", "name": f"n{i}",
                 "labels": {"zone": f"z{i % 2}"}}, {"allocatable": alloc})
            out.append(doc["rv"])
        pod_i = 0
        for rnd in range(4):
            for _ in range(int(rng.integers(3, 40))):
                req = [int(rng.integers(100, 6_000)),
                       int(rng.integers(128, 8_192))] + [0] * (R - 2)
                doc = {"kind": "pod_add", "name": f"p{pod_i}",
                       "priority": int(rng.integers(0, 9_000)),
                       "node_selector": ({"zone": "z1"} if pod_i % 5 == 0
                                         else {})}
                if pod_i % 2:
                    _, reply, _ = client.call(
                        s.FrameType.STATE_PUSH, doc,
                        {"requests": np.asarray(req, np.int32)})
                else:
                    body = json.dumps(dict(doc, requests=req)).encode()
                    with urllib.request.urlopen(urllib.request.Request(
                            f"http://127.0.0.1:{asm.gateway.port}/v1/state",
                            data=body, method="POST"), timeout=30) as resp:
                        reply = json.loads(resp.read())
                out.append(reply["rv"])
                pod_i += 1
            if rnd % 2:
                result = s.solve_remote(client)
            else:
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{asm.gateway.port}/v1/solve",
                        data=b"{}", method="POST"), timeout=60) as resp:
                    result = json.loads(resp.read())
            out.append({k: result[k] for k in (
                "assignments", "failures", "nominations", "round_pods")})
    finally:
        client.close()
        asm.stop()
    return out


def test_both_binaries_bind_alike(monkeypatch):
    got = sidecar_script("torch", monkeypatch)
    want = sidecar_script("jax", monkeypatch)
    assert got == want
    rounds = [r for r in got if isinstance(r, dict)]
    assert sum(len(r["assignments"]) for r in rounds) > 0
    assert any(r["round_pods"] >= 24 for r in rounds)


def test_scheduler_binary_is_a_full_sidecar():
    """STATE_PUSH frames and POST /v1/state apply synchronously through the
    in-process binding: the next solve sees both."""
    from koordinator_tpu_torch.transport import RpcClient
    from koordinator_tpu_torch.transport.services import solve_remote
    from koordinator_tpu_torch.transport.wire import FrameType

    d = tempfile.mkdtemp(prefix="kc")
    asm = assemble("torch", ["--node-capacity", "16",
                             "--listen-socket", f"{d}/sidecar.sock",
                             "--http-port", "0"])
    try:
        client = RpcClient(asm.server.path, timeout=10.0)
        client.connect()
        try:
            _, doc, _ = client.call(
                FrameType.STATE_PUSH,
                {"kind": "node_upsert", "name": "wire-node"},
                {"allocatable": np.asarray([8_000, 16_384] + [0] * (R - 2),
                                           np.int32)})
            assert doc["rv"] == 1
            body = json.dumps({"kind": "pod_add", "name": "http-pod",
                               "requests": [1_000, 1_024] + [0] * (R - 2)})
            req = urllib.request.Request(
                f"http://127.0.0.1:{asm.gateway.port}/v1/state",
                data=body.encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read())["rv"] == 2
            result = solve_remote(client)
            assert result["assignments"] == {"http-pod": "wire-node"}
        finally:
            client.close()
    finally:
        asm.stop()
        shutil.rmtree(d, ignore_errors=True)
