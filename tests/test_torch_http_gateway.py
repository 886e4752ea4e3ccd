"""Parity of the port's HTTP/JSON gateway
(``koordinator_tpu_torch/transport/http_gateway.py``) with the JAX package's:
one script of requests against a gateway of each package, over a scheduler
of that package with a state-sync service, a lease store, a hook dispatcher,
an auditor, an SLO monitor and trend engine on a fake clock and a stubbed
profile capture, answers every route with the same status and the same
body: the health and version routes, state pushes (and their 400s),
solves, the diagnosis, leases (and the CAS's 409), hooks (and the unknown
hook's 400), the audit ring, the debug documents (rounds, SLO with its
sharding section, steady, forecast, tenants, timeline, latency, profile,
trace, explain), the scrape's scheduler series, 404 and 501 alike.
Values that read a clock (durations, timestamps, trace ids) are compared
by name only.  Then both gateways survive the same garbage requests.
"""

import json
import socket
import urllib.error
import urllib.request

import pytest

from tests.torch_parity import (
    R,
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


def pkg_mods(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import ha, runtimeproxy, slo_monitor, trend
        from koordinator_tpu.ops import introspection
        from koordinator_tpu.scheduler.explanation import WorkloadAuditor
        from koordinator_tpu.transport import http_gateway
    else:
        from koordinator_tpu_torch import ha, runtimeproxy, slo_monitor, trend
        from koordinator_tpu_torch.ops import introspection
        from koordinator_tpu_torch.scheduler.explanation import (
            WorkloadAuditor,
        )
        from koordinator_tpu_torch.transport import http_gateway
    return dict(ha=ha, runtimeproxy=runtimeproxy, slo=slo_monitor,
                trend=trend, insp=introspection, auditor=WorkloadAuditor,
                http=http_gateway)


def request(port, path, method="GET", body=None, raw: bytes | None = None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


#: keys whose values read a clock or an id generator: compared by name
VOLATILE = {"start_time", "duration_s", "solve_wall_s", "solve_device_s",
            "phase_s", "staleness_s", "trace_id", "span_id", "parent_id",
            "evaluated_at", "time", "timestamp", "ts", "last_fired",
            "created", "wall_s", "cycles", "series", "pending", "p50_s",
            "p99_s", "sketches", "rate_per_hour", "windows", "peak_burn",
            "breached", "breaches_total", "slo_breached",
            "slo_breaches_total", "verdicts", "leaking", "drifting",
            "recompiles_by_shape", "sheds_total", "attempts", "events",
            "creation_timestamp", "update_time", "last_update",
            "cycle_critical_cause", "cycle_critical_seconds", "dump_reason",
            "round_trace_id"}


def canon(doc):
    if isinstance(doc, dict):
        return {k: ("<v>" if k in VOLATILE else canon(v))
                for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [canon(v) for v in doc]
    return doc


class HookServer:
    def __init__(self, response_cls):
        self.response_cls = response_cls

    def handle(self, hook, request):
        return self.response_cls(annotations={"seen": hook.value},
                                 labels=dict(request.labels))


class StubProfiler:
    def start_trace(self, out_dir):
        pass

    def stop_trace(self):
        pass


def scheduler_series(text: str) -> list[str]:
    """The scrape's scheduler series that read no clock."""
    keep = ("pods_enqueued_total", "pending_pods", "solver_device_bytes",
            "solver_shard_count", "solver_axis_shard_count",
            "unschedulable_pods", "incremental_solve_rounds_total",
            "capacity_slack")
    return sorted(line for line in text.splitlines()
                  if not line.startswith("#")
                  and any(k in line.split("{")[0].split(" ")[0]
                          for k in keep))


def script(pkg: str) -> list:
    s = side(pkg)
    m = pkg_mods(pkg)
    kw = {"mesh": "off"} if pkg == "jax" else {}
    sched = s.scheduler(capacity=16, managers=True, trace_pods=True, **kw)
    sync = s.StateSyncService()
    sync.attach_binding(s.SchedulerBinding(sched))
    store = m["ha"].InMemoryLeaseStore()
    dispatcher = m["runtimeproxy"].Dispatcher()
    dispatcher.register(HookServer(m["runtimeproxy"].HookResponse),
                        [m["runtimeproxy"].HookType.PRE_RUN_POD_SANDBOX])
    auditor = m["auditor"]()
    sched.auditor = auditor
    t = [10_000.0]
    sched.slo_monitor = m["slo"].SloMonitor(
        specs=m["slo"].default_specs(), clock=lambda: t[0])
    sched.trend_engine = m["trend"].TrendEngine(
        sched.slo_monitor.cache, clock=lambda: t[0])
    sched.profile_capture = m["insp"].ProfilerCapture(
        enabled=True, out_dir="/nonexistent/profile",
        profiler=StubProfiler(), sleep=lambda s: None)
    gw = m["http"].HttpGateway(scheduler=sched, dispatcher=dispatcher,
                               lease_store=store, auditor=auditor,
                               state_sync=sync)
    bare = m["http"].HttpGateway()
    out = []
    gw.start()
    bare.start()
    try:
        def call(*a, **k):
            status, body = request(gw.port, *a, **k)
            out.append((a[0], status, canon(body)))
            return status, body

        call("/healthz")
        call("/version")
        call("/v1/state", "POST", {
            "kind": "node_upsert", "name": "n1",
            "allocatable": [8_000, 32_768] + [0] * (R - 2)})
        call("/v1/state", "POST", {
            "kind": "node_upsert", "name": "n2",
            "allocatable": [4_000, 16_384] + [0] * (R - 2),
            "labels": {"zone": "b"}})
        for i, cpu in enumerate((1_000, 2_500, 900, 64_000)):
            call("/v1/state", "POST", {
                "kind": "pod_add", "name": f"p{i}", "priority": 5_000 - i,
                "requests": [cpu, 1_024] + [0] * (R - 2)})
        call("/v1/state", "POST", raw=b"[1, 2]")
        call("/v1/state", "POST", {"kind": "pod_add", "name": "bad",
                                   "requests": [1.5] * R})
        call("/v1/state", "POST", {"kind": "no_such_kind", "name": "x"})
        call("/v1/state", "POST", {"kind": "pod_add", "name": "huge",
                                   "requests": [2 ** 70] * R})
        call("/v1/diagnosis")
        call("/v1/solve", "POST", {})
        call("/v1/solve", "POST", raw=b"run-now")
        call("/v1/diagnosis")
        call("/debug/rounds?size=4")
        call("/debug/rounds?size=x")
        call("/debug/explain/p3?candidates=0")
        call("/debug/explain/p3")
        call("/debug/explain/nobody")
        call("/debug/explain/rsv::r1")
        call("/debug/trace/p0")
        call("/debug/trace/nobody")
        t[0] += 30.0
        call("/debug/slo")
        call("/debug/steady")
        call("/debug/steady?window=x")
        call("/debug/steady?window=-1")
        call("/debug/forecast")
        call("/debug/tenants")
        call("/debug/timeline?cycles=2")
        call("/debug/timeline?cycles=0")
        call("/debug/latency")
        call("/debug/latency?tenant=absent")
        call("/debug/profile?seconds=0.5")
        call("/debug/profile?seconds=nan")
        call("/debug/profile?seconds=x")
        call("/v1/podresources")
        call("/v1/audit?size=50")
        call("/v1/audit?size=x")
        call("/v1/hooks/PreRunPodSandbox", "POST",
             {"pod_meta": {"name": "p"}, "labels": {"a": "b"}})
        call("/v1/hooks/NoSuchHook", "POST", {})
        call("/v1/leases/sched")
        call("/v1/leases/sched", "PUT", {
            "expect_holder": "", "holder": "a", "duration_seconds": 5.0,
            "acquire_time": 1.0, "renew_time": 1.0, "transitions": 1})
        call("/v1/leases/sched", "PUT", {"expect_holder": "x",
                                         "holder": "b"})
        call("/v1/leases/sched")
        call("/no/such/route")
        call("/healthz", "POST", {})
        status, text = request(gw.port, "/metrics")
        out.append(("/metrics", status, scheduler_series(text)))
        for path, method in (("/v1/solve", "POST"), ("/v1/state", "POST"),
                             ("/v1/leases/x", "GET"), ("/debug/slo", "GET"),
                             ("/debug/rounds", "GET"),
                             ("/v1/podresources", "GET"),
                             ("/v1/hooks/PreRunPodSandbox", "POST"),
                             ("/debug/profile", "GET")):
            status, body = request(bare.port, path, method,
                                   {} if method == "POST" else None)
            out.append(("bare " + path, status, body))
    finally:
        bare.stop()
        gw.stop()
    return out


def test_every_route_answers_alike():
    got, want = script("torch"), script("jax")
    assert [(p, st) for p, st, _ in got] == [(p, st) for p, st, _ in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    statuses = {p: st for p, st, _ in got}
    assert statuses["/debug/forecast"] == statuses["/debug/tenants"] == 501
    assert statuses["/v1/podresources"] == 501
    assert statuses["/debug/profile?seconds=0.5"] == 200


def garbage(pkg: str) -> list:
    s = side(pkg)
    m = pkg_mods(pkg)
    kw = {"mesh": "off"} if pkg == "jax" else {}
    sched = s.scheduler(capacity=8, **kw)
    sched.snapshot.upsert_node(s.NodeSpec(name="n1",
                                          allocatable=rv(4_000, 4_096)))
    gw = m["http"].HttpGateway(scheduler=sched,
                               lease_store=m["ha"].InMemoryLeaseStore())
    gw.start()
    out = []
    try:
        for blob in (b"\x00" * 64, b"NOT-HTTP AT ALL\r\n\r\n",
                     b"POST /v1/solve HTTP/1.1\r\nContent-Length: 10\r\n\r\n"
                     b"not json!!",
                     b"POST /v1/state HTTP/1.1\r\nContent-Length: 999999\r\n"
                     b"\r\nshort",
                     b"GET /v1/%00%ff HTTP/1.1\r\n\r\n"):
            conn = socket.create_connection(("127.0.0.1", gw.port),
                                            timeout=5)
            conn.settimeout(5)
            try:
                conn.sendall(blob)
                try:
                    while conn.recv(4096):
                        pass
                except OSError:
                    pass
            finally:
                conn.close()
            out.append(request(gw.port, "/healthz"))
        out.append(request(gw.port, "/v1/leases/x", "PUT", raw=b"{broken")[0])
        out.append(request(gw.port, "/healthz"))
    finally:
        gw.stop()
    return out


def test_gateway_survives_garbage_alike():
    got = garbage("torch")
    assert got == garbage("jax")
    assert got[-1] == (200, {"ok": True})

