"""HTTP/JSON gateway: the externally-speakable boundary of the sidecar
(port of ``koordinator_tpu/transport/http_gateway.py``, copied whole).

The north-star deployment has the reference's Go scheduler plugins calling
into this framework as a sidecar (BASELINE.json: "the Go plugins calling
into a Python sidecar via the existing framework.Plugin extension point").
The framed unix/TCP transport (channel.py) is the efficient Python<->
Python path; THIS module is the language-neutral one — plain HTTP + JSON,
callable from Go's net/http (or curl) with no codegen and no client
library, the interop role gRPC's JSON transcoding plays for the
reference's api.proto surface.

Routes (all JSON bodies/responses unless noted):

    GET  /healthz                      -> {"ok": true}
    GET  /version                      -> {"protocol": N}
    GET  /metrics                      -> text exposition over ALL
                                          component registries
                                          (metrics.expose_all) so every
                                          binary scrapes uniformly;
                                          ?openmetrics=1 (or Accept:
                                          application/openmetrics-text)
                                          adds histogram exemplars
    GET  /debug/rounds?size=N          -> the scheduler's round flight
                                          recorder, newest first
    GET  /debug/trace/<pod>            -> recent spans of the pod's
                                          trace (scheduler binaries);
                                          typed 404 for unknown pods
    GET  /debug/explain/<pod>          -> the pod's placement
                                          explanation: reject-reason
                                          node counts joined to its
                                          trace_id/round, plus per-term
                                          score decomposition of its
                                          winning/top-k candidates;
                                          typed 404 for unknown pods
                                          and rsv:: reserve-pods
    GET  /debug/slo                    -> the SLO burn-rate engine's
                                          evaluation (specs, windows,
                                          burn rates, breach state)
    GET  /debug/steady?window=N        -> the trend engine's long-
                                          horizon steady/drifting/
                                          leaking verdicts per watched
                                          series, joined to SLO breach
                                          state (scheduler binaries)
    GET  /debug/forecast?nodes=N       -> the forecast plane's horizon
                                          policy, prediction-error
                                          stats, and per-node predicted
                                          peaks (501 without a plane —
                                          forecast mode off)
    GET  /debug/tenants                -> multi-tenant rollup: per-
                                          tenant weight/share/credit,
                                          queue depth, degraded state,
                                          cycle dispatch mode (501
                                          without a tenancy front-end)
    GET  /debug/timeline?cycles=N      -> the critical-path
                                          observatory's reconstructed
                                          cycle gantts: typed segments,
                                          host-wait attribution,
                                          device-idle intervals, and
                                          the critical-path chain +
                                          dominant cause per cycle
    GET  /debug/latency?tenant=        -> the pod-journey ledger's
                                          per-(tenant, qos, stage)
                                          e2e latency quantile table
                                          from mergeable sketches (501
                                          when the ledger is off; typed
                                          400 on an unknown tenant)
    GET  /debug/profile?seconds=N      -> on-demand torch.profiler
                                          capture; 403 unless enabled
                                          at assembly (gated off by
                                          default)
    POST /v1/state                     -> one state event (the STATE_PUSH
                                          frame's JSON form: {"kind",
                                          "name", resource vectors as
                                          arrays, ...}) -> {"rv": N}
    POST /v1/solve                     -> one scheduling round
    POST /v1/hooks/<HookType>          -> runtime-hook dispatch
    GET  /v1/leases/<name>             -> lease record
    PUT  /v1/leases/<name>             -> CAS update {ok}; 409 on conflict
    GET  /v1/diagnosis                 -> last round's schedule diagnosis
    GET  /v1/podresources              -> kubelet pod-resources listing
                                          enriched with koord allocations
    GET  /v1/audit?size=N&group=G      -> recent audit events, newest first
                                          (AuditEventsHTTPHandler's role)

Handlers delegate to the same objects the framed services use
(transport/services.py SolveService/HookService, ha.LeaseService's store),
so both boundaries stay behaviorally identical.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from koordinator_tpu_torch.transport.wire import PROTOCOL_VERSION


class HttpGateway:
    """Threaded HTTP server over the sidecar's services.

    Any of ``scheduler``, ``dispatcher``, ``lease_store`` may be None —
    the matching routes then answer 501, so a koordlet-only or
    scheduler-only binary exposes exactly its own surface.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        scheduler=None,
        dispatcher=None,
        lease_store=None,
        pod_resources=None,
        auditor=None,
        state_sync=None,
    ):
        self.scheduler = scheduler
        self.dispatcher = dispatcher
        self.lease_store = lease_store
        self.pod_resources = pod_resources
        self.auditor = auditor
        self.state_sync = state_sync
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: no stderr spam
                pass

            def _reply(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, code: int, text: str,
                            content_type: str = "text/plain; "
                            "version=0.0.4; charset=utf-8") -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                return json.loads(self.rfile.read(length).decode())

            def do_GET(self):
                try:
                    gateway._route(self, "GET")
                except Exception as e:  # route bug: fail the call
                    self._reply(500, {"error": repr(e)})

            def do_POST(self):
                try:
                    gateway._route(self, "POST")
                except Exception as e:
                    self._reply(500, {"error": repr(e)})

            def do_PUT(self):
                try:
                    gateway._route(self, "PUT")
                except Exception as e:
                    self._reply(500, {"error": repr(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        # tight poll interval, matching channel.RpcServer: shutdown()
        # blocks until serve_forever's select loop notices, and the 0.5s
        # stdlib default stalls every gateway stop/restart
        self._thread = threading.Thread(
            target=lambda: self._server.serve_forever(poll_interval=0.05),
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- routing ------------------------------------------------------------

    _LEASE = re.compile(r"^/v1/leases/([A-Za-z0-9._-]+)$")
    _HOOK = re.compile(r"^/v1/hooks/([A-Za-z0-9._-]+)$")
    _TRACE = re.compile(r"^/debug/trace/(.+)$")
    _EXPLAIN = re.compile(r"^/debug/explain/(.+)$")

    def _route(self, req, method: str) -> None:
        path = req.path.split("?", 1)[0]
        if method == "GET" and path == "/healthz":
            return req._reply(200, {"ok": True})
        if method == "GET" and path == "/version":
            return req._reply(200, {"protocol": PROTOCOL_VERSION})
        if method == "GET" and path == "/metrics":
            return self._metrics(req)
        if method == "GET" and path == "/debug/rounds":
            return self._debug_rounds(req)
        if method == "GET" and path == "/debug/slo":
            return self._debug_slo(req)
        if method == "GET" and path == "/debug/steady":
            return self._debug_steady(req)
        if method == "GET" and path == "/debug/forecast":
            return self._debug_forecast(req)
        if method == "GET" and path == "/debug/tenants":
            return self._debug_tenants(req)
        if method == "GET" and path == "/debug/timeline":
            return self._debug_timeline(req)
        if method == "GET" and path == "/debug/latency":
            return self._debug_latency(req)
        if method == "GET" and path == "/debug/profile":
            return self._debug_profile(req)
        m = self._TRACE.match(path)
        if m and method == "GET":
            return self._debug_trace(req, m.group(1))
        m = self._EXPLAIN.match(path)
        if m and method == "GET":
            return self._debug_explain(req, m.group(1))
        if method == "POST" and path == "/v1/state":
            return self._state_push(req)
        if method == "POST" and path == "/v1/solve":
            return self._solve(req)
        if method == "GET" and path == "/v1/diagnosis":
            return self._diagnosis(req)
        if method == "GET" and path == "/v1/podresources":
            if self.pod_resources is None:
                return req._reply(501,
                                  {"error": "no pod-resources proxy"})
            return req._reply(200, self.pod_resources.list())
        if method == "GET" and path == "/v1/audit":
            if self.auditor is None:
                return req._reply(501, {"error": "no auditor attached"})
            from urllib.parse import parse_qs

            query = parse_qs(req.path.partition("?")[2])
            try:
                size = int(query.get("size", ["100"])[0])
            except ValueError:
                return req._reply(400, {"error": "size must be an int"})
            group = query.get("group", [None])[0]
            return req._reply(200, {"events": self.auditor.query(
                limit=size, group=group)})
        m = self._HOOK.match(path)
        if m and method == "POST":
            return self._hook(req, m.group(1))
        m = self._LEASE.match(path)
        if m:
            if method == "GET":
                return self._lease_get(req, m.group(1))
            if method == "PUT":
                return self._lease_put(req, m.group(1))
        req._reply(404, {"error": f"no route {method} {path}"})

    def _state_push(self, req) -> None:
        """One state event, the STATE_PUSH frame's JSON form: resource
        vectors ride as JSON int arrays (fine for the interop path; the
        hot path uses the framed transport's raw array section).  Rides
        the same validated handler, so a malformed HTTP push fails with
        400 instead of poisoning the replay log."""
        if self.state_sync is None:
            return req._reply(501, {"error": "no state-sync service"})
        import numpy as np

        from koordinator_tpu_torch.transport.wire import (
            STATE_PUSH_ARRAY_KEYS,
            WireSchemaError,
        )

        doc = req._body()
        if not isinstance(doc, dict):
            return req._reply(400, {"error": "body must be a JSON object"})
        arrays = {}
        for key in STATE_PUSH_ARRAY_KEYS:
            if key in doc:
                value = doc.pop(key)
                if (not isinstance(value, list)
                        or not all(isinstance(v, int)
                                   and not isinstance(v, bool)
                                   for v in value)):
                    return req._reply(400, {
                        "error": f"{key} must be a JSON array of ints"})
                try:
                    arrays[key] = np.asarray(value, np.int64)
                except OverflowError:
                    return req._reply(400, {
                        "error": f"{key} has values beyond int64"})
        try:
            # the handler owns schema validation (incl. kind/name)
            out, _ = self.state_sync._handle_state_push(doc, arrays)
        except WireSchemaError as e:
            body = {"error": str(e)}
            if getattr(e, "resync", False):
                # same resync hint the framed ERROR carries: the
                # pusher's view of this service is stale, not just this
                # one request (docs/robustness.md)
                body["resync"] = True
            return req._reply(400, body)
        req._reply(200, out)

    def _metrics(self, req) -> None:
        """Aggregate scrape surface: every component registry, so the
        same scrape config works against any of the five binaries."""
        from urllib.parse import parse_qs

        from koordinator_tpu_torch import metrics

        query = parse_qs(req.path.partition("?")[2])
        openmetrics = (metrics.parse_openmetrics_flag(
            query.get("openmetrics", ["0"])[0])
            or "application/openmetrics-text"
            in (req.headers.get("Accept") or ""))
        content_type = ("application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8" if openmetrics
                        else "text/plain; version=0.0.4; charset=utf-8")
        req._reply_text(200, metrics.expose_all(openmetrics=openmetrics),
                        content_type=content_type)

    def _debug_rounds(self, req) -> None:
        if getattr(self.scheduler, "flight_recorder", None) is None:
            return req._reply(501, {"error": "no flight recorder "
                                    "(scheduler binaries only)"})
        from urllib.parse import parse_qs

        from koordinator_tpu_torch.scheduler.services import debug_rounds_body

        query = parse_qs(req.path.partition("?")[2])
        try:
            size = int(query.get("size", ["32"])[0])
        except ValueError:
            return req._reply(400, {"error": "size must be an int"})
        return req._reply(200, debug_rounds_body(self.scheduler, size))

    def _debug_slo(self, req) -> None:
        """The SLO burn-rate engine's evaluation — same body the
        DebugService serves (shared builder)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_slo_body,
        )

        try:
            return req._reply(200, debug_slo_body(self.scheduler))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_steady(self, req) -> None:
        """The trend engine's steady/drifting/leaking verdicts — same
        body the DebugService serves (shared builder; ?window=N
        overrides the evaluation window)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qsl

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_steady_body,
        )

        params = dict(parse_qsl(req.path.partition("?")[2]))
        try:
            return req._reply(200, debug_steady_body(self.scheduler,
                                                     params))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_forecast(self, req) -> None:
        """The forecast plane's horizon/error/per-node-peak document —
        same body the DebugService serves (shared builder; ?nodes=N
        bounds the node section, typed 501 without a plane)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qsl

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_forecast_body,
        )

        params = dict(parse_qsl(req.path.partition("?")[2]))
        try:
            return req._reply(200, debug_forecast_body(self.scheduler,
                                                       params))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_tenants(self, req) -> None:
        """The multi-tenant rollup — same body the DebugService serves
        (shared builder; typed 501 without a tenancy front-end)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_tenants_body,
        )

        try:
            return req._reply(200, debug_tenants_body(self.scheduler))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_timeline(self, req) -> None:
        """The critical-path observatory's cycle gantts — same body the
        DebugService serves (shared builder; ?cycles=N bounds the ring
        slice, 400 on a malformed bound)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qsl

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_timeline_body,
        )

        params = dict(parse_qsl(req.path.partition("?")[2]))
        try:
            return req._reply(200, debug_timeline_body(self.scheduler,
                                                       params))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_latency(self, req) -> None:
        """The pod-journey ledger's latency quantile table — same body
        the DebugService serves (shared builder; ?tenant= filters, typed
        400 on an unknown tenant, 501 while the ledger is off)."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qsl

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_latency_body,
        )

        params = dict(parse_qsl(req.path.partition("?")[2]))
        try:
            return req._reply(200, debug_latency_body(self.scheduler,
                                                      params))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_profile(self, req) -> None:
        """On-demand torch.profiler capture (?seconds=N), 403 while the
        assembly-time gate is off — the default."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qs

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_profile_body,
        )

        query = parse_qs(req.path.partition("?")[2])
        seconds = query.get("seconds", ["1.0"])[0]
        try:
            return req._reply(200,
                              debug_profile_body(self.scheduler, seconds))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_trace(self, req, pod: str) -> None:
        """Typed statuses ride the shared builder's DebugApiError (404
        for unknown pods) — the same mapping the DebugService applies,
        so the two surfaces cannot drift."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_trace_body,
        )

        try:
            return req._reply(200, debug_trace_body(self.scheduler, pod))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _debug_explain(self, req, pod: str) -> None:
        """One pod's placement explanation (reject-reason counts +
        candidate score decomposition; ?candidates=0 skips the
        decomposition for polling loops); 404s are typed via the shared
        builder for unknown pods and rsv:: reserve-pods."""
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from urllib.parse import parse_qsl

        from koordinator_tpu_torch.scheduler.services import (
            DebugApiError,
            debug_explain_body,
        )

        params = dict(parse_qsl(req.path.partition("?")[2]))
        try:
            return req._reply(200, debug_explain_body(self.scheduler, pod,
                                                      params))
        except DebugApiError as e:
            return req._reply(e.status, {"error": e.message})

    def _solve(self, req) -> None:
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        from koordinator_tpu_torch import tracing

        # a trace context in the body joins the round to the caller's
        # trace, same as the framed SOLVE_REQUEST path.  The body was
        # IGNORED before tracing existed, so a non-JSON body (curl -d
        # 'run-now') must keep triggering the round, not 500
        try:
            doc = req._body()
        except ValueError:
            doc = {}
        ctx = (tracing.TraceContext.from_doc(doc.get("trace"))
               if isinstance(doc, dict) else None)
        with tracing.activate(ctx):
            result = self.scheduler.schedule_round()
        req._reply(200, {
            "assignments": dict(result.assignments),
            "failures": {name: diag.message()
                         for name, diag in result.failures.items()},
            "nominations": {p: [n, v] for p, (n, v)
                            in result.nominations.items()},
            "round_pods": result.round_pods,
        })

    def _diagnosis(self, req) -> None:
        if self.scheduler is None:
            return req._reply(501, {"error": "no scheduler attached"})
        result = getattr(self.scheduler, "last_result", None)
        if result is None:
            return req._reply(200, {"failures": {}})
        req._reply(200, {
            "failures": {name: diag.message()
                         for name, diag in result.failures.items()},
        })

    def _hook(self, req, hook_name: str) -> None:
        if self.dispatcher is None:
            return req._reply(501, {"error": "no hook dispatcher attached"})
        from koordinator_tpu_torch.runtimeproxy import HookRequest, HookType

        try:
            hook = HookType(hook_name)
        except ValueError:
            return req._reply(400, {"error": f"unknown hook {hook_name}"})
        doc = req._body()
        request = HookRequest(
            pod_meta=doc.get("pod_meta", {}),
            container_meta=doc.get("container_meta", {}),
            labels=doc.get("labels", {}),
            annotations=doc.get("annotations", {}),
            cgroup_parent=doc.get("cgroup_parent", ""),
            resources=doc.get("resources", {}),
            envs=doc.get("envs", {}),
        )
        merged = self.dispatcher.dispatch(hook, request)
        req._reply(200, {
            "labels": merged.labels,
            "annotations": merged.annotations,
            "cgroup_parent": merged.cgroup_parent,
            "resources": merged.resources,
            "envs": merged.envs,
        })

    def _lease_get(self, req, name: str) -> None:
        if self.lease_store is None:
            return req._reply(501, {"error": "no lease store attached"})
        rec = self.lease_store.get(name)
        req._reply(200, dataclasses.asdict(rec))

    def _lease_put(self, req, name: str) -> None:
        if self.lease_store is None:
            return req._reply(501, {"error": "no lease store attached"})
        from koordinator_tpu_torch.ha import LeaseRecord

        doc = req._body()
        expect = doc.pop("expect_holder", "")
        fields = {f.name for f in dataclasses.fields(LeaseRecord)}
        rec = LeaseRecord(**{k: v for k, v in doc.items() if k in fields})
        if self.lease_store.update(name, expect, rec):
            return req._reply(200, {"ok": True})
        req._reply(409, {"ok": False, "error": "holder mismatch"})
