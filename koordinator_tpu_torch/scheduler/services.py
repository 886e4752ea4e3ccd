"""Scheduler debug/services API (port of
``koordinator_tpu/scheduler/services.py``; reference: ``frameworkext/services/
services.go:32-51`` — a gin HTTP server where every plugin mounts endpoints
under ``/apis/v1/plugins/<name>``; plus ``frameworkext/debug.go`` runtime
flag toggles).

Transport-agnostic core: a route registry mapping paths to callables that
return JSON-able objects; ``serve_forever`` optionally exposes it over the
stdlib HTTP server. Built-in routes cover the reference's debug surface:
nodes, pending pods, gangs, quotas, last-round diagnosis, metrics scrape,
and the runtime-togglable top-N score dump.

The routes that read a module the port has not copied (the forecast plane,
tenancy) answer as the JAX package's do for a scheduler without it: 501.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

import numpy as np


class DebugApiError(Exception):
    """A debug route failing with a SPECIFIC status (gate closed, busy)
    instead of the blanket 500 — both HTTP surfaces map it verbatim."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def debug_rounds_body(scheduler, size: int) -> dict:
    """The /debug/rounds payload — ONE builder shared by DebugService
    and the HTTP gateway so the two surfaces cannot drift."""
    return {"rounds": scheduler.flight_recorder.snapshot(size)}


def debug_slo_body(scheduler) -> dict:
    """The /debug/slo payload (shared by DebugService and the HTTP
    gateway): the SLO burn-rate engine's latest evaluation."""
    monitor = getattr(scheduler, "slo_monitor", None)
    if monitor is None:
        raise DebugApiError(501, "no SLO monitor attached "
                                 "(scheduler binaries only)")
    # copy: report() may return the monitor's shared internal dict (the
    # background sampler's _last_report); inserting into it would race
    # concurrent scrapes and pollute the stored report
    body = dict(monitor.report())
    # sharded-solve introspection rides the SLO document: shard count,
    # per-device bytes, recompiles per (fn, shape@mesh) bucket
    report = getattr(scheduler, "sharding_report", None)
    if report is not None:
        body["sharding"] = report()
    return body


def debug_steady_body(scheduler, params: dict | None = None) -> dict:
    """The /debug/steady payload (shared by DebugService and the HTTP
    gateway): the long-horizon trend engine's per-series
    steady/drifting/leaking verdicts, joined to the SLO engine's breach
    state — "is this thing leaking or drifting under churn" as one
    document.

    ``?window=N`` overrides the evaluation window (seconds).  When an
    SLO monitor is attached its sampler runs first, so an on-demand
    request (no background cadence) still evaluates current telemetry;
    repeated scrapes build the window organically like /debug/slo."""
    engine = getattr(scheduler, "trend_engine", None)
    if engine is None:
        raise DebugApiError(501, "no trend engine attached "
                                 "(scheduler binaries only)")
    window = (params or {}).get("window")
    if window is not None:
        try:
            window = float(window)
        except (TypeError, ValueError):
            raise DebugApiError(400, "window must be a number") from None
        if not (window > 0):   # also rejects NaN
            raise DebugApiError(400, "window must be positive")
    monitor = getattr(scheduler, "slo_monitor", None)
    if monitor is not None:
        monitor.sample_once()
    body = engine.evaluate(window_s=window)
    if monitor is not None:
        slo = monitor.report()
        body["slo_breached"] = slo.get("breached", [])
        body["slo_breaches_total"] = {
            d["name"]: d["breaches_total"] for d in slo.get("slos", [])}
    return body


def debug_forecast_body(scheduler, params: dict | None = None) -> dict:
    """The /debug/forecast payload (shared by DebugService and the HTTP
    gateway): the forecast plane's horizon policy, prediction-error
    stats, and per-node predicted peaks — plus the scheduler's mode and
    the last admission-reserve fraction.

    ``?nodes=N`` bounds the per-node section (default 64, ordered by
    predicted CPU peak — the nodes the plane is about to act on).
    Typed 501 without a plane (forecast mode off / non-scheduler
    binaries), 400 on a malformed bound."""
    plane = getattr(scheduler, "forecast_plane", None)
    if plane is None:
        raise DebugApiError(501, "no forecast plane attached "
                                 "(--forecast-mode off or non-scheduler "
                                 "binary)")
    nodes = (params or {}).get("nodes", 64)
    try:
        nodes = int(nodes)
    except (TypeError, ValueError):
        raise DebugApiError(400, "nodes must be an integer") from None
    if nodes < 0:
        raise DebugApiError(400, "nodes must be >= 0")
    snapshot = getattr(scheduler, "snapshot", None)
    row_names = ({row: name for name, row in snapshot.node_index.items()}
                 if snapshot is not None else None)
    # the reserve fraction rides the plane's report (per-plane state —
    # a shared global gauge would cross tenants' planes)
    body = plane.report(max_nodes=nodes, row_names=row_names)
    body["mode"] = getattr(scheduler, "forecast_mode", "off")
    from koordinator_tpu_torch import metrics

    body["evictions_prestaged_total"] = sum(
        v for _, v in metrics.forecast_evictions_prestaged.items())
    return body


def debug_tenants_body(scheduler) -> dict:
    """The /debug/tenants payload (shared by DebugService and the HTTP
    gateway): the multi-tenant front-end's rollup — per-tenant
    weight/share/credit, queue depth, degraded/suspension state, last
    solve path, plus the cycle's dispatch mode and host-wait fraction.

    Served through ANY tenant's scheduler (each per-tenant Scheduler
    carries a ``tenant_front`` back-reference) or directly through a
    tenancy front-end (the JAX package's ``TenantScheduler``; the port
    has none yet); a single-tenant scheduler answers a typed 501."""
    front = (scheduler if hasattr(scheduler, "tenants_report")
             else getattr(scheduler, "tenant_front", None))
    if front is None:
        raise DebugApiError(501, "no tenancy front-end attached "
                                 "(multi-tenant schedulers only)")
    return front.tenants_report()


def debug_timeline_body(scheduler, params: dict | None = None) -> dict:
    """The /debug/timeline?cycles=N payload (shared by DebugService and
    the HTTP gateway): the critical-path observatory's reconstructed
    cycle gantts, newest first — typed segments, the wall-time
    attribution by cause (sums to 1.0 with an explicit unattributed
    residual), device-idle intervals derived from the dispatch/block
    edges, and the cycle's critical-path chain + dominant cause.

    The recorder is process-wide (``timeline.RECORDER``): a
    multi-tenant front's cycles and an untenanted scheduler's
    one-round cycles land in the same ring.  400 on a malformed
    bound; an empty ``cycles`` list (not an error) means no cycle has
    run with the recorder armed (e.g. ``--no-timeline``)."""
    from koordinator_tpu_torch import timeline

    cycles = (params or {}).get("cycles", 8)
    try:
        cycles = int(cycles)
    except (TypeError, ValueError):
        raise DebugApiError(400, "cycles must be an integer") from None
    if cycles < 1:
        raise DebugApiError(400, "cycles must be >= 1")
    return {
        "enabled": timeline.RECORDER.enabled,
        "causes": list(timeline.ATTRIBUTION_CAUSES),
        "cycles": timeline.RECORDER.cycles(cycles),
    }


def debug_latency_body(scheduler, params: dict | None = None) -> dict:
    """The /debug/latency?tenant= payload (shared by DebugService and the
    HTTP gateway): the pod-journey ledger's per-(tenant, qos, stage)
    latency quantile table — TRUE per-pod arrival->bind e2e quantiles
    plus the stage decomposition (ingest, queue_wait, solve, commit),
    each from a mergeable log-bucketed sketch with <=1% relative error.

    501 when the ledger is off (``KOORD_JOURNEY=0`` / ``--no-journey``);
    400 (typed) on a tenant filter that matches no recorded series."""
    from koordinator_tpu_torch import journey

    if not journey.LEDGER.enabled:
        raise DebugApiError(501, "journey ledger disabled "
                                 "(KOORD_JOURNEY=0 / --no-journey)")
    tenant = (params or {}).get("tenant")
    if tenant is not None:
        known = journey.LEDGER.tenants()
        if tenant not in known:
            raise DebugApiError(
                400, f"unknown tenant {tenant!r} "
                     f"(recorded: {', '.join(known) or 'none yet'})")
    doc = journey.LEDGER.report(tenant=tenant)
    doc["stages"] = list(journey.STAGES)
    doc["pending"] = journey.LEDGER.pending_count()
    return doc


def debug_profile_body(scheduler, seconds) -> dict:
    """The /debug/profile?seconds=N payload: an on-demand torch.profiler
    capture.  403 while the gate is off (the default), 400 for a
    ``seconds`` that is not a finite number, 409 while a capture is in
    flight — shared by both HTTP surfaces."""
    from koordinator_tpu_torch.ops.introspection import (
        ProfileBusy,
        ProfileDisabled,
    )

    capture = getattr(scheduler, "profile_capture", None)
    if capture is None:
        raise DebugApiError(403, "profiling endpoint disabled (enable at "
                                 "assembly with --enable-profile-endpoint)")
    import math

    try:
        seconds_f = float(seconds)
    except (TypeError, ValueError):
        raise DebugApiError(400, "seconds must be a number") from None
    if not math.isfinite(seconds_f):
        # nan survives float() and min/max clamping — it would start a
        # trace and then die in sleep() as a blanket 500
        raise DebugApiError(400, "seconds must be finite")
    try:
        return capture.capture(seconds_f)
    except ProfileDisabled as e:
        raise DebugApiError(403, str(e)) from None
    except ProfileBusy as e:
        raise DebugApiError(409, str(e)) from None


def debug_trace_body(scheduler, pod: str) -> dict:
    """The /debug/trace/<pod> payload; shared by DebugService and the
    HTTP gateway.  ``pod`` may arrive percent-encoded from either HTTP
    surface.  Unknown pods raise a TYPED 404 :class:`DebugApiError` so
    both surfaces serve the same status + body (previously the gateway
    and DebugService each hand-rolled the mapping)."""
    from urllib.parse import unquote

    from koordinator_tpu_torch import tracing

    pod = unquote(pod)
    trace_id = scheduler.pod_trace_id(pod)
    if trace_id is None:
        raise DebugApiError(404, f"no trace recorded for pod {pod!r}")
    return {"pod": pod, "trace_id": trace_id,
            "spans": [s.to_doc() for s in
                      tracing.TRACER.spans_for_trace(trace_id)]}


def debug_explain_body(scheduler, pod: str,
                       params: dict | None = None) -> dict:
    """The /debug/explain/<pod> payload (shared by DebugService and the
    HTTP gateway): the pod's retained :class:`~koordinator_tpu_torch.scheduler.
    explanation.PlacementExplanation` (reject-reason node counts joined
    to its trace_id and round) plus an on-demand per-term score
    decomposition of its current winning/top-k candidate nodes.

    ``?candidates=0`` skips the decomposition: it runs a (1, N) score
    pass under the scheduler's round lock, which a single operator query
    wants inline but a many-pod polling loop (tools/explain_summary.py)
    must not serialize rounds behind.

    Typed statuses: 404 for a pod the scheduler has never seen (no
    explanation retained, not pending, not bound) and for reserve-pods
    (``rsv::`` placement vehicles are not user workloads — query the
    reservation via /apis/v1/reservations instead)."""
    from urllib.parse import unquote

    from koordinator_tpu_torch.scheduler.scheduler import RSV_POD_PREFIX

    want_candidates = str((params or {}).get("candidates", "1")
                          ).strip().lower() not in ("0", "false", "no",
                                                    "off")
    pod = unquote(pod)
    if pod.startswith(RSV_POD_PREFIX):
        raise DebugApiError(
            404, f"reserve-pod {pod!r} is a placement vehicle, not a "
                 "workload; its reservation is served at "
                 "/apis/v1/reservations")
    explanation = scheduler.pod_explanation(pod)
    pending = pod in scheduler.pending
    bound = scheduler.bound.get(pod)
    if explanation is None and not pending and bound is None:
        raise DebugApiError(
            404, f"no explanation recorded for pod {pod!r}")
    body = {
        "pod": pod,
        "status": ("bound" if bound is not None
                   else "pending" if pending else "gone"),
        "trace_id": scheduler.pod_trace_id(pod),
        "explanation": explanation.to_doc() if explanation else None,
        "explain_enabled": scheduler.explain,
    }
    if bound is not None:
        body["node"] = bound.node
    if want_candidates:
        candidates = scheduler.explain_candidates(pod)
        if candidates is not None:
            body["candidates"] = candidates
    return body


class DebugService:
    def __init__(self, scheduler=None):
        self.scheduler = scheduler
        self._routes: dict[str, Callable[[dict], object]] = {}
        self._prefix_routes: dict[str, Callable[[str, dict], object]] = {}
        self._lock = threading.Lock()
        #: debug.go: runtime-togglable top-N score dumping (0 = off)
        self.dump_top_n_scores = 0
        self.last_scores: Optional[dict] = None
        if scheduler is not None:
            self._register_builtin()

    # -- registry (plugins mount under /apis/v1/plugins/<name>/...) ----------

    def register(self, path: str, handler: Callable[[dict], object]) -> None:
        with self._lock:
            self._routes[path.rstrip("/")] = handler

    def register_plugin(self, plugin_name: str, sub_path: str,
                        handler: Callable[[dict], object]) -> None:
        self.register(f"/apis/v1/plugins/{plugin_name}/{sub_path.lstrip('/')}",
                      handler)

    def register_prefix(self, prefix: str,
                        handler: Callable[[str, dict], object]) -> None:
        """Parameterized route: ``handler(rest, params)`` receives the
        path remainder after ``prefix`` (e.g. the pod name under
        ``/debug/trace/``)."""
        with self._lock:
            self._prefix_routes[prefix] = handler

    def handle(self, path: str, params: dict | None = None) -> tuple[int, object]:
        """(status, body) — the transport-agnostic request entry."""
        with self._lock:
            handler = self._routes.get(path.rstrip("/"))
            prefix_routes = dict(self._prefix_routes)
        if handler is None:
            for prefix, ph in prefix_routes.items():
                if path.startswith(prefix) and len(path) > len(prefix):
                    rest = path[len(prefix):]
                    try:
                        return 200, ph(rest, params or {})
                    except DebugApiError as e:
                        return e.status, {"error": e.message}
                    except KeyError as e:
                        return 404, {"error": str(e)}
                    except Exception as e:  # noqa: BLE001
                        return 500, {"error": str(e)}
            return 404, {"error": f"no route {path}"}
        try:
            return 200, handler(params or {})
        except DebugApiError as e:
            return e.status, {"error": e.message}
        except Exception as e:  # noqa: BLE001 — debug API must not crash
            return 500, {"error": str(e)}

    # -- built-in routes ------------------------------------------------------

    def _register_builtin(self) -> None:
        self.register("/apis/v1/nodes", self._nodes)
        self.register("/apis/v1/pods", self._pods)
        self.register("/apis/v1/gangs", self._gangs)
        self.register("/apis/v1/quotas", self._quotas)
        self.register("/apis/v1/reservations", self._reservations)
        self.register("/apis/v1/resource-status", self._resource_status)
        self.register("/apis/v1/diagnosis", self._diagnosis)
        self.register("/apis/v1/__debug/scores", self._scores)
        self.register("/apis/v1/__debug/set-top-n", self._set_top_n)
        self.register("/metrics", self._metrics)
        self.register("/debug/rounds", self._rounds)
        self.register("/debug/slo", self._slo)
        self.register("/debug/steady", self._steady)
        self.register("/debug/forecast", self._forecast)
        self.register("/debug/tenants", self._tenants)
        self.register("/debug/timeline", self._timeline)
        self.register("/debug/latency", self._latency)
        self.register("/debug/profile", self._profile)
        self.register_prefix("/debug/trace/", self._trace)
        self.register_prefix("/debug/explain/", self._explain)

    def _nodes(self, params: dict) -> object:
        snapshot = self.scheduler.snapshot
        out = []
        for name, row in snapshot.node_index.items():
            spec = snapshot.node_specs.get(name)
            out.append({
                "name": name, "row": row,
                "allocatable": (
                    np.asarray(spec.allocatable).tolist() if spec else None
                ),
            })
        return out

    def _pods(self, params: dict) -> object:
        return [
            {"name": p.name, "priority": p.priority, "gang": p.gang,
             "quota": p.quota, "requests": np.asarray(p.requests).tolist()}
            for p in self.scheduler.pending.values()
        ]

    def _gangs(self, params: dict) -> object:
        return [
            {"name": g.name, "min_member": g.min_member,
             "rejected": g.rejected,
             "first_failure": g.first_failure}
            for g in self.scheduler.gangs.values()
        ]

    def _quotas(self, params: dict) -> object:
        tree = self.scheduler.quota_tree
        if tree is None:
            return []
        return [
            {"name": name,
             "min": np.asarray(node.min).tolist(),
             "max": np.asarray(node.max).tolist(),
             "used": np.asarray(node.used).tolist(),
             "runtime": np.asarray(tree.runtime_of(name)).tolist()}
            for name, node in tree.nodes.items()
        ]

    def _resource_status(self, params: dict) -> object:
        """Fine-grained allocation annotations per bound pod (cpuset
        resource-status + device-allocated payloads)."""
        return dict(self.scheduler.resource_status)

    def _reservations(self, params: dict) -> object:
        return [
            {"name": s.name, "phase": s.phase.value, "node": s.node,
             "requests": np.asarray(s.requests).tolist(),
             "allocated": (np.asarray(s.allocated).tolist()
                           if s.allocated is not None else None),
             "owner_pods": list(s.owner_pods),
             "allocate_once": s.allocate_once}
            for s in self.scheduler.reservations.specs()
        ]

    def _diagnosis(self, params: dict) -> object:
        import dataclasses as _dc

        result = getattr(self.scheduler, "last_result", None)
        if result is None:
            return {}
        return {
            pod: _dc.asdict(d) if _dc.is_dataclass(d) else str(d)
            for pod, d in result.failures.items()
        }

    def _scores(self, params: dict) -> object:
        return self.last_scores or {}

    def _set_top_n(self, params: dict) -> object:
        self.dump_top_n_scores = int(params.get("n", 0))
        return {"dump_top_n_scores": self.dump_top_n_scores}

    def _metrics(self, params: dict) -> object:
        from koordinator_tpu_torch import metrics

        # aggregate exposition (all component registries): the same
        # scrape body the HTTP gateway serves, so both debug surfaces
        # agree; ?openmetrics=1 adds histogram exemplars
        return metrics.expose_all(openmetrics=metrics.parse_openmetrics_flag(
            params.get("openmetrics", "0")))

    def _rounds(self, params: dict) -> object:
        """The round flight recorder, newest first (?size=N)."""
        return debug_rounds_body(self.scheduler,
                                 int(params.get("size", 32)))

    def _slo(self, params: dict) -> object:
        """The SLO burn-rate engine's evaluation (/debug/slo)."""
        return debug_slo_body(self.scheduler)

    def _steady(self, params: dict) -> object:
        """The trend engine's steady-state verdicts (/debug/steady,
        ?window=N overrides the evaluation window)."""
        return debug_steady_body(self.scheduler, params)

    def _forecast(self, params: dict) -> object:
        """The forecast plane's horizon/error/per-node-peak document
        (/debug/forecast, ?nodes=N bounds the node section); typed 501
        without a plane."""
        return debug_forecast_body(self.scheduler, params)

    def _tenants(self, params: dict) -> object:
        """The multi-tenant rollup (/debug/tenants): per-tenant
        shares/queues/degraded state + cycle dispatch mode; typed 501
        without a tenancy front-end."""
        return debug_tenants_body(self.scheduler)

    def _timeline(self, params: dict) -> object:
        """The critical-path observatory's reconstructed cycle gantts
        (/debug/timeline?cycles=N): segments, wall-time attribution,
        device-idle intervals, critical path per cycle."""
        return debug_timeline_body(self.scheduler, params)

    def _latency(self, params: dict) -> object:
        """Pod-journey latency quantile table (/debug/latency?tenant=):
        per-(tenant, qos, stage) e2e + stage sketches; 501 when the
        ledger is off, typed 400 on an unknown tenant filter."""
        return debug_latency_body(self.scheduler, params)

    def _profile(self, params: dict) -> object:
        """On-demand torch.profiler capture (/debug/profile?seconds=N);
        403 unless the gate was enabled at assembly."""
        return debug_profile_body(self.scheduler,
                                  params.get("seconds", 1.0))

    def _trace(self, pod: str, params: dict) -> object:
        """Recent spans of one pod's trace (/debug/trace/<pod>);
        unknown pods surface the builder's typed 404."""
        return debug_trace_body(self.scheduler, pod)

    def _explain(self, pod: str, params: dict) -> object:
        """One pod's placement explanation (/debug/explain/<pod>):
        reject-reason node counts + candidate score decomposition
        (?candidates=0 skips the decomposition for polling loops)."""
        return debug_explain_body(self.scheduler, pod, params)

    def record_scores(self, pods: list, scores: np.ndarray,
                      node_names: list[str]) -> None:
        """Called by the scheduler after a solve when dumping is on."""
        n = self.dump_top_n_scores
        if n <= 0:
            return
        top = {}
        for i, pod in enumerate(pods):
            row = np.asarray(scores[i])
            order = np.argsort(row)[::-1][:n]
            top[getattr(pod, "name", str(i))] = [
                {"node": node_names[j] if j < len(node_names) else str(j),
                 "score": float(row[j])}
                for j in order
            ]
        self.last_scores = top

    # -- optional stdlib HTTP transport ---------------------------------------

    def serve_forever(self, port: int = 10251):  # pragma: no cover - manual
        from http.server import BaseHTTPRequestHandler, HTTPServer
        from urllib.parse import parse_qsl, urlparse

        service = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                parsed = urlparse(self.path)
                status, body = service.handle(
                    parsed.path, dict(parse_qsl(parsed.query))
                )
                if isinstance(body, str):
                    payload = body.encode()
                    ctype = "text/plain"
                else:
                    payload = json.dumps(body, default=str).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        HTTPServer(("127.0.0.1", port), Handler).serve_forever()
