"""Parity of the port's ``DebugService`` (``koordinator_tpu_torch/scheduler/
services.py``) with the JAX package's, route by route.

A JAX and a port scheduler, each with its own package's ``DebugService``
(``debug_service=``), a quota tree, CPU and device managers and gangs, are
fed the same seeded cluster through each package's ``StateSyncService``
(an in-process binding) and run the same rounds on a fixed clock; the
top-N score dump is armed through ``/apis/v1/__debug/set-top-n`` before
the first.  Then every built-in route answers with the same status and the
same JSON body (as ``json.dumps`` serves it) on both, each asked straight
after the rounds, before any reset of the process-wide metrics, timeline
and journey state, and the after-rounds ones checked to be non-empty:

- the state routes (nodes, pods, gangs, quotas, reservations,
  resource-status, diagnosis, the recorded scores, set-top-n) whole;
- ``/debug/rounds`` with the flight records' time fields masked and their
  trace ids renamed by first appearance; ``/debug/timeline``'s cycles by
  their segments' (cause, name); ``/debug/latency`` by its series' counts
  (the rest are times);
- ``/debug/explain/<pod>`` whole (a pending, a bound, an unknown and a
  reserve-pod's name), and on a traced pair ``/debug/trace/<pod>`` with
  span ids renamed and times masked;
- the routes of modules the port has not copied answer as the JAX
  scheduler does without them: ``/debug/slo``, ``/debug/steady``,
  ``/debug/forecast`` and ``/debug/tenants`` 501, ``/debug/profile`` 403;
- ``/metrics``: fresh, equal but for the three HELP lines
  ``tests/test_torch_metrics.py`` allows; after the rounds, every family
  equal with the time-valued samples (the ``*_seconds`` histograms'
  buckets and sums, the timeline's gauges), ``capacity_slack`` (float32
  sums, within a relative 1e-5) and the JAX scheduler's mesh and compile
  introspection gauges masked.
"""

import json
import re

import numpy as np
import pytest

from tests.test_torch_transport import fill
from tests.torch_parity import (
    PKGS,
    reset_observability,
    rv,
    set_torch_threads,
    side,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_observability():
    reset_observability()
    yield
    reset_observability()


def debug_module(pkg):
    if pkg == "jax":
        from koordinator_tpu.scheduler import services
    else:
        from koordinator_tpu_torch.scheduler import services
    return services


def run_pair(trace_pods: bool = False) -> dict:
    """The same seeded scenario on both packages; {pkg: (scheduler,
    debug service, service)} after two rounds."""
    out = {}
    for pkg in PKGS:
        s = side(pkg)
        total = rv(400_000, 800_000).astype(np.int64)
        tree = s.QuotaTree(total)
        for name, mx in (("team-a", 20_000), ("team-b", 200_000)):
            qmax = np.full(total.shape, s.UNBOUNDED, np.int64)
            qmax[0] = mx
            tree.add(name, min=np.zeros_like(total), max=qmax)
        kw = {"mesh": "off"} if pkg == "jax" else {}
        sched = s.scheduler(managers=True, zero_thresholds=False,
                            quota_tree=tree, trace_pods=trace_pods,
                            clock=lambda: 100.0, **kw)
        # a slow dump depends on the host's speed, not on the round
        sched.flight_recorder.slow_threshold_s = float("inf")
        debug = debug_module(pkg).DebugService(sched)
        sched.debug_service = debug
        status, body = debug.handle("/apis/v1/__debug/set-top-n",
                                    {"n": "3"})
        assert (status, body) == (200, {"dump_top_n_scores": 3})
        service = s.StateSyncService()
        service.attach_binding(s.SchedulerBinding(sched))
        fill(service, np.random.default_rng(3), n_nodes=8, n_pods=20)
        for j in range(4):
            service.add_pod(f"q{j}", rv(3_000, 1_024), quota="team-a",
                            priority=100 + j)
        service.add_pod("huge", rv(900_000, 1_024), priority=50)
        sched.register_gang(s.GangRecord(name="g-ok", min_member=2))
        sched.register_gang(s.GangRecord(name="g-short", min_member=5))
        for j in range(2):
            service.add_pod(f"g-ok-{j}", rv(500, 256), gang="g-ok")
            service.add_pod(f"g-short-{j}", rv(500, 256), gang="g-short")
        sched.schedule_round()
        service.remove_pod("p0")
        service.add_pod("late", rv(1_200, 2_048), priority=7_000)
        sched.schedule_round()
        out[pkg] = (sched, debug, service)
    return out


def wire_json(body):
    """The body as the HTTP surfaces serve it."""
    if isinstance(body, str):
        return body
    return json.loads(json.dumps(body, default=str))


TIME_FIELDS = ("start_time", "duration_s", "solve_wall_s", "solve_device_s",
               "cycle_critical_cause", "cycle_critical_seconds")


def canon_rounds(body: dict) -> list:
    ids: dict = {}
    out = []
    for rec in body["rounds"]:
        rec = dict(rec)
        for k in TIME_FIELDS:
            rec[k] = "<t>"
        rec["phase_s"] = sorted(rec["phase_s"])
        rec["trace_id"] = ids.setdefault(rec["trace_id"], len(ids))
        out.append(rec)
    return out


def canon_timeline(body: dict) -> tuple:
    return (body["enabled"], body["causes"],
            [(c["cycle"], c["mode"],
              sorted((s["cause"], s["name"]) for s in c["segments"]))
             for c in body["cycles"]])


def canon_latency(body: dict) -> tuple:
    return (body["stages"], body["pending"], body["enabled"],
            [(r["tenant"], r["qos"], r["stage"], r["count"])
             for r in body["series"]])


def canon_trace(body: dict) -> dict:
    ids: dict = {}

    def cid(x):
        return None if x is None else ids.setdefault(x, len(ids))

    spans = []
    for s in body["spans"]:
        attrs = {k: ("<t>" if k in ("solve_wall_s", "solve_device_s")
                     else cid(v) if k == "round_trace_id" else v)
                 for k, v in s["attributes"].items()}
        spans.append((s["name"], s["service"], cid(s["trace_id"]),
                      cid(s["span_id"]), cid(s["parent_id"]), s["status"],
                      attrs, [e["name"] for e in s["events"]]))
    return {"pod": body["pod"], "trace_id": cid(body["trace_id"]),
            "spans": spans}


def canon_explain(body: dict) -> dict:
    """The explanation's ``update_time`` is the host's wall clock."""
    if body.get("explanation"):
        body["explanation"]["update_time"] = "<t>"
    return body


CANON = {"/debug/rounds": canon_rounds, "/debug/timeline": canon_timeline,
         "/debug/latency": canon_latency}

#: (path, query, the status both answer)
ROUTES = [
    ("/apis/v1/nodes", {}, 200), ("/apis/v1/pods", {}, 200),
    ("/apis/v1/gangs", {}, 200), ("/apis/v1/quotas", {}, 200),
    ("/apis/v1/reservations", {}, 200),
    ("/apis/v1/resource-status", {}, 200), ("/apis/v1/diagnosis", {}, 200),
    ("/apis/v1/__debug/scores", {}, 200),
    ("/debug/rounds", {"size": "8"}, 200),
    ("/debug/rounds/", {"size": "2"}, 200),
    ("/debug/timeline", {"cycles": "4"}, 200),
    ("/debug/timeline", {"cycles": "0"}, 400),
    ("/debug/latency", {}, 200), ("/debug/latency", {"tenant": "x"}, 400),
    ("/debug/slo", {}, 501), ("/debug/steady", {}, 501),
    ("/debug/forecast", {}, 501), ("/debug/tenants", {}, 501),
    ("/debug/profile", {"seconds": "1"}, 403),
    ("/debug/profile", {"seconds": "nan"}, 403),
    ("/no/such/route", {}, 404), ("/debug/explain/", {}, 404),
    ("/apis/v1/__debug/set-top-n", {"n": "2"}, 200),
]


def explain_targets(sched) -> list[str]:
    pending = sorted(sched.pending)
    bound = sorted(sched.bound)
    assert pending and bound
    return [pending[0], pending[-1], bound[0], bound[-1], "no-such-pod",
            "rsv::rsv-0", "p0"]


@pytest.fixture(scope="module")
def pair():
    """The scenario's schedulers, and every answer read straight after the
    rounds: the metric registries, the timeline recorder and the journey
    ledger are process-wide, and the autouse fixtures (this file's and
    ``tests/conftest.py``'s) clear them around each test body, so a route
    asked from a test would read a wiped state.

    {pkg: {"sched", "debug", "routes": [(status, body)] in ``ROUTES``'
    order, "explain": {candidates: [(status, body)]}, "metrics": str}}."""
    reset_observability()
    out = {}
    try:
        for pkg, (sched, debug, _) in run_pair().items():
            out[pkg] = {"sched": sched, "debug": debug}
        targets = explain_targets(out["jax"]["sched"])
        for pkg in PKGS:
            debug = out[pkg]["debug"]
            status, body = debug.handle("/metrics", {})
            assert status == 200
            out[pkg]["metrics"] = body
            out[pkg]["explain"] = {
                c: [debug.handle(f"/debug/explain/{pod}", {"candidates": c})
                    for pod in targets] for c in ("1", "0")}
            # in ROUTES' order: set-top-n (last) changes the dump's size
            out[pkg]["routes"] = [debug.handle(path, dict(params))
                                  for path, params, _ in ROUTES]
        out["explain_targets"] = targets
        yield out
    finally:
        reset_observability()


@pytest.mark.parametrize("route", range(len(ROUTES)))
def test_route_answers_alike(pair, route):
    path, params, want_status = ROUTES[route]
    answers = []
    for pkg in PKGS:
        status, body = pair[pkg]["routes"][route]
        body = wire_json(body)
        canon = CANON.get(path.rstrip("/"))
        if status == 200 and canon is not None:
            body = canon(body)
        answers.append((status, body))
    assert answers[0] == answers[1], path
    assert answers[0][0] == want_status, answers[0][1]
    if path == "/apis/v1/__debug/scores":
        assert answers[0][1] and all(len(v) == 3
                                     for v in answers[0][1].values())
    # the process-wide state the rounds left is there to be compared
    if path == "/debug/timeline" and want_status == 200:
        assert answers[0][1][2] and all(c[2] for c in answers[0][1][2])
    if path == "/debug/latency" and want_status == 200:
        assert any(r[3] for r in answers[0][1][3])
    if path == "/debug/rounds" and want_status == 200:
        assert len(answers[0][1]) == 2


def test_every_builtin_route_is_registered(pair):
    for pkg in PKGS:
        debug = pair[pkg]["debug"]
        assert set(debug._routes) == set(pair["jax"]["debug"]._routes)
        assert set(debug._prefix_routes) == {"/debug/trace/",
                                            "/debug/explain/"}
        assert (debug.dump_top_n_scores
                == pair["jax"]["debug"].dump_top_n_scores)


@pytest.mark.parametrize("candidates", ["1", "0"])
def test_explain_route_answers_alike(pair, candidates):
    for i, pod in enumerate(pair["explain_targets"]):
        answers = [pair[pkg]["explain"][candidates][i] for pkg in PKGS]
        answers = [(st, canon_explain(wire_json(b)) if st == 200
                     else wire_json(b)) for st, b in answers]
        assert answers[0] == answers[1], pod


def test_score_dump_records_equal_scores(pair):
    dumps = [pair[pkg]["debug"].last_scores for pkg in PKGS]
    assert dumps[0] == dumps[1]
    # the second round's queue: every pod the round saw, three nodes each
    assert len(dumps[1]) == pair["torch"]["sched"].last_result.round_pods
    for rows in dumps[1].values():
        assert len(rows) == 3
        scores = [r["score"] for r in rows]
        assert scores == sorted(scores, reverse=True)


def metric_samples(body: str) -> dict:
    """{family: [(sample, labels, value)]} of a classic exposition."""
    out: dict = {}
    family = None
    for line in body.splitlines():
        m = re.match(r"# HELP (\S+) ", line)
        if m:
            family = m.group(1)
            out[family] = []
            continue
        if not line or line.startswith("#"):
            continue
        m = re.match(r"(\S+?)(\{.*\})? (\S+)$", line)
        out[family].append((m.group(1), m.group(2) or "", m.group(3)))
    return out


TIME_GAUGES = ("koord_scheduler_host_wait_attribution",
               "koord_scheduler_critical_path_seconds",
               "koord_scheduler_device_idle_fraction")
JAX_ONLY = tuple("koord_scheduler_" + n for n in (
    "solver_quality_mode", "solver_recompiles_total",
    "solver_jit_cache_size", "solver_device_bytes", "solver_shard_count",
    "solver_axis_shard_count"))
SLACK = "koord_scheduler_capacity_slack_fraction"


def test_metrics_route_fresh_differs_only_in_the_allowed_help_lines():
    from tests.test_torch_metrics import compare_bodies

    debugs = [debug_module(pkg).DebugService(side(pkg).scheduler())
              for pkg in PKGS]
    # the JAX constructor sets its quality-mode gauge: start both fresh
    reset_observability()
    bodies = []
    for debug in debugs:
        status, body = debug.handle("/metrics", {})
        assert status == 200
        bodies.append(body)
    compare_bodies(bodies[1], bodies[0])


def test_metrics_route_after_the_rounds(pair):
    bodies = [metric_samples(pair[pkg]["metrics"]) for pkg in PKGS]
    want, got = bodies
    # the exposition holds the rounds: the scheduler's series are not empty
    enqueued = got["koord_scheduler_pods_enqueued_total"]
    assert enqueued and all(float(v) > 0 for _, _, v in enqueued)
    assert got[SLACK] and any(float(v) != 0 for _, _, v in got[SLACK])
    assert set(got) <= set(want)
    for family, samples in got.items():
        other = want[family]
        if family in JAX_ONLY:
            continue
        assert [(n, lbl) for n, lbl, _ in samples] == [
            (n, lbl) for n, lbl, _ in other], family
        for (name, lbl, v), (_, _, w) in zip(samples, other):
            timed = (family in TIME_GAUGES or (
                family.endswith("_seconds")
                and not name.endswith("_count")))
            if timed:
                continue
            if family == SLACK:
                assert float(v) == pytest.approx(float(w), rel=1e-5)
                continue
            assert v == w, (family, name, lbl)


def test_trace_route_on_traced_schedulers():
    pair = run_pair(trace_pods=True)
    sched = pair["jax"][0]
    pods = [sorted(sched.bound)[0], sorted(sched.pending)[0], "huge",
            "never-seen"]
    for pod in pods:
        answers = []
        for pkg in PKGS:
            status, body = pair[pkg][1].handle(f"/debug/trace/{pod}", {})
            body = wire_json(body)
            answers.append((status, canon_trace(body) if status == 200
                            else body))
        assert answers[0] == answers[1], pod
        assert answers[0][0] == (404 if pod == "never-seen" else 200)
    # the explanations carry the pods' trace ids on both sides
    for pod in pods[:2]:
        for pkg in PKGS:
            status, body = pair[pkg][1].handle(f"/debug/explain/{pod}",
                                               {"candidates": "0"})
            assert status == 200
            assert body["trace_id"] == pair[pkg][0].pod_trace_id(pod)
