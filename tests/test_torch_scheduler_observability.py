"""Parity of the port's observability hooks with the JAX
``Scheduler(mesh="off")``, round by round: the traces, the flight records,
the scheduler's metric series, the timeline cycles and the journey.

An ``ObsTwin`` (the gates suite's twin: binds, failures, pending, node
accounting, bound records, reservations, quota, managers, explanations and
the gates' state compared after every round) runs both schedulers with
``trace_pods=True``, an in-memory exporter on each package's tracer, the
timeline recorder and the journey ledger on, and compares after every
round:

- the finished spans in export order: names, services, attributes and the
  parent structure, with trace and span ids renamed by first appearance
  and the time-valued attributes (``solve_wall_s``, ``solve_device_s``)
  masked;
- the flight records field by field, their time fields (``start_time``,
  ``duration_s``, ``solve_wall_s``, ``solve_device_s``, the cycle's
  critical cause and seconds) masked and ``phase_s`` by its keys;
- every series of the scheduler registry: counters' and gauges' label sets
  and values, a time-valued histogram's label sets and counts, other
  histograms whole; the time-valued gauges (the timeline's) by their label
  sets; ``capacity_slack`` within a relative 1e-5 (two float32 sums whose
  order torch and XLA choose); the JAX scheduler's quality-mode and
  compile and mesh introspection gauges, which the port does not have, are
  left out;
- the timeline cycles' segments by (cause, name);
- the journey's counts by (tenant, qos, stage);
- the pods' trace registries, and each explanation's ``trace_id`` (set on
  both).

The flight recorders' slow threshold is lifted on both sides (a slow dump
depends on the host's speed, not on the round); the slow dump is held in
tests/test_torch_flight_recorder.py.  The last test holds the port's
binds bit-identical with every hook on and every hook off, as
tests/test_journey.py does for the JAX scheduler.
"""

import math

import numpy as np
import pytest

from tests.test_torch_scheduler_gates import (
    BE,
    Elector,
    GateTwin,
    batch_node,
    bvec,
)
from tests.test_torch_scheduler_placement import (
    cpu_state,
    device_state,
    masked,
    node,
    pod,
)
from tests.torch_parity import (
    CPU,
    R,
    reset_observability,
    set_torch_threads,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_observability():
    reset_observability()
    yield
    reset_observability()


PREFIX = "koord_scheduler_"
#: the JAX scheduler's gauges of paths the port does not have (quality
#: mode, the jit and mesh introspection)
LEFT_OUT = {PREFIX + n for n in (
    "solver_quality_mode", "solver_recompiles_total",
    "solver_jit_cache_size", "solver_device_bytes", "solver_shard_count",
    "solver_axis_shard_count")}
TIME_HISTOGRAMS = {PREFIX + n for n in (
    "scheduling_duration_seconds", "solver_batch_duration_seconds",
    "solver_device_duration_seconds")}
TIME_GAUGES = {PREFIX + n for n in (
    "host_wait_attribution", "critical_path_seconds", "device_idle_fraction")}
SLACK = PREFIX + "capacity_slack_fraction"
#: relative tolerance of capacity_slack: float32 sums in another order
SLACK_RTOL = 1e-5
TIME_ATTRIBUTES = ("solve_wall_s", "solve_device_s")
TIME_FIELDS = ("start_time", "duration_s", "solve_wall_s", "solve_device_s",
               "cycle_critical_cause", "cycle_critical_seconds")


def canon_spans(spans):
    """Spans in export order with their ids renamed by first appearance;
    returns (the docs, the renaming)."""
    ids: dict = {}

    def cid(x):
        return None if x is None else ids.setdefault(x, len(ids))

    out = []
    for s in spans:
        attrs = {}
        for k, v in s.attributes.items():
            if k in TIME_ATTRIBUTES:
                v = "<t>"
            elif k == "round_trace_id" and v is not None:
                v = ("id", cid(v))
            attrs[k] = v
        out.append((s.name, s.service, cid(s.trace_id), cid(s.span_id),
                    cid(s.parent_id), s.status, attrs,
                    [e["name"] for e in s.events]))
    return out, ids


def flight_docs(recorder, ids):
    out = []
    for rec in recorder.records:
        d = rec.to_doc()
        for k in TIME_FIELDS:
            d[k] = "<t>"
        d["phase_s"] = sorted(d["phase_s"])
        d["trace_id"] = ids[d["trace_id"]]
        out.append(d)
    return out


def series(mod):
    """{metric name -> comparable form} of a package's scheduler registry."""
    out = {}
    for name, m in mod.SCHEDULER.items():
        if name in LEFT_OUT:
            continue
        if isinstance(m, mod.Histogram):
            st = sorted((sorted(lbl.items()), counts, total, s)
                        for lbl, counts, total, s in m.state())
            if name in TIME_HISTOGRAMS:
                st = [(lbl, total) for lbl, _c, total, _s in st]
            out[name] = st
        else:
            items = sorted((sorted(lbl.items()), v) for lbl, v in m.items())
            if name in TIME_GAUGES:
                items = [lbl for lbl, _v in items]
            out[name] = items
    return out


def cycles(recorder):
    return [(c["cycle"], c["mode"],
             sorted((s["cause"], s["name"]) for s in c["segments"]))
            for c in recorder.cycles(limit=64)]


def journey_counts(ledger):
    return {(r["tenant"], r["qos"], r["stage"]): r["count"]
            for r in ledger.report()["series"]}


def strip_trace(status: dict, key: str) -> dict:
    return {name: {k: ("<trace>" if k == key else v) for k, v in s.items()}
            for name, s in status.items()}


class ObsTwin(GateTwin):
    """The gates suite's twin with every observability hook on and the
    hooks' outputs in the comparison."""

    def __init__(self, nodes, **kw):
        from koordinator_tpu import tracing as jt

        from koordinator_tpu_torch import tracing as tt

        kw.setdefault("trace_pods", True)
        super().__init__(nodes, **kw)
        self.jspans, self.tspans = jt.InMemoryExporter(), tt.InMemoryExporter()
        jt.TRACER.add_exporter(self.jspans)
        tt.TRACER.add_exporter(self.tspans)
        for s in (self.j, self.p):
            s.flight_recorder.slow_threshold_s = math.inf
        self.slacks = []

    @staticmethod
    def explanation_docs(sched) -> list[dict]:
        # the trace ids are random: compared by presence (and below, equal
        # to the scheduler's own registry)
        return [dict(d, trace_id=d["trace_id"] and "<trace>")
                for d in GateTwin.explanation_docs(sched)]

    def check_fine_grained(self):
        # the trace annotation carries random ids: its presence compared
        from koordinator_tpu import tracing as jt

        from koordinator_tpu_torch import tracing as tt

        j, p = self.j, self.p
        assert tt.TRACE_ANNOTATION == jt.TRACE_ANNOTATION
        assert (masked(strip_trace(p.resource_status, tt.TRACE_ANNOTATION))
                == masked(strip_trace(j.resource_status,
                                      jt.TRACE_ANNOTATION)))
        assert cpu_state(p.cpu_manager) == cpu_state(j.cpu_manager)
        assert device_state(p.device_manager) == device_state(
            j.device_manager)

    def check(self, jr, tr):
        super().check(jr, tr)
        from koordinator_tpu import journey as jj
        from koordinator_tpu import metrics as jm
        from koordinator_tpu import timeline as jtl

        from koordinator_tpu_torch import journey, metrics, timeline

        j, p = self.j, self.p
        jdocs, jids = canon_spans(self.jspans.spans)
        tdocs, tids = canon_spans(self.tspans.spans)
        assert tdocs == jdocs
        assert flight_docs(p.flight_recorder, tids) == flight_docs(
            j.flight_recorder, jids)
        assert p.flight_recorder.dumps == j.flight_recorder.dumps
        assert p.flight_recorder.overwrites == j.flight_recorder.overwrites
        got, want = series(metrics), series(jm)
        assert sorted(got) == sorted(want)
        slack_got, slack_want = got.pop(SLACK), want.pop(SLACK)
        assert got == want
        assert [lbl for lbl, _ in slack_got] == [lbl for lbl, _ in slack_want]
        for (_, a), (_, b) in zip(slack_got, slack_want):
            assert a == pytest.approx(b, rel=SLACK_RTOL)
        self.slacks.append(slack_got)
        tcycles = cycles(timeline.RECORDER)
        assert tcycles == cycles(jtl.RECORDER)
        for c in timeline.RECORDER.cycles(limit=64):
            assert sum(c["attribution"].values()) == pytest.approx(1.0)
            assert 0.0 <= c["device_idle_fraction"] <= 1.0
        assert journey_counts(journey.LEDGER) == journey_counts(jj.LEDGER)
        assert sorted(p._pod_trace_ids) == sorted(j._pod_trace_ids)
        assert sorted(p.pod_traces) == sorted(j.pod_traces)
        for name in j.explain_ring._ring:
            je, te = j.pod_explanation(name), p.pod_explanation(name)
            assert (te.trace_id is None) == (je.trace_id is None)
            assert te.trace_id == p.pod_trace_id(name)

    def spans(self, name):
        return [s for s in self.tspans.spans if s.name == name]


def pods_of(rng, prefix, count, arrival=False, **kw):
    out = []
    for j in range(count):
        out.append(pod(f"{prefix}{j}", cpu=int(rng.integers(100, 4_000)),
                       mem=int(rng.integers(128, 8_192)),
                       priority=int(rng.integers(0, 9)),
                       qos=int(rng.integers(0, 3)),
                       arrival_ts=(1e9 + j) if arrival else 0.0, **kw))
    return out


def cluster(rng, n):
    return [node(f"n{i}", cpu=int(rng.integers(8_000, 64_000)),
                 mem=int(rng.integers(16_384, 262_144))) for i in range(n)]


def test_constructor_takes_trace_pods_and_the_ring_size():
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    snap = ClusterSnapshot(8, device="cpu")
    plain = Scheduler(snap, device="cpu")
    assert plain.trace_pods is False
    assert plain.flight_recorder.capacity == 256
    assert plain.flight_recorder.slow_threshold_s == plain.monitor.timeout_sec
    s = Scheduler(snap, device="cpu", trace_pods=True, flight_ring_size=7)
    assert s.trace_pods is True and s.flight_recorder.capacity == 7


def test_cold_incremental_and_greedy_rounds():
    rng = np.random.default_rng(170)
    nodes = cluster(rng, 200)
    tw = ObsTwin(nodes, capacity=256, batch_solver_threshold=64)
    for s in (tw.j, tw.p):
        s.incremental_dirty_threshold = 1.0
    tw.enqueue(*pods_of(rng, "a", 300, arrival=True))
    tw.round()
    assert tw.p.last_solve_path == "full_cold"
    for i in rng.choice(200, 4, replace=False):
        usage = np.zeros(R, np.int32)
        usage[CPU] = int(rng.integers(0, 4_000))
        tw.upsert_node(dict(nodes[i], usage=usage))
    tw.enqueue(*pods_of(rng, "b", 120))
    tw.round()
    assert tw.p.last_solve_path == "incremental"
    for s in (tw.j, tw.p):
        s.batch_solver_threshold = 10**6
    tw.enqueue(*pods_of(rng, "c", 40, arrival=True))
    res = tw.round()
    assert tw.p.last_solver == "greedy" and res.assignments
    rounds = tw.spans("scheduler.round")
    assert len(rounds) == 3
    assert [r.attributes["solve_path"] for r in rounds] == [
        "full_cold", "incremental", "greedy"]
    assert len(tw.spans("scheduler.enqueue")) == 460
    assert len(tw.spans("scheduler.bind")) == len(tw.p.bound)
    from koordinator_tpu_torch import journey, metrics, tracing

    assert metrics.incremental_solve_total.items() == [
        ({"path": "full_cold"}, 1.0), ({"path": "incremental"}, 1.0)]
    assert all(tracing.TRACE_ANNOTATION in tw.p.resource_status[n]
               for n in tw.p.bound)
    e2e = sum(r["count"] for r in journey.LEDGER.report()["series"]
              if r["stage"] == "e2e")
    ingest = sum(r["count"] for r in journey.LEDGER.report()["series"]
                 if r["stage"] == "ingest")
    assert e2e == len(tw.p.bound)
    assert 0 < ingest < e2e
    assert [r.placed for r in tw.p.flight_recorder.records] == [
        r.attributes["placed"] for r in rounds]


def test_quota_backlog_and_diagnose():
    rng = np.random.default_rng(171)
    # the full path ("disabled"): on the CPU the JAX scheduler's
    # incremental finish writes pass 2's binds into a read-only view of
    # pass 1's result, so a backlog that pass 2 places raises there
    tw = ObsTwin(cluster(rng, 120), capacity=128, quota=True,
                 batch_solver_threshold=64, incremental_solve=False)
    quotas = ["qa", "qb", "qc", None]
    batch = []
    for k, p in enumerate(pods_of(rng, "q", 400)):
        p["requests"][CPU] *= 8
        batch.append(dict(p, quota=quotas[k % 4]))
    big = [pod(f"big{j}", cpu=900_000, mem=1_024) for j in range(3)]
    tw.enqueue(*batch, *big)
    res = tw.round()
    assert res.failures and "big0" in res.failures
    tw.enqueue(*pods_of(rng, "r", 100, quota="qa"))
    res = tw.round()
    assert any(d.quota_rejected for d in res.failures.values())
    from koordinator_tpu_torch import metrics

    top = dict((lbl["reason"], v) for lbl, v in
               metrics.unschedulable_pods.items())
    explained = [e for e in tw.p.explain_ring._ring.values()
                 if e.round == tw.p.round_seq and e.top_reason()]
    assert sum(top.values()) == len(explained) > 0
    assert top["quota"] > 0
    assert metrics.filter_reject_fraction.state()
    assert len(tw.slacks[-1]) == R


def test_gang_round():
    rng = np.random.default_rng(172)
    tw = ObsTwin(cluster(rng, 64), capacity=64, batch_solver_threshold=32)
    tw.gang("g-ok", 4)
    tw.gang("g-short", 6)
    pods = pods_of(rng, "s", 60)
    pods += [pod(f"gok{j}", cpu=500, mem=512, gang="g-ok") for j in range(5)]
    pods += [pod(f"gsh{j}", cpu=500, mem=512, gang="g-short")
             for j in range(3)]
    tw.enqueue(*pods)
    res = tw.round()
    assert tw.p.last_solve_path == "full_gang"
    assert "gok0" in res.assignments and "gsh0" in res.failures
    assert tw.p.pod_explanation("gsh0").trace_id is not None
    tw.t = 700.0                     # past the 600 s WaitTime
    tw.enqueue(*pods_of(rng, "t", 10))
    tw.round()
    assert tw.p.gangs["g-short"].rejected
    tw.round()
    assert tw.p._last_gang_rejected_names == ["gsh0", "gsh1", "gsh2"]
    assert tw.p.pod_explanation("gsh0").reasons == {"gang_barrier": 64}


def test_degraded_round_with_suspended_pods():
    tw = ObsTwin([batch_node(f"n{i}") for i in range(4)],
                 staleness_threshold_sec=10.0)
    tw.sync()
    tw.enqueue(pod("prod-1"), pod("be-1", cpu=500, mem=256, qos=BE),
               dict(name="batch-1", requests=bvec(batch_cpu=500,
                                                  batch_mem=256)))
    tw.t = 5.0
    tw.round()
    tw.enqueue(pod("prod-2"), pod("be-2", cpu=500, mem=256, qos=BE),
               dict(name="batch-2", requests=bvec(batch_cpu=500,
                                                  batch_mem=256)))
    tw.t = 16.0
    tw.round()
    assert tw.p.degraded and tw.p.last_suspended == 2
    rec = tw.p.flight_recorder.last()
    assert rec.degraded and rec.dump_reason == "degraded"
    assert rec.suspended == 2 and rec.solve_path == "greedy"
    from koordinator_tpu_torch import metrics

    assert metrics.degraded_mode.value() == 1.0
    assert metrics.degraded_suspended_pods.value() == 2.0
    assert metrics.degraded_transitions_total.value(
        labels={"phase": "enter"}) == 1.0
    assert metrics.state_staleness_seconds.value() == 16.0
    tw.t = 17.0
    tw.sync()
    tw.round()
    assert not tw.p.degraded
    assert metrics.degraded_transitions_total.value(
        labels={"phase": "exit"}) == 1.0
    assert metrics.degraded_suspended_pods.value() == 0.0


def test_elector_and_barrier_gated_rounds():
    rng = np.random.default_rng(173)
    tw = ObsTwin(cluster(rng, 16), barrier=True)
    elector = Elector(leading=False)
    tw.j.elector = tw.p.elector = elector
    for b in (tw.j.barrier, tw.p.barrier):
        b.start()
    tw.enqueue(*pods_of(rng, "e", 12))
    tw.round()
    elector.leading = True
    tw.round()
    tw.seen[0] = tw.version[0]
    res = tw.round()
    assert res.assignments
    rounds = tw.spans("scheduler.round")
    assert [r.attributes.get("gated") for r in rounds] == [True, True, None]
    assert "solver" not in rounds[0].attributes
    assert [r.round for r in tw.p.flight_recorder.records] == [3]
    from koordinator_tpu_torch import metrics, timeline

    assert [c["cycle"] for c in timeline.RECORDER.cycles()] == [3]
    assert metrics.pending_pods.value() == float(len(tw.p.pending))


def test_propagated_context_traces_without_trace_pods():
    from koordinator_tpu import tracing as jt

    from koordinator_tpu_torch import tracing as tt

    rng = np.random.default_rng(174)
    tw = ObsTwin(cluster(rng, 8), capacity=8, trace_pods=False)
    tw.enqueue(*pods_of(rng, "u", 3))
    spec = pods_of(rng, "v", 1)[0]
    with jt.TRACER.span("submit"), tt.TRACER.span("submit") as sp:
        tw.enqueue(spec)
    assert tw.p.pod_trace_id("v0") == sp.trace_id
    assert tw.p.pod_trace_id("u0") is None
    tw.round()
    binds = tw.spans("scheduler.bind")
    assert [s.attributes["pod"] for s in binds] == ["v0"]
    assert binds[0].trace_id == sp.trace_id


def test_ring_overwrites_and_the_dequeue():
    rng = np.random.default_rng(175)
    tw = ObsTwin(cluster(rng, 8), capacity=8, flight_ring_size=2)
    for k in range(4):
        tw.enqueue(*pods_of(rng, f"w{k}-", 3))
        tw.both("dequeue", f"w{k}-2")
        tw.round()
    assert tw.p.flight_recorder.overwrites == 2
    assert [r.round for r in tw.p.flight_recorder.records] == [3, 4]
    from koordinator_tpu_torch import journey, metrics

    assert metrics.round_flight_overwritten.value() == 2.0
    assert metrics.pods_enqueued_total.value() == 12.0
    assert journey.LEDGER.pending_count() == 0


def run_hooks(on: bool):
    """A seeded sequence through the port alone, every hook on (traced
    pods, an exporter, the recorder and the ledger) or every hook off;
    returns each round's binds, failures, node accounting and quota
    used."""
    from koordinator_tpu_torch import tracing
    from koordinator_tpu_torch.quota.tree import QuotaTree
    from koordinator_tpu_torch.scheduler.scheduler import (
        GangRecord,
        Scheduler,
    )
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )

    from tests.torch_parity import failure_docs

    reset_observability(enabled=on)
    exporter = tracing.InMemoryExporter()
    if on:
        tracing.TRACER.add_exporter(exporter)
    rng = np.random.default_rng(176)
    snap = ClusterSnapshot(capacity=128, device="cpu")
    for n in cluster(rng, 100):
        snap.upsert_node(NodeSpec(**n))
    tree = QuotaTree(np.full(R, 10**7, np.int64))
    mx = np.full(R, -1, np.int64)
    mx[CPU] = 150_000
    tree.add("team", np.zeros(R, np.int64), mx)
    sched = Scheduler(snap, quota_tree=tree, device="cpu", trace_pods=on,
                      batch_solver_threshold=64)
    sched.incremental_dirty_threshold = 1.0
    sched.register_gang(GangRecord(name="g", min_member=3))
    out = []
    for rnd in range(4):
        specs = pods_of(rng, f"h{rnd}-", 150 if rnd < 3 else 30,
                        arrival=True)
        for k, p in enumerate(specs):
            q = "team" if k % 3 == 0 else None
            g = "g" if rnd == 2 and k < 4 else None
            sched.enqueue(PodSpec(**dict(p, quota=q, gang=g)))
        if rnd == 3:
            sched.batch_solver_threshold = 10**6
        res = sched.schedule_round()
        out.append((dict(res.assignments), failure_docs(res),
                    sched.last_solve_path,
                    snap.state.node_requested.numpy().copy(),
                    tree.nodes["team"].used.copy()))
    tracing.TRACER.remove_exporter(exporter)
    assert bool(exporter.spans) == on
    return out


def test_binds_bit_identical_with_every_hook_on_or_off():
    on, off = run_hooks(True), run_hooks(False)
    assert [r[2] for r in on] == ["full_cold", "incremental", "full_gang",
                                  "greedy"]
    for a, b in zip(on, off, strict=True):
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        assert np.array_equal(a[3], b[3]) and np.array_equal(a[4], b[4])
    assert any(r[0] for r in on)
