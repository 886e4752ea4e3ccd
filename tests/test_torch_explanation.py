"""The port's ScheduleExplanation persistence, explanation ring and
workload auditor (``koordinator_tpu_torch/scheduler/explanation.py``),
mirroring tests/test_explanation.py case by case, each run on both packages
with the same actions and compared."""

import dataclasses

import numpy as np
import pytest

from tests.torch_parity import CPU, MEM, R, set_torch_threads

set_torch_threads()


def modules():
    """((JAX explanation, JAX diagnosis), (port explanation, port
    diagnosis))."""
    from koordinator_tpu.scheduler import diagnosis as jd
    from koordinator_tpu.scheduler import explanation as je

    from koordinator_tpu_torch.scheduler import diagnosis as td
    from koordinator_tpu_torch.scheduler import explanation as te

    return (je, jd), (te, td)


def diag(mod, **kw):
    defaults = dict(total_nodes=4, feasible_nodes=0,
                    insufficient_resources=4, usage_over_threshold=0,
                    affinity_mismatch=0, quota_rejected=False, invalid=0)
    defaults.update(kw)
    return mod.PodDiagnosis(**defaults)


def both(fn):
    """fn(explanation module, diagnosis module) on both packages."""
    (je, jd), (te, td) = modules()
    return fn(je, jd), fn(te, td)


def crs(store) -> list[dict]:
    return [dataclasses.asdict(e) for e in store.list()]


def test_async_record_drain_and_delete():
    def run(ex, d):
        store = ex.ExplanationStore(clock=lambda: 42.0)
        store.record("p1", diag(d))
        queued = store.get("p1")
        drained = store.drain()
        doc = dataclasses.asdict(store.get("p1"))
        store.delete("p1")
        return queued, drained, doc, store.get("p1")

    want, got = both(run)
    assert got == want
    assert got[0] is None and got[1] == 1 and got[3] is None
    assert got[2]["update_time"] == 42.0
    assert "4 insufficient resources" in got[2]["reasons"][0]


def test_blocking_mode_writes_through():
    def run(ex, d):
        store = ex.ExplanationStore(blocking=True, clock=lambda: 1.0)
        store.record("p1", diag(d))
        return crs(store)

    want, got = both(run)
    assert got == want and len(got) == 1


def test_queue_bound_drops_instead_of_blocking():
    def run(ex, d):
        store = ex.ExplanationStore(queue_size=2, clock=lambda: 1.0)
        for i in range(5):
            store.record(f"p{i}", diag(d))
        return store.dropped, store.drain(), crs(store)

    want, got = both(run)
    assert got == want and got[:2] == (3, 2)


def test_capacity_evicts_oldest():
    def run(ex, d):
        store = ex.ExplanationStore(capacity=2, blocking=True,
                                    clock=lambda: 1.0)
        for i in range(3):
            store.record(f"p{i}", diag(d))
        return crs(store)

    want, got = both(run)
    assert got == want
    assert [c["pod_name"] for c in got] == ["p1", "p2"]


def test_preemption_nomination_lands_on_cr():
    def run(ex, d):
        store = ex.ExplanationStore(blocking=True, clock=lambda: 1.0)
        store.record("p1", diag(d, preempt_node="n3",
                                preempt_victims=["v1", "v2"]))
        return crs(store)

    want, got = both(run)
    assert got == want
    assert "preempting [v1, v2]" in got[0]["node_offers"]["n3"]


def test_delete_purges_queued_entry_too():
    def run(ex, d):
        store = ex.ExplanationStore(clock=lambda: 1.0)
        store.record("p1", diag(d))
        store.delete("p1")
        return store.drain(), store.get("p1")

    want, got = both(run)
    assert got == want == (0, None)


def audit_trace(auditor, keys) -> dict:
    return {k: ([dataclasses.asdict(e) for e in auditor.events(k)],
                auditor.attempts(k)) for k in keys}


def test_auditor_rings_and_transitions():
    def run(ex, _d):
        t = [0.0]
        a = ex.WorkloadAuditor(ring_size=4, clock=lambda: t[0])
        a.record_attempt("gang-a")
        a.record_attempt("gang-a")
        t[0] = 1.0
        a.record_gating("p", True)
        a.record_gating("p", True)
        a.record_gating("p", False)
        for i in range(10):
            t[0] = 2.0 + i
            a.record("gang-a", "ScheduleFailed", f"m{i}")
        before = audit_trace(a, ["gang-a", "p"])
        a.delete("gang-a")
        return before, audit_trace(a, ["gang-a", "p"])

    want, got = both(run)
    assert got == want
    assert len(got[0]["gang-a"][0]) == 4 and got[0]["gang-a"][1] == 2
    assert got[1]["gang-a"] == ([], 0)


def test_disabled_auditor_records_nothing():
    def run(ex, _d):
        a = ex.WorkloadAuditor(enabled=False)
        a.record_attempt("x")
        a.record("x", "ScheduleFailed")
        a.record_gating("x", True)
        return audit_trace(a, ["x"])

    want, got = both(run)
    assert got == want == {"x": ([], 0)}


def test_ring_keeps_latest_per_pod_and_evicts_oldest():
    def run(ex, _d):
        ring = ex.ExplanationRing(capacity=3, clock=lambda: 5.0)
        for i, pod in enumerate(["a", "b", "c", "a", "d"]):
            ring.record(ex.PlacementExplanation(
                pod=pod, round=i, total_nodes=8, feasible_nodes=0,
                reasons={"fit_cpu": 8 - i, "quota": i % 2}))
        return {p: (None if ring.get(p) is None else ring.get(p).to_doc())
                for p in "abcd"}, len(ring)

    want, got = both(run)
    assert got == want
    assert got[0]["b"] is None and got[0]["a"]["round"] == 3
    assert got[1] == 3


@pytest.mark.parametrize("reasons", [
    {}, {"fit_cpu": 3, "affinity": 3}, {"fit_cpu": 2, "quota": 1},
    {"usage_threshold": 5, "gang_barrier": 2, "fit_memory": 9},
    {"degraded_suspended": 4}, {"fit_gpu": 0, "affinity": 0},
])
def test_placement_explanation_summary_and_top_reason(reasons):
    def run(ex, _d):
        exp = ex.PlacementExplanation(
            pod="p", round=2, total_nodes=10, feasible_nodes=1,
            reasons=dict(reasons), quota="q", gang="g", update_time=3.0)
        return exp.top_reason(), exp.summary(), exp.to_doc()

    want, got = both(run)
    assert got == want


def test_scheduler_persists_and_clears_explanations():
    """tests/test_explanation.py's scheduler case on both schedulers: a
    failed pod persists its CR and audit record, and the bind after it
    clears the CR and records the success."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig
    from koordinator_tpu.scheduler import (
        ClusterSnapshot as JSnap,
        NodeSpec as JNode,
        PodSpec as JPod,
        Scheduler as JSched,
    )

    from koordinator_tpu_torch.scheduler import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
        Scheduler,
    )

    from tests.torch_parity import port

    (je, _), (te, _) = modules()

    def vec(cpu, mem):
        v = np.zeros(R, np.int32)
        v[CPU], v[MEM] = cpu, mem
        return v

    cfg = ScoringConfig.default().replace(
        usage_thresholds=jnp.zeros(R, jnp.int32),
        estimator_defaults=jnp.zeros(R, jnp.int32))
    jsnap, tsnap = JSnap(capacity=16), ClusterSnapshot(16, device="cpu")
    for snap, node_cls in ((jsnap, JNode), (tsnap, NodeSpec)):
        snap.upsert_node(node_cls(name="n1", allocatable=vec(4_000, 8_192),
                                  usage=np.zeros(R, np.int32)))
    sides = []
    for ex, make in (
            (je, lambda **kw: JSched(jsnap, config=cfg, mesh="off", **kw)),
            (te, lambda **kw: Scheduler(tsnap, config=port(
                cfg, "ScoringConfig"), device="cpu", **kw))):
        store = ex.ExplanationStore(blocking=True, clock=lambda: 7.0)
        auditor = ex.WorkloadAuditor(clock=lambda: 8.0)
        sides.append((make(explanations=store, auditor=auditor), store,
                      auditor))
    outs = []
    for (sched, store, auditor), pod_cls in zip(sides, (JPod, PodSpec)):
        sched.enqueue(pod_cls(name="big", requests=vec(99_000, 1_024)))
        res = sched.schedule_round()
        first = (dataclasses.asdict(res.failures["big"]), crs(store),
                 audit_trace(auditor, ["big"]))
        sched.pending.pop("big")
        sched.enqueue(pod_cls(name="big", requests=vec(1_000, 1_024)))
        res = sched.schedule_round()
        outs.append((first, res.assignments, crs(store),
                     audit_trace(auditor, ["big"])))
    assert outs[1] == outs[0]
    first, assignments, after, trace = outs[1]
    assert "available" in first[1][0]["reasons"][0]
    assert first[2]["big"][1] == 1
    assert first[2]["big"][0][-1]["record_type"] == "ScheduleFailed"
    assert assignments == {"big": "n1"} and after == []
    assert trace["big"][0][-1]["record_type"] == "ScheduleSuccess"
