"""Parity of the port's Diagnose phase and placement explanations
(``koordinator_tpu_torch/scheduler/scheduler.py`` with ``explain``,
``explanations`` and ``auditor``) with the JAX ``Scheduler(mesh="off")`` at
its defaults, round by round.

An ``ExplainTwin`` is the preemption suite's ``PreemptTwin`` (itself the
reservation suite's ``Twin``: binds, failures field by field, pending
queues, accounting, bound records, quota usage; and nominations, evictions
and PDB budgets) with an ``ExplanationStore`` and a ``WorkloadAuditor`` on
each side, every clock the twin's fake one.  After every round it also
compares each side's explanation ring (every retained
``PlacementExplanation.to_doc()``, in ring order), the round's top-reason
summary and ``round_seq``, the store's CRs after a drain, the auditor's
events and attempts by workload key, and ``explain_candidates`` of the
pending and bound pods.

The scenarios: plain rounds where every node-level reason fires (greedy
and batch), the post-solve quota blame and the capacity failures it leaves
alone, gangs failing on the barrier and then parked once rejected (a round
of parkees only), reservations (a reserve-pod that fails, one that
places, TTL expiry and a node instance gone), preemption (the nomination
on the diagnosis and the CR, its bind clearing both), and the host
recompute with ``explain=False``.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_scheduler_preemption import PreemptTwin, quota_pair
from tests.test_torch_scheduler_reservations import node
from tests.test_torch_scheduler_reservations import pod as base_pod
from tests.torch_parity import GPU, port, set_torch_threads

set_torch_threads()


def pod(name, gpu=0, **kw):
    """The reservation suite's pod, with a GPU request when asked."""
    spec = base_pod(name, **kw)
    spec["requests"][GPU] = gpu
    return spec


def events(auditor) -> dict:
    return {key: [dataclasses.asdict(e) for e in ring]
            for key, ring in auditor._records.items()}


class ExplainTwin(PreemptTwin):
    """PreemptTwin (preemption off unless asked) with explanation stores,
    auditors and the explanation rings in the comparison.  ``cfg``
    replaces both schedulers' scoring config (a JAX ScoringConfig)."""

    def __init__(self, nodes, cfg=None, **kw):
        from koordinator_tpu.scheduler import explanation as je

        from koordinator_tpu_torch.scheduler import explanation as te

        kw.setdefault("enable_preemption", False)
        super().__init__(nodes, **kw)
        clock = lambda: self.t  # noqa: E731
        self.stores = (je.ExplanationStore(clock=clock),
                       te.ExplanationStore(clock=clock))
        self.auditors = (je.WorkloadAuditor(clock=clock),
                         te.WorkloadAuditor(clock=clock))
        for sched, store, auditor in zip((self.j, self.p), self.stores,
                                         self.auditors):
            sched.explanations, sched.auditor = store, auditor
            sched.explain_ring.clock = clock
        if cfg is not None:
            self.j.config = cfg
            self.p.config = port(cfg, "ScoringConfig")
        self.rounds = []

    def gang(self, name, min_member, wait_time_sec=None):
        from koordinator_tpu.scheduler.scheduler import GangRecord as JG

        from koordinator_tpu_torch.scheduler.scheduler import GangRecord

        for cls, s in ((JG, self.j), (GangRecord, self.p)):
            s.register_gang(cls(name=name, min_member=min_member,
                                wait_time_sec=wait_time_sec))

    def round(self):
        res = super().round()
        self.rounds.append(res)
        return res

    def check(self, jr, tr):
        super().check(jr, tr)
        j, p = self.j, self.p
        assert p.round_seq == j.round_seq
        assert p._last_unschedulable_top == j._last_unschedulable_top
        assert ([e.to_doc() for e in p.explain_ring._ring.values()]
                == [e.to_doc() for e in j.explain_ring._ring.values()])
        for store in self.stores:
            store.drain()
        jcrs, tcrs = ([dataclasses.asdict(e) for e in s.list()]
                      for s in self.stores)
        assert tcrs == jcrs
        assert self.stores[1].dropped == self.stores[0].dropped
        ja, ta = self.auditors
        assert events(ta) == events(ja)
        assert ta._attempts == ja._attempts
        names = sorted(j.pending)[:6] + sorted(j.bound)[:4] + ["nobody"]
        for name in names:
            assert p.explain_candidates(name) == j.explain_candidates(name)
        for name in set(j.pending) | set(jr.failures):
            jx, tx = j.pod_explanation(name), p.pod_explanation(name)
            assert (tx is None) == (jx is None), name
            if jx is not None:
                assert tx.to_doc() == jx.to_doc()


def default_config():
    """The JAX default scoring config: usage thresholds 65/95 and the
    estimator's defaults on (the Twin's own zeroes both)."""
    from koordinator_tpu.ops.assignment import ScoringConfig

    return ScoringConfig.default()


def mixed_nodes():
    return [
        node("n-ok", cpu=16_000, mem=65_536),
        node("n-cpu1", cpu=500, mem=65_536),
        node("n-cpu2", cpu=900, mem=65_536),
        node("n-mem", cpu=64_000, mem=100),
        node("n-hot", cpu=10_000, mem=65_536, usage_cpu=9_500),
        node("n-zone", cpu=16_000, mem=65_536, labels={"zone": "b"}),
    ]


@pytest.mark.parametrize("threshold", [1_024, 2], ids=["greedy", "batch"])
def test_every_node_reason_fires(threshold):
    tw = ExplainTwin(mixed_nodes(), cfg=default_config(),
                     batch_solver_threshold=threshold)
    tw.enqueue(pod("fits", cpu=1_000, mem=500),
               pod("huge", cpu=70_000, mem=500),
               pod("fat", cpu=1_000, mem=70_000),
               pod("zoned", cpu=1_000, mem=500, node_selector={"zone": "c"}),
               pod("gpu", cpu=1_000, mem=500, gpu=1_000))
    res = tw.round()
    assert "fits" in res.assignments
    assert set(res.failures) >= {"huge", "fat", "zoned", "gpu"}
    exp = tw.p.pod_explanation("zoned")
    assert exp.reasons.get("affinity", 0) > 0 and exp.total_nodes == 6
    assert "node_invalid" not in exp.reasons
    assert tw.p.pod_explanation("huge").top_reason() == "fit_cpu"
    # a node leaves and another arrives; the stuck pods diagnose again
    tw.remove_node("n-cpu1")
    tw.upsert_node(node("n-big", cpu=120_000, mem=65_536))
    tw.t = 1.0
    res = tw.round()
    assert "huge" in res.assignments
    tw.t = 2.0
    tw.round()
    assert tw.p.round_seq == 3


@pytest.mark.parametrize("threshold", [1_024, 2], ids=["greedy", "batch"])
def test_quota_blame_needs_feasible_nodes(threshold):
    """Pods a leaf's headroom turns away after this round's binds are
    blamed on the quota (nodes were feasible); a pod that fits no node
    keeps its fit reason though the quota turns it away too."""
    trees = quota_pair(("qa", 0, 3_000), ("qb", 0, 40_000),
                       total_cpu=64_000)
    tw = ExplainTwin([node(f"n{i}", cpu=8_000) for i in range(4)],
                     trees=trees, batch_solver_threshold=threshold)
    tw.enqueue(*[pod(f"a{i}", cpu=2_000, quota="qa", priority=100 - i)
                 for i in range(3)],
               pod("a-huge", cpu=50_000, quota="qa"),
               pod("b-huge", cpu=50_000, quota="qb"),
               pod("free", cpu=1_000))
    res = tw.round()
    assert "a0" in res.assignments
    blamed = res.failures["a1"]
    assert blamed.quota_rejected and blamed.feasible_nodes == 0
    assert blamed.reason_counts["quota"] > 0
    assert not res.failures["a-huge"].quota_rejected
    assert res.failures["a-huge"].reason_counts["quota"] == 0
    exp = tw.p.pod_explanation("a1")
    assert exp.top_reason() == "quota" and exp.quota == "qa"
    assert "rejected by elastic quota" in tw.stores[1].get("a1").reasons[0]
    tw.t = 1.0
    tw.round()


def test_gang_barrier_then_parked_pods():
    """A gang one member short fails on the barrier though its members
    fit (the explanation says gang_barrier), is rejected after its
    WaitTime, and its parked members are explained on a round where no
    other pod is pending."""
    tw = ExplainTwin([node("n1", cpu=8_000), node("n2", cpu=8_000)])
    tw.gang("g", 3, wait_time_sec=30)
    tw.gang("big", 2, wait_time_sec=30)
    tw.enqueue(pod("g1", cpu=1_000, gang="g"), pod("g2", cpu=1_000, gang="g"),
               pod("b1", cpu=9_000, gang="big"),
               pod("b2", cpu=9_000, gang="big"), pod("solo", cpu=1_000))
    res = tw.round()
    assert "solo" in res.assignments
    exp = tw.p.pod_explanation("g1")
    assert exp.reasons == {"gang_barrier": 2} and exp.feasible_nodes == 0
    assert tw.p.pod_explanation("b1").top_reason() == "fit_cpu"
    for t in (20.0, 40.0, 50.0):
        tw.t = t
        res = tw.round()
    assert res.round_pods == 0
    assert tw.p.pod_explanation("g2").reasons == {"gang_barrier": 2}
    assert tw.p._last_unschedulable_top == {"gang_barrier": 4}


def test_reservation_lifecycle_audit():
    """A reserve-pod too big for any node gets a diagnosis and no
    explanation, CR or audit record; one that places opens its
    reservation (ReservationAvailable); a TTL expires one
    (ReservationExpired); a removed node fails another
    (ReservationFailed)."""
    tw = ExplainTwin([node("n1", cpu=16_000), node("n2", cpu=16_000)])
    tw.reservation("big", cpu=99_000)
    tw.reservation("ok", cpu=4_000)
    tw.reservation("ttl", cpu=2_000, ttl_sec=5.0)
    tw.reservation("pinned", cpu=2_000, node="n2")
    res = tw.round()
    assert "rsv::big" in res.failures and "rsv::ok" in res.assignments
    assert tw.p.pod_explanation("rsv::big") is None
    assert tw.stores[1].get("rsv::big") is None
    assert "rsv::big" not in tw.auditors[1]._records
    tw.t = 10.0
    tw.enqueue(pod("web", cpu=1_000, labels={"app": "web"}))
    tw.round()
    tw.remove_node("n2")
    tw.upsert_node(node("n2", cpu=16_000))
    tw.t = 11.0
    tw.round()
    kinds = {e["record_type"] for evs in events(tw.auditors[1]).values()
             for e in evs}
    assert {"ReservationAvailable", "ReservationExpired",
            "ReservationFailed", "ScheduleSuccess"} <= kinds


@pytest.mark.parametrize("threshold", [1_024, 2], ids=["greedy", "batch"])
def test_preemption_lands_on_diagnosis_and_cr(threshold):
    tw = ExplainTwin([node("n1", cpu=4_000), node("n2", cpu=4_000)],
                     enable_preemption=True, batch_solver_threshold=threshold)
    tw.enqueue(pod("low-a", cpu=2_000, priority=10),
               pod("low-b", cpu=2_000, priority=20),
               pod("low-c", cpu=4_000, priority=30))
    assert not tw.round().failures
    tw.gang("job", 2)
    tw.enqueue(pod("high", cpu=2_000, priority=9_500),
               pod("j1", cpu=2_000, priority=9_000, gang="job"),
               pod("j2", cpu=2_000, priority=9_000, gang="job"))
    tw.t = 1.0
    res = tw.round()
    diag = res.failures["high"]
    assert diag.preempt_node == res.nominations["high"][0]
    assert diag.preempt_victims == res.nominations["high"][1]
    cr = tw.stores[1].get("high")
    assert "fits after preempting" in cr.node_offers[diag.preempt_node]
    tw.t = 2.0
    res = tw.round()
    assert "high" in res.assignments
    assert tw.stores[1].get("high") is None


@pytest.mark.parametrize("scenario", ["mixed", "quota", "gang"])
def test_host_recompute_when_explain_is_off(scenario):
    """explain=False: each failed pod's diagnosis is recomputed on the
    host (explain_pod), no explanation is kept, and the CRs and audit
    records still go out."""
    if scenario == "mixed":
        tw = ExplainTwin(mixed_nodes(), cfg=default_config(), explain=False)
        tw.enqueue(pod("huge", cpu=70_000), pod("fat", cpu=1_000, mem=70_000),
                   pod("zoned", cpu=1_000, node_selector={"zone": "c"}))
    elif scenario == "quota":
        trees = quota_pair(("qa", 0, 3_000), total_cpu=64_000)
        tw = ExplainTwin([node(f"n{i}", cpu=8_000) for i in range(3)],
                         trees=trees, explain=False,
                         batch_solver_threshold=2)
        tw.enqueue(*[pod(f"a{i}", cpu=2_000, quota="qa") for i in range(3)])
    else:
        tw = ExplainTwin([node("n1", cpu=8_000)], explain=False)
        tw.gang("g", 3, wait_time_sec=5)
        tw.enqueue(pod("g1", gang="g"), pod("g2", gang="g"))
    res = tw.round()
    assert res.failures
    assert all(d.reason_counts is not None for d in res.failures.values())
    assert len(tw.p.explain_ring) == 0
    assert tw.stores[1].list()
    tw.t = 10.0
    tw.round()


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_rounds_with_everything(seed):
    """Seeded rounds over quotas, gangs, selectors, thresholds and
    preemption on the batch path, arrivals every round."""
    rng = np.random.default_rng(seed)
    nodes = [node(f"n{i}", cpu=int(rng.integers(2_000, 16_000)),
                  mem=int(rng.integers(4_096, 65_536)),
                  usage_cpu=int(rng.integers(0, 6_000)),
                  labels={"zone": f"z{i % 3}"}) for i in range(10)]
    trees = quota_pair(("qa", 2_000, 12_000), ("qb", 0, 8_000),
                       total_cpu=60_000)
    tw = ExplainTwin(nodes, cfg=default_config(), trees=trees,
                     enable_preemption=True, cap=6, chunk=2,
                     batch_solver_threshold=8)
    tw.gang("g0", 3, wait_time_sec=4)
    quotas = [None, "qa", "qb"]
    for rnd in range(5):
        tw.t = 2.0 * rnd
        arrivals = []
        for j in range(int(rng.integers(6, 14))):
            kw = dict(cpu=int(rng.integers(100, 6_000)),
                      mem=int(rng.integers(128, 8_192)),
                      priority=int(rng.integers(0, 9_999)),
                      quota=quotas[int(rng.integers(0, 3))])
            if rng.random() < 0.2:
                kw["node_selector"] = {"zone": f"z{int(rng.integers(0, 4))}"}
            if rng.random() < 0.15:
                kw["gang"] = "g0"
            arrivals.append(pod(f"r{rnd}-{j}", **kw))
        tw.enqueue(*arrivals)
        tw.round()
    assert any(r.failures for r in tw.rounds)
