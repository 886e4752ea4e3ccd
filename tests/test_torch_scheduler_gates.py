"""Parity of the port's round gates with the JAX ``Scheduler(mesh="off")``,
round by round: the leader ``elector`` and the startup ``barrier``, the
staleness watchdog's degraded mode (PreEnqueue's suspension, the full pass
over the candidate cache, the exit hysteresis), hinted rounds on a dense
(P, N) mask above and below the batch threshold (one with a topology gang),
``bind_batch_fn``, the ``faults`` seam and the monitor's phases.

A ``GateTwin`` (the placement suite's twin: binds in order, failures field
by field, pending, node accounting, bound records, reservations, quota,
nominations, managers) gives each scheduler its own hints, barrier,
monitor, fault stub and bind recorders, and compares after every round:
the explanation rings' docs and the top-reason summary, ``last_suspended``
and the suspended names, ``degraded`` and its entries, ``last_result``,
the ``bind_batch_fn`` payloads and the ``round_timings`` keys.  The cases
mirror tests/test_robustness.py's degraded-mode cases (:683-795),
tests/test_explain.py's (:294, :373) and tests/test_hints.py's scheduler
cases.
"""

import numpy as np
import pytest

from tests.test_torch_scheduler_placement import (
    PlacementTwin,
    block_tree,
    node,
    pod,
)
from tests.torch_parity import (
    BATCH_CPU,
    BATCH_MEM,
    CPU,
    MEM,
    R,
    set_torch_threads,
)

set_torch_threads()

BE = 1   # QoSClass.BE


class Elector:
    """A leader elector stub: ``tick()`` says whether this replica leads."""

    def __init__(self, leading=True):
        self.leading = leading

    def tick(self) -> bool:
        return self.leading


class Faults:
    """The ``faults`` seam's stub: counts the solves it saw."""

    def __init__(self):
        self.solves = 0

    def on_solve(self):
        self.solves += 1


class GateTwin(PlacementTwin):
    """Both schedulers with their own hints, barrier, monitor, fault stub
    and bind recorders, and the gates' state in the comparison."""

    def __init__(self, nodes, hints=False, barrier=False, both_sinks=True,
                 **kw):
        super().__init__(nodes, **kw)
        from koordinator_tpu.scheduler.barrier import SyncBarrier as JBarrier
        from koordinator_tpu.scheduler.hints import SchedulingHints as JHints

        from koordinator_tpu_torch.scheduler.barrier import SyncBarrier
        from koordinator_tpu_torch.scheduler.hints import SchedulingHints

        for s in (self.j, self.p):
            s.explain_ring.clock = lambda: self.t
        self.jbatches, self.tbatches = [], []
        self.j.bind_batch_fn = self.jbatches.append
        self.p.bind_batch_fn = self.tbatches.append
        if not both_sinks:
            self.j.bind_fn = self.p.bind_fn = None
        self.jfaults, self.tfaults = Faults(), Faults()
        self.j.faults, self.p.faults = self.jfaults, self.tfaults
        if hints:
            self.j.hints = JHints(self.j.snapshot)
            self.p.hints = SchedulingHints(self.p.snapshot)
        # the barrier's version and what the informer has seen
        self.version, self.seen = [0], [0]
        if barrier:
            def mark():
                self.version[0] += 1
                return self.version[0]

            def observed():
                return self.seen[0]

            self.j.barrier = JBarrier(mark, observed)
            self.p.barrier = SyncBarrier(mark, observed)

    def hint(self, name, preferred=(), excluded=()):
        from koordinator_tpu.scheduler.hints import PodHint as JHint

        from koordinator_tpu_torch.scheduler.hints import PodHint

        for cls, s in ((JHint, self.j), (PodHint, self.p)):
            s.hints.set_hint(name, cls(preferred_nodes=set(preferred),
                                       excluded_nodes=set(excluded)))

    def sync(self):
        """An informer event reached both schedulers at the twin's time."""
        self.both("note_sync_event")

    @staticmethod
    def explanation_docs(sched) -> list[dict]:
        return [e.to_doc() for e in sched.explain_ring._ring.values()]

    def check(self, jr, tr):
        super().check(jr, tr)
        j, p = self.j, self.p
        assert p.round_seq == j.round_seq
        assert p.degraded == j.degraded
        assert p.degraded_entries == j.degraded_entries
        assert p.degraded_since == j.degraded_since
        assert p.last_suspended == j.last_suspended
        assert p._last_suspended_names == j._last_suspended_names
        assert p._last_gang_rejected_names == j._last_gang_rejected_names
        assert p._last_staleness_s == j._last_staleness_s
        assert self.explanation_docs(p) == self.explanation_docs(j)
        assert p._last_unschedulable_top == j._last_unschedulable_top
        assert p.last_result.assignments == j.last_result.assignments
        assert (sorted(p.last_result.failures)
                == sorted(j.last_result.failures))
        assert self.tbatches == self.jbatches
        assert sorted(p.monitor.round_timings) == sorted(
            j.monitor.round_timings)
        assert self.tfaults.solves == self.jfaults.solves
        assert p.batch_rebuilds == j.batch_rebuilds


def bvec(cpu=0, mem=0, batch_cpu=0, batch_mem=0):
    v = np.zeros(R, np.int32)
    v[CPU], v[MEM] = cpu, mem
    v[BATCH_CPU], v[BATCH_MEM] = batch_cpu, batch_mem
    return v


def batch_node(name, cpu=64_000, mem=65_536):
    return dict(name=name, allocatable=bvec(cpu, mem, 10_000, 8_192),
                usage=np.zeros(R, np.int32), labels={})


# -- tests/test_robustness.py:683-795, degraded mode -------------------------


def test_constructor_takes_the_gates():
    """The port's Scheduler takes the gates' arguments, with the JAX
    scheduler's defaults."""
    from koordinator_tpu_torch.scheduler.monitor import SchedulerMonitor
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    snap = ClusterSnapshot(8, device="cpu")
    plain = Scheduler(snap, device="cpu")
    assert (plain.bind_batch_fn, plain.barrier, plain.hints, plain.elector,
            plain.staleness_threshold_sec, plain.staleness_exit_sec,
            plain.faults) == (None,) * 7
    assert isinstance(plain.monitor, SchedulerMonitor)
    mon, sink, el, fl = SchedulerMonitor(), [].append, Elector(), Faults()
    s = Scheduler(snap, device="cpu", bind_batch_fn=sink, monitor=mon,
                  barrier="b", hints="h", elector=el,
                  staleness_threshold_sec=5.0, staleness_exit_sec=1.0,
                  faults=fl)
    assert (s.bind_batch_fn, s.monitor, s.barrier, s.hints, s.elector,
            s.staleness_threshold_sec, s.staleness_exit_sec, s.faults) == (
        sink, mon, "b", "h", el, 5.0, 1.0, fl)


def test_stalled_feed_flips_degraded_and_suspends_be_admission():
    tw = GateTwin([batch_node("n0")], staleness_threshold_sec=10.0)
    tw.sync()                                 # the feed spoke at t=0
    tw.enqueue(pod("prod-1"), pod("be-1", cpu=500, mem=256, qos=BE),
               dict(name="batch-dim-1", requests=bvec(batch_cpu=500,
                                                      batch_mem=256)))
    tw.t = 5.0
    res = tw.round()
    assert not tw.p.degraded
    assert set(res.assignments) == {"prod-1", "be-1", "batch-dim-1"}
    tw.enqueue(pod("prod-2"), pod("be-2", cpu=500, mem=256, qos=BE),
               dict(name="batch-dim-2", requests=bvec(batch_cpu=500,
                                                      batch_mem=256)))
    tw.t = 16.0                               # silent past the threshold
    res = tw.round()
    assert tw.p.degraded and tw.p.degraded_entries == 1
    assert set(res.assignments) == {"prod-2"}
    assert tw.p.last_suspended == 2
    assert tw.p._last_suspended_names == ["be-2", "batch-dim-2"]
    assert tw.p.pod_explanation("be-2").reasons == {"degraded_suspended": 1}
    tw.t = 17.0
    tw.sync()                                 # the feed heals
    res = tw.round()
    assert not tw.p.degraded
    assert set(res.assignments) == {"be-2", "batch-dim-2"}


def test_degraded_exit_has_hysteresis():
    tw = GateTwin([batch_node("n0")], staleness_threshold_sec=10.0)
    tw.sync()
    tw.t = 11.0
    tw.round()
    assert tw.p.degraded
    tw.t = 20.0
    tw.sync()
    tw.t = 26.0                               # age 6 > the exit age 5
    tw.round()
    assert tw.p.degraded
    tw.t = 24.5                               # age 4.5 <= 5
    tw.round()
    assert not tw.p.degraded


def test_degraded_exit_age_is_configurable():
    tw = GateTwin([batch_node("n0")], staleness_threshold_sec=10.0,
                  staleness_exit_sec=2.0)
    tw.sync()
    tw.enqueue(pod("be", qos=BE))
    tw.t = 12.0
    tw.round()
    tw.sync()
    tw.t = 14.5                               # age 2.5 > 2.0
    tw.round()
    assert tw.p.degraded and "be" in tw.p.pending
    tw.sync()
    tw.t = 16.0                               # age 1.5 <= 2.0
    tw.round()
    assert not tw.p.degraded and "be" in tw.p.bound


def test_degraded_forces_full_pass_over_incremental_cache():
    tw = GateTwin([node(f"n{i}", cpu=64_000) for i in range(4)],
                  staleness_threshold_sec=10.0, batch_solver_threshold=1)
    tw.j.incremental_dirty_threshold = 1.0
    tw.p.incremental_dirty_threshold = 1.0
    tw.sync()
    tw.enqueue(pod("w0", cpu=100, mem=128))
    tw.round()
    assert tw.p.last_solve_path == "full_cold"
    tw.enqueue(pod("w1", cpu=100, mem=128))
    tw.t = 2.0
    tw.round()
    assert tw.p.last_solve_path == "incremental"
    tw.enqueue(pod("w2", cpu=100, mem=128))
    tw.t = 15.0                               # stale: the cache drops
    tw.round()
    assert tw.p.degraded and tw.p.last_solve_path == "degraded"
    assert tw.p._cand_cache is None and tw.j._cand_cache is None
    tw.sync()
    tw.t = 15.5
    tw.enqueue(pod("w3", cpu=100, mem=128))
    tw.round()
    assert not tw.p.degraded and tw.p.last_solve_path == "full_cold"
    tw.enqueue(pod("w4", cpu=100, mem=128))
    tw.round()
    assert tw.p.last_solve_path == "incremental"


def test_degraded_watchdog_disabled_by_default():
    tw = GateTwin([batch_node("n0")])
    tw.t = 1e9
    tw.sync()
    tw.enqueue(pod("be", qos=BE))
    tw.round()
    assert not tw.p.degraded and "be" in tw.p.bound


# -- tests/test_explain.py:294, :373 ------------------------------------------


@pytest.mark.parametrize("more", [False, True])
def test_degraded_suspension_explained(more):
    """A queue held out whole still explains itself (``more``: with a prod
    pod beside it that solves)."""
    tw = GateTwin([node("n1")])
    for s in (tw.j, tw.p):
        s.degraded = True     # the watchdog is off; the state set directly
    tw.enqueue(pod("be-pod", qos=BE))
    if more:
        tw.enqueue(pod("prod", cpu=2_000))
    res = tw.round()
    assert "be-pod" not in res.assignments
    exp = tw.p.pod_explanation("be-pod")
    assert exp.reasons == {"degraded_suspended": 1}
    assert exp.top_reason() == "degraded_suspended"
    assert tw.p._last_unschedulable_top == {"degraded_suspended": 1}
    assert sorted(tw.p.monitor.round_timings) == sorted(
        ["PreEnqueue", "BatchBuild", "Solve", "Reserve", "Bind", "Diagnose"]
        if more else ["PreEnqueue"])


def test_degraded_mode_explain_still_serves():
    tw = GateTwin([node("n1")])
    for s in (tw.j, tw.p):
        s.degraded = True
    tw.enqueue(pod("be-held", qos=BE), pod("too-big", cpu=90_000))
    res = tw.round()
    assert tw.p.pod_explanation("be-held").reasons == {
        "degraded_suspended": 1}
    assert "too-big" in res.failures
    assert tw.p.explain_candidates("too-big") == []


# -- the leader and barrier gates ---------------------------------------------


def test_standby_replica_decides_nothing():
    """A standby's round decides nothing, reads no clock and empties
    ``last_result``; once it leads, the queue solves."""
    el = Elector(leading=True)
    tw = GateTwin([node("n1")], elector=el, staleness_threshold_sec=5.0)
    tw.enqueue(pod("big", cpu=90_000))
    tw.round()
    assert "big" in tw.p.last_result.failures
    el.leading = False
    tw.sync()
    tw.t = 100.0
    tw.enqueue(pod("a"))
    res = tw.round()
    assert res.assignments == {} and tw.p.last_result.failures == {}
    assert tw.p.monitor.round_timings == {}
    assert tw.p._last_staleness_s is None and not tw.p.degraded
    el.leading = True
    res = tw.round()
    assert tw.p.degraded and "a" in res.assignments


def test_closed_barrier_keeps_the_last_result():
    """A closed startup barrier decides nothing and leaves ``last_result``
    as the last deciding round left it; it opens once the informer has
    seen the barrier's version, and a wait past its timeout opens it
    anyway (returning False)."""
    tw = GateTwin([node("n1")], barrier=True)
    tw.enqueue(pod("big", cpu=90_000))
    tw.round()
    assert "big" in tw.p.last_result.failures
    for b in (tw.j.barrier, tw.p.barrier):
        b.start()
    tw.enqueue(pod("a"))
    res = tw.round()
    assert res.assignments == {} and "a" in tw.p.pending
    assert "big" in tw.p.last_result.failures
    assert tw.p.monitor.round_timings == {}
    tw.seen[0] = tw.version[0]
    res = tw.round()
    assert "a" in res.assignments
    assert tw.p.barrier.synced


def test_barrier_wait_opens_on_timeout():
    from koordinator_tpu.scheduler.barrier import SyncBarrier as JBarrier

    from koordinator_tpu_torch.scheduler.barrier import SyncBarrier

    outs = []
    for cls in (JBarrier, SyncBarrier):
        t, slept = [0.0], []

        def sleep(s, t=t, slept=slept):
            slept.append(s)
            t[0] += s

        b = cls(lambda: 3, lambda: 1, timeout_seconds=0.2,
                clock=lambda t=t: t[0], sleep=sleep)
        assert b.check()              # never started: no gate
        assert b.start() == 3 and not b.check()
        outs.append((b.wait_until_synced(poll_interval=0.05), b.synced,
                     len(slept)))
        assert b.check()
    assert outs[0] == outs[1] and outs[1][0] is False


# -- hinted rounds on a dense mask --------------------------------------------


def _hint_nodes(n=12):
    return [node(f"n{i}", cpu=16_000, labels={"zone": f"z{i % 3}"})
            for i in range(n)]


def _hint_pods(rng, start, count):
    return [pod(f"p{start + j}", cpu=int(rng.integers(500, 6_000)),
                mem=int(rng.integers(256, 8_192)),
                priority=int(rng.integers(3_000, 9_999)),
                creation=float(start + j),
                node_selector={"zone": "z1"} if j % 7 == 0 else {})
            for j in range(count)]


@pytest.mark.parametrize("threshold", [8, 1_024])
def test_hinted_rounds(threshold):
    """Hinted rounds above the batch threshold (``full_dense``: K1, K3 and
    the rescue on the dense mask) and below it (the greedy scan on it),
    with excluded nodes, preferred nodes feasible and not, a hint cleared
    and a failure recorded; the cache resumes once no pod is hinted."""
    rng = np.random.default_rng(7 if threshold == 8 else 8)
    tw = GateTwin(_hint_nodes(), hints=True, batch_solver_threshold=threshold,
                  both_sinks=False)
    tw.enqueue(*_hint_pods(rng, 0, 30))
    tw.hint("p1", excluded={"n0", "n1", "n2"})
    tw.hint("p2", preferred={"n5"})
    tw.hint("p3", preferred={"n4", "n7"}, excluded={"n4"})
    tw.hint("p4", preferred={"ghost", "n0"})
    tw.hint("p7", excluded={f"n{i}" for i in range(12) if i != 4})
    res = tw.round()
    if threshold == 8:
        assert tw.p.last_solve_path == "full_dense"
    assert res.assignments.get("p2") == "n5"
    assert res.assignments.get("p7", "n4") == "n4"
    assert res.assignments.get("p1") not in ("n0", "n1", "n2")
    for s in (tw.j, tw.p):
        s.hints.record_failure("p9", "n3")
        s.hints.clear("p2")
    # a dead row in the middle of the node table, and a fresh node
    tw.remove_node("n6")
    tw.upsert_node(node("n12", cpu=16_000, labels={"zone": "z1"}))
    tw.enqueue(*_hint_pods(rng, 100, 24))
    tw.round()
    for s in (tw.j, tw.p):
        for name in ("p1", "p3", "p4", "p7", "p9"):
            s.hints.clear(name)
    tw.enqueue(*_hint_pods(rng, 200, 20))
    tw.round()
    if threshold == 8:
        assert tw.p.last_solve_path in ("full_cold", "incremental",
                                        "full_fallback")
    assert len(tw.tbatches) == 3 and tw.p.bind_fn is None


def test_hinted_round_with_a_topology_gang():
    """A hinted batch that also holds a topology gang: the planner's pins
    on the dense mask the hints made."""
    tw = GateTwin([node(f"n{i}", cpu=8_000) for i in range(8)], hints=True,
                  tree_paths=block_tree(4, 2), batch_solver_threshold=4)
    tw.gang("g", 2, dict(desired_slots=2, must_gather_layer=1))
    tw.enqueue(*[pod(f"g{i}", cpu=8_000, gang="g") for i in range(2)],
               *[pod(f"x{i}", cpu=2_000) for i in range(4)])
    tw.hint("g0", excluded={"n0", "n1", "n2"})
    tw.hint("x1", preferred={"n3"})
    res = tw.round()
    assert tw.p.last_solve_path == "full_gang"
    assert tw.p.last_topology_parts_s["gangs"] == 1
    assert res.assignments.get("x1") == "n3"
    assert res.assignments.get("g0") not in (None, "n0", "n1", "n2")


def test_bind_batch_fn_takes_the_round_and_bind_fn_the_rest():
    """With both sinks set, a round's main binds go to ``bind_batch_fn`` as
    one list in bind order (``bind_fn`` sees none of them), while the
    reservation pre-pass's binds go to ``bind_fn``; with ``bind_batch_fn``
    alone the payload equals what ``bind_fn`` would have seen."""
    tw = GateTwin([node("n1", cpu=10_000), node("n2", cpu=10_000)])
    tw.reservation(cpu=6_000)
    tw.enqueue(pod("a", priority=5), pod("b", priority=9))
    tw.round()
    assert [n for n, _ in tw.tbatches[-1]] == ["b", "a"]
    assert tw.tbinds == []
    tw.enqueue(pod("web-1", cpu=2_000, labels={"app": "web"}),
               pod("c", cpu=500))
    tw.round()
    assert [n for n, _ in tw.tbinds] == ["web-1"]
    assert [n for n, _ in tw.tbatches[-1]] == ["c"]
    solo = GateTwin([node("n1")], both_sinks=False)
    solo.enqueue(*[pod(f"s{i}", cpu=100 * (i + 1), priority=i)
                   for i in range(5)])
    solo.round()
    assert [n for n, _ in solo.tbatches[0]] == [f"s{i}" for i in
                                                range(4, -1, -1)]


def test_round_timings_and_faults_over_every_phase():
    """Reservations, Nominated, QuotaRevoke, PreEnqueue, BatchBuild, Solve,
    Reserve, Bind, Diagnose and PostFilter, as each round reaches them;
    ``faults.on_solve()`` once a solving round."""
    from tests.test_torch_scheduler_preemption import PreemptTwin, quota_pair

    tw = GateTwin([node(f"m{i}", cpu=8_000) for i in range(4)],
                  trees=quota_pair(("a", 0, 32_000), ("b", 24_000, 32_000),
                                   total_cpu=32_000),
                  enable_preemption=True)
    tw.revoke(delay=5.0)
    for j in range(8):
        PreemptTwin.add_bound(tw, f"b{j}", f"m{j % 4}", cpu=4_000,
                              priority=j, quota="a")
    for s in (tw.j, tw.p):
        s.quota_tree.nodes["a"].used[CPU] += 32_000
    tw.enqueue(*[pod(f"h{j}", cpu=4_000, priority=9_000 + j)
                 for j in range(2)])
    seen = []
    tw.round()
    seen.append(set(tw.p.monitor.round_timings))
    tw.round()
    seen.append(set(tw.p.monitor.round_timings))
    tw.enqueue(pod("bq", cpu=20_000, priority=9_999, quota="b"))
    tw.reservation(cpu=1_000)
    tw.round()
    seen.append(set(tw.p.monitor.round_timings))
    tw.t = 10.0
    tw.round()
    seen.append(set(tw.p.monitor.round_timings))
    assert tw.trevoked and tw.tevict
    assert "PostFilter" in seen[0] and "Nominated" in seen[1]
    assert {"Reservations", "QuotaRevoke"} <= seen[2]
    assert tw.tfaults.solves >= 2
    assert tw.p.monitor.stats()["PreEnqueue"]["count"] == 4.0
