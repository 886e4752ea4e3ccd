"""Parity of the port's gang shell and ``cand_method`` with the JAX
``Scheduler(mesh="off")``, round by round.

A ``GangTwin`` feeds every action to both schedulers and, after every round,
compares what the reservation suite's ``Twin`` compares (binds in order,
failed sets, pending queues, node accounting, bound records, quota usage,
solver and solve path) and each registered gang's ``rejected`` and
``first_failure``, the pods PreEnqueue held back, and the batch's gang ids.

The scenarios: the non-topology gang cases of tests/test_scheduler.py
(WaitTime rejection, a feasible gang, gangs through the batch engine under
quota contention, the rescue of a satisfied gang's surplus members), the
kitchen-sink churn of tests/test_scheduler_accounting.py (quotas, gangs,
reservations and node flaps), gang groups, a gang name no PodGroup
registered, a batch reused across rounds whose gang index changes, and a
gangless steady sequence under ``cand_method="approx"`` and ``"chunked"``
(a cold round, then two refresh rounds on the candidate cache).
"""

import numpy as np
import pytest

from tests.test_torch_scheduler_reservations import Twin, node, pod, vec
from tests.torch_parity import CPU, MEM, R, set_torch_threads

set_torch_threads()


class GangTwin(Twin):
    """Twin with gang registration and gang state in the comparison.
    ``trees`` gives both schedulers their own (JAX, port) quota trees."""

    def __init__(self, nodes, trees=None, **kw):
        super().__init__(nodes, **kw)
        if trees is not None:
            self.j.quota_tree, self.p.quota_tree = trees

    def gang(self, name, min_member, group=None, wait_time_sec=None):
        from koordinator_tpu.scheduler.scheduler import GangRecord as JG

        from koordinator_tpu_torch.scheduler.scheduler import GangRecord

        for cls, sched in ((JG, self.j), (GangRecord, self.p)):
            sched.register_gang(cls(name=name, min_member=min_member,
                                    group=group,
                                    wait_time_sec=wait_time_sec))

    def check(self, jr, tr):
        super().check(jr, tr)
        j, p = self.j, self.p
        assert sorted(p.gangs) == sorted(j.gangs)
        for name, jg in j.gangs.items():
            tg = p.gangs[name]
            assert (tg.rejected, tg.first_failure, tg.wait_time_sec) == (
                jg.rejected, jg.first_failure, jg.wait_time_sec), name
        assert p._last_gang_rejected_names == j._last_gang_rejected_names
        if tr.round_pods:
            jb, tb = j._batch_cache[1], p._batch_cache[1]
            assert np.array_equal(np.asarray(jb.gang_id),
                                  tb.gang_id.numpy())


def quota_team(cpu_max, total_cpu, total_mem):
    """(JAX, port) trees with one quota "team" capped at ``cpu_max``."""
    from koordinator_tpu.quota.tree import QuotaTree as JTree

    from koordinator_tpu_torch.quota.tree import QuotaTree as TTree

    out = []
    for cls in (JTree, TTree):
        mx = np.full(R, -1, np.int64)
        mx[CPU] = cpu_max
        tree = cls(vec(total_cpu, total_mem).astype(np.int64))
        tree.add("team", min=np.zeros(R, np.int64), max=mx)
        out.append(tree)
    return tuple(out)


# -- tests/test_scheduler.py ----------------------------------------------------


def test_gang_wait_time_rejection():
    tw = GangTwin([node("n1", cpu=4_000)])
    tw.gang("g", 2, wait_time_sec=100)
    tw.enqueue(pod("g1", cpu=3_000, gang="g"), pod("g2", cpu=3_000, gang="g"))
    assert not tw.round().assignments
    tw.t = 50.0
    tw.round()
    assert not tw.p.gangs["g"].rejected
    tw.t = 200.0
    tw.round()
    assert tw.p.gangs["g"].rejected
    assert tw.round().round_pods == 0
    assert sorted(tw.p._last_gang_rejected_names) == ["g1", "g2"]


def test_gang_schedules_when_feasible():
    tw = GangTwin([node("n1"), node("n2")])
    tw.gang("g", 3)
    tw.enqueue(*[pod(f"g{i}", cpu=6_000, gang="g") for i in range(3)])
    assert len(tw.round().assignments) == 3
    assert tw.p.gangs["g"].wait_time_sec == 600.0


def test_batch_engine_with_gangs_and_quota_contention():
    tw = GangTwin([node(f"n{i}", cpu=16_000) for i in range(4)],
                  trees=quota_team(8_000, 64_000, 262_144),
                  batch_solver_threshold=4)
    tw.gang("g", 3)
    tw.enqueue(*[pod(f"g{i}", cpu=4_000, gang="g") for i in range(3)])
    tw.enqueue(*[pod(f"q{i}", cpu=3_000, quota="team") for i in range(4)])
    res = tw.round()
    assert tw.p.last_solver == "batch"
    assert tw.p.last_solve_path == "full_gang"
    assert all(f"g{i}" in res.assignments for i in range(3))
    assert sum(f"q{i}" in res.assignments for i in range(4)) == 2
    assert all(res.failures[f].quota_rejected for f in res.failures)


def test_rescue_places_surplus_members_of_satisfied_gang():
    tw = GangTwin([node(f"n{i}", cpu=16_000) for i in range(8)],
                  batch_solver_threshold=2)
    tw.gang("g", 3)
    tw.enqueue(*[pod(f"g{i}", cpu=2_000, gang="g") for i in range(5)])
    res = tw.round()
    assert tw.p.last_solver == "batch"
    assert len(res.assignments) == 5 and not res.failures


def test_rescue_turns_only_satisfied_gangs_gangless():
    """A round whose batch solve strands members: the satisfied gang's
    surplus rescues one by one, the rolled-back gang comes back whole
    (and fails whole: it does not fit)."""
    tw = GangTwin([node(f"n{i}", cpu=8_000) for i in range(3)],
                  batch_solver_threshold=2)
    tw.gang("ok", 2)
    tw.gang("big", 4)
    tw.enqueue(*[pod(f"ok{i}", cpu=1_500, gang="ok", priority=9_000)
                 for i in range(6)])
    tw.enqueue(*[pod(f"big{i}", cpu=6_000, gang="big") for i in range(4)])
    res = tw.round()
    assert all(f"ok{i}" in res.assignments for i in range(6))
    assert all(f"big{i}" in res.failures for i in range(4))
    assert tw.p.gangs["big"].first_failure == 0.0


# -- gang groups, unregistered names, batch reuse --------------------------------


def test_gang_group_fails_together_then_wait_rejects_it():
    tw = GangTwin([node(f"n{i}", cpu=8_000) for i in range(2)])
    tw.gang("a", 2, group="grp", wait_time_sec=30)
    tw.gang("b", 3, group="grp", wait_time_sec=60)
    tw.gang("solo", 1)
    tw.enqueue(*[pod(f"a{i}", cpu=2_000, gang="a") for i in range(2)])
    tw.enqueue(*[pod(f"b{i}", cpu=5_000, gang="b") for i in range(3)])
    tw.enqueue(pod("s0", cpu=1_000, gang="solo"))
    res = tw.round()
    assert "s0" in res.assignments
    assert not any(n in res.assignments for n in ("a0", "a1", "b0"))
    for t, rejected in ((20.0, set()), (40.0, {"a"}), (90.0, {"a", "b"})):
        tw.t = t
        tw.round()
        assert {g for g, r in tw.p.gangs.items() if r.rejected} == rejected


def test_unregistered_gang_name_is_min_member_zero():
    """A pod names a gang no PodGroup registered: min_member 0, so its
    members bind one by one, and the WaitTime machine has no record."""
    tw = GangTwin([node("n1", cpu=8_000)], batch_solver_threshold=2)
    tw.enqueue(*[pod(f"u{i}", cpu=3_000, gang="ghost") for i in range(3)])
    res = tw.round()
    assert len(res.assignments) == 2 and len(res.failures) == 1
    assert tw.p.last_solve_path == "full_gang" and not tw.p.gangs


@pytest.mark.parametrize("threshold", [2, 1024], ids=["batch", "greedy"])
def test_batch_reuse_across_rounds_with_a_changing_gang_index(threshold):
    """Members of gang "m" wait (min_member not yet pending) while gang
    "a" arrives and sorts before it: "m"'s index moves from 0 to 1, so
    no row may be copied with its old id.  Then "a" binds and leaves,
    and "m"'s index moves back."""
    tw = GangTwin([node(f"n{i}", cpu=16_000) for i in range(3)],
                  batch_solver_threshold=threshold)
    tw.gang("m", 4)
    tw.gang("a", 2)
    tw.enqueue(*[pod(f"m{i}", cpu=1_000, gang="m") for i in range(3)])
    tw.enqueue(*[pod(f"p{i}", cpu=500) for i in range(3)])
    tw.round()
    tw.enqueue(*[pod(f"a{i}", cpu=1_000, gang="a") for i in range(2)])
    tw.enqueue(pod("p9", cpu=500))
    res = tw.round()
    assert {"a0", "a1"} <= set(res.assignments)
    assert tw.p._batch_host["gang_index"] == {"a": 0, "m": 1}
    tw.enqueue(pod("m3", cpu=1_000, gang="m"))
    res = tw.round()
    assert {"m0", "m1", "m2", "m3"} <= set(res.assignments)


# -- tests/test_scheduler_accounting.py kitchen-sink churn ---------------------


@pytest.mark.parametrize("seed", range(3))
def test_kitchen_sink_churn(seed):
    from koordinator_tpu.quota.tree import QuotaTree as JTree

    from koordinator_tpu_torch.quota.tree import QuotaTree as TTree

    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(4)]
    trees = []
    for cls in (JTree, TTree):
        tree = cls(vec(64_000, 262_144).astype(np.int64))
        mx = np.full(R, -1, np.int64)
        mx[CPU] = 20_000
        for q in ("qa", "qb"):
            tree.add(q, min=np.zeros(R, np.int64), max=mx.copy())
        trees.append(tree)
    tw = GangTwin([node(n, cpu=int(rng.integers(6_000, 16_000)))
                   for n in names], trees=tuple(trees))
    pod_seq = rsv_seq = gang_seq = 0
    for _step in range(24):
        op = int(rng.integers(0, 12))
        if op <= 4:
            gang = None
            members = 1
            if rng.random() < 0.3:
                gang = f"g{gang_seq}"
                gang_seq += 1
                members = int(rng.integers(2, 4))
                tw.gang(gang, members)
            pods = []
            for _ in range(members):
                pods.append(pod(f"p{pod_seq}",
                                cpu=int(rng.integers(200, 3_000)),
                                mem=int(rng.integers(128, 4_096)),
                                quota=str(rng.choice(["qa", "qb"])),
                                gang=gang))
                pod_seq += 1
            tw.enqueue(*pods)
            tw.round()
        elif op <= 6 and tw.p.bound:
            victim = sorted(tw.p.bound)[int(rng.integers(0, len(tw.p.bound)))]
            tw.both("delete_pod", victim)
        elif op == 7:
            rname = f"r{rsv_seq}"
            rsv_seq += 1
            tw.reservation(name=rname, cpu=int(rng.integers(1_000, 4_000)),
                           mem=int(rng.integers(1_024, 8_192)),
                           owners=[{"app": rname}])
            tw.round()
        elif op == 8 and len(tw.p.reservations):
            specs = tw.p.reservations.specs()
            tw.both("remove_reservation",
                    specs[int(rng.integers(0, len(specs)))].name)
        elif op == 9:
            gone = names[int(rng.integers(0, len(names)))]
            if gone in tw.p.snapshot.node_index:
                tw.remove_node(gone)
        else:
            back = names[int(rng.integers(0, len(names)))]
            if back not in tw.p.snapshot.node_index:
                tw.upsert_node(node(back,
                                    cpu=int(rng.integers(6_000, 16_000))))
    assert gang_seq > 0


# -- cand_method on the incremental path ---------------------------------------


def _wrap_nodes(n: int, rng):
    """n nodes, the first and last four identical and the largest, so the
    approx reduction's wrap case ranks at the top of every row."""
    out = []
    for i in range(n):
        big = i < 4 or i >= n - 4
        out.append(node(f"n{i:03d}",
                        cpu=64_000 if big else int(rng.integers(8_000,
                                                                32_000)),
                        mem=262_144 if big else int(rng.integers(16_384,
                                                                 65_536)),
                        usage_cpu=0 if big else int(rng.integers(0, 4_000))))
    return out


@pytest.mark.parametrize("method", ["approx", "chunked"])
def test_steady_sequence_under_cand_method(method):
    """A gangless batch sequence (node count = capacity): a cold round,
    then two refresh rounds after arrivals, on the candidate cache with
    ``cand_method``; a port scheduler on ``exact`` beside them must hold
    other candidates after the cold round (approx is not exact here)."""
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )

    from tests.torch_parity import port

    rng = np.random.default_rng(31)
    nodes = _wrap_nodes(64, rng)
    tw = GangTwin(nodes, capacity=64, batch_solver_threshold=16)
    exact_snap = ClusterSnapshot(64, device="cpu")
    for n in nodes:
        exact_snap.upsert_node(NodeSpec(**n))
    exact = Scheduler(exact_snap, config=port(tw.j.config, "ScoringConfig"),
                      batch_solver_threshold=16, device="cpu")
    for sched in (tw.j, tw.p):
        sched.cand_method = method
        sched.incremental_dirty_threshold = 1.0

    def arrivals(start, count):
        return [pod(f"p{start + j}", cpu=int(rng.integers(100, 1_500)),
                    mem=int(rng.integers(128, 2_048)),
                    priority=int(rng.integers(3_000, 9_999)),
                    creation=float(start + j)) for j in range(count)]

    first = arrivals(0, 400)
    tw.enqueue(*first)
    exact.enqueue_many([PodSpec(**p) for p in first])
    tw.round()
    exact.schedule_round()
    assert tw.p.last_solve_path == "full_cold"
    assert tw.p._cand_cache["method"] == method
    approx_nodes = tw.p._cand_cache["cache"].cand_node.numpy()
    exact_nodes = exact._cand_cache["cache"].cand_node.numpy()
    assert (approx_nodes != exact_nodes).any(axis=1).sum() >= 1
    for rnd in range(2):
        tw.enqueue(*arrivals(1_000 * (rnd + 1), 60))
        res = tw.round()
        assert tw.p.last_solve_path == "incremental"
        assert res.assignments
