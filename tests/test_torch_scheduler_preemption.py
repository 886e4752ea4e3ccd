"""Parity of the port's PostFilter, Nominated and QuotaRevoke phases
(``koordinator_tpu_torch/scheduler/scheduler.py``) with the JAX
``Scheduler(mesh="off")``, round by round.

A ``PreemptTwin`` feeds every action to both schedulers, each with its own
``preempt_fn`` and ``revoke_fn`` recorder, and after every round compares
what the reservation suite's ``Twin`` compares (binds in order, failed
sets, pending queues, node accounting, bound records, quota usage) and the
round's nominations (node and victim list per preemptor), the schedulers'
standing nominations and their node instances, the eviction and revoke
calls in order, and every PDB's remaining budget.

The scenarios are tests/test_preemption.py's scheduler cases (a preemption
then its nominated bind, ``preemptionPolicy: Never``, PDB budgets, gang
all-or-nothing and its atomic failure, quota headroom not spent twice by a
gang, a nominated gang resolving all-or-nothing, nominated capacity held
against rivals, dequeue and delete of a nominated pod, same-quota victims,
the round cap and the chains of single preemptors), a node removed and
re-added under a nomination, and seeded multi-round traces with bound pods
seeded through ``add_bound_pod``, PDBs, quotas, gangs and a small
``preempt_cap`` and ``preempt_chunk``, on the greedy and the batch paths,
with the overuse revoke on.
"""

import numpy as np
import pytest

from tests.test_torch_scheduler_reservations import Twin, node, pod, vec
from tests.torch_parity import CPU, MEM, R, set_torch_threads

set_torch_threads()


class PreemptTwin(Twin):
    """Twin with preemption on, PDBs, seeded bound pods and the revoke
    controller, and all of their state in the comparison."""

    def __init__(self, nodes, trees=None, cap=None, chunk=None, **kw):
        kw.setdefault("enable_preemption", True)
        super().__init__(nodes, **kw)
        if trees is not None:
            self.j.quota_tree, self.p.quota_tree = trees
        self.jevict, self.tevict = [], []
        self.j.preempt_fn = lambda v, by: self.jevict.append((v, by))
        self.p.preempt_fn = lambda v, by: self.tevict.append((v, by))
        for s in (self.j, self.p):
            if cap is not None:
                s.preempt_cap = cap
            if chunk is not None:
                s.preempt_chunk = chunk
        self.jrevoked, self.trevoked = [], []

    def pdb(self, name, selector, allowed):
        from koordinator_tpu.scheduler.scheduler import PdbRecord as JP

        from koordinator_tpu_torch.scheduler.scheduler import PdbRecord

        for cls, s in ((JP, self.j), (PdbRecord, self.p)):
            s.register_pdb(cls(name=name, selector=dict(selector),
                               allowed=allowed))

    def gang(self, name, min_member):
        from koordinator_tpu.scheduler.scheduler import GangRecord as JG

        from koordinator_tpu_torch.scheduler.scheduler import GangRecord

        for cls, s in ((JG, self.j), (GangRecord, self.p)):
            s.register_gang(cls(name=name, min_member=min_member))

    def add_bound(self, name, node_name, cpu=1_000, mem=1_024, priority=0,
                  quota=None, non_preemptible=False, labels=None, gang=None):
        """A pre-existing bound pod, through both add_bound_pod."""
        from koordinator_tpu.scheduler.scheduler import BoundPod as JB

        from koordinator_tpu_torch.scheduler.scheduler import BoundPod
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec

        labels = dict(labels or {})
        gen = self.j.snapshot.node_generation.get(node_name, 0)
        self.j.add_bound_pod(JB(
            name=name, node=node_name, requests=vec(cpu, mem),
            priority=priority, quota=quota, non_preemptible=non_preemptible,
            labels=labels, gang=gang, node_generation=gen))
        self.p.add_bound_pod(BoundPod(PodSpec(
            name=name, requests=vec(cpu, mem), priority=priority,
            quota=quota, non_preemptible=non_preemptible,
            labels=dict(labels), gang=gang), node_name, gen))

    def revoke(self, delay=5.0):
        self.j.enable_overuse_revoke(
            lambda p, q: self.jrevoked.append((p, q)), delay_evict_sec=delay)
        self.p.enable_overuse_revoke(
            lambda p, q: self.trevoked.append((p, q)), delay_evict_sec=delay)

    def check(self, jr, tr):
        super().check(jr, tr)
        j, p = self.j, self.p
        assert tr.nominations == jr.nominations
        assert p.nominations == j.nominations
        assert p._nomination_gen == j._nomination_gen
        assert self.tevict == self.jevict
        assert self.trevoked == self.jrevoked
        assert {n: r.allowed for n, r in p.pdbs.items()} == {
            n: r.allowed for n, r in j.pdbs.items()}
        for name, jb in j.bound.items():
            tb = p.bound[name]
            assert (tb.priority, tb.quota, tb.non_preemptible, tb.labels,
                    tb.gang) == (jb.priority, jb.quota, jb.non_preemptible,
                                 jb.labels, jb.gang)
            assert np.array_equal(tb.requests, jb.requests)


def quota_pair(*leaves, total_cpu=16_000, declared_mem=True):
    """(JAX, port) trees of standalone quotas (name, min cpu, max cpu)."""
    from koordinator_tpu.quota.tree import QuotaTree as JTree

    from koordinator_tpu_torch.quota.tree import QuotaTree as TTree

    out = []
    for cls in (JTree, TTree):
        total = np.zeros(R, np.int64)
        total[CPU], total[MEM] = total_cpu, 1 << 20
        tree = cls(total)
        for name, mn, mx in leaves:
            lo = np.zeros(R, np.int64)
            lo[CPU] = mn
            hi = np.full(R, -1, np.int64)
            hi[CPU] = mx
            if declared_mem:
                hi[MEM] = 1 << 20
            tree.add(name, min=lo, max=hi)
        out.append(tree)
    return tuple(out)


def bind_all(tw, *pods):
    tw.enqueue(*pods)
    res = tw.round()
    assert not res.failures
    return res


# -- tests/test_preemption.py TestSchedulerPostFilter ------------------------------


def test_preempt_then_bind_next_round():
    tw = PreemptTwin([node("n1", cpu=4_000)])
    bind_all(tw, pod("low-a", cpu=2_000, priority=10),
             pod("low-b", cpu=2_000, priority=20))
    tw.enqueue(pod("high", cpu=2_000, priority=9_500))
    res = tw.round()
    assert res.nominations["high"] == ("n1", ["low-a"])
    assert tw.tevict == [("low-a", "high")]
    assert tw.round().assignments == {"high": "n1"}
    assert not tw.p.nominations


@pytest.mark.parametrize("policy", ["Never", "PreemptLowerPriority"])
def test_preemption_policy(policy):
    tw = PreemptTwin([node("n1", cpu=4_000)])
    bind_all(tw, pod("low", cpu=4_000, priority=10))
    tw.enqueue(pod("high", cpu=2_000, priority=9_500,
                   preemption_policy=policy))
    res = tw.round()
    assert bool(res.nominations) == (policy != "Never")


@pytest.mark.parametrize("budgets,victims", [
    ((1,), ["web-b"]),          # the in-budget pod goes, not the violating
    ((3, 2), ["web-a"]),        # several PDBs: each pays
    ((0,), ["web-a"]),          # budget 0: the reprieve order still decides
])
def test_pdb_budgets(budgets, victims):
    tw = PreemptTwin([node("n1", cpu=4_000)])
    for i, allowed in enumerate(budgets):
        tw.pdb(f"pdb-{i}", {"app": "web"}, allowed)
    bind_all(tw, pod("web-a", cpu=2_000, priority=10, labels={"app": "web"}),
             pod("web-b", cpu=2_000, priority=20, labels={"app": "web"}))
    tw.enqueue(pod("high", cpu=2_000, priority=9_500))
    res = tw.round()
    assert res.nominations["high"][1] == victims


@pytest.mark.parametrize("hard", [False, True])
def test_gang_preemption_all_or_nothing(hard):
    """Both members preempt, one victim a node; with one node's pod
    non-preemptible the gang fails whole and nothing is evicted."""
    tw = PreemptTwin([node("n1", cpu=4_000), node("n2", cpu=4_000)])
    bind_all(tw, pod("low-1", cpu=4_000, priority=10),
             pod("low-2", cpu=4_000, priority=10, non_preemptible=hard))
    tw.gang("job", 2)
    tw.enqueue(pod("g1", cpu=4_000, priority=9_000, gang="job"),
               pod("g2", cpu=4_000, priority=9_000, gang="job"))
    res = tw.round()
    if hard:
        assert not res.nominations
        assert set(tw.p.bound) == {"low-1", "low-2"}
    else:
        assert set(res.nominations) == {"g1", "g2"}
        assert set(tw.round().assignments) == {"g1", "g2"}


def test_unchecked_dim_deficit_does_not_block_preemption():
    trees = quota_pair(("q", 4_000, 4_000), total_cpu=4_000,
                       declared_mem=False)
    tw = PreemptTwin([node("n1", cpu=4_000)], trees=trees)
    bind_all(tw, pod("low", cpu=4_000, mem=2_048, priority=10, quota="q"))
    tw.enqueue(pod("high", cpu=4_000, mem=2_048, priority=9_500, quota="q"))
    assert tw.round().nominations["high"][1] == ["low"]


def test_gang_quota_headroom_not_double_spent():
    trees = quota_pair(("q", 4_000, 4_000), total_cpu=4_000)
    tw = PreemptTwin([node("n1", cpu=8_000), node("n2", cpu=8_000)],
                     trees=trees)
    bind_all(tw, pod("low-1", cpu=2_000, mem=0, priority=10, quota="q"),
             pod("low-2", cpu=2_000, mem=0, priority=10, quota="q"))
    tw.gang("job", 2)
    tw.enqueue(pod("g1", cpu=4_000, mem=0, priority=9_000, gang="job",
                   quota="q"),
               pod("g2", cpu=4_000, mem=0, priority=9_000, gang="job",
                   quota="q"))
    assert not tw.round().nominations
    assert set(tw.p.bound) == {"low-1", "low-2"}


def test_nominated_gang_resolves_all_or_nothing():
    tw = PreemptTwin([node("n1", cpu=4_000), node("n2", cpu=4_000)])
    bind_all(tw, pod("low-1", cpu=4_000, priority=10),
             pod("low-2", cpu=4_000, priority=10))
    tw.gang("job", 2)
    tw.enqueue(pod("g1", cpu=4_000, priority=9_000, gang="job"),
               pod("g2", cpu=4_000, priority=9_000, gang="job"))
    res = tw.round()
    tw.remove_node(res.nominations["g2"][0])
    res2 = tw.round()
    assert "g1" not in res2.assignments and "g2" not in res2.assignments
    assert not tw.p.nominations


@pytest.mark.parametrize("action", ["dequeue", "delete_pod", "readd_node"])
def test_nominated_pod_leaves_or_its_node_flaps(action):
    """A nominated preemptor dequeued or deleted releases its assumed
    charge; one whose node is removed and re-added releases nothing from
    the fresh instance and rejoins the batch."""
    tw = PreemptTwin([node("n1", cpu=4_000), node("n2", cpu=1_000)])
    bind_all(tw, pod("low", cpu=4_000, priority=10))
    tw.enqueue(pod("high", cpu=4_000, priority=9_500))
    assert tw.round().nominations["high"][0] == "n1"
    if action == "readd_node":
        tw.remove_node("n1")
        tw.upsert_node(node("n1", cpu=4_000))
    else:
        tw.both(action, "high")
    tw.enqueue(pod("other", cpu=3_000, priority=100))
    tw.round()
    tw.round()


def test_nominated_capacity_protected_from_other_pods():
    tw = PreemptTwin([node("n1", cpu=4_000)])
    bind_all(tw, pod("low", cpu=4_000, priority=10))
    tw.enqueue(pod("high", cpu=4_000, priority=9_500))
    tw.round()
    tw.enqueue(pod("rival", cpu=4_000, priority=9_500, creation=-1.0))
    res = tw.round()
    assert res.assignments.get("high") == "n1" and "rival" in res.failures


def test_quota_preemption_same_quota_victims():
    trees = quota_pair(("team-a", 4_000, 4_000), ("team-b", 4_000, 4_000),
                       total_cpu=8_000)
    tw = PreemptTwin([node("n1", cpu=16_000)], trees=trees)
    bind_all(tw, pod("a-low", cpu=4_000, mem=0, priority=10, quota="team-a"),
             pod("b-low", cpu=4_000, mem=0, priority=10, quota="team-b"))
    tw.enqueue(pod("a-high", cpu=4_000, mem=0, priority=9_500,
                   quota="team-a"))
    assert tw.round().nominations["a-high"][1] == ["a-low"]
    assert tw.round().assignments == {"a-high": "n1"}


# -- TestPreemptionBudget: the cap and the chains --------------------------------


@pytest.mark.parametrize("cap,chunk", [(2, 256), (1_024, 2), (5, 3)])
def test_round_cap_and_chunked_chains(cap, chunk):
    tw = PreemptTwin([node(f"n{i}", cpu=4_000) for i in range(6)], cap=cap,
                     chunk=chunk)
    bind_all(tw, *[pod(f"low-{i}", cpu=4_000, priority=10)
                   for i in range(6)])
    tw.enqueue(*[pod(f"high-{i}", cpu=4_000, priority=9_000 + 100 * i)
                 for i in range(6)])
    res = tw.round()
    assert len(res.nominations) == min(cap, 6)
    tw.round()
    tw.round()


# -- seeded traces: add_bound_pod, PDBs, quotas, gangs, cap and chunk -------------


@pytest.mark.parametrize("seed,threshold", [(0, 1_024), (1, 8), (2, 8)])
def test_seeded_preemption_rounds(seed, threshold):
    rng = np.random.default_rng(seed)
    nodes = [node(f"n{i}", cpu=int(rng.integers(8_000, 24_000)),
                  mem=int(rng.integers(16_384, 65_536))) for i in range(12)]
    trees = quota_pair(("qa", 10_000, 40_000), ("qb", 5_000, 30_000),
                       ("qc", 0, 20_000), total_cpu=120_000)
    tw = PreemptTwin(nodes, trees=trees, cap=10, chunk=3,
                     batch_solver_threshold=threshold)
    tw.revoke(delay=5.0)
    for i in range(4):
        tw.pdb(f"pdb-{i}", {"app": f"a{i}"}, int(rng.integers(0, 4)))
    quotas = [None, "qa", "qb", "qc"]
    for i in range(70):
        nd = nodes[int(rng.integers(0, len(nodes)))]["name"]
        tw.add_bound(f"b{i}", nd, cpu=int(rng.integers(200, 2_500)),
                     mem=int(rng.integers(128, 4_096)),
                     priority=int(rng.integers(1_000, 6_000)),
                     quota=quotas[int(rng.integers(0, 4))],
                     non_preemptible=bool(rng.random() < 0.1),
                     labels={"app": f"a{int(rng.integers(0, 6))}"})
    tw.gang("g0", 3)
    tw.gang("g1", 2)
    for rnd in range(6):
        tw.t = 3.0 * rnd
        arrivals = []
        for j in range(int(rng.integers(4, 12))):
            gang = None
            if rng.random() < 0.2:
                gang = f"g{int(rng.integers(0, 2))}"
            arrivals.append(pod(
                f"p{rnd}-{j}", cpu=int(rng.integers(500, 6_000)),
                mem=int(rng.integers(128, 4_096)),
                priority=int(rng.integers(3_000, 9_999)),
                quota=quotas[int(rng.integers(0, 4))], gang=gang,
                creation=float(rnd * 100 + j),
                labels={"app": f"a{int(rng.integers(0, 6))}"},
                preemption_policy=("Never" if rng.random() < 0.1
                                   else "PreemptLowerPriority")))
        tw.enqueue(*arrivals)
        if rnd == 3:
            # quota b's demand rises: qa's runtime shrinks under its used
            tw.enqueue(pod("qb-burst", cpu=30_000, quota="qb",
                           priority=9_999))
        if rnd == 4 and tw.p.nominations:
            tw.both("delete_pod", sorted(tw.p.nominations)[0])
        tw.round()
    assert tw.tevict
