"""Parity of the port's Reservation lifecycle (``koordinator_tpu_torch/
scheduler``: the tick, reserve-pods, the pre-pass on the reservation-aware
scan, binds and releases) with the JAX ``Scheduler(mesh="off")``.

Every action goes to both schedulers; after every round their binds (in
order), failed sets, pending queues, node accounting, bound-pod records,
reservation phases and allocations, quota usage, solver and solve path
must be equal.  The scenarios mirror tests/test_scheduler.py's
TestReservationRounds and TestMigrationWithReservations (those that need no
descheduler or debug service) and tests/test_scheduler_accounting.py's
node-flap cases; two seeded multi-round traces drive the batch path (a low
``batch_solver_threshold``, the incremental candidate cache on) and the
greedy path (the default threshold).
"""

import numpy as np
import pytest

from tests.torch_parity import CPU, MEM, R, failure_docs, set_torch_threads

set_torch_threads()


def vec(cpu=0, mem=0):
    v = np.zeros(R, np.int32)
    v[CPU], v[MEM] = cpu, mem
    return v


def node(name, cpu=16_000, mem=65_536, usage_cpu=0, labels=None):
    usage = np.zeros(R, np.int32)
    usage[CPU] = usage_cpu
    return dict(name=name, allocatable=vec(cpu, mem), usage=usage,
                labels=labels or {})


def pod(name, cpu=1_000, mem=1_024, **kw):
    return dict(name=name, requests=vec(cpu, mem), **kw)


class Twin:
    """A JAX scheduler and the port's, fed the same actions."""

    def __init__(self, nodes, capacity=16, quota=False, **kw):
        import jax.numpy as jnp

        from koordinator_tpu.ops.assignment import ScoringConfig
        from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
        from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
        from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode

        from koordinator_tpu_torch.scheduler.scheduler import Scheduler
        from koordinator_tpu_torch.scheduler.snapshot import (
            ClusterSnapshot,
            NodeSpec,
        )

        from tests.torch_parity import port, quota_trees

        self.t = 0.0
        self.jnode, self.tnode = JNode, NodeSpec
        jcfg = ScoringConfig.default().replace(
            usage_thresholds=jnp.zeros(R, jnp.int32),
            estimator_defaults=jnp.zeros(R, jnp.int32))
        jsnap = JSnap(capacity=capacity)
        tsnap = ClusterSnapshot(capacity, device="cpu")
        for n in nodes:
            jsnap.upsert_node(JNode(**n))
            tsnap.upsert_node(NodeSpec(**n))
        jtree = ttree = None
        if quota:
            jtree, ttree = quota_trees(0, loose=True)
        self.jbinds, self.tbinds = [], []
        clock = lambda: self.t  # noqa: E731
        self.j = JSched(jsnap, config=jcfg, quota_tree=jtree,
                        bind_fn=lambda p, n: self.jbinds.append((p, n)),
                        clock=clock, mesh="off", **kw)
        self.p = Scheduler(tsnap, config=port(jcfg, "ScoringConfig"),
                           quota_tree=ttree,
                           bind_fn=lambda p, n: self.tbinds.append((p, n)),
                           clock=clock, device="cpu", **kw)

    # -- actions ----------------------------------------------------------

    def enqueue(self, *pods):
        from koordinator_tpu.scheduler.snapshot import PodSpec as JPod

        from koordinator_tpu_torch.scheduler.snapshot import PodSpec

        for p in pods:
            self.j.enqueue(JPod(**p))
            self.p.enqueue(PodSpec(**p))

    def reservation(self, name="rsv-a", cpu=8_000, mem=8_192, owners=None,
                    **kw):
        """Add the same Reservation to both (owners: a list of label
        dicts, default app=web)."""
        from koordinator_tpu.scheduler import reservations as jr

        from koordinator_tpu_torch.scheduler import reservations as tr

        for mod, sched in ((jr, self.j), (tr, self.p)):
            spec = mod.ReservationSpec(
                name=name, requests=vec(cpu, mem),
                owners=[mod.OwnerMatcher(labels=dict(lbl)) for lbl in
                        (owners if owners is not None else [{"app": "web"}])],
                **{k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in kw.items()})
            sched.add_reservation(spec)

    def both(self, method, *args):
        getattr(self.j, method)(*args)
        getattr(self.p, method)(*args)

    def upsert_node(self, n):
        self.j.snapshot.upsert_node(self.jnode(**n))
        self.p.snapshot.upsert_node(self.tnode(**n))

    def remove_node(self, name):
        self.j.snapshot.remove_node(name)
        self.p.snapshot.remove_node(name)

    def round(self):
        jr, tr = self.j.schedule_round(), self.p.schedule_round()
        self.check(jr, tr)
        return tr

    # -- the comparison -----------------------------------------------------

    def check(self, jr, tr):
        j, p = self.j, self.p
        assert tr.assignments == jr.assignments
        assert failure_docs(tr) == failure_docs(jr)
        assert tr.round_pods == jr.round_pods
        assert p.last_solver == j.last_solver
        if j.last_solver == "batch":
            assert p.last_solve_path == j.last_solve_path
        assert self.tbinds == self.jbinds
        assert sorted(p.pending) == sorted(j.pending)
        assert np.array_equal(np.asarray(j.snapshot.state.node_requested),
                              p.snapshot.state.node_requested.numpy())
        assert sorted(p.bound) == sorted(j.bound)
        for name, jb in j.bound.items():
            tb = p.bound[name]
            assert (tb.node, tb.reservation, tb.rsv_generation,
                    tb.node_generation) == (jb.node, jb.reservation,
                                            jb.rsv_generation,
                                            jb.node_generation)
            assert (tb.rsv_drawn is None) == (jb.rsv_drawn is None)
            if jb.rsv_drawn is not None:
                assert np.array_equal(tb.rsv_drawn, jb.rsv_drawn)
        jspecs = {s.name: s for s in j.reservations.specs()}
        tspecs = {s.name: s for s in p.reservations.specs()}
        assert sorted(tspecs) == sorted(jspecs)
        for name, js in jspecs.items():
            ts = tspecs[name]
            assert ts.phase.value == js.phase.value
            assert (ts.node, ts.owner_pods, ts.generation,
                    ts.node_generation, ts.available_at) == (
                js.node, js.owner_pods, js.generation, js.node_generation,
                js.available_at)
            assert (ts.allocated is None) == (js.allocated is None)
            if js.allocated is not None:
                assert np.array_equal(ts.allocated, js.allocated)
        if j.quota_tree is not None:
            for name, q in j.quota_tree.nodes.items():
                tq = p.quota_tree.nodes[name]
                assert np.array_equal(q.used, tq.used)
                assert np.array_equal(q.non_preemptible_used,
                                      tq.non_preemptible_used)


# -- tests/test_scheduler.py TestReservationRounds ---------------------------


def test_reserve_pod_places_and_hides_capacity():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000)
    res = tw.round()
    assert res.assignments.get("rsv::rsv-a") == "n1"
    assert [s.name for s in tw.p.reservations.available()] == ["rsv-a"]
    tw.enqueue(pod("other", cpu=4_000))
    assert "other" in tw.round().failures


def test_owner_pod_allocates_from_reservation():
    tw = Twin([node("n1", cpu=10_000), node("n2", cpu=10_000)])
    tw.reservation(cpu=8_000)
    tw.round()
    rnode = tw.p.reservations.get("rsv-a").node
    tw.enqueue(pod("web-1", cpu=6_000, labels={"app": "web"}))
    res = tw.round()
    assert res.assignments["web-1"] == rnode
    spec = tw.p.reservations.get("rsv-a")
    assert spec.allocated[CPU] == 6_000 and spec.owner_pods == ["web-1"]


def test_pinned_reservation_available_without_solve():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(node="n1", cpu=8_000)
    tw.enqueue(pod("other", cpu=4_000))
    assert "other" in tw.round().failures
    assert tw.p.reservations.get("rsv-a").node == "n1"


def test_allocate_once_consumes_reservation():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000, allocate_once=True)
    tw.round()
    tw.enqueue(pod("web-1", cpu=2_000, labels={"app": "web"}))
    res = tw.round()
    assert res.assignments["web-1"] == "n1"
    assert tw.p.reservations.get("rsv-a").phase.value == "Succeeded"
    assert not tw.p.reservations.available()


def test_expiration_returns_remainder():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000, ttl_sec=60.0)
    tw.round()
    assert tw.p.reservations.available()
    tw.t = 120.0
    tw.enqueue(pod("other", cpu=6_000))
    assert tw.round().assignments.get("other") == "n1"


def test_remove_reservation_frees_capacity():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000)
    tw.round()
    tw.both("remove_reservation", "rsv-a")
    tw.enqueue(pod("other", cpu=6_000))
    assert tw.round().assignments.get("other") == "n1"


def test_owner_pod_delete_returns_allocation_not_node_capacity():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000)
    tw.round()
    tw.enqueue(pod("web-1", cpu=6_000, labels={"app": "web"}))
    tw.round()
    tw.both("delete_pod", "web-1")
    assert tw.p.reservations.get("rsv-a").allocated[CPU] == 0
    tw.enqueue(pod("other", cpu=4_000))
    assert "other" in tw.round().failures
    tw.enqueue(pod("web-2", cpu=8_000, labels={"app": "web"}))
    assert tw.round().assignments.get("web-2") == "n1"


def test_reapply_available_reservation_is_idempotent():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=6_000)
    tw.round()
    tw.reservation(cpu=6_000)
    tw.round()
    avail = tw.p.reservations.available()
    assert len(avail) == 1 and avail[0].node == "n1"
    tw.enqueue(pod("other", cpu=4_000))
    assert tw.round().assignments.get("other") == "n1"


def test_pending_reservation_expires_by_ttl():
    tw = Twin([node("n1", cpu=2_000)])
    tw.reservation(cpu=50_000, ttl_sec=60.0)
    tw.round()
    tw.t = 120.0
    tw.round()
    assert tw.p.reservations.get("rsv-a") is None
    assert "rsv::rsv-a" not in tw.p.pending


def test_pinned_reservation_waits_for_fit():
    tw = Twin([node("n1", cpu=2_000)])
    tw.reservation(node="n1", cpu=8_000)
    tw.enqueue(pod("other", cpu=1_000))
    assert tw.round().assignments.get("other") == "n1"
    assert not tw.p.reservations.available()


def test_allocate_once_frees_fully_with_owner_pod():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000, allocate_once=True)
    tw.round()
    tw.enqueue(pod("web-1", cpu=2_000, labels={"app": "web"}))
    tw.round()
    tw.both("delete_pod", "web-1")
    tw.enqueue(pod("other", cpu=9_000))
    assert tw.round().assignments.get("other") == "n1"


def test_recreated_reservation_not_credited_by_old_pods():
    tw = Twin([node("n1", cpu=20_000)])
    tw.reservation(cpu=8_000)
    tw.round()
    tw.enqueue(pod("web-1", cpu=4_000, labels={"app": "web"}))
    tw.round()
    tw.both("remove_reservation", "rsv-a")
    tw.reservation(cpu=6_000)
    tw.round()
    assert tw.p.reservations.get("rsv-a").allocated[CPU] == 0
    tw.both("delete_pod", "web-1")
    assert tw.p.reservations.get("rsv-a").allocated[CPU] == 0
    tw.enqueue(pod("other", cpu=14_000))
    assert tw.round().assignments.get("other") == "n1"


def test_pending_update_refreshes_reserve_pod_requests():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=1_000)
    tw.reservation(cpu=4_000)
    tw.round()
    assert tw.p.reservations.get("rsv-a").node == "n1"
    tw.enqueue(pod("big", cpu=7_000))
    assert "big" in tw.round().failures
    tw.enqueue(pod("ok", cpu=6_000))
    assert tw.round().assignments.get("ok") == "n1"


def test_owner_update_reaches_prepass_cache():
    tw = Twin([node("n1", cpu=10_000)])
    tw.reservation(cpu=8_000)
    tw.round()
    tw.enqueue(pod("db-1", cpu=6_000, labels={"app": "db"}))
    assert "db-1" in tw.round().failures
    tw.reservation(cpu=8_000, owners=[{"app": "db"}])
    assert tw.round().assignments.get("db-1") == "n1"
    assert tw.p.reservations.get("rsv-a").allocated[CPU] == 6_000


def test_reserve_pod_honors_template_node_selector():
    tw = Twin([node("cpu-1", cpu=20_000, labels={"pool": "cpu"}),
               node("gpu-1", cpu=10_000, labels={"pool": "gpu"})])
    tw.reservation(cpu=8_000, node_selector={"pool": "gpu"})
    tw.round()
    assert tw.p.reservations.get("rsv-a").node == "gpu-1"


# -- tests/test_scheduler_accounting.py ---------------------------------------


def test_stale_available_reservation_fails_on_node_flap():
    tw = Twin([node("n1", cpu=8_000)])
    tw.reservation(name="r1", cpu=4_000, mem=4_096, owners=[{"app": "a"}])
    tw.round()
    assert tw.p.reservations.get("r1").phase.value == "Available"
    tw.remove_node("n1")
    tw.upsert_node(node("n1", cpu=8_000))
    tw.round()
    spec = tw.p.reservations.get("r1")
    assert spec is None or spec.phase.value != "Available"
    tw.enqueue(pod("big", cpu=7_000))
    assert tw.round().assignments.get("big") == "n1"


def test_row_reuse_before_flush_keeps_new_charges():
    tw = Twin([node("n1", cpu=8_000)])
    tw.enqueue(pod("p1", cpu=3_000))
    tw.round()
    tw.remove_node("n1")
    tw.upsert_node(node("n2", cpu=8_000))
    tw.reservation(name="r2", cpu=2_000, mem=1_024, node="n2", owners=[])
    tw.round()
    for sched in (tw.j, tw.p):
        sched.snapshot.flush()
    row = tw.p.snapshot.node_index["n2"]
    assert int(tw.p.snapshot.state.node_requested[row, CPU]) == 2_000
    tw.both("remove_reservation", "r2")
    for sched in (tw.j, tw.p):
        sched.snapshot.flush()
    assert not tw.p.snapshot.state.node_requested[row].any()
    assert np.array_equal(np.asarray(tw.j.snapshot.state.node_requested),
                          tw.p.snapshot.state.node_requested.numpy())


# -- seeded multi-round traces ------------------------------------------------


def _trace_nodes(rng, n):
    return [node(f"n{i}", cpu=int(rng.integers(8_000, 32_000)),
                 mem=int(rng.integers(16_384, 65_536)),
                 labels={"zone": f"z{i % 3}"}) for i in range(n)]


def _owner_pods(rng, start, count, apps):
    out = []
    for j in range(count):
        app = int(rng.integers(0, apps))
        out.append(pod(f"w{start + j}", cpu=int(rng.integers(250, 3_000)),
                       mem=int(rng.integers(256, 4_096)),
                       priority=int(rng.integers(3_000, 9_999)),
                       labels={"app": f"svc-{app}"}, creation=float(start + j),
                       quota=("qa", "qb", "qc", None)[j % 4],
                       non_preemptible=(j % 7 == 0)))
    return out


def _plain_pods(rng, start, count):
    return [pod(f"p{start + j}", cpu=int(rng.integers(100, 4_000)),
                mem=int(rng.integers(128, 8_192)),
                priority=int(rng.integers(3_000, 9_999)),
                creation=float(start + j),
                node_selector={"zone": "z1"} if j % 9 == 0 else {})
            for j in range(count)]


def _run_trace(tw, rng, n_nodes, scale, rounds=4):
    """Reservations pinned and placed by reserve-pods (allocate-once,
    Restricted, TTLs), owner and plain pods, owner deletions, a
    reservation removed, an owner edit, a node flap and TTL expiry.
    Returns the binds the pre-pass made through a reservation."""
    apps = 6
    specs = {}
    for v in range(12):
        kw = dict(owners=[{"app": f"svc-{v % apps}"}],
                  allocate_once=(v % 4 == 1), restricted=(v % 4 == 2))
        if v % 3 == 0:
            kw["node"] = f"n{int(rng.integers(0, n_nodes))}"
        if v % 5 == 0:
            kw["ttl_sec"] = 30.0
        specs[f"r{v}"] = dict(cpu=int(rng.integers(2_000, 8_000)),
                              mem=int(rng.integers(4_096, 16_384)), **kw)
        tw.reservation(name=f"r{v}", **specs[f"r{v}"])
    tw.enqueue(*_plain_pods(rng, 0, 2 * scale))
    tw.round()
    drew = 0
    for rnd in range(1, rounds):
        tw.t = 20.0 * rnd
        tw.enqueue(*_owner_pods(rng, rnd * 1_000, scale, apps))
        tw.enqueue(*_plain_pods(rng, rnd * 1_000, scale // 2))
        res = tw.round()
        drew += sum(1 for name in res.assignments
                    if name in tw.p.bound
                    and tw.p.bound[name].reservation is not None)
        bound_owners = sorted(n for n, b in tw.p.bound.items()
                              if n.startswith("w"))
        for name in bound_owners[::5]:
            tw.both("delete_pod", name)
        if rnd == 1:
            tw.both("remove_reservation", "r4")
            # an owner edit: the same charge, other owners
            tw.reservation(name="r7", **dict(specs["r7"],
                                             owners=[{"app": "svc-0"}]))
        if rnd == 2:
            tw.remove_node("n2")
            tw.upsert_node(node("n2", cpu=20_000))
    return drew


@pytest.mark.parametrize("path", ["batch", "greedy"])
def test_seeded_reservation_trace(path):
    """The batch path: threshold 24 with the incremental cache on, and a
    pre-pass cap of 10 so the cap keeps the highest-priority owners; the
    greedy path: the defaults."""
    rng = np.random.default_rng(11 if path == "batch" else 12)
    n_nodes = 20
    kw = {"batch_solver_threshold": 24} if path == "batch" else {}
    tw = Twin(_trace_nodes(rng, n_nodes), capacity=32, quota=True, **kw)
    if path == "batch":
        tw.j.rsv_prepass_cap = tw.p.rsv_prepass_cap = 10
    drew = _run_trace(tw, rng, n_nodes, scale=40 if path == "batch" else 12)
    assert drew > 0
    if path == "batch":
        assert tw.p.last_solver == "batch"


@pytest.mark.parametrize("path", ["greedy", "batch"])
def test_owner_pod_with_a_negative_request(path):
    """An owner pod requesting a negative amount on one dimension, matched
    to an Available reservation, goes through the reservation pre-pass (K4r
    on the card) as the JAX scheduler sends it: the binds, the
    reservations' allocations (the remainder rising past ``reserved`` on
    the negative dimension) and the quota, round by round, equal."""
    kw = {"batch_solver_threshold": 4} if path == "batch" else {}
    tw = Twin([node("n1", cpu=10_000), node("n2", cpu=10_000),
               node("n3", cpu=6_000)], quota=True, **kw)
    tw.reservation(name="rsv-a", cpu=6_000, mem=4_096)
    tw.reservation(name="rsv-b", node="n3", cpu=3_000, mem=2_048,
                   owners=[{"app": "db"}])
    tw.round()
    tw.t = 5.0
    neg = pod("web-neg", cpu=2_000, mem=1_024, labels={"app": "web"},
              quota="qa")
    neg["requests"][MEM] = -3_000
    db = pod("db-neg", cpu=-500, mem=512, labels={"app": "db"}, quota="qb")
    tw.enqueue(neg, db, pod("web-2", cpu=1_000, labels={"app": "web"}),
               *[pod(f"filler-{j}", cpu=500, mem=256) for j in range(6)])
    res = tw.round()
    assert tw.p.bound["web-neg"].reservation == "rsv-a"
    assert tw.p.bound["db-neg"].reservation == "rsv-b"
    spec = tw.p.reservations.get("rsv-a")
    assert spec.allocated[MEM] < 0 < spec.requests[MEM] - spec.allocated[MEM]
    assert "web-neg" in res.assignments
    tw.t = 10.0
    tw.enqueue(pod("web-3", cpu=4_000, mem=6_000, labels={"app": "web"},
                   quota="qa"))
    tw.round()
    tw.both("delete_pod", "web-neg")
    tw.enqueue(pod("web-4", cpu=1_500, mem=2_000, labels={"app": "web"}))
    tw.round()
