"""Parity of the port's quota overuse revoke (``koordinator_tpu_torch/quota/
overuse_revoke.py``) and of K6's walk (``kernels/overuse_revoke.py``
``overuse_revoke_mirror``) with the JAX package's
``quota/overuse_revoke.py``.

``select_overuse_victims`` of both packages and the mirror take the same
seeded bound pods, per-quota used, runtime and checked dims and PDB
budgets; the revoke masks must be equal.  The cases cover quotas over on
one or several dims, undeclared dims, PDB-blocked pods, hopeless quotas
with and without a blocked pod (skipped, or every candidate evicted),
requests of 0 on the overshoot dim, many rows outside any quota (the
reference walks them as no-ops on quota 0; the port leaves them out),
priority ties, and int32 wraps.  The controller cases hold the port's
``QuotaOveruseRevokeController`` against JAX's through both schedulers
(tests/test_scheduler.py's overuse scenarios and seeded multi-quota ones).
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, MEM, R, port, set_torch_threads

set_torch_threads()


def overuse_problem(seed: int, *, n_quotas: int = 5, n_bound: int = 200,
                    v_cap: int = 256, outside: float = 0.2,
                    blocked_pdbs: int = 1, wrap: bool = False):
    rng = np.random.default_rng(seed)
    v = n_bound
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, v)
    req[:, MEM] = rng.integers(128, 8_192, v)
    req[rng.random(v) < 0.1, CPU] = 0
    quota = rng.integers(0, n_quotas, v).astype(np.int32)
    quota[rng.random(v) < outside] = -1
    pri = rng.integers(1_000, 9_000, v).astype(np.int32)
    pri[rng.random(v) < 0.3] = 3_000                  # ties
    nonp = rng.random(v) < 0.1
    pdb = rng.integers(-1, 3, v).astype(np.int32)
    valid_rows = rng.random(v) < 0.95
    used = np.zeros((n_quotas, R), np.int64)
    live = valid_rows & (quota >= 0)
    np.add.at(used, quota[live], req[live])
    used = used.astype(np.int32)
    # runtime: some quotas under, some a bit over, some far over
    factor = rng.choice([1.2, 0.9, 0.6, 0.2], (n_quotas, 1))
    factor[0] = 0.6
    runtime = (used * factor).astype(np.int32)
    checked = rng.random((n_quotas, R)) < 0.7
    checked[:, CPU] |= rng.random(n_quotas) < 0.8
    if wrap:
        used[0, MEM] = 2**30
        runtime[0, MEM] = 0
        req[quota == 0, MEM] = 2**30 - 5
    pdb_allowed = np.array([0] * blocked_pdbs + [5] * (3 - blocked_pdbs),
                           np.int32)
    return dict(req=req, quota=quota, pri=pri, nonp=nonp, pdb=pdb,
                valid=valid_rows, used=used, runtime=runtime,
                checked=checked, pdb_allowed=pdb_allowed, v_cap=v_cap)


def sched_pair(pb):
    import jax.numpy as jnp

    from koordinator_tpu.ops.preemption import ScheduledPods

    node = np.zeros(len(pb["req"]), np.int32)
    jsched = ScheduledPods.build(
        pb["req"], node, priority=pb["pri"], quota_id=pb["quota"],
        non_preemptible=pb["nonp"], pdb_id=pb["pdb"], capacity=pb["v_cap"])
    valid = np.asarray(jsched.valid).copy()
    valid[: len(pb["req"])] &= pb["valid"]
    jsched = jsched.replace(valid=jnp.asarray(valid))
    return jsched, port(jsched, "ScheduledPods")


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def run_overuse(pb, with_pdb=True):
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.quota.overuse_revoke import (
        select_overuse_victims as jsel,
    )

    from koordinator_tpu_torch.kernels.overuse_revoke import (
        overuse_revoke_mirror,
    )
    from koordinator_tpu_torch.quota.overuse_revoke import (
        select_overuse_victims,
    )

    jsched, tsched = sched_pair(pb)
    pdb = pb["pdb_allowed"] if with_pdb else None
    want = np.asarray(jax.jit(jsel)(
        jsched, jnp.asarray(pb["used"]), jnp.asarray(pb["runtime"]),
        jnp.asarray(pb["checked"]),
        None if pdb is None else jnp.asarray(pdb)))
    args = (tsched, t(pb["used"]), t(pb["runtime"]), t(pb["checked"]),
            None if pdb is None else t(pdb))
    got = select_overuse_victims(*args).numpy()
    assert np.array_equal(want, got)
    mirror, walk = overuse_revoke_mirror(*args)
    assert np.array_equal(want, mirror)
    return want, walk


@pytest.mark.parametrize("seed,opts,with_pdb", [
    (0, {}, True),
    (1, {}, False),
    (2, dict(outside=0.6, n_quotas=3), True),
    (3, dict(blocked_pdbs=3), True),
    (4, dict(n_quotas=1, n_bound=240), True),
    (5, dict(wrap=True), True),
    (6, dict(blocked_pdbs=0), True),
    (7, dict(n_quotas=9, n_bound=60, v_cap=64), False),
])
def test_select_overuse_victims_matches_jax(seed, opts, with_pdb):
    revoke, _ = run_overuse(overuse_problem(seed, **opts), with_pdb)
    assert revoke.any()


def test_hopeless_quota_with_and_without_a_blocked_pod():
    """A quota whose non-candidates alone overshoot runtime: with a
    PDB-blocked pod it is skipped (no pod goes), without one every
    candidate goes, even those requesting 0 on the overshoot dim."""
    pb = overuse_problem(8, n_quotas=2, n_bound=40, v_cap=64, outside=0.0)
    pb["quota"][:] = 0
    pb["quota"][30:] = 1
    pb["valid"][:] = True
    pb["nonp"][:] = False
    pb["nonp"][:3] = True
    pb["pri"][:3] = 1
    pb["req"][:3, CPU] = 50_000
    pb["req"][5:8, CPU] = 0
    pb["used"][0] = pb["req"][:30].sum(0)
    pb["runtime"][0] = 10_000
    pb["checked"][0] = False
    pb["checked"][0, CPU] = True
    pb["pdb"][:] = -1
    pb["pdb"][10] = 0                    # budget 0: blocked
    revoke, _ = run_overuse(pb)
    assert not revoke[:30].any()         # skipped
    pb["pdb"][10] = 2                    # budget 5: nothing blocked
    revoke, _ = run_overuse(pb)
    assert revoke[3:30].all()            # every candidate goes


def test_rows_outside_any_quota_change_nothing():
    """Half the rows have no quota (the reference walks them on quota 0 as
    no-ops); moving them into quota 0 as non-preemptible pods changes no
    revoke decision either."""
    pb = overuse_problem(9, outside=0.5)
    before, _ = run_overuse(pb)
    pb["nonp"] = pb["nonp"] | (pb["quota"] < 0)
    pb["quota"] = np.where(pb["quota"] < 0, 0, pb["quota"]).astype(np.int32)
    after, _ = run_overuse(pb)
    assert np.array_equal(before, after)


def test_one_long_quota_walk():
    """One quota of 2,000 pods at a third of its used: the walk removes
    most of them, then reprieves from the top."""
    pb = overuse_problem(10, n_quotas=1, n_bound=2_000, v_cap=2_048,
                         outside=0.0)
    pb["runtime"][0] = pb["used"][0] // 3
    pb["checked"][0] = False
    pb["checked"][0, CPU] = True
    revoke, walk = run_overuse(pb)
    assert int(walk[0]) > 1_000 and revoke.sum() < walk[0]


def stop_problem(n_pods: int, removed: int | None, blocked: bool = False):
    """One quota of ``n_pods`` candidates of 100 mcores each, priorities
    ascending, at runtime ``used - 100 * removed``: phase 1 removes exactly
    ``removed`` pods (None: runtime -1, so the walk runs past the end of
    the list and the quota is hopeless; ``blocked`` adds a pod an exhausted
    PDB protects, so it is skipped)."""
    v = n_pods + 1
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = 100
    req[:, MEM] = 128
    pdb = np.full(v, -1, np.int32)
    pdb[-1] = 0 if blocked else -1
    used = np.zeros((1, R), np.int32)
    used[0] = req.sum(0)
    runtime = used.copy()
    runtime[0, CPU] = -1 if removed is None else used[0, CPU] - 100 * removed
    checked = np.zeros((1, R), bool)
    checked[0, CPU] = True
    return dict(req=req, quota=np.zeros(v, np.int32),
                pri=np.arange(1_000, 1_000 + v, dtype=np.int32),
                nonp=np.zeros(v, bool), pdb=pdb, valid=np.ones(v, bool),
                used=used, runtime=runtime, checked=checked,
                pdb_allowed=np.array([0, 5, 5], np.int32),
                v_cap=max(8, 1 << (v - 1).bit_length()))


@pytest.mark.parametrize("n_pods,removed,where", [
    (100, 0, "lane 0 of the first chunk"),
    (100, 64, "lane 0 of the third chunk"),
    (100, 31, "lane 31 of the first chunk"),
    (100, 63, "lane 31 of the second chunk"),
    (96, 95, "lane 31 of the last chunk"),
    (100, None, "past the end"),
    (96, None, "past the end of a whole chunk"),
])
def test_k6_stopping_points(n_pods, removed, where):
    """Phase 1 walks 32 rows a step: its stop is found by a ballot within a
    chunk, at any lane, or past the end of the list (hopeless: every
    candidate goes, or none with a blocked pod)."""
    revoke, walk = run_overuse(stop_problem(n_pods, removed))
    want = n_pods + 1 if removed is None else removed
    assert int(walk[0]) == want, where
    if removed is None:
        assert revoke.sum() == n_pods + 1
        revoke, walk = run_overuse(stop_problem(n_pods, None, blocked=True))
        assert int(walk[0]) == n_pods and not revoke.any()


# -- the controller through both schedulers (tests/test_scheduler.py) -----------


def revoke_twin(pdb=None, **kw):
    """Both schedulers on one 16-core node behind two quotas "a" and "b"
    (cpu max 16,000 each), the revoke loop on at a 5 s delay."""
    from tests.test_torch_scheduler_preemption import PreemptTwin, quota_pair
    from tests.test_torch_scheduler_reservations import node

    tw = PreemptTwin([node("n1", cpu=16_000, mem=131_072)],
                     trees=quota_pair(("a", 0, 16_000), ("b", 0, 16_000),
                                      declared_mem=False),
                     enable_preemption=False, **kw)
    tw.revoke(delay=5.0)
    if pdb is not None:
        tw.pdb(*pdb)
    return tw


def test_overuse_revoke_in_round_loop():
    from tests.test_torch_scheduler_reservations import pod

    tw = revoke_twin()
    tw.enqueue(pod("a-low", cpu=10_000, quota="a", priority=3_000),
               pod("a-high", cpu=4_000, quota="a", priority=9_000))
    assert {"a-low", "a-high"} <= set(tw.round().assignments)
    tw.enqueue(pod("b-1", cpu=8_000, quota="b", priority=9_000))
    assert "b-1" in tw.round().failures
    tw.t = 10.0
    res = tw.round()
    assert tw.trevoked == [("a-low", "a")]
    assert res.assignments.get("b-1") == "n1"
    assert "a-high" in tw.p.bound


@pytest.mark.parametrize("case", ["budget_zero", "around_protected",
                                  "uncurable"])
def test_overuse_revoke_and_pdbs(case):
    from tests.test_torch_scheduler_reservations import pod

    if case == "budget_zero":
        tw = revoke_twin(pdb=("protect-a", {"app": "a"}, 0))
        tw.enqueue(pod("a-low", cpu=14_000, quota="a", priority=3_000,
                       labels={"app": "a"}))
        want = []
    elif case == "around_protected":
        tw = revoke_twin(pdb=("protect-low", {"tier": "low"}, 0))
        tw.enqueue(pod("a-low", cpu=7_000, quota="a", priority=3_000,
                       labels={"tier": "low"}),
                   pod("a-mid", cpu=7_000, quota="a", priority=6_000))
        want = [("a-mid", "a")]
    else:
        tw = revoke_twin(pdb=("protect-big", {"tier": "big"}, 0))
        tw.enqueue(pod("a-big", cpu=12_000, quota="a", priority=3_000,
                       labels={"tier": "big"}),
                   pod("a-small", cpu=2_000, quota="a", priority=6_000))
        want = []
    tw.round()
    tw.enqueue(pod("b-1", cpu=8_000, quota="b", priority=9_000))
    tw.round()
    tw.t = 10.0
    tw.round()
    assert tw.trevoked == want


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_overuse_rounds(seed):
    """Three quotas filled while the others idle, then demand arriving in
    turns: runtimes shrink under used, the monitor arms and fires on the
    fake clock, PDBs with budgets 0-2 over the pods' app labels."""
    from tests.test_torch_scheduler_preemption import PreemptTwin, quota_pair
    from tests.test_torch_scheduler_reservations import node, pod

    rng = np.random.default_rng(seed)
    tw = PreemptTwin([node(f"n{i}", cpu=16_000, mem=131_072)
                      for i in range(6)],
                     trees=quota_pair(("a", 0, 60_000), ("b", 0, 60_000),
                                      ("c", 10_000, 60_000),
                                      total_cpu=96_000),
                     enable_preemption=False, batch_solver_threshold=16)
    tw.revoke(delay=4.0)
    for i in range(3):
        tw.pdb(f"pdb-{i}", {"app": f"x{i}"}, int(rng.integers(0, 3)))
    for rnd in range(7):
        tw.t = 3.0 * rnd
        q = "abc"[rnd % 3]
        tw.enqueue(*[pod(f"{q}{rnd}-{j}", cpu=int(rng.integers(500, 5_000)),
                         quota=q, priority=int(rng.integers(1_000, 9_000)),
                         labels={"app": f"x{int(rng.integers(0, 5))}"},
                         creation=float(rnd * 100 + j))
                     for j in range(int(rng.integers(6, 14)))])
        tw.round()
    assert tw.trevoked
