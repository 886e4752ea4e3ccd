"""Parity of the port's gang solve (koordinator_tpu_torch.ops.gang) and the
exact greedy scan with the JAX package: assignments, node accounting and
every quota-state field, exactly."""

import numpy as np
import pytest

from tests.torch_parity import (
    assert_same_fields,
    config,
    port,
    problem,
    quota_trees,
    same,
    set_torch_threads,
    with_quota_ids,
)

set_torch_threads()


def _with_gangs(jp, seed: int):
    """Gang ids over the first pods: six gangs in four groups, min members
    high enough that some gangs fail and roll back."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.gang import GangInfo

    rng = np.random.default_rng(seed + 500)
    p = jp.capacity
    gang_id = np.full(p, -1, np.int32)
    gang_id[:36] = rng.integers(0, 6, 36)
    gangs = GangInfo.build(np.array([4, 6, 3, 9, 5, 2], np.int32),
                           group_id=np.array([0, 1, 1, 3, 4, 4], np.int32))
    return jp.replace(gang_id=jnp.asarray(gang_id)), gangs


GANG_CASES = [(solver, quota, gang, seed)
              for solver in ("batch", "greedy")
              for quota in (False, True)
              for gang in (False, True)
              for seed in (0, 1)]


@pytest.mark.parametrize("solver,with_quota,with_gangs,seed", GANG_CASES)
def test_gang_assign_matches_jax(solver, with_quota, with_gangs, seed):
    from koordinator_tpu.ops.gang import GangInfo, gang_assign as jax_gang
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops.gang import gang_assign

    js, jp = problem(seed, "factored", n_nodes=16, n_pods=64)
    jcfg = config("default")
    gangs = GangInfo.build(np.zeros(0, np.int32))
    if with_gangs:
        jp, gangs = _with_gangs(jp, seed)
    jquota = tquota = None
    if with_quota:
        jtree, _ = quota_trees(seed)
        jquota, _ = JQ.from_tree(jtree)
        jp = with_quota_ids(jp, seed)
        tquota = port(jquota, "QuotaDeviceState")
    wa, wst, wq = jax_gang(js, jp, jcfg, gangs, jquota, passes=2,
                           solver=solver)
    ga, gst, gq = gang_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                              port(jcfg, "ScoringConfig"),
                              port(gangs, "GangInfo"), tquota, passes=2,
                              solver=solver)
    assert same(wa, ga)
    assert_same_fields(wst, gst, "ClusterState")
    if with_quota:
        assert_same_fields(wq, gq, "QuotaDeviceState")
    assert int((ga >= 0).sum()) > 0


@pytest.mark.parametrize("seed", range(2))
def test_greedy_assign_matches_jax(seed):
    from koordinator_tpu.ops.assignment import greedy_assign as jax_greedy
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops.assignment import greedy_assign

    js, jp = problem(seed + 7, "edge", n_nodes=16, n_pods=48)
    jtree, _ = quota_trees(seed)
    jquota, _ = JQ.from_tree(jtree)
    jp = with_quota_ids(jp, seed)
    jcfg = config("everything")
    wa, wst, wq = jax_greedy(js, jp, jcfg, jquota)
    ga, gst, gq = greedy_assign(port(js, "ClusterState"),
                                port(jp, "PodBatch"),
                                port(jcfg, "ScoringConfig"),
                                port(jquota, "QuotaDeviceState"))
    assert same(wa, ga)
    assert_same_fields(wst, gst, "ClusterState")
    assert_same_fields(wq, gq, "QuotaDeviceState")


def test_pre_enqueue_and_rollback_match_jax():
    import jax.numpy as jnp

    from koordinator_tpu.ops import gang as jg

    from koordinator_tpu_torch.ops import gang as tg

    js, jp = problem(3, "factored", n_nodes=16, n_pods=64)
    jp, gangs = _with_gangs(jp, 3)
    tp, tgangs = port(jp, "PodBatch"), port(gangs, "GangInfo")
    assert same(jg.pre_enqueue_mask(jp, gangs), tg.pre_enqueue_mask(tp, tgangs))

    rng = np.random.default_rng(3)
    a = np.where(rng.random(jp.capacity) < 0.6,
                 rng.integers(0, 16, jp.capacity), -1).astype(np.int32)
    prior = rng.random(jp.capacity) < 0.1
    want = jg.rollback_failed_gangs(jnp.asarray(a), js, jp, gangs,
                                    prior_kept=jnp.asarray(prior))
    import torch

    got = tg.rollback_failed_gangs(torch.from_numpy(a), port(js, "ClusterState"),
                                   tp, tgangs,
                                   prior_kept=torch.from_numpy(prior))
    assert same(want[0], got[0])
    assert_same_fields(want[1], got[1], "ClusterState")
    assert same(want[2], got[2]) and same(want[3], got[3])
    assert bool(got[3].any())     # some gang failed and rolled back


def test_gang_info_build_matches_jax():
    from koordinator_tpu.ops.gang import GangInfo

    from koordinator_tpu_torch.ops.gang import GangInfo as TGang

    mm, gid = np.array([3, 1, 4], np.int32), np.array([0, 0, 2], np.int32)
    assert_same_fields(GangInfo.build(mm, gid), TGang.build(mm, gid,
                                                            device="cpu"),
                       "GangInfo")


def test_greedy_solver_rejects_a_candidate_method():
    from koordinator_tpu_torch.ops.gang import GangInfo, gang_assign

    js, jp = problem(0, "factored", n_nodes=16, n_pods=16)
    with pytest.raises(ValueError, match="only to solver"):
        gang_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                    port(config(), "ScoringConfig"),
                    GangInfo.build(np.zeros(0, np.int32), device="cpu"),
                    solver="greedy", method="exact")
    with pytest.raises(ValueError, match="unknown solver"):
        gang_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                    port(config(), "ScoringConfig"),
                    GangInfo.build(np.zeros(0, np.int32), device="cpu"),
                    solver="lp")
