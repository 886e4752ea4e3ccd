"""Parity of the port's batch solver (koordinator_tpu_torch.ops.batch_assign
and the plain versions behind its three kernels) with the JAX package.

Candidates, assignments, node accounting and quota state are int32/bool:
the tolerance is exact equality.  The kernels themselves need a GPU; here,
on CPU tensors, every wrapper takes its plain version, which is what these
suites hold against JAX.  chip_smoke.py holds each kernel against its plain
version on the card.
"""

import os

import numpy as np
import pytest
import torch

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

CAND_CASES = [
    # (seed, mode, variant, k, spread_bits, n_nodes)
    (0, "factored", "default", 32, (5, 15), 48),
    (1, "factored", "agg", 32, (5, 15), 48),
    (2, "out_of_range", "dominant", 32, (5, 15), 48),
    (3, "dense", "default", 32, (5, 15), 48),
    (4, "edge", "everything", 32, (5, 15), 48),
    (5, "factored", "default", 8, 5, 48),          # one stratum
    (6, "factored", "most_allocated", 7, (3, 9, 15), 48),  # uneven splits
    (7, "factored", "default", 32, (5, 15), 20),   # k > N: k clamps to N
]


@pytest.mark.parametrize("method", ["exact", "chunked_exact"])
@pytest.mark.parametrize("seed,mode,variant,k,sb,n_nodes", CAND_CASES)
def test_select_candidates_matches_jax(method, seed, mode, variant, k, sb,
                                       n_nodes):
    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = problem(seed, mode, n_nodes=n_nodes)
    jcfg = config(variant)
    want = jba.select_candidates(js, jp, jcfg, k=k, spread_bits=sb,
                                 method=method, with_scores=True)
    got = tba.select_candidates(port(js, "ClusterState"),
                                port(jp, "PodBatch"),
                                port(jcfg, "ScoringConfig"), k=k,
                                spread_bits=sb, method=method,
                                with_scores=True)
    for name, w, g in zip(("cand_key", "cand_node", "cand_score"), want, got):
        assert same(w, g), name


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_plain_candidates_are_chunk_invariant(chunk):
    """The plain K1 version scores pod chunks; every chunk width gives the
    JAX exact rows (rows are independent)."""
    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_plain,
    )

    js, jp = problem(11, "factored")
    jcfg = config("default")
    want = jba.select_candidates(js, jp, jcfg, method="exact",
                                 with_scores=True)
    got = select_candidates_plain(port(js, "ClusterState"),
                                  port(jp, "PodBatch"),
                                  port(jcfg, "ScoringConfig"), chunk=chunk)
    for w, g in zip(want, got):
        assert same(w, g)


@pytest.mark.parametrize("n_total", [48, 1000, 4099])
def test_rank_parts_wraps_like_jax(n_total):
    """rot_id * 7919 wraps in int32 and (ids - rot) % n floors on negative
    values: rotation ids near 2**31 exercise both."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    rng = np.random.default_rng(n_total)
    p, n = 12, 48
    scores = rng.integers(-50, 40_000, (p, n)).astype(np.int32)
    feas = rng.random((p, n)) < 0.7
    rot = np.array([2**31 - 1, 2**31 - 2, 271_184, 0, 1, 7919, 123_456_789,
                    2**30, 5, 2**31 - 7919, 99, 3], np.int32)
    for sb in (0, 5, 15):
        wk, wt = jba._rank_parts(jnp.asarray(scores), jnp.asarray(feas), sb,
                                 jnp.asarray(rot), n_total=n_total)
        gk, gt = tba._rank_parts(torch.from_numpy(scores),
                                 torch.from_numpy(feas), sb,
                                 torch.from_numpy(rot), n_total=n_total)
        assert same(wk, gk) and same(wt, gt)
    node = rng.integers(0, n_total, (p, 4)).astype(np.int32)
    assert same(jba._candidate_tb(jnp.asarray(node), jnp.asarray(rot),
                                  n_total),
                tba._candidate_tb(torch.from_numpy(node),
                                  torch.from_numpy(rot), n_total))


BATCH_CASES = [(s, q) for s in range(4) for q in (False, True)]


@pytest.mark.parametrize("seed,with_quota", BATCH_CASES)
def test_batch_assign_matches_jax(seed, with_quota):
    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops import batch_assign as tba

    # 160 pods over 16 nodes: contended, so rounds and prefix acceptance run
    js, jp = problem(seed, "factored", n_nodes=16, n_pods=160)
    jcfg = config("default" if seed % 2 else "dominant")
    jquota = tquota = None
    if with_quota:
        jtree, _ = quota_trees(seed)
        jquota, _ = JQ.from_tree(jtree)
        jp = with_quota_ids(jp, seed)
        tquota = port(jquota, "QuotaDeviceState")
    wa, wst, wq = jba.batch_assign(js, jp, jcfg, jquota)
    ga, gst, gq = tba.batch_assign(port(js, "ClusterState"),
                                   port(jp, "PodBatch"),
                                   port(jcfg, "ScoringConfig"), tquota)
    assert same(wa, ga)
    assert_same_fields(wst, gst, "ClusterState")
    if with_quota:
        assert_same_fields(wq, gq, "QuotaDeviceState")
    else:
        assert wq is None and gq is None
    assert int((ga >= 0).sum()) > 0


def test_quota_device_state_from_tree_matches_jax():
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.quota.admission import QuotaDeviceState as TQ

    jtree, ttree = quota_trees(3)
    jq, jidx = JQ.from_tree(jtree)
    tq, tidx = TQ.from_tree(ttree, device="cpu")
    assert jidx == tidx
    assert_same_fields(jq, tq, "QuotaDeviceState")


@pytest.mark.parametrize("seed", range(3))
def test_quota_admission_and_charge_match_jax(seed):
    import jax.numpy as jnp

    from koordinator_tpu.quota import admission as ja
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.quota import admission as ta

    jtree, _ = quota_trees(seed)
    jq, _ = JQ.from_tree(jtree)
    tq = port(jq, "QuotaDeviceState")
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 60_000, (16, 10)).astype(np.int32)
    qid = rng.choice(np.array([0, 1, 2, 3, -1, 5], np.int32), 16)
    npre = rng.random(16) < 0.4
    mask = rng.random(16) < 0.6
    t = torch.from_numpy
    assert same(ja.quota_admission_mask(jq, jnp.asarray(req), jnp.asarray(qid),
                                        jnp.asarray(npre)),
                ta.quota_admission_mask(tq, t(req), t(qid), t(npre)))
    for sign in (1, -1):
        w = ja.charge_quota_batch(jq, jnp.asarray(req), jnp.asarray(qid),
                                  jnp.asarray(mask), jnp.asarray(npre), sign)
        g = ta.charge_quota_batch(tq, t(req), t(qid), t(mask), t(npre), sign)
        assert_same_fields(w, g, "QuotaDeviceState")
    w = ja.charge_quota(jq, jnp.asarray(req[0]), jnp.int32(2),
                        non_preemptible=True)
    g = ta.charge_quota(tq, t(req[0]), 2, non_preemptible=True)
    assert_same_fields(w, g, "QuotaDeviceState")


@pytest.mark.parametrize("seed", range(4))
def test_prefix_accept_sorted_matches_jax(seed):
    """K3b's plain version against JAX's contended path, with segments
    oversubscribed and inactive pods in the overflow segment."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.kernels.prefix_accept import (
        segmented_prefix_accept,
    )

    rng = np.random.default_rng(seed)
    p, s = 64, 6
    requests = rng.integers(0, 500, (p, 10)).astype(np.int32)
    requests[rng.random((p, 10)) < 0.5] = 0
    choice = rng.integers(0, s, p).astype(np.int32)
    free = rng.integers(0, 1_500, (s, 10)).astype(np.int32)
    active = rng.random(p) < 0.8
    prio = rng.integers(0, 5, p).astype(np.int32)    # many priority ties
    order = np.lexsort((np.arange(p), -prio))
    seg = np.where(active, choice, s).astype(np.int32)
    choice_free = np.where(active[:, None], free[choice], 0).astype(np.int32)
    want = jba._prefix_accept_sorted_choice(
        jnp.asarray(seg), jnp.asarray(requests), jnp.asarray(choice_free),
        jnp.asarray(order), jnp.asarray(active))
    t = torch.from_numpy
    got = segmented_prefix_accept(t(seg), t(requests), t(choice_free),
                                  t(order.astype(np.int64)), t(active), s)
    assert same(want, got)
    assert 0 < int(got.sum()) < int(active.sum())   # contended, some accepted


@pytest.mark.parametrize("seed", range(3))
def test_round_fit_choose_matches_jax_round_body(seed):
    """K3a's plain version against the JAX round body's fit and choice."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
    )

    rng = np.random.default_rng(seed)
    p, k, n = 40, 32, 24
    cand_key = rng.integers(-1, 2**20, (p, k)).astype(np.int32)
    cand_key[rng.random((p, k)) < 0.2] = -1
    cand_key[:3] = -1                       # rows with no valid candidate
    cand_key[5, :4] = 77                    # tied keys: first slot wins
    cand_node = rng.integers(0, n, (p, k)).astype(np.int32)
    free = rng.integers(-100, 2_000, (n, 10)).astype(np.int32)
    req = rng.integers(0, 1_500, (p, 10)).astype(np.int32)
    req[rng.random((p, 10)) < 0.5] = 0
    active = rng.random(p) < 0.8

    jkey, jnode = jnp.asarray(cand_key), jnp.asarray(cand_node)
    cand_free = jnp.asarray(free)[jnode]
    fits = jnp.all((jnp.asarray(req)[:, None, :] <= cand_free)
                   | (jnp.asarray(req)[:, None, :] == 0), axis=-1) & (jkey >= 0)
    best = jba._choose_candidate(jkey, None, fits)
    has = np.asarray(jnp.take_along_axis(fits, best[:, None], 1)[:, 0])
    choice = np.asarray(jnp.take_along_axis(jnode, best[:, None], 1)[:, 0])

    t = torch.from_numpy
    g_choice, g_has = round_fit_choose(t(cand_key), t(cand_node), t(free),
                                       t(req), t(active),
                                       torch.arange(p, dtype=torch.int32))
    assert np.array_equal(g_has.numpy(), has & active)
    assert np.array_equal(g_choice.numpy()[active], choice[active])
    assert np.array_equal(g_choice.numpy()[~active], cand_node[~active, 0])


@pytest.mark.parametrize("method", ["approx", "chunked", "fused"])
def test_unported_or_unknown_methods_raise(method):
    """Every method of the JAX package is ported (approx and chunked run
    K1a's reduction and equal JAX's rows); an unknown one raises."""
    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = problem(0, "factored")
    args = (port(js, "ClusterState"), port(jp, "PodBatch"),
            port(config(), "ScoringConfig"))
    if method not in jba.CANDIDATE_METHODS:
        with pytest.raises(ValueError, match="unknown"):
            tba.select_candidates(*args, method=method)
        return
    want = jba.select_candidates(js, jp, config(), method=method)
    got = tba.select_candidates(*args, method=method)
    assert all(same(w, g) for w, g in zip(want, got))


def test_cpu_wrappers_launch_nothing_and_other_devices_raise():
    """A wrapper takes its plain version only because its tensors lie on
    the CPU (no launch is counted); any other non-CUDA device raises
    instead of falling back."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels.prefix_accept import (
        segmented_prefix_accept,
    )
    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
    )
    from koordinator_tpu_torch.ops import batch_assign as tba

    from koordinator_tpu_torch.ops.reservation import (
        ReservationSet,
        reservation_greedy_assign,
    )

    build.reset_launch_counts()
    js, jp = problem(2, "factored")
    ts, tp = port(js, "ClusterState"), port(jp, "PodBatch")
    tba.batch_assign(ts, tp, port(config(), "ScoringConfig"))
    tba.batch_assign(ts, tp, port(config(), "ScoringConfig"),
                     method="approx")
    rsv = ReservationSet.zeros(16, device="cpu")
    reservation_greedy_assign(
        ts, tp, port(config(), "ScoringConfig"), rsv,
        torch.zeros((tp.capacity, rsv.capacity), dtype=torch.bool))
    from koordinator_tpu_torch.ops.preemption import (
        ScheduledPods,
        preempt_chain,
    )
    from koordinator_tpu_torch.quota.overuse_revoke import (
        select_overuse_victims,
    )

    n = ts.capacity
    sched = ScheduledPods.build(
        np.full((6, 10), 500, np.int32), np.arange(6, dtype=np.int32) % n,
        quota_id=np.zeros(6, np.int32), device="cpu")
    preempt_chain(ts, sched, tp.requests[:2], tp.priority[:2],
                  torch.full((2,), -1, dtype=torch.int32),
                  torch.ones((2, n), dtype=torch.bool),
                  torch.zeros(2, dtype=torch.bool),
                  torch.ones(2, dtype=torch.bool),
                  torch.zeros(1, dtype=torch.int32), None)
    q = torch.zeros((1, 10), dtype=torch.int32)
    select_overuse_victims(sched, q + 3_000, q, q == 0)
    from koordinator_tpu_torch.ops.explain import explain_counts

    explain_counts(ts, tp, port(config(), "ScoringConfig"))
    from koordinator_tpu_torch.kernels.offer_slots import offer_slots

    offer_slots(ts, tp.requests[:3].contiguous(), [0, 3], tp.capacity,
                torch.ones((1, n), dtype=torch.bool),
                port(config(), "ScoringConfig"))
    assert build.LAUNCHES == {"select_candidates": 0,
                              "select_candidates_approx": 0,
                              "refresh_candidates": 0, "round_fit_choose": 0,
                              "segmented_prefix_accept": 0, "greedy_scan": 0,
                              "reservation_scan": 0, "victim_select": 0,
                              "overuse_revoke": 0, "explain_counts": 0,
                              "offer_slots": 0}
    meta = dict(device="meta")
    key = torch.empty((4, 8), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        round_fit_choose(key, key, torch.empty((3, 10), dtype=torch.int32,
                                               **meta),
                         torch.empty((4, 10), dtype=torch.int32, **meta),
                         torch.empty(4, dtype=torch.bool, **meta),
                         torch.empty(4, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="several devices"):
        segmented_prefix_accept(
            torch.zeros(4, dtype=torch.int32), torch.zeros((4, 10),
                                                           dtype=torch.int32),
            torch.zeros((4, 10), dtype=torch.int32, **meta),
            torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.bool),
            3)
    from koordinator_tpu_torch.ops.assignment import ScoringConfig
    from koordinator_tpu_torch.state.cluster_state import (
        ClusterState,
        PodBatch,
    )

    with pytest.raises(ValueError, match="no kernel for device"):
        explain_counts(ClusterState.zeros(8, device="meta"),
                       PodBatch.build(np.zeros((2, 10), np.int32),
                                      node_capacity=8, device="meta"),
                       ScoringConfig.default("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        offer_slots(ClusterState.zeros(8, device="meta"),
                    torch.empty((0, 10), dtype=torch.int32, **meta), [0, 0],
                    16, torch.empty((1, 8), dtype=torch.bool, **meta))


def test_kernel_sources_carry_their_note_and_build_lazily():
    """Each .cu names the JAX function it replaces (file:line) and what
    bounds it; importing the package compiles nothing."""
    import re

    from koordinator_tpu_torch.kernels import build

    srcs = build.sources()
    assert sorted(os.path.basename(s) for s in srcs) == [
        "explain_counts.cu", "greedy_scan.cu", "offer_slots.cu",
        "overuse_revoke.cu", "refresh_candidates.cu", "round_fit_choose.cu",
        "segmented_prefix_accept.cu", "select_candidates.cu",
        "victim_select.cu"]
    for path in srcs:
        head = open(path).read().split("#include")[0]
        assert re.search(r"koordinator_tpu/\w+/\w+\.py:\d+", head), path
        assert "bounds it" in head, path
    assert build._lib is None
