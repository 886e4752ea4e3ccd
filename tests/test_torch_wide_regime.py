"""Parity of the port's WIDE key regime with the JAX package.

Past ``PACKED_NODE_CAPACITY`` (2**15) node rows the JAX package ranks by
(quantized score, rotated tie-break) instead of one packed int32, and the
port does the same: ``_rank_parts``, ``_topk_by_rank`` (among equal
(key, tb) pairs the HIGHER column first), ``select_candidates``
(``exact`` and ``chunked_exact``), the propose/accept rounds' two-stage
choice, the candidate refresh, and the ``Scheduler`` over rounds, at
40,960 and 65,536 nodes (tests/test_batch_assign.py:385 and
tests/test_sharded_solve.py:196,223 solve these shapes in JAX).  On the
CPU every kernel wrapper takes its plain version; chip_smoke.py holds the
kernels against those on the card.

The problems hold short rows (pods whose selector admits seven nodes, a
pod that admits none, invalid padding rows), so the -1 slots' order
(tie-break descending) is exercised, and rotation ids whose tie-break
difference wraps in int32, so that at 40,960 nodes (2**32 is not a
multiple of it) two nodes can share a tie-break.  Every comparison is
exact: all outputs are int32 or bool.  JAX is imported inside the tests.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    R,
    assert_same_fields,
    config,
    failure_docs,
    port,
    problem,
    quota_trees,
    same,
    set_torch_threads,
    with_quota_ids,
)

set_torch_threads()

WIDE = (40_960, 65_536)


def danger_rot_ids(rng, count: int, n_nodes: int) -> np.ndarray:
    """Rot ids whose rot*7919 (int32-wrapped) lies within n_nodes above
    -2**31: the tie-break difference wraps for some nodes."""
    inv = pow(7919, -1, 2**32)
    target = (2**31 + rng.integers(0, n_nodes, count)) % 2**32
    rot = (target.astype(object) * inv) % 2**32
    return np.array([r - 2**32 if r >= 2**31 else r for r in rot], np.int32)


def wide_problem(seed: int, n_nodes: int, n_pods: int = 12):
    """(JAX ClusterState, JAX PodBatch): ``problem``'s widths at
    ``n_nodes``, with node class 2 held by seven nodes only, three pods
    that select class 2 alone (rows shorter than k), one that selects no
    class, invalid padding rows past ``n_pods``, and wrapping rotation
    ids on half the pods."""
    import jax.numpy as jnp

    state, pods = problem(seed, "factored", n_nodes=n_nodes, n_pods=n_pods)
    rng = np.random.default_rng(seed + 7)
    cls = rng.integers(0, 2, n_nodes).astype(np.int32)
    cls[rng.choice(n_nodes, 7, replace=False)] = 2
    sel = np.array(pods.selector_mask)
    sel[:3] = False
    sel[:3, 2] = True
    sel[3] = False
    rot = np.array(pods.rot_id)
    rot[: n_pods // 2] = danger_rot_ids(rng, n_pods // 2, n_nodes)
    return (state.replace(node_class=jnp.asarray(cls)),
            pods.replace(selector_mask=jnp.asarray(sel),
                         rot_id=jnp.asarray(rot)))


@functools.lru_cache(maxsize=None)
def _jax():
    import jax

    from koordinator_tpu.ops import batch_assign as jba

    return dict(
        select=jax.jit(jba.select_candidates,
                       static_argnames=("k", "spread_bits", "method",
                                        "with_scores")),
        rounds=jax.jit(jba._assign_rounds, static_argnames=("rounds",)),
        refresh=jax.jit(jba.refresh_candidates,
                        static_argnames=("k", "spread_bits")),
    )


def test_node_capacity_ceiling_is_the_only_wall():
    """The packed regime's 2**15 is no wall: only the 2**30 ceiling of
    the int32 key arithmetic raises, as in JAX."""
    from koordinator_tpu_torch.ops import batch_assign as tba

    tba.check_node_capacity(tba.PACKED_NODE_CAPACITY + 1)
    tba.check_node_capacity(tba.MAX_NODE_CAPACITY)
    with pytest.raises(ValueError, match="ceiling"):
        tba.check_node_capacity(2**30 + 1)
    assert tba._packed_regime(tba.PACKED_NODE_CAPACITY)
    assert not tba._packed_regime(tba.PACKED_NODE_CAPACITY + 1)


@pytest.mark.parametrize("n_total", [32_769, 40_960, 65_536, 2**30])
def test_rank_parts_and_candidate_keys_match_jax(n_total):
    """The wide key is the quantized score alone; tb rides beside it.
    Rotation ids near the int32 wrap exercise the tie-break's wrap."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    rng = np.random.default_rng(n_total % 1000)
    p, n = 12, 64
    scores = rng.integers(-50, 40_000, (p, n)).astype(np.int32)
    feas = rng.random((p, n)) < 0.7
    rot = danger_rot_ids(rng, p, min(n_total, 2**20))
    rot[:4] = [2**31 - 1, 0, 7919, 123_456_789]
    ids = rng.integers(0, n_total, n).astype(np.int32)
    for sb in (0, 5, 15):
        for node_ids in (None, ids):
            want = jba._rank_parts(
                jnp.asarray(scores), jnp.asarray(feas), sb, jnp.asarray(rot),
                None if node_ids is None else jnp.asarray(node_ids),
                n_total=n_total)
            got = tba._rank_parts(
                torch.from_numpy(scores), torch.from_numpy(feas), sb,
                torch.from_numpy(rot),
                None if node_ids is None else torch.from_numpy(node_ids),
                n_total=n_total)
            assert same(want[0], got[0]) and same(want[1], got[1])
    score = rng.integers(-1, 2**15, (p, 8)).astype(np.int32)
    node = rng.integers(0, n_total, (p, 8)).astype(np.int32)
    for sb in (0, 5, 15):
        assert same(jba._candidate_keys(jnp.asarray(score), jnp.asarray(node),
                                        jnp.asarray(rot), sb, n_total),
                    tba._candidate_keys(torch.from_numpy(score),
                                        torch.from_numpy(node),
                                        torch.from_numpy(rot), sb, n_total))


@pytest.mark.parametrize("k", [1, 5, 16, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_by_rank_orders_ties_like_jax(k, seed):
    """Many exactly equal (key, tb) pairs, infeasible keys and an
    all-infeasible row: JAX's stable ascending sort then flip puts the
    higher column first among equal pairs, and so must the port."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    rng = np.random.default_rng(seed)
    p, n = 6, 300
    key = rng.integers(-1, 3, (p, n)).astype(np.int32)
    key[2] = -1
    tb = rng.integers(0, 4, (p, n)).astype(np.int32)
    tb[3] = rng.integers(0, 40_960, n)
    wk, wi = jba._topk_by_rank(jnp.asarray(key), jnp.asarray(tb), k, 40_960)
    gk, gi = tba._topk_by_rank(torch.from_numpy(key), torch.from_numpy(tb), k,
                               40_960)
    assert same(wk, gk) and same(wi, gi)


@pytest.mark.parametrize("n_total", WIDE)
@pytest.mark.parametrize("method", ["exact", "chunked_exact"])
def test_select_candidates_match_jax(method, n_total):
    """Keys (the quantized score alone), nodes (the -1 slots in
    tie-break order included) and clipped scores, both strata."""
    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = wide_problem(1, n_total)
    want = _jax()["select"](js, jp, config(), k=32, spread_bits=(5, 15),
                            method=method, with_scores=True)
    got = tba.select_candidates(port(js, "ClusterState"),
                                port(jp, "PodBatch"),
                                port(config(), "ScoringConfig"), k=32,
                                method=method, with_scores=True)
    for name, w, g in zip(("cand_key", "cand_node", "cand_score"), want, got):
        assert same(w, g), name
    key = got[0].numpy()
    for half in (key[:3, :16], key[:3, 16:]):   # each stratum's share
        assert (half >= 0).sum(1).max() <= 7
    assert (key[3] < 0).all()


@pytest.mark.parametrize("n_total", WIDE)
@pytest.mark.parametrize("with_quota", [False, True],
                         ids=["no_quota", "quota"])
def test_assign_rounds_match_jax(n_total, with_quota):
    """The rounds' two-stage choice (max key, then max tb among the
    fitting columns at that key) over JAX's own candidates: assignments,
    node accounting and quota state.  Requests are scaled up so that
    pods contend for the candidates' free capacity."""
    import jax.numpy as jnp

    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = wide_problem(2, n_total, n_pods=40)
    jp = jp.replace(requests=jp.requests * 6)
    jquota = tquota = None
    if with_quota:
        jp = with_quota_ids(jp, 2)
        jtree, _ = quota_trees(2)
        jquota, _ = JQ.from_tree(jtree)
        tquota = port(jquota, "QuotaDeviceState")
    ck, cn = _jax()["select"](js, jp, config(), k=8, spread_bits=(5, 15),
                              method="exact", with_scores=False)
    # every pod proposes among the same few nodes: equal keys, so the
    # tie-break decides, and the winners fill the nodes
    ck = jnp.where(ck >= 0, ck & 1, ck)
    want = _jax()["rounds"](js, jp, jquota, ck, cn, rounds=12)
    got = tba._assign_rounds(port(js, "ClusterState"), port(jp, "PodBatch"),
                             tquota, torch.from_numpy(np.array(ck)),
                             torch.from_numpy(np.array(cn)), 12)
    assert same(want[0], got[0])
    assert same(want[1].node_requested, got[1].node_requested)
    assert (got[0].numpy() >= 0).sum() > 0
    if with_quota:
        assert_same_fields(want[2], got[2], "QuotaDeviceState")


@pytest.mark.parametrize("n_total", WIDE)
@pytest.mark.parametrize("n_dirty,pad", [(5, 3), (40, 24)])
def test_refresh_candidates_match_jax(n_total, n_dirty, pad):
    """The refresh merge in the wide regime: a stale cache (the usage of
    the dirty nodes moved), dirty lists shorter and longer than a
    stratum's k (the two branches of the JAX merge), padding entries on
    row 0, and a dirty node that holds cached slots.  The plain version
    and the kernel's 64-bit list mirror both equal JAX."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_plain,
        refresh_from_wide_lists,
    )

    js, jp = wide_problem(3, n_total)
    rng = np.random.default_rng(n_dirty)
    ck, cn, cs = _jax()["select"](js, jp, config(), k=32, spread_bits=(5, 15),
                                  method="exact", with_scores=True)
    dirty = rng.choice(n_total, n_dirty, replace=False).astype(np.int32)
    dirty[0] = int(np.asarray(cn)[4, 0])   # a node cached slots hold
    usage = np.array(js.node_usage)
    usage[dirty] = (usage[dirty] * rng.random((n_dirty, 1)) * 1.5).astype(
        np.int32)
    js = js.replace(node_usage=jnp.asarray(usage))
    rows = np.concatenate([dirty, np.zeros(pad, np.int32)])
    valid = np.arange(n_dirty + pad) < n_dirty
    cache = jba.CandidateCache(ck, cn, cs)
    wk, wcache = _jax()["refresh"](js, jp, config(), cache, jnp.asarray(rows),
                                   jnp.asarray(valid), k=32,
                                   spread_bits=(5, 15))
    args = (port(js, "ClusterState"), port(jp, "PodBatch"),
            port(config(), "ScoringConfig"), torch.from_numpy(np.array(cn)),
            torch.from_numpy(np.array(cs)), torch.from_numpy(rows),
            torch.from_numpy(valid), 32, (5, 15))
    for fn in (refresh_candidates_plain, refresh_from_wide_lists):
        key, node, score = fn(*args)
        assert same(wk, key), fn.__name__
        assert same(wcache.cand_node, node), fn.__name__
        assert same(wcache.cand_score, score), fn.__name__


def _vec(cpu, mem):
    v = np.zeros(R, np.int32)
    v[0], v[1] = cpu, mem
    return v


def test_scheduler_matches_jax_at_40960_nodes():
    """The port's Scheduler against the JAX Scheduler(mesh="off") on a
    40,960-node cluster (capacity 40,960: the wide regime, at a capacity
    2**32 is not a multiple of), three rounds
    of ~130 pods with the batch threshold lowered so they take the batch
    path: a cold round, then two rounds after a usage refresh and
    arrivals (the incremental path under the forced threshold).  Binds,
    failures, the solve path and the node accounting, round by round."""
    from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode
    from koordinator_tpu.scheduler.snapshot import PodSpec as JPod

    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )

    n_nodes = 40_960
    jsched = JSched(JSnap(capacity=n_nodes), batch_solver_threshold=64,
                    mesh="off")
    tsched = Scheduler(ClusterSnapshot(n_nodes, device="cpu"),
                       batch_solver_threshold=64, device="cpu")
    for s in (jsched, tsched):
        s.incremental_dirty_threshold = 1.0
    rng = np.random.default_rng(40)
    alloc = np.stack([_vec(c, m) for c, m in zip(
        rng.integers(8_000, 64_000, n_nodes),
        rng.integers(16_384, 262_144, n_nodes))])
    usage = (alloc * rng.random((n_nodes, 1)) * 0.5).astype(np.int32)

    def nodes(idx):
        for i in idx:
            spec = dict(name=f"n{i}", allocatable=alloc[i], usage=usage[i],
                        labels={"zone": f"z{i % 4}"})
            jsched.snapshot.upsert_node(JNode(**spec))
            tsched.snapshot.upsert_node(NodeSpec(**spec))

    def pods(start, count):
        for j in range(start, start + count):
            spec = dict(name=f"p{j}",
                        requests=_vec(rng.integers(100, 4_000),
                                      rng.integers(128, 8_192)),
                        priority=int(rng.integers(3_000, 9_999)),
                        node_selector=({"zone": "z1"} if j % 5 == 0
                                       else {}),
                        creation=float(j))
            jsched.enqueue(JPod(**spec))
            tsched.enqueue(PodSpec(**spec))

    nodes(range(n_nodes))
    assert tsched.snapshot.capacity == jsched.snapshot.capacity == n_nodes
    paths = []
    for rnd in range(3):
        pods(rnd * 130, 130)
        if rnd:
            hit = rng.choice(n_nodes, 400, replace=False)
            usage[hit] = (alloc[hit] * rng.random((400, 1)) * 0.5).astype(
                np.int32)
            nodes(hit)
        jr, tr = jsched.schedule_round(), tsched.schedule_round()
        assert tr.assignments == jr.assignments, f"round {rnd}"
        assert failure_docs(tr) == failure_docs(jr), f"round {rnd}"
        assert jsched.last_solver == "batch"
        assert tsched.last_solve_path == jsched.last_solve_path
        assert np.array_equal(
            np.asarray(jsched.snapshot.state.node_requested),
            tsched.snapshot.state.node_requested.numpy()), f"round {rnd}"
        assert len(tr.assignments) > 100
        paths.append(tsched.last_solve_path)
    assert paths == ["full_cold", "incremental", "incremental"], paths
