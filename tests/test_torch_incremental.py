"""Parity of the port's incremental candidate cache with the JAX package.

- ops level: over seeded random node and pod deltas, ``align_candidate_cache``,
  ``refresh_candidates`` (K2's plain version on the CPU),
  ``scatter_candidate_rows``, ``assign_round_pass`` and
  ``assign_followup_pass`` equal their JAX twins exactly, and the refreshed
  cache equals a full selection on its valid slots (the JAX property of
  tests/test_incremental_solve.py, held by the port too);
- scheduler level: the port's ``Scheduler`` and the JAX ``Scheduler``, both
  with the incremental path on, give the same binds, failures and
  ``last_solve_path`` round by round through arrivals, binds, usage
  refreshes and node churn, with and without a quota tree;
- the batch cache and row reuse give the tensors of a fresh build.

Every comparison is exact (int32 and bool tensors).  JAX is imported inside
the tests; its functions are jitted once per process.
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

_CACHE_FIELDS = ("cand_key", "cand_node", "cand_score")


@functools.lru_cache(maxsize=None)
def _jax():
    import jax

    from koordinator_tpu.ops import batch_assign as jba

    return dict(
        align=jax.jit(jba.align_candidate_cache),
        refresh=jax.jit(jba.refresh_candidates,
                        static_argnames=("k", "spread_bits")),
        scatter=jax.jit(jba.scatter_candidate_rows),
        select=jax.jit(jba.select_candidates,
                       static_argnames=("k", "spread_bits", "method",
                                        "with_scores")),
        pass1=jax.jit(jba.assign_round_pass, static_argnames=("rounds",)),
        pass2=jax.jit(jba.assign_followup_pass,
                      static_argnames=("k", "rounds", "spread_bits",
                                       "method")),
    )


def _same_cache(jcache, tcache):
    for name in _CACHE_FIELDS:
        assert same(getattr(jcache, name), getattr(tcache, name)), name


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _permute(jpods, perm):
    """The JAX PodBatch with its rows in ``perm`` order (queue churn)."""
    import jax.numpy as jnp

    fields = {}
    for name in ("requests", "priority", "qos", "gang_id", "quota_id",
                 "non_preemptible", "valid", "rot_id", "selector_mask"):
        fields[name] = jnp.asarray(np.asarray(getattr(jpods, name))[perm])
    return jpods.replace(**fields)


OPS_CASES = [
    # (seed, variant, k, spread_bits, n_nodes)
    (0, "default", 8, (5, 15), 48),      # k_i = 4 < D = 8
    (1, "agg", 32, (5, 15), 48),         # k_i = 16 >= D = 8
    (2, "everything", 8, 5, 48),         # one stratum
    (3, "default", 32, (5, 15), 20),     # k > N: k clamps to N
]


@pytest.mark.parametrize("seed,variant,k,sb,n_nodes", OPS_CASES)
def test_incremental_section_matches_jax_over_random_deltas(seed, variant, k,
                                                            sb, n_nodes):
    """Each step: a node delta (usage, requested, validity; row 0 among the
    dirty rows at step 0, beside the padded entries that also point at row
    0), a pod delta (requests changed, queue rows permuted, some rows
    unmapped), then align -> refresh -> compacted rescore -> scatter, and
    both solve passes with a quota tree.  JAX and the port agree on every
    intermediate, and the cache equals a full selection."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQuota

    from koordinator_tpu_torch.ops import batch_assign as tba

    fns = _jax()
    rng = np.random.default_rng(seed)
    jstate, jpods = problem(seed, "factored", n_nodes=n_nodes, n_pods=40,
                            invalid_tail=3)
    jpods = with_quota_ids(jpods, seed)
    jtree, _ = quota_trees(seed)
    jquota, _ = JQuota.from_tree(jtree)
    jcfg = config(variant)
    tcfg = port(jcfg, "ScoringConfig")
    tquota = port(jquota, "QuotaDeviceState")
    n, p = jstate.capacity, jpods.capacity
    ck, cn, cs = fns["select"](jstate, jpods, jcfg, k=k, spread_bits=sb,
                               method="exact", with_scores=True)
    jcache = jba.CandidateCache(ck, cn, cs)
    tcache = tba.CandidateCache(*(_t(a) for a in (ck, cn, cs)))
    touched_steps = 0

    for step in range(4):
        rows = np.unique(rng.integers(0, n, rng.integers(1, 6)))
        if step == 0:
            rows = np.unique(np.append(rows, 0))
        usage = np.asarray(jstate.node_usage).copy()
        req = np.asarray(jstate.node_requested).copy()
        valid = np.asarray(jstate.node_valid).copy()
        usage[rows] = (usage[rows] * rng.uniform(0.3, 1.7)).astype(np.int32)
        alloc = np.asarray(jstate.node_allocatable)
        req[rows] = np.clip(
            req[rows] + rng.integers(-2_000, 4_000, req[rows].shape),
            0, alloc[rows]).astype(np.int32)
        flip = rows[rng.random(len(rows)) < 0.2]
        valid[flip] = ~valid[flip]
        jstate = jstate.replace(node_usage=jnp.asarray(usage),
                                node_requested=jnp.asarray(req),
                                node_valid=jnp.asarray(valid))
        changed = np.zeros(p, bool)
        pd = np.unique(rng.integers(0, p, rng.integers(0, 4)))
        if len(pd):
            preq = np.asarray(jpods.requests).copy()
            preq[pd, 0] = rng.integers(100, 6_000, len(pd))
            jpods = jpods.replace(requests=jnp.asarray(preq))
            changed[pd] = True
        perm = rng.permutation(p)
        jpods = _permute(jpods, perm)
        changed = changed[perm]
        map_rows = perm.astype(np.int32)
        map_ok = rng.random(p) >= 0.05
        tstate, tpods = port(jstate, "ClusterState"), port(jpods, "PodBatch")

        dirty = np.zeros(n, bool)
        dirty[rows] = True
        dpad = max(8, 1 << (len(rows) - 1).bit_length())
        drows = np.zeros(dpad, np.int32)
        drows[: len(rows)] = rows
        dvalid = np.zeros(dpad, bool)
        dvalid[: len(rows)] = True

        jal, jtouch = fns["align"](jcache, jnp.asarray(map_rows),
                                   jnp.asarray(map_ok), jnp.asarray(dirty))
        tal, ttouch = tba.align_candidate_cache(tcache, _t(map_rows),
                                                _t(map_ok), _t(dirty))
        _same_cache(jal, tal)
        assert same(jtouch, ttouch)
        touched_steps += bool(np.asarray(jtouch).any())

        jkey, jref = fns["refresh"](jstate, jpods, jcfg, jal,
                                    jnp.asarray(drows), jnp.asarray(dvalid),
                                    k=k, spread_bits=sb)
        tkey, tref = tba.refresh_candidates(tstate, tpods, tcfg, tal,
                                            _t(drows), _t(dvalid), k=k,
                                            spread_bits=sb)
        assert same(jkey, tkey)
        _same_cache(jref, tref)

        dirty_pods = np.asarray(jtouch) | ~map_ok | changed
        jsmall, idx = jpods.compact(dirty_pods)
        tsmall, tidx = tpods.compact(dirty_pods)
        assert np.array_equal(idx, tidx)
        jsel = fns["select"](jstate, jsmall, jcfg, k=k, spread_bits=sb,
                             method="exact", with_scores=True)
        tsel = tba.select_candidates(tstate, tsmall, tcfg, k=k,
                                     spread_bits=sb, method="exact",
                                     with_scores=True)
        rows_pad = np.full(jsmall.capacity, p, np.int32)
        rows_pad[: len(idx)] = idx
        jcache = fns["scatter"](jref, jnp.asarray(rows_pad), *jsel)
        tcache = tba.scatter_candidate_rows(tref, _t(rows_pad), *tsel)
        _same_cache(jcache, tcache)

        # exactness of the cache itself: equal to a full selection
        fk, fn = tba.select_candidates(tstate, tpods, tcfg, k=k,
                                       spread_bits=sb, method="exact")
        ok = fk >= 0
        assert torch.equal(ok, tcache.cand_key >= 0), f"step {step}"
        assert torch.equal(fk[ok], tcache.cand_key[ok]), f"step {step}"
        assert torch.equal(fn[ok], tcache.cand_node[ok]), f"step {step}"

        # both solve passes over the refreshed candidates, quota charged
        ja, jst, jq, jest = fns["pass1"](jstate, jpods, jquota,
                                         jcache.cand_key, jcache.cand_node,
                                         jcfg, rounds=12)
        ta, tst, tq, test_ = tba.assign_round_pass(
            tstate, tpods, tquota, tcache.cand_key, tcache.cand_node, tcfg,
            rounds=12)
        assert same(ja, ta) and same(jest, test_)
        assert_same_fields(jst, tst, "ClusterState")
        assert_same_fields(jq, tq, "QuotaDeviceState")
        leftover = np.asarray(jpods.valid) & (np.asarray(ja) < 0)
        if leftover.any():
            jl, _ = jpods.compact(leftover)
            tl, _ = tpods.compact(leftover)
            j2 = fns["pass2"](jst, jest, jl, jq, jcfg, k=k, rounds=12,
                              spread_bits=sb, method="exact")
            t2 = tba.assign_followup_pass(tst, test_, tl, tq, tcfg, k=k,
                                          rounds=12, spread_bits=sb,
                                          method="exact")
            assert same(j2[0], t2[0]) and same(j2[3], t2[3])
            assert_same_fields(j2[1], t2[1], "ClusterState")
            assert_same_fields(j2[2], t2[2], "QuotaDeviceState")
    assert touched_steps > 0, "no step put a dirty node in the cached slots"


def test_scatter_candidate_rows_drops_out_of_range_rows():
    """Rows past the cache (the scheduler's padding value P, and beyond)
    and below -P drop; -1 is the last row, as in JAX's ``mode="drop"``."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    rng = np.random.default_rng(4)
    p, k = 16, 6
    base = [rng.integers(-1, 500, (p, k)).astype(np.int32) for _ in range(3)]
    rows = np.array([3, p, -1, p + 7, -p - 1, 0, 9, p], np.int32)
    src = [rng.integers(-1, 500, (len(rows), k)).astype(np.int32)
           for _ in range(3)]
    want = jba.scatter_candidate_rows(
        jba.CandidateCache(*(jnp.asarray(a) for a in base)),
        jnp.asarray(rows), *(jnp.asarray(a) for a in src))
    got = tba.scatter_candidate_rows(
        tba.CandidateCache(*(_t(a) for a in base)), _t(rows),
        *(_t(a) for a in src))
    _same_cache(want, got)


def test_refresh_refuses_a_dense_feasibility_mask():
    """The refresh scores gathered dirty COLUMNS through the factored
    selector mask; a dense (P, N) mask has no such form (the JAX scheduler
    never sends one down this path) and is refused, not misread."""
    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = problem(6, "dense", n_nodes=24, n_pods=16)
    tstate, tpods = port(js, "ClusterState"), port(jp, "PodBatch")
    tcfg = port(config("default"), "ScoringConfig")
    cache = tba.CandidateCache(*tba.select_candidates(
        tstate, tpods, tcfg, k=8, method="exact", with_scores=True))
    rows = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="factored selector"):
        tba.refresh_candidates(tstate, tpods, tcfg, cache, rows,
                               torch.zeros(8, dtype=torch.bool), k=8)


# -- scheduler level -----------------------------------------------------------


def _vec(cpu, mem):
    v = np.zeros(R, np.int32)
    v[0], v[1] = cpu, mem
    return v


def _jax_tree(tight: bool):
    from koordinator_tpu.quota.tree import QuotaTree as JTree

    from koordinator_tpu_torch.quota.tree import QuotaTree as TTree

    out = []
    for cls in (JTree, TTree):
        total = np.zeros(R, np.int64)
        total[0], total[1] = 400_000, 800_000
        t = cls(total)
        mn = np.zeros(R, np.int64)
        mn[0] = 20_000
        mx = np.full(R, 60_000 if tight else 10**6, np.int64)
        t.add("qa", mn, mx)
        t.add("qb", mn, mx)
        t.refresh_runtime()
        out.append(t)
    return out


def _sched_pair(n_nodes: int, quota: bool, threshold):
    from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap

    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    jtree, ttree = _jax_tree(tight=True) if quota else (None, None)
    cap = max(32, 1 << (n_nodes - 1).bit_length())
    jsched = JSched(JSnap(capacity=cap), quota_tree=jtree,
                    batch_solver_threshold=1, mesh="off")
    tsched = Scheduler(ClusterSnapshot(cap, device="cpu"), quota_tree=ttree,
                       batch_solver_threshold=1, device="cpu")
    if threshold is not None:
        jsched.incremental_dirty_threshold = threshold
        tsched.incremental_dirty_threshold = threshold
    assert jsched.incremental_solve and tsched.incremental_solve
    return jsched, tsched


def _both_nodes(jsched, tsched, specs):
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode

    from koordinator_tpu_torch.scheduler.snapshot import NodeSpec

    for spec in specs:
        jsched.snapshot.upsert_node(JNode(**spec))
        tsched.snapshot.upsert_node(NodeSpec(**spec))


def _both_pods(jsched, tsched, specs):
    from koordinator_tpu.scheduler.snapshot import PodSpec as JPod

    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    for spec in specs:
        jsched.enqueue(JPod(**spec))
        tsched.enqueue(PodSpec(**spec))


def _node_spec(rng, name):
    return dict(name=name,
                allocatable=_vec(rng.integers(8_000, 32_000),
                                 rng.integers(16_384, 65_536)),
                usage=_vec(rng.integers(0, 2_000), rng.integers(0, 4_096)),
                labels={"zone": f"z{rng.integers(0, 2)}"})


def _pod_spec(rng, name, quota=None, creation=0.0):
    return dict(name=name,
                requests=_vec(rng.integers(200, 4_000),
                              rng.integers(256, 8_192)),
                priority=int(rng.integers(3_000, 9_999)), quota=quota,
                node_selector=({"zone": "z1"} if rng.random() < 0.2 else {}),
                creation=creation)


def _assert_round_equal(jr, tr, jsched, tsched, rnd):
    assert tr.assignments == jr.assignments, f"round {rnd}"
    assert failure_docs(tr) == failure_docs(jr), f"round {rnd}"
    jpath = (jsched.last_solve_path if jsched.last_solver == "batch"
             else "greedy")
    assert tsched.last_solve_path == jpath, f"round {rnd}"
    assert np.array_equal(np.asarray(jsched.snapshot.state.node_requested),
                          tsched.snapshot.state.node_requested.numpy())
    st = tsched.snapshot.state
    ok = (st.node_requested <= st.node_allocatable).all(dim=-1)
    assert bool(ok[st.node_valid].all()), "node overcommitted"


@pytest.mark.parametrize("quota", [False, True], ids=["no_quota", "quota"])
@pytest.mark.parametrize("threshold", [None, 1.0],
                         ids=["default_threshold", "forced_incremental"])
def test_scheduler_defaults_match_jax_over_churn(quota, threshold):
    """Arrivals every round, a standing backlog of pods no node fits (the
    steady state's unchanged queue rows), usage refreshes, a node removed
    and one added.  With the defaults the small delta stays under the dirty
    threshold, so rounds go incremental; 1.0 forces the refresh whatever
    the delta (tests/test_incremental_solve.py's setting)."""
    jsched, tsched = _sched_pair(64, quota, threshold)
    rng = np.random.default_rng(17 if quota else 7)
    _both_nodes(jsched, tsched, [_node_spec(rng, f"n{i}") for i in range(64)])
    big = dict(requests=_vec(90_000, 10_000), priority=4_000)
    _both_pods(jsched, tsched, [dict(big, name=f"big{i}", creation=float(i))
                                for i in range(30)])
    paths = []
    pod_i = 0
    for rnd in range(7):
        arrivals = []
        for _ in range(int(rng.integers(1, 5))):
            q = ("qa", "qb")[pod_i % 2] if quota else None
            arrivals.append(_pod_spec(rng, f"p{pod_i}", q,
                                      creation=100.0 + pod_i))
            pod_i += 1
        _both_pods(jsched, tsched, arrivals)
        if rnd >= 2:
            refresh = []
            for i in np.unique(rng.integers(0, 64, 2)):
                name = f"n{i}"
                if name not in tsched.snapshot.node_specs:
                    continue
                spec = dict(_node_spec(rng, name),
                            allocatable=tsched.snapshot.node_specs[name]
                            .allocatable)
                refresh.append(spec)
            _both_nodes(jsched, tsched, refresh)
        if rnd == 5:
            jsched.snapshot.remove_node("n3")
            tsched.snapshot.remove_node("n3")
            _both_nodes(jsched, tsched, [_node_spec(rng, "n-extra")])
        jr, tr = jsched.schedule_round(), tsched.schedule_round()
        _assert_round_equal(jr, tr, jsched, tsched, rnd)
        assert tsched.last_dirty_node_frac <= 1.0
        paths.append(tsched.last_solve_path)
        if quota:
            for name, q in jsched.quota_tree.nodes.items():
                assert np.array_equal(q.used,
                                      tsched.quota_tree.nodes[name].used)
    assert paths[0] == "full_cold"
    assert "incremental" in paths, paths


def test_unchanged_queue_takes_the_incremental_path_with_no_dirty_pods():
    """Repeated rounds over an unchanged queue no node fits: the refresh
    runs with zero dirty pods and zero dirty nodes, and the whole batch is
    reused (the JAX test_unchanged_queue_rounds_reuse_cache_without_rescore,
    on both schedulers)."""
    jsched, tsched = _sched_pair(1, quota=False, threshold=None)
    _both_nodes(jsched, tsched, [dict(name="small",
                                      allocatable=_vec(1_000, 1_024))])
    _both_pods(jsched, tsched, [dict(name=f"big{i}",
                                     requests=_vec(50_000, 100_000),
                                     priority=5_000) for i in range(4)])
    for rnd, path in enumerate(("full_cold", "incremental", "incremental")):
        jr, tr = jsched.schedule_round(), tsched.schedule_round()
        _assert_round_equal(jr, tr, jsched, tsched, rnd)
        assert not tr.assignments and tsched.last_solve_path == path
    assert tsched.last_dirty_pod_frac == 0.0
    assert tsched.last_dirty_node_frac == 0.0
    assert tsched.batch_rebuilds == 1


def test_dirty_fraction_over_threshold_falls_back_to_the_full_pass():
    jsched, tsched = _sched_pair(12, quota=False, threshold=0.0)
    rng = np.random.default_rng(5)
    _both_nodes(jsched, tsched, [_node_spec(rng, f"n{i}") for i in range(12)])
    for rnd, path in enumerate(("full_cold", "full_fallback")):
        _both_pods(jsched, tsched, [_pod_spec(rng, f"p{rnd}-{j}")
                                    for j in range(3)])
        jr, tr = jsched.schedule_round(), tsched.schedule_round()
        _assert_round_equal(jr, tr, jsched, tsched, rnd)
        assert tsched.last_solve_path == path


# -- batch cache and row reuse ---------------------------------------------


def _port_sched(snap, quota_tree=None):
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    return Scheduler(snap, quota_tree=quota_tree, device="cpu")


def test_batch_cache_and_row_reuse_equal_a_fresh_build():
    """A reused batch (whole or row by row) equals a fresh build of the
    same queue, and both equal the JAX scheduler's build: after arrivals,
    a dequeue, a re-specced pod, and a new node class."""
    import dataclasses

    from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode
    from koordinator_tpu.scheduler.snapshot import PodSpec as JPod

    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )

    rng = np.random.default_rng(23)
    jtree, ttree = quota_trees(2, loose=True)
    jsnap, tsnap = JSnap(capacity=32), ClusterSnapshot(32, device="cpu")
    nodes = [dict(_node_spec(rng, f"n{i}"),
                  taints={"gpu": "yes"} if i % 5 == 0 else {})
             for i in range(20)]
    for spec in nodes:
        jsnap.upsert_node(JNode(**spec))
        tsnap.upsert_node(NodeSpec(**spec))
    jsched = JSched(jsnap, quota_tree=jtree, mesh="off")
    sched = _port_sched(tsnap, ttree)

    def pod(j):
        d = _pod_spec(rng, f"p{j}", ("qa", "qb", "qc", None)[j % 4],
                      creation=float(j))
        d["tolerations"] = {"gpu": "yes"} if j % 3 == 0 else {}
        d["non_preemptible"] = j % 7 == 0
        return d

    specs = {f"p{j}": pod(j) for j in range(40)}

    def check_build(expect_reuse: bool):
        pods = sched._active_pods()
        _, quota_index = sched._build_quota()
        before = sched.batch_rebuilds
        cached = sched._batch_cache
        batch = sched._build_batch(pods, {}, quota_index)
        if expect_reuse:
            assert batch is cached[1] and sched.batch_rebuilds == before
        fresh = _port_sched(tsnap, ttree)
        fresh._rot_ids = dict(sched._rot_ids)
        fresh._rot_counter = sched._rot_counter
        fresh.pending = dict(sched.pending)
        assert_same_fields(fresh._build_batch(pods, {}, quota_index), batch,
                           "PodBatch")
        jpods = [JPod(**specs[p.name]) for p in pods]
        jsched._rot_ids = dict(sched._rot_ids)
        jsched._rot_counter = sched._rot_counter
        jsched.pending = {p.name: p for p in jpods}
        jbatch = jsched._build_batch(jpods, {}, quota_index)
        assert_same_fields(jbatch, batch, "PodBatch")

    sched.enqueue_many([PodSpec(**s) for s in specs.values()])
    check_build(False)
    check_build(True)                     # unchanged queue: whole reuse
    for j in range(40, 46):               # arrivals: row reuse
        specs[f"p{j}"] = pod(j)
        sched.enqueue(PodSpec(**specs[f"p{j}"]))
    sched.dequeue("p5")
    del specs["p5"]
    specs["p8"] = dict(specs["p8"], requests=_vec(3_333, 4_444),
                       priority=9_998)
    sched.enqueue(PodSpec(**specs["p8"]))  # a re-specced pod
    check_build(False)
    new_class = dataclasses.replace(NodeSpec(**nodes[1]),
                                    labels={"zone": "z9"})
    tsnap.upsert_node(new_class)          # a new equivalence class
    jsnap.upsert_node(JNode(**dict(nodes[1], labels={"zone": "z9"})))
    check_build(False)
