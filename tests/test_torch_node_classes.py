"""Parity of the port with the JAX package past 64 node classes.

A node class is one distinct (labels, taints) signature; the scheduler's
selector masks have one column per class, padded to a power of two.  The
kernels carry a pod's row as W = ceil(C / 64) 64-bit words (K1, K2, K4 and
K4r), so C = 128 (two words) and C = 1,024 (sixteen) are held here: the
selector words' gather against the JAX package's, the candidate selection,
the refresh, the batch solve, the greedy scan and the reservation scan on
seeded problems, and both schedulers over rounds with more than 64
signatures registered.  On the CPU every kernel wrapper takes its plain
version; chip_smoke.py holds the kernels against those on the card.  Every
comparison is exact: all outputs are int32 or bool.  JAX is imported
inside the tests.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    CPU,
    MEM,
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

CLASSES = (128, 1_024)


def class_problem(seed: int, c: int, n_nodes: int = 256, n_pods: int = 48):
    """(JAX ClusterState, JAX PodBatch): ``problem``'s widths with ``c``
    selector columns: node classes uniform over c and an eighth more past
    the mask's width (infeasible for every pod), each class admitted with
    probability 1/2, every fourth pod admitting only classes 64 and up."""
    import jax.numpy as jnp

    state, pods = problem(seed, "factored", n_nodes=n_nodes, n_pods=n_pods)
    rng = np.random.default_rng(seed + 11)
    cls = rng.integers(0, c + c // 8, n_nodes).astype(np.int32)
    sel = rng.random((pods.capacity, c)) < 0.5
    sel[::4, :64] = False
    sel[n_pods:] = False
    return (state.replace(node_class=jnp.asarray(cls)),
            pods.replace(selector_mask=jnp.asarray(sel)))


@pytest.mark.parametrize("c", (65, 128, 1_024, 1_500))
def test_selector_words_gather_like_jax(c):
    """The kernels' word-packed selector test (selector_words,
    selector_bit) equals the JAX package's feasible_rows gather, classes
    past the width included."""
    from koordinator_tpu_torch.kernels.select_candidates import (
        selector_bit,
        selector_words,
    )

    js, jp = class_problem(c, c)
    want = np.asarray(jp.feasible_rows(js))
    sel = torch.from_numpy(np.array(jp.selector_mask))
    got = selector_bit(selector_words(sel),
                       torch.from_numpy(np.array(js.node_class)), c)
    assert np.array_equal(got.numpy(), want)
    assert selector_words(sel).shape == (sel.shape[0], -(-c // 64))


@pytest.mark.parametrize("c", CLASSES)
@pytest.mark.parametrize("method", ["exact", "chunked_exact"])
def test_select_candidates_match_jax(method, c):
    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = class_problem(1, c)
    want = jba.select_candidates(js, jp, config(), k=32, method=method,
                                 with_scores=True)
    got = tba.select_candidates(port(js, "ClusterState"),
                                port(jp, "PodBatch"),
                                port(config(), "ScoringConfig"), k=32,
                                method=method, with_scores=True)
    for name, w, g in zip(("cand_key", "cand_node", "cand_score"), want, got):
        assert same(w, g), name
    assert int((got[0] >= 0).sum()) > 0


@pytest.mark.parametrize("c", CLASSES)
def test_refresh_candidates_match_jax(c):
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_plain,
    )

    js, jp = class_problem(2, c)
    ck, cn, cs = jba.select_candidates(js, jp, config(), k=32,
                                       with_scores=True)
    rng = np.random.default_rng(c)
    dirty = rng.choice(js.capacity, 20, replace=False).astype(np.int32)
    usage = np.array(js.node_usage)
    usage[dirty] = (usage[dirty] * rng.random((20, 1)) * 1.5).astype(
        np.int32)
    js = js.replace(node_usage=jnp.asarray(usage))
    rows = np.concatenate([dirty, np.zeros(12, np.int32)])
    valid = np.arange(32) < 20
    mask = jnp.zeros(js.capacity, bool).at[rows].max(valid)
    cache, _ = jba.align_candidate_cache(
        jba.CandidateCache(ck, cn, cs),
        jnp.arange(jp.capacity, dtype=jnp.int32), jp.valid, mask)
    wk, wcache = jba.refresh_candidates(js, jp, config(), cache,
                                        jnp.asarray(rows),
                                        jnp.asarray(valid), k=32)
    key, node, score = refresh_candidates_plain(
        port(js, "ClusterState"), port(jp, "PodBatch"),
        port(config(), "ScoringConfig"),
        torch.from_numpy(np.array(cache.cand_node)),
        torch.from_numpy(np.array(cache.cand_score)),
        torch.from_numpy(rows), torch.from_numpy(valid))
    assert same(wk, key)
    assert same(wcache.cand_node, node)
    assert same(wcache.cand_score, score)


def _quota(seed, jp):
    from koordinator_tpu.quota.admission import QuotaDeviceState

    jtree, _ = quota_trees(seed, loose=True)
    jquota, _ = QuotaDeviceState.from_tree(jtree)
    return jquota, with_quota_ids(jp, seed)


@pytest.mark.parametrize("c", CLASSES)
def test_batch_and_greedy_solves_match_jax(c):
    """The batch solve (K1, K3a, K3b) and the greedy scan (K4) behind the
    quota tree: assignments, node accounting and quota state."""
    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.ops.assignment import greedy_assign as jgreedy

    from koordinator_tpu_torch.ops import batch_assign as tba
    from koordinator_tpu_torch.ops.assignment import greedy_assign

    js, jp = class_problem(3, c, n_nodes=64, n_pods=120)
    jquota, jp = _quota(3, jp)
    args = (port(js, "ClusterState"), port(jp, "PodBatch"),
            port(config(), "ScoringConfig"),
            port(jquota, "QuotaDeviceState"))
    for jfn, tfn in ((jba.batch_assign, tba.batch_assign),
                     (jgreedy, greedy_assign)):
        wa, wst, wq = jfn(js, jp, config(), jquota)
        ga, gst, gq = tfn(*args)
        assert same(wa, ga), tfn.__name__
        assert_same_fields(wst, gst, "ClusterState")
        assert_same_fields(wq, gq, "QuotaDeviceState")
        assert int((ga >= 0).sum()) > 0


@pytest.mark.parametrize("c", CLASSES)
def test_reservation_scan_matches_jax(c):
    """The reservation-aware scan (K4r's plain version) over 24 rows."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import ReservationSet
    from koordinator_tpu.ops.reservation import (
        reservation_greedy_assign as jassign,
    )

    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.ops.reservation import (
        reservation_greedy_assign,
    )

    js, jp = class_problem(4, c, n_nodes=64, n_pods=40)
    js = js.replace(node_requested=(np.asarray(js.node_allocatable) * 0.6)
                    .astype(np.int32))
    rng = np.random.default_rng(c + 4)
    reserved = np.zeros((24, R), np.int32)
    reserved[:, CPU] = rng.integers(500, 8_000, 24)
    reserved[:, MEM] = rng.integers(256, 16_384, 24)
    rsv = ReservationSet.build(
        reserved, rng.integers(0, 64, 24).astype(np.int32),
        allocated=(reserved * rng.random((24, R)) * 0.5).astype(np.int32),
        allocate_once=rng.random(24) < 0.25,
        restricted=rng.random(24) < 0.3)
    match = rng.random((jp.capacity, rsv.capacity)) < 0.4
    want = jassign(js, jp, config(), rsv, jnp.asarray(match))
    trsv = convert.reservation_set_from_numpy(
        convert.fields_of(rsv, "ReservationSet"), "cpu")
    got = reservation_greedy_assign(
        port(js, "ClusterState"), port(jp, "PodBatch"),
        port(config(), "ScoringConfig"), trsv, torch.from_numpy(match))
    assert same(want[0], got[0]) and same(want[1], got[1])
    assert_same_fields(want[2], got[2], "ClusterState")
    assert_same_fields(want[3], got[3], "ReservationSet")
    assert int((got[1] >= 0).sum()) > 0


def _vec(cpu, mem):
    v = np.zeros(R, np.int32)
    v[CPU], v[MEM] = cpu, mem
    return v


@pytest.mark.parametrize("zones,kinds,class_capacity",
                         [(10, 10, 128), (40, 16, 1_024)])
def test_schedulers_match_jax_past_64_signatures(zones, kinds,
                                                 class_capacity):
    """Both schedulers over one sequence with ``zones`` x ``kinds``
    (labels) and a tainted variant registered, more than 64 signatures:
    a cold batch round, an incremental one after arrivals and a usage
    refresh (the dirty threshold forced to 1.0), and a greedy round (the
    batch threshold raised).  Binds, failures,
    the solve path and the node accounting, round by round."""
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

    n_nodes = zones * kinds + 8
    cap = 1 << (n_nodes - 1).bit_length()
    jsched = JSched(JSnap(capacity=cap), batch_solver_threshold=1,
                    mesh="off")
    tsched = Scheduler(ClusterSnapshot(cap, device="cpu"),
                       batch_solver_threshold=1, device="cpu")
    for s in (jsched, tsched):
        s.incremental_dirty_threshold = 1.0
    rng = np.random.default_rng(zones)
    specs = []
    for i in range(n_nodes):
        z, t = i % zones, (i // zones) % kinds
        specs.append(dict(
            name=f"n{i}",
            allocatable=_vec(rng.integers(8_000, 32_000),
                             rng.integers(16_384, 65_536)),
            usage=_vec(rng.integers(0, 2_000), rng.integers(0, 4_096)),
            labels={"zone": f"z{z}", "type": f"t{t}"},
            taints={"dedicated": "batch"} if i >= zones * kinds else {}))

    def nodes(chosen):
        for spec in chosen:
            jsched.snapshot.upsert_node(JNode(**spec))
            tsched.snapshot.upsert_node(NodeSpec(**spec))

    def pods(start, count):
        for j in range(start, start + count):
            sel = {}
            if rng.random() < 0.5:
                sel["zone"] = f"z{rng.integers(0, zones)}"
            if rng.random() < 0.3:
                sel["type"] = f"t{rng.integers(0, kinds)}"
            spec = dict(name=f"p{j}",
                        requests=_vec(rng.integers(200, 4_000),
                                      rng.integers(256, 8_192)),
                        priority=int(rng.integers(3_000, 9_999)),
                        node_selector=sel,
                        tolerations=({"dedicated": "batch"}
                                     if rng.random() < 0.2 else {}),
                        creation=float(j))
            jsched.enqueue(JPod(**spec))
            tsched.enqueue(PodSpec(**spec))

    nodes(specs)
    assert tsched.snapshot.class_count > 64
    assert tsched.snapshot.class_capacity == class_capacity
    paths = []
    for rnd in range(3):
        pods(rnd * 60, 60)
        if rnd == 1:
            hit = rng.choice(n_nodes, 6, replace=False)
            nodes([dict(specs[i], usage=_vec(rng.integers(0, 2_000),
                                             rng.integers(0, 4_096)))
                   for i in hit])
        if rnd == 2:
            jsched.batch_solver_threshold = 10**6
            tsched.batch_solver_threshold = 10**6
        jr, tr = jsched.schedule_round(), tsched.schedule_round()
        assert tr.assignments == jr.assignments, f"round {rnd}"
        assert failure_docs(tr) == failure_docs(jr), f"round {rnd}"
        jpath = (jsched.last_solve_path if jsched.last_solver == "batch"
                 else "greedy")
        assert tsched.last_solve_path == jpath, f"round {rnd}"
        assert np.array_equal(
            np.asarray(jsched.snapshot.state.node_requested),
            tsched.snapshot.state.node_requested.numpy()), f"round {rnd}"
        assert len(tr.assignments) > 0, f"round {rnd}"
        paths.append(jpath)
    assert paths == ["full_cold", "incremental", "greedy"], paths
