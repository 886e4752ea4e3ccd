"""Parity of the port's ``approx`` and ``chunked`` candidate methods (K1a's
reduction) with the JAX package, on the CPU.

The JAX package picks each stratum's candidates with ``approx_max_k`` over a
float32 key that keeps the quantized score and the tie-break's high bits
(``koordinator_tpu/ops/batch_assign.py`` ``_reduce_candidates``), and its
CPU lowering breaks ties lowest column first.  Inside a run of tie-break
values that share those high bits, lowest column first is exact's highest
tie-break first, except in the run that wraps past column N - 1 to column
0: that run is where the two methods part.  So every problem here holds a
block of identical, attractive nodes at both ends of the node axis (the
node count equals the capacity, so column N - 1 is a real node), or is one
of the shapes where random scores reach the wrap, and each asserts that
JAX's ``approx`` differs from its ``exact`` in at least one row: no test
can pass with ``approx`` routed to the exact path.

Keys, nodes, scores and assignments must be equal, exactly.  Half the
pods of the wide problems carry rotation ids whose tie-break difference
wraps in int32 (two nodes can share a tie-break there).  JAX is imported
inside the tests.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_wide_regime import danger_rot_ids
from tests.torch_parity import (
    CPU,
    GPU,
    MEM,
    assert_same_fields,
    port,
    quota_trees,
    same,
    set_torch_threads,
    with_quota_ids,
)

set_torch_threads()


def wrap_problem(n_nodes: int, n_pods: int, seed: int, ends: int = 4,
                 danger: bool = False):
    """(JAX ClusterState, JAX PodBatch) from ``build_problem`` (4 classes)
    with the first and last ``ends`` nodes made identical and attractive
    (the largest capacity, nothing used, class 0, which every pod
    selects), so they tie at the top of every row across the wrap.
    ``danger`` gives half the pods wrapping rotation ids."""
    import jax.numpy as jnp

    from koordinator_tpu.state.cluster_state import ClusterState
    from tests.problem_helpers import build_problem

    js, jp = build_problem(n_nodes=n_nodes, n_pods=n_pods, seed=seed,
                           classes=4)
    alloc = np.array(js.node_allocatable)
    usage = np.array(js.node_usage)
    requested = np.array(js.node_requested)
    cls = np.array(js.node_class)
    edge = np.r_[0:ends, n_nodes - ends:n_nodes]
    alloc[edge, CPU], alloc[edge, MEM], alloc[edge, GPU] = (
        64_000, 262_144, 8_000)
    usage[edge] = 0
    requested[edge] = 0
    cls[edge] = 0
    state = ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                     capacity=n_nodes, node_class=cls)
    sel = np.array(jp.selector_mask)
    sel[:, 0] = True
    pods = jp.replace(selector_mask=jnp.asarray(sel))
    if danger:
        rng = np.random.default_rng(seed + 11)
        rot = np.array(pods.rot_id)
        rot[: n_pods // 2] = danger_rot_ids(rng, n_pods // 2, n_nodes)
        pods = pods.replace(rot_id=jnp.asarray(rot))
    return state, pods


def build_shape(name: str):
    """(JAX state, JAX pods, spread_bits, k) of a named shape."""
    from tests.problem_helpers import build_problem

    if name == "packed_32x4096_seed2":
        return (*build_problem(n_nodes=32, n_pods=4096, seed=2, classes=4),
                (5, 15), 16)
    if name == "packed_64x4096_seed0":
        return (*build_problem(n_nodes=64, n_pods=4096, seed=0, classes=4),
                (5, 15), 16)
    if name == "packed_256x512_sb0":
        return (*build_problem(n_nodes=256, n_pods=512, seed=0, classes=4),
                0, 16)
    if name == "packed_wrap_256x512":
        return (*wrap_problem(256, 512, seed=1, danger=True), (5, 15), 16)
    if name == "wide_40960_sb5":
        return (*wrap_problem(40_960, 192, seed=3, danger=True), (5, 15), 16)
    if name == "wide_40960_sb0":
        return (*wrap_problem(40_960, 192, seed=4, danger=True), 0, 16)
    raise ValueError(name)


SHAPES = ("packed_32x4096_seed2", "packed_64x4096_seed0",
          "packed_256x512_sb0", "packed_wrap_256x512", "wide_40960_sb5",
          "wide_40960_sb0")


@functools.lru_cache(maxsize=None)
def _jax_select():
    import jax

    from koordinator_tpu.ops import batch_assign as jba

    return jax.jit(jba.select_candidates,
                   static_argnames=("k", "spread_bits", "method",
                                    "with_scores"))


@functools.lru_cache(maxsize=None)
def shape_and_jax(name: str):
    """A shape and JAX's (key, node, score) under approx and exact."""
    from koordinator_tpu.ops.assignment import ScoringConfig

    js, jp, sb, k = build_shape(name)
    cfg = ScoringConfig.default()
    out = {}
    for method in ("approx", "exact"):
        out[method] = tuple(np.asarray(a) for a in _jax_select()(
            js, jp, cfg, k=k, spread_bits=sb, method=method,
            with_scores=True))
    return js, jp, sb, k, out


def rows_differing(out) -> int:
    return int((out["approx"][1] != out["exact"][1]).any(axis=1).sum())


def _port_args(js, jp):
    from koordinator_tpu.ops.assignment import ScoringConfig

    return (port(js, "ClusterState"), port(jp, "PodBatch"),
            port(ScoringConfig.default(), "ScoringConfig"))


@pytest.mark.parametrize("method", ["approx", "chunked"])
@pytest.mark.parametrize("shape", SHAPES)
def test_select_candidates_match_jax(shape, method):
    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp, sb, k, out = shape_and_jax(shape)
    assert rows_differing(out) >= 1, "approx equals exact on this shape"
    got = tba.select_candidates(*_port_args(js, jp), k=k, spread_bits=sb,
                                method=method, with_scores=True)
    for name, w, g in zip(("cand_key", "cand_node", "cand_score"),
                          out["approx"], got):
        assert np.array_equal(w, g.numpy()), name


def test_wrap_run_orders_lowest_column_first():
    """The wrap case: on rows whose top run holds both column N - 1 and
    column 0, approx puts column 0 first and exact column N - 1."""
    js, jp, sb, k, out = shape_and_jax("packed_wrap_256x512")
    n = js.capacity
    node_a, node_e = out["approx"][1], out["exact"][1]
    seen = 0
    for row_a, row_e in zip(node_a[:, :8], node_e[:, :8]):
        la, le = list(row_a), list(row_e)
        if 0 in la and n - 1 in la and 0 in le and n - 1 in le:
            if la.index(0) < la.index(n - 1) and le.index(n - 1) < le.index(0):
                seen += 1
    assert seen >= 1


def test_jax_chunked_equals_approx_row_for_row():
    """The JAX package's chunked method is approx row for row, and so is
    the port's plain version at any pod-chunk width."""
    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_plain,
    )

    js, jp, sb, k, out = shape_and_jax("packed_32x4096_seed2")
    chunked = _jax_select()(js, jp, ScoringConfig.default(), k=k,
                            spread_bits=sb, method="chunked",
                            with_scores=True)
    for w, c in zip(out["approx"], chunked):
        assert np.array_equal(w, np.asarray(c))
    st, pb, cfg = _port_args(js, jp)
    whole = select_candidates_plain(st, pb, cfg, k, sb, method="approx")
    for chunk in (1_000, 4_096):
        got = select_candidates_plain(st, pb, cfg, k, sb, chunk=chunk,
                                      method="approx")
        assert all(torch.equal(a, b) for a, b in zip(whole, got))


def test_k_at_least_the_column_count_ranks_exactly():
    """A stratum whose share is every column takes the exact path, as the
    JAX package does (``k_i < key.shape[1]`` picks approx_max_k); one
    column fewer takes approx, which differs from exact on this shape."""
    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp = wrap_problem(12, 256, seed=5, ends=2)
    cfg = ScoringConfig.default()
    for k, parted in ((12, False), (32, False), (11, True)):
        want = {m: tuple(np.asarray(a) for a in _jax_select()(
            js, jp, cfg, k=k, spread_bits=5, method=m, with_scores=True))
            for m in ("approx", "exact")}
        assert (rows_differing(want) >= 1) == parted, k
        got = tba.select_candidates(*_port_args(js, jp), k=k, spread_bits=5,
                                    method="approx", with_scores=True)
        for w, g in zip(want["approx"], got):
            assert np.array_equal(w, g.numpy()), k


@pytest.mark.parametrize("k,spread", [(1, 0), (2, (5, 15)), (3, (5, 15))],
                         ids=["k1", "k2", "k3"])
def test_one_candidate_stratum_takes_the_last_maximum(k, spread):
    """At k = 1 approx_max_k's CPU lowering reduces to the row's LAST
    maximum: the higher column among equal keys, column N - 1 on a row
    with no feasible column.  A stratum of one candidate (k = 1, k = 2's
    two strata, k = 3's second) follows it, in the plain version and in
    K1a's mirror; JAX's approx differs from its exact here."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.kernels import select_candidates as k1
    from koordinator_tpu_torch.ops import batch_assign as tba
    from koordinator_tpu_torch.ops.assignment import score_pods

    js, jp = wrap_problem(64, 256, seed=8, danger=True)
    sel = np.array(jp.selector_mask)
    sel[::17] = False                     # rows with no feasible column
    jp = jp.replace(selector_mask=jnp.asarray(sel))
    cfg = ScoringConfig.default()
    want = {m: tuple(np.asarray(a) for a in _jax_select()(
        js, jp, cfg, k=k, spread_bits=spread, method=m, with_scores=True))
        for m in ("approx", "exact")}
    assert rows_differing(want) >= 1
    got = tba.select_candidates(*_port_args(js, jp), k=k,
                                spread_bits=spread, method="approx",
                                with_scores=True)
    for w, g in zip(want["approx"], got):
        assert np.array_equal(w, g.numpy())
    assert (want["approx"][1][::17, -1] == 63).all()
    st, pb, tcfg = _port_args(js, jp)
    scores, feasible = score_pods(st, pb, tcfg)
    strata = spread if isinstance(spread, tuple) else (spread,)
    for sb, k_i in zip(strata, k1._stratum_splits(k, len(strata))):
        key, tb = k1._rank_parts(scores, feasible, sb, pb.rot_id)
        a = k1.approx_keys(key, tb, sb, 64)
        assert torch.equal(k1.topk_from_approx_ranks(a, k_i),
                           k1._topk_approx(key, tb, sb, k_i, 64))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_rank_mirror_equals_plain(shape):
    """K1a's lists (``approx_rank``: the approx key over the column's
    complement, 64 bits) and its decoding (``topk_from_approx_ranks``:
    the node from the low bits, -1 slots the lowest infeasible columns)
    give the plain version's columns, for every stratum of the shape."""
    from koordinator_tpu_torch.kernels import select_candidates as k1
    from koordinator_tpu_torch.ops.assignment import score_pods

    js, jp, sb, k, _ = shape_and_jax(shape)
    st, pb, cfg = _port_args(js, jp)
    scores, feasible = score_pods(st, pb, cfg)
    n = st.capacity
    strata = sb if isinstance(sb, tuple) else (sb,)
    for s, k_i in zip(strata, k1._stratum_splits(k, len(strata))):
        key, tb = k1._rank_parts(scores, feasible, s, pb.rot_id)
        a = k1.approx_keys(key, tb, s, n)
        assert int(a.max()) < 2**30
        assert torch.equal(k1.topk_from_approx_ranks(a, k_i),
                           k1._topk_approx(key, tb, s, k_i, n))


@pytest.mark.parametrize("k", [2, 32])
@pytest.mark.parametrize("method", ["approx", "chunked"])
def test_assign_followup_pass_matches_jax(method, k):
    """The second pass over compacted leftovers, selecting with the
    method against the est-augmented state, quota charged.  At k = 2 (one
    candidate a stratum) the wrap run decides each pod's first candidate,
    so JAX's approx assigns otherwise than its exact."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.ops.assignment import ScoringConfig
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops import batch_assign as tba

    js, jp, sb, _, out = shape_and_jax("packed_wrap_256x512")
    assert rows_differing(out) >= 1
    jtree, _ = quota_trees(3, loose=True)
    jquota, _ = JQ.from_tree(jtree)
    jp = with_quota_ids(jp, 3)
    rng = np.random.default_rng(9)
    est = jnp.asarray((np.asarray(js.node_allocatable) * rng.random(
        js.node_allocatable.shape) * 0.1).astype(np.int32))
    cfg = ScoringConfig.default()
    want = jba.assign_followup_pass(js, est, jp, jquota, cfg, k=k,
                                    method=method)
    if k == 2:
        exact = jba.assign_followup_pass(js, est, jp, jquota, cfg, k=k,
                                         method="exact")
        assert (np.asarray(want[0]) != np.asarray(exact[0])).any()
    got = tba.assign_followup_pass(
        port(js, "ClusterState"), torch.from_numpy(np.asarray(est)),
        port(jp, "PodBatch"), port(jquota, "QuotaDeviceState"),
        port(cfg, "ScoringConfig"), k=k, method=method)
    assert same(want[0], got[0]) and int((got[0] >= 0).sum()) > 0
    assert_same_fields(want[1], got[1], "ClusterState")
    assert_same_fields(want[2], got[2], "QuotaDeviceState")
    assert same(want[3], got[3])


def test_gang_assign_batch_approx_matches_jax():
    """gang_assign's batch solver with method="approx" (K1a in every
    pass), gangs in groups rolling back."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig
    from koordinator_tpu.ops.gang import GangInfo, gang_assign as jax_gang

    from koordinator_tpu_torch.ops.gang import gang_assign

    js, jp, sb, k, out = shape_and_jax("packed_wrap_256x512")
    assert rows_differing(out) >= 1
    rng = np.random.default_rng(21)
    gang_id = np.full(jp.capacity, -1, np.int32)
    gang_id[:96] = rng.integers(0, 8, 96)
    gangs = GangInfo.build(
        np.array([10, 14, 12, 40, 9, 11, 13, 12], np.int32),
        group_id=np.array([0, 1, 1, 3, 4, 4, 6, 7], np.int32))
    jp = jp.replace(gang_id=jnp.asarray(gang_id))
    cfg = ScoringConfig.default()
    wa, wst, _ = jax_gang(js, jp, cfg, gangs, None, passes=2,
                          solver="batch", method="approx")
    ga, gst, _ = gang_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                             port(cfg, "ScoringConfig"),
                             port(gangs, "GangInfo"), None, passes=2,
                             solver="batch", method="approx")
    assert same(wa, ga)
    assert_same_fields(wst, gst, "ClusterState")
    placed = np.bincount(gang_id[(gang_id >= 0) & (ga.numpy() >= 0)],
                         minlength=8)
    assert placed.max() > 0 and (placed == 0).any()


# -- K1a's int32 lists (packed regime) ----------------------------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

#: node counts of the int32 rank's tests: below a run, off a multiple of
#: the run length 2**d, powers of two (where 2**32 % N == 0) and the packed
#: regime's last capacity
INT32_NODES = (1, 2, 5, 31, 64, 100, 257, 1_000, 4_099, 10_240, 32_768)


def _rot_at(offset: int) -> int:
    """The rot id whose rot * 7919 (int32-wrapped) is -2**31 + offset."""
    rot = ((2**31 + offset) % 2**32 * pow(7919, -1, 2**32)) % 2**32
    return rot - 2**32 if rot >= 2**31 else rot


def _int32_case(n: int, p: int, seed: int, score_hi: int, density: float):
    """(scores, feasible, rot_id) of ``p`` rows over ``n`` columns: scores
    in [0, score_hi) (few distinct keys, so runs of one approx key hold
    many columns), the first two rows wholly feasible, one row with none,
    and rot ids in three kinds a row: random, the band's
    (:func:`danger_rot_ids`) and rot * 7919 == -2**31 exactly (every
    difference wraps, one preimage a value)."""

    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.integers(0, score_hi, (p, n))
                              .astype(np.int32))
    feas = rng.random((p, n)) < density
    feas[:2] = True
    feas[2] = False
    rot = rng.integers(-(2**31), 2**31 - 1, p).astype(np.int32)
    rot[1::3] = danger_rot_ids(rng, len(rot[1::3]), n)
    rot[3] = _rot_at(0)
    return scores, torch.from_numpy(feas), torch.from_numpy(rot)


@functools.lru_cache(maxsize=None)
def _jax_reduce(k: int, sb: int):
    import jax

    from koordinator_tpu.ops import batch_assign as jba

    return jax.jit(lambda s, f, r: jba._reduce_candidates(
        s, f, (sb,), k, "approx", r)[1])


@settings(max_examples=30, deadline=None)
@given(n=st.sampled_from(INT32_NODES), sb=st.integers(0, 7),
       k=st.integers(1, 32), seed=st.integers(0, 2**16),
       score_hi=st.sampled_from([2, 40, 4_000]),
       density=st.sampled_from([0.05, 0.6, 1.0]))
def test_int32_approx_rank_matches_jax(n, sb, k, seed, score_hi, density):
    """K1a's packed int32 lists (``approx_rank_int32``) and their decoding
    (``topk_from_approx_int32``: the rotation inverted, the tie-break's one
    preimage, -1 slots the lowest infeasible columns or at k = 1 column
    N - 1; band rows on the 64-bit rank) give ``_topk_approx``'s columns
    and the JAX package's approx branch of ``_reduce_candidates``, exactly,
    at every spread, k and node count (k >= N ranks exactly)."""
    import jax.numpy as jnp

    from koordinator_tpu_torch.kernels import select_candidates as k1

    k = min(k, n)
    scores, feas, rot = _int32_case(n, 8, seed, score_hi, density)
    key, tb = k1._rank_parts(scores, feas, sb, rot)
    got = k1.topk_from_approx_int32(key, tb, sb, k, rot, n)
    plain = (k1._topk_approx(key, tb, sb, k, n) if k < n
             else k1._topk_by_rank(key, tb, k, n)[1])
    assert torch.equal(got, plain)
    want = _jax_reduce(k, sb)(jnp.asarray(scores.numpy()),
                              jnp.asarray(feas.numpy()),
                              jnp.asarray(rot.numpy()))
    assert np.array_equal(np.asarray(want), got.numpy())


@settings(max_examples=40, deadline=None)
@given(n=st.one_of(st.sampled_from(INT32_NODES), st.integers(1, 2**15)),
       offsets=st.lists(st.integers(0, 2**15), min_size=1, max_size=6),
       seed=st.integers(0, 2**16))
def test_approx_band_is_where_a_tie_break_has_two_preimages(n, offsets,
                                                             seed):
    """``approx_band`` holds exactly for the rot ids at which some
    tie-break value of the row has two preimages
    (``tie_break_preimages``): rot ids whose rot * 7919 lies ``offset``
    above -2**31 (the band when 0 < offset < N and N does not divide
    2**32), and random ones."""
    from koordinator_tpu_torch.kernels import select_candidates as k1

    rng = np.random.default_rng(seed)
    rots = [_rot_at(off % (2 * n)) for off in offsets]
    rots += rng.integers(-(2**31), 2**31 - 1, 3).tolist()
    rot = torch.tensor(rots, dtype=torch.int32)
    values = torch.arange(n, dtype=torch.int32)[None, :].expand(len(rots), n)
    _, second = k1.tie_break_preimages(values, rot[:, None].expand(-1, n), n)
    assert torch.equal(k1.approx_band(rot, n), (second >= 0).any(dim=1))


@settings(max_examples=40, deadline=None)
@given(n=st.sampled_from(INT32_NODES), sb=st.integers(0, 7),
       k=st.integers(1, 32), seed=st.integers(0, 2**16),
       score_hi=st.sampled_from([2, 40, 4_000]))
def test_int32_approx_rank_orders_as_the_64_bit_rank(n, sb, k, seed,
                                                      score_hi):
    """Off the band, the int32 rank orders a row's feasible columns as
    K1a's 64-bit ``approx_rank`` does (approx key descending, the lowest
    column first; at k = 1 the highest), every column of the row: the
    entries are distinct, so the two sorts agree position by position."""
    from koordinator_tpu_torch.kernels import select_candidates as k1

    if k >= n:
        return                       # an exact stratum: no approx rank
    scores, feas, rot = _int32_case(n, 8, seed, score_hi, 1.0)
    key, tb = k1._rank_parts(scores, feas, sb, rot)
    r32 = k1.approx_rank_int32(key, tb, sb, k, rot, n)
    cols = torch.arange(n)[None, :].expand(8, n)
    r64 = k1.approx_rank(k1.approx_keys(key, tb, sb, n), cols, last=k == 1)
    off = ~k1.approx_band(rot, n) & feas.all(dim=1)   # row 2 has none
    assert int(off.sum()) >= 3
    for i in torch.nonzero(off).flatten().tolist():
        assert r32[i].unique().numel() == n
        assert torch.equal(torch.argsort(r32[i], descending=True),
                           torch.argsort(r64[i], descending=True))
