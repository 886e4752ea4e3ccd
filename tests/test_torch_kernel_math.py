"""The arithmetic the port's CUDA kernels compute differently from their
plain versions, held on the CPU against floor division and the JAX package.

``koordinator_tpu_torch/kernels/select_candidates.py`` mirrors each piece
in PyTorch (the kernels themselves run only on the card; ``chip_smoke.py``
holds them against their plain versions there):

- (a) floor division by an invariant divisor through a magic multiplier
  and shift (``magic_divisor`` / ``magic_floordiv``, and the small
  ScarceResourceAvoidance table), against ``//``;
- (b) the node recovered from a rotated tie-break
  (``tie_break_preimages``), against ``_candidate_tb`` for every node;
- (c) the top-k formed from int32 keys alone, with the -1 slots filled
  from the row's lowest infeasible columns (``topk_from_int32_keys``),
  against the JAX package's ``_topk_by_rank``;
- (d) the wide regime's 64-bit composite rank ``key << 30 | tb``
  (``wide_rank``): its order, its decoding back to (key, tb), and the top-k
  formed from it with the node recovered from the tie-break and the -1
  slots in tie-break order (``topk_from_wide_keys``), against
  ``_topk_by_rank``;
- (e) K2's list merge of the wide regime (``refresh_from_wide_lists``:
  (64-bit rank, 32-bit word) pairs, the word naming each entry's slot or
  dirty column), against the JAX package's ``refresh_candidates``, and
  the butterfly step that merges two lanes' pair lists
  (``merge_pair_lists``), against a sorted union;
- (f) the selector rows packed into 64-bit words and the kernels' bit test
  (``selector_words``, ``selector_bit``), against the JAX package's
  selector gather.

Tolerance 0 everywhere: every value is an integer.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from koordinator_tpu_torch.kernels.select_candidates import (
    _TB_BITS,
    SCARCE_RECIP,
    WIDE_TB_BITS,
    _candidate_tb,
    magic_divisor,
    magic_floordiv,
    scarce_floordiv,
    selector_bit,
    selector_words,
    tie_break_preimages,
    topk_from_int32_keys,
    topk_from_wide_keys,
    wide_rank,
)
from tests.torch_parity import set_torch_threads

set_torch_threads()

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _wmul100(x: np.ndarray) -> np.ndarray:
    """wmul(x, 100): the int32 product the scores divide, wrapped."""
    return (x.astype(np.int64) * 100).astype(np.int32)


def _check_division(numerators, divisors) -> None:
    x = torch.tensor(np.asarray(numerators, np.int64).astype(np.int32))
    d = torch.tensor(np.asarray(divisors, np.int64))
    m, l = magic_divisor(d)
    assert bool(torch.all((m >= 0) & (m < 2**32)))
    got = magic_floordiv(x, m, l)
    want = (x.to(torch.int64) // d).to(torch.int32)
    assert torch.equal(got, want)


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, INT32_MAX),
       xs=st.lists(st.integers(INT32_MIN, INT32_MAX), min_size=1,
                   max_size=64),
       caps=st.lists(st.integers(0, INT32_MAX), min_size=1, max_size=64))
def test_magic_floordiv_equals_floor_division(d, xs, caps):
    """(a) Any int32 numerator, including wmul(x, 100) products that wrap
    negative, over any divisor in 1..2**31-1."""
    wrapped = _wmul100(np.asarray(caps, np.int64))
    nums = np.concatenate([np.asarray(xs, np.int64), wrapped])
    _check_division(nums, np.full(nums.shape, d))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 100, 8_000, 64_000, 2**15 + 1,
                               2**30, 2**30 + 1, 2**31 - 1])
def test_magic_floordiv_at_the_wrap_edge(d):
    """(a) Explicit edges: the int32 extremes, the numerators around the
    point where wmul(x, 100) wraps (x = 21,474,836 -> 2,147,483,600 stays;
    x = 21,474,837 -> -2,147,483,596 wraps), and multiples of d +- 1."""
    edge = 2**31 // 100
    xs = [0, 1, -1, INT32_MAX, INT32_MIN, INT32_MIN + 1, INT32_MAX - 1,
          d, d - 1, d + 1, -d, -d - 1, -d + 1]
    xs += list(_wmul100(np.arange(edge - 3, edge + 4)))
    xs += list(_wmul100(np.array([INT32_MAX, INT32_MAX // 100 + 1])))
    q = INT32_MAX // d
    xs += [q * d, q * d - 1, -q * d, -q * d - 1]
    xs = [x for x in xs if INT32_MIN <= x <= INT32_MAX]
    _check_division(xs, [d] * len(xs))


def test_magic_floordiv_dense_small_divisors():
    """(a) Every divisor 1..4,096 against a seeded spread of numerators."""
    rng = np.random.default_rng(0)
    d = np.repeat(np.arange(1, 4_097), 16)
    x = rng.integers(INT32_MIN, INT32_MAX, d.shape[0], endpoint=True)
    _check_division(x, d)


def test_scarce_table_equals_floor_division():
    """(a) The ScarceResourceAvoidance division, exhaustively: numerators
    (n_diff - n_inter) * 100 for every n_diff in 1..R."""
    n = torch.arange(1, len(SCARCE_RECIP)).repeat_interleave(1_001)
    x = torch.arange(0, 1_001).repeat(len(SCARCE_RECIP) - 1)
    assert torch.equal(scarce_floordiv(x, n),
                       (x // n).to(torch.int32))


def _danger_rot(n_total: int, offset: int) -> int:
    """A rot id whose rot*7919 (int32-wrapped) lies ``offset`` above
    -2**31, so the tie-break difference wraps for the nodes
    n >= 2**31 + rot*7919."""
    target = (2**31 + offset) % 2**32          # -2**31 + offset, unsigned
    inv = pow(7919, -1, 2**32)
    rot = (target * inv) % 2**32
    return rot - 2**32 if rot >= 2**31 else rot


@pytest.mark.parametrize("n_total", [1, 7, 1_024, 10_240, 32_768])
def test_tie_break_preimages_invert_candidate_tb(n_total):
    """(b) For every node, at rot ids whose rot*7919 wraps (large ids) and
    ones whose tie-break difference also wraps: the node is a preimage of
    its own tie-break under the JAX package's and the port's
    _candidate_tb, and without the difference wrap it is the only one."""
    from koordinator_tpu.ops.batch_assign import _candidate_tb as jax_tb

    plain = [0, 1, 3, 271_184, 2**31 - 1, -5, -(2**31), 1_000_003,
             987_654_321]
    danger = [_danger_rot(n_total, off)
              for off in sorted({0, 1, n_total // 2, max(n_total - 2, 0)})]
    rots = torch.tensor(plain + danger, dtype=torch.int32)
    nodes = torch.arange(n_total, dtype=torch.int32)[None, :].expand(
        len(rots), n_total).contiguous()
    tb = _candidate_tb(nodes, rots, n_total)
    want = np.asarray(jax_tb(nodes.numpy(), rots.numpy(), n_total))
    assert np.array_equal(tb.numpy(), want)
    first, second = tie_break_preimages(tb, rots[:, None].expand_as(tb),
                                        n_total)
    assert bool(torch.all((first == nodes) | (second == nodes)))
    assert bool(torch.all((second < 0) | (first < second)))
    # the preimages map back to the same tie-break
    for cand in (first, second):
        ok = cand >= 0
        back = _candidate_tb(cand.clamp(min=0), rots, n_total)
        assert torch.equal(back[ok], tb[ok])
    rot_wrapped = (rots * 7919).to(torch.int64)
    no_wrap = rot_wrapped >= n_total - 2**31
    assert bool(torch.all(second[no_wrap] < 0))
    assert bool(torch.all(first[no_wrap] == nodes[no_wrap]))


def test_tie_break_collides_only_when_the_difference_wraps():
    """(b) At N = 10,240 (2**32 mod N = 4,096) a rot id in the wrap zone
    gives some tie-break two nodes; at N = 1,024 it never does."""
    for n_total, shared in ((10_240, True), (1_024, False)):
        rot = torch.tensor([_danger_rot(n_total, n_total // 2)],
                           dtype=torch.int32)
        nodes = torch.arange(n_total, dtype=torch.int32)[None, :]
        tb = _candidate_tb(nodes, rot, n_total)
        has_two = tb.unique().numel() < n_total
        assert has_two == shared


def _keys(rng, p: int, n: int, feasible_counts, rot: np.ndarray,
          spread_bits: int):
    """A (P, N) ranking key (packed or wide, by N) with exactly
    feasible_counts[i] feasible
    columns in row i (random columns, random scores), via _rank_parts."""
    from koordinator_tpu_torch.kernels.select_candidates import _rank_parts

    scores = torch.from_numpy(rng.integers(0, 400, (p, n)).astype(np.int32))
    feas = np.zeros((p, n), bool)
    for i, c in enumerate(feasible_counts):
        feas[i, rng.choice(n, size=c, replace=False)] = True
    key, tb = _rank_parts(scores, torch.from_numpy(feas), spread_bits,
                          torch.from_numpy(rot), n_total=n)
    return key, tb


@pytest.mark.parametrize("n,k,spread_bits", [(40, 16, 0), (40, 16, 5),
                                             (10_240, 16, 15), (7, 5, 0)])
def test_topk_from_int32_keys_matches_jax_topk(n, k, spread_bits):
    """(c) Rows with 0, 1, k-1, k and many feasible columns, at rot ids
    with and without the wrapped tie-break, against the JAX package's
    _topk_by_rank: the same keys and the same columns, the -1 slots
    included."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.batch_assign import _topk_by_rank

    rng = np.random.default_rng(n + k + spread_bits)
    k = min(k, n)
    counts = [0, 1, k - 1, k, min(n, k + 1), n, n // 2, 2]
    rot = np.array([_danger_rot(n, (i * 131) % max(n - 1, 1)) if i % 2
                    else int(rng.integers(0, 2**31 - 1))
                    for i in range(len(counts))], np.int32)
    key, tb = _keys(rng, len(counts), n, counts, rot, spread_bits)
    want_key, want_col = _topk_by_rank(jnp.asarray(key.numpy()),
                                       jnp.asarray(tb.numpy()), k, n)
    got_key, got_col = topk_from_int32_keys(key, k, torch.from_numpy(rot),
                                            n)
    assert np.array_equal(got_key.numpy(), np.asarray(want_key))
    assert np.array_equal(got_col.numpy(), np.asarray(want_col))


def test_topk_from_int32_keys_resolves_shared_tie_breaks():
    """(c) Two feasible nodes with one key (a wrapped tie-break and the
    same quantized score): the lower column comes first, as in
    lax.top_k, whether both or only one of them fit in k."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.batch_assign import _topk_by_rank
    from koordinator_tpu_torch.kernels.select_candidates import _rank_parts

    n = 10_240
    rot = torch.tensor([_danger_rot(n, n // 2)] * 3, dtype=torch.int32)
    tb_row = _candidate_tb(torch.arange(n, dtype=torch.int32)[None, :],
                           rot[:1], n)[0]
    vals, counts = torch.unique(tb_row, return_counts=True)
    shared = int(vals[counts == 2][0])
    a, b = torch.nonzero(tb_row == shared).flatten().tolist()
    scores = torch.full((3, n), 50, dtype=torch.int32)
    feas = torch.zeros((3, n), dtype=torch.bool)
    feas[:, [a, b]] = True
    feas[1, :8] = True               # more feasible columns, lower keys
    scores[1, :8] = 10
    feas[2, 100] = True              # a better node: k = 2 keeps one copy
    scores[2, 100] = 90
    key, tb = _rank_parts(scores, feas, 0, rot, n_total=n)
    for k in (1, 2, 3, 16):
        want_key, want_col = _topk_by_rank(jnp.asarray(key.numpy()),
                                           jnp.asarray(tb.numpy()), k, n)
        got_key, got_col = topk_from_int32_keys(key, k, rot, n)
        assert np.array_equal(got_key.numpy(), np.asarray(want_key))
        assert np.array_equal(got_col.numpy(), np.asarray(want_col))
    assert (int(key[0, a]) == int(key[0, b])) and a < b
    assert _TB_BITS == 15


def _refresh_case(n: int, n_dirty: int, pad: int, seed: int,
                  n_pods: int = 24):
    """(JAX state before, JAX state after a usage refresh of ``n_dirty``
    nodes, JAX pods, dirty rows, dirty valid) with half the pods at rot
    ids whose tie-break wraps.  Where two nodes share pod 0's tie-break,
    the first two such pairs are made identical, empty and roomy, the
    first dirty (listed in reverse node order, its fresh usage 0) and the
    second clean, so both keys occur twice, among the fresh entries and
    among the cached ones."""
    import jax.numpy as jnp

    from koordinator_tpu.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    r = 10
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = rng.integers(8_000, 64_000, n)
    alloc[:, 1] = rng.integers(16_384, 262_144, n)
    usage = (alloc * rng.random((n, r)) * 0.5).astype(np.int32)
    requested = (alloc * rng.random((n, r)) * 0.3).astype(np.int32)
    node_class = rng.integers(0, 3, n).astype(np.int32)
    rot = np.array([_danger_rot(n, (i * 977) % max(n - 1, 1)) if i % 2
                    else int(rng.integers(0, 2**31 - 1))
                    for i in range(n_pods)], np.int32)
    rot[0] = _danger_rot(n, n // 2)
    tb = _candidate_tb(torch.arange(n, dtype=torch.int32)[None, :],
                       torch.tensor(rot[:1]), n)[0]
    vals, counts = torch.unique(tb, return_counts=True)
    pairs = [torch.nonzero(tb == v).flatten().tolist()
             for v in vals[counts == 2][:2].tolist()]
    forced = []
    for i, (a, b) in enumerate(pairs):
        alloc[b], usage[b], requested[b] = alloc[a], usage[a], requested[a]
        node_class[b] = node_class[a]
        if i == 0:
            forced = [b, a]
        alloc[[a, b], 0], alloc[[a, b], 1] = 64_000, 262_144
        usage[[a, b]], requested[[a, b]] = 0, 0
    paired = {x for p in pairs for x in p}
    others = [int(x) for x in rng.permutation(n) if int(x) not in paired]
    rows = (forced + others)[:n_dirty]
    # pods 2 and 3 fit only the few nodes of class 3: rows shorter than k
    node_class[[x for x in others[::-1] if x not in rows][:5]] = 3
    before = ClusterState.from_arrays(alloc, requested=requested,
                                      usage=usage, capacity=n,
                                      node_class=node_class)
    usage2 = usage.copy()
    usage2[rows] = (alloc[rows] * rng.random((len(rows), r)) * 0.5).astype(
        np.int32)
    usage2[forced] = 0
    after = ClusterState.from_arrays(alloc, requested=requested,
                                     usage=usage2, capacity=n,
                                     node_class=node_class)
    req = np.zeros((n_pods, r), np.int32)
    req[:, 0] = rng.integers(100, 4_000, n_pods)
    req[:, 1] = rng.integers(128, 8_192, n_pods)
    req[rng.random(n_pods) < 0.1, 0] = 0
    sel = rng.random((n_pods, 8)) < 0.7
    sel[:, 3:] = False
    sel[:2, :3] = True
    sel[2:4] = False
    sel[2:4, 3] = True
    pods = PodBatch.build(req, priority=np.full(n_pods, 5, np.int32),
                          selector_mask=sel, class_capacity=8,
                          node_capacity=n, capacity=n_pods, rot_id=rot)
    drows = np.zeros(len(rows) + pad, np.int32)
    drows[:len(rows)] = rows
    dvalid = np.zeros(len(rows) + pad, bool)
    dvalid[:len(rows)] = True
    return before, after, pods, jnp.asarray(drows), jnp.asarray(dvalid), \
        bool(pairs)


@pytest.mark.parametrize("n,n_dirty,pad", [(7, 3, 2), (1_024, 33, 7),
                                           (1_024, 1, 0), (10_240, 100, 28)])
def test_int32_list_refresh_matches_jax(n, n_dirty, pad):
    """K2's int32-list merge (refresh_from_int32_lists) against the JAX
    package's refresh_candidates, row for row: keys, the recovered nodes
    (tie-breaks shared by two dirty nodes or two cached ones where the
    wrap allows it) and the -1 slots' cached nodes in slot order."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_plain,
        refresh_from_int32_lists,
    )
    from tests.torch_parity import port

    before, after, pods, drows, dvalid, shared = _refresh_case(
        n, n_dirty, pad, seed=n + n_dirty)
    cfg = ScoringConfig.default()
    key, node, score = jba.select_candidates(before, pods, cfg, k=32,
                                             spread_bits=(5, 15),
                                             with_scores=True)
    dirty = jnp.zeros(n, bool).at[drows].max(dvalid)
    cache, _ = jba.align_candidate_cache(
        jba.CandidateCache(key, node, score),
        jnp.arange(pods.capacity, dtype=jnp.int32), pods.valid, dirty)
    want_key, want = jba.refresh_candidates(after, pods, cfg, cache, drows,
                                            dvalid, k=32,
                                            spread_bits=(5, 15))
    args = (port(after, "ClusterState"), port(pods, "PodBatch"),
            port(cfg, "ScoringConfig"),
            torch.from_numpy(np.array(cache.cand_node)),
            torch.from_numpy(np.array(cache.cand_score)),
            torch.from_numpy(np.array(drows)),
            torch.from_numpy(np.array(dvalid)), 32, (5, 15))
    for fn in (refresh_from_int32_lists, refresh_candidates_plain):
        got_key, got_node, got_score = fn(*args)
        assert np.array_equal(got_key.numpy(), np.asarray(want_key))
        assert np.array_equal(got_node.numpy(), np.asarray(want.cand_node))
        assert np.array_equal(got_score.numpy(), np.asarray(want.cand_score))
    kk = np.asarray(want_key)
    assert (kk < 0).any()                      # -1 slots are covered
    if shared:
        # some row keeps two equal stratum-0 keys (a shared tie-break)
        dup = (kk[:, 1:] == kk[:, :-1]) & (kk[:, 1:] >= 0)
        assert dup.any()


# -- the wide regime (node capacity past 2**15) ------------------------------


@settings(max_examples=200, deadline=None)
@given(pairs=st.lists(st.tuples(st.integers(-1, 2**15 - 1),
                                st.integers(0, 2**30 - 1)),
                      min_size=1, max_size=60))
def test_wide_rank_orders_by_key_then_tie_break(pairs):
    """(d) key * 2**30 + tb orders exactly as (key, tb), and the key and
    the tie-break come back from it (an arithmetic shift, the low 30
    bits)."""
    key = torch.tensor([k for k, _ in pairs], dtype=torch.int32)
    tb = torch.tensor([t for _, t in pairs], dtype=torch.int32)
    rank = wide_rank(key, tb)
    order = sorted(range(len(pairs)), key=lambda i: (pairs[i], i))
    assert torch.sort(rank, stable=True).indices.tolist() == order
    assert torch.equal((rank >> WIDE_TB_BITS).to(torch.int32), key)
    assert torch.equal((rank & ((1 << WIDE_TB_BITS) - 1)).to(torch.int32),
                       tb)


@settings(max_examples=12, deadline=None)
@given(n=st.sampled_from([32_769, 40_960, 65_536]),
       k=st.sampled_from([1, 5, 16]), spread_bits=st.sampled_from([0, 5, 15]),
       seed=st.integers(0, 2**16))
def test_topk_from_wide_keys_matches_jax_topk(n, k, spread_bits, seed):
    """(d) Rows with 0, 1, k-1, k and many feasible columns over the whole
    node axis, half at rot ids whose tie-break wraps (two nodes share one
    where 2**32 is not a multiple of N), against the JAX package's
    _topk_by_rank in the wide regime: keys and columns, the -1 slots
    included."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.batch_assign import _topk_by_rank

    rng = np.random.default_rng(seed)
    counts = [0, 1, k - 1, k, k + 1, n // 3, 3]
    rot = np.array([_danger_rot(n, int(rng.integers(0, n - 1))) if i % 2
                    else int(rng.integers(0, 2**31 - 1))
                    for i in range(len(counts))], np.int32)
    key, tb = _keys(rng, len(counts), n, counts, rot, spread_bits)
    want_key, want_col = _topk_by_rank(jnp.asarray(key.numpy()),
                                       jnp.asarray(tb.numpy()), k, n)
    got_key, got_col = topk_from_wide_keys(key, tb, k, torch.from_numpy(rot),
                                           n)
    assert np.array_equal(got_key.numpy(), np.asarray(want_key))
    assert np.array_equal(got_col.numpy(), np.asarray(want_col))


def test_topk_from_wide_keys_puts_the_higher_of_a_shared_pair_first():
    """(d) Two feasible nodes a < b with one (key, tb) (a wrapped
    tie-break, the same quantized score): the wide order puts b first,
    whether both or only one of them fit in k, and the -1 slots follow
    the tie-break descending."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.batch_assign import _topk_by_rank
    from koordinator_tpu_torch.kernels.select_candidates import _rank_parts

    n = 40_960
    rot = torch.tensor([_danger_rot(n, n // 2)] * 3, dtype=torch.int32)
    tb_row = _candidate_tb(torch.arange(n, dtype=torch.int32)[None, :],
                           rot[:1], n)[0]
    vals, counts = torch.unique(tb_row, return_counts=True)
    shared = int(vals[counts == 2][0])
    a, b = torch.nonzero(tb_row == shared).flatten().tolist()
    scores = torch.full((3, n), 50, dtype=torch.int32)
    feas = torch.zeros((3, n), dtype=torch.bool)
    feas[:, [a, b]] = True
    feas[1, :8] = True
    scores[1, :8] = 10
    feas[2, 100] = True
    scores[2, 100] = 90
    key, tb = _rank_parts(scores, feas, 0, rot, n_total=n)
    for k in (1, 2, 3, 16):
        want_key, want_col = _topk_by_rank(jnp.asarray(key.numpy()),
                                           jnp.asarray(tb.numpy()), k, n)
        got_key, got_col = topk_from_wide_keys(key, tb, k, rot, n)
        assert np.array_equal(got_key.numpy(), np.asarray(want_key))
        assert np.array_equal(got_col.numpy(), np.asarray(want_col))
    assert got_col[0, :2].tolist() == [b, a]


@pytest.mark.parametrize("n,n_dirty,pad", [(32_769, 1, 0), (40_960, 5, 3),
                                           (40_960, 33, 7),
                                           (65_536, 100, 28),
                                           (40_960, 40, 70_000)])
def test_wide_list_refresh_matches_jax(n, n_dirty, pad):
    """(e) K2's pair-list merge (refresh_from_wide_lists) against the
    JAX package's refresh_candidates in the wide regime, row for row: a
    dirty list shorter than a stratum's k (JAX's merge positions k + the
    column) and longer (k + the dirty top-k's rank), padding on row 0
    (70,000 padded columns: words past 16 bits, and tens of thousands of
    entries that tie on (key, tb)),
    tie-breaks shared by two dirty or two cached nodes, rows shorter than
    k whose -1 slots take infeasible dirty columns by tie-break."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_plain,
        refresh_from_wide_lists,
    )
    from tests.torch_parity import port

    before, after, pods, drows, dvalid, _ = _refresh_case(
        n, n_dirty, pad, seed=n + n_dirty)
    cfg = ScoringConfig.default()
    key, node, score = jba.select_candidates(before, pods, cfg, k=32,
                                             spread_bits=(5, 15),
                                             with_scores=True)
    dirty = jnp.zeros(n, bool).at[drows].max(dvalid)
    cache, _ = jba.align_candidate_cache(
        jba.CandidateCache(key, node, score),
        jnp.arange(pods.capacity, dtype=jnp.int32), pods.valid, dirty)
    want_key, want = jba.refresh_candidates(after, pods, cfg, cache, drows,
                                            dvalid, k=32,
                                            spread_bits=(5, 15))
    args = (port(after, "ClusterState"), port(pods, "PodBatch"),
            port(cfg, "ScoringConfig"),
            torch.from_numpy(np.array(cache.cand_node)),
            torch.from_numpy(np.array(cache.cand_score)),
            torch.from_numpy(np.array(drows)),
            torch.from_numpy(np.array(dvalid)), 32, (5, 15))
    for fn in (refresh_from_wide_lists, refresh_candidates_plain):
        got_key, got_node, got_score = fn(*args)
        assert np.array_equal(got_key.numpy(), np.asarray(want_key))
        assert np.array_equal(got_node.numpy(), np.asarray(want.cand_node))
        assert np.array_equal(got_score.numpy(), np.asarray(want.cand_score))
    assert (np.asarray(want_key) < 0).any()     # -1 slots are covered


@settings(max_examples=200, deadline=None)
@given(n_a=st.integers(0, 16), n_b=st.integers(0, 16),
       spread=st.integers(1, 2**31), seed=st.integers(0, 2**16))
def test_pair_list_butterfly_keeps_the_top_k(n_a, n_b, spread, seed):
    """(e) K2's butterfly step on (rank, word) pair lists
    (``merge_pair_lists``, the kernel's bitonic ``merge_pairs``) equals
    the sorted union's top 16: lists of 0 to 16 pairs padded with the
    empty pair, ranks from -2**30 over ``spread`` values (narrow spreads
    tie many ranks), words distinct as the dirty columns are."""
    from koordinator_tpu_torch.kernels.refresh_candidates import (
        merge_pair_lists,
    )

    rng = np.random.default_rng(seed)
    k, empty = 16, (-(2**63), 0)
    words = rng.choice(2**32, n_a + n_b, replace=False).tolist()
    ranks = (rng.integers(0, spread, n_a + n_b) - 2**30).tolist()
    pairs = list(zip(ranks, words))

    def listed(part):
        return sorted(part, reverse=True) + [empty] * (k - len(part))

    a, b = listed(pairs[:n_a]), listed(pairs[n_a:])
    assert merge_pair_lists(a, b) == sorted(a + b, reverse=True)[:k]


@settings(max_examples=60, deadline=None)
@given(c=st.integers(1, 300), seed=st.integers(0, 2**16),
       density=st.floats(0.0, 1.0))
def test_selector_words_pack_and_test_like_jax(c, seed, density):
    """(f) Bit c % 64 of word c // 64 is column c, and the kernels' test
    of a node class against the words equals the JAX package's selector
    gather (``PodBatch.feasible_rows``: column min(class, C-1), false
    from class C on)."""
    from koordinator_tpu.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    p, n = 5, 40
    sel = rng.random((p, c)) < density
    cls = rng.integers(0, c + 70, n).astype(np.int32)
    words = selector_words(torch.from_numpy(sel))
    assert words.shape == (p, -(-c // 64)) and words.dtype == torch.int64
    w = words.numpy().view(np.uint64)
    for col in range(c):
        bit = (w[:, col // 64] >> np.uint64(col % 64)) & np.uint64(1)
        assert np.array_equal(bit.astype(bool), sel[:, col])
    state = ClusterState.from_arrays(np.ones((n, 10), np.int32),
                                     capacity=n, node_class=cls)
    pods = PodBatch.build(np.ones((p, 10), np.int32), selector_mask=sel,
                          class_capacity=c, node_capacity=n, capacity=p)
    want = np.asarray(pods.feasible_rows(state))
    got = selector_bit(words, torch.from_numpy(cls), c)
    assert want.shape == (p, n) and np.array_equal(got.numpy(), want)
