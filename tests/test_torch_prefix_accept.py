"""K3b's per-round acceptance, its once-a-solve quota grouping and the
kernel's blocked segmented scan, held against the JAX package on the CPU.

``koordinator_tpu_torch/kernels/prefix_accept.py`` keeps three versions of
one round's acceptance:

- ``round_prefix_accept_plain``: the levels composed one by one, as the
  JAX round body composes ``_prefix_accept`` and ``_quota_prefix_accept``
  (what the CPU path runs);
- ``round_prefix_accept_mirror``: the kernel's arithmetic (one entry list,
  the quota levels grouped once a solve, a segmented scan in tiles with
  carries across them), with the tile size a parameter;
- the CUDA kernel itself, which ``chip_smoke.py`` holds against the plain
  version on the card.

Tolerance 0 everywhere: every value is an integer or a bool.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from koordinator_tpu_torch.kernels.prefix_accept import (
    accept_plan,
    blocked_segmented_scan,
    round_prefix_accept,
    round_prefix_accept_mirror,
    round_prefix_accept_plain,
    segmented_prefix_accept,
    segmented_prefix_accept_mirror,
)
from tests.torch_parity import (
    config,
    port,
    problem,
    quota_trees,
    set_torch_threads,
    with_quota_ids,
)

set_torch_threads()

R = 10
TILES = (1, 3, 32, 1024)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _three_level_quota(rng, depth: int = 8):
    """(headroom, min_headroom, checked, chain) of root -> 2 parents -> 4
    leaves plus a standalone quota (Q = 8 rows, row 7 unused), the chain
    ``depth`` columns wide (most of them empty)."""
    q = 8
    parent_of = {0: -1, 1: 0, 2: 0, 3: 1, 4: 1, 5: 2, 6: 2, 7: -1}
    chain = np.full((q, depth), -1, np.int32)
    for i in range(q):
        cur, d = i, 0
        while cur >= 0:
            chain[i, d] = cur
            cur, d = parent_of[cur], d + 1
    headroom = rng.integers(-200, 9_000, (q, R)).astype(np.int32)
    min_headroom = rng.integers(-200, 3_000, (q, R)).astype(np.int32)
    checked = rng.random((q, R)) < 0.6
    checked[:, 0] = True
    return headroom, min_headroom, checked, chain


def _round_case(seed: int, p: int = 96, n: int = 12, one_segment=False):
    """One round's inputs: requests with zero dims, choices (-1 where the
    pod has no fitting candidate, and then inactive), priorities with
    ties, pods over every quota row and none."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 1_500, (p, R)).astype(np.int32)
    req[rng.random((p, R)) < 0.5] = 0
    req[:, 2] = 0                                   # a dim no pod requests
    free = rng.integers(0, 6_000, (n, R)).astype(np.int32)
    choice = rng.integers(0, n, p).astype(np.int32)
    has = rng.random(p) < 0.85
    choice[~has] = -1
    act = has & (rng.random(p) < 0.9)
    prio = rng.integers(0, 6, p).astype(np.int32)
    qid = rng.choice(np.array([0, 1, 2, 3, 4, 5, 6, 7, -1], np.int32), p)
    npre = rng.random(p) < 0.3
    if one_segment:
        choice[has] = 3
        qid[:] = 4
    headroom, min_headroom, checked, chain = _three_level_quota(rng)
    if one_segment:                     # room for the first few dozen pods
        free[3] = 20_000
        headroom[[4, 1, 0]] = 20_000
        min_headroom[4] = 6_000
    return dict(req=req, free=free, choice=choice, act=act, prio=prio,
                qid=qid, npre=npre, headroom=headroom,
                min_headroom=min_headroom, checked=checked, chain=chain)


def _jax_round(c):
    """The JAX round body's acceptance: _prefix_accept & _quota_prefix_accept."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ
    from koordinator_tpu.state.cluster_state import PodBatch

    p = c["req"].shape[0]
    quota = JQ(headroom=jnp.asarray(c["headroom"]),
               min_headroom=jnp.asarray(c["min_headroom"]),
               checked=jnp.asarray(c["checked"]),
               chain=jnp.asarray(c["chain"]),
               valid=jnp.ones(c["chain"].shape[0], bool))
    pods = PodBatch.build(c["req"], priority=c["prio"], node_capacity=16,
                          capacity=p).replace(
        quota_id=jnp.asarray(c["qid"]),
        non_preemptible=jnp.asarray(c["npre"]))
    order = jnp.lexsort((jnp.arange(p), -jnp.asarray(c["prio"])))
    req, act = jnp.asarray(c["req"]), jnp.asarray(c["act"])
    acc = jba._prefix_accept(jnp.asarray(c["choice"]), req,
                             jnp.asarray(c["free"]), order, act)
    acc = acc & jba._quota_prefix_accept(quota, req, pods, order, act)
    return np.asarray(acc)


def _port_round(c, fn, **kw):
    order = torch.sort(-_t(c["prio"]), stable=True).indices
    plan = accept_plan(order, _t(c["req"]), _t(c["qid"]), _t(c["npre"]),
                       _t(c["chain"]), _t(c["checked"]))
    return fn(plan, _t(c["choice"]), _t(c["act"]), _t(c["free"]),
              _t(c["headroom"]), _t(c["min_headroom"]), **kw).numpy()


@pytest.mark.parametrize("seed,one_segment", [(0, False), (1, False),
                                              (2, False), (3, True)])
def test_round_accept_plain_and_mirror_match_jax(seed, one_segment):
    """A three-level tree in an eight-column chain (five empty columns),
    non-preemptible pods, checked masks, zero-request dims, choice -1; the
    last case puts every pod in one node and one leaf quota."""
    c = _round_case(seed, one_segment=one_segment)
    want = _jax_round(c)
    assert 0 < want.sum() < c["act"].sum()          # contended
    assert np.array_equal(_port_round(c, round_prefix_accept_plain), want)
    assert np.array_equal(_port_round(c, round_prefix_accept), want)
    for tile in TILES:
        got = _port_round(c, round_prefix_accept_mirror, tile=tile)
        assert np.array_equal(got, want), tile


def test_round_accept_with_no_active_pod_and_without_quota():
    """A level with no active pod accepts nothing; without a quota only
    the node level runs."""
    c = _round_case(5)
    c["act"][:] = False
    assert not _port_round(c, round_prefix_accept_mirror, tile=3).any()
    c = _round_case(6)
    order = torch.sort(-_t(c["prio"]), stable=True).indices
    plan = accept_plan(order, _t(c["req"]))
    args = (_t(c["choice"]), _t(c["act"]), _t(c["free"]))
    want = round_prefix_accept_plain(plan, *args)
    for tile in TILES:
        assert torch.equal(round_prefix_accept_mirror(plan, *args, tile=tile),
                           want)


@pytest.mark.parametrize("seed", range(2))
def test_once_a_solve_grouping_matches_jax_every_round(seed, monkeypatch):
    """Over every round of a seeded solve with a quota tree: the per-round
    acceptance built on the once-a-solve grouping (the kernel's mirror at
    several tiles, and the plain version) equals the JAX round body's on
    that round's inputs, and the solve's result equals JAX _assign_rounds."""
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops import batch_assign as tba
    from tests.torch_parity import same

    js, jp = problem(20 + seed, "factored", n_nodes=12, n_pods=120)
    jtree, _ = quota_trees(seed)
    jquota, _ = JQ.from_tree(jtree)
    jp = with_quota_ids(jp, seed)
    jcfg = config()
    key, node = jba.select_candidates(js, jp, jcfg, k=8)
    want = jba._assign_rounds(js, jp, jquota, key, node, 12)

    ts, tp = port(js, "ClusterState"), port(jp, "PodBatch")
    tq = port(jquota, "QuotaDeviceState")
    order_j = jnp.lexsort((jnp.arange(jp.capacity), -jp.priority))
    rounds = []

    @jax.jit
    def jax_round(choice, act, free, headroom, min_headroom):
        jq = jquota.replace(headroom=headroom, min_headroom=min_headroom)
        acc = jba._prefix_accept(choice, jp.requests, free, order_j, act)
        return acc & jba._quota_prefix_accept(jq, jp.requests, jp, order_j,
                                              act)

    def checked(plan, choice, act, free, headroom, min_headroom):
        ref = np.asarray(jax_round(*(jnp.asarray(a.numpy()) for a in (
            choice, act, free, headroom, min_headroom))))
        got = round_prefix_accept_plain(plan, choice, act, free, headroom,
                                        min_headroom)
        assert np.array_equal(got.numpy(), ref)
        for tile in (3, 32, 1024):
            mirror = round_prefix_accept_mirror(plan, choice, act, free,
                                                headroom, min_headroom, tile)
            assert np.array_equal(mirror.numpy(), ref), tile
        rounds.append(int(act.sum()))
        return got

    monkeypatch.setattr(tba, "round_prefix_accept", checked)
    got = tba._assign_rounds(ts, tp, tq, port_tensor(key), port_tensor(node),
                             12)
    assert len(rounds) >= 2 and rounds[0] > rounds[-1]
    assert same(want[0], got[0])
    assert same(want[1].node_requested, got[1].node_requested)
    assert same(want[2].headroom, got[2].headroom)
    assert same(want[2].min_headroom, got[2].min_headroom)


def port_tensor(a):
    return torch.from_numpy(np.array(a))


def _jax_sorted_choice(seg, req, choice_free, prio, active):
    import jax.numpy as jnp

    from koordinator_tpu.ops import batch_assign as jba

    p = seg.shape[0]
    order = np.lexsort((np.arange(p), -prio))
    out = jba._prefix_accept_sorted_choice(
        jnp.asarray(seg), jnp.asarray(req), jnp.asarray(choice_free),
        jnp.asarray(order), jnp.asarray(active))
    return np.asarray(out), order


def _one_level(rng, p: int, s: int, max_req: int = 600):
    req = rng.integers(0, max_req, (p, R)).astype(np.int32)
    req[rng.random((p, R)) < 0.4] = 0
    choice = rng.integers(0, s, p).astype(np.int32)
    free = rng.integers(0, 3 * max_req, (s, R)).astype(np.int32)
    active = rng.random(p) < 0.8
    seg = np.where(active, choice, s).astype(np.int32)
    choice_free = np.where(active[:, None], free[choice], 0).astype(np.int32)
    prio = rng.integers(0, 4, p).astype(np.int32)
    return seg, req, choice_free, prio, active


def _check_one_level(seg, req, choice_free, prio, active, s, tiles=TILES):
    want, order = _jax_sorted_choice(seg, req, choice_free, prio, active)
    args = (_t(seg), _t(req), _t(choice_free), _t(order.astype(np.int64)),
            _t(active), s)
    assert np.array_equal(segmented_prefix_accept(*args).numpy(), want)
    for tile in tiles:
        got = segmented_prefix_accept_mirror(*args, tile=tile)
        assert np.array_equal(got.numpy(), want), tile
    return want


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), s=st.integers(1, 6),
       tile=st.sampled_from(TILES))
def test_blocked_scan_mirror_matches_jax_sorted_choice(seed, s, tile):
    """The kernel's blocked scan over one level equals the JAX contended
    path, whatever the tile size and wherever runs cross tiles (64 pods,
    one shape, so JAX compiles once)."""
    rng = np.random.default_rng(seed)
    _check_one_level(*_one_level(rng, 64, s), s, tiles=(tile,))


@pytest.mark.parametrize("p,s,tiles", [(2_048, 1, (32, 1024)),
                                       (31, 1, TILES), (32, 1, TILES),
                                       (33, 1, TILES), (97, 3, TILES)])
def test_runs_across_tiles(p, s, tiles):
    """One segment holding a 2,048-pod batch (two 1,024-entry tiles),
    runs of a 32-entry tile and one entry either side of it."""
    rng = np.random.default_rng(p)
    req = rng.integers(0, 600, (p, R)).astype(np.int32)
    req[rng.random((p, R)) < 0.4] = 0
    seg = rng.integers(0, s, p).astype(np.int32)
    # room for about half of each segment's requests
    free = (np.stack([req[seg == i].sum(0) for i in range(s)]) // 2)
    choice_free = free[seg].astype(np.int32)
    prio = rng.integers(0, 4, p).astype(np.int32)
    active = np.ones(p, bool)
    want = _check_one_level(seg, req, choice_free, prio, active, s, tiles)
    assert 0 < want.sum() < p


def test_wrap_edge_inside_the_documented_domain():
    """One segment whose sum reaches 2**31 - 1 exactly (the global int32
    sum does not overflow): the last pods' prefixes sit at the edge."""
    p = 64
    req = np.zeros((p, R), np.int32)
    req[:, 0] = (2**31 - 1) // p
    req[-1, 0] += (2**31 - 1) - int(req[:, 0].sum())
    assert int(req[:, 0].astype(np.int64).sum()) == 2**31 - 1
    seg = np.zeros(p, np.int32)
    choice_free = np.full((p, R), 2**31 - 1, np.int32)
    choice_free[p // 2:, 0] = 2**31 - 2          # the tail half just misses
    prio = np.zeros(p, np.int32)
    active = np.ones(p, bool)
    want = _check_one_level(seg, req, choice_free, prio, active, 1)
    assert want[:p // 2].all() and not want[-1]


def test_blocked_segmented_scan_wraps_as_int32():
    """The scan's sums wrap like the kernel's int32 adds, carried across
    tiles or not."""
    v = torch.tensor([[2**31 - 1], [5], [7], [-3]], dtype=torch.int32)
    start = torch.tensor([True, False, True, False])
    want = torch.tensor([[2**31 - 1], [-(2**31) + 4], [7], [4]],
                        dtype=torch.int32)
    for tile in (1, 2, 3, 4):
        assert torch.equal(blocked_segmented_scan(v, start, tile), want)
