"""K8, the gang offer-slot count (``koordinator_tpu_torch/kernels/
offer_slots.py``), on the CPU: its plain version and the kernel's mirror
(``offer_slots_mirror``: the scan's cumulative rows and totals, then node
tiles walking the gangs, the validity ANDed over the members'
feasible rows, the member rows a stage at a time and the zero rows from
the totals alone) against the JAX package, bit for bit (int32: exact
equality, no tolerance).  In the explicit mode the reference is
``gang_offer_slots`` on each gang's front-packed matrix and node validity;
in the member mode it is ``gang_candidate_prep``'s node validity (the
state's ``node_valid`` and every member's feasible row) and then
``gang_offer_slots``.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` ``phase_offer_slots_edges`` holds it against the plain
version on the same edges).

The edges: thresholds off (no config, and a config with no threshold),
thresholds running past the members into the zero rows, a node that fits
nothing, the validity false, a negative request, P = 16 and P = 65,536,
the aggregated thresholds, a gang with no member row, several gangs in one
call, node chunks of the plain version down to one node; in the member
mode a member whose feasible row is all false, members with disjoint
feasible sets, the state's ``node_valid`` false on some nodes, a state
whose capacity exceeds its nodes, gangs longer than a scan step and than a
stage, and many gangs over several node tiles.  The kernel's slicing of
the gangs runs only on the card (``phase_offer_slots_edges``); here
``offer_grid`` sizes its slices.  The kernel's tiling constants are read
from its source.
"""

import os
import re

import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, MEM, R, port, set_torch_threads

set_torch_threads()

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "koordinator_tpu_torch", "kernels", "csrc", "offer_slots.cu")


def node_state(seed: int, n: int = 12, tight: bool = False,
               capacity: int | None = None, wide: bool = False,
               steep: bool = False):
    """A JAX ClusterState of ``n`` nodes (``capacity`` rows, the rest
    invalid padding): cpu 4,000-32,000 and memory 8,192-65,536 (``wide``:
    and 0-2,000 of every other dimension), usage and requests up to half of
    it; ``tight`` makes node 0 fit nothing (its requested over its
    allocatable) and node 1 a node at the cpu threshold's edge; ``steep``
    nodes 2 and 3 of 20,000,000 cpu, their threshold near 2^31."""
    from koordinator_tpu.state.cluster_state import ClusterState

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, R), np.int32)
    alloc[:, CPU] = rng.integers(4_000, 32_000, n)
    alloc[:, MEM] = rng.integers(8_192, 65_536, n)
    if wide:
        alloc[:, 2:] = rng.integers(0, 2_000, (n, R - 2))
    usage = (alloc * rng.random((n, R)) * 0.5).astype(np.int32)
    agg = (alloc * rng.random((n, R)) * 0.6).astype(np.int32)
    requested = (alloc * rng.random((n, R)) * 0.5).astype(np.int32)
    if tight:
        requested[0] = alloc[0] + 1
        alloc[1, CPU] = 10_000
        usage[1, CPU] = 6_300
    if steep:
        # nodes whose cpu threshold sits near 2^31: under a steep default
        # the zero rows' wrapping estimate can jump past it
        alloc[2:4, CPU] = 20_000_000
        usage[2:4, CPU] = (1_900_000, 0)
        requested[2:4, CPU] = 0
    return ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                    agg_usage=agg, capacity=capacity or n)


def gang_rows(seed: int, m: int, negative: bool = False):
    rng = np.random.default_rng(seed + 100)
    req = np.zeros((m, R), np.int32)
    req[:, CPU] = rng.integers(0, 3_000, m)
    req[:, MEM] = rng.integers(0, 4_096, m)
    req[rng.random(m) < 0.2, CPU] = 0        # the estimator's default
    if negative and m:
        req[rng.integers(0, m), CPU] = -2_000
        req[rng.integers(0, m), MEM] = -70_000
    return req


def configs(all_ten: bool = False, steep: bool = False):
    """(JAX config or None, label) of the threshold regimes; ``all_ten``
    adds a usage threshold on every dimension, ``steep`` cpu estimator
    defaults of 10,000,000 and 30,000,000 (a zero row's x100 estimate of
    10^9, and one that wraps negative)."""
    import jax.numpy as jnp

    from tests.torch_parity import config

    base = config("default")
    out = [(None, "no_config"),
           (base.replace(usage_thresholds=jnp.zeros(R, jnp.int32)),
            "thresholds_off"),
           (base, "instantaneous"), (config("agg"), "aggregated"),
           (base.replace(estimator_defaults=jnp.zeros(R, jnp.int32)),
            "zero_defaults")]
    if all_ten:
        out.append((base.replace(usage_thresholds=jnp.asarray(
            [65, 95, 40, 50, 60, 70, 80, 85, 90, 55], jnp.int32)), "all_ten"))
    if steep:
        for d in (10_000_000, 30_000_000):
            out.append((base.replace(estimator_defaults=jnp.zeros(
                R, jnp.int32).at[CPU].set(d).at[MEM].set(200)),
                f"default_{d}"))
    return out


def jax_slots(state, rows, p_rows, node_valid, cfg):
    import jax.numpy as jnp

    from koordinator_tpu.ops.network_topology import gang_offer_slots

    mat = np.zeros((p_rows, R), np.int32)
    mat[: len(rows)] = rows
    return np.asarray(gang_offer_slots(state, jnp.asarray(mat),
                                       jnp.asarray(node_valid), cfg))


def both(state, gangs, p_rows, valid, cfg):
    """(JAX (G, N), plain (G, N), mirror (G, N)) for ``gangs`` (a list of
    (M_g, R) member rows) in one call of each port function."""
    from koordinator_tpu_torch.kernels import offer_slots as k8

    want = np.stack([jax_slots(state, rows, p_rows, valid[g], cfg)
                     for g, rows in enumerate(gangs)])
    tstate = port(state, "ClusterState")
    tcfg = None if cfg is None else port(cfg, "ScoringConfig")
    reqs = torch.from_numpy(np.concatenate(gangs).astype(np.int32)
                            if gangs else np.zeros((0, R), np.int32))
    offsets = np.concatenate([[0], np.cumsum([len(g) for g in gangs])])
    tv = torch.from_numpy(np.asarray(valid))
    plain = k8.offer_slots(tstate, reqs, offsets.tolist(), p_rows, tv, tcfg)
    mirror = k8.offer_slots_mirror(tstate, reqs, offsets.tolist(), p_rows,
                                   tv, tcfg)
    return want, plain.numpy(), mirror.numpy()


def members_both(state, requests, feasible, masks, cfg):
    """(JAX (G, N), plain (G, N), mirror (G, N)) in the member mode: the
    JAX side is gang_candidate_prep's validity (the state's node_valid and
    every member's feasible row) and gang_offer_slots on the gang's
    front-packed (P, R) matrix; the port's one call of each function over
    the gangs' member CSR."""
    import jax.numpy as jnp

    from koordinator_tpu_torch.kernels import offer_slots as k8
    from koordinator_tpu_torch.ops.network_topology import member_csr

    p_rows = requests.shape[0]
    want = []
    for mask in masks:
        member_idx = np.flatnonzero(mask)
        valid = state.node_valid
        if member_idx.size:
            valid = valid & jnp.all(jnp.asarray(feasible)[member_idx],
                                    axis=0)
        want.append(jax_slots(state, requests[member_idx], p_rows,
                              np.asarray(valid), cfg))
    rows, offsets = member_csr(masks)
    tstate = port(state, "ClusterState")
    tcfg = None if cfg is None else port(cfg, "ScoringConfig")
    kw = dict(cfg=tcfg, rows=rows, feasible=torch.from_numpy(feasible))
    treq = torch.from_numpy(requests)
    plain = k8.offer_slots(tstate, treq, offsets, p_rows, **kw)
    mirror = k8.offer_slots_mirror(tstate, treq, offsets, p_rows, **kw)
    return np.stack(want), plain.numpy(), mirror.numpy()


@pytest.mark.parametrize("p_rows", [16, 64, 1_024])
@pytest.mark.parametrize("seed", range(2))
def test_regimes(seed, p_rows):
    state = node_state(seed, tight=True)
    rng = np.random.default_rng(seed)
    gangs = [gang_rows(seed + g, int(rng.integers(0, min(p_rows, 12) + 1)),
                       negative=(g == 2)) for g in range(4)]
    valid = rng.random((len(gangs), state.capacity)) < 0.85
    valid[:, 1] = True
    for cfg, label in configs():
        want, plain, mirror = both(state, gangs, p_rows, valid, cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        if cfg is not None and label == "instantaneous":
            # the zero rows' estimates carry some counts past the members
            sizes = np.array([len(g) for g in gangs])[:, None]
            assert ((want > sizes) & (want < p_rows)).any()


def edge_gangs():
    """(member rows of 4 gangs, their (4, 12) validity): a row that fails
    every node followed by a negative one that brings the sums back under
    the free capacity, a gang with no member row, one of all 16 rows."""
    req = gang_rows(7, 16, negative=True)
    req[3, CPU] = 40_000           # fails every node; the next row is -
    req[4, CPU] = -40_000          # negative, so the sums fit again
    valid = np.ones((4, 12), bool)
    valid[1, ::2] = False
    return [req[:6], req[:16], np.zeros((0, R), np.int32), req[6:16]], valid


def test_edges():
    """A node that fits nothing, node_valid false, a negative request
    walking back under the free capacity past a failed row, a gang with no
    member row, and a gang filling all P rows."""
    state = node_state(7, tight=True)
    gangs, valid = edge_gangs()
    for cfg, label in configs():
        want, plain, mirror = both(state, gangs, 16, valid, cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        assert (want[:, 0] == 0).all() and (want[1, ::2] == 0).all()


@pytest.mark.parametrize("p_rows", [16, 64])
def test_steep_defaults(p_rows):
    """test_edges' gangs under cpu estimator defaults whose zero rows'
    x100 estimate climbs by 10^9 a row past a threshold near 2^31 (walked
    row by row, the sums wrapping through it) or wraps negative; and a
    gang of a -20,000,000 cpu request, whose zero rows start more than
    2^31 below the threshold (walked row by row too)."""
    state = node_state(7, tight=True, steep=True)
    gangs, valid = edge_gangs()
    sink = np.zeros((1, R), np.int32)
    sink[0, CPU] = -20_000_000
    gangs.append(sink)
    valid = np.concatenate([valid, np.ones((1, valid.shape[1]), bool)])
    for cfg, label in configs(steep=True)[2:]:
        want, plain, mirror = both(state, gangs, p_rows, valid, cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        if label == "default_10000000":
            # the empty gang on nodes 2 and 3: the cpu estimate wraps past
            # the threshold on node 2 (6 rows), climbs onto it on node 3
            assert want[2, 2] == min(5, p_rows) and want[2, 3] == 1
        if label == "instantaneous":
            assert want[4, 2] == p_rows


def test_p_65536_and_chunks():
    """P = 65,536 (the flagship's batch rows) over a few nodes, the plain
    version at chunks of 1 and 3 nodes too."""
    from koordinator_tpu_torch.kernels import offer_slots as k8

    state = node_state(3, n=4)
    rows = gang_rows(3, 24)
    rows[8:] = 0                   # the first 8 fit some nodes
    valid = np.ones((1, 4), bool)
    for cfg, label in configs()[1:3]:
        want, plain, mirror = both(state, [rows], 65_536, valid, cfg)
        assert np.array_equal(want, plain) and np.array_equal(want, mirror), (
            label)
        tcfg = port(cfg, "ScoringConfig")
        for chunk in (1, 3):
            got = k8.offer_slots_plain(port(state, "ClusterState"),
                                       torch.from_numpy(rows), [0, 24],
                                       65_536, torch.from_numpy(valid), tcfg,
                                       chunk=chunk)
            assert np.array_equal(want, got.numpy()), (label, chunk)
        if label == "thresholds_off":
            # a node either stops among the members or takes all 65,536
            assert ((want < 24) | (want == 65_536)).all()
            assert (want == 65_536).any()


def member_problem(seed: int, n: int, p: int, sizes, pad: int = 0,
                   scale: int = 1, closed: float = 0.1, wide: bool = False):
    """(JAX state of ``n`` nodes in ``n + pad`` rows with a tenth of the
    real nodes' node_valid false, (P, R) requests divided by ``scale``,
    (P, N) feasible mask closed on a ``closed`` share of the pairs, member
    masks of ``sizes``); ``wide``: nodes with every dimension, and the
    second half of the rows requesting gpu and the batch and mid bands,
    so that some gangs have live dimensions past cpu and memory; the
    first gang's second member feasible nowhere (when it has two), the
    second gang's members on disjoint halves of the nodes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    state = node_state(seed, n=n, tight=True, capacity=n + pad, wide=wide)
    off = np.asarray(state.node_valid).copy()
    off[rng.choice(n, max(1, n // 10), replace=False)] = False
    state = state.replace(node_valid=jnp.asarray(off))
    requests = gang_rows(seed, p, negative=True) // scale
    if wide:
        half = slice(p // 2, p)
        requests[half, 3] = rng.integers(0, 300, p - p // 2)
        requests[half, 6:] = rng.integers(0, 400, (p - p // 2, R - 6))
    feasible = rng.random((p, n + pad)) >= closed
    order = rng.permutation(p)
    masks, at = [], 0
    for m in sizes:
        mask = np.zeros(p, bool)
        mask[order[at:at + m]] = True
        masks.append(mask)
        at += m
    if len(masks) > 0 and sizes[0] >= 2:
        feasible[np.flatnonzero(masks[0])[1]] = False
    if len(masks) > 1 and sizes[1] >= 2:
        first, second = np.flatnonzero(masks[1])[:2]
        feasible[first, (n + pad) // 2:] = False
        feasible[second, : (n + pad) // 2] = False
    return state, requests, feasible, masks


@pytest.mark.parametrize("case", ["edges", "long_gangs", "tiles", "wide"])
def test_member_mode(case):
    """The member mode against gang_candidate_prep's validity and
    gang_offer_slots: an all-false member, disjoint feasible sets, the
    state's node_valid off on some nodes, padded node rows, a gang with no
    member; gangs of 31-33, 63-65 and 130 members (past a scan step of 32
    rows and a stage of 64); many gangs over three node tiles (300 nodes,
    the last tile ragged); gangs with live dimensions past cpu
    and memory beside gangs of cpu and memory alone, on nodes of every
    dimension under a threshold on each."""
    if case == "wide":
        args = dict(seed=14, n=40, p=96, sizes=[3, 4, 5, 2, 6, 3, 1, 4],
                    wide=True)
    elif case == "edges":
        args = dict(seed=11, n=24, p=64, sizes=[4, 6, 0, 1, 9, 3], pad=8)
    elif case == "long_gangs":
        # requests small enough that many nodes fail past the first stage
        args = dict(seed=12, n=20, p=512, sizes=[31, 32, 33, 63, 64, 65,
                                                 130, 0], scale=40,
                    closed=0.0005)
    else:
        args = dict(seed=13, n=300, p=128, sizes=[3, 5, 2, 8, 1, 4, 6, 2, 7])
    state, requests, feasible, masks = member_problem(**args)
    for cfg, label in configs(all_ten=case == "wide"):
        want, plain, mirror = members_both(state, requests, feasible, masks,
                                           cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        if case == "edges":
            assert (want[0] == 0).all() and (want[1] == 0).all()
            assert (want[:, ~np.asarray(state.node_valid)] == 0).all()
            assert (want[2] > 0).any()
        if case == "long_gangs":
            assert ((want[6] > 64) & (want[6] < 130)).any(), label


def test_band_estimate_is_the_estimators():
    """The scan's band estimate (the kernel's arithmetic) equals
    scoring.estimate_pod_usage_by_band on both packages: band requests
    folded into cpu and memory, zero requests at the defaults, negative
    requests and products that wrap int32."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import scoring as jscoring

    from koordinator_tpu_torch.kernels import offer_slots as k8
    from koordinator_tpu_torch.ops import scoring
    from tests.torch_parity import config

    rng = np.random.default_rng(5)
    q = rng.integers(-5_000, 50_000, (256, R)).astype(np.int32)
    q[rng.random((256, R)) < 0.3] = 0
    q[:32, CPU] = rng.integers(2**29, 2**31 - 1, 32)
    q[32:64, 6] = rng.integers(2**30, 2**31 - 1, 32)
    for variant in ("default", "agg"):
        cfg = config(variant)
        tcfg = port(cfg, "ScoringConfig")
        got = k8.band_estimate(torch.from_numpy(q), tcfg.estimator_factors,
                               tcfg.estimator_defaults)
        want = jscoring.estimate_pod_usage_by_band(
            jnp.asarray(q), cfg.estimator_factors, cfg.estimator_defaults)
        assert np.array_equal(np.asarray(want), got.numpy())
        assert torch.equal(got, scoring.estimate_pod_usage_by_band(
            torch.from_numpy(q), tcfg.estimator_factors,
            tcfg.estimator_defaults))


def test_offer_scan_sums_each_gang_once():
    """The scan's cumulative rows restart at every gang, wrap int32, gather
    the member rows in the CSR's order; a gang's totals are its last row,
    zero with no member; row G is a zero request's estimate; a gang's live
    dimensions are those some member requests or estimates."""
    from koordinator_tpu_torch.kernels import offer_slots as k8
    from tests.torch_parity import config

    rng = np.random.default_rng(6)
    req = rng.integers(-1_000, 2**30, (40, R)).astype(np.int32)
    rows = np.array([5, 2, 9, 9, 30, 1, 7], np.int64)
    offs = np.array([0, 3, 3, 7], np.int64)
    tcfg = port(config("default"), "ScoringConfig")
    req[rows[:3], 2:] = 0
    cum, totals, live = k8.offer_scan(torch.from_numpy(req), offs, rows,
                                      tcfg)
    assert cum.shape == (7, 2 * R) and totals.shape == (4, 2 * R)
    est = k8.band_estimate(torch.from_numpy(req), tcfg.estimator_factors,
                           tcfg.estimator_defaults).numpy()
    zero = k8.band_estimate(torch.zeros((1, R), dtype=torch.int32),
                            tcfg.estimator_factors,
                            tcfg.estimator_defaults).numpy()[0]
    for g in range(3):
        members = rows[offs[g]:offs[g + 1]]
        seq = np.concatenate([req[members], est[members]], 1).astype(
            np.int64)
        want = (np.cumsum(seq, 0) + 2**31) % 2**32 - 2**31
        assert np.array_equal(cum[offs[g]:offs[g + 1]].numpy(), want)
        last = want[-1] if len(members) else np.zeros(2 * R)
        assert np.array_equal(totals[g].numpy(), last)
        bits = sum(1 << (r if r < R else k8.LIVE_EST + r - R)
                   for r in range(2 * R) if (seq[:, r] != 0).any())
        assert int(live[g]) == bits
    # the first gang requests cpu and memory alone; the empty one nothing
    assert int(live[0]) & 0xFFFC == 0 and int(live[1]) == 0
    assert (totals[3, :R] == 0).all()
    assert np.array_equal(totals[3, R:].numpy(), zero)


def test_offer_grid_fills_the_card_for_any_gang_count():
    """The walk's grid: tiles of 128 nodes by slices of the gangs, as many
    CTAs as the card holds at 16 gangs as at 128, every gang in one slice,
    and no limit on the gang count (no grid dimension holds the gangs)."""
    from koordinator_tpu_torch.kernels import offer_slots as k8

    resident = 132 * 6
    for g, n in ((16, 10_240), (128, 10_240), (78, 10_240), (1, 10_240),
                 (65_600, 1_024), (3, 100), (1_000_000, 1)):
        tiles, gps = k8.offer_grid(g, n, resident)
        slices = -(-g // gps)
        assert tiles == -(-n // k8.NODES_PER_CTA)
        assert gps >= 1 and (slices - 1) * gps < g <= slices * gps
        assert slices <= max(1, resident // tiles)
        if g >= resident // tiles:
            assert tiles * slices > resident // 2
    assert not hasattr(k8, "MAX_GANGS")
    assert "65535" not in open(SRC).read()


def test_kernel_constants_from_source():
    from koordinator_tpu_torch.kernels import offer_slots as k8

    src = open(SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kNodesPerCta") == k8.NODES_PER_CTA
    assert const("kRowsPerStage") == k8.ROWS_PER_STAGE
    assert const("kRowInts") == k8.ROW_INTS
    assert const("kLiveEst") == k8.LIVE_EST
    # a cumulative row holds the request's R sums, then the estimate's
    assert const("kEstAt") >= R and const("kEstAt") + R <= k8.ROW_INTS
    # the walk's threads: a node each, and the producer warp
    assert "kThreads = kNodesPerCta + 32" in src
    assert "koord_offer_slots" in src and "koord_offer_slots_resident" in src


def test_wrapper_takes_plain_version_on_cpu_only():
    """On CPU tensors the wrapper is the plain version and launches
    nothing, in both modes."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels import offer_slots as k8

    state = port(node_state(1), "ClusterState")
    before = build.LAUNCHES["offer_slots"]
    rows = torch.from_numpy(gang_rows(1, 5))
    valid = torch.ones((1, state.capacity), dtype=torch.bool)
    got = k8.offer_slots(state, rows, [0, 5], 32, valid)
    assert torch.equal(got, k8.offer_slots_plain(state, rows, [0, 5], 32,
                                                 valid))
    feasible = torch.ones((5, state.capacity), dtype=torch.bool)
    got = k8.offer_slots(state, rows, [0, 2, 5], 5, rows=[4, 0, 1, 2, 3],
                         feasible=feasible)
    assert torch.equal(got, k8.offer_slots_plain(
        state, rows, [0, 2, 5], 5, rows=[4, 0, 1, 2, 3], feasible=feasible))
    assert build.LAUNCHES["offer_slots"] == before
    # offsets the kernel could not read safely are refused on either path
    for offs, p_rows in (([0, 6], 32), ([0, 3, 2], 32), ([1, 5], 32),
                         ([0, 5], 4), ([0, 5, 5], 32)):
        with pytest.raises(ValueError, match="offsets"):
            k8.offer_slots(state, rows, offs, p_rows, valid)
    with pytest.raises(ValueError, match="offsets"):
        k8.offer_slots(state, rows, [0, 3], 5, rows=[0, 1], feasible=feasible)
    with pytest.raises(ValueError, match="member rows"):
        k8.offer_slots(state, rows, [0, 2], 5, rows=[0, 5],
                       feasible=feasible)
    with pytest.raises(ValueError, match="node_valid, or rows"):
        k8.offer_slots(state, rows, [0, 2], 5, valid, rows=[0, 1],
                       feasible=feasible)
