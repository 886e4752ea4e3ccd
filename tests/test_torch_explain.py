"""Parity of the port's reject-reason accounting (``koordinator_tpu_torch/
ops/explain.py`` and K7's plain version, ``kernels/explain_counts.py``) with
``koordinator_tpu/ops/explain.py``: ``fit_first_fail``, ``explain_counts``
and ``decompose_scores`` must equal JAX's bit for bit.

The problems cover factored selector rows of 3 and 65 classes (one and two
selector words), a dense feasibility mask, the aggregated thresholds on and
off, invalid pod and node rows, requests of 0 against a negative free, and
the plain version's pod chunks, one of them not dividing the batch.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    CPU,
    GPU,
    MEM,
    R,
    config,
    port,
    problem,
    same,
    set_torch_threads,
)

set_torch_threads()


def with_classes(state, pods, seed: int, c: int):
    """The problem's state and batch with node classes over ``c`` selector
    columns (a few out of range) and a (P, c) selector mask."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 77)
    n, p = state.capacity, pods.capacity
    cls = rng.integers(0, c + 2, n).astype(np.int32)
    sel = rng.random((p, c)) < 0.6
    return (state.replace(node_class=jnp.asarray(cls)),
            pods.replace(selector_mask=jnp.asarray(sel), feasible=None))


def invalidate(state, pods, seed: int):
    """Some node rows and some pod rows made invalid."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 99)
    nv = np.asarray(state.node_valid) & (rng.random(state.capacity) > 0.2)
    pv = np.asarray(pods.valid) & (rng.random(pods.capacity) > 0.2)
    return (state.replace(node_valid=jnp.asarray(nv)),
            pods.replace(valid=jnp.asarray(pv)))


def zero_requests_on_negative_free(state, pods, seed: int):
    """Nodes whose requested exceeds allocatable on memory (free < 0) and
    pods that request no memory: a request of 0 fits a negative free."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 55)
    requested = np.array(state.node_requested)
    alloc = np.asarray(state.node_allocatable)
    over = rng.random(state.capacity) < 0.3
    requested[over, MEM] = alloc[over, MEM] + 1_000
    req = np.array(pods.requests)
    req[rng.random(pods.capacity) < 0.4, MEM] = 0
    req[rng.random(pods.capacity) < 0.1, GPU] = 0
    return (state.replace(node_requested=jnp.asarray(requested)),
            pods.replace(requests=jnp.asarray(req)))


CASES = {
    "factored": dict(mode="factored"),
    "out_of_range": dict(mode="out_of_range"),
    "c3": dict(mode="factored", classes=3),
    "c65": dict(mode="factored", classes=65),
    "dense": dict(mode="dense"),
    "agg": dict(mode="factored", cfg="agg"),
    "agg_dense": dict(mode="dense", cfg="agg"),
    "edge": dict(mode="edge"),
    "edge_agg": dict(mode="edge", cfg="agg"),
    "invalid_rows": dict(mode="factored", invalid=True),
    "invalid_tail": dict(mode="dense", invalid_tail=7),
    "zero_requests": dict(mode="factored", negative_free=True),
    "everything": dict(mode="factored", classes=65, cfg="everything",
                       invalid=True, negative_free=True),
}


def case_problem(name: str, seed: int):
    """(JAX state, JAX batch, JAX config) of one named case."""
    spec = CASES[name]
    state, pods = problem(seed, spec["mode"], n_nodes=48, n_pods=37,
                          invalid_tail=spec.get("invalid_tail", 0))
    if "classes" in spec:
        state, pods = with_classes(state, pods, seed, spec["classes"])
    if spec.get("invalid"):
        state, pods = invalidate(state, pods, seed)
    if spec.get("negative_free"):
        state, pods = zero_requests_on_negative_free(state, pods, seed)
    return state, pods, config(spec.get("cfg", "default"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_first_fail_equals_jax(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import explain as jex

    from koordinator_tpu_torch.ops import explain as tex

    rng = np.random.default_rng(seed)
    free = rng.integers(-500, 3_000, (24, R)).astype(np.int32)
    req = rng.integers(-100, 3_000, (9, R)).astype(np.int32)
    req[rng.random((9, R)) < 0.4] = 0
    want = np.asarray(jex.fit_first_fail(jnp.asarray(free), jnp.asarray(req)))
    got = tex.fit_first_fail(torch.from_numpy(free), torch.from_numpy(req))
    assert np.array_equal(want, got.numpy())
    assert (got.sum(-1) <= 1).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_counts_equals_jax(name):
    from koordinator_tpu.ops import explain as jex

    from koordinator_tpu_torch.kernels import explain_counts as k7
    from koordinator_tpu_torch.ops import explain as tex

    state, pods, cfg = case_problem(name, seed=sorted(CASES).index(name))
    want_c, want_f = jex.explain_counts(state, pods, cfg)
    ts, tp = port(state, "ClusterState"), port(pods, "PodBatch")
    tc = port(cfg, "ScoringConfig")
    got_c, got_f = tex.explain_counts(ts, tp, tc)
    assert same(want_c, got_c) and same(want_f, got_f)
    # every chunking gives the same bits: 5 does not divide the 64 rows
    for chunk in (1, 5, 64, 1_000):
        c, f = k7.explain_counts_plain(ts, tp, tc, chunk=chunk)
        assert same(want_c, c) and same(want_f, f), chunk
    # the partition: a valid pod's nodes are counted once each
    n = state.capacity
    valid = tp.valid.numpy()
    total = got_f.numpy() + got_c.numpy()[:, :tex.REASON_QUOTA].sum(1)
    assert (total[valid] == n).all() and (total[~valid] == 0).all()
    assert (got_c.numpy()[:, tex.REASON_QUOTA:] == 0).all()


def test_hand_built_fixture_every_reason_fires():
    """tests/test_explain.py's 3-pod x 4-node fixture, where every
    node-level reason fires, through the port."""
    from koordinator_tpu_torch.ops import explain as tex
    from koordinator_tpu_torch.ops.assignment import ScoringConfig
    from koordinator_tpu_torch.state.cluster_state import (
        ClusterState,
        PodBatch,
    )

    alloc = np.zeros((4, R), np.int32)
    alloc[:, CPU] = [10_000, 100, 10_000, 10_000]
    alloc[:, MEM] = [10_000, 10_000, 100, 10_000]
    usage = np.zeros((4, R), np.int32)
    usage[3, CPU] = 9_900
    state = ClusterState.from_arrays(alloc, usage=usage, capacity=4,
                                     device="cpu")
    reqs = np.zeros((3, R), np.int32)
    reqs[:, CPU] = 1_000
    reqs[:, MEM] = 1_000
    reqs[2, MEM] = 0
    feasible = np.ones((3, 4), bool)
    feasible[1, 0] = False
    batch = PodBatch.build(reqs, feasible=feasible, node_capacity=4,
                           capacity=4, device="cpu")
    counts, feas = tex.explain_counts(state, batch,
                                      ScoringConfig.default("cpu"))
    expected = {
        0: ({"fit_cpu": 1, "fit_memory": 1, "usage_threshold": 1}, 1),
        1: ({"fit_cpu": 1, "fit_memory": 1, "usage_threshold": 1,
             "affinity": 1}, 0),
        2: ({"fit_cpu": 1, "usage_threshold": 2}, 1),
    }
    for i, (reasons, n_feasible) in expected.items():
        got = {name: int(counts[i, j])
               for j, name in enumerate(tex.REASON_NAMES) if counts[i, j]}
        assert got == reasons, (i, got)
        assert int(feas[i]) == n_feasible
    assert int(counts[3].sum()) == 0 and int(feas[3]) == 0
    assert counts.dtype == torch.int32 and feas.dtype == torch.int32


@pytest.mark.parametrize("variant", ["default", "dominant", "most_allocated",
                                     "everything"])
def test_decompose_scores_equals_jax(variant):
    import jax.numpy as jnp

    from koordinator_tpu.ops import explain as jex

    from koordinator_tpu_torch.ops import explain as tex
    from koordinator_tpu_torch.ops.assignment import score_pods

    state, pods = problem(11, "factored", n_nodes=40, n_pods=21)
    cfg = config(variant)
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 40, (pods.capacity, 6)).astype(np.int32)
    want = jex.decompose_scores(state, pods, cfg, jnp.asarray(cand))
    ts, tp = port(state, "ClusterState"), port(pods, "PodBatch")
    tc = port(cfg, "ScoringConfig")
    got = tex.decompose_scores(ts, tp, tc, torch.from_numpy(cand))
    assert sorted(got) == sorted(want)
    for term in want:
        assert same(want[term], got[term]), term
    # the total is the composite score the solve ranks on
    scores, _ = score_pods(ts, tp, tc)
    assert torch.equal(got["total"],
                       torch.gather(scores, 1, torch.from_numpy(cand).long()))


# -- K7's launch plan (kernels/explain_counts.py explain_plan) ---------------

PLAN_PODS = [1, 31, 32, 33, 1_200, 17_941, 1 << 20]
PLAN_NODES = [1, 127, 128, 129, 10_240, 65_536]
PLAN_RESIDENT = [132, 264, 396, 528]


def kernel_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/explain_counts.cu`` that
    are integer arithmetic over its own earlier ones (those built on
    ``koord_score.cuh``'s are left out)."""
    import re
    from pathlib import Path

    from koordinator_tpu_torch.kernels import explain_counts as k7

    src = (Path(k7.__file__).parent / "csrc" / "explain_counts.cu").read_text()
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([\w\s+*/()-]+);",
                                 src):
        try:
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
        except NameError:
            pass
    return env


def test_plan_takes_the_kernels_block_and_tile():
    """explain_plan's pods a block and rows a tile are the kernel's."""
    from koordinator_tpu_torch.kernels import explain_counts as k7

    kc = kernel_constants()
    assert (k7.PODS_PER_CTA, k7.TILE) == (kc["kPodsPerCta"], kc["kTile"])


@pytest.mark.parametrize("n_nodes", PLAN_NODES)
@pytest.mark.parametrize("p_rows", PLAN_PODS)
def test_plan_covers_every_block_tile_once(p_rows, n_nodes):
    """K7's plan over 132-528 resident CTAs: the grid sized on the batch's
    power-of-two capacity, the work on the rows up to the last valid pod;
    every (32-pod block, 128-row tile) pair in exactly one CTA's range
    (pair w is block w // tiles, tile w % tiles), the ranges even within
    one pair, the grid no larger than the card holds at once."""
    from koordinator_tpu_torch.kernels import explain_counts as k7

    capacity = max(32, 1 << (p_rows - 1).bit_length())
    blocks, tiles = -(-p_rows // 32), -(-n_nodes // 128)
    for resident in PLAN_RESIDENT:
        grid = k7.explain_grid(capacity, n_nodes, resident)
        assert 1 <= grid <= resident
        assert grid == min(resident, -(-capacity // 32) * tiles)
        plan = k7.explain_plan(p_rows, n_nodes, grid)
        assert (plan["blocks"], plan["tiles"]) == (blocks, tiles)
        assert plan["work"] == blocks * tiles
        start, stop = plan["start"], plan["stop"]
        assert len(start) == grid
        seen = np.zeros(plan["work"], np.int8)
        for a, b in zip(start, stop):
            seen[a:b] += 1
        assert (seen == 1).all()
        # each pair decodes to one (block, tile) and back
        busy = stop > start
        w = np.concatenate([start[busy], stop[busy] - 1])
        blk, tile = np.divmod(w, tiles)
        assert (blk < blocks).all() and (blk * tiles + tile == w).all()
        sizes = stop - start
        assert sizes.max() - sizes.min() <= 1
        assert sizes.min() >= 1 or plan["work"] < grid


@pytest.mark.parametrize("n_nodes", [20_000, 65_536, 1 << 20])
def test_plan_flush_keeps_every_field_under_its_limit(n_nodes):
    """The kernel's flush rule (its kFlushTiles, kSteps and kFieldLimit)
    on a CTA's whole range (a grid of 1, every tile of every block): a
    flush at each block's change and after kFlushTiles tiles; a lane adds
    at most 1 to one 8-bit field a pod per step, kSteps steps a tile, so
    the steps between two flushes stay within the field, and the warp's
    sum of one field (32 lanes, even and odd bytes as 16-bit fields)
    under 2^16."""
    from koordinator_tpu_torch.kernels import explain_counts as k7

    kc = kernel_constants()
    steps, flush, limit = kc["kSteps"], kc["kFlushTiles"], kc["kFieldLimit"]
    assert steps == kc["kTile"] // 32 and limit < 256
    assert 32 * limit < 1 << 16
    plan = k7.explain_plan(65, n_nodes, 1)
    assert (plan["start"][0], plan["stop"][0]) == (0, plan["work"])
    since, most, blk = 0, 0, -1
    for w in range(plan["work"]):
        b = w // plan["tiles"]
        if b != blk or since == flush:
            since, blk = 0, b
        since += 1
        most = max(most, since)
    assert most * steps <= limit
