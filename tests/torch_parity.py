"""Shared seeded problems and helpers of the port's parity suites (tests/test_torch_*.py).

Inputs are made with numpy from a seed, built into the JAX package's objects,
and carried into the port's objects through ``koordinator_tpu_torch.convert``
(numpy in between, CPU device), so both packages see the same bits.  JAX is
imported inside the functions, never at module scope.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

R = 10
CPU, MEM, GPU = 0, 1, 3
BATCH_CPU, BATCH_MEM, MID_CPU = 6, 7, 8


def port(obj, kind: str):
    """The port's twin of a JAX object, on the CPU."""
    from koordinator_tpu_torch import convert

    return convert.from_numpy(kind, convert.fields_of(obj, kind), "cpu")


def same(jax_value, torch_value) -> bool:
    """Exact equality of a JAX array and a torch tensor (shape and bits)."""
    a = np.asarray(jax_value)
    b = torch_value.cpu().numpy()
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def assert_same_fields(jax_obj, torch_obj, kind: str) -> None:
    from koordinator_tpu_torch import convert

    want = convert.fields_of(jax_obj, kind)
    got = convert.fields_of(torch_obj, kind)
    for name in convert.FIELDS[kind]:
        if want[name] is None or got[name] is None:
            assert want[name] is None and got[name] is None, name
            continue
        assert want[name].shape == got[name].shape, name
        assert np.array_equal(want[name], got[name]), (
            f"{kind}.{name} differs")


def failure_docs(result) -> dict:
    """A scheduling round's failures, each diagnosis as a dict of its
    fields (equal across the two packages field by field)."""
    return {name: dataclasses.asdict(diag)
            for name, diag in result.failures.items()}


def config(variant: str = "default"):
    """A JAX ScoringConfig variant."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig

    cfg = ScoringConfig.default()
    if variant == "default":
        return cfg
    if variant == "agg":
        return cfg.replace(agg_usage_thresholds=jnp.zeros(R, jnp.int32)
                           .at[CPU].set(55).at[MEM].set(80))
    if variant == "dominant":
        return cfg.replace(
            loadaware_dominant_weight=jnp.int32(2),
            loadaware_resource_weights=jnp.zeros(R, jnp.int32)
            .at[CPU].set(3).at[MEM].set(1).at[GPU].set(2),
            scarce_plugin_weight=jnp.int32(2))
    if variant == "most_allocated":
        return cfg.replace(
            fitplus_most_allocated=jnp.zeros(R, bool).at[CPU].set(True),
            fitplus_resource_weights=jnp.zeros(R, jnp.int32)
            .at[CPU].set(2).at[MEM].set(1).at[GPU].set(3),
            fitplus_plugin_weight=jnp.int32(3))
    if variant == "everything":
        return cfg.replace(
            agg_usage_thresholds=jnp.zeros(R, jnp.int32).at[MEM].set(70),
            loadaware_dominant_weight=jnp.int32(1),
            fitplus_most_allocated=jnp.zeros(R, bool).at[MEM].set(True),
            scarce_plugin_weight=jnp.int32(1),
            loadaware_plugin_weight=jnp.int32(2))
    raise ValueError(variant)


def problem(seed: int, mode: str = "factored", n_nodes: int = 48,
            n_pods: int = 40, invalid_tail: int = 0):
    """(JAX ClusterState, JAX PodBatch) of one seeded problem.

    ``mode``:
      - "factored": selector classes over 3 node classes (8 mask columns);
      - "out_of_range": factored, with some nodes in class ids past the
        mask's width (they must read as infeasible);
      - "dense": an explicit (P, N) feasibility mask;
      - "edge": every node at the usage-threshold rounding edge
        (round-half-up of 65.5% vs 65.4% instantaneous cpu usage, 55.5% vs
        55.4% aggregated), and batch/mid band requests on some pods.
    """
    import jax.numpy as jnp

    from koordinator_tpu.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 64_000, n_nodes)
    alloc[:, MEM] = rng.integers(16_384, 262_144, n_nodes)
    alloc[:, GPU] = rng.integers(0, 2, n_nodes) * 8_000
    usage = (alloc * rng.random((n_nodes, R)) * 0.6).astype(np.int32)
    agg = (alloc * rng.random((n_nodes, R)) * 0.7).astype(np.int32)
    requested = (alloc * rng.random((n_nodes, R)) * 0.5).astype(np.int32)
    node_class = rng.integers(0, 3, n_nodes).astype(np.int32)

    req = np.zeros((n_pods, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, n_pods)
    req[:, MEM] = rng.integers(128, 8_192, n_pods)
    req[rng.random(n_pods) < 0.2, GPU] = 1_000
    req[rng.random(n_pods) < 0.1, CPU] = 0      # estimator default path

    if mode == "edge":
        # cpu usage% = round(100 * (usage + est) / 1000) crosses 65 -> 66 at
        # usage + est = 655; est of a 100 mcore request is 85
        alloc[:, CPU] = 1_000
        usage[:, CPU] = rng.integers(565, 575, n_nodes)
        # the aggregated policy's edge (55%, see config("agg")) at 555
        agg[:, CPU] = rng.integers(465, 475, n_nodes)
        requested[:, CPU] = rng.integers(0, 400, n_nodes)
        req[:, CPU] = 100
        band = rng.random(n_pods) < 0.3
        req[band, BATCH_CPU] = req[band, CPU]
        req[band, CPU] = 0
        req[band, BATCH_MEM] = 512
        req[rng.random(n_pods) < 0.2, MID_CPU] = 50
    if mode == "out_of_range":
        node_class[rng.random(n_nodes) < 0.25] = 9
    if invalid_tail:
        alloc[-invalid_tail:] = 0

    state = ClusterState.from_arrays(
        alloc, requested=requested, usage=usage, agg_usage=agg,
        capacity=n_nodes, node_class=node_class)
    if invalid_tail:
        valid = np.ones(n_nodes, bool)
        valid[-invalid_tail:] = False
        state = state.replace(node_valid=jnp.asarray(valid))

    kw = {}
    if mode == "dense":
        kw = dict(feasible=rng.random((n_pods, n_nodes)) < 0.8)
    else:
        sel = rng.random((n_pods, 8)) < 0.7
        sel[:, :3] |= rng.random((n_pods, 3)) < 0.5
        kw = dict(selector_mask=sel, class_capacity=8)
    cap = 1 << (n_pods - 1).bit_length()
    pods = PodBatch.build(
        req, priority=rng.integers(3_000, 9_999, n_pods).astype(np.int32),
        node_capacity=n_nodes, capacity=cap, **kw)
    return state, pods


def quota_trees(seed: int = 0, loose: bool = False):
    """(JAX QuotaTree, port QuotaTree) of the same small hierarchy:
    root -> parent -> {qa, qb}, plus a standalone qc; cpu/memory checked."""
    from koordinator_tpu.quota.tree import QuotaTree as JTree

    from koordinator_tpu_torch.quota.tree import QuotaTree as TTree

    rng = np.random.default_rng(seed)
    scale = 8 if loose else 1
    trees = []
    for cls in (JTree, TTree):
        total = np.full(R, 10**7, np.int64)
        t = cls(total)
        mx = np.full(R, -1, np.int64)
        mx[CPU], mx[MEM] = 120_000 * scale, 400_000 * scale
        t.add("parent", np.zeros(R, np.int64), mx)
        child = np.full(R, -1, np.int64)
        child[CPU] = 70_000 * scale
        mn = np.zeros(R, np.int64)
        mn[CPU] = 20_000
        t.add("qa", mn, child, parent="parent")
        t.add("qb", np.zeros(R, np.int64), child, parent="parent")
        solo = np.full(R, -1, np.int64)
        solo[MEM] = 150_000 * scale
        t.add("qc", np.zeros(R, np.int64), solo)
        trees.append(t)
    for name in ("qa", "qb", "qc"):
        req = np.zeros(R, np.int64)
        req[CPU] = int(rng.integers(50_000, 150_000)) * scale
        req[MEM] = int(rng.integers(100_000, 500_000)) * scale
        for t in trees:
            t.set_request(name, req)
    for t in trees:
        t.refresh_runtime()
    return trees[0], trees[1]


def tight_quota(seed: int):
    """(JAX QuotaDeviceState, port twin) of :func:`quota_trees`' hierarchy
    with the checked headroom of the parent and the leaves cut to a few
    pods' worth (requests run 100-4,000 mcores and 128-8,192 MiB) and
    qa's min headroom to one or two, so consecutive pods of one leaf often
    find room for one of them only."""
    import jax.numpy as jnp

    from koordinator_tpu.quota.admission import QuotaDeviceState

    jtree, _ = quota_trees(seed)
    quota, _ = QuotaDeviceState.from_tree(jtree)
    rng = np.random.default_rng(seed + 2000)
    head = np.array(quota.headroom)
    head[0, CPU] = rng.integers(5_000, 12_000)
    head[1:3, CPU] = rng.integers(1_500, 7_000, 2)
    head[3, MEM] = rng.integers(6_000, 20_000)      # qc checks memory
    min_head = np.array(quota.min_headroom)
    min_head[1, CPU] = rng.integers(1_000, 5_000)
    quota = quota.replace(headroom=jnp.asarray(head),
                          min_headroom=jnp.asarray(min_head))
    return quota, port(quota, "QuotaDeviceState")


def with_quota_ids(pods, seed: int):
    """The JAX PodBatch with quota ids over {qa, qb, qc, none} (rows of the
    sorted quota index: parent=0, qa=1, qb=2, qc=3) and some
    non-preemptible pods."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 1000)
    p = pods.capacity
    qid = rng.choice(np.array([1, 2, 3, -1], np.int32), size=p)
    non_pre = rng.random(p) < 0.2
    return pods.replace(quota_id=jnp.asarray(qid),
                        non_preemptible=jnp.asarray(non_pre))


def set_torch_threads() -> None:
    """The suites run under several workers: keep torch's pool small."""
    torch.set_num_threads(2)
