"""Parity of the port's network-topology gang planner (``koordinator_tpu_torch/
ops/network_topology.py``) with the JAX package's, bit for bit (every output
is int32 or bool: exact equality, no tolerance).

Seeded clusters on spine/block/node trees (snapshot rows in the tree's add
order, and a state whose capacity is larger than the tree's), seeded pod
batches (selector classes and a dense mask) and gangs go through both
packages: ``TopologyTree.build``, ``gang_offer_slots`` (K8's plain version
here), ``aggregate_tree``, ``constrain_multiples``, ``eligible_candidates``
from every must-gather layer, ``rank_candidates`` both ways (``jnp.lexsort``'s
last-key-first stable order, with ``~candidates`` and ``-scores`` keys),
``gang_candidate_prep`` and ``plan_gang_placement`` with and without a
config, layer multiples, node scores and existing peers;
``gang_offer_slots_many`` equals each gang's own prep.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, MEM, R, port, same, set_torch_threads

set_torch_threads()


def tree(spines=2, blocks=3, nodes=4, capacity=None):
    """(JAX TopologyTree, port TopologyTree, n nodes, JAX arrays, port
    arrays)."""
    from koordinator_tpu.ops.network_topology import TopologyTree as JT

    from koordinator_tpu_torch.ops.network_topology import TopologyTree as TT

    out = []
    for cls in (JT, TT):
        t = cls(["spine", "block", "node"])
        for s in range(spines):
            for b in range(blocks):
                for k in range(nodes):
                    t.add_node([f"s{s}", f"b{s}.{b}", f"n{s}.{b}.{k}"])
        out.append(t)
    n = spines * blocks * nodes
    jarr = out[0].build(capacity=capacity)
    tarr = out[1].build(capacity=capacity, device="cpu")
    return n, jarr, tarr


def cluster(seed: int, n: int, capacity: int | None = None, p: int = 48,
            dense: bool = False):
    """(JAX ClusterState, JAX PodBatch) over ``n`` nodes (capacity
    ``capacity``): cpu 8,000-32,000 a node, pods cpu 500-6,000."""
    from koordinator_tpu.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 32_000, n)
    alloc[:, MEM] = rng.integers(16_384, 131_072, n)
    usage = (alloc * rng.random((n, R)) * 0.5).astype(np.int32)
    requested = (alloc * rng.random((n, R)) * 0.4).astype(np.int32)
    node_class = rng.integers(0, 3, n).astype(np.int32)
    state = ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                     capacity=capacity or n,
                                     node_class=node_class)
    req = np.zeros((p, R), np.int32)
    req[:, CPU] = rng.integers(500, 6_000, p)
    req[:, MEM] = rng.integers(512, 8_192, p)
    req[rng.random(p) < 0.1, CPU] = 0
    cap = state.capacity
    if dense:
        kw = dict(feasible=rng.random((p, cap)) < 0.9)
    else:
        sel = rng.random((p, 4)) < 0.85
        kw = dict(selector_mask=sel, class_capacity=4)
    pods = PodBatch.build(req, node_capacity=cap, **kw)
    return state, pods


def requirements(rng, layers: int = 4):
    from koordinator_tpu.ops.network_topology import TopologyRequirements

    out = []
    for _ in range(5):
        mults = tuple(int(x) for x in rng.choice([1, 1, 2, 3], layers))
        out.append(TopologyRequirements(
            desired_slots=int(rng.choice([0, 3, 6, 10])),
            must_gather_layer=int(rng.integers(-1, layers)),
            layer_multiples=mults[: int(rng.integers(0, layers + 1))]))
    return out


def test_tree_build_carries():
    from tests.torch_parity import assert_same_fields

    for cap in (None, 40):
        _, jarr, tarr = tree(capacity=cap)
        assert_same_fields(jarr, tarr, "TopologyArrays")
        assert_same_fields(jarr, port(jarr, "TopologyArrays"),
                           "TopologyArrays")


@pytest.mark.parametrize("seed", range(3))
def test_tree_programs(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import network_topology as jnt

    from koordinator_tpu_torch.ops import network_topology as tnt

    rng = np.random.default_rng(seed)
    n, jarr, tarr = tree()
    for cap in (n, n + 8):   # a state padded larger than the tree
        slots = rng.integers(0, 5, cap).astype(np.int32)
        scores = rng.integers(0, 100, cap).astype(np.int32)
        existing = rng.integers(0, 3, cap).astype(np.int32)
        scores[rng.integers(0, cap)] = -2**31
        ja = jnt.aggregate_tree(jarr, jnp.asarray(slots), jnp.asarray(scores),
                                jnp.asarray(existing))
        ta = tnt.aggregate_tree(tarr, torch.from_numpy(slots),
                                torch.from_numpy(scores),
                                torch.from_numpy(existing))
        for a, b in zip(ja, ta):
            assert same(a, b)
        for mults in ((1, 1, 1, 1), (1, 2, 3, 2), (1, 1, 4, 1), (5, 1, 1, 3)):
            m = np.asarray(mults, np.int32)
            jc = jnt.constrain_multiples(jarr, ja[0], jnp.asarray(m))
            tc = tnt.constrain_multiples(tarr, ta[0], torch.from_numpy(m))
            assert same(jc, tc)
            for desired in (1, 4, 9, 30):
                for layer in (-1, 0, 1, 2, 3):
                    jok, jd = jnt.eligible_candidates(
                        jarr, jc, jnp.int32(desired), jnp.int32(layer))
                    tok, td = tnt.eligible_candidates(tarr, tc, desired,
                                                      layer)
                    assert same(jok, tok) and int(jd) == int(td)
                    for lower in (True, False):
                        jr = jnt.rank_candidates(jarr, jok, jc, ja[1], ja[2],
                                                 prefer_lower_slots=lower)
                        tr = tnt.rank_candidates(tarr, tok, tc, ta[1], ta[2],
                                                 prefer_lower_slots=lower)
                        assert np.array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize("cfg_name", [None, "default", "agg"])
@pytest.mark.parametrize("seed", range(2))
def test_offer_slots(seed, cfg_name):
    import jax.numpy as jnp

    from koordinator_tpu.ops import network_topology as jnt

    from koordinator_tpu_torch.ops import network_topology as tnt
    from tests.torch_parity import config

    rng = np.random.default_rng(seed)
    n, _, _ = tree()
    state, pods = cluster(seed, n)
    cfg = None if cfg_name is None else config(cfg_name)
    tcfg = None if cfg is None else port(cfg, "ScoringConfig")
    tstate = port(state, "ClusterState")
    for m in (0, 3, 12):
        req = np.array(pods.requests)
        req[m:] = 0
        valid = rng.random(state.capacity) < 0.8
        want = jnt.gang_offer_slots(state, jnp.asarray(req),
                                    jnp.asarray(valid), cfg)
        got = tnt.gang_offer_slots(tstate, torch.from_numpy(req),
                                   torch.from_numpy(valid), tcfg)
        assert same(want, got), m


@pytest.mark.parametrize("dense", [False, True], ids=["classes", "dense"])
@pytest.mark.parametrize("seed", range(3))
def test_prep_and_plan(seed, dense):
    import jax.numpy as jnp

    from koordinator_tpu.ops import network_topology as jnt

    from koordinator_tpu_torch.ops import network_topology as tnt
    from tests.torch_parity import config

    rng = np.random.default_rng(seed + 50)
    cap = 32 if seed == 2 else None     # the state padded past the tree
    n, jarr, tarr = tree(capacity=cap)
    state, pods = cluster(seed, n, capacity=cap, dense=dense)
    tstate, tpods = port(state, "ClusterState"), port(pods, "PodBatch")
    masks = []
    for _ in range(3):
        mask = np.zeros(pods.capacity, bool)
        mask[rng.choice(48, int(rng.integers(2, 14)), replace=False)] = True
        masks.append(mask)
    jcfg = config("default")
    tcfg = port(jcfg, "ScoringConfig")
    many = tnt.gang_offer_slots_many(tstate, tpods, masks, tcfg)
    for g, mask in enumerate(masks):
        for req in requirements(rng):
            for cfg, tc in ((None, None), (jcfg, tcfg)):
                scores = existing = None
                if rng.random() < 0.5:
                    scores = rng.integers(0, 100, state.capacity).astype(
                        np.int32)
                    existing = rng.integers(0, 2, state.capacity).astype(
                        np.int32)
                jkw = tkw = {}
                if scores is not None:
                    jkw = dict(node_scores=jnp.asarray(scores),
                               node_existing=jnp.asarray(existing))
                    tkw = dict(node_scores=torch.from_numpy(scores),
                               node_existing=torch.from_numpy(existing))
                jp = jnt.gang_candidate_prep(state, pods, mask, jarr, req,
                                             cfg=cfg, **jkw)
                tp = tnt.gang_candidate_prep(tstate, tpods, mask, tarr, req,
                                             cfg=tc, **tkw)
                assert np.array_equal(jp[0], tp[0]) and jp[1] == tp[1]
                for a, b in zip(jp[2:], tp[2:]):
                    assert same(a, b), req
                want = jnt.plan_gang_placement(state, pods, mask, jarr, req,
                                               cfg=cfg, **jkw)
                got = tnt.plan_gang_placement(tstate, tpods, mask, tarr, req,
                                              cfg=tc, **tkw)
                assert np.array_equal(want, got), req
        # the one-launch count of every gang equals each gang's own
        jp = jnt.gang_candidate_prep(state, pods, mask, jarr, requirements(
            rng)[0], cfg=jcfg)
        slots = jnt.gang_offer_slots(
            state,
            jnp.where(jnp.asarray(mask)[:, None], pods.requests, 0)[
                jnp.asarray(np.argsort(~mask, kind="stable"))],
            state.node_valid & jnp.all(pods.feasible_rows(state)[
                jnp.asarray(np.flatnonzero(mask))], axis=0), jcfg)
        assert same(slots, many[g])


def test_distribute_host_is_the_reference_walk():
    from koordinator_tpu.ops import network_topology as jnt

    from koordinator_tpu_torch.ops import network_topology as tnt

    rng = np.random.default_rng(9)
    n, jarr, _ = tree()
    parent = np.asarray(jarr.topo_parent)
    layer = np.asarray(jarr.topo_layer)
    t2n = np.asarray(jarr.topo_to_node)
    for _ in range(20):
        t = len(parent)
        slots = rng.integers(0, 6, t)
        scores = rng.integers(0, 50, t)
        existing = rng.integers(0, 2, t)
        mults = rng.choice([1, 2], 4)
        root = int(rng.integers(0, t))
        desired = int(rng.integers(1, 12))
        assert (jnt._distribute_host(parent, layer, t2n, slots, scores,
                                     existing, root, desired, mults)
                == tnt._distribute_host(parent, layer, t2n, slots, scores,
                                        existing, root, desired, mults))


@pytest.mark.parametrize("seed", range(3))
def test_member_csr_is_each_masks_rows(seed):
    """member_csr, the CSR K8 reads: gang k's rows the set rows of its
    mask in ascending order, its offsets their running count; empty masks
    among full ones, and no masks at all."""
    from koordinator_tpu_torch.ops import network_topology as tnt

    rng = np.random.default_rng(seed)
    p = 500
    masks = [rng.random(p) < rng.choice([0.0, 0.01, 0.3])
             for _ in range(25)]
    rows, offsets = tnt.member_csr(masks)
    assert offsets[0] == 0 and offsets.size == len(masks) + 1
    for k, mask in enumerate(masks):
        got = rows[offsets[k]:offsets[k + 1]]
        assert np.array_equal(got, [i for i in range(p) if mask[i]]), k
    assert offsets[-1] == rows.size == sum(int(m.sum()) for m in masks)
    empty = tnt.member_csr([])
    assert empty[0].size == 0 and np.array_equal(empty[1], [0])


@pytest.mark.parametrize("dense", [False, True], ids=["classes", "dense"])
def test_many_by_members_is_each_gangs_prep(dense):
    """gang_offer_slots_many over the scheduler's member masks, the node
    validity folded in the call, equals JAX's gang_candidate_prep validity and
    gang_offer_slots gang by gang: a member whose feasible row is all
    false, an empty gang and a state padded past the tree."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import network_topology as jnt

    from koordinator_tpu_torch.ops import network_topology as tnt
    from tests.torch_parity import config

    rng = np.random.default_rng(70)
    n, _, _ = tree()
    state, pods = cluster(3, n, capacity=32, dense=dense)
    tstate, tpods = port(state, "ClusterState"), port(pods, "PodBatch")
    gang_id = rng.integers(-1, 8, pods.capacity).astype(np.int32)
    gang_id[gang_id == 5] = -1      # an empty gang
    valid = np.asarray(pods.valid)
    gangs = [3, 0, 5, 7, 1]
    feasible = np.asarray(pods.feasible_rows(state)).copy()
    feasible[np.flatnonzero((gang_id == 7) & valid)[0]] = False
    jcfg = config("default")
    slots = tnt.gang_offer_slots_many(
        tstate, tpods, [(gang_id == g) & valid for g in gangs],
        port(jcfg, "ScoringConfig"), feasible=torch.from_numpy(feasible))
    for k, g in enumerate(gangs):
        mask = (gang_id == g) & valid
        members = np.flatnonzero(mask)
        node_valid = state.node_valid
        if members.size:
            node_valid = node_valid & jnp.all(
                jnp.asarray(feasible)[members], axis=0)
        want = jnt.gang_offer_slots(
            state,
            jnp.where(jnp.asarray(mask)[:, None], pods.requests, 0)[
                jnp.asarray(np.argsort(~mask, kind="stable"))],
            node_valid, jcfg)
        assert same(want, slots[k]), g
    assert (slots[3] == 0).all()
