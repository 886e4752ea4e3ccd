"""Parity of the port's NUMA/cpuset ops (``koordinator_tpu_torch/ops/numa.py``
and ``ops/select.py``) with the JAX package's, bit for bit (every output is
int32 or bool: exact equality, no tolerance).

Seeded topologies (uniform SMT layouts and irregular ones whose core and
NUMA ids run past the capacity and MAX_NUMA, where JAX's segment sums drop
and its gathers clamp), reference counts, exclusivity bans and requests go
through both packages.  The traps: FullPCPUs rounding up to whole cores,
the O(C^2) sibling rank, an empty selection unless all k CPUs are taken,
and ``jnp.lexsort``'s stable last-key-first order with int32 keys at
-2^31 (whose negation wraps).
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import port, same, set_torch_threads

set_torch_threads()

BINDS = (0, 1, 2)          # default, FullPCPUs, SpreadByPCPUs
STRATEGIES = (0, 1)        # MostAllocated, LeastAllocated


def topologies(seed: int):
    """[(JAX CPUTopology, its port)]: uniform layouts and irregular ones."""
    from koordinator_tpu.ops.numa import CPUTopology

    rng = np.random.default_rng(seed)
    out = [
        CPUTopology.uniform(sockets=1, numa_per_socket=2, cores_per_numa=4),
        CPUTopology.uniform(sockets=2, numa_per_socket=2, cores_per_numa=2,
                            threads_per_core=2),
        CPUTopology.uniform(sockets=1, numa_per_socket=1, cores_per_numa=6,
                            threads_per_core=1, capacity=8),
    ]
    n = int(rng.integers(6, 15))
    core = np.sort(rng.integers(0, n, n))
    numa = (core * 3) // max(n, 1)
    out.append(CPUTopology.build(core, numa, numa // 2))
    # ids past the capacity and MAX_NUMA: JAX drops them from segment sums
    # and clamps its gathers
    core = rng.integers(0, 20, 10)
    numa = rng.integers(0, 11, 10)
    out.append(CPUTopology.build(core, numa, np.zeros(10, np.int32)))
    return [(t, port(t, "CPUTopology")) for t in out]


def ref_state(rng, cap: int, max_ref: int):
    rc = rng.integers(0, max_ref + 1, cap).astype(np.int32)
    rc[rng.random(cap) < 0.5] = 0
    banned = rng.random(cap) < 0.15
    return rc, banned


@pytest.mark.parametrize("seed", range(4))
def test_take_cpus(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import numa as jn

    from koordinator_tpu_torch.ops import numa as tn

    rng = np.random.default_rng(seed)
    for jt, tt in topologies(seed):
        cap = jt.capacity
        for max_ref in (1, 2):
            rc, banned = ref_state(rng, cap, max_ref)
            for bind in BINDS:
                for strategy in STRATEGIES:
                    n = int(rng.integers(0, cap + 2))
                    for ban in (None, banned):
                        js, jok = jn.take_cpus(
                            jt, jnp.asarray(rc), jnp.int32(max_ref),
                            jnp.int32(n), bind_policy=bind,
                            strategy=strategy,
                            banned=None if ban is None else jnp.asarray(ban))
                        ts, tok = tn.take_cpus(
                            tt, torch.from_numpy(rc), max_ref, n,
                            bind_policy=bind, strategy=strategy,
                            banned=(None if ban is None
                                    else torch.from_numpy(ban)))
                        assert same(js, ts) and same(jok, tok), (
                            seed, cap, max_ref, bind, strategy, n)


def test_take_cpus_traps():
    """FullPCPUs rounds an odd request up to whole cores; the selection is
    empty unless all k are taken; the sibling rank orders SpreadByPCPUs."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import numa as jn

    from koordinator_tpu_torch.ops import numa as tn

    jt = jn.CPUTopology.uniform(sockets=1, numa_per_socket=2, cores_per_numa=4)
    tt = port(jt, "CPUTopology")
    rc = np.zeros(jt.capacity, np.int32)
    rc[[1, 2, 5]] = 1           # three half-taken cores
    for bind, n in ((1, 3), (1, 5), (2, 6), (0, 13), (0, 14), (1, 12)):
        js, jok = jn.take_cpus(jt, jnp.asarray(rc), jnp.int32(1),
                               jnp.int32(n), bind_policy=bind)
        ts, tok = tn.take_cpus(tt, torch.from_numpy(rc), 1, n,
                               bind_policy=bind)
        assert same(js, ts) and same(jok, tok), (bind, n)
        if not bool(tok):
            assert not ts.any()
    # FullPCPUs: 3 cpus take two whole cores
    ts, tok = tn.take_cpus(tt, torch.zeros(16, dtype=torch.int32), 1, 3,
                           bind_policy=1)
    assert bool(tok) and int(ts.sum()) == 4


@pytest.mark.parametrize("full", [False, True], ids=["any", "full_pcpus"])
def test_cpuset_fit_and_batched(full):
    import jax.numpy as jnp

    from koordinator_tpu.ops import numa as jn

    from koordinator_tpu_torch.ops import numa as tn

    rng = np.random.default_rng(7)
    for jt, tt in topologies(3):
        cap = jt.capacity
        for n in range(0, cap + 2, 3):
            rc, banned = ref_state(rng, cap, 1)
            jf = jn.cpuset_fit(jt, jnp.asarray(rc), jnp.int32(1), jnp.int32(n),
                               full_pcpus=full, banned=jnp.asarray(banned))
            tf = tn.cpuset_fit(tt, torch.from_numpy(rc), 1, n,
                               full_pcpus=full,
                               banned=torch.from_numpy(banned))
            assert same(jf, tf), (cap, n)
    # batched over 6 nodes of one layout with per-node counts and max_ref
    jt, tt = topologies(0)[0]
    cap = jt.capacity
    rcs = rng.integers(0, 3, (6, cap)).astype(np.int32)
    mr = rng.integers(1, 3, 6).astype(np.int32)

    def tile(a, k):
        return np.broadcast_to(np.asarray(a), (k, cap)).copy()

    from koordinator_tpu.ops.numa import CPUTopology as JTopo

    jb = JTopo(*(jnp.asarray(tile(getattr(jt, f), 6)) for f in
                 ("core_of", "numa_of", "socket_of", "valid")))
    tb = tn.CPUTopology(*(torch.from_numpy(tile(getattr(jt, f), 6)) for f in
                          ("core_of", "numa_of", "socket_of", "valid")))
    for n in (1, 3, 5, 9):
        jf = jn.cpuset_fit_batched(jb, jnp.asarray(rcs), jnp.asarray(mr),
                                   jnp.int32(n), full_pcpus=full)
        tf = tn.cpuset_fit_batched(tb, torch.from_numpy(rcs),
                                   torch.from_numpy(mr), n, full_pcpus=full)
        assert same(jf, tf), n


@pytest.mark.parametrize("seed", range(3))
def test_hints_merge_and_score(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import numa as jn

    from koordinator_tpu_torch.ops import numa as tn

    rng = np.random.default_rng(seed)
    for _ in range(6):
        free = rng.integers(0, 9, jn.MAX_NUMA).astype(np.int32)
        free[rng.random(jn.MAX_NUMA) < 0.4] = 0
        total = free + rng.integers(0, 9, jn.MAX_NUMA).astype(np.int32)
        req = int(rng.integers(0, 20))
        jh = jn.numa_hints(jnp.asarray(free), jnp.int32(req))
        th = tn.numa_hints(torch.from_numpy(free), req)
        assert same(jh, th)
        assert same(jn.preferred_mask(jh), tn.preferred_mask(th))
        provider = rng.random((3, 1 << jn.MAX_NUMA)) < 0.6
        provider[0] = np.asarray(jh)
        for policy in range(4):
            ja, jm = jn.merge_hints(jnp.asarray(provider), policy=policy)
            ta, tm = tn.merge_hints(torch.from_numpy(provider), policy=policy)
            assert same(ja, ta) and same(jm, tm), policy
        for strategy in STRATEGIES:
            assert same(
                jn.numa_score(jnp.asarray(free), jnp.asarray(total),
                              jnp.int32(req), strategy=strategy),
                tn.numa_score(torch.from_numpy(free), torch.from_numpy(total),
                              req, strategy=strategy))
    # no feasible mask at all
    none = np.zeros(1 << jn.MAX_NUMA, bool)
    assert same(jn.preferred_mask(jnp.asarray(none)),
                tn.preferred_mask(torch.from_numpy(none)))


def test_take_by_rank_and_lexsort_int32_edges():
    """Keys at -2^31 and 2^31 - 1 (a negated -2^31 wraps to itself), bool
    keys and ties broken by the earlier keys, as jnp.lexsort orders them."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.select import take_by_rank as jtake

    from koordinator_tpu_torch.ops.select import lexsort, take_by_rank

    rng = np.random.default_rng(11)
    edge = np.array([-2**31, 2**31 - 1, 0, -1, 1], np.int64)
    for _ in range(8):
        c = int(rng.integers(4, 40))
        a = rng.choice(edge, c).astype(np.int32)
        b = rng.integers(-3, 3, c).astype(np.int32)
        flag = rng.random(c) < 0.5
        keys_np = (np.arange(c, dtype=np.int32), -a, b, ~flag)
        jorder = jnp.lexsort(tuple(jnp.asarray(k) for k in keys_np))
        torder = lexsort(tuple(torch.from_numpy(k) for k in keys_np))
        assert np.array_equal(np.asarray(jorder), torder.numpy())
        eligible = rng.random(c) < 0.7
        k = int(rng.integers(0, c + 2))
        js, jok = jtake(tuple(jnp.asarray(x) for x in keys_np),
                        jnp.asarray(eligible), jnp.int32(k))
        ts, tok = take_by_rank(tuple(torch.from_numpy(x) for x in keys_np),
                               torch.from_numpy(eligible), k)
        assert same(js, ts) and same(jok, tok)
