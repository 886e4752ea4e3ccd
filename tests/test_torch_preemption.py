"""Parity of the port's preemption ops (``koordinator_tpu_torch/ops/
preemption.py``) and of K5's decomposition (``kernels/preemption.py``
``preempt_chain_mirror``) with the JAX package's ``ops/preemption.py``.

Every case makes its inputs with numpy from a seed and feeds the same bits
to ``select_victims``, ``pick_node``, ``preempt_one`` (both quota paths:
no headroom with a Python-bool rule, and a headroom) and ``preempt_chain``
of both packages, and to the mirror of K5's per-node walk; every output is
int32 or bool and must be equal.  The sweeps cover PDB, quota and priority
mixes and the int32 edges: priorities at NEG_PRI and -2**31 (whose negation
wraps), per-node priority sums that wrap, headroom at +-2**30, a node with
more than 32 candidates (the PDB carry across K5a's chunks), and the
``N * B`` bound of the reference's PDB segment ids.  The hypothesis cases
mirror tests/test_preemption_properties.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.torch_parity import CPU, MEM, R, port, set_torch_threads

set_torch_threads()

INT32_MIN = -(2**31)
OPEN = 2**30
N_NODES = 12
V_CAP = 128


def problem(seed: int, *, n_nodes: int = N_NODES, n_bound: int = 90,
            n_pdbs: int = 3, n_quotas: int = 3, edges: bool = False,
            crowd: int = 0, v_cap: int = V_CAP):
    """Numpy arrays of one preemption problem: a cluster about 90% full of
    bound pods over ``n_nodes``, PDB and quota ids, a preemptor.
    ``edges`` puts priorities at NEG_PRI, -2**31 and near 2**30 (so a
    node's victim priorities sum past int32), and ``crowd`` bound pods on
    node 0 (more than one 32-row chunk of candidates)."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 32_000, n_nodes)
    alloc[:, MEM] = rng.integers(16_384, 65_536, n_nodes)
    v = n_bound + crowd
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = rng.integers(200, 3_000, v)
    req[:, MEM] = rng.integers(256, 4_096, v)
    req[rng.random(v) < 0.1, MEM] = 0
    node = rng.integers(0, n_nodes, v).astype(np.int32)
    node[n_bound:] = 0
    if crowd:
        req[n_bound:, CPU] = rng.integers(20, 200, crowd)
        alloc[0, CPU] = 31_000 + int(req[n_bound:, CPU].sum())
    node[rng.random(v) < 0.05] = -1              # unbound rows
    pri = rng.integers(1_000, 9_000, v).astype(np.int32)
    pri[rng.random(v) < 0.3] = rng.integers(1_000, 1_004)  # ties
    if edges:
        pick = rng.random(v)
        pri[pick < 0.1] = -(2**31) + 1
        pri[(pick >= 0.1) & (pick < 0.2)] = INT32_MIN
        pri[(pick >= 0.2) & (pick < 0.35)] = rng.integers(
            2**30, 2**30 + 2**29, int(((pick >= 0.2) & (pick < 0.35)).sum()))
    quota = rng.integers(-1, n_quotas, v).astype(np.int32)
    nonp = rng.random(v) < 0.1
    pdb = rng.integers(-1, n_pdbs, v).astype(np.int32) if n_pdbs else \
        np.full(v, -1, np.int32)
    requested = np.zeros((n_nodes, R), np.int64)
    np.add.at(requested, node[node >= 0], req[node >= 0])
    requested = np.minimum(requested, alloc).astype(np.int32)
    valid_node = np.ones(n_nodes, bool)
    valid_node[rng.random(n_nodes) < 0.1] = False
    pdb_allowed = (rng.integers(0, 4, max(n_pdbs, 1)).astype(np.int32))
    p_req = np.zeros(R, np.int32)
    p_req[CPU] = rng.integers(1_000, 12_000)
    p_req[MEM] = rng.integers(0, 16_384)
    p_pri = int(rng.integers(5_000, 10_000)) if not edges else int(
        rng.choice([2**31 - 1, 2**30 + 2**29, -(2**31) + 2]))
    p_quota = int(rng.integers(-1, n_quotas))
    feasible = rng.random(n_nodes) < 0.9
    hr = np.zeros(R, np.int32)
    hr[CPU] = rng.integers(-4_000, 8_000)
    hr[MEM] = rng.choice([-OPEN, OPEN, int(rng.integers(0, 20_000))])
    hr[2:] = rng.choice([-OPEN, OPEN, 0])
    return dict(alloc=alloc, requested=requested, valid_node=valid_node,
                req=req, node=node, pri=pri, quota=quota, nonp=nonp, pdb=pdb,
                pdb_allowed=pdb_allowed, p_req=p_req, p_pri=p_pri,
                p_quota=p_quota, feasible=feasible, hr=hr,
                v_cap=max(v_cap, 1 << (v - 1).bit_length()))


_JITTED = {}


def jitted(name: str):
    """The JAX package's preemption op ``name``, jitted once a process."""
    if name not in _JITTED:
        import jax

        from koordinator_tpu.ops import preemption as jp

        static = {"select_victims": ("same_quota_only",),
                  "preempt_one": ("same_quota_only", "nominate")}
        _JITTED[name] = jax.jit(getattr(jp, name),
                                static_argnames=static.get(name, ()))
    return _JITTED[name]


def jax_objects(pb):
    import jax.numpy as jnp

    from koordinator_tpu.ops.preemption import ScheduledPods
    from koordinator_tpu.state.cluster_state import ClusterState

    state = ClusterState.from_arrays(pb["alloc"], requested=pb["requested"],
                                     capacity=len(pb["alloc"]))
    state = state.replace(node_valid=jnp.asarray(pb["valid_node"]))
    sched = ScheduledPods.build(
        pb["req"], pb["node"], priority=pb["pri"], quota_id=pb["quota"],
        non_preemptible=pb["nonp"], pdb_id=pb["pdb"], capacity=pb["v_cap"])
    return state, sched


def port_objects(jstate, jsched):
    return port(jstate, "ClusterState"), port(jsched, "ScheduledPods")


def t(a, dtype=None):
    out = torch.from_numpy(np.asarray(a).copy())
    return out if dtype is None else out.to(dtype)


def same(a, b) -> bool:
    a = np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


SOLVE_FIELDS = ("eligible", "victim", "violating", "num_victims",
                "num_violating", "max_victim_pri", "sum_victim_pri")


def assert_solve(jsolve, tsolve, label):
    for f in SOLVE_FIELDS:
        assert same(getattr(jsolve, f), getattr(tsolve, f)), f"{label}: {f}"


def mirror_dry_run(tstate, tsched, pb, quota_mode, same_quota):
    """The mirror's dry run for one preemptor, as a VictimSolve-like dict."""
    from koordinator_tpu_torch.kernels import preemption as k5

    out = k5.preempt_chain_mirror(
        tstate, tsched, t(pb["p_req"][None]), t([pb["p_pri"]], torch.int32),
        t([pb["p_quota"]], torch.int32), t(pb["feasible"][None]),
        t([same_quota]), t([True]), t(pb["pdb_allowed"]), quota_mode,
        headroom=None if quota_mode == k5.NO_QUOTA else t(pb["hr"]),
        commit=False)
    v = tsched.capacity
    victim = np.zeros(v, bool)
    violating = np.zeros(v, bool)
    victim[out["rows"]] = out["flags"] & 1
    violating[out["rows"]] = (out["flags"] & 2) > 0
    rec = out["node_rec"]
    return dict(eligible=rec[0].astype(bool), victim=victim,
                violating=violating, num_victims=rec[4],
                num_violating=rec[1], max_victim_pri=rec[2],
                sum_victim_pri=rec[3])


def run_case(pb):
    """select_victims / pick_node / preempt_one of both packages and the
    mirror, over the three quota paths; returns nothing, asserts."""
    import jax.numpy as jnp

    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as tp

    jstate, jsched = jax_objects(pb)
    tstate, tsched = port_objects(jstate, jsched)
    jargs = (jnp.asarray(pb["p_req"]), jnp.int32(pb["p_pri"]),
             jnp.int32(pb["p_quota"]), jnp.asarray(pb["feasible"]),
             jnp.asarray(pb["pdb_allowed"]))
    targs = (t(pb["p_req"]), torch.tensor(pb["p_pri"], dtype=torch.int32),
             torch.tensor(pb["p_quota"], dtype=torch.int32),
             t(pb["feasible"]), t(pb["pdb_allowed"]))
    paths = [(None, False, k5.NO_QUOTA), (None, True, k5.NO_QUOTA),
             (pb["hr"], True, k5.HEADROOM), (pb["hr"], False, k5.HEADROOM)]
    for hr, sq, mode in paths:
        label = f"headroom={hr is not None} same_quota={sq}"
        jsolve = jitted("select_victims")(
            jstate, jsched, *jargs,
            quota_headroom=None if hr is None else jnp.asarray(hr),
            same_quota_only=sq)
        tsolve = tp.select_victims(
            tstate, tsched, *targs,
            quota_headroom=None if hr is None else t(hr),
            same_quota_only=sq)
        assert_solve(jsolve, tsolve, label)
        mirror = mirror_dry_run(tstate, tsched, pb, mode, sq)
        for f in SOLVE_FIELDS:
            assert same(getattr(jsolve, f), mirror[f]), f"mirror {label}: {f}"
        assert int(jitted("pick_node")(jsolve)) == int(
            tp.pick_node(tsolve)), label
        jout = jitted("preempt_one")(
            jstate, jsched, *jargs,
            quota_headroom=None if hr is None else jnp.asarray(hr),
            same_quota_only=sq)
        tout = tp.preempt_one(
            tstate, tsched, *targs,
            quota_headroom=None if hr is None else t(hr),
            same_quota_only=sq)
        assert int(jout.node) == int(tout.node), label
        assert same(jout.victims, tout.victims), label
        assert same(jout.state.node_requested, tout.state.node_requested)
        assert same(jout.sched.valid, tout.sched.valid), label
        assert same(jout.pdb_allowed, tout.pdb_allowed), label


CASES = [
    # (seed, options)
    (0, {}),
    (1, dict(n_pdbs=0)),
    (2, dict(n_quotas=1, n_pdbs=1)),
    (3, dict(edges=True)),
    (4, dict(edges=True, n_pdbs=6)),
    (5, dict(crowd=37)),
    (6, dict(crowd=70, n_pdbs=2, edges=True)),
    (7, dict(n_bound=120, n_nodes=6, n_pdbs=8)),
]


@pytest.mark.parametrize("seed,opts", CASES)
def test_select_pick_and_preempt_one_match_jax(seed, opts):
    run_case(problem(seed, **opts))


def test_node_with_110_candidates_carries_pdb_ranks_across_chunks():
    """One node holding 110 bound pods over two PDBs with budgets 40 and
    70: ranks cross K5a's 32-row chunks before a budget runs out."""
    pb = problem(11, n_bound=20, crowd=110, n_pdbs=2)
    pb["pdb"][20:] = np.arange(110) % 2
    pb["pdb_allowed"] = np.array([40, 70], np.int32)
    pb["pri"][20:] = 1_000 + np.arange(110) % 7
    pb["p_pri"] = 9_000
    pb["p_req"][CPU] = 30_000
    run_case(pb)


def test_all_ties_pick_the_lowest_row():
    """Identical nodes and victims: every key ties, the lowest row wins."""
    pb = problem(12, n_nodes=8, n_bound=32, n_pdbs=0)
    pb["alloc"][:] = pb["alloc"][0]
    pb["valid_node"][:] = True
    pb["node"][:32] = np.repeat(np.arange(8), 4)
    pb["req"][:] = pb["req"][0]
    pb["pri"][:] = 1_500
    pb["nonp"][:] = False
    pb["quota"][:] = -1
    requested = np.zeros_like(pb["requested"], dtype=np.int64)
    np.add.at(requested, pb["node"], pb["req"])
    pb["requested"] = np.minimum(requested, pb["alloc"]).astype(np.int32)
    pb["feasible"][:] = True
    pb["p_req"] = pb["req"][0] * 2
    run_case(pb)


def test_no_eligible_node_gives_minus_one():
    pb = problem(13)
    pb["p_pri"] = -(2**31) + 1      # nothing is below it but -2**31
    pb["pri"][pb["pri"] == INT32_MIN] = 0
    run_case(pb)


def test_pdb_segment_bound_raises_as_the_reference_does():
    import jax.numpy as jnp

    from koordinator_tpu.ops.preemption import _pdb_violating as jviol

    from koordinator_tpu_torch.ops.preemption import (
        _pdb_violating as tviol,
    )

    v = 8
    cand = np.ones(v, bool)
    order = np.arange(v)
    node = np.zeros(v, np.int32)
    pdb = np.zeros(v, np.int32)
    for n_cap, b, raises in ((65_536, 32_767, False),
                             (65_536, 32_768, True)):
        allowed = np.zeros(b, np.int32)
        if raises:
            with pytest.raises(OverflowError):
                jviol(jnp.asarray(cand), jnp.asarray(order),
                      jnp.asarray(node), jnp.asarray(pdb),
                      jnp.asarray(allowed), n_cap)
            with pytest.raises(OverflowError):
                tviol(t(cand), t(order), t(node), t(pdb), t(allowed), n_cap)
        else:
            assert same(jviol(jnp.asarray(cand), jnp.asarray(order),
                              jnp.asarray(node), jnp.asarray(pdb),
                              jnp.asarray(allowed), n_cap),
                        tviol(t(cand), t(order), t(node), t(pdb), t(allowed),
                              n_cap))


# -- the chain -------------------------------------------------------------------


def chain_problem(seed: int, c: int = 10, **opts):
    pb = problem(seed, **opts)
    rng = np.random.default_rng(seed + 500)
    n, q = len(pb["alloc"]), 3
    reqs = np.zeros((c, R), np.int32)
    reqs[:, CPU] = rng.integers(1_000, 9_000, c)
    reqs[:, MEM] = rng.integers(0, 8_192, c)
    pris = rng.integers(4_000, 10_000, c).astype(np.int32)
    qids = rng.integers(-1, q, c).astype(np.int32)
    same_q = (qids >= 0) & (rng.random(c) < 0.8)
    feas = rng.random((c, n)) < 0.85
    active = rng.random(c) < 0.85
    base_hr = rng.integers(-3_000, 15_000, (q, R)).astype(np.int32)
    base_hr[:, 2:] = rng.choice([OPEN, -OPEN, 0], (q, R - 2))
    # a later preemptor repeats an earlier one: it must see its nomination
    reqs[-1], pris[-1], qids[-1], same_q[-1] = reqs[0], pris[0], qids[0], \
        same_q[0]
    feas[-1] = feas[0]
    return pb, dict(reqs=reqs, pris=pris, qids=qids, feas=feas,
                    same_q=same_q, active=active, base_hr=base_hr)


def run_chain(pb, ch, grid: int = 3):
    import jax.numpy as jnp

    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as tp

    jstate, jsched = jax_objects(pb)
    tstate, tsched = port_objects(jstate, jsched)
    jout = jitted("preempt_chain")(
        jstate, jsched, jnp.asarray(ch["reqs"]), jnp.asarray(ch["pris"]),
        jnp.asarray(ch["qids"]), jnp.asarray(ch["feas"]),
        jnp.asarray(ch["same_q"]), jnp.asarray(ch["active"]),
        jnp.asarray(pb["pdb_allowed"]), jnp.asarray(ch["base_hr"]))
    targs = (t(ch["reqs"]), t(ch["pris"]), t(ch["qids"]), t(ch["feas"]),
             t(ch["same_q"]), t(ch["active"]), t(pb["pdb_allowed"]))
    tout = tp.preempt_chain(tstate, tsched, *targs, t(ch["base_hr"]))
    assert same(jout.node, tout.node)
    assert same(jout.victims, tout.victims)
    assert same(jout.state.node_requested, tout.state.node_requested)
    assert same(jout.sched.valid, tout.sched.valid)
    assert same(jout.pdb_allowed, tout.pdb_allowed)
    mirror = k5.preempt_chain_mirror(tstate, tsched, *targs, k5.CHAIN,
                                     headroom=t(ch["base_hr"]), grid=grid)
    assert np.array_equal(mirror["nodes"], np.asarray(jout.node))
    assert np.array_equal(mirror["victims"], np.asarray(jout.victims))
    assert np.array_equal(mirror["requested"],
                          np.asarray(jout.state.node_requested))
    assert np.array_equal(mirror["valid"], np.asarray(jout.sched.valid))
    assert np.array_equal(mirror["pdb"], np.asarray(jout.pdb_allowed))
    assert np.array_equal(mirror["assumed"], tout.assumed.numpy())
    return jout


@pytest.mark.parametrize("seed,opts", [
    (20, {}), (21, dict(edges=True)), (22, dict(crowd=40, n_pdbs=4)),
    (23, dict(n_quotas=3, n_pdbs=1, n_bound=110)),
])
def test_chain_matches_jax_and_the_mirror(seed, opts):
    pb, ch = chain_problem(seed, **opts)
    out = run_chain(pb, ch)
    assert (np.asarray(out.node) >= 0).any()


def test_chain_inactive_rows_leave_the_carry_untouched():
    pb, ch = chain_problem(24)
    ch["active"][:] = False
    ch["active"][3] = True
    out = run_chain(pb, ch)
    node = np.asarray(out.node)
    assert (node[np.arange(len(node)) != 3] == -1).all()


def test_chain_later_preemptor_sees_an_earlier_nomination():
    """Two identical preemptors in a row, each alone filling the cheapest
    node's room: the second must go elsewhere (or fail)."""
    pb, ch = chain_problem(25, c=2)
    ch["active"][:] = True
    ch["same_q"][:] = False
    ch["feas"][:] = True
    out = run_chain(pb, ch)
    node = np.asarray(out.node)
    if node[0] >= 0:
        assert node[1] != node[0] or not np.asarray(out.victims)[1].any()


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("seed,opts", [
    (26, {}), (27, dict(edges=True, crowd=40, n_pdbs=4)),
])
def test_chain_mirror_at_grid_sizes(seed, opts, grid):
    """K5's partial keys over 1, 3 and 132 CTAs (most CTAs own no node at
    12 nodes): the choice and every output are the reference's."""
    pb, ch = chain_problem(seed, **opts)
    run_chain(pb, ch, grid=grid)


def tiny_problem(alloc_cpu, pods, preemptors, pdb_allowed):
    """A hand-made chain: ``pods`` as (node, cpu, priority, pdb,
    non-preemptible) on nodes of ``alloc_cpu`` mcores (each node's
    accounting their sum), ``preemptors`` as (cpu, priority, feasible
    nodes); no quota anywhere."""
    n, v = len(alloc_cpu), len(pods)
    alloc = np.zeros((n, R), np.int32)
    alloc[:, CPU] = alloc_cpu
    alloc[:, MEM] = 65_536
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = [p[1] for p in pods]
    req[:, MEM] = 256
    node = np.array([p[0] for p in pods], np.int32)
    requested = np.zeros((n, R), np.int64)
    np.add.at(requested, node, req)
    pb = dict(alloc=alloc, requested=requested.astype(np.int32),
              valid_node=np.ones(n, bool), req=req, node=node,
              pri=np.array([p[2] for p in pods], np.int32),
              quota=np.full(v, -1, np.int32),
              nonp=np.array([p[4] for p in pods], bool),
              pdb=np.array([p[3] for p in pods], np.int32),
              pdb_allowed=np.array(pdb_allowed, np.int32),
              v_cap=max(8, 1 << (v - 1).bit_length()))
    c = len(preemptors)
    reqs = np.zeros((c, R), np.int32)
    reqs[:, CPU] = [p[0] for p in preemptors]
    feas = np.zeros((c, n), bool)
    for j, p in enumerate(preemptors):
        feas[j, list(p[2])] = True
    ch = dict(reqs=reqs, pris=np.array([p[1] for p in preemptors], np.int32),
              qids=np.full(c, -1, np.int32), feas=feas,
              same_q=np.zeros(c, bool), active=np.ones(c, bool),
              base_hr=np.full((1, R), OPEN, np.int32))
    return pb, ch


@pytest.mark.parametrize("grid", [1, 2])
def test_consecutive_preemptors_choose_the_same_node(grid):
    """Node 1 alone holds victims; two preemptors in a row both take it,
    the second against the first's evictions and nomination."""
    pods = [(0, 9_000, 9_500, -1, False), (2, 9_000, 1_000, -1, True)]
    pods += [(1, 2_500, 1_000 + k, -1, False) for k in range(4)]
    pb, ch = tiny_problem([10_000] * 3, pods,
                          [(4_000, 9_000, (0, 1, 2)),
                           (4_000, 9_000, (0, 1, 2))], [1])
    out = run_chain(pb, ch, grid=grid)
    assert np.asarray(out.node).tolist() == [1, 1]
    victims = np.asarray(out.victims)
    assert victims[0].any() and victims[1].any()
    assert not (victims[0] & victims[1]).any()


@pytest.mark.parametrize("first_active", [True, False])
def test_pdb_budget_spent_by_one_preemptor_flips_the_next_choice(
        first_active):
    """Preemptor 0 evicts the only pod it can, PDB 0's last budget; pod 1
    on node 1, of the same PDB, then becomes violating for preemptor 1,
    which takes node 2 (a higher victim priority, no violation) instead of
    node 1 — which it takes when preemptor 0 is inactive."""
    pods = [(0, 9_000, 1_000, 0, False), (1, 9_000, 1_000, 0, False),
            (2, 9_000, 2_000, -1, False)]
    pb, ch = tiny_problem([10_000] * 3, pods,
                          [(5_000, 9_000, (0,)), (5_000, 9_000, (1, 2))],
                          [1])
    ch["active"][0] = first_active
    out = run_chain(pb, ch, grid=2)
    assert np.asarray(out.node).tolist() == ([0, 2] if first_active
                                             else [-1, 1])


def test_csr_carried_across_two_chains_and_a_gang():
    """One PostFilter's calls: two chains, then a gang's two preempt_one
    calls (both quota paths), each on the carry of the one before; the
    port, the mirror (on the carried CSR) and JAX agree at every call, the
    CSR is built once and carried by every returned ScheduledPods, and it
    equals a fresh build on the last one."""
    import jax.numpy as jnp

    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as tp

    pb, ch = chain_problem(28, c=10, crowd=40, n_pdbs=4)
    jstate, jsched = jax_objects(pb)
    tstate, tsched = port_objects(jstate, jsched)
    jpdb, tpdb = jnp.asarray(pb["pdb_allowed"]), t(pb["pdb_allowed"])
    n = tstate.capacity
    built = k5.victim_csr(tsched, n)
    for lo, hi in ((0, 5), (5, 10)):
        cut = {k: ch[k][lo:hi] for k in ("reqs", "pris", "qids", "feas",
                                         "same_q", "active")}
        jout = jitted("preempt_chain")(
            jstate, jsched, *(jnp.asarray(cut[k]) for k in (
                "reqs", "pris", "qids", "feas", "same_q", "active")),
            jpdb, jnp.asarray(ch["base_hr"]))
        targs = [t(cut[k]) for k in ("reqs", "pris", "qids", "feas",
                                     "same_q", "active")] + [tpdb]
        tout = tp.preempt_chain(tstate, tsched, *targs, t(ch["base_hr"]))
        mirror = k5.preempt_chain_mirror(tstate, tsched, *targs, k5.CHAIN,
                                         headroom=t(ch["base_hr"]), grid=2)
        for got in (tout.node, mirror["nodes"]):
            assert same(jout.node, got)
        for got in (tout.victims, mirror["victims"]):
            assert same(jout.victims, got)
        for got in (tout.sched.valid, mirror["valid"]):
            assert same(jout.sched.valid, got)
        for got in (tout.pdb_allowed, mirror["pdb"]):
            assert same(jout.pdb_allowed, got)
        assert same(jout.state.node_requested, mirror["requested"])
        assert k5.victim_csr(tout.sched, n) is built
        jstate, jsched, jpdb = jout.state, jout.sched, jout.pdb_allowed
        tstate, tsched, tpdb = tout.state, tout.sched, tout.pdb_allowed
    for j, (hr, mode) in enumerate(((None, k5.NO_QUOTA),
                                    (ch["base_hr"][0], k5.HEADROOM))):
        sq = hr is not None
        jout = jitted("preempt_one")(
            jstate, jsched, jnp.asarray(ch["reqs"][j]),
            jnp.int32(ch["pris"][j]), jnp.int32(ch["qids"][j]),
            jnp.asarray(ch["feas"][j]), jpdb,
            quota_headroom=None if hr is None else jnp.asarray(hr),
            same_quota_only=sq)
        one = (t(ch["reqs"][j]), torch.tensor(ch["pris"][j]),
               torch.tensor(ch["qids"][j]), t(ch["feas"][j]), tpdb)
        tout = tp.preempt_one(tstate, tsched, *one,
                              quota_headroom=None if hr is None else t(hr),
                              same_quota_only=sq)
        mirror = k5.preempt_chain_mirror(
            tstate, tsched, one[0][None], one[1].reshape(1),
            one[2].reshape(1), one[3][None], torch.tensor([sq]),
            torch.tensor([True]), tpdb, mode,
            headroom=None if hr is None else t(hr), grid=2)
        assert int(jout.node) == int(tout.node) == int(mirror["nodes"][0])
        assert same(jout.victims, tout.victims)
        assert same(jout.victims, mirror["victims"][0])
        assert same(jout.sched.valid, mirror["valid"])
        assert same(jout.pdb_allowed, mirror["pdb"])
        assert same(jout.state.node_requested, mirror["requested"])
        assert k5.victim_csr(tout.sched, n) is built
        jstate, jsched, jpdb = jout.state, jout.sched, jout.pdb_allowed
        tstate, tsched, tpdb = tout.state, tout.sched, tout.pdb_allowed
    fresh = k5.VictimCSR(tsched, n)
    for f in ("offsets", "rows", "row_count", "pri", "quota", "pdb", "nonp",
              "req"):
        assert torch.equal(getattr(fresh, f), getattr(built, f)), f


# -- hypothesis: the shapes of tests/test_preemption_properties.py ---------------


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), pdbs=st.integers(0, 4),
       edges=st.booleans())
def test_random_problems_match_jax(seed, pdbs, edges):
    rng = np.random.default_rng(seed)
    pb = problem(seed, n_nodes=8, n_bound=int(rng.integers(4, 60)),
                 n_pdbs=pdbs, edges=edges, v_cap=64)
    run_case(pb)
