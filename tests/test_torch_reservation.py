"""Parity of the port's reservation ops (``koordinator_tpu_torch/ops/
reservation.py``) and of the reservation-aware plain scan
(``ops/assignment.py`` ``greedy_scan_plain``, K4r's plain version) with the
JAX package, exactly: every output is int32 or bool.

The op-level cases mirror tests/test_reservation.py one for one on the
same inputs; the seeded sweeps feed one numpy problem (aligned and
restricted rows, allocate-once, exhausted rows, unplaced and invalid rows,
zero-request dimensions, selector masks and dense masks, with and without
the quota tree) to ``reservation_greedy_assign`` of both packages.  K4r's
record layout (``kernels/greedy_scan.py`` ``reservation_records``) is held
here too; the kernel itself runs only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    CPU,
    MEM,
    R,
    config,
    port,
    problem,
    quota_trees,
    same,
    set_torch_threads,
    tight_quota,
    with_quota_ids,
)

set_torch_threads()


def vec(cpu=0, mem=0):
    v = np.zeros(R, np.int32)
    v[CPU], v[MEM] = cpu, mem
    return v


def mk_state(node_cpus, requested_cpus=None, mem=65_536):
    from koordinator_tpu.state.cluster_state import ClusterState

    alloc = np.zeros((len(node_cpus), R), np.int32)
    alloc[:, CPU] = node_cpus
    alloc[:, MEM] = mem
    req = None
    if requested_cpus is not None:
        req = np.zeros_like(alloc)
        req[:, CPU] = requested_cpus
    return ClusterState.from_arrays(alloc, requested=req)


def mk_pods(cpus, state, mem=1_024):
    from koordinator_tpu.state.cluster_state import PodBatch

    req = np.zeros((len(cpus), R), np.int32)
    req[:, CPU] = cpus
    req[:, MEM] = mem
    return PodBatch.build(req, node_capacity=state.capacity)


def quiet_cfg():
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig

    return ScoringConfig.default().replace(
        usage_thresholds=jnp.zeros(R, jnp.int32),
        estimator_defaults=jnp.zeros(R, jnp.int32),
    )


def rsv_set(reserved, node_idx, **kw):
    from koordinator_tpu.ops.reservation import ReservationSet

    return ReservationSet.build(np.asarray(reserved), np.asarray(node_idx),
                                **kw)


def one_reservation(node=0, cpu=4_000, mem=8_192, **kw):
    return rsv_set(np.stack([vec(cpu, mem)]), [node], **kw)


def both(*objs):
    """The port's twins of JAX objects (state, pods, config, reservation
    set), by their class names."""
    from koordinator_tpu_torch import convert

    out = []
    for o in objs:
        kind = type(o).__name__
        if kind == "ReservationSet":
            out.append(convert.reservation_set_from_numpy(
                convert.fields_of(o, kind), "cpu"))
        else:
            out.append(port(o, kind))
    return out


def match_of(pods, rsv, fill=True, at=None):
    m = np.full((pods.capacity, rsv.capacity), fill, bool)
    if at is not None:
        m[:] = False
        m[at] = True
    return m


def assert_score_parity(state, pods, cfg, rsv, match):
    from koordinator_tpu.ops.reservation import (
        score_pods_with_reservations as jscore,
    )

    from koordinator_tpu_torch.ops.reservation import (
        score_pods_with_reservations,
    )

    import jax.numpy as jnp

    want = jscore(state, pods, cfg, rsv, jnp.asarray(match))
    ts, tp, tc, tr = both(state, pods, cfg, rsv)
    got = score_pods_with_reservations(ts, tp, tc, tr,
                                       torch.from_numpy(match))
    for w, g in zip(want, got):
        assert same(w, g)
    return got


def assert_fit_parity(state, pods, rsv, match):
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import reservation_fit as jfit

    from koordinator_tpu_torch.ops.reservation import reservation_fit

    want = jfit(rsv, state.free, pods.requests, jnp.asarray(match))
    ts, tp, tr = both(state, pods, rsv)
    got = reservation_fit(tr, ts.free, tp.requests, torch.from_numpy(match))
    assert same(want, got)
    return got


def assert_scan_parity(state, pods, cfg, rsv, match, quota=None,
                       tquota=None):
    """reservation_greedy_assign of both packages on one problem: the
    assignments, the reservation choices, the node accounting, the
    reservation set and the quota state equal."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import (
        reservation_greedy_assign as jassign,
    )

    from koordinator_tpu_torch.ops.reservation import (
        reservation_greedy_assign,
    )

    from tests.torch_parity import assert_same_fields

    want = jassign(state, pods, cfg, rsv, jnp.asarray(match), quota)
    ts, tp, tc, tr = both(state, pods, cfg, rsv)
    got = reservation_greedy_assign(ts, tp, tc, tr, torch.from_numpy(match),
                                    tquota)
    assert same(want[0], got[0])
    assert same(want[1], got[1])
    assert_same_fields(want[2], got[2], "ClusterState")
    assert_same_fields(want[3], got[3], "ReservationSet")
    if quota is None:
        assert want[4] is None and got[4] is None
    else:
        assert_same_fields(want[4], got[4], "QuotaDeviceState")
    return got


# -- the op-level cases of tests/test_reservation.py -------------------------


def test_non_owner_cannot_use_reserved_capacity():
    state = mk_state([10_000], requested_cpus=[8_000])
    pods = mk_pods([4_000], state)
    rsv = one_reservation(node=0, cpu=8_000)
    _, feasible, _ = assert_score_parity(state, pods, quiet_cfg(), rsv,
                                         match_of(pods, rsv, False))
    assert not bool(feasible[0, 0])


def test_owner_fits_via_reservation_restore():
    state = mk_state([10_000], requested_cpus=[8_000])
    pods = mk_pods([4_000], state)
    rsv = one_reservation(node=0, cpu=8_000)
    _, feasible, fits = assert_score_parity(
        state, pods, quiet_cfg(), rsv, match_of(pods, rsv, at=(0, 0)))
    assert bool(feasible[0, 0]) and bool(fits[0, 0])


def test_aligned_spill_uses_node_free():
    state = mk_state([10_000], requested_cpus=[8_000])
    pods = mk_pods([4_000], state)
    rsv = one_reservation(node=0, cpu=3_000)
    fits = assert_fit_parity(state, pods, rsv, match_of(pods, rsv))
    assert bool(fits[0, 0])


def test_restricted_blocks_spill_on_reserved_dims():
    state = mk_state([10_000], requested_cpus=[8_000])
    rsv = one_reservation(node=0, cpu=3_000, restricted=np.array([True]))
    pods = mk_pods([4_000], state)
    assert not bool(assert_fit_parity(state, pods, rsv,
                                      match_of(pods, rsv))[0, 0])
    small = mk_pods([3_000], state)
    assert bool(assert_fit_parity(state, small, rsv,
                                  match_of(small, rsv))[0, 0])


def test_nominate_prefers_best_fit():
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import (
        nominate_reservation as jnominate,
    )

    from koordinator_tpu_torch.ops.reservation import nominate_reservation

    state = mk_state([20_000], requested_cpus=[11_000])
    rsv = rsv_set(np.stack([vec(8_000, 8_192), vec(3_000, 8_192)]), [0, 0])
    pods = mk_pods([2_000], state)
    match = match_of(pods, rsv)
    fits = assert_fit_parity(state, pods, rsv, match)
    want = jnominate(jnp.asarray(fits.numpy()), rsv,
                     jnp.zeros(pods.capacity, jnp.int32))
    (tr,) = both(rsv)
    got = nominate_reservation(fits, tr,
                               torch.zeros(pods.capacity, dtype=torch.int32))
    assert same(want, got) and int(got[0]) == 1


def test_nominate_sentinel_total_equals_the_reference():
    """A fitting row on the chosen node whose int32 remainder total is
    2**31 - 1 ties the reference's sentinel: argmin's first index wins,
    a row on another node; the port keeps that quirk."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import (
        nominate_reservation as jnominate,
    )

    from koordinator_tpu_torch.ops.reservation import nominate_reservation

    big = np.zeros(R, np.int32)
    big[CPU], big[MEM] = 2**31 - 1 - 5, 5
    rsv = rsv_set(np.stack([vec(1_000, 0), big]), [0, 1])
    fits = np.zeros((2, rsv.capacity), bool)
    fits[0, 1] = fits[1, 0] = fits[1, 1] = True
    node = np.array([1, 1], np.int32)
    want = jnominate(jnp.asarray(fits), rsv, jnp.asarray(node))
    (tr,) = both(rsv)
    got = nominate_reservation(torch.from_numpy(fits), tr,
                               torch.from_numpy(node))
    assert same(want, got) and got.tolist() == [0, 0]


def test_allocate_once_consumes_everything():
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import (
        allocate_from_reservation as jallocate,
    )

    from koordinator_tpu_torch.ops.reservation import (
        allocate_from_reservation,
    )

    from tests.torch_parity import assert_same_fields

    rsv = one_reservation(node=0, cpu=8_000, allocate_once=np.array([True]))
    want_rsv, want_spill = jallocate(rsv, jnp.int32(0),
                                     jnp.asarray(vec(2_000, 512)))
    (tr,) = both(rsv)
    got_rsv, got_spill = allocate_from_reservation(
        tr, 0, torch.from_numpy(vec(2_000, 512)))
    assert_same_fields(want_rsv, got_rsv, "ReservationSet")
    assert same(want_spill, got_spill)
    assert int(got_spill[CPU]) == 0 and int(got_rsv.remaining.sum()) == 0


@pytest.mark.parametrize("r_idx", [-1, 0, 1])
def test_allocate_from_reservation_rows(r_idx):
    """allocate_from_reservation on no row, an active row, and an
    unplaced allocate-once row (nothing to give, nothing consumed)."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import (
        allocate_from_reservation as jallocate,
    )

    from koordinator_tpu_torch.ops.reservation import (
        allocate_from_reservation,
    )

    from tests.torch_parity import assert_same_fields

    rsv = rsv_set(np.stack([vec(3_000, 2_048), vec(8_000, 512)]), [0, -1],
                  allocated=np.stack([vec(1_000, 0), vec(0, 0)]),
                  allocate_once=np.array([False, True]))
    req = vec(2_500, 1_024)
    want_rsv, want_spill = jallocate(rsv, jnp.int32(r_idx),
                                     jnp.asarray(req))
    (tr,) = both(rsv)
    got_rsv, got_spill = allocate_from_reservation(tr, r_idx,
                                                   torch.from_numpy(req))
    assert_same_fields(want_rsv, got_rsv, "ReservationSet")
    assert same(want_spill, got_spill)


def test_greedy_assign_charges_reservation_then_node():
    state = mk_state([10_000], requested_cpus=[6_000])
    pods = mk_pods([8_000], state, mem=1_024)
    rsv = one_reservation(node=0, cpu=6_000, mem=2_048)
    a, rc, new_state, new_rsv, _ = assert_scan_parity(
        state, pods, quiet_cfg(), rsv, match_of(pods, rsv))
    assert int(a[0]) == 0 and int(rc[0]) == 0
    assert int(new_state.node_requested[0, CPU]) == 6_000 + 2_000
    assert int(new_rsv.allocated[0, CPU]) == 6_000


def test_greedy_assign_prefers_reserved_node():
    state = mk_state([10_000, 10_000], requested_cpus=[0, 4_000])
    pods = mk_pods([2_000], state)
    rsv = one_reservation(node=1, cpu=4_000)
    a, rc, _, _, _ = assert_scan_parity(state, pods, quiet_cfg(), rsv,
                                        match_of(pods, rsv))
    assert int(a[0]) == 1 and int(rc[0]) == 0


def test_overloaded_node_stays_infeasible_even_for_owners():
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import ScoringConfig

    state = mk_state([10_000], requested_cpus=[8_000])
    state = state.replace(
        node_usage=state.node_usage.at[0, CPU].set(9_000),
        node_agg_usage=state.node_agg_usage.at[0, CPU].set(9_000),
    )
    pods = mk_pods([1_000], state)
    rsv = one_reservation(node=0, cpu=8_000)
    cfg = ScoringConfig.default().replace(
        estimator_defaults=jnp.zeros(R, jnp.int32))
    _, feasible, _ = assert_score_parity(state, pods, cfg, rsv,
                                         match_of(pods, rsv))
    assert not bool(feasible[0, 0])


def test_unrequested_dim_negative_free_does_not_block():
    from koordinator_tpu.state.cluster_state import PodBatch

    state = mk_state([10_000], requested_cpus=[8_000], mem=1_024)
    state = state.replace(
        node_requested=state.node_requested.at[0, MEM].set(2_048))
    req = np.zeros((1, R), np.int32)
    req[0, CPU] = 3_000
    pods = PodBatch.build(req, node_capacity=state.capacity)
    rsv = one_reservation(node=0, cpu=8_000, mem=0)
    assert bool(assert_fit_parity(state, pods, rsv,
                                  match_of(pods, rsv))[0, 0])


def test_exhausted_reservation_gets_no_boost():
    state = mk_state([10_000, 10_000], requested_cpus=[0, 4_000])
    pods = mk_pods([2_000, 2_000], state)
    rsv = one_reservation(node=1, cpu=4_000, allocate_once=np.array([True]))
    a, rc, _, _, _ = assert_scan_parity(state, pods, quiet_cfg(), rsv,
                                        match_of(pods, rsv))
    assert int(a[0]) == 1 and int(rc[0]) == 0
    assert int(a[1]) == 0 and int(rc[1]) == -1


def test_greedy_assign_with_no_reservation_equals_plain_scan():
    """An empty reservation set leaves the scan K4's: the same
    assignments and accounting as greedy_assign."""
    from koordinator_tpu.ops.reservation import ReservationSet

    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    state, pods = problem(5, n_nodes=24, n_pods=20)
    rsv = ReservationSet.zeros(16)
    cfg = config()
    a, rc, new_state, _, _ = assert_scan_parity(
        state, pods, cfg, rsv, match_of(pods, rsv))
    ts, tp, tc = both(state, pods, cfg)
    pa, pstate, _ = greedy_assign_plain(ts, tp, tc)
    assert torch.equal(a, pa) and bool((rc == -1).all())
    assert torch.equal(new_state.node_requested, pstate.node_requested)


def _cache_snapshot(ttl=None):
    """(JAX snapshot + cache, port snapshot + cache) over one 10-core node."""
    from koordinator_tpu.scheduler.reservations import (
        ReservationCache as JCache,
    )
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode

    from koordinator_tpu_torch.scheduler.reservations import ReservationCache
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
    )

    out = []
    for snap_cls, node_cls, cache_cls, kw in (
            (JSnap, JNode, JCache, {}),
            (ClusterSnapshot, NodeSpec, ReservationCache, {"device": "cpu"})):
        snap = snap_cls(**kw)
        snap.upsert_node(node_cls("n0", vec(10_000, 65_536)))
        snap.flush()
        out.append((snap, cache_cls()))
    return out


def _spec(pkg, name, requests, **kw):
    if pkg == "jax":
        from koordinator_tpu.scheduler.reservations import (
            OwnerMatcher,
            ReservationSpec,
        )
    else:
        from koordinator_tpu_torch.scheduler.reservations import (
            OwnerMatcher,
            ReservationSpec,
        )
    owners = [OwnerMatcher(labels=lbl) for lbl in kw.pop("owner_labels", [])]
    return ReservationSpec(name, requests, owners=owners, **kw)


def _pod(pkg, *args, **kw):
    if pkg == "jax":
        from koordinator_tpu.scheduler.snapshot import PodSpec
    else:
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec
    return PodSpec(*args, **kw)


def _same_spec(a, b):
    assert a.phase.value == b.phase.value and a.node == b.node
    assert a.owner_pods == b.owner_pods
    assert (a.allocated is None) == (b.allocated is None)
    if a.allocated is not None:
        assert np.array_equal(a.allocated, b.allocated)


def test_expire_after_node_deleted_does_not_crash():
    pairs = _cache_snapshot()
    for pkg, (snap, cache) in zip(("jax", "torch"), pairs):
        cache.upsert(_spec(pkg, "rsv-x", vec(4_000, 4_096), ttl_sec=10.0))
        cache.make_available("rsv-x", "n0", snap, now=0.0)
        snap.remove_node("n0")
        snap.flush()
        assert cache.expire_tick(now=11.0, snapshot=snap) == ["rsv-x"]
        assert cache.get("rsv-x").phase.value == "Expired"
    _same_spec(pairs[0][1].get("rsv-x"), pairs[1][1].get("rsv-x"))


def test_cache_lifecycle_and_expiration():
    pairs = _cache_snapshot()
    sets = []
    for pkg, (snap, cache) in zip(("jax", "torch"), pairs):
        cache.upsert(_spec(pkg, "rsv-a", vec(6_000, 8_192),
                           owner_labels=[{"app": "web"}], ttl_sec=60.0))
        cache.make_available("rsv-a", "n0", snap, now=100.0)
        assert int(np.asarray(snap.state.node_requested)[0, CPU]) == 6_000
        pod = _pod(pkg, "p0", vec(2_000, 512), labels={"app": "web"})
        dev, names = cache.build_set(snap)
        sets.append(dev)
        match = cache.match_matrix([pod], 1, dev.capacity)
        assert match[0, 0]
        stranger = _pod(pkg, "p1", vec(2_000, 512), labels={"app": "db"})
        assert not cache.match_matrix([stranger], 1, dev.capacity)[0, 0]
        drawn = cache.commit_allocations(names, [pod], np.array([0]),
                                         np.array([0]))
        assert cache.get("rsv-a").allocated[CPU] == 2_000
        assert int(drawn[0][CPU]) == 2_000
        assert cache.expire_tick(now=161.0, snapshot=snap) == ["rsv-a"]
        assert int(np.asarray(snap.state.node_requested)[0, CPU]) == 2_000
    from tests.torch_parity import assert_same_fields

    assert_same_fields(sets[0], sets[1], "ReservationSet")
    _same_spec(pairs[0][1].get("rsv-a"), pairs[1][1].get("rsv-a"))
    assert same(pairs[0][0].state.node_requested,
                pairs[1][0].state.node_requested)


def test_allocate_once_commit_marks_succeeded():
    pairs = _cache_snapshot()
    for pkg, (snap, cache) in zip(("jax", "torch"), pairs):
        cache.upsert(_spec(pkg, "rsv-b", vec(4_000, 4_096),
                           owner_labels=[{"job": "x"}], allocate_once=True))
        cache.make_available("rsv-b", "n0", snap, now=0.0)
        dev, names = cache.build_set(snap)
        pod = _pod(pkg, "p0", vec(1_000, 256), labels={"job": "x"})
        drawn = cache.commit_allocations(names, [pod], np.array([0]),
                                         np.array([0]))
        spec = cache.get("rsv-b")
        assert spec.phase.value == "Succeeded"
        np.testing.assert_array_equal(spec.allocated, spec.requests)
        np.testing.assert_array_equal(drawn[0], vec(4_000, 4_096))
    _same_spec(pairs[0][1].get("rsv-b"), pairs[1][1].get("rsv-b"))


def test_snapshot_reserve_and_release_equal_the_reference():
    """reserve, reserve_batch, unreserve and unreserve_instance move the
    same rows by the same amounts as the JAX snapshot's, and an instance
    release against a re-added node (or a gone one) is a no-op."""
    pairs = _cache_snapshot()
    for _, (snap, _cache) in zip(("jax", "torch"), pairs):
        node_cls = type(snap.node_specs["n0"])
        snap.upsert_node(node_cls("n1", vec(20_000, 65_536)))
        snap.flush()
        snap.reserve("n0", vec(1_500, 256))
        snap.reserve_batch({"n0": vec(250, 0), "n1": vec(4_000, 1_024)})
        snap.unreserve("n1", vec(1_000, 24))
        gen = snap.node_generation["n1"]
        snap.unreserve_instance("n1", vec(500, 0), gen)
        snap.remove_node("n1")
        snap.upsert_node(node_cls("n1", vec(20_000, 65_536)))
        snap.unreserve_instance("n1", vec(500, 0), gen)   # a fresh instance
        snap.unreserve_instance("gone", vec(500, 0), 0)
        assert snap.node_generation["n1"] == gen + 1
        snap.flush()
    (jsnap, _), (tsnap, _) = pairs
    assert same(jsnap.state.node_requested, tsnap.state.node_requested)
    assert jsnap.node_generation == tsnap.node_generation
    assert (sorted(jsnap.consume_candidate_dirty())
            == sorted(tsnap.consume_candidate_dirty()))


def test_match_matrix_equals_the_reference():
    """The owner-match matrix over mixed label selectors and controller
    owners, for pods with and without labels and owners."""
    rng = np.random.default_rng(3)
    mats = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from koordinator_tpu.scheduler.reservations import (
                OwnerMatcher,
                ReservationCache,
            )
        else:
            from koordinator_tpu_torch.scheduler.reservations import (
                OwnerMatcher,
                ReservationCache,
            )
        rng = np.random.default_rng(3)
        cache = ReservationCache()
        for v in range(20):
            owners = []
            for _ in range(int(rng.integers(0, 3))):
                labels = ({"app": f"a{int(rng.integers(0, 4))}"}
                          if rng.random() < 0.8 else {})
                if rng.random() < 0.3:
                    labels["tier"] = "x"
                ctl = (f"rs/{int(rng.integers(0, 3))}" if rng.random() < 0.3
                       else None)
                owners.append(OwnerMatcher(labels=labels, controller=ctl))
            spec = _spec(pkg, f"r{v}", vec(1_000, 1_000))
            spec.owners = owners
            cache.upsert(spec)
            spec.phase = type(spec.phase)("Available")
            spec.allocated = np.zeros(R, np.int32)
        pods = []
        for i in range(30):
            labels = {}
            if rng.random() < 0.8:
                labels["app"] = f"a{int(rng.integers(0, 4))}"
            if rng.random() < 0.3:
                labels["tier"] = "x"
            owner = f"rs/{int(rng.integers(0, 3))}" if rng.random() < 0.5 else None
            pods.append(_pod(pkg, f"p{i}", vec(10, 10), labels=labels,
                             owner=owner))
        mats.append(cache.match_matrix(pods, 32, 32))
    assert mats[0].dtype == mats[1].dtype
    assert np.array_equal(mats[0], mats[1]) and mats[0].any()


# -- seeded sweeps of the reservation-aware scan -----------------------------


def random_reservations(seed: int, state, n_rows: int, on_nodes=None):
    """A seeded JAX ReservationSet over ``state``'s nodes: aligned and
    restricted rows, allocate-once rows, exhausted rows (allocated =
    reserved), partly drawn rows, unplaced rows (node -1), reserved
    vectors with zero dims, and invalid padding past ``n_rows``."""
    rng = np.random.default_rng(seed + 500)
    n = state.capacity
    reserved = np.zeros((n_rows, R), np.int32)
    reserved[:, CPU] = rng.integers(500, 8_000, n_rows)
    reserved[:, MEM] = rng.integers(256, 16_384, n_rows)
    reserved[rng.random(n_rows) < 0.2, MEM] = 0
    reserved[rng.random(n_rows) < 0.15, 3] = 1_000
    allocated = (reserved * rng.random((n_rows, R)) * 0.6).astype(np.int32)
    allocated[rng.random(n_rows) < 0.2] = 0
    exhausted = rng.random(n_rows) < 0.15
    allocated[exhausted] = reserved[exhausted]
    nodes = (rng.integers(0, n, n_rows) if on_nodes is None
             else rng.choice(np.asarray(on_nodes), n_rows))
    nodes[rng.random(n_rows) < 0.1] = -1
    return rsv_set(reserved, nodes.astype(np.int32), allocated=allocated,
                   allocate_once=rng.random(n_rows) < 0.25,
                   restricted=rng.random(n_rows) < 0.3)


def random_match(seed: int, pods, rsv, density: float = 0.3):
    rng = np.random.default_rng(seed + 900)
    return rng.random((pods.capacity, rsv.capacity)) < density


SWEEPS = [
    # (seed, mode, scoring, rows, quota, on a few nodes)
    (0, "factored", "default", 12, False, False),
    (1, "factored", "default", 40, True, False),
    (2, "dense", "agg", 24, False, True),
    (3, "out_of_range", "everything", 30, True, True),
    (4, "factored", "most_allocated", 64, True, False),
    (5, "edge", "dominant", 20, False, False),
]


@pytest.mark.parametrize("seed,mode,variant,rows,with_quota,few", SWEEPS)
def test_reservation_scan_sweep(seed, mode, variant, rows, with_quota, few):
    state, pods = problem(seed, mode, n_nodes=32, n_pods=28)
    # crowd the nodes so reservations matter: half the free capacity gone
    state = state.replace(
        node_requested=(np.asarray(state.node_allocatable) * 0.6).astype(
            np.int32))
    rsv = random_reservations(seed, state, rows,
                              on_nodes=[1, 5, 6] if few else None)
    match = random_match(seed, pods, rsv)
    quota = tquota = None
    if with_quota:
        from koordinator_tpu.quota.admission import QuotaDeviceState

        jtree, _ = quota_trees(seed)
        quota, _ = QuotaDeviceState.from_tree(jtree)
        pods = with_quota_ids(pods, seed)
        tquota = port(quota, "QuotaDeviceState")
    a, rc, _, new_rsv, _ = assert_scan_parity(
        state, pods, config(variant), rsv, match, quota, tquota)
    placed = a >= 0
    assert bool(placed.any())
    # the sweep reaches the reservation branch: some pod drew from a row
    assert bool((rc >= 0).any()) or mode == "edge"


def test_reservation_records_layout():
    """K4r's records: the placed rows only, sorted by node with the rows
    of one node in row order, each record (reserved, allocated, node, row,
    flags), and the most rows on one CTA's node range."""
    from koordinator_tpu_torch.kernels.greedy_scan import (
        RSV_INTS,
        reservation_records,
    )

    state, _ = problem(7, n_nodes=32, n_pods=4)
    jrsv = random_reservations(7, state, 40, on_nodes=[0, 3, 3, 9, 31])
    (rsv,) = both(jrsv)
    # a row past the node range is inert as well
    rsv.node_idx[5] = 40
    nodes_per_cta = 4
    records, perm, vmax = reservation_records(rsv, 32, nodes_per_cta)
    node = rsv.node_idx.numpy()
    valid = rsv.valid.numpy()
    placed = np.flatnonzero(valid & (node >= 0) & (node < 32))
    want = placed[np.argsort(node[placed], kind="stable")]
    assert np.array_equal(perm.numpy(), want)
    assert records.shape == (len(want), RSV_INTS)
    rec = records.numpy()
    assert np.array_equal(rec[:, :R], rsv.reserved.numpy()[want])
    assert np.array_equal(rec[:, R:2 * R], rsv.allocated.numpy()[want])
    assert np.array_equal(rec[:, 2 * R], node[want])
    assert np.array_equal(rec[:, 2 * R + 1], want)
    flags = (rsv.allocate_once.numpy()[want].astype(int)
             + 2 * rsv.restricted.numpy()[want].astype(int))
    assert np.array_equal(rec[:, 2 * R + 2], flags)
    assert vmax == np.bincount(node[want] // nodes_per_cta).max()


# -- K4r's step, as the kernel orders it -------------------------------------

#: quota-tight sweeps of the step's model: (seed, mode, scoring, rows, on
#: a few nodes)
STEP_SWEEPS = [
    (20, "factored", "default", 24, False),
    (21, "dense", "agg", 40, True),
    (22, "out_of_range", "everything", 64, True),
    (23, "factored", "most_allocated", 48, False),
]


def _step_case(seed, mode, variant, rows, few):
    """A crowded problem with reservations, the owner match and the tight
    quota tree, as JAX objects and the port's."""
    state, pods = problem(seed, mode, n_nodes=32, n_pods=48)
    state = state.replace(
        node_requested=(np.asarray(state.node_allocatable) * 0.6).astype(
            np.int32))
    rsv = random_reservations(seed, state, rows,
                              on_nodes=[2, 9, 9, 30] if few else None)
    match = random_match(seed, pods, rsv, density=0.5)
    pods = with_quota_ids(pods, seed)
    # most pods under the parent's two leaves, whose headroom they share
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 3000)
    pods = pods.replace(quota_id=jnp.asarray(rng.choice(
        np.array([1, 2, 1, 2, 3, -1], np.int32), size=pods.capacity)))
    quota, tquota = tight_quota(seed)
    return state, pods, config(variant), rsv, match, quota, tquota


@pytest.mark.parametrize("seed,mode,variant,rows,few", STEP_SWEEPS)
def test_step_model_equals_plain_and_jax(seed, mode, variant, rows, few):
    """K4r's step as the kernel orders it (``greedy_scan_mirror``: each
    node's range of records, the fit folded into the node pass, the next
    pod found while the current one is scored and re-checked after its
    charge) gives ``greedy_scan_plain``'s and the JAX package's
    ``reservation_greedy_assign``'s assignments, reservation choices,
    node accounting, reservations and quota, on quota-tight sweeps."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_mirror
    from koordinator_tpu_torch.ops.assignment import greedy_scan_plain

    state, pods, cfg, rsv, match, quota, tquota = _step_case(
        seed, mode, variant, rows, few)
    want = assert_scan_parity(state, pods, cfg, rsv, match, quota, tquota)
    ts, tp, tc, tr = both(state, pods, cfg, rsv)
    m = torch.from_numpy(match)
    plain = greedy_scan_plain(ts, tp, tc, tquota, tr, m)
    trace = {}
    got = greedy_scan_mirror(ts, tp, tc, tquota, tr, m, trace=trace)
    for ref in (want, plain):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2].node_requested, ref[2].node_requested)
        assert torch.equal(got[3].allocated, ref[3].allocated)
        assert torch.equal(got[4].headroom, ref[4].headroom)
        assert torch.equal(got[4].min_headroom, ref[4].min_headroom)
    qid = tp.quota_id.numpy()
    assert (got[0].numpy()[qid >= 0] == -1).any()   # quota turned some away
    assert bool((got[1] >= 0).any())                # some drew a record
    assert trace["resumed"] >= 1                    # a re-check failed


@pytest.mark.parametrize("seed,mode,variant,rows,few", STEP_SWEEPS)
def test_quota_rejection_is_final_within_a_scan(seed, mode, variant, rows,
                                                few):
    """The premise of speculative admission: with requests that are not
    negative, no pod that the headroom rejects before a charge is admitted
    after it, at any point of the scan (every pod of the batch, under the
    headroom before the scan and after each charge)."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_mirror
    from koordinator_tpu_torch.quota.admission import quota_admission_mask

    state, pods, cfg, rsv, match, _, tquota = _step_case(
        seed, mode, variant, rows, few)
    ts, tp, tc, tr = both(state, pods, cfg, rsv)
    assert bool((tp.requests >= 0).all())
    trace = {}
    greedy_scan_mirror(ts, tp, tc, tquota, tr, torch.from_numpy(match),
                       trace=trace)
    assert len(trace["headroom"]) >= 3
    admitted = torch.stack([
        quota_admission_mask(tquota.replace(headroom=h, min_headroom=mh),
                             tp.requests, tp.quota_id, tp.non_preemptible)
        for h, mh in trace["headroom"]])
    assert bool((admitted[0] & ~admitted[-1]).any())  # the quota binds
    assert not bool((~admitted[:-1] & admitted[1:]).any())


# -- negative requests through K4r's step ------------------------------------


def _negative_case(seed, mode, variant, rows, few):
    """``_step_case`` with negative requests on a third of the pods (one
    or two dims each, as deep as the rows' reserved vectors) and records
    whose remainder starts above ``reserved`` (a negative ``allocated``)
    or below zero: a draw then raises a remainder where the scan runs."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.reservation import ReservationSet

    state, pods, cfg, rsv, match, quota, tquota = _step_case(
        seed, mode, variant, rows, few)
    rng = np.random.default_rng(seed + 4000)
    req = np.asarray(pods.requests).copy()
    neg = rng.random(req.shape[0]) < 0.35
    req[neg, CPU] = -rng.integers(1, 6_000, int(neg.sum()))
    two = neg & (rng.random(req.shape[0]) < 0.5)
    req[two, MEM] = -rng.integers(1, 20_000, int(two.sum()))
    pods = pods.replace(requests=jnp.asarray(req))
    alloc = np.asarray(rsv.allocated).copy()
    n_rows = alloc.shape[0]
    up = rng.random(n_rows) < 0.2
    alloc[up, CPU] = -rng.integers(1, 4_000, int(up.sum()))
    down = ~up & (rng.random(n_rows) < 0.1)
    alloc[down, MEM] = np.asarray(rsv.reserved)[down, MEM] + 100
    rsv = ReservationSet(
        valid=rsv.valid, node_idx=rsv.node_idx, reserved=rsv.reserved,
        allocated=jnp.asarray(alloc), allocate_once=rsv.allocate_once,
        restricted=rsv.restricted)
    return state, pods, cfg, rsv, match, quota, tquota


@pytest.mark.parametrize("seed,mode,variant,rows,few", STEP_SWEEPS[:3])
def test_step_model_takes_negative_requests(seed, mode, variant, rows, few):
    """K4r's step as the kernel orders it takes pods with negative requests
    and records whose remainder lies outside [0, reserved] exactly: the
    mirror, ``greedy_scan_plain`` and the JAX package's
    ``reservation_greedy_assign`` give the same assignments, reservation
    choices, node accounting, reservations and quota, and some negative
    pod draws from a record (its remainder rises past ``reserved``)."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_mirror
    from koordinator_tpu_torch.ops.assignment import greedy_scan_plain

    state, pods, cfg, rsv, match, quota, tquota = _negative_case(
        seed, mode, variant, rows, few)
    want = assert_scan_parity(state, pods, cfg, rsv, match, quota, tquota)
    ts, tp, tc, tr = both(state, pods, cfg, rsv)
    m = torch.from_numpy(match)
    plain = greedy_scan_plain(ts, tp, tc, tquota, tr, m)
    trace = {}
    got = greedy_scan_mirror(ts, tp, tc, tquota, tr, m, trace=trace)
    for ref in (want, plain):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2].node_requested, ref[2].node_requested)
        assert torch.equal(got[3].allocated, ref[3].allocated)
        assert torch.equal(got[4].headroom, ref[4].headroom)
        assert torch.equal(got[4].min_headroom, ref[4].min_headroom)
    neg = (tp.requests < 0).any(1) & tp.valid
    drew = got[1] >= 0
    assert bool((neg & drew).any())
    rows = got[1][neg & drew].long()
    before = tr.reserved[rows] - tr.allocated[rows]
    after = got[3].reserved[rows] - got[3].allocated[rows]
    assert bool((after > before).any())
    assert trace["rose"] >= 1


def test_step_model_raises_at_the_int32_max_sentinel():
    """The one case K4r does not take: every fitting record on the chosen
    node has a total remainder of exactly 2**31 - 1, where the reference's
    argmin lands on its own INT32_MAX sentinel and names row 0 of the set
    (here a row on another node).  The mirror raises, as the kernel's
    wrapper does."""
    from koordinator_tpu_torch.kernels.greedy_scan import (
        ReservationSentinelError,
        greedy_scan_mirror,
    )

    state = mk_state([16_000, 16_000], requested_cpus=[16_000, 15_000])
    pods = mk_pods([2_000], state, mem=0)
    big = np.zeros(R, np.int32)
    big[CPU], big[2] = 3_000, 2**31 - 1 - 3_000
    rsv = rsv_set(np.stack([vec(1_000, 0), big]), [0, 1])
    match = match_of(pods, rsv, at=(0, 1))
    got = assert_scan_parity(state, pods, quiet_cfg(), rsv, match)
    # the reference: the pod goes to node 1 through row 1, and draws from
    # row 0 on node 0
    assert int(got[0][0]) == 1 and int(got[1][0]) == 0
    ts, tp, tc, tr = both(state, pods, quiet_cfg(), rsv)
    with pytest.raises(ReservationSentinelError):
        greedy_scan_mirror(ts, tp, tc, None, tr, torch.from_numpy(match))
