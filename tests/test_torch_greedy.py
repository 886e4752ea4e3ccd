"""Parity of the port's exact greedy scan (``ops/assignment.py``
``greedy_assign``, the K4 kernel's wrapper) with the JAX package.

On CPU tensors the wrapper takes its plain version, a Python loop over pods;
these cases hold it against the JAX ``greedy_assign`` (``_greedy_scan``
without reservations) on assignments, node accounting and every quota field,
with tolerance 0.  chip_smoke.py holds the kernel against the plain version
on the card.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    CPU,
    MEM,
    R,
    assert_same_fields,
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

GREEDY_CASES = [
    # (seed, mode, variant, with_quota, n_nodes, n_pods)
    (0, "factored", "default", True, 24, 48),
    (1, "out_of_range", "dominant", True, 24, 48),
    (2, "dense", "default", True, 24, 40),
    (3, "edge", "agg", False, 16, 48),
    (4, "factored", "most_allocated", False, 24, 48),
    (5, "edge", "everything", True, 16, 64),
]


def _run_both(js, jp, jcfg, with_quota: bool, seed: int):
    from koordinator_tpu.ops.assignment import greedy_assign as jax_greedy
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops.assignment import greedy_assign

    jquota = tquota = None
    if with_quota:
        jtree, _ = quota_trees(seed)
        jquota, _ = JQ.from_tree(jtree)
        jp = with_quota_ids(jp, seed)
        tquota = port(jquota, "QuotaDeviceState")
    want = jax_greedy(js, jp, jcfg, jquota)
    got = greedy_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                        port(jcfg, "ScoringConfig"), tquota)
    assert same(want[0], got[0])
    assert_same_fields(want[1], got[1], "ClusterState")
    if with_quota:
        assert_same_fields(want[2], got[2], "QuotaDeviceState")
    else:
        assert got[2] is None
    return np.asarray(want[0]), jp


@pytest.mark.parametrize("seed,mode,variant,with_quota,n_nodes,n_pods",
                         GREEDY_CASES)
def test_greedy_assign_matches_jax(seed, mode, variant, with_quota, n_nodes,
                                   n_pods):
    """Selector classes (in range and past the mask width), dense masks,
    the threshold rounding edge, aggregated thresholds, and a quota tree
    whose chains and non-preemptible min headroom reject some pods."""
    js, jp = problem(seed, mode, n_nodes=n_nodes, n_pods=n_pods,
                     invalid_tail=2)
    a, _ = _run_both(js, jp, config(variant), with_quota, seed)
    assert (a >= 0).sum() > 0


def test_greedy_assign_with_infeasible_and_quota_blocked_pods():
    """Rows no node can take (requests past every node), rows a tight
    quota rejects, non-preemptible rows against the min headroom, and
    padded invalid rows all assign -1 and charge nothing."""
    import jax.numpy as jnp

    js, jp = problem(11, "factored", n_nodes=16, n_pods=40)
    req = np.asarray(jp.requests).copy()
    req[::5, CPU] = 10**6                   # fits no node
    jp = jp.replace(requests=jnp.asarray(req))
    a, jp = _run_both(js, jp, config("default"), True, 11)
    assert (a[::5][: 40 // 5] == -1).all()
    assert (a[40:] == -1).all()             # padded rows
    qid = np.asarray(jp.quota_id)[:40]
    assert (a[:40][qid >= 0] == -1).any()   # quota admission rejects some


def test_greedy_assign_all_rows_infeasible():
    import jax.numpy as jnp

    js, jp = problem(12, "factored", n_nodes=16, n_pods=24)
    req = np.zeros((jp.capacity, R), np.int32)
    req[:, CPU] = 10**6
    jp = jp.replace(requests=jnp.asarray(req))
    a, _ = _run_both(js, jp, config("agg"), True, 12)
    assert (a == -1).all()


def test_greedy_assign_on_cpu_launches_no_kernel():
    """The wrapper takes the plain version for CPU tensors: no launch is
    counted."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.ops.assignment import greedy_assign

    js, jp = problem(13, "factored", n_nodes=16, n_pods=16)
    build.reset_launch_counts()
    a, _, q = greedy_assign(port(js, "ClusterState"), port(jp, "PodBatch"),
                            port(config("default"), "ScoringConfig"))
    assert q is None and int((a >= 0).sum()) > 0
    assert build.LAUNCHES["greedy_scan"] == 0


def test_greedy_kernel_wrapper_refuses_mixed_devices():
    """A wrapper never falls back: tensors on different devices raise
    before anything runs."""
    from koordinator_tpu_torch.kernels import build

    with pytest.raises(ValueError, match="several devices"):
        build.on_cpu(torch.zeros(2), torch.zeros(2, device="meta"))


def _unplaced_kinds(jp, jquota, assignments: np.ndarray):
    """Replay the scan's quota admission on the host: (rows quota admission
    rejected at their turn, admitted rows no node took)."""
    valid = np.asarray(jp.valid)
    prio = np.asarray(jp.priority)
    order = np.lexsort((np.arange(jp.capacity), -prio))
    req = np.asarray(jp.requests).astype(np.int64)
    qid = np.asarray(jp.quota_id)
    non_pre = np.asarray(jp.non_preemptible)
    head = np.asarray(jquota.headroom).astype(np.int64)
    min_head = np.asarray(jquota.min_headroom).astype(np.int64)
    checked = np.asarray(jquota.checked)
    chain = np.asarray(jquota.chain)
    qvalid = np.asarray(jquota.valid)
    rejected, no_node = [], []
    for i in order:
        if not valid[i]:
            continue
        q = int(qid[i])
        anc = chain[q][chain[q] >= 0] if q >= 0 else []
        if q >= 0:
            need = checked[q] & (req[i] != 0)
            ok = bool(qvalid[q]) and not np.any(need & (req[i] > head[anc]))
            if non_pre[i]:
                ok = ok and not np.any(need & (req[i] > min_head[q]))
            if not ok:
                rejected.append(i)
                continue
        if assignments[i] < 0:
            no_node.append(i)
        elif q >= 0 and qvalid[q]:
            head[anc] -= req[i]
            if non_pre[i]:
                min_head[q] -= req[i]
    return rejected, no_node


@pytest.mark.parametrize("seed,mode", [(21, "factored"), (22, "dense"),
                                       (23, "out_of_range")])
def test_greedy_scan_skips_unplaced_pods_exactly(seed, mode):
    """The premise of the scan kernel's warp-at-a-time skip: a pod the scan
    leaves unassigned (quota admission rejects it at its turn, or no node
    takes it) changes no carried state.  Dropping every such pod (valid =
    False) and scanning again gives the same assignments, the same
    node_requested and the same quota state, in the JAX scan and in the
    port's plain version."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import greedy_assign as jax_greedy
    from koordinator_tpu.quota.admission import QuotaDeviceState as JQ

    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    js, jp = problem(seed, mode, n_nodes=20, n_pods=60)
    req = np.asarray(jp.requests).copy()
    req[1::7, CPU] = 10**6                  # fits no node
    jp = jp.replace(requests=jnp.asarray(req))
    jtree, _ = quota_trees(seed)
    jquota, _ = JQ.from_tree(jtree)
    jp = with_quota_ids(jp, seed)
    cfg = config("default")
    want = jax_greedy(js, jp, cfg, jquota)
    a = np.asarray(want[0])
    rejected, no_node = _unplaced_kinds(jp, jquota, a)
    assert rejected and no_node, "both kinds of unplaced pod occur"
    keep = np.asarray(jp.valid).copy()
    keep[rejected + no_node] = False
    jp_kept = jp.replace(valid=jnp.asarray(keep))
    again = jax_greedy(js, jp_kept, cfg, jquota)
    assert np.array_equal(np.asarray(again[0]), a)
    for field in ("node_requested",):
        assert np.array_equal(np.asarray(getattr(again[1], field)),
                              np.asarray(getattr(want[1], field)))
    for field in ("headroom", "min_headroom"):
        assert np.array_equal(np.asarray(getattr(again[2], field)),
                              np.asarray(getattr(want[2], field)))
    tquota = port(jquota, "QuotaDeviceState")
    args = (port(js, "ClusterState"), port(jp, "PodBatch"),
            port(cfg, "ScoringConfig"))
    full = greedy_assign_plain(*args, tquota)
    kept = greedy_assign_plain(args[0], port(jp_kept, "PodBatch"), args[2],
                               tquota)
    assert same(want[0], full[0]) and same(want[0], kept[0])
    assert torch.equal(full[1].node_requested, kept[1].node_requested)
    assert_same_fields(want[2], kept[2], "QuotaDeviceState")
    assert_same_fields(want[2], full[2], "QuotaDeviceState")


# -- K4's step, as the kernel orders it --------------------------------------

#: quota-tight sweeps of the step's model: (seed, mode, scoring, what may
#: raise a headroom: nothing, pods requesting a negative amount, or the
#: parent's memory headroom wrapping past int32's minimum)
STEP_CASES = [
    (40, "factored", "default", "none"),
    (41, "dense", "dominant", "none"),
    (47, "factored", "agg", "none"),
    (43, "factored", "most_allocated", "negative"),
    (44, "dense", "everything", "negative"),
    (46, "factored", "default", "wrap"),
]


@pytest.mark.parametrize("seed,mode,variant,rise", STEP_CASES)
def test_step_model_equals_plain_and_jax(seed, mode, variant, rise):
    """K4's step as the kernel orders it (``greedy_scan_mirror``: the next
    pod found while the current one is scored and re-checked after its
    charge, and searched again after a charge that raised a headroom)
    gives ``greedy_assign_plain``'s and the JAX package's
    ``greedy_assign``'s assignments, node accounting and quota on
    quota-tight sweeps, most pods under one parent.  A headroom rises
    under a negative request, and when qa's pods charge the parent's
    memory headroom (left at -2**31 + 1,000) past int32's minimum: qb's
    pods, which check memory, are rejected until that wrap and admitted
    after it."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import greedy_assign as jax_greedy

    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_mirror
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    js, jp = problem(seed, mode, n_nodes=48, n_pods=64, invalid_tail=2)
    jp = with_quota_ids(jp, seed)
    rng = np.random.default_rng(seed + 3000)
    qid = rng.choice(np.array([1, 2, 1, 2, 3, -1], np.int32),
                     size=jp.capacity)
    req = np.asarray(jp.requests).copy()
    if rise == "negative":
        req[rng.integers(0, 60, 3), CPU] = -1_500
    jp = jp.replace(quota_id=jnp.asarray(qid), requests=jnp.asarray(req))
    jquota, tquota = tight_quota(seed)
    if rise == "wrap":
        head = np.array(jquota.headroom)
        head[0, MEM] = -(2**31) + 1_000
        checked = np.array(jquota.checked)
        checked[2, MEM] = True
        jquota = jquota.replace(headroom=jnp.asarray(head),
                                checked=jnp.asarray(checked))
        tquota = port(jquota, "QuotaDeviceState")
    jcfg = config(variant)
    want = jax_greedy(js, jp, jcfg, jquota)
    ts, tp, tc = (port(js, "ClusterState"), port(jp, "PodBatch"),
                  port(jcfg, "ScoringConfig"))
    plain = greedy_assign_plain(ts, tp, tc, tquota)
    trace = {}
    got = greedy_scan_mirror(ts, tp, tc, tquota, trace=trace)
    assert same(want[0], got[0]) and torch.equal(got[0], plain[0])
    assert_same_fields(want[1], got[2], "ClusterState")
    assert_same_fields(want[2], got[4], "QuotaDeviceState")
    assert torch.equal(got[4].headroom, plain[2].headroom)
    a = got[0].numpy()
    assert (a >= 0).any() and (a[qid >= 0] == -1).any()
    if rise == "none":
        assert trace["resumed"] >= 1 and trace["rose"] == 0
    else:
        assert trace["rose"] >= 1
    if rise == "wrap":
        assert (a[qid == 2] >= 0).any()


@pytest.mark.parametrize("window", [16, 32])
def test_step_model_stages_the_window_again_behind_it(window):
    """A charge that raises a headroom after the speculated next pod moved
    the kernel's pod window past the charged one: pod 0 requests -10,000
    mcores of qa, whose headroom of 1,000 rejects the 2,000-mcore pods
    behind it until that charge, and the next pod admitted before it lies
    two windows on.  The search that runs again from pod 1 stages the
    window anew behind the old one, and pods 1-5 are admitted after all,
    as in ``greedy_assign_plain`` and the JAX package's
    ``greedy_assign``."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.assignment import greedy_assign as jax_greedy

    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_mirror
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    n_pods, tight = 3 * window, 5 * window // 2
    js, jp = problem(48, "factored", n_nodes=48, n_pods=n_pods)
    req = np.zeros((n_pods, R), np.int32)
    req[:, CPU] = np.where(np.arange(n_pods) < tight, 2_000, 500)
    req[0, CPU] = -10_000
    req[:, MEM] = 1_024
    qid = np.where(np.arange(n_pods) < tight, 1, -1).astype(np.int32)
    jp = jp.replace(requests=jnp.asarray(req), quota_id=jnp.asarray(qid),
                    priority=jnp.asarray(9_000 - np.arange(n_pods),
                                         jnp.int32),
                    non_preemptible=jnp.zeros(n_pods, bool),
                    selector_mask=jnp.ones_like(jp.selector_mask))
    jquota, _ = tight_quota(48)
    head = np.array(jquota.headroom)
    head[:, CPU] = 10**6
    head[1, CPU] = 1_000
    checked = np.array(jquota.checked)
    checked[1, CPU] = True
    jquota = jquota.replace(headroom=jnp.asarray(head),
                            checked=jnp.asarray(checked))
    tquota = port(jquota, "QuotaDeviceState")
    jcfg = config("default")
    want = jax_greedy(js, jp, jcfg, jquota)
    ts, tp, tc = (port(js, "ClusterState"), port(jp, "PodBatch"),
                  port(jcfg, "ScoringConfig"))
    plain = greedy_assign_plain(ts, tp, tc, tquota)
    trace = {}
    got = greedy_scan_mirror(ts, tp, tc, tquota, trace=trace, window=window)
    assert same(want[0], got[0]) and torch.equal(got[0], plain[0])
    assert_same_fields(want[1], got[2], "ClusterState")
    assert_same_fields(want[2], got[4], "QuotaDeviceState")
    a = got[0].numpy()
    assert (a[:6] >= 0).all() and (a[6:tight] == -1).all()
    assert (a[tight:] >= 0).any() and trace["rose"] >= 1
