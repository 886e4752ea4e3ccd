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
    R,
    assert_same_fields,
    config,
    port,
    problem,
    quota_trees,
    same,
    set_torch_threads,
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
