"""K4 and K4r: the exact sequential greedy scan as one kernel on a cluster of
CTAs, without and with reservations.

:func:`greedy_scan_kernel` (K4) and :func:`reservation_scan_kernel` (K4r)
are the wrappers.  CPU tensors take their plain versions,
``ops/assignment.py`` :func:`greedy_assign_plain` and
:func:`greedy_scan_plain` (the JAX package's ``_greedy_scan`` as a Python
loop over pods); CUDA tensors launch ``csrc/greedy_scan.cu`` once for the
whole scan (16 CTAs, each owning a range of the nodes and, for K4r, the
reservation rows on them; see the source's header).  A launch the card
refuses (a cluster or shared-memory request it cannot meet, e.g. a quota
tree too large for each CTA's replica) raises.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    greedy_assign_plain,
    greedy_scan_plain,
    pod_estimates,
    priority_order,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: ints of K4r's reservation record (csrc/greedy_scan.cu kRsvInts):
#: reserved (R), allocated (R), node, row, flags
RSV_INTS = 2 * NUM_RESOURCE_DIMS + 3
_ONCE, _RESTRICTED = 1, 2


def _scan_args(state: ClusterState, pods: PodBatch, cfg: ScoringConfig,
               quota, scratch_fn):
    """Check the scan's inputs and build the arguments K4 and K4r share,
    up to the pods' quota ids; returns (args before P and N, assignments,
    new_state, new_quota)."""
    n, r = state.capacity, NUM_RESOURCE_DIMS
    p = pods.capacity
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(state.node_valid, "node_valid", torch.bool, (n,))
    build.expect(state.node_class, "node_class", torch.int32, (n,))
    build.expect(pods.requests, "requests", torch.int32, (p, r))
    build.expect(pods.valid, "valid", torch.bool, (p,))
    build.expect(pods.quota_id, "quota_id", torch.int32, (p,))
    build.expect(pods.non_preemptible, "non_preemptible", torch.bool, (p,))
    if pods.selector_mask is not None:
        build.expect(pods.selector_mask, "selector_mask", torch.bool,
                     (p, None))
        c = pods.selector_mask.shape[1]
        sel, feas = pods.selector_mask, None
    else:
        sel, feas, c = None, pods.feasible, 1
        build.expect(feas, "feasible", torch.bool, (p, n))
    dev = pods.requests.device
    requested = state.node_requested.clone()
    assignments = torch.full((p,), -1, dtype=torch.int32, device=dev)
    new_quota = None
    q_args = [None] * 5 + [0, 0]
    if quota is not None:
        q, d = quota.capacity, quota.chain.shape[1]
        build.expect(quota.headroom, "headroom", torch.int32, (q, r))
        build.expect(quota.min_headroom, "min_headroom", torch.int32, (q, r))
        build.expect(quota.checked, "checked", torch.bool, (q, r))
        build.expect(quota.chain, "chain", torch.int32, (q, d))
        build.expect(quota.valid, "valid", torch.bool, (q,))
        new_quota = quota.replace(headroom=quota.headroom.clone(),
                                  min_headroom=quota.min_headroom.clone())
        q_args = [new_quota.headroom, new_quota.min_headroom, quota.checked,
                  quota.chain, quota.valid, q, d]
    new_state = state.replace(node_requested=requested)
    if p == 0:
        return None, assignments, new_state, new_quota
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage
    order = priority_order(pods).to(torch.int32)
    # the node columns' global home, needed only when they do not fit a
    # CTA's shared memory beside the quota replica
    nbytes = scratch_fn(n, q_args[5], q_args[6])
    if nbytes < 0:
        raise RuntimeError("greedy_scan: the card's shared memory could not "
                           "be queried")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    # the selector rows as words, packed by the launch
    words = (None if sel is None else
             torch.empty((p, -(-c // 64)), dtype=torch.int64, device=dev))
    args = [build.ptr(state.node_allocatable), build.ptr(requested),
            build.ptr(state.node_usage), build.ptr(base),
            build.ptr(state.node_valid), build.ptr(state.node_class),
            build.ptr(scratch), build.ptr(pods.requests), build.ptr(est),
            build.ptr(pods.valid), build.ptr(order), build.ptr(sel), c,
            build.ptr(words),
            build.ptr(feas), build.ptr(cfgv), cfgv.numel(),
            *(build.ptr(t) if torch.is_tensor(t) else t for t in q_args),
            build.ptr(pods.quota_id), build.ptr(pods.non_preemptible), p, n]
    # the temporaries must outlive the launch's enqueue
    keep = (est, cfgv, order, scratch, words)
    return (args, keep), assignments, new_state, new_quota


def greedy_scan_kernel(state: ClusterState, pods: PodBatch,
                       cfg: ScoringConfig, quota=None):
    """K4's wrapper: (assignments, new_state, new_quota) as
    :func:`greedy_assign_plain` returns them.  The kernel updates copies of
    ``node_requested`` and of the quota's headroom tensors in place; the
    inputs are not modified."""
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds,
                    None if quota is None else quota.headroom):
        return greedy_assign_plain(state, pods, cfg, quota)
    lib = build.lib()
    launch, assignments, new_state, new_quota = _scan_args(
        state, pods, cfg, quota, lib.koord_greedy_scan_scratch_bytes)
    if launch is None:
        return assignments, new_state, new_quota
    args, _keep = launch
    err = lib.koord_greedy_scan(*args, build.ptr(assignments),
                                build.stream_of(assignments))
    build.check(err, "greedy_scan")
    build.LAUNCHES["greedy_scan"] += 1
    return assignments, new_state, new_quota


def reservation_records(rsv, n_nodes: int, nodes_per_cta: int):
    """K4r's view of a reservation set: the placed rows (valid, on a node in
    [0, n_nodes)) as (V', RSV_INTS) int32 records sorted by node, stable so
    that the rows of one node stay in row order; the rows' order into the
    set (V',); and the most records on one CTA's node range.  The other
    rows can neither fit a pod nor be nominated: they stay as they are."""
    dev = rsv.node_idx.device
    placed = rsv.valid & (rsv.node_idx >= 0) & (rsv.node_idx < n_nodes)
    key = torch.where(placed, rsv.node_idx, n_nodes).to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    count = int(placed.sum())
    perm = perm[:count]
    node = rsv.node_idx[perm]
    flags = (rsv.allocate_once[perm].to(torch.int32) * _ONCE
             + rsv.restricted[perm].to(torch.int32) * _RESTRICTED)
    rows = torch.cat([rsv.reserved[perm], rsv.allocated[perm], node[:, None],
                      perm[:, None].to(torch.int32), flags[:, None]], dim=1)
    per_cta = torch.bincount(node.long() // nodes_per_cta, minlength=1)
    vmax = int(per_cta.max()) if count else 0
    return rows.contiguous(), perm, vmax


def reservation_scan_kernel(state: ClusterState, pods: PodBatch,
                            cfg: ScoringConfig, rsv, match,
                            quota=None, boost: int = 10_000):
    """K4r's wrapper: (assignments, rsv_choice, new_state, new_rsv,
    new_quota) as :func:`greedy_scan_plain` returns them with ``rsv``.

    On the card it raises unless every placed reservation row's remainder
    is non-negative with a total below 2**31 - 1 and no valid pod requests
    a negative amount: then the remainders only shrink through the scan
    (what the kernel's nomination relies on).  The inputs are not
    modified."""
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds, rsv.reserved, match,
                    None if quota is None else quota.headroom):
        return greedy_scan_plain(state, pods, cfg, quota, rsv, match, boost)
    n, r, p, v = state.capacity, NUM_RESOURCE_DIMS, pods.capacity, rsv.capacity
    build.expect(rsv.valid, "rsv.valid", torch.bool, (v,))
    build.expect(rsv.node_idx, "rsv.node_idx", torch.int32, (v,))
    build.expect(rsv.reserved, "rsv.reserved", torch.int32, (v, r))
    build.expect(rsv.allocated, "rsv.allocated", torch.int32, (v, r))
    build.expect(rsv.allocate_once, "rsv.allocate_once", torch.bool, (v,))
    build.expect(rsv.restricted, "rsv.restricted", torch.bool, (v,))
    build.expect(match, "match", torch.bool, (p, v))
    lib = build.lib()
    records, perm, vmax = reservation_records(
        rsv, n, lib.koord_reservation_scan_nodes_per_cta(n))
    rem = records[:, :r].to(torch.int64) - records[:, r:2 * r]
    bad = ((rem < 0).any() | (rem.sum(1) >= 2**31 - 1).any()
           | ((pods.requests < 0).any(1) & pods.valid).any())
    if bool(bad):
        raise ValueError(
            "reservation_scan: the kernel takes remainders in "
            "[0, reserved] summing below 2**31 - 1 and non-negative "
            "requests")
    launch, assignments, new_state, new_quota = _scan_args(
        state, pods, cfg, quota, lib.koord_reservation_scan_scratch_bytes)
    rsv_choice = torch.full((p,), -1, dtype=torch.int32,
                            device=assignments.device)
    if launch is None:
        return assignments, rsv_choice, new_state, rsv, new_quota
    args, _keep = launch
    match_rec = match[:, perm].contiguous()
    err = lib.koord_reservation_scan(
        *args, build.ptr(records), records.shape[0], vmax,
        build.ptr(match_rec), boost, build.ptr(assignments),
        build.ptr(rsv_choice), build.stream_of(assignments))
    build.check(err, "reservation_scan")
    build.LAUNCHES["reservation_scan"] += 1
    allocated = rsv.allocated.clone()
    allocated[perm] = records[:, r:2 * r]
    return (assignments, rsv_choice, new_state,
            rsv.replace(allocated=allocated), new_quota)
