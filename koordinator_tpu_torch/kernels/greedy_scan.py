"""K4: the exact sequential greedy scan as one kernel on a cluster of CTAs.

:func:`greedy_scan_kernel` is the wrapper: CPU tensors take
``ops/assignment.py`` :func:`greedy_assign_plain` (the JAX package's
``_greedy_scan`` without the reservation branch, as a Python loop over
pods), CUDA tensors launch ``csrc/greedy_scan.cu`` once for the whole scan
(16 CTAs, each owning a range of the nodes; see the source's header).
A launch the card refuses (a cluster or shared-memory request it cannot
meet, e.g. a quota tree too large for each CTA's replica) raises.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    greedy_assign_plain,
    pod_estimates,
    priority_order,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch


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
        sel, feas = pods.selector_mask, None
        build.expect(sel, "selector_mask", torch.bool, (p, None))
        c = sel.shape[1]
        if c > 64:
            raise ValueError(f"the kernel takes at most 64 node classes, "
                             f"got {c}")
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
        return assignments, new_state, new_quota
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage
    order = priority_order(pods).to(torch.int32)
    lib = build.lib()
    # the node columns' global home, needed only when they do not fit a
    # CTA's shared memory beside the quota replica
    nbytes = lib.koord_greedy_scan_scratch_bytes(n, q_args[5], q_args[6])
    if nbytes < 0:
        raise RuntimeError("greedy_scan: the card's shared memory could not "
                           "be queried")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    err = lib.koord_greedy_scan(
        build.ptr(state.node_allocatable), build.ptr(requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(scratch), build.ptr(pods.requests), build.ptr(est),
        build.ptr(pods.valid), build.ptr(order), build.ptr(sel), c,
        build.ptr(feas), build.ptr(cfgv), cfgv.numel(),
        *(build.ptr(t) if torch.is_tensor(t) else t for t in q_args),
        build.ptr(pods.quota_id), build.ptr(pods.non_preemptible), p, n,
        build.ptr(assignments), build.stream_of(assignments))
    build.check(err, "greedy_scan")
    build.LAUNCHES["greedy_scan"] += 1
    return assignments, new_state, new_quota
