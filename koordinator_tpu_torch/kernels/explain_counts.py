"""K7: the Diagnose phase's reject-reason count.

:func:`explain_counts` is the wrapper: CPU tensors take
:func:`explain_counts_plain`, CUDA tensors launch
``csrc/explain_counts.cu``.  The plain version is the JAX algebra of
``koordinator_tpu/ops/explain.py`` ``explain_counts`` (``fit_first_fail``,
``_threshold_mask``, ``feasible_rows`` and the masked sums) in PyTorch,
taken one dimension at a time over chunks of pod rows: the first failing
dimension as a running mask of the dimensions before it, and
``usage_threshold_mask``'s int32 terms per thresholded dimension, the same
expressions elementwise, so the same bits with no (chunk, N, R)
intermediate.  The rows are independent, so every chunking gives the same
bits too.

The kernel judges fit, the usage threshold and the selector exactly as K1
does (``csrc/koord_score.cuh``: ``node_dim_terms``' free capacity and
threshold terms, ``SelRow``), attributes each (pod, node) pair to its first
failing reason, and counts the pairs in registers: nothing of (P, N) is
written to device memory.  :func:`explain_grid` is its grid, the CTAs the
card holds at once (as the library reports them for the instance it
takes) or fewer, and :func:`explain_plan` its work: the (32-pod block,
128-row tile) pairs up to the last valid pod, cut in even contiguous
ranges over the grid.  The kernel records the pod bound it found and each
CTA's range (:data:`LAST_LAUNCH`), so a check on the card holds the plan
against the kernel's own walk.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops.assignment import pod_estimates
from koordinator_tpu_torch.ops.explain import (
    NUM_REASONS,
    REASON_AFFINITY,
    REASON_FIT_FIRST,
    REASON_NODE_INVALID,
    REASON_USAGE_THRESHOLD,
)
from koordinator_tpu_torch.ops.filtering import MAX_SCALE
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: (chunk, N) elements the plain version holds in one intermediate when no
#: chunk is given
PLAIN_CHUNK_ELEMENTS = 1 << 26

#: the kernel's pods a CTA (a block) and node rows a tile
#: (csrc/explain_counts.cu kPodsPerCta, kTile)
PODS_PER_CTA = 32
TILE = 128

#: the last launch on the card: ``resident`` and ``grid`` (explain_grid's),
#: and ``record``, the kernel's int64 record on the device: the last valid
#: pod's row + 1, then each CTA's [start, stop) of (block, tile) pairs
LAST_LAUNCH: dict = {}


def explain_grid(p_rows: int, n_nodes: int, resident: int) -> int:
    """K7's grid over ``p_rows`` pod rows and ``n_nodes`` node rows with
    ``resident`` CTAs the card holds at once: no more CTAs than it holds
    or than there are (block, tile) pairs."""
    return max(1, min(resident, -(-max(p_rows, 0) // PODS_PER_CTA)
                      * -(-max(n_nodes, 1) // TILE)))


def explain_plan(p_rows: int, n_nodes: int, grid: int) -> dict:
    """K7's work over the pod rows up to the last valid one (``p_rows``:
    the kernel finds that bound on the card) and ``n_nodes`` node rows on
    ``grid`` CTAs: the (block, tile) pairs block-major (pair w is block
    w // tiles, tile w % tiles), and each CTA's range [start, stop):
    ``work // grid`` pairs each, one more for the first ``work % grid``."""
    blocks = -(-max(p_rows, 0) // PODS_PER_CTA)
    tiles = -(-max(n_nodes, 1) // TILE)
    work = blocks * tiles
    g = np.arange(grid, dtype=np.int64)
    per, rem = divmod(work, grid)
    start = g * per + np.minimum(g, rem)
    return dict(blocks=blocks, tiles=tiles, work=work, grid=grid,
                start=start, stop=start + per + (g < rem))


def plain_chunk(n_nodes: int) -> int:
    """The plain version's default pod chunk at ``n_nodes`` node rows."""
    return max(1, PLAIN_CHUNK_ELEMENTS // max(n_nodes, 1))


def explain_counts_plain(state: ClusterState, pods: PodBatch, cfg,
                         chunk: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts (P, NUM_REASONS) int32, feasible (P,) int32): the JAX
    algebra a dimension at a time over pod chunks of ``chunk`` rows
    (:func:`plain_chunk` when None)."""
    n, p = state.capacity, pods.capacity
    dev = pods.requests.device
    step = plain_chunk(n) if chunk is None else max(1, chunk)
    valid_n = state.node_valid
    free = state.free
    pod_est = pod_estimates(pods, cfg)
    n_invalid = torch.sum(~valid_n, dtype=torch.int32)
    # _threshold_mask's policy: the aggregated thresholds, when any is
    # set, replace the instantaneous ones; usage_threshold_mask's terms,
    # per dimension (only a threshold > 0 can exceed)
    if bool(torch.any(cfg.agg_usage_thresholds > 0)):
        usage, thresholds = state.node_agg_usage, cfg.agg_usage_thresholds
    else:
        usage, thresholds = state.node_usage, cfg.usage_thresholds
    total = state.node_allocatable
    limit = (thresholds + 1) * total                              # (N, R)
    half = total // 2
    thr_dims = [d for d, t in enumerate(thresholds.tolist()) if t > 0]
    counts = torch.zeros((p, NUM_REASONS), dtype=torch.int32, device=dev)
    feasible = torch.zeros(p, dtype=torch.int32, device=dev)
    for start in range(0, p, step):
        stop = min(start + step, p)
        pod_valid = pods.valid[start:stop]
        req = pods.requests[start:stop]
        est = pod_est[start:stop]
        base = valid_n[None, :] & pod_valid[:, None]              # (c, N)
        part = counts[start:stop]
        # fit_first_fail: a dimension fails where the request is not 0 and
        # exceeds the free capacity; the first failing one is the one no
        # earlier dimension precedes
        failed = torch.zeros_like(base)
        for d in range(NUM_RESOURCE_DIMS):
            fails = ((req[:, d, None] > free[None, :, d])
                     & (req[:, d, None] != 0))
            part[:, REASON_FIT_FIRST + d] = torch.sum(
                base & fails & ~failed, dim=1, dtype=torch.int32)
            failed |= fails
        fit = ~failed
        exceeded = torch.zeros_like(base)
        for d in thr_dims:
            a = (MAX_SCALE * (usage[None, :, d] + est[:, d, None])
                 + half[None, :, d])
            exceeded |= (total[None, :, d] > 0) & (a >= limit[None, :, d])
        thr = ~exceeded
        if pods.feasible is not None:
            aff = pods.feasible[start:stop]
        else:
            c = pods.selector_mask.shape[1]
            nc = torch.clamp(state.node_class, max=c - 1).long()
            aff = (pods.selector_mask[start:stop][:, nc]
                   & (state.node_class < c)[None, :])
        part[:, REASON_USAGE_THRESHOLD] = torch.sum(
            base & fit & ~thr, dim=1, dtype=torch.int32)
        part[:, REASON_AFFINITY] = torch.sum(
            base & fit & thr & ~aff, dim=1, dtype=torch.int32)
        part[:, REASON_NODE_INVALID] = torch.where(pod_valid, n_invalid, 0)
        feasible[start:stop] = torch.sum(base & fit & thr & aff, dim=1,
                                         dtype=torch.int32)
    return counts, feasible


def explain_counts(state: ClusterState, pods: PodBatch, cfg
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's wrapper; see :func:`explain_counts_plain`."""
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds):
        return explain_counts_plain(state, pods, cfg)
    n, r, p = state.capacity, NUM_RESOURCE_DIMS, pods.capacity
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(state.node_valid, "node_valid", torch.bool, (n,))
    build.expect(state.node_class, "node_class", torch.int32, (n,))
    build.expect(pods.requests, "requests", torch.int32, (p, r))
    build.expect(pods.valid, "valid", torch.bool, (p,))
    if pods.selector_mask is not None:
        sel, dense = pods.selector_mask, None
        build.expect(sel, "selector_mask", torch.bool, (p, None))
        c = sel.shape[1]
    else:
        sel, dense, c = None, pods.feasible, 1
        build.expect(dense, "feasible", torch.bool, (p, n))
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage
    dev = pods.requests.device
    # the kernel zeroes both before it counts
    counts = torch.empty((p, NUM_REASONS), dtype=torch.int32, device=dev)
    feasible = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return counts, feasible
    lib = build.lib()
    # (the library picks the instance and asks its occupancy once a
    # device, instance and thresholded-dim count)
    resident = int(lib.koord_explain_counts_resident(
        c, int(dense is not None), build.ptr(cfgv), cfgv.numel()))
    if resident < 1:
        raise RuntimeError("explain_counts: no CTA fits an SM")
    grid = explain_grid(p, n, resident)
    scratch = torch.empty(lib.koord_explain_counts_scratch_bytes(n),
                          dtype=torch.uint8, device=dev)
    record = torch.empty(1 + 2 * grid, dtype=torch.int64, device=dev)
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(resident=resident, grid=grid, record=record)
    words = (None if sel is None else
             torch.empty((p, -(-c // 64)), dtype=torch.int64, device=dev))
    err = lib.koord_explain_counts(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(pods.requests), build.ptr(est), build.ptr(pods.valid),
        build.ptr(sel), c, build.ptr(words), build.ptr(dense),
        build.ptr(cfgv), cfgv.numel(), p, n, NUM_REASONS,
        build.ptr(scratch), build.ptr(counts), build.ptr(feasible),
        grid, build.ptr(record), build.stream_of(counts))
    build.check(err, "explain_counts")
    build.LAUNCHES["explain_counts"] += 1
    return counts, feasible
