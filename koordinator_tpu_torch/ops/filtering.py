"""Feasibility masks: the Filter phase as boolean tensor algebra (port of
``koordinator_tpu/ops/filtering.py``).

- :func:`fit_mask` — NodeResourcesFit: every requested dimension fits into the
  node's request-free capacity.
- :func:`usage_threshold_mask` — LoadAwareScheduling Filter
  (``pkg/scheduler/plugins/loadaware/load_aware.go:150``): a node is
  unschedulable when round(estimatedUsage / allocatable * 100) exceeds the
  per-resource threshold.
"""

from __future__ import annotations

import torch

MAX_SCALE = 100  # percentage scale; MaxNodeScore upstream


def fit_mask(free: torch.Tensor, requests: torch.Tensor) -> torch.Tensor:
    """(N, R) free x (P, R) requests -> (P, N) bool: request fits entirely.

    Dimensions the pod does not request (req == 0) never exclude a node.
    """
    fits = ((requests[:, None, :] <= free[None, :, :])
            | (requests[:, None, :] == 0))
    return torch.all(fits, dim=-1)


def usage_threshold_mask(
    usage: torch.Tensor,
    allocatable: torch.Tensor,
    thresholds: torch.Tensor,
    pod_estimated: torch.Tensor | None = None,
) -> torch.Tensor:
    """LoadAware usage-threshold filter: (P, N) with ``pod_estimated``
    (P, R), else (N,) bool — True = node passes.

    Usage percentage is round(est*100/total) compared with ``>``
    (load_aware.go:326).  round-half-up = floor((100e + t//2)/t), and
    floor(A/t) > thr  <=>  A >= (thr+1)*t, so the predicate needs no
    division.  Both sides stay in int32 exactly as the JAX code keeps them
    (A <= 100*est + t/2 < 2^31 and (thr+1)*t <= 101*MAX_QUANTITY < 2^31 for
    the documented quantity bound).
    """
    total = allocatable
    if pod_estimated is not None:
        est = usage[None, :, :] + pod_estimated[:, None, :]  # (P, N, R)
        total = total[None, :, :]
    else:
        est = usage
    a = MAX_SCALE * est + total // 2
    exceeded = (thresholds > 0) & (total > 0) & (a >= (thresholds + 1) * total)
    return ~torch.any(exceeded, dim=-1)


def combine_masks(*masks: torch.Tensor) -> torch.Tensor:
    """AND together broadcastable feasibility masks."""
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out
