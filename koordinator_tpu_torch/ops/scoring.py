"""Score functions with reference-parity integer semantics (port of
``koordinator_tpu/ops/scoring.py``).

Each scorer is written over the full (pods x nodes) problem; MaxNodeScore =
100 as upstream.  All division is integer floor division on int32.  The JAX
package routes it through ``exact_floordiv``, a float-estimate-plus-correction
workaround for the TPU's slow integer divide that gives floor division's bits
for the non-negative operands here; the port divides with ``//`` directly.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import BATCH_DIMS, MID_DIMS, ResourceDim

MAX_NODE_SCORE = 100


def _isum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int32 sum (torch promotes integer sums to int64; JAX keeps int32)."""
    return torch.sum(x, dim=dim, dtype=torch.int32)


def least_used_score(used: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """(capacity-used)*100/capacity; 0 when capacity==0 or used>capacity.

    Parity: pkg/scheduler/plugins/loadaware/load_aware.go:368 leastUsedScore.
    """
    ok = (capacity > 0) & (used <= capacity)
    safe_cap = torch.clamp(capacity, min=1)
    return torch.where(
        ok, torch.clamp(capacity - used, min=0) * MAX_NODE_SCORE // safe_cap, 0)


def most_requested_score(requested: torch.Tensor,
                         capacity: torch.Tensor) -> torch.Tensor:
    """min(requested, capacity)*100/capacity; 0 when capacity==0.

    Parity: noderesourcefitplus/node_resource_fit_plus_utils.go:36.
    """
    clamped = torch.minimum(requested, capacity)
    safe_cap = torch.clamp(capacity, min=1)
    return torch.where(capacity > 0, clamped * MAX_NODE_SCORE // safe_cap, 0)


def least_requested_score(requested: torch.Tensor,
                          capacity: torch.Tensor) -> torch.Tensor:
    """Parity: noderesourcefitplus/node_resource_fit_plus_utils.go:47."""
    return least_used_score(requested, capacity)


def loadaware_score(
    used: torch.Tensor,
    allocatable: torch.Tensor,
    weights: torch.Tensor,
    dominant_weight,
) -> torch.Tensor:
    """LoadAwareScheduling scorer: weighted least-used + dominant-resource
    term (load_aware.go:347)::

      nodeScore = sum_i w_i * leastUsed_i  +  dw * min_i leastUsed_i
      score     = nodeScore / (sum_i w_i + dw)

    The min runs over configured resources (w_i > 0); with none configured
    the dominant score is MaxNodeScore.  Returns (..., N) int32.
    """
    per_res = least_used_score(used, allocatable)  # (..., N, R)
    w = weights.to(torch.int32)
    dw = torch.as_tensor(dominant_weight, dtype=torch.int32, device=w.device)
    configured = w > 0
    dominant = torch.amin(torch.where(configured, per_res, MAX_NODE_SCORE),
                          dim=-1)
    node_score = _isum(per_res * w) + dominant * dw
    weight_sum = _isum(w) + dw
    return torch.where(weight_sum > 0,
                       node_score // torch.clamp(weight_sum, min=1), 0)


def fitplus_score(
    requested: torch.Tensor,
    allocatable: torch.Tensor,
    pod_requests: torch.Tensor,
    weights: torch.Tensor,
    most_allocated: torch.Tensor,
) -> torch.Tensor:
    """NodeResourcesFitPlus (node_resource_fit_plus_utils.go:58): for each
    resource the pod requests, strategy_r(nodeRequested + podRequest,
    allocatable) * w_r, summed and divided by the summed weights.
    Returns (P, N) int32; MaxNodeScore when no weighted resource is requested.
    """
    combined = requested[None, :, :] + pod_requests[:, None, :]  # (P, N, R)
    least = least_requested_score(combined, allocatable[None])
    most = most_requested_score(combined, allocatable[None])
    per_res = torch.where(most_allocated, most, least)

    req_mask = pod_requests[:, None, :] > 0  # (P, 1, R)
    w = torch.where(req_mask, weights.to(torch.int32), 0)
    num = _isum(per_res * w)
    den = _isum(w)
    return torch.where(den > 0, num // torch.clamp(den, min=1), MAX_NODE_SCORE)


def scarce_resource_score(
    pod_requests: torch.Tensor,
    node_allocatable: torch.Tensor,
    scarce_dims: torch.Tensor,
) -> torch.Tensor:
    """ScarceResourceAvoidance (scarce_resource_avoidance.go:89,158)::

      diff      = node resource types NOT requested by the pod
      intersect = diff ∩ configured scarce types
      score     = (|diff| - |intersect|) * 100 / |diff|, or 100 if either empty.

    Returns (P, N) int32.
    """
    node_has = node_allocatable > 0
    pod_wants = pod_requests > 0
    diff = node_has[None, :, :] & ~pod_wants[:, None, :]  # (P, N, R)
    inter = diff & scarce_dims
    n_diff = _isum(diff.to(torch.int32))
    n_inter = _isum(inter.to(torch.int32))
    score = (n_diff - n_inter) * MAX_NODE_SCORE // torch.clamp(n_diff, min=1)
    return torch.where((n_diff == 0) | (n_inter == 0), MAX_NODE_SCORE, score)


def estimate_pod_usage(
    pod_requests: torch.Tensor,
    scaling_factors_pct: torch.Tensor,
    default_request: torch.Tensor | None = None,
) -> torch.Tensor:
    """LoadAware DefaultEstimator (default_estimator.go:74-121): estimated
    usage = round(request * factor/100); zero-request dims estimate at the
    (unscaled) default.  Returns (P, R) int32."""
    scaled = (pod_requests * scaling_factors_pct + 50) // 100
    if default_request is not None:
        scaled = torch.where((pod_requests == 0) & (default_request > 0),
                             default_request, scaled)
    return scaled


def estimate_pod_usage_by_band(
    pod_requests: torch.Tensor,
    scaling_factors_pct: torch.Tensor,
    default_request: torch.Tensor | None = None,
) -> torch.Tensor:
    """Band-translated usage estimate: batch/mid requests count as physical
    use (default_estimator.go:74-83).  The summed bands land in the physical
    CPU/MEMORY dims; the band dims are zeroed before estimating."""
    cpu_eff = (pod_requests[..., ResourceDim.CPU]
               + pod_requests[..., ResourceDim.BATCH_CPU]
               + pod_requests[..., ResourceDim.MID_CPU])
    mem_eff = (pod_requests[..., ResourceDim.MEMORY]
               + pod_requests[..., ResourceDim.BATCH_MEMORY]
               + pod_requests[..., ResourceDim.MID_MEMORY])
    translated = pod_requests.clone()
    translated[..., ResourceDim.CPU] = cpu_eff
    translated[..., ResourceDim.MEMORY] = mem_eff
    for d in (*BATCH_DIMS, *MID_DIMS):
        translated[..., d] = 0
    return estimate_pod_usage(translated, scaling_factors_pct, default_request)
