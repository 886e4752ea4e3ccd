"""Placement explainability: the reject-reason accounting of the Diagnose
phase (port of ``koordinator_tpu/ops/explain.py``).

A pod that stays pending gets, for each reason, the count of nodes that
reason eliminated: an O(P x NUM_REASONS) reduction of the Filter's masks,
never a (P, N) reason tensor on the host.

Attribution is first-fail in filter order (as ``scheduler/diagnosis.py``
``explain_pod``): a node counts against exactly one reason: resource fit
(per dimension, the first failing dimension in global dimension order),
then the usage threshold, then affinity/selector.  Invalid node rows count
apart.  The pod-level gates (elastic-quota admission, the gang barrier,
degraded-mode suspension) have no per-node mask: the scheduler fills their
columns when it blames a failure on them.

:func:`explain_counts` runs K7 (``kernels/explain_counts.py``) on CUDA
tensors and its plain version on CPU tensors; the scheduler calls it once a
round over the compacted failed rows.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS, ResourceDim
from koordinator_tpu_torch.ops import scoring
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

# ---- reason taxonomy -------------------------------------------------------
#
# Stable column order of the (P, NUM_REASONS) counts tensor.  Do not
# reorder: recorded explanations key on these names.

REASON_NODE_INVALID = 0
#: per-dimension resource fit: column REASON_FIT_FIRST + ResourceDim
REASON_FIT_FIRST = 1
REASON_USAGE_THRESHOLD = 1 + NUM_RESOURCE_DIMS
REASON_AFFINITY = 2 + NUM_RESOURCE_DIMS
#: pod-level gates (filled on the host; the counts leave them zero)
REASON_QUOTA = 3 + NUM_RESOURCE_DIMS
REASON_GANG = 4 + NUM_RESOURCE_DIMS
REASON_DEGRADED = 5 + NUM_RESOURCE_DIMS
NUM_REASONS = 6 + NUM_RESOURCE_DIMS

REASON_NAMES: tuple[str, ...] = (
    "node_invalid",
    *(f"fit_{dim.name.lower()}" for dim in ResourceDim),
    "usage_threshold",
    "affinity",
    "quota",
    "gang_barrier",
    "degraded_suspended",
)
assert len(REASON_NAMES) == NUM_REASONS

#: columns the counts fill (everything before the pod-level gates)
NODE_REASONS = REASON_NAMES[:REASON_QUOTA]


def fit_first_fail(free: torch.Tensor, requests: torch.Tensor) -> torch.Tensor:
    """(P, N, R) bool: dimension d is the FIRST dimension (global order)
    where the pod's request does not fit the node's free capacity.  At
    most one True a (pod, node); an all-False row fits every dimension.  A
    request of 0 fits whatever is free."""
    dim_ok = ((requests[:, None, :] <= free[None, :, :])
              | (requests[:, None, :] == 0))
    fails = ~dim_ok
    # fails before this dim (the exclusive running count): the first fail
    # is the one no earlier dim precedes
    prior = torch.cumsum(fails, dim=-1, dtype=torch.int32) - fails.int()
    return fails & (prior == 0)


def explain_counts(state: ClusterState, pods: PodBatch, cfg
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reject-reason accounting for a pod batch: ``(counts, feasible)``,
    counts (P, NUM_REASONS) int32 (per pod, how many nodes each reason
    eliminated, first-fail; the pod-level gate columns stay 0) and
    feasible (P,) int32, the nodes that passed every filter.  For a valid
    pod ``feasible + counts[:REASON_QUOTA].sum() == N``, the padded node
    capacity; invalid pod rows are all zero.

    CUDA tensors launch K7; CPU tensors take its plain version."""
    from koordinator_tpu_torch.kernels import explain_counts as k7

    return k7.explain_counts(state, pods, cfg)


def decompose_scores(state: ClusterState, pods: PodBatch, cfg,
                     cand_node: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-term score decomposition at the (P, K) candidate node rows
    ``cand_node``: a dict of (P, K) int32 tensors, the raw per-plugin
    scores (``loadaware``, ``fitplus``, ``scarce``) and their weighted
    ``total``, equal to the composite ``score_pods`` computes at the same
    pairs."""
    req = pods.requests                                     # (P, R)
    pod_est = scoring.estimate_pod_usage_by_band(
        req, cfg.estimator_factors, cfg.estimator_defaults)
    rows = cand_node.long()
    alloc = state.node_allocatable[rows]                    # (P, K, R)
    requested = state.node_requested[rows]
    usage = state.node_usage[rows]

    la = scoring.loadaware_score(
        usage + pod_est[:, None, :], alloc,
        cfg.loadaware_resource_weights, cfg.loadaware_dominant_weight)

    # NodeResourcesFitPlus at the gathered rows: fitplus_score's math
    combined = requested + req[:, None, :]
    least = scoring.least_requested_score(combined, alloc)
    most = scoring.most_requested_score(combined, alloc)
    per_res = torch.where(cfg.fitplus_most_allocated, most, least)
    req_mask = (req > 0)[:, None, :]
    w = torch.where(req_mask, cfg.fitplus_resource_weights.to(torch.int32), 0)
    num = torch.sum(per_res * w, dim=-1, dtype=torch.int32)
    den = torch.sum(w, dim=-1, dtype=torch.int32)
    fp = torch.where(den > 0, num // torch.clamp(den, min=1),
                     scoring.MAX_NODE_SCORE)

    # ScarceResourceAvoidance at the gathered rows
    diff = (alloc > 0) & ~req_mask
    inter = diff & cfg.scarce_dims
    n_diff = torch.sum(diff, dim=-1, dtype=torch.int32)
    n_inter = torch.sum(inter, dim=-1, dtype=torch.int32)
    sc = ((n_diff - n_inter) * scoring.MAX_NODE_SCORE
          // torch.clamp(n_diff, min=1))
    sc = torch.where((n_diff == 0) | (n_inter == 0), scoring.MAX_NODE_SCORE,
                     sc)

    total = (la * cfg.loadaware_plugin_weight
             + fp * cfg.fitplus_plugin_weight
             + sc * cfg.scarce_plugin_weight)
    return {"loadaware": la, "fitplus": fp, "scarce": sc, "total": total}
