"""Batched scheduling: score the whole (pods x nodes) problem, then assign
(port of ``koordinator_tpu/ops/assignment.py``).

- :func:`score_pods` — one-shot Filter+Score over the (P, N) matrix, no
  capacity feedback between pods.  It is the plain version of the fused
  candidate-selection kernel (``kernels/select_candidates.py``).
- :func:`greedy_assign` — sequential greedy assignment with capacity feedback
  in priority order (the reference's scheduleOne loop over a whole queue).
  On CUDA tensors it runs the K4 kernel (``kernels/greedy_scan.py``); its
  plain version :func:`greedy_assign_plain` is a Python loop over pods.  The
  rescue pass and rounds under the batch-solver threshold run it.  The loop
  itself, :func:`greedy_scan_plain`, also takes reservations: the plain
  version of K4r, which ``ops/reservation.py`` ``reservation_greedy_assign``
  runs for the scheduler's reservation pre-pass.

The scoring pipeline composes the scheduler profile's score plugins:
  final = la_w * LoadAware + fp_w * NodeResourcesFitPlus + sc_w * ScarceResourceAvoidance
"""

from __future__ import annotations

import dataclasses

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS, ResourceDim
from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops import filtering, scoring
from koordinator_tpu_torch.quota.admission import charge_quota, quota_admission_mask
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch


@dataclasses.dataclass
class ScoringConfig:
    """Plugin weights/args (scheduler-profile equivalent), as tensors."""

    # LoadAwareScheduling args (apis/config/types.go LoadAwareSchedulingArgs)
    loadaware_resource_weights: torch.Tensor  # (R,) int32
    loadaware_dominant_weight: torch.Tensor   # () int32
    loadaware_plugin_weight: torch.Tensor     # () int32
    usage_thresholds: torch.Tensor            # (R,) int32 pct, 0 = unchecked
    agg_usage_thresholds: torch.Tensor        # (R,) int32 pct, 0 = unchecked
    estimator_factors: torch.Tensor           # (R,) int32 pct
    estimator_defaults: torch.Tensor          # (R,) int32

    # NodeResourcesFitPlus args
    fitplus_resource_weights: torch.Tensor    # (R,) int32
    fitplus_most_allocated: torch.Tensor      # (R,) bool
    fitplus_plugin_weight: torch.Tensor       # () int32

    # ScarceResourceAvoidance args
    scarce_dims: torch.Tensor                 # (R,) bool
    scarce_plugin_weight: torch.Tensor        # () int32

    def replace(self, **changes) -> "ScoringConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def default(cls, device=None) -> "ScoringConfig":
        dev = resolve_device(device)
        r = NUM_RESOURCE_DIMS

        def vec(fill=0, dtype=torch.int32, **at):
            v = torch.full((r,), fill, dtype=dtype)
            for d, val in at.items():
                v[ResourceDim[d.upper()]] = val
            return v.to(dev)

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return cls(
            loadaware_resource_weights=vec(cpu=1, memory=1),
            loadaware_dominant_weight=scalar(0),
            loadaware_plugin_weight=scalar(1),
            # defaultNodeCPUUsageThreshold / memory
            usage_thresholds=vec(cpu=65, memory=95),
            agg_usage_thresholds=vec(),
            # DefaultEstimatedScalingFactors
            estimator_factors=vec(100, cpu=85, memory=70),
            # DefaultMilliCPURequest / DefaultMemoryRequest (MiB units)
            estimator_defaults=vec(cpu=250, memory=200),
            fitplus_resource_weights=vec(cpu=1, memory=1),
            fitplus_most_allocated=vec(False, dtype=torch.bool),
            fitplus_plugin_weight=scalar(1),
            scarce_dims=vec(False, dtype=torch.bool, gpu=True),
            scarce_plugin_weight=scalar(0),
        )


def _composite_score(
    cfg: ScoringConfig,
    allocatable: torch.Tensor,   # (N, R)
    requested: torch.Tensor,     # (N, R)
    est_usage: torch.Tensor,     # (N, R) node usage + in-flight estimates
    pod_requests: torch.Tensor,  # (P, R)
    pod_estimated: torch.Tensor, # (P, R)
) -> torch.Tensor:
    """(P, N) weighted sum of score plugins."""
    la = scoring.loadaware_score(
        est_usage[None, :, :] + pod_estimated[:, None, :],
        allocatable[None, :, :],
        cfg.loadaware_resource_weights,
        cfg.loadaware_dominant_weight,
    )
    fp = scoring.fitplus_score(
        requested, allocatable, pod_requests,
        cfg.fitplus_resource_weights, cfg.fitplus_most_allocated,
    )
    sc = scoring.scarce_resource_score(pod_requests, allocatable, cfg.scarce_dims)
    return (la * cfg.loadaware_plugin_weight
            + fp * cfg.fitplus_plugin_weight
            + sc * cfg.scarce_plugin_weight)


def _threshold_mask(cfg, usage, agg_usage, allocatable, pod_est):
    """LoadAware Filter threshold selection: the aggregated-percentile policy,
    when configured, REPLACES the instantaneous thresholds (load_aware.go:150
    checks one or the other, never both)."""
    if bool(torch.any(cfg.agg_usage_thresholds > 0)):
        return filtering.usage_threshold_mask(
            agg_usage, allocatable, cfg.agg_usage_thresholds, pod_est)
    return filtering.usage_threshold_mask(
        usage, allocatable, cfg.usage_thresholds, pod_est)


def pod_estimates(pods: PodBatch, cfg: ScoringConfig) -> torch.Tensor:
    """(P, R) estimated usage per pod (the LoadAware estimator)."""
    return scoring.estimate_pod_usage_by_band(
        pods.requests, cfg.estimator_factors, cfg.estimator_defaults)


def score_pods(
    state: ClusterState, pods: PodBatch, cfg: ScoringConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot batched Filter+Score (no capacity feedback).

    Returns (scores, feasible): (P, N) int32 and (P, N) bool.
    """
    pod_est = pod_estimates(pods, cfg)
    feasible = filtering.combine_masks(
        filtering.fit_mask(state.free, pods.requests),
        _threshold_mask(cfg, state.node_usage, state.node_agg_usage,
                        state.node_allocatable, pod_est),
        pods.feasible_rows(state),
        state.node_valid[None, :],
        pods.valid[:, None],
    )
    scores = _composite_score(
        cfg, state.node_allocatable, state.node_requested, state.node_usage,
        pods.requests, pod_est)
    return scores, feasible


def priority_order(pods: PodBatch) -> torch.Tensor:
    """(P,) int64 pod order: priority descending, batch row ascending on
    ties (``jnp.lexsort((arange, -priority))`` as one stable sort)."""
    return torch.sort(-pods.priority, stable=True).indices


def greedy_assign(state: ClusterState, pods: PodBatch, cfg: ScoringConfig,
                  quota=None):
    """Assign a whole pending batch sequentially in priority order: the K4
    kernel's wrapper (``kernels/greedy_scan.py``), which takes
    :func:`greedy_assign_plain` on CPU tensors.  Same returns."""
    # imported here: the kernel module imports this one
    from koordinator_tpu_torch.kernels import greedy_scan

    return greedy_scan.greedy_scan_kernel(state, pods, cfg, quota)


def greedy_assign_plain(state: ClusterState, pods: PodBatch,
                        cfg: ScoringConfig, quota=None):
    """Assign a whole pending batch sequentially in priority order (the JAX
    package's ``greedy_assign``): :func:`greedy_scan_plain` without
    reservations.

    Returns (assignments, new_state, new_quota): assignments is (P,) int32
    node row per pod (batch order), -1 = unschedulable; new_state carries
    the updated node_requested; new_quota is None unless a
    :class:`QuotaDeviceState` is given, which then also admits and is
    charged per pod.
    """
    assignments, _, new_state, _, new_quota = greedy_scan_plain(
        state, pods, cfg, quota)
    return assignments, new_state, new_quota


def greedy_scan_plain(state: ClusterState, pods: PodBatch,
                      cfg: ScoringConfig, quota=None, rsv=None, match=None,
                      rsv_boost: int = 10_000):
    """The JAX package's ``_greedy_scan`` as a Python loop over pods: one
    pod per step, each filtered and scored against the accounting its
    predecessors left, ties to the lowest node index.

    With a :class:`~koordinator_tpu_torch.ops.reservation.ReservationSet`
    ``rsv`` and its (P, V) owner ``match``, each step also extends the fit
    with the pod's fitting matched reservations, adds ``rsv_boost`` to
    their nodes' scores, nominates a reservation on the chosen node and
    charges the node only the part of the request that reservation does
    not cover.

    Returns (assignments, rsv_choice, new_state, new_rsv, new_quota); the
    reservation outputs are None when ``rsv`` is None.  Invalid rows are
    skipped: in the JAX scan they assign -1 and add zero, so skipping them
    gives the same bits, and so is a pod no node takes.
    """
    from koordinator_tpu_torch.ops.reservation import (
        allocate_from_reservation,
        nominate_reservation,
        reservation_fit,
        reservation_node_mask,
    )

    dev = state.device
    order = priority_order(pods).tolist()
    valid = pods.valid.tolist()
    pod_est_all = pod_estimates(pods, cfg)
    feasible_all = pods.feasible_rows(state)
    requested = state.node_requested.clone()
    est_added = torch.zeros_like(state.node_usage)
    assignments = torch.full((pods.capacity,), -1, dtype=torch.int32,
                             device=dev)
    rsv_choice = (None if rsv is None else
                  torch.full((pods.capacity,), -1, dtype=torch.int32,
                             device=dev))
    alloc = state.node_allocatable
    node_valid = state.node_valid
    for idx in order:
        if not valid[idx]:
            continue
        req = pods.requests[idx]
        pod_est = pod_est_all[idx]
        free = torch.where(node_valid[:, None], alloc - requested, 0)
        fits = torch.all((req[None, :] <= free) | (req[None, :] == 0), dim=-1)
        if rsv is not None:
            fits_v = reservation_fit(rsv, free, req[None, :],
                                     match[idx:idx + 1])
            via_rsv = reservation_node_mask(fits_v, rsv, state.capacity)[0]
            fits = fits | via_rsv
        feasible = (
            fits
            & _threshold_mask(cfg, state.node_usage + est_added,
                              state.node_agg_usage + est_added,
                              alloc, pod_est[None, :])[0]
            & feasible_all[idx]
            & node_valid
        )
        if quota is not None:
            admitted = quota_admission_mask(
                quota, req[None, :], pods.quota_id[idx:idx + 1],
                pods.non_preemptible[idx:idx + 1])[0]
            feasible = feasible & admitted
        scores = _composite_score(
            cfg, alloc, requested, state.node_usage + est_added,
            req[None, :], pod_est[None, :])[0]
        if rsv is not None:
            scores = scores + torch.where(via_rsv, rsv_boost, 0).to(
                scores.dtype)
        masked = torch.where(feasible, scores, -1)
        best = int(torch.argmax(masked))
        if int(masked[best]) < 0:
            continue
        add = req
        if rsv is not None:
            node = torch.tensor([best], dtype=torch.int32, device=dev)
            r_idx = int(nominate_reservation(fits_v, rsv, node)[0])
            rsv, add = allocate_from_reservation(rsv, r_idx, req)
            rsv_choice[idx] = r_idx
        requested[best] += add
        est_added[best] += pod_est
        assignments[idx] = best
        if quota is not None:
            quota = charge_quota(quota, req, pods.quota_id[idx],
                                 non_preemptible=pods.non_preemptible[idx])
    return (assignments, rsv_choice, state.replace(node_requested=requested),
            rsv, quota)
