"""Gang (coscheduling) all-or-nothing assignment (port of
``koordinator_tpu/ops/gang.py``).

Solve-and-rollback in place of the reference's Permit-phase park-and-wait
(``coscheduling/core/core.go:544``): solve, count per-gang placements,
propagate failure through gang groups, roll back every pod of a failed
group (assignments, node accounting, quota charges), and optionally
re-solve with the freed capacity.  PreEnqueue parity: a gang with fewer
pending pods than minMember never enters the solve (``core.go:212``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    greedy_assign,
    pod_estimates,
)
from koordinator_tpu_torch.ops.batch_assign import batch_assign
from koordinator_tpu_torch.quota.admission import charge_quota_batch
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch


@dataclasses.dataclass
class GangInfo:
    """Gang definitions, shape (G,) (PodGroup minMember, gang-group)."""

    min_member: torch.Tensor  # (G,) int32
    group_id: torch.Tensor    # (G,) int32 — gangs sharing a group live or die together
    valid: torch.Tensor       # (G,) bool

    @property
    def capacity(self) -> int:
        return self.min_member.shape[0]

    @classmethod
    def build(cls, min_member: np.ndarray, group_id: np.ndarray | None = None,
              capacity: int | None = None, device=None) -> "GangInfo":
        dev = resolve_device(device)
        g = len(min_member)
        cap = capacity if capacity is not None else max(8, g)
        mm = np.zeros(cap, np.int32)
        mm[:g] = min_member
        gid = np.arange(cap, dtype=np.int32)
        if group_id is not None:
            gid[:g] = group_id
        valid = np.zeros(cap, bool)
        valid[:g] = True
        return cls(min_member=torch.from_numpy(mm).to(dev),
                   group_id=torch.from_numpy(gid).to(dev),
                   valid=torch.from_numpy(valid).to(dev))


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int32, device=values.device)
    return out.index_add_(0, ids.long(), values.to(torch.int32))


def _per_gang_counts(flags: torch.Tensor, gang_id: torch.Tensor,
                     g: int) -> torch.Tensor:
    """Sum boolean flags per gang; gang_id -1 lands in an overflow bucket."""
    gid = torch.where(gang_id >= 0, gang_id, g)
    return _segment_sum(flags, gid, g + 1)[:g]


def _group_ok(gang_ok: torch.Tensor, gangs: GangInfo) -> torch.Tensor:
    """(G,) bool: True when every valid gang in the same group met min."""
    fails = _segment_sum(~gang_ok & gangs.valid, gangs.group_id,
                         gangs.capacity)
    return fails[gangs.group_id.long()] == 0


def pre_enqueue_mask(pods: PodBatch, gangs: GangInfo) -> torch.Tensor:
    """(P,) bool: gang pods are schedulable only when their gang has at
    least minMember pending pods (PreEnqueue parity)."""
    pending = _per_gang_counts(pods.valid, pods.gang_id, gangs.capacity)
    gang_ready = pending >= gangs.min_member
    pod_gang = torch.clamp(pods.gang_id, min=0).long()
    return (pods.gang_id < 0) | gang_ready[pod_gang]


def rollback_failed_gangs(assignments, state_before: ClusterState,
                          pods: PodBatch, gangs: GangInfo, prior_kept=None):
    """Undo every assignment belonging to a gang group that missed
    minMember.  Returns (final_assignments, state, keep_mask, failed_mask);
    node_requested is rebuilt from ``state_before`` plus only this pass's
    kept pods.  ``prior_kept`` marks pods kept in earlier passes: they count
    toward minMember but are not re-assigned."""
    assigned = (assignments >= 0) & pods.valid
    counted = assigned if prior_kept is None else (assigned | prior_kept)
    counts = _per_gang_counts(counted, pods.gang_id, gangs.capacity)
    gang_ok = (counts >= gangs.min_member) & gangs.valid
    ok = _group_ok(gang_ok, gangs)
    pod_gang = torch.clamp(pods.gang_id, min=0).long()
    keep = assigned & ((pods.gang_id < 0) | ok[pod_gang])

    final = torch.where(keep, assignments, -1)
    node = torch.where(keep, assignments, 0).long()
    add = torch.where(keep[:, None], pods.requests, 0)
    node_requested = state_before.node_requested.clone().index_add_(0, node,
                                                                    add)
    failed = (pods.gang_id >= 0) & ~ok[pod_gang] & pods.valid
    return (final, state_before.replace(node_requested=node_requested), keep,
            failed)


def gang_assign(state: ClusterState, pods: PodBatch, cfg: ScoringConfig,
                gangs: GangInfo, quota=None, passes: int = 2,
                solver: str = "greedy", method: str = "auto"):
    """Batch assignment with gang all-or-nothing semantics.

    Returns (assignments, state, quota) as ``greedy_assign`` does.
    ``solver="greedy"`` is the exact sequential scan, ``"batch"`` the
    propose/accept solve; ``passes`` > 1 re-solves leftover pods after
    rollback so freed capacity is reclaimed within the batch."""
    if solver not in ("greedy", "batch"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "greedy" and method != "auto":
        # the sequential scan has no candidate stage
        raise ValueError('method applies only to solver="batch"')

    pre_ok = pre_enqueue_mask(pods, gangs)
    active_pods = pods.replace(valid=pods.valid & pre_ok)

    total = torch.full((pods.capacity,), -1, dtype=torch.int32,
                       device=pods.device)
    kept_so_far = torch.zeros(pods.capacity, dtype=torch.bool,
                              device=pods.device)
    cur_state, cur_quota = state, quota
    # estimated usage of pods kept in earlier passes (the reference's
    # pod-assign cache): later passes filter and score against it
    pod_est_all = pod_estimates(pods, cfg)
    est_accum = torch.zeros_like(state.node_usage)

    for _ in range(passes):
        solve_state = cur_state.replace(
            node_usage=cur_state.node_usage + est_accum,
            node_agg_usage=cur_state.node_agg_usage + est_accum)
        if solver == "batch":
            a, _, _ = batch_assign(solve_state, active_pods, cfg, cur_quota,
                                   method=method)
        else:
            a, _, _ = greedy_assign(solve_state, active_pods, cfg, cur_quota)

        final, cur_state, keep, failed = rollback_failed_gangs(
            a, cur_state, active_pods, gangs, prior_kept=kept_so_far)
        node = torch.where(keep, final, 0).long()
        est_accum.index_add_(0, node,
                             torch.where(keep[:, None], pod_est_all, 0))
        if cur_quota is not None:
            cur_quota = charge_quota_batch(
                cur_quota, active_pods.requests, active_pods.quota_id, keep,
                active_pods.non_preemptible)
        total = torch.where(keep, final, total)
        kept_so_far = kept_so_far | keep
        # still-unassigned pods stay in play; rolled-back gangs back off
        active_pods = active_pods.replace(
            valid=active_pods.valid & ~keep & ~failed)

    return total, cur_state, cur_quota
