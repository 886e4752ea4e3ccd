"""Schedule diagnosis: why a pod stayed pending (port of
``koordinator_tpu/scheduler/diagnosis.py``).

The reference's ``frameworkext/schedule_diagnosis.go:44-108``: when a pod
fails to place, report how many nodes each filter stage eliminated ("0/128
nodes available: 96 insufficient resources, 30 usage over threshold, 2
didn't match node selector") instead of a bare failure.

The scheduler builds a round's diagnoses from one reject-reason count over
the failed rows (``ops/explain.py`` ``explain_counts``,
:func:`diagnosis_from_counts`); with ``explain=False`` it recomputes each
failed pod's stage masks on the host instead (:func:`explain_pod`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.ops import explain as ex
from koordinator_tpu_torch.ops import filtering, scoring
from koordinator_tpu_torch.ops.assignment import ScoringConfig
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch


@dataclasses.dataclass
class PodDiagnosis:
    """Counts of nodes eliminated per stage (a node counts once, first-fail)."""

    total_nodes: int
    feasible_nodes: int
    insufficient_resources: int
    usage_over_threshold: int
    affinity_mismatch: int
    quota_rejected: bool
    invalid: int
    #: PostFilter outcome: the nominated node and victims when preemption
    #: helps (schedule_diagnosis.go records the same on the explanation)
    preempt_node: str | None = None
    preempt_victims: list[str] = dataclasses.field(default_factory=list)
    #: reject-reason counts keyed by ops/explain.REASON_NAMES (per-dim fit,
    #: threshold, affinity, and the pod-level gates the host fills); None
    #: when the explain accounting was off
    reason_counts: dict[str, int] | None = None

    def message(self) -> str:
        msg = self._base_message()
        if self.preempt_node is not None:
            victims = ", ".join(self.preempt_victims)
            msg += (f"; fits on {self.preempt_node} after preempting "
                    f"[{victims}]")
        return msg

    def _base_message(self) -> str:
        if self.quota_rejected:
            return "pod rejected by elastic quota admission"
        parts = []
        if self.insufficient_resources:
            parts.append(f"{self.insufficient_resources} insufficient resources")
        if self.usage_over_threshold:
            parts.append(f"{self.usage_over_threshold} usage over threshold")
        if self.affinity_mismatch:
            parts.append(f"{self.affinity_mismatch} didn't match node selector")
        detail = ", ".join(parts) if parts else "no failure recorded"
        return (f"{self.feasible_nodes}/{self.total_nodes} nodes available: "
                f"{detail}")


def explain_pod(
    state: ClusterState,
    pods: PodBatch,
    cfg: ScoringConfig,
    pod_idx: int,
    quota_admitted: bool = True,
) -> PodDiagnosis:
    """Stage-by-stage elimination breakdown for one pod of the batch,
    recomputed on the host."""
    req = pods.requests[pod_idx][None, :]
    pod_est = scoring.estimate_pod_usage_by_band(
        req, cfg.estimator_factors, cfg.estimator_defaults)
    valid = state.node_valid.cpu().numpy()
    total = int(valid.sum())

    fit = filtering.fit_mask(state.free, req)[0].cpu().numpy() & valid
    inst = filtering.usage_threshold_mask(
        state.node_usage, state.node_allocatable, cfg.usage_thresholds,
        pod_est)
    agg = filtering.usage_threshold_mask(
        state.node_agg_usage, state.node_allocatable,
        cfg.agg_usage_thresholds, pod_est)
    agg_enabled = bool(torch.any(cfg.agg_usage_thresholds > 0))
    thr = (agg if agg_enabled else inst)[0].cpu().numpy() & valid
    aff = pods.feasible_row(state, pod_idx).cpu().numpy() & valid

    feasible = fit & thr & aff
    # first-fail attribution, in filter order: fit -> thresholds -> affinity
    fail_fit = valid & ~fit
    fail_thr = valid & fit & ~thr
    fail_aff = valid & fit & thr & ~aff

    # per-dim first-fail fit counts (the host oracle of explain_counts)
    free = state.free.cpu().numpy()
    r = req.cpu().numpy()[0]
    dim_ok = (r[None, :] <= free) | (r[None, :] == 0)        # (N, R)
    fails = ~dim_ok
    prior = np.cumsum(fails, axis=-1) - fails
    ff = fails & (prior == 0)                                # (N, R)
    counts = {name: 0 for name in ex.REASON_NAMES}
    counts["node_invalid"] = int((~valid).sum())
    for d in range(ff.shape[1]):
        counts[ex.REASON_NAMES[ex.REASON_FIT_FIRST + d]] = int(
            (fail_fit & ff[:, d]).sum())
    counts["usage_threshold"] = int(fail_thr.sum())
    counts["affinity"] = int(fail_aff.sum())

    return PodDiagnosis(
        total_nodes=total,
        feasible_nodes=int(feasible.sum()) if quota_admitted else 0,
        insufficient_resources=int(fail_fit.sum()),
        usage_over_threshold=int(fail_thr.sum()),
        affinity_mismatch=int(fail_aff.sum()),
        quota_rejected=not quota_admitted,
        invalid=int((~valid).sum()),
        reason_counts=counts,
    )


def diagnosis_from_counts(
    counts: np.ndarray,      # (NUM_REASONS,) int: one pod's row of the counts
    feasible: int,
    total_nodes: int,
    quota_admitted: bool = True,
) -> PodDiagnosis:
    """A :class:`PodDiagnosis` from one row of ``ops/explain.explain_counts``
    (the batched replacement for :func:`explain_pod` per failed pod)."""
    # one conversion to Python ints a row (the scheduler calls this for
    # every failed pod of a round)
    row = np.asarray(counts).tolist()
    return PodDiagnosis(
        total_nodes=total_nodes,
        feasible_nodes=int(feasible) if quota_admitted else 0,
        insufficient_resources=sum(
            row[ex.REASON_FIT_FIRST:ex.REASON_USAGE_THRESHOLD]),
        usage_over_threshold=row[ex.REASON_USAGE_THRESHOLD],
        affinity_mismatch=row[ex.REASON_AFFINITY],
        quota_rejected=not quota_admitted,
        invalid=row[ex.REASON_NODE_INVALID],
        reason_counts=dict(zip(ex.REASON_NAMES, row)),
    )
