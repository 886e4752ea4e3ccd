"""The reduced batched scheduler of the port (from
``koordinator_tpu/scheduler/scheduler.py``).

One round, as the JAX ``Scheduler(..., incremental_solve=False)`` runs it on
its full-solve path:

1. flush the snapshot's dirty node rows into the device state;
2. take the pending queue in (priority desc, creation, name) order and build
   the pod batch, with a stable per-pod-name rotation id (31-bit wrap);
3. refresh the quota tree's requests and flatten it to device state;
4. solve with ``gang_assign`` — the data-parallel batch solver for rounds of
   ``batch_solver_threshold`` pods or more, the exact greedy scan below it;
5. rescue the batch solver's leftovers with the exact greedy scan over a
   compacted batch;
6. adopt the solved state, then bind: record the assignment, charge the
   quota tree's ``used``, call ``bind_fn``.

Left out of this reduced shell, and kept by the JAX scheduler: the
incremental candidate cache, gang registration and the WaitTime machine
(every batch carries an empty ``GangInfo``, as the JAX round does when no
gang is registered), reservations, preemption, hints, forecast and quality
modes, tenancy, the solve mesh, and the journey, timeline and metrics hooks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.ops.assignment import ScoringConfig
from koordinator_tpu_torch.ops.gang import GangInfo, gang_assign
from koordinator_tpu_torch.quota.admission import (
    QuotaDeviceState,
    quota_admission_mask,
)
from koordinator_tpu_torch.quota.tree import QuotaTree
from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot, PodSpec
from koordinator_tpu_torch.state.cluster_state import PodBatch, _bucket


@dataclasses.dataclass
class SchedulingResult:
    assignments: dict[str, str]   # pod -> node
    failures: dict[str, str]      # pod -> short reason
    round_pods: int = 0
    #: pods the greedy rescue pass placed (batch rounds only)
    rescued: int = 0


class Scheduler:
    """Batched scheduler over a :class:`ClusterSnapshot`.  Tensors live on
    the snapshot's device."""

    def __init__(self, snapshot: ClusterSnapshot,
                 config: ScoringConfig | None = None,
                 quota_tree: QuotaTree | None = None,
                 bind_fn=None, gang_passes: int = 2,
                 batch_solver_threshold: int = 1024, device=None):
        if device is not None and torch.device(device) != snapshot.device:
            raise ValueError(f"device {device} differs from the snapshot's "
                             f"{snapshot.device}")
        self.snapshot = snapshot
        self.device = snapshot.device
        self.config = (config if config is not None
                       else ScoringConfig.default(self.device))
        self.quota_tree = quota_tree
        self.bind_fn = bind_fn
        self.gang_passes = gang_passes
        self.batch_solver_threshold = batch_solver_threshold
        self.pending: dict[str, PodSpec] = {}
        #: which solve engine the last round used ("greedy"/"batch")
        self.last_solver = "greedy"
        #: stable per-pod-name rotation ids (PodBatch.rot_id)
        self._rot_ids: dict[str, int] = {}
        self._rot_counter = 0

    # -- queue ----------------------------------------------------------------

    def enqueue(self, pod: PodSpec) -> None:
        self.pending[pod.name] = pod

    def enqueue_many(self, pods: list[PodSpec]) -> None:
        for pod in pods:
            self.pending[pod.name] = pod

    def dequeue(self, pod_name: str) -> None:
        self.pending.pop(pod_name, None)

    def _active_pods(self) -> list[PodSpec]:
        return sorted(self.pending.values(),
                      key=lambda p: (-p.priority, p.creation, p.name))

    # -- batch and quota --------------------------------------------------------

    def _build_batch(self, pods: list[PodSpec],
                     quota_index: dict[str, int]) -> PodBatch:
        p = len(pods)
        dims = self.snapshot.dims
        cap = _bucket(max(p, 1), minimum=16)
        requests = np.zeros((p, dims), np.int32)
        priority = np.zeros(p, np.int32)
        qos = np.zeros(p, np.int8)
        quota_id = np.full(p, -1, np.int32)
        non_preempt = np.zeros(p, bool)
        rot = np.zeros(p, np.int32)

        # stable rotation ids: a pod keeps its candidate tie-break when the
        # queue shifts around it; the registry is pruned against the live
        # queue so a long-lived scheduler doesn't leak
        if len(self._rot_ids) > 4 * max(len(self.pending), 64):
            live = set(self.pending)
            self._rot_ids = {name: rid for name, rid in self._rot_ids.items()
                             if name in live}
        for i, pod in enumerate(pods):
            rid = self._rot_ids.get(pod.name)
            if rid is None:
                rid = self._rot_ids[pod.name] = self._rot_counter
                # 31-bit wrap: the id is a modular rotation identity
                self._rot_counter = (self._rot_counter + 1) & 0x7FFFFFFF
            rot[i] = rid

        c_cap = self.snapshot.class_capacity
        sel = np.zeros((p, c_cap), bool)
        memo: dict[tuple, np.ndarray] = {}
        for i, pod in enumerate(pods):
            requests[i] = pod.requests
            priority[i] = pod.priority
            qos[i] = pod.qos
            if pod.quota is not None and pod.quota in quota_index:
                quota_id[i] = quota_index[pod.quota]
            non_preempt[i] = pod.non_preemptible
            sel_key = (tuple(sorted(pod.node_selector.items())),
                       tuple(sorted(pod.tolerations.items())))
            row = memo.get(sel_key)
            if row is None:
                row = memo[sel_key] = self.snapshot.selector_row_for(pod)
            sel[i] = row
        return PodBatch.build(
            requests, priority=priority, qos=qos, quota_id=quota_id,
            non_preemptible=non_preempt, selector_mask=sel,
            class_capacity=c_cap, node_capacity=self.snapshot.capacity,
            capacity=cap, rot_id=rot, device=self.device)

    def _refresh_quota_tree(self) -> None:
        """A leaf quota's request is its admitted usage plus its pending
        pods' requests; then re-derive runtime."""
        pending: dict[str, np.ndarray] = {}
        for pod in self.pending.values():
            if pod.quota is not None and pod.quota in self.quota_tree.nodes:
                cur = pending.setdefault(
                    pod.quota, np.zeros(self.snapshot.dims, np.int64))
                cur += pod.requests.astype(np.int64)
        zero = np.zeros(self.snapshot.dims, np.int64)
        for name, qnode in self.quota_tree.nodes.items():
            if self.quota_tree.children[name]:
                continue  # parents aggregate from children
            self.quota_tree.set_request(name,
                                        qnode.used + pending.get(name, zero))
        self.quota_tree.refresh_runtime()

    def _build_quota(self) -> tuple[QuotaDeviceState | None, dict[str, int]]:
        if self.quota_tree is None:
            return None, {}
        self._refresh_quota_tree()
        return QuotaDeviceState.from_tree(self.quota_tree, device=self.device)

    # -- the round ----------------------------------------------------------

    def schedule_round(self) -> SchedulingResult:
        """Solve the current pending queue; reserve, bind."""
        result = SchedulingResult({}, {}, 0)
        self.snapshot.flush()
        pods = self._active_pods()
        if not pods:
            return result
        quota, quota_index = self._build_quota()
        batch = self._build_batch(pods, quota_index)
        gangs = GangInfo.build(np.zeros(0, np.int32), device=self.device)
        solver = ("batch" if len(pods) >= self.batch_solver_threshold
                  else "greedy")
        self.last_solver = solver
        assignments, new_state, new_quota = gang_assign(
            self.snapshot.state, batch, self.config, gangs, quota,
            passes=self.gang_passes, solver=solver)

        a = assignments.cpu().numpy()
        leftover = batch.valid.cpu().numpy() & (a < 0)
        if solver == "batch" and bool(leftover[: len(pods)].any()):
            # exact rescue over the compacted leftovers: the batch engine's
            # top-k/round approximation may fail pods a greedy scan places
            small, idx = batch.compact(leftover)
            r_small, new_state, new_quota = gang_assign(
                new_state, small, self.config, gangs, new_quota,
                passes=self.gang_passes, solver="greedy")
            r = r_small.cpu().numpy()[: len(idx)]
            result.rescued = int((r >= 0).sum())
            a = a.copy()
            a[idx] = np.where(a[idx] >= 0, a[idx], r)
        result.round_pods = len(pods)
        self.snapshot.adopt_state(new_state)

        binds = []
        for i, pod in enumerate(pods):
            if int(a[i]) >= 0:
                binds.append((pod, self.snapshot.node_name(int(a[i]))))
        self._commit_binds(binds, result)

        fail_rows = [i for i, _ in enumerate(pods) if int(a[i]) < 0]
        if fail_rows:
            admitted = None
            if new_quota is not None:
                admitted = quota_admission_mask(
                    new_quota, batch.requests, batch.quota_id,
                    batch.non_preemptible).cpu().numpy()
            for i in fail_rows:
                result.failures[pods[i].name] = (
                    "quota" if admitted is not None and not admitted[i]
                    else "no feasible node")
        return result

    def _commit_binds(self, binds, result: SchedulingResult) -> None:
        """Record the binds, charge each quota's ``used`` once per
        (quota, non-preemptible) group, then call ``bind_fn`` per pod."""
        for pod, node in binds:
            result.assignments[pod.name] = node
            self.pending.pop(pod.name, None)
        if self.quota_tree is not None:
            groups: dict[tuple[str, bool], list[np.ndarray]] = {}
            for pod, _node in binds:
                if pod.quota and pod.quota in self.quota_tree.nodes:
                    groups.setdefault((pod.quota, bool(pod.non_preemptible)),
                                      []).append(pod.requests)
            for (name, non_preemptible), reqs in groups.items():
                q = self.quota_tree.nodes[name]
                total = np.sum(np.stack(reqs).astype(np.int64), axis=0)
                q.used = q.used + total
                if non_preemptible:
                    q.non_preemptible_used = q.non_preemptible_used + total
        if self.bind_fn is not None:
            for pod, node in binds:
                self.bind_fn(pod.name, node)
