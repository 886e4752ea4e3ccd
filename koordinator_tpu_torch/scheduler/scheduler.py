"""The reduced batched scheduler of the port (from
``koordinator_tpu/scheduler/scheduler.py``).

One round, as the JAX ``Scheduler`` runs it with its defaults:

1. flush the snapshot's dirty node rows into the device state;
2. take the pending queue in (priority desc, creation, name) order and build
   the pod batch, with a stable per-pod-name rotation id (31-bit wrap).  An
   unchanged queue reuses the last batch whole; a changed one re-fills only
   the rows of new or re-specced pods (``_batch_cache``/``_batch_host``);
3. refresh the quota tree's requests and flatten it to device state;
4. solve.  Rounds under ``batch_solver_threshold`` pods take the exact
   greedy scan (K4).  Batch rounds with ``incremental_solve`` take the
   candidate cache: the first round selects over the whole (P, N) problem
   and warms it (``full_cold``), later rounds refresh it over the dirty
   nodes and pods (``incremental``, K2 plus K1 on the compacted dirty
   pods) unless the dirty fraction crosses
   ``incremental_dirty_threshold`` (``full_fallback``); the propose/accept
   passes after it equal ``gang_assign``'s bit for bit.  Without
   ``incremental_solve`` a batch round calls ``gang_assign`` (``disabled``);
5. rescue the batch solver's leftovers with the exact greedy scan over a
   compacted batch;
6. adopt the solved state (marking the assigned rows dirty for the cache),
   then bind: record the assignment, charge the quota tree's ``used``, call
   ``bind_fn``.

``last_solve_path`` names the path of the last round: the JAX scheduler's
names for batch rounds, and ``greedy`` for a round under the threshold
(the JAX scheduler leaves the attribute as it was on such a round and
labels its latency metric ``greedy``).

Left out of this reduced shell, and kept by the JAX scheduler: gang
registration and the WaitTime machine (every batch carries an empty
``GangInfo``, as the JAX round does when no gang is registered), hints and
their dense masks, reservations, preemption, forecast and quality modes,
degraded mode, tenancy, the solve mesh, and the journey, timeline and
metrics hooks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.ops import batch_assign as ba
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
                 batch_solver_threshold: int = 1024,
                 incremental_solve: bool = True, device=None):
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
        #: stable per-pod-name rotation ids (PodBatch.rot_id): a pod keeps
        #: its candidate tie-break when the queue shifts around it (the
        #: candidate cache's row independence depends on this)
        self._rot_ids: dict[str, int] = {}
        self._rot_counter = 0
        #: bumped by every queue mutation; keys the whole-batch reuse
        self._pending_rev = 0
        self._batch_cache: tuple[tuple, PodBatch] | None = None
        self.batch_rebuilds = 0
        #: host arrays and name -> row / spec maps of the last batch build,
        #: for row-level reuse and the candidate cache's row mapping
        self._batch_host: dict | None = None

        # -- incremental delta-driven solve (gangless batch rounds) --
        self.incremental_solve = incremental_solve
        self.incremental_dirty_threshold = 0.25
        # candidate selection (k, strata, rounds, method "auto", which is
        # "exact" off the TPU) takes batch_assign's defaults, as
        # gang_assign's full rounds do, so both paths solve one problem
        self._cand_cache: dict | None = None
        #: which path the last round took: full_cold | incremental |
        #: full_fallback | disabled (batch rounds), greedy, or none
        self.last_solve_path = "none"
        #: the dirty node and pod fractions the last round's cache saw
        self.last_dirty_node_frac = 0.0
        self.last_dirty_pod_frac = 0.0

    # -- queue ----------------------------------------------------------------

    def enqueue(self, pod: PodSpec) -> None:
        self.pending[pod.name] = pod
        self._pending_rev += 1

    def enqueue_many(self, pods: list[PodSpec]) -> None:
        for pod in pods:
            self.enqueue(pod)

    def dequeue(self, pod_name: str) -> None:
        if self.pending.pop(pod_name, None) is not None:
            self._pending_rev += 1

    def _active_pods(self) -> list[PodSpec]:
        return sorted(self.pending.values(),
                      key=lambda p: (-p.priority, p.creation, p.name))

    # -- batch and quota --------------------------------------------------------

    def _build_batch(self, pods: list[PodSpec],
                     quota_index: dict[str, int]) -> PodBatch:
        # cache key: everything that feeds the batch tensors.  _pending_rev
        # covers pod contents (mutations go through enqueue/dequeue), the
        # name tuple the active set, capacity node-array growth, class_count
        # new label/taint equivalence classes
        key = (
            self._pending_rev,
            tuple(pod.name for pod in pods),
            tuple(sorted(quota_index.items())),
            self.snapshot.capacity,
            self.snapshot.class_count,
        )
        if self._batch_cache is not None and self._batch_cache[0] == key:
            return self._batch_cache[1]
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

        # row-level reuse: an incremental queue change re-fills only the
        # rows whose pod is new or re-specced; unchanged rows gather from
        # the last build's host arrays in one vectorised copy.  Valid only
        # while the quota index and the selector classes are unchanged:
        # they parameterise row CONTENT
        c_cap = self.snapshot.class_capacity
        prev = self._batch_host
        reuse_ok = (
            prev is not None
            and prev["quota_index"] == quota_index
            and prev["class_cap"] == c_cap
            # the class COUNT: a new class within the same bucket changes
            # every pod's selector row (the new class's column)
            and prev["class_count"] == self.snapshot.class_count
            and prev["dims"] == dims
        )
        sel = np.zeros((p, c_cap), bool)
        fill_rows: list[int] = []
        if reuse_ok:
            src, dst = [], []
            prev_row, prev_spec = prev["row_of"], prev["specs"]
            for i, pod in enumerate(pods):
                j = prev_row.get(pod.name)
                if j is not None and prev_spec.get(pod.name) is pod:
                    src.append(j)
                    dst.append(i)
                else:
                    fill_rows.append(i)
            if dst:
                src_a, dst_a = np.asarray(src), np.asarray(dst)
                requests[dst_a] = prev["requests"][src_a]
                priority[dst_a] = prev["priority"][src_a]
                qos[dst_a] = prev["qos"][src_a]
                quota_id[dst_a] = prev["quota_id"][src_a]
                non_preempt[dst_a] = prev["non_preempt"][src_a]
                sel[dst_a] = prev["sel"][src_a]
        else:
            fill_rows = list(range(p))

        memo: dict[tuple, np.ndarray] = {}
        for i in fill_rows:
            pod = pods[i]
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
        batch = PodBatch.build(
            requests, priority=priority, qos=qos, quota_id=quota_id,
            non_preemptible=non_preempt, selector_mask=sel,
            class_capacity=c_cap, node_capacity=self.snapshot.capacity,
            capacity=cap, rot_id=rot, device=self.device)
        self._batch_cache = (key, batch)
        self._batch_host = {
            "row_of": {pod.name: i for i, pod in enumerate(pods)},
            "specs": {pod.name: pod for pod in pods},
            "requests": requests, "priority": priority, "qos": qos,
            "quota_id": quota_id, "non_preempt": non_preempt, "sel": sel,
            "quota_index": dict(quota_index),
            "class_cap": c_cap,
            "class_count": self.snapshot.class_count,
            "dims": dims,
        }
        self.batch_rebuilds += 1
        return batch

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
        self.last_dirty_node_frac = 0.0
        self.last_dirty_pod_frac = 0.0
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
        # the incremental path takes every gangless batch round with a
        # factored selector mask, which is every batch round of this shell
        use_inc = (solver == "batch" and self.incremental_solve
                   and batch.selector_mask is not None)
        if use_inc:
            assignments, new_state, new_quota = (
                self._solve_batch_incremental(pods, batch, quota))
        else:
            self.last_solve_path = "disabled" if solver == "batch" else "greedy"
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
        self.snapshot.adopt_state(new_state,
                                  changed_rows=np.unique(a[a >= 0]))

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

    # -- the incremental candidate cache --------------------------------------

    def _select(self, state, batch: PodBatch, k: int):
        return ba.select_candidates(state, batch, self.config, k=k,
                                    with_scores=True)

    def _solve_batch_incremental(self, pods: list[PodSpec],
                                 batch: PodBatch, quota):
        """The incremental solve, dispatch then finish: returns
        (assignments, new_state, new_quota) like gang_assign."""
        return self._finish_batch_incremental(
            self._dispatch_batch_incremental(pods, batch, quota))

    def _dispatch_batch_incremental(self, pods: list[PodSpec],
                                    batch: PodBatch, quota) -> dict:
        """Candidate refresh or selection, then the first solve pass.

        Steady state: only dirty rows are rescored (pods new or re-specced,
        or whose cached candidates touch a dirty node) against the dirty
        node columns the snapshot accumulated, and merged into the cached
        (P, k) candidates (K2).  When the dirty fraction crosses
        ``incremental_dirty_threshold``, or no valid cache exists, the full
        selection runs instead and re-warms the cache.  The passes after it
        mirror gang_assign's gangless pass loop bit for bit, so the path
        never changes a decision.  Returns the finish context."""
        snap = self.snapshot
        n = snap.capacity
        k = min(ba.CAND_K, n)
        meta = self._cand_cache
        cache_ok = (
            meta is not None
            and meta["n"] == n
            # identity of the OBJECT: a replaced config invalidates
            and meta["cfg"] is self.config
        )
        # consumed once per cache rebuild or refresh: both branches below
        # leave a cache that reflects the post-consume state
        dirty_rows = [r for r in snap.consume_candidate_dirty() if r < n]

        path = "full_cold"
        cache = None
        if cache_ok:
            node_frac = len(dirty_rows) / max(len(snap.node_index), 1)
            row_of, specs = meta["row_of"], meta["specs"]
            map_rows = np.zeros(batch.capacity, np.int32)
            map_ok = np.zeros(batch.capacity, bool)
            changed = np.zeros(batch.capacity, bool)
            for i, pod in enumerate(pods):
                j = row_of.get(pod.name)
                if j is not None and specs.get(pod.name) is pod:
                    map_rows[i] = j
                    map_ok[i] = True
                else:
                    changed[i] = True
            dirty_np = np.zeros(n, bool)
            dirty_np[dirty_rows] = True
            dpad = _bucket(max(len(dirty_rows), 1), minimum=64)
            drows = np.zeros(dpad, np.int32)
            drows[: len(dirty_rows)] = dirty_rows
            dvalid = np.zeros(dpad, bool)
            dvalid[: len(dirty_rows)] = True

            def dev(a):
                return torch.from_numpy(a).to(self.device)

            aligned, touch = ba.align_candidate_cache(
                meta["cache"], dev(map_rows), dev(map_ok), dev(dirty_np))
            dirty_pods = changed | touch.cpu().numpy()
            pod_frac = float(dirty_pods.sum()) / max(len(pods), 1)
            self.last_dirty_node_frac = node_frac
            self.last_dirty_pod_frac = pod_frac
            if max(node_frac, pod_frac) <= self.incremental_dirty_threshold:
                path = "incremental"
                _, cache = ba.refresh_candidates(
                    snap.state, batch, self.config, aligned, dev(drows),
                    dev(dvalid), k=k)
                if dirty_pods.any():
                    small, idx = batch.compact(dirty_pods)
                    sk, sn, ss = self._select(snap.state, small, k)
                    rows_pad = np.full(small.capacity, batch.capacity,
                                       np.int32)
                    rows_pad[: len(idx)] = idx
                    cache = ba.scatter_candidate_rows(
                        cache, dev(rows_pad), sk, sn, ss)
            else:
                path = "full_fallback"
        if cache is None:
            cache = ba.CandidateCache(*self._select(snap.state, batch, k))
        # the batch build already made this round's name -> row and spec
        # maps for its own row reuse: share them
        host = self._batch_host
        self._cand_cache = {
            "cache": cache, "row_of": host["row_of"], "specs": host["specs"],
            "n": n, "cfg": self.config,
        }
        self.last_solve_path = path
        try:
            a, state, quota, est_accum = ba.assign_round_pass(
                snap.state, batch, quota, cache.cand_key, cache.cand_node,
                self.config)
        except Exception:
            self._cand_cache = None
            raise
        return {"a": a, "state": state, "quota": quota,
                "est_accum": est_accum, "batch": batch, "k": k}

    def _finish_batch_incremental(self, ctx: dict):
        """The later passes, each full-selecting over the COMPACTED
        leftovers (small x N, not P x N) against the est-augmented state.
        Returns (assignments, new_state, new_quota) like gang_assign."""
        batch = ctx["batch"]
        state, quota, est_accum = ctx["state"], ctx["quota"], ctx["est_accum"]
        a_np = ctx["a"].cpu().numpy()
        valid = batch.valid.cpu().numpy()
        try:
            for _ in range(1, self.gang_passes):
                leftover = valid & (a_np < 0)
                if not leftover.any():
                    break
                small, idx = batch.compact(leftover)
                a2, state, quota, est_accum = ba.assign_followup_pass(
                    state, est_accum, small, quota, self.config, k=ctx["k"])
                a2_np = a2.cpu().numpy()[: len(idx)]
                placed = a2_np >= 0
                if not placed.any():
                    break
                a_np[idx[placed]] = a2_np[placed]
        except Exception:
            self._cand_cache = None
            raise
        return torch.from_numpy(a_np).to(self.device), state, quota

    def _commit_binds(self, binds, result: SchedulingResult) -> None:
        """Record the binds, charge each quota's ``used`` once per
        (quota, non-preemptible) group, then call ``bind_fn`` per pod."""
        for pod, node in binds:
            result.assignments[pod.name] = node
            if self.pending.pop(pod.name, None) is not None:
                self._pending_rev += 1
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
