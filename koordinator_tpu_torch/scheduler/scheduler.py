"""The reduced batched scheduler of the port (from
``koordinator_tpu/scheduler/scheduler.py``).

One round, as the JAX ``Scheduler`` runs it with its defaults:

1. flush the snapshot's dirty node rows into the device state; when any
   Reservation exists, run its tick: expire by TTL, fail those whose node
   instance is gone, open a pinned one whose node has room (charging it),
   and queue a synthetic reserve-pod ``rsv::<name>`` (priority 9000) for
   every other Pending one;
2. PreEnqueue: skip the pods of rejected gangs; take the rest in
   (priority desc, creation, name) order, index the round's gangs (sorted
   names, ``min_member`` 0 for a name no PodGroup registered, gang
   groups) and build the pod batch, with a gang id a pod and a stable
   per-pod-name rotation id (31-bit wrap).  An unchanged queue reuses the
   last batch whole; a changed one re-fills only the rows of new or
   re-specced pods (``_batch_cache``/``_batch_host``);
3. refresh the quota tree's requests and flatten it to device state;
   with an Available reservation that has something left, the
   reservation pre-pass: up to ``rsv_prepass_cap`` owner-matched pods
   (highest priority first) take the reservation-first exact scan (K4r,
   ``ops/reservation.py`` ``reservation_greedy_assign``), draw from their
   reservations and bind; their rows leave the batch;
4. solve.  Rounds under ``batch_solver_threshold`` pods (counted before
   the pre-pass) take the exact
   greedy scan (K4).  A batch round with any gang calls ``gang_assign``
   (``full_gang``: all-or-nothing per gang and gang group, rolled back
   and re-solved over ``gang_passes`` passes).  Gangless batch rounds
   with ``incremental_solve`` take the
   candidate cache: the first round selects over the whole (P, N) problem
   and warms it (``full_cold``), later rounds refresh it over the dirty
   nodes and pods (``incremental``, K2 plus K1 on the compacted dirty
   pods) unless the dirty fraction crosses
   ``incremental_dirty_threshold`` (``full_fallback``); the propose/accept
   passes after it equal ``gang_assign``'s bit for bit.  Without
   ``incremental_solve`` a batch round calls ``gang_assign`` (``disabled``).
   ``cand_method`` picks the candidate method of the incremental path's
   selections and its second pass only (``approx`` and ``chunked`` run
   K1a); the full paths and the rescue select with ``auto`` (``exact``),
   as the JAX scheduler's do;
5. rescue the batch solver's leftovers with the exact greedy scan over a
   compacted batch, with the round's gangs: members of gangs rolled back
   come back whole, and the surplus members of a gang already satisfied
   this round rescue as gangless pods;
6. adopt the solved state (marking the assigned rows dirty for the cache),
   then bind: a placed reserve-pod makes its reservation Available (the
   solve already charged its vector); every other pod is recorded in the
   ``bound`` registry, charges the quota tree's ``used`` and goes to
   ``bind_fn``;
7. the gang WaitTime machine (Permit's timeout): a gang with a failed
   member and none placed this round starts its wait at its first such
   round and is rejected once ``wait_time_sec`` has passed since; a gang
   with a member placed clears its wait.

Removing a bound pod (:meth:`Scheduler.delete_pod`,
:meth:`Scheduler.remove_bound_pod`) returns what it drew from a
reservation to that reservation and frees only the rest of its request;
removing or expiring a reservation returns its remainder to the node.

``last_solve_path`` names the path of the last round: the JAX scheduler's
names for batch rounds, and ``greedy`` for a round under the threshold
(the JAX scheduler leaves the attribute as it was on such a round and
labels its latency metric ``greedy``).

Left out of this reduced shell, and kept by the JAX scheduler: gangs with
network-topology requirements (``register_gang`` refuses them: the
topology planner waits for ``ops/network_topology.py``), explanations, the
auditor's per-workload attempts and Diagnose's per-reason counts (failures
carry a short reason), hints and their dense masks, preemption and
nominations, the fine-grained CPU and device allocators, forecast and
quality modes, degraded mode, tenancy, the solve mesh, and the journey,
timeline and metrics hooks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from koordinator_tpu_torch.ops import batch_assign as ba
from koordinator_tpu_torch.ops.assignment import ScoringConfig
from koordinator_tpu_torch.ops.gang import GangInfo, gang_assign
from koordinator_tpu_torch.ops.reservation import reservation_greedy_assign
from koordinator_tpu_torch.quota.admission import (
    QuotaDeviceState,
    quota_admission_mask,
)
from koordinator_tpu_torch.quota.tree import QuotaTree
from koordinator_tpu_torch.scheduler.reservations import (
    ReservationCache,
    ReservationPhase,
)
from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot, PodSpec
from koordinator_tpu_torch.state.cluster_state import PodBatch, _bucket

#: pending-queue key prefix for synthetic reserve-pods (koordinator models a
#: Reservation as a pod the scheduler places; reservation_types.go)
RSV_POD_PREFIX = "rsv::"


@dataclasses.dataclass(slots=True)
class BoundPod:
    """Host record of a bound pod: its spec and where it went (one is made
    per bind, so it holds the spec instead of copying its fields)."""

    pod: PodSpec
    node: str
    #: snapshot.node_generation at bind time: the node INSTANCE this pod
    #: was charged to (a release after the node was removed and re-added
    #: under the same name must not decrement the fresh instance)
    node_generation: int = 0
    #: reservation this pod allocated from, and how much it drew: freeing
    #: the pod returns the drawn part to the reservation remainder (the
    #: node keeps the reservation's charge) and frees only the spill
    reservation: str | None = None
    rsv_drawn: np.ndarray | None = None
    rsv_generation: int = 0

    @property
    def name(self) -> str:
        return self.pod.name

    @property
    def requests(self) -> np.ndarray:
        return self.pod.requests

    @property
    def quota(self) -> str | None:
        return self.pod.quota

    @property
    def non_preemptible(self) -> bool:
        return self.pod.non_preemptible


@dataclasses.dataclass
class GangRecord:
    """Host-side gang state (PodGroup + gang annotations)."""

    name: str
    min_member: int
    group: str | None = None
    #: None = inherit the scheduler's default (CoschedulingArgs
    #: DefaultTimeout; 600 s like the reference)
    wait_time_sec: float | None = None
    first_failure: float | None = None
    rejected: bool = False
    #: network-topology gather requirements (not ported: register_gang
    #: refuses a record that sets them)
    topology: object | None = None


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
                 gang_default_timeout_sec: float = 600.0,
                 batch_solver_threshold: int = 1024,
                 incremental_solve: bool = True, device=None,
                 clock=time.monotonic):
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
        #: CoschedulingArgs.DefaultTimeout: WaitTime for gangs that don't
        #: set their own
        self.gang_default_timeout_sec = gang_default_timeout_sec
        #: registered gangs by name
        self.gangs: dict[str, GangRecord] = {}
        #: the pods PreEnqueue held back last round (their gang rejected)
        self._last_gang_rejected_names: list[str] = []
        self.batch_solver_threshold = batch_solver_threshold
        self.clock = clock
        self.pending: dict[str, PodSpec] = {}
        #: bound pods by name (what remove_bound_pod releases)
        self.bound: dict[str, BoundPod] = {}
        #: the Reservation lifecycle: reserve-pods place through the normal
        #: rounds, Available reservations get the pre-pass
        self.reservations = ReservationCache()
        #: owner-matched pods the pre-pass takes a round at most, highest
        #: priority first (the rest solve normally and may draw next round)
        self.rsv_prepass_cap = 2048
        self._rsv_match_cache: tuple[tuple, np.ndarray] | None = None
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
        # candidate selection (k, strata, rounds) takes batch_assign's
        # defaults, as gang_assign's full rounds do, so both paths solve
        # one problem.  The method applies to the incremental path only:
        # "auto" is "exact" (the JAX scheduler's "approx" is for a TPU)
        self.cand_method = "auto"
        self._cand_cache: dict | None = None
        #: which path the last round took: full_cold | incremental |
        #: full_fallback | disabled (batch rounds), greedy, or none
        self.last_solve_path = "none"
        #: the dirty node and pod fractions the last round's cache saw
        self.last_dirty_node_frac = 0.0
        self.last_dirty_pod_frac = 0.0

    # -- registration -----------------------------------------------------------

    def register_gang(self, record: GangRecord) -> None:
        if record.topology is not None:
            raise ValueError(
                f"gang {record.name!r}: network-topology requirements are "
                "not ported (ROADMAP A7: ops/network_topology.py)")
        if record.wait_time_sec is None:
            record.wait_time_sec = self.gang_default_timeout_sec
        self.gangs[record.name] = record

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

    # -- bound pods -------------------------------------------------------------

    def delete_pod(self, name: str) -> None:
        """Informer pod delete, whatever state the pod is in: a pending pod
        is dequeued; a bound pod releases its node charge and its quota
        charge."""
        if name in self.pending:
            self.dequeue(name)
        bound = self.bound.get(name)
        if bound is not None:
            self.remove_bound_pod(name)
            self._charge_quota_used(bound, sign=-1)

    def remove_bound_pod(self, name: str) -> None:
        """Release a bound pod's node charge iff still tracked (its quota
        charge stays with the caller).  A pod that allocated through a
        reservation gives its drawn vector back to the reservation's
        remainder (the reserved capacity stays charged to the node, hidden
        from non-owners) and frees only its spill; once the reservation is
        gone or consumed, the drawn part frees with the pod."""
        pod = self.bound.pop(name, None)
        if pod is not None:
            self._release_bound_capacity(pod)

    def _release_bound_capacity(self, bp: BoundPod) -> None:
        if bp.node not in self.snapshot.node_index:
            return
        if (self.snapshot.node_generation.get(bp.node, 0)
                != bp.node_generation):
            # the node this pod was charged to is gone; the same name now
            # labels a fresh instance that started clean
            return
        free_vec = bp.requests
        if bp.reservation is not None and bp.rsv_drawn is not None:
            drawn = bp.rsv_drawn.astype(np.int64)
            if self.reservations.return_allocation(
                    bp.reservation, drawn, bp.rsv_generation):
                free_vec = np.maximum(bp.requests.astype(np.int64) - drawn,
                                      0)
            else:
                free_vec = np.maximum(bp.requests.astype(np.int64), drawn)
        self.snapshot.unreserve(bp.node, free_vec.astype(np.int32))

    def _charge_quota_used(self, pod, sign: int) -> None:
        if (pod.quota and self.quota_tree is not None
                and pod.quota in self.quota_tree.nodes):
            q = self.quota_tree.nodes[pod.quota]
            q.used = q.used + sign * pod.requests.astype(np.int64)
            if pod.non_preemptible:
                q.non_preemptible_used = (
                    q.non_preemptible_used
                    + sign * pod.requests.astype(np.int64))

    # -- reservations -------------------------------------------------------------

    def add_reservation(self, spec) -> None:
        """Accept a Reservation CR: placement happens next round (a pinned
        node goes Available directly; otherwise a reserve-pod schedules
        through the normal solve).

        Re-applying an existing name is an update: if the placed charge is
        unchanged (same requests, same pin) only the mutable spec fields
        move; otherwise the old reservation is removed first (returning its
        remainder) so the new one cannot double-charge the node."""
        spec.created_at = self.clock()
        old = self.reservations.get(spec.name)
        if old is not None and old.phase in (ReservationPhase.AVAILABLE,
                                             ReservationPhase.SUCCEEDED):
            if (np.array_equal(old.requests, spec.requests)
                    and spec.node in (None, old.node)):
                old.owners = spec.owners
                old.ttl_sec = spec.ttl_sec
                old.restricted = spec.restricted
                # owner edits change who matches
                self._rsv_match_cache = None
                return
            self.remove_reservation(spec.name)
        self.reservations.upsert(spec)
        # a still-queued reserve-pod carries the OLD requests: drop it so
        # the next tick queues the updated one
        if self.pending.pop(RSV_POD_PREFIX + spec.name, None) is not None:
            self._pending_rev += 1

    def remove_reservation(self, name: str) -> None:
        """Reservation CR deleted: return the unallocated remainder and
        drop any queued reserve-pod."""
        self.reservations.remove(name, self.snapshot)
        if self.pending.pop(RSV_POD_PREFIX + name, None) is not None:
            self._pending_rev += 1

    def _reservation_tick(self, now: float) -> None:
        """Expire reservations; move Pending ones toward Available (pinned
        node: directly, after a fit check; else queue a reserve-pod)."""
        self.reservations.fail_stale_instances(self.snapshot)
        for name in self.reservations.expire_tick(now, self.snapshot):
            # a Pending reservation that expired drops its reserve-pod too
            if self.pending.pop(RSV_POD_PREFIX + name, None) is not None:
                self._pending_rev += 1
        # terminal specs are settled: purge them
        self.reservations.gc()
        for spec in self.reservations.pending():
            if spec.node is not None:
                # pinned: Available only if it fits (make_available charges
                # the node; the un-pinned path gets its fit check from the
                # reserve-pod's solve)
                row = self.snapshot.node_index.get(spec.node)
                if row is None:
                    continue
                state = self.snapshot.state
                free = (state.node_allocatable[row].cpu().numpy()
                        - state.node_requested[row].cpu().numpy())
                if np.all(spec.requests <= free):
                    self.reservations.make_available(
                        spec.name, spec.node, self.snapshot, now)
                continue
            key = RSV_POD_PREFIX + spec.name
            if key not in self.pending:
                self.pending[key] = PodSpec(
                    name=key, requests=spec.requests.astype(np.int32),
                    priority=9000, node_selector=dict(spec.node_selector),
                    tolerations=dict(spec.tolerations))
                self._pending_rev += 1

    def _reservation_prepass(self, pods: list[PodSpec], batch: PodBatch,
                             quota, result: SchedulingResult):
        """Reservation-first exact solve over owner-matched pods: they
        allocate from their reservations' remainders before the general
        solve sees them.  Returns the batch with their rows made invalid,
        and the quota they were charged to."""
        avail = self.reservations.available()
        if not avail:
            return batch, quota
        # fully consumed reservations have nothing to lend
        if not any(np.any(s.requests > s.allocated) for s in avail
                   if s.allocated is not None):
            return batch, quota
        rsv_set, names = self.reservations.build_set(self.snapshot)
        # the owner matching is cached between rounds over an unchanged
        # queue (its row order too) and reservation set (owner edits clear
        # the cache in add_reservation)
        mkey = (self._pending_rev, tuple(p.name for p in pods),
                tuple(s.generation for s in avail))
        cached = self._rsv_match_cache
        if cached is not None and cached[0] == mkey:
            match = cached[1]
        else:
            match = self.reservations.match_matrix(
                pods, batch.capacity, rsv_set.capacity)
            # reserve-pods cannot consume reservations; gang members keep
            # all-or-nothing semantics in the main solve
            for i, pod in enumerate(pods):
                if pod.name.startswith(RSV_POD_PREFIX) or pod.gang:
                    match[i] = False
            self._rsv_match_cache = (mkey, match)
        matched = batch.valid.cpu().numpy() & match.any(axis=1)
        if not matched.any():
            return batch, quota
        if int(matched.sum()) > self.rsv_prepass_cap:
            prio = batch.priority.cpu().numpy()
            rows = np.flatnonzero(matched)
            keep = rows[np.argsort(-prio[rows], kind="stable")
                        [: self.rsv_prepass_cap]]
            matched = np.zeros_like(matched)
            matched[keep] = True
        small, idx = batch.compact(matched)
        m_small = np.zeros((small.capacity, rsv_set.capacity), bool)
        m_small[: len(idx)] = match[idx]
        a_r, rc, new_state, _, new_quota = reservation_greedy_assign(
            self.snapshot.state, small, self.config, rsv_set,
            torch.from_numpy(m_small).to(self.device), quota)
        a_r, rc = a_r.cpu().numpy(), rc.cpu().numpy()
        self.snapshot.adopt_state(new_state,
                                  changed_rows=np.unique(a_r[a_r >= 0]))
        sub_pods = [pods[i] for i in idx]
        drawn = self.reservations.commit_allocations(names, sub_pods, a_r, rc)
        binds, records, bound_rows = [], [], []
        for j, pod in enumerate(sub_pods):
            if int(a_r[j]) < 0:
                continue
            r = int(rc[j])
            rname = (names[r] if 0 <= r < len(names) and drawn[j] is not None
                     else None)
            rspec = self.reservations.get(rname) if rname is not None else None
            binds.append((pod, self.snapshot.node_name(int(a_r[j]))))
            records.append((rname, drawn[j],
                            rspec.generation if rspec else 0))
            bound_rows.append(int(idx[j]))
        self._commit_binds(binds, result, records)
        if bound_rows:
            mask = np.zeros(batch.capacity, bool)
            mask[bound_rows] = True
            batch = batch.replace(
                valid=batch.valid & ~torch.from_numpy(mask).to(self.device))
        return batch, (new_quota if new_quota is not None else quota)

    def _commit_reserve_pod(self, pod: PodSpec, node: str,
                            result: SchedulingResult, now: float) -> None:
        """A placed reserve-pod: its Reservation becomes Available.  The
        solve already charged the reserved vector to ``node_requested``."""
        rname = pod.name[len(RSV_POD_PREFIX):]
        if self.pending.pop(pod.name, None) is not None:
            self._pending_rev += 1
        if self.reservations.get(rname) is None:
            # the CR was deleted since the tick: release the solve's charge
            self.snapshot.unreserve(node, pod.requests)
            return
        self.reservations.make_available(rname, node, self.snapshot, now=now,
                                         charge=False)
        result.assignments[pod.name] = node

    def _active_pods(self) -> list[PodSpec]:
        """PreEnqueue: skip the pods of rejected gangs."""
        out = []
        self._last_gang_rejected_names = []
        for pod in self.pending.values():
            if pod.gang is not None:
                gang = self.gangs.get(pod.gang)
                if gang is not None and gang.rejected:
                    if not pod.name.startswith(RSV_POD_PREFIX):
                        self._last_gang_rejected_names.append(pod.name)
                    continue
            out.append(pod)
        out.sort(key=lambda p: (-p.priority, p.creation, p.name))
        return out

    def _build_gang_info(self, pods: list[PodSpec]
                         ) -> tuple[GangInfo, dict[str, int]]:
        """The round's gangs: sorted names, ``min_member`` (0 for a name no
        PodGroup registered) and gang groups (the first gang of a group
        names it)."""
        names = sorted({p.gang for p in pods if p.gang is not None})
        index = {n: i for i, n in enumerate(names)}
        groups: dict[str, int] = {}
        min_member = np.zeros(len(names), np.int32)
        group_id = np.arange(len(names), dtype=np.int32)
        for name, i in index.items():
            gang = self.gangs.get(name)
            min_member[i] = gang.min_member if gang else 0
            if gang and gang.group:
                group_id[i] = groups.setdefault(gang.group, i)
        return (GangInfo.build(min_member, group_id, device=self.device),
                index)

    # -- batch and quota --------------------------------------------------------

    def _build_batch(self, pods: list[PodSpec], gang_index: dict[str, int],
                     quota_index: dict[str, int]) -> PodBatch:
        # cache key: everything that feeds the batch tensors.  _pending_rev
        # covers pod contents (mutations go through enqueue/dequeue), the
        # name tuple the active set (gang rejection too), capacity
        # node-array growth, class_count new label/taint equivalence classes
        key = (
            self._pending_rev,
            tuple(pod.name for pod in pods),
            tuple(sorted(gang_index.items())),
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
        gang_id = np.full(p, -1, np.int32)
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
        # while the gang and quota indexes and the selector classes are
        # unchanged: they parameterise row CONTENT (a row copied under
        # another gang index would carry a stale gang id)
        c_cap = self.snapshot.class_capacity
        prev = self._batch_host
        reuse_ok = (
            prev is not None
            and prev["gang_index"] == gang_index
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
                gang_id[dst_a] = prev["gang_id"][src_a]
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
            if pod.gang is not None and pod.gang in gang_index:
                gang_id[i] = gang_index[pod.gang]
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
            requests, priority=priority, qos=qos, gang_id=gang_id,
            quota_id=quota_id,
            non_preemptible=non_preempt, selector_mask=sel,
            class_capacity=c_cap, node_capacity=self.snapshot.capacity,
            capacity=cap, rot_id=rot, device=self.device)
        self._batch_cache = (key, batch)
        self._batch_host = {
            "row_of": {pod.name: i for i, pod in enumerate(pods)},
            "specs": {pod.name: pod for pod in pods},
            "requests": requests, "priority": priority, "qos": qos,
            "gang_id": gang_id, "quota_id": quota_id,
            "non_preempt": non_preempt, "sel": sel,
            "gang_index": dict(gang_index),
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
        now = self.clock()
        if len(self.reservations):
            # the pinned fit check reads the flushed device rows
            self._reservation_tick(now)
        pods = self._active_pods()
        if not pods:
            return result
        gangs, gang_index = self._build_gang_info(pods)
        quota, quota_index = self._build_quota()
        batch = self._build_batch(pods, gang_index, quota_index)
        if len(self.reservations):
            # the batch cache keeps the whole batch; the solve gets the one
            # without the pre-pass's binds
            batch, quota = self._reservation_prepass(pods, batch, quota,
                                                     result)
        solver = ("batch" if len(pods) >= self.batch_solver_threshold
                  else "greedy")
        self.last_solver = solver
        # the incremental path takes every gangless batch round with a
        # factored selector mask (every batch round of this shell has one);
        # a round with a gang keeps gang_assign's full path
        use_inc = (solver == "batch" and self.incremental_solve
                   and not gang_index and batch.selector_mask is not None)
        if use_inc:
            assignments, new_state, new_quota = (
                self._solve_batch_incremental(pods, batch, quota))
        else:
            self.last_solve_path = (
                "greedy" if solver == "greedy"
                else "full_gang" if gang_index else "disabled")
            assignments, new_state, new_quota = gang_assign(
                self.snapshot.state, batch, self.config, gangs, quota,
                passes=self.gang_passes, solver=solver)

        a = assignments.cpu().numpy()
        leftover = batch.valid.cpu().numpy() & (a < 0)
        if solver == "batch" and bool(leftover[: len(pods)].any()):
            # exact rescue over the compacted leftovers: the batch engine's
            # top-k/round approximation may fail pods a greedy scan places.
            # Rolled-back gangs come back whole; the surplus members of a
            # gang already satisfied this round rescue as gangless pods
            # (its min_member is met), so the rescue's pre-enqueue and
            # rollback cannot strand them
            ga = batch.gang_id.cpu().numpy()
            placed = np.bincount(ga[(ga >= 0) & (a >= 0)],
                                 minlength=gangs.capacity)
            satisfied = placed >= gangs.min_member.cpu().numpy()
            rescue_gid = np.where(
                (ga >= 0) & satisfied[np.maximum(ga, 0)], -1, ga)
            small, idx = batch.replace(
                gang_id=torch.from_numpy(rescue_gid.astype(np.int32)).to(
                    self.device)).compact(leftover)
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

        placed_gangs: set[str] = set()
        binds = []
        for i, pod in enumerate(pods):
            if int(a[i]) >= 0:
                node = self.snapshot.node_name(int(a[i]))
                if pod.name.startswith(RSV_POD_PREFIX):
                    self._commit_reserve_pod(pod, node, result, now)
                else:
                    binds.append((pod, node))
                    if pod.gang:
                        placed_gangs.add(pod.gang)
        self._commit_binds(binds, result)

        # a pod in assignments was bound by the reservation pre-pass (its
        # row left the batch before the solve)
        fail_rows = [i for i, pod in enumerate(pods)
                     if int(a[i]) < 0 and pod.name not in result.assignments]
        failed_gangs: set[str] = set()
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
                if pods[i].gang:
                    failed_gangs.add(pods[i].gang)
        self._gang_wait_time(placed_gangs, failed_gangs, now)
        return result

    def _gang_wait_time(self, placed: set[str], failed: set[str],
                        now: float) -> None:
        """The gang WaitTime machine (Permit's timeout): a gang that failed
        with no member placed starts its wait, or is rejected once the
        wait is over; a gang with a member placed clears its wait."""
        for name in failed - placed:
            gang = self.gangs.get(name)
            if gang is None:
                continue
            if gang.first_failure is None:
                gang.first_failure = now
            elif now - gang.first_failure > gang.wait_time_sec:
                gang.rejected = True
        for name in placed:
            gang = self.gangs.get(name)
            if gang is not None:
                gang.first_failure = None

    # -- the incremental candidate cache --------------------------------------

    def _cand_method(self) -> str:
        """``cand_method`` resolved: "auto" is "exact" (the JAX scheduler
        takes "approx" only on a TPU)."""
        return "exact" if self.cand_method == "auto" else self.cand_method

    def _select(self, state, batch: PodBatch, k: int, method: str):
        return ba.select_candidates(state, batch, self.config, k=k,
                                    method=method, with_scores=True)

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
        method = self._cand_method()
        meta = self._cand_cache
        cache_ok = (
            meta is not None
            and meta["n"] == n
            and meta["method"] == method
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
                    sk, sn, ss = self._select(snap.state, small, k, method)
                    rows_pad = np.full(small.capacity, batch.capacity,
                                       np.int32)
                    rows_pad[: len(idx)] = idx
                    cache = ba.scatter_candidate_rows(
                        cache, dev(rows_pad), sk, sn, ss)
            else:
                path = "full_fallback"
        if cache is None:
            cache = ba.CandidateCache(*self._select(snap.state, batch, k,
                                                    method))
        # the batch build already made this round's name -> row and spec
        # maps for its own row reuse: share them
        host = self._batch_host
        self._cand_cache = {
            "cache": cache, "row_of": host["row_of"], "specs": host["specs"],
            "n": n, "method": method, "cfg": self.config,
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
                "est_accum": est_accum, "batch": batch, "k": k,
                "method": method}

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
                    state, est_accum, small, quota, self.config, k=ctx["k"],
                    method=ctx["method"])
                a2_np = a2.cpu().numpy()[: len(idx)]
                placed = a2_np >= 0
                if not placed.any():
                    break
                a_np[idx[placed]] = a2_np[placed]
        except Exception:
            self._cand_cache = None
            raise
        return torch.from_numpy(a_np).to(self.device), state, quota

    def _commit_binds(self, binds, result: SchedulingResult,
                      reservations=None) -> None:
        """Record the binds in the result and the ``bound`` registry, charge
        each quota's ``used`` once per (quota, non-preemptible) group, then
        call ``bind_fn`` per pod.  ``reservations`` gives each bind's
        (reservation, drawn vector, reservation generation) when the
        pre-pass made it."""
        gen = self.snapshot.node_generation
        for k, (pod, node) in enumerate(binds):
            result.assignments[pod.name] = node
            if self.pending.pop(pod.name, None) is not None:
                self._pending_rev += 1
            if reservations is None:
                self.bound[pod.name] = BoundPod(pod, node, gen.get(node, 0))
            else:
                self.bound[pod.name] = BoundPod(pod, node, gen.get(node, 0),
                                                *reservations[k])
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
