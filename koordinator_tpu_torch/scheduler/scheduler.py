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
7. Diagnose: a :class:`PodDiagnosis` for every failed pod in
   ``result.failures``, from one reject-reason count over the compacted
   failed rows (``ops/explain.py`` ``explain_counts``, K7) or, with
   ``explain=False``, a host recompute a pod; a pod the post-solve quota
   does not admit is blamed on the quota when some nodes were otherwise
   feasible.  Then the gang WaitTime machine (Permit's timeout): a gang
   with a failed member and none placed this round starts its wait at its
   first such round and is rejected once ``wait_time_sec`` has passed
   since; a gang with a member placed clears its wait.  With ``explain``,
   each unplaced user pod's :class:`PlacementExplanation` goes to
   ``explain_ring`` (:meth:`Scheduler.pod_explanation`).

Around them, when enabled: the Nominated phase (after the tick) binds the
pods an earlier round's preemption nominated, each re-checked on its
nominated node with its own assumed charge released (a gang all-or-nothing;
a failed one loses its nomination and rejoins the batch); the QuotaRevoke
phase (``enable_overuse_revoke``, before PreEnqueue) evicts the least
important pods of quotas over their runtime past the delay (K6); and the
PostFilter phase (``enable_preemption``, after the gang WaitTime machine)
preempts for the round's failed pods, highest priority first, up to
``preempt_cap`` a round: gangs as jobs all-or-nothing through
``preempt_one``, runs of single pods through ``preempt_chain`` in chunks of
``preempt_chunk`` (K5), the victims evicted through ``preempt_fn`` and their
PDBs charged, each preemptor's request assumed on its node and quota and
recorded in ``result.nominations`` and on its diagnosis.  After PostFilter
the failed pods' diagnoses persist to ``explanations`` (an
``ExplanationStore``), and ``auditor`` (a ``WorkloadAuditor``) records each
workload's attempts, failures, binds and reservation transitions.

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
topology planner waits for ``ops/network_topology.py``), hints and their
dense masks, the fine-grained CPU and device allocators (and so
``add_bound_pod``'s ``resource_status``), forecast and quality modes,
degraded mode (so no pod is held back as ``degraded_suspended``), tenancy,
the solve mesh, pod traces (``pod_trace_id`` is None, as in JAX without
``trace_pods``), the flight recorder, and the journey, timeline and
metrics hooks (among them the explain rollup's gauges).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from koordinator_tpu_torch.ops import batch_assign as ba
from koordinator_tpu_torch.ops import explain as ex
from koordinator_tpu_torch.ops import scoring
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    _threshold_mask,
    score_pods,
)
from koordinator_tpu_torch.ops.gang import GangInfo, gang_assign
from koordinator_tpu_torch.ops.preemption import (
    ScheduledPods,
    preempt_chain,
    preempt_one,
)
from koordinator_tpu_torch.ops.reservation import reservation_greedy_assign
from koordinator_tpu_torch.quota.admission import (
    HEADROOM_CLAMP,
    QuotaDeviceState,
    quota_admission_mask,
)
from koordinator_tpu_torch.quota.tree import UNBOUNDED, QuotaTree
from koordinator_tpu_torch.scheduler.diagnosis import (
    PodDiagnosis,
    diagnosis_from_counts,
    explain_pod,
)
from koordinator_tpu_torch.scheduler.explanation import (
    ExplanationRing,
    PlacementExplanation,
)
from koordinator_tpu_torch.scheduler.reservations import (
    ReservationCache,
    ReservationPhase,
)
from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot, PodSpec
from koordinator_tpu_torch.state.cluster_state import PodBatch, _bucket

#: pending-queue key prefix for synthetic reserve-pods (koordinator models a
#: Reservation as a pod the scheduler places; reservation_types.go)
RSV_POD_PREFIX = "rsv::"


@dataclasses.dataclass
class PdbRecord:
    """PodDisruptionBudget: selector + remaining disruption budget."""

    name: str
    selector: dict[str, str]
    allowed: int  # status.disruptionsAllowed

    def matches(self, labels: dict[str, str]) -> bool:
        # a PDB with an empty selector matches nothing; a pod with no labels
        # matches no PDB (filterPodsWithPDBViolation, preempt.go:224)
        if not self.selector or not labels:
            return False
        return all(labels.get(k) == v for k, v in self.selector.items())


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

    @property
    def priority(self) -> int:
        return self.pod.priority

    @property
    def labels(self) -> dict[str, str]:
        return self.pod.labels

    @property
    def gang(self) -> str | None:
        return self.pod.gang


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
    failures: dict[str, PodDiagnosis]   # pod -> why
    round_pods: int = 0
    #: pods the greedy rescue pass placed (batch rounds only)
    rescued: int = 0
    #: PostFilter outcomes: preemptor pod -> (nominated node, victim names)
    nominations: dict[str, tuple[str, list[str]]] = dataclasses.field(
        default_factory=dict)


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
                 clock=time.monotonic, enable_preemption: bool | None = None,
                 preempt_fn=None, explanations=None, auditor=None,
                 explain: bool = True):
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

        # -- preemption (PostFilter) --
        # by default only preempt when someone is wired to evict the victim
        # (freeing accounting for pods that keep running would double-book
        # nodes)
        self.enable_preemption = (enable_preemption
                                  if enable_preemption is not None
                                  else preempt_fn is not None)
        #: called as preempt_fn(victim_name, preemptor_name) per eviction
        self.preempt_fn = preempt_fn
        self.pdbs: dict[str, PdbRecord] = {}
        #: preemptor pod -> nominated node name (nominatedNodeName)
        self.nominations: dict[str, str] = {}
        #: node INSTANCE each nomination's charge was assumed against
        self._nomination_gen: dict[str, int] = {}
        #: failed pods that may attempt preemption in one round, highest
        #: priority first (a gang that does not fit the rest is skipped
        #: whole; the others retry next round)
        self.preempt_cap = 1024
        #: single-pod preemptors run in chains of at most this many
        self.preempt_chunk = 256
        #: the quota overuse revoke controller (enable_overuse_revoke)
        self.overuse_revoke = None

        # -- diagnosis and explanations --
        #: rounds run so far (the explanations' ``round``)
        self.round_seq = 0
        #: when False, Diagnose recomputes each failed pod on the host, and
        #: no explanation is kept
        self.explain = explain
        #: explanation.ExplanationStore: failures persist as
        #: ScheduleExplanation CRs (schedule_diagnosis.go DumpDiagnosis)
        self.explanations = explanations
        #: explanation.WorkloadAuditor: per-pod/gang lifecycle records
        self.auditor = auditor
        #: bounded pod-keyed retention of the latest explanations
        self.explain_ring = ExplanationRing()
        #: {top reason -> pod count} of the last round's explanations
        self._last_unschedulable_top: dict[str, int] = {}
        #: pods degraded mode held back (not ported: always empty)
        self._last_suspended_names: list[str] = []
        #: host seconds of the last round's Diagnose phase, and of its
        #: parts: "quota_mask" (the post-solve quota admission mask),
        #: "compact" (the failed rows and their compacted batch), "k7"
        #: (the reject-reason count and its copy to the host), "diagnoses"
        #: (a PodDiagnosis a failed pod), "gang_wait" (the WaitTime
        #: machine) and "explanations" (the round's PlacementExplanations)
        self.last_diagnose_s = 0.0
        self.last_diagnose_parts_s: dict[str, float] = {}

    # -- registration -----------------------------------------------------------

    def register_gang(self, record: GangRecord) -> None:
        if record.topology is not None:
            raise ValueError(
                f"gang {record.name!r}: network-topology requirements are "
                "not ported (ROADMAP A7: ops/network_topology.py)")
        if record.wait_time_sec is None:
            record.wait_time_sec = self.gang_default_timeout_sec
        self.gangs[record.name] = record

    def register_pdb(self, record: PdbRecord) -> None:
        self.pdbs[record.name] = record

    def add_bound_pod(self, pod: BoundPod) -> None:
        """Seed a pre-existing bound pod (informer replay at startup): its
        request is reserved on its node here and released by
        :meth:`remove_bound_pod`."""
        self.add_bound_pods([pod])

    def add_bound_pods(self, pods: list[BoundPod]) -> None:
        """:meth:`add_bound_pod` for many pods, their node charges in one
        device update (integer adds commute: the same bits)."""
        by_node: dict[str, np.ndarray] = {}
        for pod in pods:
            self.bound[pod.name] = pod
            if pod.node in self.snapshot.node_index:
                cur = by_node.get(pod.node)
                req = pod.requests.astype(np.int32)
                by_node[pod.node] = req if cur is None else cur + req
        self.snapshot.reserve_batch(by_node)

    def enable_overuse_revoke(self, revoke_fn,
                              delay_evict_sec: float = 5.0) -> None:
        """Turn on the elastic-quota overuse revoke loop
        (quota_overuse_revoke.go): each round, quotas whose used exceeds
        runtime continuously past the delay get their least important pods
        revoked until they fit.  ``revoke_fn(pod, quota)`` is required: it
        performs the eviction, and freeing capacity nobody evicts would
        oversubscribe the node."""
        from koordinator_tpu_torch.quota.overuse_revoke import (
            QuotaOveruseRevokeController,
        )

        self.overuse_revoke = QuotaOveruseRevokeController(
            self, revoke_fn=revoke_fn, delay_evict_sec=delay_evict_sec,
            clock=self.clock)

    # -- queue ----------------------------------------------------------------

    def enqueue(self, pod: PodSpec) -> None:
        self.pending[pod.name] = pod
        self._pending_rev += 1

    def enqueue_many(self, pods: list[PodSpec]) -> None:
        for pod in pods:
            self.enqueue(pod)

    def dequeue(self, pod_name: str) -> None:
        # a deleted nominated preemptor releases its assumed node and quota
        # charge, and must not pin a later pod of the same name
        pod = self.pending.pop(pod_name, None)
        if pod is not None:
            self._pending_rev += 1
        if pod_name in self.nominations and pod is not None:
            self._nomination_release(pod)
        else:
            self.nominations.pop(pod_name, None)
            self._nomination_gen.pop(pod_name, None)

    # -- bound pods -------------------------------------------------------------

    def delete_pod(self, name: str) -> None:
        """Informer pod delete, whatever state the pod is in: a pending or
        nominated pod is dequeued; a bound pod releases its node charge and
        its quota charge."""
        if name in self.pending or name in self.nominations:
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
        for name in self.reservations.fail_stale_instances(self.snapshot):
            if self.auditor is not None:
                self.auditor.record(name, "ReservationFailed",
                                    "node instance gone")
        for name in self.reservations.expire_tick(now, self.snapshot):
            # a Pending reservation that expired drops its reserve-pod too
            if self.pending.pop(RSV_POD_PREFIX + name, None) is not None:
                self._pending_rev += 1
            if self.auditor is not None:
                self.auditor.record(name, "ReservationExpired", "")
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
        if self.explanations is not None:
            self.explanations.delete(pod.name)
        if self.auditor is not None:
            self.auditor.record(pod.name, "ReservationAvailable", node)

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
        """Solve the current pending queue; reserve, bind, diagnose."""
        self.round_seq += 1
        self._last_unschedulable_top = {}
        result = SchedulingResult({}, {}, 0)
        self.last_dirty_node_frac = 0.0
        self.last_dirty_pod_frac = 0.0
        self.snapshot.flush()
        now = self.clock()
        if len(self.reservations):
            # the pinned fit check reads the flushed device rows
            self._reservation_tick(now)
        if self.nominations:
            # Nominated: earlier rounds' preemptors bind on their nodes
            self.snapshot.flush()
            self._resolve_nominations(result)
        if self.overuse_revoke is not None and self.quota_tree is not None:
            # QuotaRevoke: after the nominations (their released charges
            # must not trigger evictions), before the solve (the freed
            # headroom admits this round), on a fresh runtime
            self._refresh_quota_tree()
            self.overuse_revoke.revoke_once()
        pods = self._active_pods()
        if not pods:
            # a queue held out whole still explains itself
            if self.explain:
                self._record_round_explanations(
                    [], result, [], set(), len(self.snapshot.node_index))
            return result
        if self.auditor is not None:
            # one attempt a workload key a round: a gang is one attempt;
            # reserve-pods are not workloads
            for key in {pod.gang or pod.name for pod in pods
                        if not pod.name.startswith(RSV_POD_PREFIX)}:
                self.auditor.record_attempt(key)
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

        self._diagnose(pods, batch, a, quota, new_quota, placed_gangs, now,
                       result)
        if self.enable_preemption and result.failures:
            self._run_preemption(pods, batch, result)
        if self.explanations is not None:
            # persist after PostFilter, so nominations land on the CR (the
            # binds cleared theirs in _commit_binds)
            for pod in pods:
                if pod.name.startswith(RSV_POD_PREFIX):
                    # an unplaced reserve-pod retries next round; it is not
                    # a user pod
                    continue
                diag = result.failures.get(pod.name)
                if diag is not None:
                    self.explanations.record(pod.name, diag)
                    if self.auditor is not None:
                        self.auditor.record(pod.gang or pod.name,
                                            "ScheduleFailed", diag.message())
        return result

    def _diagnose(self, pods: list[PodSpec], batch: PodBatch, a: np.ndarray,
                  quota, new_quota, placed_gangs: set[str], now: float,
                  result: SchedulingResult) -> None:
        """Diagnose: a :class:`PodDiagnosis` for every failed pod, then the
        gang WaitTime machine and, with ``explain``, the round's
        explanations.  The diagnoses come from ONE reject-reason count
        over the compacted failed rows (only (F, NUM_REASONS) comes back
        to the host), or with ``explain=False`` from a host recompute a
        pod."""
        t0 = time.perf_counter()
        admitted = None
        if quota is not None:
            # blame against the POST-solve quota: a pod that lost the
            # headroom to this round's placements failed because of quota,
            # though the pre-solve admission passed it.  Only when nodes
            # were otherwise feasible: a pod that failed on capacity or
            # affinity keeps its real reason
            diag_quota = new_quota if new_quota is not None else quota
            admitted = quota_admission_mask(
                diag_quota, batch.requests, batch.quota_id,
                batch.non_preemptible).cpu().numpy()
        t_quota = time.perf_counter()
        # a pod in assignments was bound by the reservation pre-pass (its
        # row left the batch before the solve)
        fail_rows = [i for i, pod in enumerate(pods)
                     if int(a[i]) < 0 and pod.name not in result.assignments]
        counts = feas = small = None
        row_pos: dict[int, int] = {}
        if self.explain and fail_rows:
            fmask = np.zeros(batch.capacity, bool)
            fmask[fail_rows] = True
            small, idx = batch.compact(fmask)
            row_pos = {int(r): j for j, r in enumerate(idx)}
        t_compact = time.perf_counter()
        if small is not None:
            c_dev, f_dev = ex.explain_counts(self.snapshot.state, small,
                                             self.config)
            counts, feas = c_dev.cpu().numpy(), f_dev.cpu().numpy()
        t_counts = time.perf_counter()
        total_nodes = len(self.snapshot.node_index)
        failed_gangs: set[str] = set()
        for i in fail_rows:
            pod = pods[i]
            if counts is not None:
                j = row_pos[i]
                diag = diagnosis_from_counts(counts[j], int(feas[j]),
                                             total_nodes, quota_admitted=True)
            else:
                diag = explain_pod(self.snapshot.state, batch, self.config,
                                   i, quota_admitted=True)
            if (admitted is not None and not admitted[i]
                    and diag.feasible_nodes > 0):
                # nodes were available but the quota (as of this round's
                # placements) says no: quota is the cause
                if diag.reason_counts is not None:
                    diag.reason_counts["quota"] = diag.feasible_nodes
                diag = dataclasses.replace(diag, quota_rejected=True,
                                           feasible_nodes=0)
            result.failures[pod.name] = diag
            if pod.gang:
                failed_gangs.add(pod.gang)
        t_diagnoses = time.perf_counter()
        self._gang_wait_time(placed_gangs, failed_gangs, now)
        t_gang = time.perf_counter()
        if self.explain:
            self._record_round_explanations(pods, result, fail_rows,
                                            failed_gangs, total_nodes)
        t_end = time.perf_counter()
        self.last_diagnose_s = t_end - t0
        self.last_diagnose_parts_s = {
            "quota_mask": t_quota - t0, "compact": t_compact - t_quota,
            "k7": t_counts - t_compact, "diagnoses": t_diagnoses - t_counts,
            "gang_wait": t_gang - t_diagnoses, "explanations": t_end - t_gang}

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
                      reservations=None, charge_quota: bool = True) -> None:
        """Record the binds in the result and the ``bound`` registry, charge
        each quota's ``used`` once per (quota, non-preemptible) group, then
        call ``bind_fn`` per pod.  ``reservations`` gives each bind's
        (reservation, drawn vector, reservation generation) when the
        pre-pass made it; ``charge_quota=False`` converts nominations, whose
        quota charge is already on the tree."""
        gen = self.snapshot.node_generation
        for k, (pod, node) in enumerate(binds):
            result.assignments[pod.name] = node
            if self.pending.pop(pod.name, None) is not None:
                self._pending_rev += 1
            self.nominations.pop(pod.name, None)
            self._nomination_gen.pop(pod.name, None)
            if reservations is None:
                self.bound[pod.name] = BoundPod(pod, node, gen.get(node, 0))
            else:
                self.bound[pod.name] = BoundPod(pod, node, gen.get(node, 0),
                                                *reservations[k])
        if self.quota_tree is not None and charge_quota:
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
        for pod, node in binds:
            # a bound pod's explanation is stale
            if self.explanations is not None:
                self.explanations.delete(pod.name)
            if self.auditor is not None:
                self.auditor.record(pod.gang or pod.name, "ScheduleSuccess",
                                    node)
        if self.bind_fn is not None:
            for pod, node in binds:
                self.bind_fn(pod.name, node)

    # -- nominated pods (nominatedNodeName) -------------------------------------

    def _nomination_assume(self, pod: PodSpec, node: str) -> None:
        """Account a nomination: reserve the node and charge the quota, so
        neither the victims' freed capacity nor the quota headroom can be
        spent twice before the preemptor binds."""
        self.snapshot.reserve(node, pod.requests)
        self._charge_quota_used(pod, sign=1)
        self.nominations[pod.name] = node
        self._nomination_gen[pod.name] = self.snapshot.node_generation.get(
            node, 0)

    def _nomination_release(self, pod: PodSpec) -> None:
        """Undo :meth:`_nomination_assume` (a stale nomination, a deleted
        pod); a no-op for a pod without one."""
        node = self.nominations.pop(pod.name, None)
        if node is None:
            return
        self.snapshot.unreserve_instance(
            node, pod.requests, self._nomination_gen.pop(pod.name, 0))
        self._charge_quota_used(pod, sign=-1)

    def _nominated_fit(self, pod: PodSpec, row: int) -> bool:
        """Filter again for a nominated pod on its nominated node (its own
        assumed charge released by the caller), then its quota."""
        batch = PodBatch.build(
            pod.requests[None].astype(np.int32),
            priority=np.array([pod.priority], np.int32),
            feasible=self.snapshot.feasibility_row(pod)[None],
            node_capacity=self.snapshot.capacity, capacity=16,
            device=self.device)
        _, feasible = score_pods(self.snapshot.state, batch, self.config)
        if not bool(feasible[0, row]):
            return False
        if pod.quota is not None and self.quota_tree is not None:
            return self.quota_tree.admits(pod.quota, pod.requests,
                                          pod.non_preemptible)
        return True

    def _resolve_nominations(self, result: SchedulingResult) -> None:
        """Bind the pods nominated in an earlier round.  Each pod's own
        assumed charge is released, Filter runs again on its nominated
        node, and it binds there (the assumed charge becomes the bind's)
        or loses the nomination and rejoins the batch.  Gang members
        resolve all-or-nothing: when one member's node stopped being
        viable, every member's nomination is released."""
        groups: dict[str, list[PodSpec]] = {}
        for name in list(self.nominations):
            pod = self.pending.get(name)
            if pod is None:
                self.nominations.pop(name, None)   # pod gone: nothing held
                self._nomination_gen.pop(name, None)
                continue
            groups.setdefault(pod.gang or f"\0solo:{name}", []).append(pod)
        for members in groups.values():
            assumed: list[tuple[PodSpec, str]] = []
            ok = True
            for pod in members:
                node_name = self.nominations[pod.name]
                row = self.snapshot.node_index.get(node_name)
                # release its own charge, re-check with its peers' held
                self._nomination_release(pod)
                if row is None or not self._nominated_fit(pod, row):
                    ok = False
                    break
                self._nomination_assume(pod, node_name)
                assumed.append((pod, node_name))
            if ok:
                # the assumed charges become the binds' (no second charge)
                self._commit_binds(assumed, result, charge_quota=False)
            else:
                for pod in members:
                    self._nomination_release(pod)

    # -- preemption (PostFilter) ---------------------------------------------------

    def _pdb_arrays(self) -> tuple[list[str], np.ndarray]:
        names = sorted(self.pdbs)
        allowed = np.array([self.pdbs[n].allowed for n in names],
                           np.int32).reshape(-1)
        if not names:
            allowed = np.zeros(1, np.int32)   # a padded row, never matched
        return names, allowed

    def _build_scheduled(self, quota_index: dict[str, int]):
        """The ``bound`` registry as :class:`ScheduledPods` (rows in sorted
        name order) and the names.  A pod bound to an earlier instance of a
        re-added node gets node -1 (its capacity was never charged to the
        current row); a pod matching several PDBs carries the one with the
        smallest remaining budget, the lowest index on ties (eviction pays
        every match)."""
        pdb_names, _ = self._pdb_arrays()
        pdb_index = {n: i for i, n in enumerate(pdb_names)}
        names = sorted(self.bound)
        v = len(names)
        dims = self.snapshot.dims
        node_index = self.snapshot.node_index
        node_gen = self.snapshot.node_generation
        req = np.zeros((v, dims), np.int32)
        node = np.full(v, -1, np.int32)
        pri = np.zeros(v, np.int32)
        qid = np.full(v, -1, np.int32)
        nonp = np.zeros(v, bool)
        pdb = np.full(v, -1, np.int32)
        by_labels: dict[tuple, int] = {}
        for i, name in enumerate(names):
            bp = self.bound[name]
            row = node_index.get(bp.node)
            if row is not None and node_gen.get(bp.node, 0) == \
                    bp.node_generation:
                node[i] = row
            req[i] = bp.requests
            pri[i] = bp.priority
            if bp.quota is not None and bp.quota in quota_index:
                qid[i] = quota_index[bp.quota]
            nonp[i] = bp.non_preemptible
            key = tuple(sorted(bp.labels.items()))
            best = by_labels.get(key)
            if best is None:
                matches = [pi for pn, pi in pdb_index.items()
                           if self.pdbs[pn].matches(bp.labels)]
                best = by_labels[key] = (
                    min(matches,
                        key=lambda pi: self.pdbs[pdb_names[pi]].allowed)
                    if matches else -1)
            pdb[i] = best
        return ScheduledPods.build(
            req, node, priority=pri if v else None,
            quota_id=qid if v else None, non_preemptible=nonp if v else None,
            pdb_id=pdb if v else None, device=self.device), names

    def _quota_headroom(self, quota_name: str | None) -> np.ndarray | None:
        """(R,) runtime - used of the pod's quota (postFilterState.usedLimit):
        the victims must bring used back under it.  Dims outside the
        quota's declared max are unbounded."""
        if quota_name is None or self.quota_tree is None:
            return None
        qnode = self.quota_tree.nodes.get(quota_name)
        if qnode is None:
            return None
        hr = np.where(qnode.max != UNBOUNDED, qnode.runtime - qnode.used,
                      HEADROOM_CLAMP)
        return np.clip(hr, -HEADROOM_CLAMP, HEADROOM_CLAMP).astype(np.int32)

    def _run_preemption(self, pods: list[PodSpec], batch: PodBatch,
                        result: SchedulingResult) -> None:
        """PostFilter: for each failed pod, find the cheapest victim set,
        evict and nominate.  Gang members preempt together, all-or-nothing
        (Coscheduling job preemption); a pod with a quota preempts within
        it (elasticquota's SelectVictimsOnNode)."""
        # reserve-pods place through the reservation lifecycle instead
        failed = [p for p in pods if p.name in result.failures
                  and not p.name.startswith(RSV_POD_PREFIX)]
        if not failed:
            return
        quota_index = ({} if self.quota_tree is None else
                       {n: i for i, n in enumerate(sorted(
                           self.quota_tree.nodes))})
        sched, bound_names = self._build_scheduled(quota_index)
        if not bound_names:
            return
        _, pdb_np = self._pdb_arrays()
        pdb_allowed = torch.from_numpy(pdb_np).to(self.device)
        snap_state = self.snapshot.state
        # the host commits below change the snapshot's accounting in place
        state = snap_state.replace(
            node_requested=snap_state.node_requested.clone())

        # gangs preempt as one job, other pods alone, highest priority first
        failed.sort(key=lambda p: (-p.priority, p.creation, p.name))
        jobs: list[list[PodSpec]] = []
        seen_gangs: set[str] = set()
        for p in failed:
            if p.gang is not None:
                if p.gang in seen_gangs:
                    continue
                seen_gangs.add(p.gang)
                jobs.append([q for q in failed if q.gang == p.gang])
            else:
                jobs.append([p])
        # the round's budget: a gang that does not fit what is left is
        # skipped whole, and the rest retry next round
        budget = self.preempt_cap
        capped: list[list[PodSpec]] = []
        for job in jobs:
            if budget <= 0:
                break
            if any(p.preemption_policy == "Never" for p in job):
                continue
            if len(job) > budget:
                continue
            capped.append(job)
            budget -= len(job)
        if not capped:
            return

        # the capped preemptors' feasible rows, ANDed with the load-aware
        # threshold (preemption lowers no measured usage)
        pod_row = {p.name: i for i, p in enumerate(pods)}
        fail_rows = sorted({pod_row[p.name] for job in capped for p in job})
        rows_t = torch.tensor(fail_rows, dtype=torch.long, device=self.device)
        if batch.feasible is not None:
            feas = batch.feasible[rows_t]
        else:
            c = batch.selector_mask.shape[1]
            nc = torch.clamp(snap_state.node_class, max=c - 1).long()
            feas = (batch.selector_mask[rows_t][:, nc]
                    & (snap_state.node_class < c)[None, :])
        pod_est = scoring.estimate_pod_usage_by_band(
            batch.requests[rows_t], self.config.estimator_factors,
            self.config.estimator_defaults)
        feas = feas & _threshold_mask(
            self.config, snap_state.node_usage, snap_state.node_agg_usage,
            snap_state.node_allocatable, pod_est)
        mask_row = {pods[r].name: i for i, r in enumerate(fail_rows)}

        i = 0
        while i < len(capped):
            job = capped[i]
            if len(job) == 1 and job[0].gang is None:
                # a run of single-pod preemptors: one chain
                chunk: list[PodSpec] = []
                while (i < len(capped) and len(capped[i]) == 1
                       and capped[i][0].gang is None
                       and len(chunk) < self.preempt_chunk):
                    chunk.append(capped[i][0])
                    i += 1
                state, sched, pdb_allowed = self._run_preempt_chunk(
                    chunk, state, sched, pdb_allowed, quota_index,
                    bound_names, feas, mask_row, result)
                continue
            i += 1
            state, sched, pdb_allowed = self._run_preempt_job(
                job, state, sched, pdb_allowed, quota_index, bound_names,
                feas, mask_row, result)

    def _run_preempt_job(self, job, state, sched, pdb_allowed, quota_index,
                         bound_names, feas, mask_row, result):
        """A gang: one preempt_one a member, each seeing the ones before,
        committed only when every member found a node.  Returns the evolved
        (state, sched, pdb)."""
        cur_state, cur_sched, cur_pdb = state, sched, pdb_allowed
        outcomes = []
        # quota the job's earlier members took or freed (their requests less
        # their same-quota victims'): the tree is charged only at commit
        job_assumed: dict[str, np.ndarray] = {}
        for p in job:
            quota_hr = self._quota_headroom(p.quota)
            same_quota = quota_hr is not None
            if same_quota and p.quota in job_assumed:
                quota_hr = np.clip(
                    quota_hr.astype(np.int64) - job_assumed[p.quota],
                    -HEADROOM_CLAMP, HEADROOM_CLAMP).astype(np.int32)
            qid = quota_index.get(p.quota, -1) if p.quota else -1
            out = preempt_one(
                cur_state, cur_sched,
                torch.from_numpy(p.requests.astype(np.int32)).to(self.device),
                p.priority, qid, feas[mask_row[p.name]], cur_pdb,
                quota_headroom=(torch.from_numpy(quota_hr).to(self.device)
                                if same_quota else None),
                same_quota_only=same_quota)
            node_row = int(out.node)
            if node_row < 0:
                # all-or-nothing: drop the job's tentative evictions
                return state, sched, pdb_allowed
            victim_names = [bound_names[v] for v in
                            torch.nonzero(out.victims).flatten().tolist()]
            outcomes.append((p, node_row, victim_names))
            if p.quota is not None:
                delta = p.requests.astype(np.int64)
                for vname in victim_names:
                    bp = self.bound[vname]
                    if bp.quota == p.quota:
                        delta = delta - bp.requests.astype(np.int64)
                job_assumed[p.quota] = job_assumed.get(p.quota, 0) + delta
            cur_state, cur_sched, cur_pdb = (out.state, out.sched,
                                             out.pdb_allowed)
        # later jobs see this one's evictions and nominations; the victims'
        # rows stay in place (invalid in sched)
        for p, node_row, victim_names in outcomes:
            self._commit_one_preemption(p, node_row, victim_names, result)
        return cur_state, cur_sched, cur_pdb

    def _run_preempt_chunk(self, chunk, state, sched, pdb_allowed,
                           quota_index, bound_names, feas, mask_row, result):
        """A run of single-pod preemptors as one ``preempt_chain``: the same
        as :meth:`_run_preempt_job` a pod.  Returns (state, sched, pdb)."""
        c, r = len(chunk), self.snapshot.dims
        reqs = np.zeros((c, r), np.int32)
        pris = np.zeros(c, np.int32)
        qids = np.full(c, -1, np.int32)
        same_q = np.zeros(c, bool)
        # (Q, R) runtime - used by quota row; rows with no headroom open
        base_hr = np.full((max(len(quota_index), 1), r), HEADROOM_CLAMP,
                          np.int32)
        for name, qi in quota_index.items():
            hr = self._quota_headroom(name)
            if hr is not None:
                base_hr[qi] = hr
        for j, p in enumerate(chunk):
            reqs[j] = p.requests.astype(np.int32)
            pris[j] = p.priority
            qids[j] = quota_index.get(p.quota, -1) if p.quota else -1
            same_q[j] = self._quota_headroom(p.quota) is not None
        rows = torch.tensor([mask_row[p.name] for p in chunk],
                            dtype=torch.long, device=self.device)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        out = preempt_chain(
            state, sched, dev(reqs), dev(pris), dev(qids),
            feas[rows].contiguous(), dev(same_q),
            torch.ones(c, dtype=torch.bool, device=self.device), pdb_allowed,
            dev(base_hr))
        nodes = out.node.cpu().numpy()
        victims_of: dict[int, list[str]] = {}
        for j, v in torch.nonzero(out.victims).cpu().tolist():
            victims_of.setdefault(j, []).append(bound_names[v])
        for j, p in enumerate(chunk):
            if nodes[j] >= 0:
                self._commit_one_preemption(p, int(nodes[j]),
                                            victims_of.get(j, []), result)
        return out.state, out.sched, out.pdb_allowed

    def _commit_one_preemption(self, p: PodSpec, node_row: int,
                               victim_names: list[str],
                               result: SchedulingResult) -> None:
        """The host commit of one preemptor: evict its victims (node charge
        and quota released, every matching PDB pays, ``preempt_fn``), assume
        its nomination and record it on the round's result."""
        node_name = self.snapshot.node_name(node_row)
        for vname in victim_names:
            bp = self.bound.pop(vname)
            self._release_bound_capacity(bp)
            self._charge_quota_used(bp, sign=-1)
            for rec in self.pdbs.values():
                if rec.matches(bp.labels):
                    rec.allowed -= 1
            if self.preempt_fn is not None:
                self.preempt_fn(vname, p.name)
        self._nomination_assume(p, node_name)
        result.nominations[p.name] = (node_name, victim_names)
        diag = result.failures.get(p.name)
        if diag is not None:
            diag.preempt_node = node_name
            diag.preempt_victims = victim_names

    # -- placement explanations ----------------------------------------------

    def _record_round_explanations(
        self, pods, result: SchedulingResult, fail_rows: list[int],
        failed_gangs: set[str], total_nodes: int,
    ) -> None:
        """A :class:`PlacementExplanation` for every pod the round left
        unplaced (the solve's failures, from their diagnoses, and the
        pods of rejected gangs) into ``explain_ring``, and the round's
        {top reason -> pods} summary."""
        explanations: list[PlacementExplanation] = []
        for i in fail_rows:
            pod = pods[i]
            if pod.name.startswith(RSV_POD_PREFIX):
                continue   # reserve-pods are not user workloads
            diag = result.failures.get(pod.name)
            if diag is None:
                continue
            # node_invalid counts the padded state rows too: the served
            # explanation partitions the live nodes only
            reasons = {name: count
                       for name, count in (diag.reason_counts or {}).items()
                       if count > 0 and name != "node_invalid"}
            feasible = diag.feasible_nodes
            if (pod.gang is not None and pod.gang in failed_gangs
                    and feasible > 0):
                # nodes were feasible one by one; the gang barrier
                # (minMember, rollback) held the placement back
                reasons["gang_barrier"] = feasible
                feasible = 0
            explanations.append(PlacementExplanation(
                pod=pod.name, round=self.round_seq,
                total_nodes=total_nodes, feasible_nodes=feasible,
                reasons=reasons, trace_id=self.pod_trace_id(pod.name),
                quota=pod.quota if diag.quota_rejected else None,
                gang=pod.gang))
        for name in self._last_suspended_names:
            explanations.append(PlacementExplanation(
                pod=name, round=self.round_seq, total_nodes=total_nodes,
                feasible_nodes=0,
                reasons={"degraded_suspended": total_nodes},
                trace_id=self.pod_trace_id(name),
                gang=getattr(self.pending.get(name), "gang", None)))
        for name in self._last_gang_rejected_names:
            explanations.append(PlacementExplanation(
                pod=name, round=self.round_seq, total_nodes=total_nodes,
                feasible_nodes=0, reasons={"gang_barrier": total_nodes},
                trace_id=self.pod_trace_id(name),
                gang=getattr(self.pending.get(name), "gang", None)))
        top: dict[str, int] = {}
        for exp in explanations:
            self.explain_ring.record(exp)
            reason = exp.top_reason()
            if reason is not None:
                top[reason] = top.get(reason, 0) + 1
        self._last_unschedulable_top = dict(
            sorted(top.items(), key=lambda kv: (-kv[1], kv[0])))

    def pod_trace_id(self, name: str) -> str | None:
        """The pod's trace id: None, since the port traces no pods yet (the
        JAX scheduler's answer without ``trace_pods``)."""
        return None

    def pod_explanation(self, name: str) -> PlacementExplanation | None:
        """Latest retained :class:`PlacementExplanation` of a pod."""
        return self.explain_ring.get(name)

    def explain_candidates(self, name: str, k: int = 5) -> list[dict] | None:
        """Per-term score decomposition (``ops/explain.decompose_scores``)
        of a pending pod's top-k feasible nodes, or a bound pod's node,
        against the current state; None for an unknown pod."""
        pod = self.pending.get(name)
        bound = self.bound.get(name)
        if pod is None and bound is None:
            return None
        self.snapshot.flush()
        state = self.snapshot.state

        def decompose(batch, node_rows: np.ndarray) -> list[dict]:
            cand = torch.from_numpy(
                node_rows[None, :].astype(np.int32)).to(self.device)
            terms = {t: v[0].cpu().numpy()
                     for t, v in ex.decompose_scores(
                         state, batch, self.config, cand).items()}
            return [
                {"node": self.snapshot.node_name(int(r)) or str(int(r)),
                 "score": int(terms["total"][j]),
                 "terms": {t: int(v[j]) for t, v in terms.items()
                           if t != "total"}}
                for j, r in enumerate(node_rows)
            ]

        if pod is not None:
            batch = PodBatch.build(
                pod.requests[None].astype(np.int32),
                priority=np.array([pod.priority], np.int32),
                feasible=self.snapshot.feasibility_row(pod)[None],
                node_capacity=self.snapshot.capacity, capacity=16,
                device=self.device)
            scores, feasible = score_pods(state, batch, self.config)
            row = scores[0].cpu().numpy()
            masked = np.where(feasible[0].cpu().numpy(), row, -1)
            order = np.argsort(-masked, kind="stable")[:max(k, 1)]
            order = order[masked[order] >= 0]
            if order.size == 0:
                return []
            return decompose(batch, order)
        row_idx = self.snapshot.node_index.get(bound.node)
        if row_idx is None:
            return []
        batch = PodBatch.build(
            bound.requests[None].astype(np.int32),
            node_capacity=self.snapshot.capacity, capacity=16,
            device=self.device)
        out = decompose(batch, np.array([row_idx], np.int32))
        out[0]["winner"] = True
        return out
