"""Incremental cluster snapshot: informer deltas -> device tensors (port of
``koordinator_tpu/scheduler/snapshot.py`` without solver sharding).

The host keeps name -> row maps and a dirty-row set; :meth:`flush` ships only
changed rows, written IN PLACE into the device tensors (``index_copy_``).
Capacity grows by power-of-two buckets.  A second dirty set,
``_cand_dirty``, names the rows whose solver-visible state changed since the
scheduler's incremental candidate cache last consumed them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.state.cluster_state import ClusterState, _bucket


@dataclasses.dataclass
class NodeSpec:
    """Host-side node record (what the Node informer + NodeMetric deliver)."""

    name: str
    allocatable: np.ndarray                 # (R,) int32
    usage: np.ndarray | None = None         # (R,) int32
    agg_usage: np.ndarray | None = None     # (R,) int32
    prod_usage: np.ndarray | None = None    # (R,) int32
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    #: NoSchedule taints as key -> value (a pod needs a matching toleration)
    taints: dict[str, str] = dataclasses.field(default_factory=dict)

    def signature(self) -> tuple:
        """Label/taint equivalence-class signature."""
        return (tuple(sorted(self.labels.items())),
                tuple(sorted(self.taints.items())))


@dataclasses.dataclass
class PodSpec:
    """Host-side pending pod."""

    name: str
    requests: np.ndarray                    # (R,) int32
    priority: int = 0
    qos: int = 0
    gang: str | None = None
    quota: str | None = None
    non_preemptible: bool = False
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    #: tolerated NoSchedule taints (key -> value)
    tolerations: dict[str, str] = dataclasses.field(default_factory=dict)
    creation: float = 0.0
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    #: controller key for reservation owner matching
    owner: str | None = None
    #: pod.spec.preemptionPolicy: "Never" opts out of preempting others
    #: (PodEligibleToPreemptOthers, elasticquota/preempt.go:62)
    preemption_policy: str = "PreemptLowerPriority"
    #: manager-side ingest wall clock (the journey ledger's arrival stamp);
    #: 0.0 when none rode in.  Never read by the solve or the pending sort
    #: key (that is ``creation``), so it cannot change a decision
    arrival_ts: float = 0.0


class ClusterSnapshot:
    """Name-indexed view over the device-resident ClusterState."""

    def __init__(self, capacity: int = 64, dims: int = NUM_RESOURCE_DIMS,
                 device=None):
        self.device = resolve_device(device)
        self.dims = dims
        self.state = ClusterState.zeros(capacity, dims, self.device)
        self.node_index: dict[str, int] = {}
        self._row_to_name: dict[int, str] = {}
        self.node_specs: dict[str, NodeSpec] = {}
        self._free_rows: list[int] = list(range(capacity - 1, -1, -1))
        self._dirty: set[int] = set()
        #: rows whose solver-visible state changed since the candidate cache
        #: last consumed them: spec upserts and removals AND accounting
        #: changes (solve adoption); a superset of _dirty, which only tracks
        #: host-spec rows pending a device flush
        self._cand_dirty: set[int] = set()
        # rows whose accumulated node_requested must be zeroed (freed by
        # remove_node; a reused row must not inherit the dead node's
        # accounting)
        self._reset_requested: set[int] = set()
        #: per-name INSTANCE counter, bumped each time a name (re)appears
        #: with a fresh row: a pod or reservation charged to the previous
        #: instance of a removed-then-readded node must not decrement the
        #: new one (a re-added node starts clean)
        self.node_generation: dict[str, int] = {}
        # label/taint equivalence classes: signature -> class id (never
        # recycled); the (P, C) selector masks index them via node_class
        self._class_index: dict[tuple, int] = {}
        self._class_sigs: list[tuple] = []
        #: (live rows, their class ids), rebuilt after a node upsert/remove
        self._row_classes: tuple[np.ndarray, np.ndarray] | None = None
        #: clock time of the last applied sync event (delta/heartbeat) from
        #: whatever informer feeds this snapshot; None until the feed first
        #: speaks.  The scheduler's staleness watchdog reads its AGE: a
        #: stalled feed means every usage- and batch-allocatable-derived
        #: row here is untrustworthy
        self.last_sync_time: float | None = None

    def mark_sync(self, now: float) -> None:
        """Stamp feed liveness (monotonic under the writer's clock)."""
        self.last_sync_time = now

    def staleness(self, now: float) -> float | None:
        """Seconds since the feed last spoke; None before first contact."""
        if self.last_sync_time is None:
            return None
        return max(0.0, now - self.last_sync_time)

    @property
    def class_capacity(self) -> int:
        """Padded equivalence-class count for (P, C) selector masks."""
        return _bucket(max(len(self._class_sigs), 1), minimum=8)

    @property
    def class_count(self) -> int:
        """Registered equivalence classes (ids never recycle): batch cache
        keys use this, not class_capacity, so a new class within the same
        padding bucket still invalidates."""
        return len(self._class_sigs)

    @property
    def capacity(self) -> int:
        return self.state.capacity

    def _class_of(self, spec: NodeSpec) -> int:
        sig = spec.signature()
        cid = self._class_index.get(sig)
        if cid is None:
            cid = len(self._class_sigs)
            self._class_index[sig] = cid
            self._class_sigs.append(sig)
        return cid

    @staticmethod
    def _pod_allows(pod: PodSpec, labels: tuple, taints: tuple) -> bool:
        lbl = dict(labels)
        if any(lbl.get(k) != v for k, v in pod.node_selector.items()):
            return False
        return all(pod.tolerations.get(k) == v for k, v in taints)

    def selector_row_for(self, pod: PodSpec) -> np.ndarray:
        """(class_capacity,) bool: which node equivalence classes the pod's
        nodeSelector + tolerations admit."""
        row = np.zeros(self.class_capacity, bool)
        for cid, (labels, taints) in enumerate(self._class_sigs):
            row[cid] = self._pod_allows(pod, labels, taints)
        return row

    # -- node lifecycle -----------------------------------------------------

    def upsert_node(self, spec: NodeSpec) -> int:
        row = self.node_index.get(spec.name)
        if row is None:
            if not self._free_rows:
                self._grow()
            row = self._free_rows.pop()
            if row in self._reset_requested:
                # a freed row reused before the pending flush: zero the dead
                # node's accounting now, before anything charges the new one
                # (a pinned reservation opening before the flush, whose
                # later release must balance to zero)
                self._reset_requested.discard(row)
                self.state.node_requested[row] = 0
            self.node_index[spec.name] = row
            self._row_to_name[row] = spec.name
            self.node_generation[spec.name] = (
                self.node_generation.get(spec.name, -1) + 1)
        self.node_specs[spec.name] = spec
        self._class_of(spec)
        self._row_classes = None
        self._dirty.add(row)
        self._cand_dirty.add(row)
        return row

    def remove_node(self, name: str) -> None:
        row = self.node_index.pop(name, None)
        if row is None:
            return
        del self.node_specs[name]
        del self._row_to_name[row]
        self._row_classes = None
        self._free_rows.append(row)
        self._dirty.add(row)
        self._cand_dirty.add(row)
        self._reset_requested.add(row)

    def _grow(self) -> None:
        old_cap = self.capacity
        new_cap = _bucket(old_cap + 1)
        old = self.state

        def pad(a):
            out = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype,
                              device=a.device)
            out[:old_cap] = a
            return out

        self.state = ClusterState(
            node_allocatable=pad(old.node_allocatable),
            node_requested=pad(old.node_requested),
            node_usage=pad(old.node_usage),
            node_agg_usage=pad(old.node_agg_usage),
            node_prod_usage=pad(old.node_prod_usage),
            node_valid=pad(old.node_valid),
            node_class=pad(old.node_class),
        )
        self._free_rows = (list(range(new_cap - 1, old_cap - 1, -1))
                           + self._free_rows)

    # -- delta flush ---------------------------------------------------------

    def flush(self) -> int:
        """Write dirty rows to the device tensors in place, in one row
        scatter per tensor.  Returns rows shipped."""
        if not self._dirty:
            return 0
        rows = sorted(self._dirty)
        self._dirty.clear()
        if self._reset_requested:
            reset = torch.tensor(sorted(self._reset_requested),
                                 dtype=torch.long, device=self.device)
            self._reset_requested.clear()
            self.state.node_requested.index_fill_(0, reset, 0)
        k = len(rows)
        alloc = np.zeros((k, self.dims), np.int32)
        usage = np.zeros((k, self.dims), np.int32)
        agg = np.zeros((k, self.dims), np.int32)
        prod = np.zeros((k, self.dims), np.int32)
        valid = np.zeros(k, bool)
        nclass = np.zeros(k, np.int32)
        for i, r in enumerate(rows):
            name = self._row_to_name.get(r)
            if name is None:
                continue  # removed node: stays zero/invalid
            spec = self.node_specs[name]
            alloc[i] = spec.allocatable
            if spec.usage is not None:
                usage[i] = spec.usage
            agg[i] = spec.agg_usage if spec.agg_usage is not None else usage[i]
            prod[i] = (spec.prod_usage if spec.prod_usage is not None
                       else usage[i])
            valid[i] = True
            nclass[i] = self._class_of(spec)
        self.state.scatter_update(
            torch.from_numpy(np.asarray(rows, np.int64)),
            node_allocatable=torch.from_numpy(alloc),
            node_usage=torch.from_numpy(usage),
            node_agg_usage=torch.from_numpy(agg),
            node_prod_usage=torch.from_numpy(prod),
            node_valid=torch.from_numpy(valid),
            node_class=torch.from_numpy(nclass),
        )
        return k

    # -- accounting ---------------------------------------------------------

    def reserve(self, node: str, requests: np.ndarray) -> None:
        """Account a binding onto a node (Reserve), in place."""
        row = self.node_index[node]
        self._cand_dirty.add(row)
        self.state.node_requested[row] += torch.from_numpy(
            np.asarray(requests).astype(np.int32)).to(self.device)

    def reserve_batch(self, requests_by_node) -> None:
        """Account many bindings in one device op; the same bits as
        sequential :meth:`reserve` (integer adds commute)."""
        if not requests_by_node:
            return
        add = np.zeros(tuple(self.state.node_requested.shape), np.int32)
        for node, requests in requests_by_node.items():
            row = self.node_index[node]
            self._cand_dirty.add(row)
            add[row] += requests.astype(np.int32)
        self.state.node_requested += torch.from_numpy(add).to(self.device)

    def unreserve(self, node: str, requests: np.ndarray) -> None:
        row = self.node_index[node]
        self._cand_dirty.add(row)
        self.state.node_requested[row] -= torch.from_numpy(
            np.asarray(requests).astype(np.int32)).to(self.device)

    def unreserve_instance(self, node: str, requests: np.ndarray,
                           generation: int) -> None:
        """Release a charge made against a SPECIFIC node instance: a no-op
        when the node is gone or the name now labels a fresh instance (a
        re-added node starts clean).  Every release whose record can
        outlive the node (bound pods, reservation remainders) comes through
        here."""
        if node not in self.node_index:
            return
        if self.node_generation.get(node, 0) != generation:
            return
        self.unreserve(node, requests)

    def adopt_state(self, state: ClusterState, changed_rows=None) -> None:
        """Adopt solver-updated accounting (post gang/greedy assign).

        ``changed_rows`` names the node rows whose ``node_requested`` the
        solver touched (the assigned rows), so the candidate cache only
        invalidates those; None marks every valid row dirty."""
        if state.capacity != self.capacity:
            raise ValueError("state capacity mismatch")
        if changed_rows is None:
            self._cand_dirty.update(self.node_index.values())
        else:
            self._cand_dirty.update(int(r) for r in changed_rows)
        self.state = state

    def consume_candidate_dirty(self) -> list[int]:
        """Rows dirtied since the last consume (sorted), clearing the set:
        called exactly when the candidate cache is rebuilt or refreshed."""
        rows = sorted(self._cand_dirty)
        self._cand_dirty.clear()
        return rows

    # -- queries ------------------------------------------------------------

    def node_name(self, row: int) -> str | None:
        return self._row_to_name.get(row)

    def feasibility_row(self, pod: PodSpec) -> np.ndarray:
        """(N,) bool selector/toleration mask of one pod over the live node
        rows (False elsewhere): the pod's class row expanded through each
        live node's class, the same bits as testing every node's labels
        and taints."""
        mask = np.zeros(self.capacity, bool)
        if self._row_classes is None:
            self._row_classes = (
                np.fromiter(self.node_index.values(), np.int64,
                            len(self.node_index)),
                np.fromiter((self._class_of(self.node_specs[name])
                             for name in self.node_index), np.int64,
                            len(self.node_index)))
        rows, classes = self._row_classes
        mask[rows] = self.selector_row_for(pod)[classes]
        return mask
