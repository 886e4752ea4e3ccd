"""Incremental cluster-state sync: snapshot + resource-version'd deltas
(port of ``koordinator_tpu/transport/deltasync.py``).

The reference keeps the solver-visible world current through apiserver
watch streams: informers replay a LIST (snapshot at a resourceVersion)
then stream WATCH events; a client that falls behind the retained event
window gets HTTP 410 Gone and must re-LIST. This module is that protocol
over the framed RPC layer, feeding the solver's device-resident tensors:

- :class:`StateSyncService` is the informer side: it owns the object
  cache (nodes/pods), stamps every mutation with a monotonically
  increasing resource version, retains a bounded delta log, serves HELLO
  as ACK (caught up) / DELTA (replay window) / SNAPSHOT (fell behind),
  and pushes DELTA frames to connected solvers (the WATCH stream).
- :class:`StateSyncClient` is the solver side: applies frames
  idempotently (events at or below its rv are skipped, so replays and
  reconnect overlaps are harmless), requests resync when told, and hands
  decoded objects to the snapshot/scheduler through a binding.

Deltas carry their resource vectors as raw (K, R) int32 blocks — the
host->device path stays a scatter of K rows, never a rebuild
(SURVEY.md §7 "hard parts (a)").
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Optional

import numpy as np

from koordinator_tpu_torch import metrics, timeline, tracing
from koordinator_tpu_torch.transport import channel, wire
from koordinator_tpu_torch.transport.wire import FrameType

NODE_UPSERT = "node_upsert"
NODE_USAGE = "node_usage"
NODE_ALLOC = "node_allocatable"
NODE_DEVICES = "node_devices"
NODE_REMOVE = "node_remove"
POD_ADD = "pod_add"
POD_REMOVE = "pod_remove"
RSV_UPSERT = "rsv_upsert"
RSV_REMOVE = "rsv_remove"


class ResyncRequired(Exception):
    """Client fell behind the retained window (HTTP 410 Gone analog)."""


class UnknownNodeError(wire.WireSchemaError):
    """A merge-style event (node_usage / node_allocatable / node_devices)
    named a node this service doesn't know.  For an in-process caller
    that is a peer bug (plain schema error); for a WIRE client it
    usually means the client's watch view predates a service restart
    that lost the node — the ERROR frame carries ``resync: true`` so the
    client re-HELLOs instead of failing the same push forever."""

    resync = True


class DeltaLog:
    """Bounded ordered log of (rv, event, arrays)."""

    def __init__(self, retention: int = 4096):
        self.retention = retention
        self._events: deque[tuple[int, dict, dict[str, np.ndarray]]] = deque()

    def append(self, rv: int, event: dict,
               arrays: dict[str, np.ndarray]) -> None:
        self._events.append((rv, event, arrays))
        while len(self._events) > self.retention:
            self._events.popleft()

    def oldest_rv(self) -> Optional[int]:
        return self._events[0][0] if self._events else None

    def since(self, rv: int) -> list[tuple[int, dict, dict[str, np.ndarray]]]:
        """All events with rv' > rv. Raises ResyncRequired when rv is
        before the retained window."""
        oldest = self.oldest_rv()
        if oldest is not None and rv < oldest - 1:
            raise ResyncRequired(f"rv {rv} < retained window start {oldest}")
        return [(v, e, a) for v, e, a in self._events if v > rv]


def _pack_events(
    events: list[tuple[int, dict, dict[str, np.ndarray]]]
) -> tuple[dict, dict[str, np.ndarray]]:
    """Stack per-event arrays into (K, R) blocks referenced by row index."""
    docs = []
    stacked: dict[str, list[np.ndarray]] = {}
    for rv, event, arrays in events:
        entry = dict(event, rv=rv)
        for key, arr in arrays.items():
            rows = stacked.setdefault(key, [])
            entry[f"__row_{key}__"] = len(rows)
            rows.append(np.asarray(arr))
        docs.append(entry)
    return ({"events": docs},
            {k: np.stack(v) for k, v in stacked.items()})


# -- columnar event codec (wire protocol v4) ---------------------------------
#
# The v1 packing above serializes one JSON document PER EVENT (name,
# kind, rv, and a __row_*__ manifest each) — at snapshot scale that is
# tens of thousands of json.dumps/loads round trips, the largest
# ``json_codec`` contributor in the host-wait attribution.  The v2
# packing moves the per-event constants into columnar numpy arrays that
# ride the raw array section: kind codes (uint8), rvs (int64), names
# (length + utf-8 blob columns), and one int32 row-index column per
# stacked array key.  Event fields beyond the columns — labels, trace
# contexts, reservation owners — ride a SPARSE ``extras`` list holding
# only non-default fields, so the steady-state hot kinds (node_usage,
# pod_remove) carry zero JSON per event.  Decoding reconstructs the
# exact v1 entry list, so everything downstream of the codec (rv
# guards, bindings, replay) is byte-for-byte unchanged.

_KIND_CODES = {NODE_UPSERT: 0, NODE_USAGE: 1, NODE_ALLOC: 2,
               NODE_DEVICES: 3, NODE_REMOVE: 4, POD_ADD: 5,
               POD_REMOVE: 6, RSV_UPSERT: 7, RSV_REMOVE: 8}
_CODE_KINDS = {v: k for k, v in _KIND_CODES.items()}

#: per-kind default fields elided from the wire and reconstructed at
#: decode — MUST mirror the event docs the mutation methods build
#: (upsert_node / add_pod / upsert_reservation), or round-tripped
#: entries stop being equal to the originals
_V2_DEFAULTS: dict[str, dict] = {
    NODE_UPSERT: {"labels": {}, "taints": {}, "annotations": {},
                  "devices": {}},
    POD_ADD: {"priority": 0, "quota": None, "gang": None,
              "node_selector": {}, "labels": {}, "owner": None, "qos": 0},
    RSV_UPSERT: {"owners": [], "allocate_once": False, "ttl_sec": None,
                 "node": None, "node_selector": {}, "tolerations": {},
                 "restricted": False},
}


def _pack_events_v2(
    events: list[tuple[int, dict, dict[str, np.ndarray]]]
) -> tuple[dict, dict[str, np.ndarray]] | None:
    """Columnar packing (see above).  Returns None when any event's kind
    has no code — the caller falls back to the v1 packing so a new event
    kind degrades to JSON instead of breaking the stream."""
    # hot loop: list appends + one vectorized column fill per key beat
    # per-event numpy scalar stores by ~2x at snapshot scale
    k = len(events)
    kinds: list[int] = []
    rvs: list[int] = []
    names: list[str] = []
    extras: list[list] = []
    stacked: dict[str, list[np.ndarray]] = {}
    positions: dict[str, list[int]] = {}
    kind_codes = _KIND_CODES
    v2_defaults = _V2_DEFAULTS
    for i, (rv, event, arrays) in enumerate(events):
        kind = event.get("kind")
        code = kind_codes.get(kind)
        if code is None:
            return None
        kinds.append(code)
        rvs.append(rv)
        names.append(event["name"])
        if len(event) > 2:  # anything beyond kind+name rides extras
            defaults = v2_defaults.get(kind)
            if defaults is None:
                extra = {key: val for key, val in event.items()
                         if key != "kind" and key != "name"}
            else:
                extra = {key: val for key, val in event.items()
                         if key != "kind" and key != "name"
                         and not (key in defaults
                                  and val == defaults[key])}
            if extra:
                extras.append([i, extra])
        if arrays:
            for key, arr in arrays.items():
                rows = stacked.get(key)
                if rows is None:
                    rows = stacked[key] = []
                    positions[key] = []
                positions[key].append(i)
                rows.append(np.asarray(arr))
    out_arrays: dict[str, np.ndarray] = {
        "__kinds__": np.asarray(kinds, np.uint8),
        "__rvs__": np.asarray(rvs, np.int64)}
    name_lens, name_blob = wire.pack_str_column(names)
    out_arrays["__name_lens__"] = name_lens
    out_arrays["__name_blob__"] = name_blob
    for key, blocks in stacked.items():
        col = np.full(k, -1, np.int32)
        col[positions[key]] = np.arange(len(blocks), dtype=np.int32)
        out_arrays[f"__rows_{key}__"] = col
        out_arrays[key] = np.stack(blocks)
    doc: dict = {"events_v2": k}
    if extras:
        doc["extras"] = extras
    return doc, out_arrays


def _unpack_events_v2(doc: dict,
                      arrays: dict[str, np.ndarray]) -> list[dict]:
    """Inverse of :func:`_pack_events_v2`: reconstruct the ordered v1
    entry list (``__row_*__`` indices included, so
    :func:`_unpack_event_arrays` works unchanged on the result)."""
    k = int(doc["events_v2"])
    try:
        kinds = arrays["__kinds__"]
        rvs = arrays["__rvs__"]
        names = wire.unpack_str_column(arrays["__name_lens__"],
                                       arrays["__name_blob__"])
    except KeyError as e:
        raise wire.WireSchemaError(
            f"events_v2 frame missing column {e}") from e
    if len(kinds) != k or len(rvs) != k or len(names) != k:
        raise wire.WireSchemaError(
            f"events_v2 column lengths disagree with count {k}")
    extras = {int(i): e for i, e in doc.get("extras", [])}
    # numpy scalar indexing costs ~100ns a pop; one tolist() per column
    # up front makes the reconstruction loop pure-Python cheap
    kinds_l = kinds.tolist()
    rvs_l = rvs.tolist()
    row_cols: list[tuple[str, list]] = []
    for key in arrays:
        if key.startswith("__rows_") and key.endswith("__"):
            col = arrays[key].tolist()
            if len(col) != k:
                raise wire.WireSchemaError(
                    f"events_v2 row column {key} has {len(col)} rows, "
                    f"expected {k}")
            row_cols.append((f"__row_{key[len('__rows_'):-2]}__", col))
    entries: list[dict] = []
    code_kinds = _CODE_KINDS
    v2_defaults = _V2_DEFAULTS
    for i in range(k):
        kind = code_kinds.get(kinds_l[i])
        if kind is None:
            raise wire.WireSchemaError(
                f"events_v2 frame carries unknown kind code "
                f"{kinds_l[i]}")
        entry: dict = {"kind": kind, "name": names[i]}
        defaults = v2_defaults.get(kind)
        if defaults is not None:
            for key, val in defaults.items():
                # fresh containers per entry: binding handlers treat
                # entry values as read-only, but shared mutables across
                # entries would make any future slip a cross-event
                # corruption
                entry[key] = (dict(val) if isinstance(val, dict)
                              else list(val) if isinstance(val, list)
                              else val)
        ex = extras.get(i)
        if ex is not None:
            entry.update(ex)
        entry["rv"] = rvs_l[i]
        for row_key, col in row_cols:
            row = col[i]
            if row >= 0:
                entry[row_key] = row
        entries.append(entry)
    return entries


def _decode_events(doc: dict, arrays: dict[str, np.ndarray]) -> list[dict]:
    """Normalize a DELTA/SNAPSHOT payload to the v1 entry list,
    whichever codec produced it."""
    if "events_v2" in doc:
        return _unpack_events_v2(doc, arrays)
    return doc.get("events", [])


def _unpack_event_arrays(entry: dict,
                         arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    out = {}
    for key, row in entry.items():
        if key.startswith("__row_") and key.endswith("__"):
            name = key[6:-2]
            out[name] = arrays[name][row]
    return out


def _validate_devices(devices: dict | None, context: str) -> None:
    """Reject malformed device inventories at EVERY entry point (wire
    push AND the direct upsert_node/update_node_devices API): a non-list
    type value would commit to the log and then silently skip
    registration on replay while `full_inventory` clearing sees the type
    as present — the exact live-vs-replay divergence the clearing
    exists to prevent."""
    if devices is None:
        return
    if not wire.check_field_type(devices, dict):
        raise wire.WireSchemaError(
            f"{context}: 'devices' must be an object, "
            f"got {type(devices).__name__}")
    for dev_type, inventory in devices.items():
        if not isinstance(inventory, list) or any(
                not isinstance(entry, dict) for entry in inventory):
            raise wire.WireSchemaError(
                f"{context}: devices[{dev_type!r}] must be a list "
                f"of objects")
        for entry in inventory:
            # entries feed DeviceState.build's int tensors on replay
            for field in ("core", "memory", "group"):
                if not wire.check_field_type(
                        entry.get(field, 0), int):
                    raise wire.WireSchemaError(
                        f"{context}: devices[{dev_type!r}] entry "
                        f"field {field!r} must be an integer")


class StateSyncService:
    """Informer-side state authority + wire handlers.

    Attach to an RpcServer:

        service = StateSyncService()
        service.attach(server)

    then mutate via upsert_node/remove_node/add_pod/remove_pod; every
    mutation bumps the rv, logs a delta, and pushes it to subscribers.
    """

    def __init__(self, retention: int = 4096):
        self._lock = threading.RLock()
        self.rv = 0
        #: boot-epoch id: a restarted service resets its rv counter, and
        #: a client whose last_rv happens to EQUAL the new service's rv
        #: would get a bare ACK and keep a permanently stale view (a
        #: manager's reconnect path depends on restart => resync).
        #: HELLO compares instances; a mismatch forces the full snapshot
        #: regardless of rv.
        import uuid

        self.instance = uuid.uuid4().hex
        self.log = DeltaLog(retention)
        self.nodes: dict[str, dict] = {}      # name -> {doc, arrays}
        self.pods: dict[str, dict] = {}       # name -> {doc, arrays}
        self.reservations: dict[str, dict] = {}
        self._server = None
        self._local_bindings: list = []
        #: committed events awaiting local-binding apply; populated under
        #: _lock (so it carries rv order), drained under _binding_lock
        #: only — binding applies block on scheduler.lock and must never
        #: hold the service lock while they do
        self._binding_queue: deque = deque()
        self._binding_lock = threading.Lock()
        #: high-water mark of the binding backlog (gauge shadow; only
        #: ever written under _lock alongside the append)
        self._backlog_peak = 0

    # -- mutations (informer event handlers) --------------------------------

    def attach_binding(self, binding) -> None:
        """Register an IN-PROCESS subscriber (e.g. a SchedulerBinding):
        every committed event is applied to it synchronously, so a
        sidecar binary whose solver lives in the same process as its
        sync service sees pushed state immediately — no socket loop, no
        eventual-consistency window.  Remote sync clients keep the
        broadcast path."""
        self._local_bindings.append(binding)

    def _store_and_commit(self, store_fn, event: dict,
                          arrays: dict[str, np.ndarray]) -> int:
        """Run a stored-state mutation AND append+broadcast its event
        under ONE lock acquisition, so rv order, wire order, and stored
        state always agree (the client's idempotency guard drops any rv
        it has already passed, so reordered broadcasts would lose
        events; a store released before the log append lets a racing
        mutator interleave — e.g. upsert_node(devices={}) vs
        update_node_devices(X) could log [devices=X, upsert={}] while
        storing devices=X, and the stale stored doc would then eat every
        subsequent identical heartbeat as 'unchanged').  Safe to hold:
        broadcast only enqueues to bounded per-connection queues — a
        stalled peer drops frames and gets poisoned, it cannot wedge the
        service (channel._Conn.send)."""
        with self._lock:
            store_fn()
            rv = self._commit_locked(event, arrays)
        # apply OUTSIDE the service lock: bindings block on the scheduler
        # lock (a long solve), and holding _lock through that would stall
        # every HELLO/push/broadcast behind it.  The queue was filled in
        # rv order under _lock; draining FIFO under _binding_lock keeps
        # that order even when two pushers race to drain.
        if self._local_bindings:
            self._drain_bindings()
        return rv

    def _commit_locked(self, event: dict,
                       arrays: dict[str, np.ndarray]) -> int:
        """The lock-held half of _commit, for mutations that must merge
        stored state and log the event ATOMICALLY (update_node_usage /
        update_node_devices: a racing pair must not leave the stored doc
        and the delta-log tail disagreeing).  Caller holds _lock and
        must call _drain_bindings() after releasing it."""
        # trace propagation: the mutation's originating context (a
        # traced STATE_PUSH dispatch, an instrumented in-process caller)
        # is stamped onto the event itself, so DELTA watchers, the
        # bounded replay log, AND bootstrap snapshots (the stored doc is
        # this same dict for upsert-style events) all carry it — a pod's
        # trace survives a client resync the same way its spec does
        ctx = tracing.current_context()
        if ctx is not None and tracing.TRACE_DOC_KEY not in event:
            event[tracing.TRACE_DOC_KEY] = ctx.to_doc()
        self.rv += 1
        rv = self.rv
        self.log.append(rv, event, arrays)
        if self._server is not None:
            batch = [(rv, event, arrays)]
            packed = _pack_events_v2(batch)
            if packed is None:
                # unknown kind: everyone gets the v1 JSON form
                doc, stacked = _pack_events(batch)
                self._server.broadcast(FrameType.DELTA, doc, stacked)
            else:
                # columnar frame to v4+ peers; legacy encodes the v1
                # frame lazily, ONLY if some negotiated-down peer is
                # actually connected (a pure-v4 fleet never pays it)
                doc, stacked = packed
                self._server.broadcast(
                    FrameType.DELTA, doc, stacked, min_proto=4,
                    legacy=lambda: _pack_events(batch))
        if self._local_bindings:
            self._binding_queue.append((event, arrays))
            # backlog watermark: depth sampled at append (the
            # only place it grows) plus a monotone high-water gauge —
            # the steady-state soak bounds the peak, the trend engine
            # watches it for leak-shaped growth
            depth = len(self._binding_queue)
            metrics.sync_binding_backlog.set(float(depth))
            if depth > self._backlog_peak:
                self._backlog_peak = depth
                metrics.sync_binding_backlog_peak.set(float(depth))
        return rv

    def _drain_bindings(self) -> None:
        # drain the WHOLE backlog, then route it as one ordered batch so
        # contiguous same-kind runs (a koordlet heartbeat sweep, a
        # loadgen pod burst) hit the binding's vectorized run apply —
        # one scheduler.lock round-trip per run, not per event
        with self._binding_lock:
            while True:
                items: list[tuple[dict, dict]] = []
                while True:
                    try:
                        items.append(self._binding_queue.popleft())
                    except IndexError:
                        break
                if not items:
                    metrics.sync_binding_backlog.set(0.0)
                    return
                for binding in self._local_bindings:
                    _dispatch_events(binding, items)

    def upsert_node(self, name: str, allocatable: np.ndarray,
                    usage: np.ndarray | None = None,
                    labels: dict | None = None,
                    taints: dict | None = None,
                    annotations: dict | None = None,
                    devices: dict | None = None) -> int:
        """``annotations`` carries the koordlet's NRT payload (cpu-topology
        etc.); ``devices`` carries the Device-CR inventory per type
        ({type: [{"core": c, "memory": b, "group": g}, ...]}) — both feed
        the scheduler's fine-grained allocators on the client side."""
        _validate_devices(devices, "upsert_node")
        arrays = {
            "allocatable": np.asarray(allocatable, np.int32),
            "usage": (np.asarray(usage, np.int32) if usage is not None
                      else np.zeros_like(allocatable, np.int32)),
        }
        doc = {"kind": NODE_UPSERT, "name": name,
               "labels": labels or {}, "taints": taints or {},
               "annotations": annotations or {}, "devices": devices or {}}
        def store():
            self.nodes[name] = {"doc": doc, "arrays": arrays}

        return self._store_and_commit(store, doc, arrays)

    def update_node_usage(self, name: str, usage: np.ndarray,
                          agg_usage: np.ndarray | None = None,
                          prod_usage: np.ndarray | None = None,
                          sys_usage: np.ndarray | None = None,
                          hp_usage: np.ndarray | None = None,
                          hp_request: np.ndarray | None = None,
                          hp_max_used_req: np.ndarray | None = None,
                          report_time: float | None = None) -> int:
        """The NodeMetric loop's wire form (SURVEY §3.2): refresh a
        node's USAGE without re-sending allocatable — what a koordlet's
        reporter knows.  The stored node entry merges the new usage so a
        later bootstrap snapshot carries it; live watchers get the
        NODE_USAGE delta.  Unknown node -> WireSchemaError (nothing
        enters the log: usage for a node nobody registered is a peer
        bug, and replaying it would apply to nothing).

        ``sys_usage`` (system daemons outside kube pods) and
        ``hp_usage`` (Prod+Mid pods: non-BE, priority >= mid band) are
        the colocation formula's inputs (slo-controller/noderesource
        plugins/util/util.go:55: Batch = Total - SafetyMargin -
        max(System, Reserved) - HP.Used) — a manager watch client
        consumes them; the scheduler binding ignores them.
        ``hp_request`` (sum of HP pods' REQUESTS) and ``hp_max_used_req``
        (per-pod max(request, usage) summed over HP pods) feed the
        ``request``/``maxUsageRequest`` calculate policies — without
        them a wire-fed manager silently over-advertises batch capacity
        under those policies.  ``report_time`` is the KOORDLET's report
        timestamp (NodeMetric update_time): consumers date the usage by
        it, not by their apply-time clock, so degrade windows survive a
        manager restart + bootstrap replay."""
        arrays: dict[str, np.ndarray] = {
            "usage": np.asarray(usage, np.int32)}
        if agg_usage is not None:
            arrays["agg_usage"] = np.asarray(agg_usage, np.int32)
        if prod_usage is not None:
            arrays["prod_usage"] = np.asarray(prod_usage, np.int32)
        if sys_usage is not None:
            arrays["sys_usage"] = np.asarray(sys_usage, np.int32)
        if hp_usage is not None:
            arrays["hp_usage"] = np.asarray(hp_usage, np.int32)
        if hp_request is not None:
            arrays["hp_request"] = np.asarray(hp_request, np.int32)
        if hp_max_used_req is not None:
            arrays["hp_max_used_req"] = np.asarray(hp_max_used_req,
                                                   np.int32)
        event: dict = {"kind": NODE_USAGE, "name": name}
        if report_time is not None:
            event["usage_time"] = float(report_time)
        with self._lock:
            entry = self.nodes.get(name)
            if entry is None:
                raise UnknownNodeError(
                    f"node_usage for unknown node {name!r}")
            entry["arrays"] = dict(entry["arrays"], **arrays)
            if report_time is not None:
                # merge into the stored doc so a bootstrap snapshot
                # replays the ORIGINAL report time, not the apply time
                entry["doc"] = dict(entry["doc"],
                                    usage_time=float(report_time))
            rv = self._commit_locked(event, arrays)
        if self._local_bindings:
            self._drain_bindings()
        return rv

    def update_node_allocatable(self, name: str,
                                allocatable: np.ndarray) -> int:
        """The noderesource controller's wire form (SURVEY §3.2's
        manager leg): replace a node's ALLOCATABLE vector without
        touching its usage, labels, taints, or device inventory — the
        tensor analog of the reference's node-status extended-resource
        patch (slo-controller/noderesource/noderesource_controller.go:71
        -> plugins/batchresource/plugin.go:188 -> PATCH node.status).  A
        full node_upsert from the manager would clobber the koordlet's
        device inventory (upsert replaces the stored doc wholesale);
        this event merges.  Unknown node -> WireSchemaError, same rule
        as node_usage."""
        arrays = {"allocatable": np.asarray(allocatable, np.int32)}
        with self._lock:
            entry = self.nodes.get(name)
            if entry is None:
                raise UnknownNodeError(
                    f"node_allocatable for unknown node {name!r}")
            entry["arrays"] = dict(entry["arrays"], **arrays)
            rv = self._commit_locked(
                {"kind": NODE_ALLOC, "name": name}, arrays)
        if self._local_bindings:
            self._drain_bindings()
        return rv

    def update_node_devices(self, name: str,
                            devices: dict[str, list[dict]]) -> int:
        """Device-CR refresh (the device daemon's report loop in wire
        form): replace a node's device inventory without re-sending
        allocatable.  Merges into the stored node doc so bootstrap
        replay carries it; same unknown-node posture as node_usage."""
        _validate_devices(devices, "update_node_devices")
        with self._lock:
            entry = self.nodes.get(name)
            if entry is None:
                raise UnknownNodeError(
                    f"node_devices for unknown node {name!r}")
            if entry["doc"].get("devices") == devices:
                # unchanged heartbeat (the koordlet sink re-pushes every
                # interval so a clearing re-upsert gets repaired): no
                # log append, no watcher wakeup — an N-node cluster
                # heartbeating would otherwise shrink the bounded
                # delta-log retention to ~4096/N intervals
                return self.rv
            entry["doc"] = dict(entry["doc"], devices=dict(devices))
            rv = self._commit_locked(
                {"kind": NODE_DEVICES, "name": name,
                 "devices": dict(devices)}, {})
        if self._local_bindings:
            self._drain_bindings()
        return rv

    def remove_node(self, name: str) -> int:
        return self._store_and_commit(
            lambda: self.nodes.pop(name, None),
            {"kind": NODE_REMOVE, "name": name}, {})

    def add_pod(self, name: str, requests: np.ndarray,
                priority: int = 0, quota: str | None = None,
                gang: str | None = None,
                node_selector: dict | None = None,
                labels: dict | None = None,
                owner: str | None = None,
                qos: int = 0,
                arrival_ts: float | None = None) -> int:
        arrays = {"requests": np.asarray(requests, np.int32)}
        doc = {"kind": POD_ADD, "name": name, "priority": priority,
               "quota": quota, "gang": gang,
               "node_selector": node_selector or {},
               "labels": labels or {}, "owner": owner, "qos": qos}
        if arrival_ts is not None:
            # journey-ledger ingest stamp: absent from
            # _V2_DEFAULTS on purpose so it rides v2 frames as a sparse
            # extras column only when present — v3 peers see a plain doc
            # key, and stamp-less producers ship zero extra bytes
            doc["arrival_ts"] = float(arrival_ts)
        def store():
            self.pods[name] = {"doc": doc, "arrays": arrays}

        return self._store_and_commit(store, doc, arrays)

    def remove_pod(self, name: str) -> int:
        return self._store_and_commit(
            lambda: self.pods.pop(name, None),
            {"kind": POD_REMOVE, "name": name}, {})

    def upsert_reservation(self, name: str, requests: np.ndarray,
                           owners: list[dict] | None = None,
                           allocate_once: bool = False,
                           ttl_sec: float | None = None,
                           node: str | None = None,
                           node_selector: dict | None = None,
                           tolerations: dict | None = None,
                           restricted: bool = False) -> int:
        """Reservation CR event.  ``owners`` is a list of matcher dicts:
        {"labels": {...}} and/or {"controller": "..."} per entry."""
        arrays = {"requests": np.asarray(requests, np.int64)}
        doc = {"kind": RSV_UPSERT, "name": name,
               "owners": owners or [], "allocate_once": bool(allocate_once),
               "ttl_sec": ttl_sec, "node": node,
               "node_selector": node_selector or {},
               "tolerations": tolerations or {},
               "restricted": bool(restricted)}
        def store():
            self.reservations[name] = {"doc": doc, "arrays": arrays}

        return self._store_and_commit(store, doc, arrays)

    def remove_reservation(self, name: str) -> int:
        return self._store_and_commit(
            lambda: self.reservations.pop(name, None),
            {"kind": RSV_REMOVE, "name": name}, {})

    # -- wire handlers -------------------------------------------------------

    def attach(self, server) -> None:
        self._server = server
        server.register(FrameType.HELLO, self._handle_hello)
        server.register(FrameType.STATE_PUSH, self._handle_state_push)

    def _handle_state_push(self, doc: dict, arrays):
        """Client-originated state event (wire v3): the direction a
        non-Python scheduler plugin feeds its informer view into the
        sidecar (the reference's Go plugin holds the informers; the
        sidecar only knows what it is told — frameworkext/interface.go:70
        passes cluster state INTO plugins the same way).  The event takes
        the normal commit path, so every sync client — including the
        pusher — sees it back as an rv-ordered DELTA."""
        # the channel layer validates before dispatch, but this handler is
        # also reachable directly (the HTTP gateway, embedders): validate
        # here too so a missing kind/name is always a schema error, never
        # a KeyError
        wire.validate_doc(FrameType.STATE_PUSH, doc)
        # same duality for the trace context: the channel already popped
        # and activated it for framed requests (extract returns None and
        # activate passes the ambient context through); the HTTP gateway
        # and direct embedders land here with it still in the doc
        with tracing.activate(tracing.extract(doc)):
            return self._handle_state_push_traced(doc, arrays)

    def _handle_state_push_traced(self, doc: dict, arrays):
        kind = doc.get("kind")
        name = doc["name"]

        def require_vector(key):
            """Validate a pushed resource vector BEFORE it is committed:
            a malformed array from a foreign client must fail ITS call,
            not enter the replay log where it would poison every sync
            client (including future bootstrappers) with a bad row."""
            from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS

            if key not in arrays:
                raise wire.WireSchemaError(
                    f"{kind} push requires a {key!r} array")
            arr = np.asarray(arrays[key])
            if arr.ndim != 1 or arr.shape[0] != NUM_RESOURCE_DIMS:
                raise wire.WireSchemaError(
                    f"{kind} push: {key!r} must have shape "
                    f"({NUM_RESOURCE_DIMS},), got {arr.shape}")
            if arr.dtype.kind not in "iu":
                raise wire.WireSchemaError(
                    f"{kind} push: {key!r} must be an integer vector, "
                    f"got dtype {arr.dtype}")
            if arr.size and (int(arr.max()) > 2**31 - 1
                             or int(arr.min()) < -(2**31)):
                # wider dtypes are fine as encodings, but values the
                # int32 state tensors cannot hold would wrap silently
                raise wire.WireSchemaError(
                    f"{kind} push: {key!r} has values outside int32 "
                    f"range (canonical units are milli-cores / MiB)")

        def require_doc(key, types, type_name):
            """Same poison-guard for the doc's typed fields: a string
            where a mapping belongs would commit fine and then crash
            every sync client's binding on replay (bool-vs-int per
            wire.check_field_type)."""
            val = doc.get(key)
            if val is not None and not wire.check_field_type(val, types):
                raise wire.WireSchemaError(
                    f"{kind} push: field {key!r} must be {type_name} "
                    f"or absent, got {type(val).__name__}")

        for mapping_field in ("labels", "taints", "annotations",
                              "devices", "node_selector", "tolerations"):
            require_doc(mapping_field, dict, "an object")
        require_doc("owners", list, "a list")
        # element shapes too: a string owner or a non-dict device entry
        # would commit fine and crash every sync client's binding on
        # replay — the same poisoning require_vector guards against
        for owner in doc.get("owners") or []:
            if not isinstance(owner, dict):
                raise wire.WireSchemaError(
                    f"{kind} push: every 'owners' entry must be an "
                    f"object, got {type(owner).__name__}")
            # nested matcher fields feed dict()/string handling on
            # replay (SchedulerBinding.reservation_upsert)
            if not wire.check_field_type(
                    owner.get("labels", {}), dict):
                raise wire.WireSchemaError(
                    f"{kind} push: owner 'labels' must be an object")
            if not wire.check_field_type(
                    owner.get("controller", ""), str):
                raise wire.WireSchemaError(
                    f"{kind} push: owner 'controller' must be a string")
        # device inventory shape is validated inside upsert_node /
        # update_node_devices (the consuming kinds route through them,
        # covering in-process callers too — see _validate_devices)
        for scalar_field in ("quota", "gang", "owner", "node"):
            require_doc(scalar_field, str, "a string")
        for int_field in ("priority", "qos"):
            require_doc(int_field, int, "an integer")
        require_doc("ttl_sec", (int, float), "a number")
        require_doc("usage_time", (int, float), "a number")
        require_doc("arrival_ts", (int, float), "a number")
        for bool_field in ("allocate_once", "restricted"):
            require_doc(bool_field, bool, "a boolean")

        if kind == NODE_UPSERT:
            require_vector("allocatable")
            if "usage" in arrays:
                require_vector("usage")
            rv = self.upsert_node(
                name, arrays["allocatable"], usage=arrays.get("usage"),
                labels=doc.get("labels"), taints=doc.get("taints"),
                annotations=doc.get("annotations"),
                devices=doc.get("devices"))
        elif kind == NODE_USAGE:
            require_vector("usage")
            for optional in ("agg_usage", "prod_usage", "sys_usage",
                             "hp_usage", "hp_request", "hp_max_used_req"):
                if optional in arrays:
                    require_vector(optional)
            rv = self.update_node_usage(
                name, arrays["usage"],
                agg_usage=arrays.get("agg_usage"),
                prod_usage=arrays.get("prod_usage"),
                sys_usage=arrays.get("sys_usage"),
                hp_usage=arrays.get("hp_usage"),
                hp_request=arrays.get("hp_request"),
                hp_max_used_req=arrays.get("hp_max_used_req"),
                report_time=doc.get("usage_time"))
        elif kind == NODE_ALLOC:
            require_vector("allocatable")
            rv = self.update_node_allocatable(name, arrays["allocatable"])
        elif kind == NODE_DEVICES:
            if not isinstance(doc.get("devices"), dict):
                raise wire.WireSchemaError(
                    "node_devices push requires a 'devices' object")
            rv = self.update_node_devices(name, doc["devices"])
        elif kind == NODE_REMOVE:
            rv = self.remove_node(name)
        elif kind == POD_ADD:
            require_vector("requests")
            rv = self.add_pod(
                name, arrays["requests"],
                priority=int(doc.get("priority") or 0),
                quota=doc.get("quota"), gang=doc.get("gang"),
                node_selector=doc.get("node_selector"),
                labels=doc.get("labels"), owner=doc.get("owner"),
                qos=int(doc.get("qos") or 0),
                arrival_ts=doc.get("arrival_ts"))
        elif kind == POD_REMOVE:
            rv = self.remove_pod(name)
        elif kind == RSV_UPSERT:
            require_vector("requests")
            rv = self.upsert_reservation(
                name, arrays["requests"], owners=doc.get("owners"),
                allocate_once=bool(doc.get("allocate_once", False)),
                ttl_sec=doc.get("ttl_sec"), node=doc.get("node"),
                node_selector=doc.get("node_selector"),
                tolerations=doc.get("tolerations"),
                restricted=bool(doc.get("restricted", False)))
        elif kind == RSV_REMOVE:
            rv = self.remove_reservation(name)
        else:
            raise wire.WireSchemaError(f"unknown state-push kind {kind!r}")
        return {"rv": rv}, None

    def _snapshot(self, pack=_pack_events
                  ) -> tuple[dict, dict[str, np.ndarray]]:
        events = []
        # replay order matters: nodes before reservations (placement needs
        # rows) before pods (owners need Available reservations)
        for entry in (list(self.nodes.values())
                      + list(self.reservations.values())
                      + list(self.pods.values())):
            events.append((self.rv, entry["doc"], entry["arrays"]))
        doc, arrays = pack(events)
        doc["rv"] = self.rv
        doc["snapshot"] = True
        return doc, arrays

    def _handle_hello(self, doc: dict, arrays):
        # protocol negotiation: speak min(peer, local) within
        # the supported window so one release of skew keeps working (a
        # v3 peer gets v1 JSON event lists, a v4 peer gets the columnar
        # codec); anything OUTSIDE the window is rejected loud instead
        # of mis-decoding frames later (api.proto's versioned-contract
        # role)
        peer_proto = int(doc.get("proto", 1))
        if not (wire.MIN_PROTOCOL_VERSION <= peer_proto
                <= wire.PROTOCOL_VERSION):
            raise wire.WireSchemaError(
                f"incompatible message protocol: peer {peer_proto}, "
                f"local {wire.PROTOCOL_VERSION} (supported "
                f"{wire.MIN_PROTOCOL_VERSION}..{wire.PROTOCOL_VERSION})")
        proto = min(peer_proto, wire.PROTOCOL_VERSION)
        # stamp the negotiated version on the live connection: broadcast
        # uses it to pick the columnar vs legacy frame per peer
        channel.set_conn_proto(proto)

        def pack(events):
            if proto >= 4:
                packed = _pack_events_v2(events)
                if packed is not None:
                    return packed
            return _pack_events(events)

        last_rv = int(doc.get("last_rv", -1))
        # instance-aware resync: a peer that last synced a DIFFERENT
        # service incarnation must take the full snapshot even when the
        # rv counters collide (restart resets rv; equal counters say
        # nothing about equal state).  Peers that don't send an instance
        # (older clients, the C conformance client) keep the rv-only
        # behavior.
        peer_instance = doc.get("instance")
        same_instance = peer_instance is None or peer_instance == self.instance
        with self._lock:
            if last_rv == self.rv and same_instance:
                return {"__type__": int(FrameType.ACK), "rv": self.rv,
                        "proto": proto, "instance": self.instance}, None
            if 0 <= last_rv < self.rv and same_instance:
                try:
                    events = self.log.since(last_rv)
                except ResyncRequired:
                    events = None
                if events is not None:
                    out, stacked = pack(events)
                    out["__type__"] = int(FrameType.DELTA)
                    out["rv"] = self.rv
                    out["proto"] = proto
                    out["instance"] = self.instance
                    return out, stacked
            # last_rv < 0 (fresh client), a different service incarnation,
            # ahead of us (rv counter reset), or behind the retained
            # window: full snapshot, client resets
            out, stacked = self._snapshot(pack)
            out["proto"] = proto
            out["instance"] = self.instance
            return out, stacked


class StateSyncClient:
    """Solver-side applier. Wire with an RpcClient:

        binding = SchedulerBinding(scheduler)
        sync = StateSyncClient(binding)
        client = RpcClient(path, on_push=sync.on_push)
        client.connect(); sync.bootstrap(client)

    Reconnect: call bootstrap() again — HELLO carries last_rv, overlap
    replays are dropped by the rv guard, and a ResyncRequired from the
    server falls back to a fresh snapshot apply.
    """

    def __init__(self, binding):
        self.binding = binding
        self.rv = -1
        #: message-protocol version negotiated at the last HELLO (0 =
        #: never bootstrapped); informational + test surface
        self.proto = 0
        #: service boot-epoch last synced from (HELLO echoes it); sent on
        #: reconnect so a restarted service with a colliding rv counter
        #: still forces the full snapshot
        self.instance: str | None = None
        self._lock = threading.RLock()
        self._bootstrapping = False
        self._buffer: list[tuple[dict, dict]] = []
        self.applied = 0
        self.skipped = 0
        #: rv-gap accounting: a DELTA push arriving with rv > self.rv + 1
        #: means an event was LOST on the wire (dropped/reordered frame).
        #: The rv guard makes replays idempotent but cannot conjure a
        #: missing event back — the only repair is a re-HELLO.
        self.gaps = 0
        self.needs_resync = False
        #: optional back-reference to the RpcClient this sync rides
        #: (bind_client): a detected gap severs it so the owner's
        #: reconnect machinery (ReconnectingSidecarClient.ensure ->
        #: on_connect=bootstrap) performs the re-HELLO
        self._client = None

    def bind_client(self, client) -> None:
        """Give the sync a handle to its transport so gap detection can
        self-heal by severing the stream (close() is reader-thread safe;
        the owner's next ensure() re-dials and re-bootstraps)."""
        self._client = client

    def bootstrap(self, client) -> int:
        """HELLO + apply. Pushes that race the HELLO response on the wire
        (a DELTA committed after the snapshot was built can be enqueued to
        this connection first) are buffered and replayed after the
        snapshot, where the rv guard keeps exactly the newer ones."""
        with self._lock:
            self._bootstrapping = True
            self._buffer = []
        try:
            # a detected rv gap advanced self.rv PAST the hole (the
            # fresher events were applied), so a delta re-HELLO from
            # last_rv would replay nothing and the lost event would
            # stay lost forever with the rv counters agreeing — the
            # only honest repair is the full snapshot
            last_rv = -1 if self.needs_resync else self.rv
            hello = {"last_rv": last_rv, "proto": wire.PROTOCOL_VERSION}
            if self.instance is not None:
                hello["instance"] = self.instance
            try:
                ftype, doc, arrays = client.call(FrameType.HELLO, hello)
            except channel.RpcRemoteError as e:
                # pre-negotiation server (its window tops out below
                # ours): re-HELLO once at our floor — min(peer, local)
                # on a negotiating server would land there anyway
                if "incompatible" not in str(e):
                    raise
                hello["proto"] = wire.MIN_PROTOCOL_VERSION
                ftype, doc, arrays = client.call(FrameType.HELLO, hello)
            with self._lock:
                self.proto = int(doc.get("proto", hello["proto"]))
                if doc.get("instance"):
                    self.instance = doc["instance"]
                n = 0
                if ftype is not FrameType.ACK:
                    n = self._apply(doc, arrays, from_bootstrap=True)
                # drain and exit buffering atomically — a push landing
                # after this block goes straight to _apply
                for bdoc, barrays in self._buffer:
                    n += self._apply(bdoc, barrays, from_bootstrap=True)
                self._bootstrapping = False
                self._buffer = []
                self.needs_resync = False
                # even a bare ACK is evidence the feed is alive and we
                # are caught up — the staleness watchdog counts it
                mark = getattr(self.binding, "note_sync_event", None)
                if mark is not None:
                    mark()
                return n
        finally:
            with self._lock:  # exception path (call failed): stop buffering
                self._bootstrapping = False
                self._buffer = []

    def on_push(self, frame) -> None:
        from koordinator_tpu_torch.transport.wire import decode_payload

        if frame.type is not FrameType.DELTA:
            return
        doc, arrays = decode_payload(frame.payload)
        with self._lock:
            if self._bootstrapping:
                self._buffer.append((doc, arrays))
                return
        self._apply(doc, arrays)

    def _apply(self, doc: dict, arrays: dict[str, np.ndarray],
               from_bootstrap: bool = False) -> int:
        n = 0
        gap = False
        with self._lock:
            if doc.get("snapshot"):
                self.binding.reset()
                self.rv = -1  # snapshot events all carry the snapshot rv
            high = self.rv
            # rv-guard pass first, dispatch second: the survivors route
            # as ONE ordered batch so contiguous same-kind runs hit the
            # binding's vectorized apply.  Replay (HELLO DELTA) and
            # bootstrap snapshots decode through the same path.
            to_apply: list[tuple[dict, dict]] = []
            for entry in _decode_events(doc, arrays):
                rv = int(entry.get("rv", doc.get("rv", 0)))
                if not doc.get("snapshot") and rv <= self.rv:
                    self.skipped += 1  # replay overlap: idempotent skip
                    continue
                if (not doc.get("snapshot") and not from_bootstrap
                        and self.rv >= 0 and rv > high + 1):
                    # a WATCH push skipped ahead: every committed rv is
                    # broadcast in order, so a hole means an event was
                    # lost on the wire (drop/reorder).  Apply what we
                    # have (fresher than nothing) but flag the stream
                    # for resync — the rv guard would otherwise silently
                    # drop the missing event forever.  Bootstrap applies
                    # are exempt (the HELLO reply + buffered-push replay
                    # is the server's own contiguous answer).
                    gap = True
                to_apply.append((entry, _unpack_event_arrays(entry,
                                                             arrays)))
                high = max(high, rv)
                n += 1
            self._dispatch_run(to_apply)
            self.rv = max(high, int(doc.get("rv", high)))
            self.applied += n
            if gap:
                from koordinator_tpu_torch import metrics

                self.gaps += 1
                self.needs_resync = True
                metrics.sync_gap_resyncs_total.inc()
        if gap and self._client is not None:
            # sever the stream (outside our lock; close is idempotent
            # and safe on the reader thread): the owner's reconnect path
            # re-dials and re-bootstraps; needs_resync makes that HELLO
            # ask for the full snapshot (last_rv=-1), repairing the hole
            self._client.close()
        return n

    def _dispatch(self, entry: dict, arrs: dict[str, np.ndarray]) -> None:
        _dispatch_event(self.binding, entry, arrs)

    def _dispatch_run(self, items: list[tuple[dict, dict]]) -> None:
        _dispatch_events(self.binding, items)


#: event kinds whose contiguous runs have a vectorized binding apply
#: (value = the batched method name; a binding without it falls back to
#: the per-event route)
_RUN_METHODS = {NODE_USAGE: "node_usage_run", POD_ADD: "pod_add_run"}


def _dispatch_events(binding, items: list[tuple[dict, dict]]) -> None:
    """Route an ORDERED event list, batching contiguous same-kind runs
    into one vectorized binding apply.

    Only untraced events coalesce: a trace-stamped event keeps its
    per-event ``sync.<kind>`` span (and its position relative to its
    neighbors — runs never cross it, so apply order is exactly the
    per-event order).  A run of K events costs one scheduler-lock
    round-trip and one ``deltasync_apply`` timeline segment instead of
    K of each; the batched appliers perform the same per-event mutation
    in the same order, so the resulting state is bit-identical."""
    i, n = 0, len(items)
    while i < n:
        entry, arrs = items[i]
        method = _RUN_METHODS.get(entry.get("kind"))
        run_fn = getattr(binding, method, None) if method else None
        if run_fn is None or entry.get(tracing.TRACE_DOC_KEY) is not None:
            _dispatch_event(binding, entry, arrs)
            i += 1
            continue
        j = i + 1
        while (j < n and items[j][0].get("kind") == entry["kind"]
               and items[j][0].get(tracing.TRACE_DOC_KEY) is None):
            j += 1
        if j - i == 1:
            _dispatch_event(binding, entry, arrs)
        else:
            run = items[i:j]
            tl = (timeline.RECORDER.section(
                      "deltasync_apply",
                      f"sync.{entry['kind']}_run[{j - i}]")
                  if timeline.RECORDER.enabled
                  else contextlib.nullcontext())
            with tl:
                run_fn(run)
            # staleness watchdog feed: one mark covers the run — the
            # watchdog reads only the latest timestamp
            mark = getattr(binding, "note_sync_event", None)
            if mark is not None:
                mark()
        i = j


def _dispatch_event(binding, entry: dict,
                    arrs: dict[str, np.ndarray]) -> None:
    """Route one sync event to a binding (shared by the remote client's
    watch stream and the service's in-process subscribers).

    An event stamped with a trace context applies inside a
    ``sync.<kind>`` span joined to that trace (service from the
    binding's ``service_name``), and the binding's handler runs with the
    context active — a pod_add reaching Scheduler.enqueue parents the
    pod's trace to the original submitter's span.  The entry is read,
    never mutated: the same dict may live in the service's stored state
    and replay log."""
    # timeline segment: one deltasync_apply span per routed
    # event — the binding holds scheduler.lock while it applies, so
    # this is exactly the host work that contends with solve rounds
    tl = (timeline.RECORDER.section(
              "deltasync_apply", f"sync.{entry['kind']}")
          if timeline.RECORDER.enabled else contextlib.nullcontext())
    ctx = tracing.TraceContext.from_doc(entry.get(tracing.TRACE_DOC_KEY))
    if ctx is None:
        with tl:
            _route_event(binding, entry, arrs)
        return
    with tracing.TRACER.span(
            f"sync.{entry['kind']}",
            service=getattr(binding, "service_name", None),
            parent=ctx,
            attributes={"name": entry.get("name"),
                        "rv": entry.get("rv")}):
        with tl:
            _route_event(binding, entry, arrs)


def _route_event(binding, entry: dict,
                 arrs: dict[str, np.ndarray]) -> None:
    kind = entry["kind"]
    if kind == NODE_UPSERT:
        binding.node_upsert(entry, arrs)
    elif kind == NODE_USAGE:
        binding.node_usage(entry, arrs)
    elif kind == NODE_ALLOC:
        binding.node_alloc(entry, arrs)
    elif kind == NODE_DEVICES:
        binding.node_devices(entry)
    elif kind == NODE_REMOVE:
        binding.node_remove(entry["name"])
    elif kind == POD_ADD:
        binding.pod_add(entry, arrs)
    elif kind == POD_REMOVE:
        binding.pod_remove(entry["name"])
    elif kind == RSV_UPSERT:
        binding.reservation_upsert(entry, arrs)
    elif kind == RSV_REMOVE:
        binding.reservation_remove(entry["name"])
    # staleness watchdog feed: every applied event — remote watch OR
    # in-process drain — is evidence the state feed is alive
    mark = getattr(binding, "note_sync_event", None)
    if mark is not None:
        mark()


class SchedulerBinding:
    """Applies sync events onto a Scheduler + its ClusterSnapshot.

    Every apply holds ``scheduler.lock`` — the sync client runs on the
    RpcClient reader thread while SolveService runs rounds on server
    connection threads; the lock is the single-scheduling-goroutine
    equivalent."""

    #: service attribution for sync-apply spans (_dispatch_event)
    service_name = "scheduler"

    def __init__(self, scheduler):
        self.scheduler = scheduler

    def note_sync_event(self) -> None:
        """Feed the scheduler's snapshot-staleness watchdog: called by
        the dispatch layer for every applied sync event (delta or
        bootstrap heartbeat)."""
        self.scheduler.note_sync_event()

    def reset(self) -> None:
        """Snapshot resync = restart semantics: release EVERYTHING (bound
        pods free their reservations + quota charges before their nodes
        go) and rebuild from the replayed snapshot."""
        with self.scheduler.lock:
            for name in list(self.scheduler.bound):
                self.scheduler.delete_pod(name)
            for name in list(self.scheduler.pending):
                self.scheduler.dequeue(name)
            for spec in self.scheduler.reservations.specs():
                self.scheduler.remove_reservation(spec.name)
            snap = self.scheduler.snapshot
            for name in list(snap.node_index):
                snap.remove_node(name)
            # fine-grained registries restart too: device tensors / CPU
            # topologies not re-registered by the snapshot replay must
            # not survive as live allocatable state
            if self.scheduler.device_manager is not None:
                self.scheduler.device_manager.clear()
            if self.scheduler.cpu_manager is not None:
                self.scheduler.cpu_manager.clear()

    def node_upsert(self, entry: dict, arrs: dict[str, np.ndarray]) -> None:
        from koordinator_tpu_torch.scheduler.snapshot import NodeSpec

        with self.scheduler.lock:
            self.scheduler.snapshot.upsert_node(NodeSpec(
                name=entry["name"],
                allocatable=np.asarray(arrs["allocatable"], np.int32),
                usage=np.asarray(arrs["usage"], np.int32),
                # merged node_usage refreshes ride the stored entry, so a
                # bootstrap/resync replay must carry them too
                agg_usage=(np.asarray(arrs["agg_usage"], np.int32)
                           if "agg_usage" in arrs else None),
                prod_usage=(np.asarray(arrs["prod_usage"], np.int32)
                            if "prod_usage" in arrs else None),
                labels=dict(entry.get("labels", {})),
                taints=dict(entry.get("taints", {})),
            ))
            # fine-grained registries ride the node event: NRT annotations
            # register the CPU topology, the Device inventory registers
            # per-type device tensors.  BOTH follow the same replay-parity
            # rule: an upsert replaces the stored doc wholesale, so a
            # re-upsert without a (valid) NRT annotation must clear the
            # live topology just as an omitted device type clears its
            # tensors — otherwise this process keeps making placements a
            # bootstrap-replay client cannot see
            annotations = entry.get("annotations") or {}
            if self.scheduler.cpu_manager is not None:
                from koordinator_tpu_torch.scheduler.cpu_manager import (
                    register_node_from_annotations,
                )

                if not register_node_from_annotations(
                        self.scheduler.cpu_manager, entry["name"],
                        annotations):
                    self.scheduler.cpu_manager.remove_node(entry["name"])
            # full inventory: upsert_node REPLACES the stored doc's
            # devices wholesale, so a re-upsert that omits a type must
            # clear its live tensors too — otherwise the in-process
            # scheduler and a bootstrap-replay client diverge
            self._register_devices(entry["name"],
                                   entry.get("devices") or {},
                                   full_inventory=True)

    def _register_devices(self, name: str, devices: dict,
                          full_inventory: bool) -> None:
        """Shared device registration (node_upsert + node_devices).
        ``full_inventory=True`` (both event kinds carry the node's whole
        inventory) also CLEARS types previously registered for this node
        but absent from the push — otherwise a disappeared collector
        leaves stale allocatable tensors live while bootstrap replay has
        none (divergence)."""
        manager = self.scheduler.device_manager
        if manager is None:
            return
        for dev_type, inventory in (devices or {}).items():
            if isinstance(inventory, list):
                manager.register_node_devices(dev_type, name, inventory)
        if full_inventory:
            for gone in manager.registered_types_for(name) - set(devices):
                manager.deregister_node_devices(gone, name)

    def node_devices(self, entry: dict) -> None:
        """Device-inventory refresh: re-register the node's per-type
        device tensors (the Device-CR sync path node_upsert also rides);
        unknown node: drop, same as node_usage."""
        with self.scheduler.lock:
            if entry["name"] not in self.scheduler.snapshot.node_index:
                return
            self._register_devices(entry["name"],
                                   entry.get("devices") or {},
                                   full_inventory=True)

    def node_usage(self, entry: dict, arrs: dict[str, np.ndarray]) -> None:
        """Usage-only refresh (the NodeMetric loop): keep the node's
        allocatable/labels, swap its usage rows.  Unknown node: drop —
        the delta may race a node_remove and usage for a gone node is
        moot."""
        import dataclasses as _dc

        with self.scheduler.lock:
            spec = self.scheduler.snapshot.node_specs.get(entry["name"])
            if spec is None:
                return
            usage = np.asarray(arrs["usage"], np.int32)
            self.scheduler.snapshot.upsert_node(_dc.replace(
                spec,
                usage=usage,
                agg_usage=(np.asarray(arrs["agg_usage"], np.int32)
                           if "agg_usage" in arrs else usage),
                prod_usage=(np.asarray(arrs["prod_usage"], np.int32)
                            if "prod_usage" in arrs else usage),
            ))

    def node_usage_run(self,
                       items: list[tuple[dict, dict[str, np.ndarray]]]
                       ) -> None:
        """Vectorized NODE_USAGE run: ONE scheduler-lock
        round-trip for K usage refreshes.  Per-event semantics are
        unchanged — same replace, same order, so a later event for the
        same node wins exactly as it would serially — and the snapshot's
        dirty-row set coalesces the K row writes into the next flush's
        single device scatter."""
        import dataclasses as _dc

        with self.scheduler.lock:
            snap = self.scheduler.snapshot
            for entry, arrs in items:
                spec = snap.node_specs.get(entry["name"])
                if spec is None:
                    continue
                usage = np.asarray(arrs["usage"], np.int32)
                snap.upsert_node(_dc.replace(
                    spec,
                    usage=usage,
                    agg_usage=(np.asarray(arrs["agg_usage"], np.int32)
                               if "agg_usage" in arrs else usage),
                    prod_usage=(np.asarray(arrs["prod_usage"], np.int32)
                                if "prod_usage" in arrs else usage),
                ))

    def node_alloc(self, entry: dict, arrs: dict[str, np.ndarray]) -> None:
        """Allocatable-only refresh (the manager's noderesource patch):
        keep the node's usage/labels/devices, swap its allocatable row.
        Unknown node: drop, same as node_usage."""
        import dataclasses as _dc

        with self.scheduler.lock:
            spec = self.scheduler.snapshot.node_specs.get(entry["name"])
            if spec is None:
                return
            self.scheduler.snapshot.upsert_node(_dc.replace(
                spec, allocatable=np.asarray(arrs["allocatable"],
                                             np.int32)))

    def node_remove(self, name: str) -> None:
        with self.scheduler.lock:
            self.scheduler.snapshot.remove_node(name)
            # replay parity: a removed node's fine-grained state goes
            # with it — a bootstrap-replay client has neither its device
            # tensors nor its CPU topology
            if self.scheduler.device_manager is not None:
                self.scheduler.device_manager.remove_node(name)
            if self.scheduler.cpu_manager is not None:
                self.scheduler.cpu_manager.remove_node(name)

    def pod_add(self, entry: dict, arrs: dict[str, np.ndarray]) -> None:
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec

        self.scheduler.enqueue(PodSpec(
            name=entry["name"],
            requests=np.asarray(arrs["requests"], np.int32),
            priority=int(entry.get("priority", 0)),
            quota=entry.get("quota"),
            gang=entry.get("gang"),
            node_selector=dict(entry.get("node_selector", {})),
            labels=dict(entry.get("labels", {})),
            owner=entry.get("owner"),
            qos=int(entry.get("qos", 0)),
            arrival_ts=float(entry.get("arrival_ts") or 0.0),
        ))

    def pod_add_run(self,
                    items: list[tuple[dict, dict[str, np.ndarray]]]
                    ) -> None:
        """Vectorized POD_ADD run: build the specs outside
        the scheduler lock, enqueue them under ONE acquisition."""
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec

        self.scheduler.enqueue_many([
            PodSpec(
                name=entry["name"],
                requests=np.asarray(arrs["requests"], np.int32),
                priority=int(entry.get("priority", 0)),
                quota=entry.get("quota"),
                gang=entry.get("gang"),
                node_selector=dict(entry.get("node_selector", {})),
                labels=dict(entry.get("labels", {})),
                owner=entry.get("owner"),
                qos=int(entry.get("qos", 0)),
                arrival_ts=float(entry.get("arrival_ts") or 0.0),
            )
            for entry, arrs in items
        ])

    def pod_remove(self, name: str) -> None:
        # pending, nominated, or bound — a bound delete releases its node
        # reservation and quota charge
        self.scheduler.delete_pod(name)

    def reservation_upsert(self, entry: dict,
                           arrs: dict[str, np.ndarray]) -> None:
        from koordinator_tpu_torch.scheduler.reservations import (
            OwnerMatcher,
            ReservationSpec,
        )

        owners = [
            OwnerMatcher(labels=dict(m.get("labels", {})),
                         controller=m.get("controller"))
            for m in entry.get("owners", [])
        ]
        self.scheduler.add_reservation(ReservationSpec(
            name=entry["name"],
            requests=np.asarray(arrs["requests"], np.int64),
            owners=owners,
            allocate_once=bool(entry.get("allocate_once", False)),
            ttl_sec=entry.get("ttl_sec"),
            node=entry.get("node"),
            node_selector=dict(entry.get("node_selector", {})),
            tolerations=dict(entry.get("tolerations", {})),
            restricted=bool(entry.get("restricted", False)),
        ))

    def reservation_remove(self, name: str) -> None:
        self.scheduler.remove_reservation(name)
