"""Host-side device allocation bookkeeping, deviceshare Reserve/Unreserve
(port of ``koordinator_tpu/scheduler/device_manager.py``).

Counterpart of the reference's nodeDevice cache updates
(pkg/scheduler/plugins/deviceshare/device_cache.go) and the
``scheduling.koordinator.sh/device-allocated`` annotation emitted at PreBind
(apis/extension/device_share.go:32): tracks which device minors each pod
holds, mirrors commits into the device tensors (on the manager's device:
the :mod:`ops.deviceshare` allocation and commits are torch ops there), and
renders the annotation payload for the node agent's GPU env-inject hook.
Each type keeps a host copy of its ``valid`` mask, so which minors are live
needs no copy from the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.deviceshare import (
    DEV_BINPACK,
    DeviceState,
    allocate_on_node,
    commit_allocation,
    release_allocation,
    split_request,
)


@dataclasses.dataclass
class DeviceAllocation:
    pod: str
    node: str
    device_type: str
    minors: list[int]
    core: int         # per-device core charged
    memory: int       # per-device memory charged


class DeviceManager:
    """Per-type device tensors + pod allocation records."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._state: dict[str, DeviceState] = {}
        self._valid: dict[str, np.ndarray] = {}   # host copy of state.valid
        self._node_rows: dict[str, dict[str, int]] = {}  # per device type
        self._allocs: dict[tuple[str, str], list[DeviceAllocation]] = {}
        #: raw per-node inventory, kept so nodes can register incrementally
        #: (Device CR sync delivers one node at a time)
        self._raw: dict[str, dict[str, list[dict]]] = {}

    def _set_state(self, device_type: str, per_node_devices) -> None:
        st = DeviceState.build(per_node_devices, device=self.device)
        self._state[device_type] = st
        self._valid[device_type] = st.valid.cpu().numpy()

    def register(self, device_type: str, node_names: list[str],
                 per_node_devices: list[list[dict]]) -> None:
        self._set_state(device_type, per_node_devices)
        self._node_rows[device_type] = {n: i for i, n in enumerate(node_names)}
        self._raw[device_type] = {
            n: list(d) for n, d in zip(node_names, per_node_devices)}

    def register_node_devices(self, device_type: str, node: str,
                              devices: list[dict]) -> None:
        """Incremental Device-CR sync: (re)register one node's inventory,
        rebuilding the type tensors and re-committing live allocations so
        an inventory update can't silently zero out held capacity."""
        raw = self._raw.setdefault(device_type, {})
        if raw.get(node) == list(devices):
            return   # unchanged heartbeat: skip the O(cluster) rebuild
        raw[node] = list(devices)
        self._rebuild_type(device_type)

    def deregister_node_devices(self, device_type: str, node: str) -> None:
        """Remove one node's row for a type entirely (the type vanished
        from the node's full inventory): popping rather than storing an
        empty list keeps live state identical to what bootstrap replay
        builds."""
        raw = self._raw.get(device_type)
        if raw is None or node not in raw:
            return
        raw.pop(node)
        self._rebuild_type(device_type)

    def _live_minors(self, a: DeviceAllocation, row: int) -> list[int]:
        """The subset of a record's minors present in the CURRENT
        inventory.  Records are never pruned destructively: a transient
        inventory clear must re-commit the grant when the inventory
        returns; a minor that is really gone simply never re-commits and
        is filtered from annotations/release."""
        valid = self._valid[a.device_type]
        return [m for m in a.minors if m < valid.shape[1] and valid[row, m]]

    def _selection(self, device_type: str, minors: list[int]) -> torch.Tensor:
        sel = np.zeros(self._valid[device_type].shape[1], bool)
        sel[minors] = True
        return torch.from_numpy(sel).to(self.device)

    def _rebuild_type(self, device_type: str) -> None:
        """Rebuild one type's tensors from raw inventory and re-commit the
        live part of every allocation record (shared by inventory updates
        and node removal)."""
        raw = self._raw.get(device_type)
        if not raw:
            # last node of the type gone: drop the type entirely rather
            # than keeping empty rows around
            self._raw.pop(device_type, None)
            self._state.pop(device_type, None)
            self._valid.pop(device_type, None)
            self._node_rows.pop(device_type, None)
            return
        names = sorted(raw)
        self._set_state(device_type, [raw[n] for n in names])
        self._node_rows[device_type] = {n: i for i, n in enumerate(names)}
        for (_pod, pnode), allocs in self._allocs.items():
            row = self._node_rows[device_type].get(pnode)
            if row is None:
                continue
            for a in allocs:
                if a.device_type != device_type:
                    continue
                live = self._live_minors(a, row)
                if not live:
                    continue
                self._state[device_type] = commit_allocation(
                    self._state[device_type], row,
                    self._selection(device_type, live), a.core, a.memory)

    def remove_node(self, name: str) -> None:
        """Drop one node's inventory rows across all types (NODE_REMOVE).
        Allocation RECORDS stay: a node flap must re-commit held devices on
        the rebuild, or a second pod gets granted devices the first still
        uses.  Records are purged when the pod itself is released."""
        for dev_type in list(self._raw):
            self.deregister_node_devices(dev_type, name)

    def registered_types_for(self, node: str) -> set[str]:
        """Device types this node has inventory registered under."""
        return {dev_type for dev_type, raw in self._raw.items()
                if node in raw}

    def clear(self) -> None:
        """Drop ALL inventory and allocation state: snapshot-resync restart
        semantics."""
        self._state.clear()
        self._valid.clear()
        self._node_rows.clear()
        self._allocs.clear()
        self._raw.clear()

    def state(self, device_type: str) -> DeviceState | None:
        return self._state.get(device_type)

    def allocate(self, device_type: str, node: str, pod: str, core: int,
                 memory: int = 0, strategy: int = DEV_BINPACK
                 ) -> list[int] | None:
        """Pick + commit devices for a pod; returns device minors or None."""
        dev = self._state.get(device_type)
        row = self._node_rows.get(device_type, {}).get(node)
        if dev is None or row is None:
            return None
        # Re-allocate for the same pod/type replaces the old grant (a
        # retried bind cycle must not double-charge); restore it if the
        # retry fails.
        old_records = self._allocs.get((pod, node), [])
        old_same_type = [a for a in old_records
                         if a.device_type == device_type]
        if old_same_type:
            old_state = dev
            for a in old_same_type:
                self._release_one(node, a)
                old_records.remove(a)
            dev = self._state[device_type]
        n_whole, per_core, per_mem = split_request(core, memory)
        sel, ok = allocate_on_node(dev, row, n_whole, per_core, per_mem,
                                   strategy=strategy)
        if not bool(ok):
            if old_same_type:
                self._state[device_type] = old_state
                self._allocs.setdefault((pod, node), []).extend(old_same_type)
            return None
        self._state[device_type] = commit_allocation(dev, row, sel, per_core,
                                                     per_mem)
        minors = [int(i) for i in np.flatnonzero(sel.cpu().numpy())]
        self._allocs.setdefault((pod, node), []).append(
            DeviceAllocation(pod, node, device_type, minors, per_core,
                             per_mem))
        return minors

    def _release_one(self, node: str, alloc: DeviceAllocation) -> None:
        dev = self._state.get(alloc.device_type)
        row = self._node_rows.get(alloc.device_type, {}).get(node)
        if dev is None or row is None:
            return
        # only the live minors were committed at the last rebuild, so only
        # they release
        live = self._live_minors(alloc, row)
        if not live:
            return
        self._state[alloc.device_type] = release_allocation(
            dev, row, self._selection(alloc.device_type, live), alloc.core,
            alloc.memory)

    def restore(self, node: str, pod: str, devices: dict) -> bool:
        """Replay a pod's existing device grants at startup from the
        device-allocated annotation payload
        ({type: [{"minor": m, "resources": {"core": c, "memory": b}}]}).
        Idempotent (a re-list that replays the same pod twice releases the
        previous records first) and defensive: unknown types and
        out-of-range minors are skipped.  Returns True when anything
        landed."""
        self.release(node, pod)
        restored = False
        if not isinstance(devices, dict):
            return False
        for device_type, grants in devices.items():
            dev = self._state.get(device_type)
            row = self._node_rows.get(device_type, {}).get(node)
            if dev is None or row is None or not isinstance(grants, list):
                continue
            valid = self._valid[device_type]
            for g in grants:
                try:
                    minor = int(g.get("minor", -1))
                    res = g.get("resources", {}) or {}
                    core = int(res.get("core", 0))
                    memory = int(res.get("memory", 0))
                except (TypeError, ValueError, AttributeError):
                    continue
                # bounds AND the row's valid mask: device capacities pad to
                # a power of two; a stale minor in the padding would drive
                # a nonexistent device's free counter negative
                if not (0 <= minor < valid.shape[1] and valid[row, minor]):
                    continue
                self._state[device_type] = commit_allocation(
                    self._state[device_type], row,
                    self._selection(device_type, [minor]), core, memory)
                self._allocs.setdefault((pod, node), []).append(
                    DeviceAllocation(pod, node, device_type, [minor], core,
                                     memory))
                restored = True
        return restored

    def release(self, node: str, pod: str) -> None:
        for alloc in self._allocs.pop((pod, node), []):
            self._release_one(node, alloc)

    def device_allocated_annotation(self, node: str, pod: str) -> dict | None:
        """The device-allocated annotation payload (device_share.go:32).
        Reports only minors present in the CURRENT inventory."""
        allocs = self._allocs.get((pod, node))
        if not allocs:
            return None
        out: dict = {}
        for a in allocs:
            row = self._node_rows.get(a.device_type, {}).get(node)
            minors = (self._live_minors(a, row)
                      if a.device_type in self._state and row is not None
                      else [])
            if minors:
                out.setdefault(a.device_type, []).extend(
                    {"minor": m,
                     "resources": {"core": a.core, "memory": a.memory}}
                    for m in minors)
        return out or None
