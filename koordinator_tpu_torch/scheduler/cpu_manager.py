"""Host-side CPU allocation manager: per-node topology registry + commits
(port of ``koordinator_tpu/scheduler/cpu_manager.py``).

The Reserve-phase counterpart of the reference's nodenumaresource
resource_manager (pkg/scheduler/plugins/nodenumaresource/resource_manager.go:
allocateCPUSet, Update/Release): tracks per-node per-cpu reference counts
and exclusivity on the host, runs the :mod:`ops.numa` take on the
topology's device, and produces the cpuset annotation payload
(apis/extension/numa_aware.go resource-status) that the node agent's
cpuset hook applies.  Each node keeps a host copy of its topology, so the
exclusivity mask and the payload need no copy from the device.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.numa import (
    BIND_DEFAULT,
    EXCLUSIVE_NONE,
    EXCLUSIVE_NUMA_LEVEL,
    EXCLUSIVE_PCPU_LEVEL,
    STRATEGY_MOST_ALLOCATED,
    CPUTopology,
    take_cpus,
)


@dataclasses.dataclass
class CPUAllocation:
    pod: str
    cpus: list[int]
    exclusive_policy: int = EXCLUSIVE_NONE


@dataclasses.dataclass
class NodeCPUState:
    topology: CPUTopology
    ref_count: np.ndarray                    # (C,) int32
    max_ref: int = 1
    allocations: dict[str, CPUAllocation] = dataclasses.field(
        default_factory=dict)
    #: the topology's arrays on the host: core_of, numa_of, socket_of, valid
    host: tuple = dataclasses.field(default=(), repr=False, compare=False)


def _host_topology(topology: CPUTopology) -> tuple:
    return tuple(t.cpu().numpy() for t in (
        topology.core_of, topology.numa_of, topology.socket_of,
        topology.valid))


class CPUManager:
    """Registry of node CPU topologies + allocation bookkeeping.
    ``device`` is where :func:`register_node_from_annotations` builds
    topologies (a registered topology keeps its own device)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._nodes: dict[str, NodeCPUState] = {}
        #: allocations preserved across a topology disappearance (e.g. a
        #: transient annotation-less node re-upsert removed the node):
        #: restored when the topology re-registers, so exclusive cores
        #: held by still-bound pods cannot be granted twice after the
        #: NRT annotation returns
        self._orphans: dict[str, dict[str, CPUAllocation]] = {}

    def register_node(self, name: str, topology: CPUTopology,
                      max_ref: int = 1) -> None:
        """(Re-)register a node's topology.  Node objects re-sync on every
        heartbeat, so a re-registration must carry live allocations over:
        wiping ref counts would let exclusive cores be granted twice."""
        old = self._nodes.get(name)
        host = _host_topology(topology)
        if (old is not None and old.max_ref == max_ref
                and old.topology.capacity == topology.capacity
                and all(np.array_equal(a, b)
                        for a, b in zip(old.host, host))):
            return   # unchanged heartbeat: keep state as-is
        st = NodeCPUState(topology=topology,
                          ref_count=np.zeros(topology.capacity, np.int32),
                          max_ref=max_ref, host=host)
        valid = host[3]
        carried = dict(old.allocations) if old is not None else {}
        # a topology that vanished and returned (remove_node stashed the
        # allocations) restores them too: live records win over orphans
        for pod, alloc in self._orphans.pop(name, {}).items():
            carried.setdefault(pod, alloc)
        for pod, alloc in carried.items():
            cpus = [c for c in alloc.cpus if c < len(valid) and valid[c]]
            if cpus:
                st.ref_count[cpus] += 1
                st.allocations[pod] = CPUAllocation(
                    pod, cpus, alloc.exclusive_policy)
        self._nodes[name] = st

    def node(self, name: str) -> NodeCPUState | None:
        return self._nodes.get(name)

    def clear(self) -> None:
        """Drop all topologies and CPU allocations: snapshot-resync
        restart semantics; the replayed snapshot's NRT annotations
        re-register what still exists and the bound-pod replay restores
        allocations."""
        self._nodes.clear()
        self._orphans.clear()

    def remove_node(self, name: str) -> None:
        """Drop one node's topology (its NRT annotation, or the node,
        disappeared).  Allocations are STASHED, not dropped: if the
        disappearance was transient, the re-registration restores them."""
        st = self._nodes.pop(name, None)
        if st is not None and st.allocations:
            stash = self._orphans.setdefault(name, {})
            for pod, alloc in st.allocations.items():
                stash[pod] = alloc

    def _banned_mask(self, st: NodeCPUState, pod_policy: int) -> np.ndarray:
        """CPUs excluded by other pods' exclusivity or by this pod's own
        exclusivity requirement (isCPUExclusivePCPULevel/NUMANodeLevel)."""
        core_of, numa_of = st.host[0], st.host[1]
        banned = np.zeros(st.topology.capacity, bool)
        for alloc in st.allocations.values():
            if not alloc.cpus:
                continue
            # Other pods' exclusivity claims...
            if alloc.exclusive_policy == EXCLUSIVE_PCPU_LEVEL:
                banned |= np.isin(core_of, core_of[alloc.cpus])
            elif alloc.exclusive_policy == EXCLUSIVE_NUMA_LEVEL:
                banned |= np.isin(numa_of, numa_of[alloc.cpus])
            # ...AND this pod's own requirement apply independently.
            if pod_policy == EXCLUSIVE_PCPU_LEVEL:
                # whole cores: cores already referenced by anyone are off
                # limits
                banned |= np.isin(core_of, core_of[alloc.cpus])
            elif pod_policy == EXCLUSIVE_NUMA_LEVEL:
                # whole NUMA nodes to itself
                banned |= np.isin(numa_of, numa_of[alloc.cpus])
        return banned

    def allocate(self, node: str, pod: str, n_cpus: int,
                 bind_policy: int = BIND_DEFAULT,
                 strategy: int = STRATEGY_MOST_ALLOCATED,
                 exclusive_policy: int = EXCLUSIVE_NONE) -> list[int] | None:
        """Pick and commit a cpuset; returns sorted cpu ids or None."""
        st = self._nodes.get(node)
        if st is None:
            return None
        # Re-allocate: free the old cpuset for the attempt, but restore it
        # if the new selection fails (the pod keeps running on its old cpus)
        old = st.allocations.get(pod)
        if old is not None:
            self.release(node, pod)
        banned = self._banned_mask(st, exclusive_policy)
        dev = st.topology.valid.device
        selected, ok = take_cpus(
            st.topology, torch.from_numpy(st.ref_count).to(dev), st.max_ref,
            n_cpus, bind_policy=bind_policy, strategy=strategy,
            banned=torch.from_numpy(banned).to(dev))
        if not bool(ok):
            if old is not None:
                st.ref_count[old.cpus] += 1
                st.allocations[pod] = old
            return None
        cpus = [int(i) for i in np.flatnonzero(selected.cpu().numpy())]
        st.ref_count[cpus] += 1
        st.allocations[pod] = CPUAllocation(pod, cpus, exclusive_policy)
        return cpus

    def restore(self, node: str, pod: str, cpus: list[int],
                exclusive_policy: int = EXCLUSIVE_NONE) -> bool:
        """Replay a pod's existing cpuset at startup (the reference restores
        allocations from pod resource-status annotations): commits the
        exact cpus without running selection.  Annotation data is external:
        cpu ids outside the registered topology reject the whole restore
        (the pod falls back to unpinned) rather than corrupting ref
        counts."""
        st = self._nodes.get(node)
        if st is None or not cpus:
            return False
        cpus = sorted({int(c) for c in cpus})
        valid = st.host[3]
        # bounds AND the valid mask: topology capacities are padded to a
        # power of two with zeroed core/numa ids; a stale id landing in the
        # padding would ban core 0 for every future exclusive pod
        if cpus[0] < 0 or cpus[-1] >= len(valid) or not valid[cpus].all():
            return False
        self.release(node, pod)   # idempotent replay
        st.ref_count[cpus] += 1
        st.allocations[pod] = CPUAllocation(pod, cpus, exclusive_policy)
        return True

    def release(self, node: str, pod: str) -> None:
        # purge any orphaned record too: a pod deleted while the node's
        # topology was absent must not resurrect on re-registration
        orphans = self._orphans.get(node)
        if orphans is not None:
            orphans.pop(pod, None)
            if not orphans:
                del self._orphans[node]
        st = self._nodes.get(node)
        if st is None:
            return
        alloc = st.allocations.pop(pod, None)
        if alloc is not None:
            st.ref_count[alloc.cpus] -= 1

    def resource_status(self, node: str, pod: str) -> dict | None:
        """The scheduling.koordinator.sh/resource-status annotation
        payload."""
        st = self._nodes.get(node)
        if st is None or pod not in st.allocations:
            return None
        alloc = st.allocations[pod]
        numa_of = st.host[1]
        return {
            "cpuset": ",".join(str(c) for c in alloc.cpus),
            "numaNodeResources": sorted({int(numa_of[c]) for c in alloc.cpus}),
        }


def _parse_cpu_list(spec: str, limit: int | None = None) -> list[int]:
    """'0-3,8,10-11' -> [0,1,2,3,8,10,11] (util/cpuset parity; a copy of
    ``koordinator_tpu/koordlet/system/procfs.py`` ``parse_cpu_list``).
    ``limit`` bounds the materialized size for EXTERNAL data: a corrupt
    '0-4000000000' raises ValueError before expanding."""
    cpus: list[int] = []
    for part in spec.strip().split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, hi_s = part.split("-", 1)
            lo, hi = int(lo_s), int(hi_s)
            if limit is not None and (hi < lo or hi - lo + 1 > limit):
                raise ValueError(f"cpu range too wide: {part}")
            cpus.extend(range(lo, hi + 1))
        else:
            cpus.append(int(part))
        if limit is not None and len(cpus) > limit:
            raise ValueError("cpu list too large")
    return sorted(set(cpus))


def parse_cpuset_bounded(s: str, limit: int = 1024) -> list[int]:
    """Parse a "0-3,8" cpuset string with a hard size bound (annotation
    data is external)."""
    return _parse_cpu_list(str(s), limit=limit)


def register_node_from_annotations(mgr: CPUManager, name: str,
                                   annotations: dict[str, str]) -> bool:
    """NRT bridge: parse the koordlet's cpu-topology annotation (the
    reference's nodenumaresource/topology_options.go reads the same
    payload) and register the node's topology with the CPU manager, on
    the manager's device."""
    raw = annotations.get("node.koordinator.sh/cpu-topology", "")
    if not raw:
        return False
    try:
        detail = json.loads(raw)["detail"]
        if not detail:
            return False
        core_of = np.asarray([d["core"] for d in detail], np.int32)
        numa_of = np.asarray([d["node"] for d in detail], np.int32)
        socket_of = np.asarray([d["socket"] for d in detail], np.int32)
    except (ValueError, KeyError, TypeError):
        # annotation payloads are external data: malformed entries reject
        # the registration instead of crashing node processing
        return False
    mgr.register_node(name, CPUTopology.build(core_of, numa_of, socket_of,
                                              device=mgr.device))
    return True
