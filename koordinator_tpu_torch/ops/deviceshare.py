"""Device-share scheduling: GPU/RDMA fit, scoring, allocation (port of
``koordinator_tpu/ops/deviceshare.py``).

The reference's deviceshare plugin (pkg/scheduler/plugins/deviceshare/:
device_cache.go nodeDevice state, device_allocator.go AutopilotAllocator
+ tryJointAllocate, allocator_gpu.go, gpu_shared_resource_templates_cache.go
partition templates, scoring.go).

Resource model (apis/extension/device_share.go): a device exposes ``core``
in percent-of-device units (100 = one whole device, koordinator.sh/gpu-core)
and ``memory`` in MiB.  A request is either

- **shared**: core < 100, lands on ONE device with enough free core+memory, or
- **whole**: core = n*100, takes n fully-free devices (multi-device requests
  cannot split a device, matching ValidateDeviceRequest).

Cluster-wide device state is a (nodes x max-devices x 2) tensor per device
type; Filter/Score are batched over all nodes, allocation picks device ids on
the chosen node.  Joint GPU+NIC allocation prefers devices of both types in
one topology group (device_allocator.go:208 tryJointAllocate).

Every function is torch ops on the state's device.  Commits return a new
:class:`DeviceState` whose ``free`` is a new tensor (the JAX functions are
pure, and the device manager keeps the old state to restore a failed
re-allocation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.select import (
    gather,
    int32_like,
    segment_sum,
    take_by_rank,
)
from koordinator_tpu_torch.state.cluster_state import _bucket

#: Per-device resource dims: core (percent, 100 per device) and memory (MiB).
DEV_CORE = 0
DEV_MEM = 1
NUM_DEV_DIMS = 2

#: Scheduler-facing allocate strategies (DeviceShareArgs scoring strategy).
DEV_BINPACK = 0   # most-allocated: fill busy devices/nodes first
DEV_SPREAD = 1    # least-allocated

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class DeviceState:
    """One device type (GPU, RDMA, ...) across the cluster, padded (N, D)."""

    total: torch.Tensor    # (N, D, 2) int32 per-device capacity
    free: torch.Tensor     # (N, D, 2) int32 unallocated
    valid: torch.Tensor    # (N, D) bool: device exists
    healthy: torch.Tensor  # (N, D) bool: Device CRD health
    group: torch.Tensor    # (N, D) int32 topology group (PCIe/NUMA)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.valid.shape)

    def replace(self, **changes) -> "DeviceState":
        return dataclasses.replace(self, **changes)

    @classmethod
    def zeros(cls, nodes: int, devices: int = 16, device=None
              ) -> "DeviceState":
        dev = resolve_device(device)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(total=z(nodes, devices, NUM_DEV_DIMS),
                   free=z(nodes, devices, NUM_DEV_DIMS),
                   valid=z(nodes, devices, dtype=torch.bool),
                   healthy=z(nodes, devices, dtype=torch.bool),
                   group=z(nodes, devices))

    @classmethod
    def build(cls, per_node_devices: list[list[dict]],
              node_capacity: int | None = None,
              device_capacity: int | None = None,
              device=None) -> "DeviceState":
        """From host records: one dict per device with keys
        core/memory/group/healthy (Device CRD device_types.go:112 entries)."""
        dev = resolve_device(device)
        n = len(per_node_devices)
        ncap = node_capacity or _bucket(max(n, 1))
        dmax = max((len(d) for d in per_node_devices), default=1)
        dcap = device_capacity or _bucket(max(dmax, 1), minimum=8)
        total = np.zeros((ncap, dcap, NUM_DEV_DIMS), np.int32)
        valid = np.zeros((ncap, dcap), bool)
        healthy = np.zeros((ncap, dcap), bool)
        group = np.zeros((ncap, dcap), np.int32)
        for i, devs in enumerate(per_node_devices):
            for j, d in enumerate(devs):
                total[i, j, DEV_CORE] = d.get("core", 100)
                total[i, j, DEV_MEM] = d.get("memory", 0)
                valid[i, j] = True
                healthy[i, j] = d.get("healthy", True)
                group[i, j] = d.get("group", 0)

        def t(a):
            return torch.from_numpy(a).to(dev)

        return cls(total=t(total), free=t(total.copy()), valid=t(valid),
                   healthy=t(healthy), group=t(group))


def split_request(core: int, memory: int) -> tuple[int, int, int]:
    """(n_whole, per_device_core, per_device_memory): ValidateDeviceRequest.

    core=350 is invalid in the reference (multi-device must be whole); it
    rounds up to 4 whole devices to stay total-capacity-safe.
    """
    if core <= 100:
        return (0, core, memory)
    n = -(-core // 100)
    return (n, 100, -(-memory // n) if memory else 0)


def _usable(dev: DeviceState) -> torch.Tensor:
    return dev.valid & dev.healthy


def _whole_free(dev: DeviceState) -> torch.Tensor:
    """(N, D) bool: device is fully unallocated."""
    return _usable(dev) & torch.all(dev.free == dev.total, dim=-1)


def device_fit(dev: DeviceState, n_whole, core, memory) -> torch.Tensor:
    """(N,) bool: the batched Filter over all nodes."""
    fits_each = (_usable(dev) & (dev.free[..., DEV_CORE] >= core)
                 & (dev.free[..., DEV_MEM] >= memory))
    shared_ok = torch.any(fits_each, dim=-1)
    # whole devices must also cover the per-device ask (a fully-free device
    # with less memory than asked is not a fit)
    whole_capable = (_whole_free(dev) & (dev.total[..., DEV_CORE] >= core)
                     & (dev.total[..., DEV_MEM] >= memory))
    n_whole = int32_like(n_whole, dev.free)
    whole_ok = torch.sum(whole_capable, dim=-1, dtype=torch.int32) >= n_whole
    return torch.where(n_whole > 0, whole_ok, shared_ok)


def device_score(dev: DeviceState, n_whole, core, memory,
                 strategy: int = DEV_BINPACK) -> torch.Tensor:
    """(N,) int32 in [0, 100]: scoring.go's most/least-allocated over the
    node's device pool (utilization after placing the request)."""
    v = dev.valid[..., None]
    total = torch.clamp(torch.sum(torch.where(v, dev.total, 0), dim=1,
                                  dtype=torch.int32), min=1)    # (N, 2)
    used = total - torch.sum(torch.where(v, dev.free, 0), dim=1,
                             dtype=torch.int32)
    n_whole = int32_like(n_whole, dev.free)
    core, memory = int32_like(core, dev.free), int32_like(memory, dev.free)
    ask_core = torch.where(n_whole > 0, n_whole * 100, core)
    ask = torch.stack([ask_core,
                       torch.where(n_whole > 0, n_whole * memory, memory)])
    util = torch.clamp((used + ask[None, :]) * 100 // total, 0, 100)
    score = torch.sum(util, dim=-1, dtype=torch.int32) // NUM_DEV_DIMS
    return score if strategy == DEV_BINPACK else (100 - score)


def allocate_on_node(dev: DeviceState, node, n_whole, core, memory,
                     strategy: int = DEV_BINPACK, prefer_group=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick device ids on one node: returns ((D,) bool selection, ok).

    Shared: best-fit, the fitting device with the least free core (binpack)
    or most free (spread).  Whole: n fully-free devices, preferring the
    requested topology group, then group-crowding order (keeps big groups
    intact, the allocator's honor-device-topology behavior).
    """
    d = dev.valid.shape[1]
    free = dev.free[node]            # (D, 2)
    total = dev.total[node]
    usable = dev.valid[node] & dev.healthy[node]
    groups = dev.group[node]
    n_whole = int32_like(n_whole, free)
    ar = torch.arange(d, dtype=torch.int32, device=free.device)

    if prefer_group is not None:
        pg = int32_like(prefer_group, free)
        in_group = (groups == pg) & (pg >= 0)
    else:
        in_group = torch.zeros(d, dtype=torch.bool, device=free.device)

    # shared single-device path: best-fit within the preferred topology
    # group first, then any group (same-group-then-fallback,
    # tryJointAllocate)
    fits = usable & (free[:, DEV_CORE] >= core) & (free[:, DEV_MEM] >= memory)
    fit_key = (free[:, DEV_CORE] if strategy == DEV_BINPACK
               else -free[:, DEV_CORE])
    shared_sel, shared_ok = take_by_rank((ar, fit_key, ~in_group, ~fits),
                                         fits, 1)

    # whole-devices path (per-device capacity must cover the ask)
    wfree = (usable & torch.all(free == total, dim=-1)
             & (total[:, DEV_CORE] >= core) & (total[:, DEV_MEM] >= memory))
    # group crowding: how many whole-free devices share my group (take
    # from the group that can satisfy the request with least leftover)
    g = torch.clamp(groups, min=0)
    grp_count = gather(segment_sum(wfree, g, d), g)
    can_satisfy = grp_count >= n_whole
    whole_sel, whole_ok = take_by_rank(
        (ar, torch.where(can_satisfy, grp_count, INT32_MAX), ~in_group,
         ~wfree),
        wfree, n_whole)

    sel = torch.where(n_whole > 0, whole_sel, shared_sel)
    ok = torch.where(n_whole > 0, whole_ok, shared_ok)
    return sel & ok, ok


def _add_on_node(dev: DeviceState, node, selection, core, memory,
                 sign: int) -> DeviceState:
    ask = torch.stack([int32_like(core, dev.free),
                       int32_like(memory, dev.free)])
    delta = selection.to(torch.int32)[:, None] * ask[None, :]
    free = dev.free.clone()
    free[node] += sign * delta
    return dev.replace(free=free)


def commit_allocation(dev: DeviceState, node, selection: torch.Tensor,
                      core, memory) -> DeviceState:
    """Subtract the per-device ask from the selected devices' free."""
    return _add_on_node(dev, node, selection, core, memory, -1)


def release_allocation(dev: DeviceState, node, selection: torch.Tensor,
                       core, memory) -> DeviceState:
    return _add_on_node(dev, node, selection, core, memory, 1)


def joint_allocate(gpu: DeviceState, nic: DeviceState, node, n_whole, core,
                   memory, nic_core, nic_memory,
                   strategy: int = DEV_BINPACK, nic_required: bool = False):
    """GPU + NIC co-allocation on one node (tryJointAllocate semantics).

    Allocates GPUs first, then a NIC in the same topology group as the
    chosen GPUs; if no same-group NIC fits, falls back to any NIC (or fails
    when ``nic_required``, the JointAllocate required-scope behavior).

    Returns (gpu_sel, nic_sel, ok).
    """
    gpu_sel, gpu_ok = allocate_on_node(gpu, node, n_whole, core, memory,
                                       strategy=strategy)
    # majority group of the selected gpus (first selected device's group)
    first = torch.argmax(gpu_sel.to(torch.int8))
    gpu_group = torch.where(gpu_ok, gpu.group[node][first], -1)
    nic_sel, nic_ok = allocate_on_node(nic, node, 0, nic_core, nic_memory,
                                       strategy=strategy,
                                       prefer_group=gpu_group)
    # required mode: the NIC AND every selected GPU must share one group
    # (a multi-group GPU spread has no single group for the NIC to sit in)
    nic_same_group = torch.any(nic_sel & (nic.group[node] == gpu_group))
    gpus_one_group = torch.all(~gpu_sel | (gpu.group[node] == gpu_group))
    if nic_required:
        nic_ok = nic_ok & nic_same_group & gpus_one_group
    ok = gpu_ok & nic_ok
    return gpu_sel & ok, nic_sel & ok, ok


def partition_allocate(dev: DeviceState, node, templates: torch.Tensor,
                       n_whole) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick a partition-template-conforming whole-device set (GPU partition
    tables, gpu_shared_resource_templates_cache.go): the selection must be
    an exact (T, D) template row whose devices are all free; earlier rows
    win (the table's preference order)."""
    wfree = _whole_free(dev)[node]                                # (D,)
    sizes = torch.sum(templates, dim=-1, dtype=torch.int32)       # (T,)
    fits = ((sizes == int32_like(n_whole, sizes))
            & torch.all(~templates | wfree[None, :], dim=-1))
    pick = torch.argmax(fits.to(torch.int8))                      # first
    ok = torch.any(fits)
    return templates[pick] & ok, ok
