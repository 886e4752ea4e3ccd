"""Vendor device-plugin adaptation for the bind path (a copy of
``koordinator_tpu/scheduler/device_plugin_adapter.py``; host only).

The reference's DevicePluginAdapter
(`pkg/scheduler/plugins/deviceshare/device_plugin_adapter.go:100`)
translates koord-scheduler's fine-grained device allocation into the
annotation/label dialects third-party device plugins understand, so those
plugins can act as allocators without modification.  Kubelet never shows a
device plugin the pod manifest, so vendors key off bind timestamps,
node-lock annotations, and vendor-specific allocation annotations.

This module is that translation layer for the repo's bind flow: input is
the repo's device-allocated payload
(``DeviceManager.device_allocated_annotation`` —
``{type: [{"minor", "resources": {"core", "memory"}}]}``), output is an
:class:`AdaptResult` of pod annotations/labels and node annotations (the
node lock).  Gated behind the ``DevicePluginAdaption`` feature
(``koordinator_tpu_torch/features.py``), matching the reference gate.

Memory units: the repo's device tensors carry memory in MiB
(``ops/deviceshare.py`` contract), so the allocation payload's ``memory`` is
MiB here; vendor units convert from that (Cambricon 256 MiB vMemory
units, MetaX 1 MiB vRAM units — `device_plugin_adapter.go:83,90`, which
divide byte quantities by the same unit sizes).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Mapping, Optional

SCHEDULING_PREFIX = "scheduling.koordinator.sh"
ANNOTATION_BIND_TIMESTAMP = f"{SCHEDULING_PREFIX}/bind-timestamp"
ANNOTATION_GPU_MINORS = f"{SCHEDULING_PREFIX}/gpu-minors"

# vendor dialects (device_plugin_adapter.go:46-90)
ANNOTATION_PREDICATE_TIME = "predicate-time"
ANNOTATION_HUAWEI_NPU_CORE = "huawei.com/npu-core"
ANNOTATION_HUAWEI_ASCEND_310P = "huawei.com/Ascend310P"
ANNOTATION_CAMBRICON_ASSIGNED = "CAMBRICON_DSMLU_ASSIGHED"
ANNOTATION_CAMBRICON_PROFILE = "CAMBRICON_DSMLU_PROFILE"
ANNOTATION_CAMBRICON_LOCK = "cambricon.com/dsmlu.lock"
ANNOTATION_METAX_ALLOCATED = "metax-tech.com/gpu-devices-allocated"
ANNOTATION_HAMI_LOCK = "hami.io/mutex.lock"
LABEL_GPU_ISOLATION_PROVIDER = f"{SCHEDULING_PREFIX}/gpu-isolation-provider"
LABEL_HAMI_VGPU_NODE = "hami.io/vgpu-node"
ISOLATION_PROVIDER_HAMI_CORE = "hami-core"

#: node labels carrying the GPU vendor/model (the reference reads the same
#: pair off Device-CR labels, extension/device_share.go:63)
LABEL_GPU_VENDOR = "node.koordinator.sh/gpu-vendor"
LABEL_GPU_MODEL = "node.koordinator.sh/gpu-model"

GPU_VENDOR_HUAWEI = "huawei"
GPU_VENDOR_CAMBRICON = "cambricon"
GPU_VENDOR_METAX = "metax"

CAMBRICON_VMEMORY_UNIT_MIB = 256
METAX_VRAM_UNIT_MIB = 1

#: node-lock staleness bound (device_plugin_adapter.go:97 nodeLockTimeout)
NODE_LOCK_TIMEOUT_SECONDS = 5 * 60.0


class AdaptError(ValueError):
    """Allocation cannot be expressed in the vendor's dialect."""


@dataclasses.dataclass
class AdaptResult:
    """Annotations/labels the bind flow must apply."""

    pod_annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    pod_labels: dict[str, str] = dataclasses.field(default_factory=dict)
    #: node lock annotation (key -> timestamp str); the vendor's plugin
    #: removes it after it processes the pod
    node_annotations: dict[str, str] = dataclasses.field(default_factory=dict)


def _minors_str(allocs: list[dict], prefix: str = "") -> str:
    return ",".join(f"{prefix}{int(a['minor'])}" for a in allocs)


def adapt_for_device_plugin(
    allocation: Mapping[str, list[dict]],
    gpu_vendor: str = "",
    gpu_model: str = "",
    pod_labels: Optional[Mapping[str, str]] = None,
    node_annotations: Optional[Mapping[str, str]] = None,
    clock: Callable[[], float] = time.time,
) -> AdaptResult:
    """Translate one pod's device allocation for vendor device plugins.

    ``allocation`` is the repo's device-allocated payload; ``gpu_vendor`` /
    ``gpu_model`` come from the node's Device CR labels.  Raises
    :class:`AdaptError` when the allocation cannot be expressed (the
    reference fails the PreBind the same way) — including a held,
    non-stale node lock for vendors that require one.
    """
    out = AdaptResult()
    now_ns = int(clock() * 1e9)
    # general adapter: every pod gets the bind timestamp
    out.pod_annotations[ANNOTATION_BIND_TIMESTAMP] = str(now_ns)

    gpu = allocation.get("gpu")
    if not gpu:
        return out

    # general GPU adapter: minor list + HAMi vGPU node pin
    out.pod_annotations[ANNOTATION_GPU_MINORS] = _minors_str(gpu)
    labels = dict(pod_labels or {})
    if labels.get(LABEL_GPU_ISOLATION_PROVIDER) == ISOLATION_PROVIDER_HAMI_CORE:
        out.pod_labels[LABEL_HAMI_VGPU_NODE] = ""  # bind fills node name

    if gpu_vendor == GPU_VENDOR_HUAWEI:
        out.pod_annotations[ANNOTATION_PREDICATE_TIME] = str(now_ns)
        if gpu_model == "Ascend-310P3-300I-DUO":
            out.pod_annotations[ANNOTATION_HUAWEI_ASCEND_310P] = (
                _minors_str(gpu, "Ascend310P-"))
        else:
            template = gpu[0].get("template", "")
            if template:  # vNPU: one shared-resource template
                out.pod_annotations[ANNOTATION_HUAWEI_NPU_CORE] = (
                    f"{int(gpu[0]['minor'])}-{template}")
            else:
                out.pod_annotations[ANNOTATION_HUAWEI_NPU_CORE] = (
                    _minors_str(gpu))
    elif gpu_vendor == GPU_VENDOR_CAMBRICON:
        if len(gpu) > 1:
            raise AdaptError(
                "multiple gpu share is not supported on device side")
        res = gpu[0].get("resources", {})
        core = res.get("core")
        if core is None:
            raise AdaptError("gpu core resource is required")
        memory = int(res.get("memory", 0))
        if memory < CAMBRICON_VMEMORY_UNIT_MIB:
            raise AdaptError(
                f"gpu memory must not be less than "
                f"{CAMBRICON_VMEMORY_UNIT_MIB} MiB")
        _check_node_lock(node_annotations, ANNOTATION_CAMBRICON_LOCK,
                         clock())
        out.pod_annotations[ANNOTATION_CAMBRICON_ASSIGNED] = "false"
        out.pod_annotations[ANNOTATION_CAMBRICON_PROFILE] = (
            f"{int(gpu[0]['minor'])}_{int(core)}"
            f"_{memory // CAMBRICON_VMEMORY_UNIT_MIB}")
        out.node_annotations[ANNOTATION_CAMBRICON_LOCK] = str(now_ns)
    elif gpu_vendor == GPU_VENDOR_METAX:
        requests = []
        for a in gpu:
            res = a.get("resources", {})
            core = res.get("core")
            if core is None:
                raise AdaptError("gpu core resource is required")
            memory = int(res.get("memory", 0))
            if memory < METAX_VRAM_UNIT_MIB:
                raise AdaptError(
                    f"gpu memory must not be less than "
                    f"{METAX_VRAM_UNIT_MIB} MiB")
            requests.append({
                "uuid": str(a.get("id", a["minor"])),
                "compute": int(core),
                "vRam": memory // METAX_VRAM_UNIT_MIB,
            })
        _check_node_lock(node_annotations, ANNOTATION_HAMI_LOCK, clock())
        out.pod_annotations[ANNOTATION_METAX_ALLOCATED] = json.dumps(
            [requests], separators=(",", ":"))
        out.node_annotations[ANNOTATION_HAMI_LOCK] = str(now_ns)
    return out


def _check_node_lock(node_annotations: Optional[Mapping[str, str]],
                     key: str, now: float) -> None:
    """Vendors whose plugins cannot disambiguate concurrent pods take a
    node-level lock annotation; a held, non-stale lock rejects the bind
    (the plugin removes the lock when it finishes).  Stale locks
    (> NODE_LOCK_TIMEOUT_SECONDS) are overwritten, matching lockNode's
    timeout recovery."""
    held = (node_annotations or {}).get(key)
    if not held:
        return
    try:
        held_ns = int(held)
    except ValueError:
        return  # corrupt lock value: treat as stale
    if now - held_ns / 1e9 < NODE_LOCK_TIMEOUT_SECONDS:
        raise AdaptError(f"node lock {key} is held")
