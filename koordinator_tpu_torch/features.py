"""Feature gates of the scheduler (a copy of ``koordinator_tpu/features.py``'s
:class:`FeatureGates` and ``SCHEDULER_GATES``; the koordlet and runtime-hook
gates stay with the JAX package).

One process-global :class:`FeatureGates` registry with per-gate defaults;
``--feature-gates=Name=true,...``-style overrides via :meth:`set_from_spec`.
"""

from __future__ import annotations

import threading


class FeatureGates:
    def __init__(self, defaults: dict[str, bool]):
        self._defaults = dict(defaults)
        self._overrides: dict[str, bool] = {}
        self._lock = threading.Lock()

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            if name not in self._defaults:
                raise KeyError(f"unknown feature gate {name!r}")
            return self._defaults[name]

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            if name not in self._defaults:
                raise KeyError(f"unknown feature gate {name!r}")
            self._overrides[name] = value

    def set_from_spec(self, spec: str) -> None:
        """Parse 'A=true,B=false' (the --feature-gates flag format)."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, value = part.partition("=")
            self.set(name.strip(), value.strip().lower() in ("true", "1", "yes"))

    def known(self) -> dict[str, bool]:
        with self._lock:
            out = dict(self._defaults)
            out.update(self._overrides)
            return out


# manager/scheduler gates — the union of the reference's two tables
# (pkg/features/features.go:118-169 and scheduler_features.go:146-171;
# overlapping names carry identical defaults in both).  The reference's
# vendored-k8s informer-compat shims (Compatible*/Disable*Informer and
# the GA leftovers CSIStorageCapacity/GenericEphemeralVolume/
# PodDisruptionBudget) are included for flag-surface parity even though
# this design has no client-go informers behind them.
SCHEDULER_GATES = FeatureGates({
    # webhook surface (features.go)
    "PodMutatingWebhook": True,
    "PodValidatingWebhook": True,
    "ElasticQuotaMutatingWebhook": True,
    "ElasticQuotaValidatingWebhook": True,
    "NodeMutatingWebhook": False,
    "NodeValidatingWebhook": False,
    "ConfigMapValidatingWebhook": False,
    "ReservationMutatingWebhook": False,
    "WebhookFramework": True,
    "ColocationProfileSkipMutatingResources": False,
    "ColocationProfileSkipValidatingPriority": False,
    "BindingAdmissionWebhook": False,
    "ValidatePodDeviceResource": False,
    "EnablePodEnhancedValidator": False,
    "DisableExtendedResourceSpec": False,
    "DisableDeviceResourceSpec": False,
    # quota (features.go + scheduler_features.go)
    "MultiQuotaTree": False,
    "ElasticQuotaIgnorePodOverhead": False,
    "ElasticQuotaIgnoreTerminatingPod": False,
    "ElasticQuotaImmediateIgnoreTerminatingPod": False,
    "ElasticQuotaGuaranteeUsage": False,
    "ElasticQuotaEnableUpdateResourceKey": False,
    "ElasticQuotaEvaluationTransformPod": False,
    "DisableDefaultQuota": False,
    "SupportParentQuotaSubmitPod": False,
    "EnableQuotaAdmission": False,
    # manager controllers / transformers (features.go)
    "EnableSyncGPUSharedResource": False,
    "ColocationProfileController": False,
    "DisablePVCReservation": False,
    "PriorityTransformer": False,
    "PreemptionPolicyTransformer": False,
    "ReplaceResourcesTransformer": False,
    # scheduler (scheduler_features.go)
    "CompatibleCSIStorageCapacity": False,
    "DisableCSIStorageCapacityInformer": False,
    "CompatiblePodDisruptionBudget": False,
    "DisablePodDisruptionBudgetInformer": False,
    "DisableDynamicResourceAllocationInformer": False,
    "ResizePod": False,
    "LazyReservationRestore": False,
    "OmitNodeLabelsForReservation": False,
    "SkipReservationFitsNode": False,
    "DevicePluginAdaption": False,
    "CleanExpiredReservationAllocated": False,
    "SkipFilterWithNominatedPods": False,
    "DynamicSchedulerCheck": True,
    "CSIStorageCapacity": True,
    "GenericEphemeralVolume": True,
    "PodDisruptionBudget": True,
    "SyncBarrier": False,
    "CrossSchedulerNomination": False,
    "GangPendingPodsConditionPatch": True,
})
