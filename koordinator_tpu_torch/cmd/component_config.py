"""Versioned component config for scheduler plugin args (port of
``koordinator_tpu/cmd/component_config.py``).

The reference configures plugin behavior through a KubeSchedulerConfiguration
file with per-plugin args, defaulting, and validation
(``pkg/scheduler/apis/config/types.go:31-396`` + ``v1/`` defaulting +
``validation/``); CLI flags alone cannot express per-resource weights or
thresholds.  This module is that mechanism for the rebuild:
``koord-scheduler --config FILE`` loads the same YAML shape

    apiVersion: kubescheduler.config.k8s.io/v1
    kind: KubeSchedulerConfiguration
    profiles:
    - schedulerName: koord-scheduler
      pluginConfig:
      - name: LoadAwareScheduling
        args:
          resourceWeights: {cpu: 1, memory: 1}
          usageThresholds: {cpu: 65, memory: 95}
          aggregated: {usageThresholds: {cpu: 70}}
          estimatedScalingFactors: {cpu: 85, memory: 70}
      - name: NodeResourcesFitPlus
        args: {resources: {cpu: {weight: 2, type: MostAllocated}}}
      - name: ScarceResourceAvoidance
        args: {resources: [gpu], weight: 1}
      - name: Coscheduling
        args: {defaultTimeout: 300s, enablePreemption: true}

into a :class:`SchedulerComponentConfig`: a ScoringConfig built by
DEFAULTING from ``ScoringConfig.default()`` and overlaying only the
given args, plus the scheduler-level knobs, with the reference's
validation posture — unknown plugin names, unknown arg keys, unknown
resource names, out-of-range percentages, and unsupported scoring
strategies are hard errors, not silent drops (a typo'd threshold that
silently kept the default would be worse than a crash at startup).

The :class:`ScoringConfig` fields are the port's int32 (and bool) tensors,
on the device the loader is given (None means the GPU); an integer past
int32 raises ``OverflowError``, as the JAX loader's int32 arrays do.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from koordinator_tpu_torch.api.resources import RESOURCE_NAMES, ResourceDim
from koordinator_tpu_torch.ops.assignment import ScoringConfig


class ComponentConfigError(ValueError):
    """Invalid component config — fail at startup, loudly."""


@dataclasses.dataclass
class SchedulerComponentConfig:
    #: defaults live HERE and nowhere else: a no-config assembly and a
    #: config-without-that-plugin assembly must agree
    scoring: ScoringConfig = dataclasses.field(
        default_factory=ScoringConfig.default)
    gang_default_timeout_sec: float = 600.0
    enable_preemption: bool | None = None


def _resource_dim(name: str, where: str) -> int:
    # the reference keys args by k8s resource names
    # (kubernetes.io/batch-cpu); bare dim names (gpu, batch_cpu) are
    # accepted too, like resource_vector's keyword form
    dim = RESOURCE_NAMES.get(name)
    if dim is None:
        try:
            dim = ResourceDim[name.upper().replace("-", "_")]
        except KeyError:
            raise ComponentConfigError(
                f"{where}: unknown resource name {name!r} "
                f"(known: {sorted(RESOURCE_NAMES)} or bare dim names "
                f"{[d.name.lower() for d in ResourceDim]})") from None
    return int(dim)


def _int32(value: int) -> int:
    if not -2**31 <= value < 2**31:
        raise OverflowError(f"Python int {value} too large to convert to "
                            "int32")
    return value


def _scalar(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_int32(value), dtype=torch.int32, device=like.device)


def _int_vector(base, mapping, where: str, lo: int = 0,
                hi: int | None = None):
    if not isinstance(mapping, dict):
        raise ComponentConfigError(f"{where}: expected a mapping")
    out = base.clone()
    for name, value in mapping.items():
        if not isinstance(value, int) or isinstance(value, bool):
            raise ComponentConfigError(
                f"{where}[{name}]: expected an integer, got {value!r}")
        if value < lo or (hi is not None and value > hi):
            raise ComponentConfigError(
                f"{where}[{name}]: {value} outside [{lo}, {hi}]")
        dim = _resource_dim(name, where)
        out[dim] = _int32(value)
    return out


def _check_keys(args: dict, allowed: set[str], plugin: str) -> None:
    unknown = set(args) - allowed
    if unknown:
        raise ComponentConfigError(
            f"pluginConfig {plugin}: unknown args {sorted(unknown)} "
            f"(allowed: {sorted(allowed)})")


_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)$")
_DURATION_SCALE = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def _parse_duration(value, where: str) -> float:
    """metav1.Duration strings ("600s", "10m") or bare seconds; must be
    positive (a non-positive gang timeout would reject every gang on its
    first transient failure)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        seconds = float(value)
    else:
        m = _DURATION.match(str(value))
        if not m:
            raise ComponentConfigError(
                f"{where}: bad duration {value!r} "
                f"(want e.g. '600s', '10m')")
        seconds = float(m.group(1)) * _DURATION_SCALE[m.group(2)]
    if seconds <= 0:
        raise ComponentConfigError(
            f"{where}: duration must be positive, got {value!r}")
    return seconds


def _apply_loadaware(cfg: ScoringConfig, args: dict) -> ScoringConfig:
    _check_keys(args, {"resourceWeights", "dominantResourceWeight",
                       "usageThresholds", "aggregated",
                       "estimatedScalingFactors"}, "LoadAwareScheduling")
    if "resourceWeights" in args:
        cfg = cfg.replace(loadaware_resource_weights=_int_vector(
            torch.zeros_like(cfg.loadaware_resource_weights),
            args["resourceWeights"],
            "LoadAwareScheduling.resourceWeights"))
    if "dominantResourceWeight" in args:
        w = args["dominantResourceWeight"]
        if not isinstance(w, int) or isinstance(w, bool) or w < 0:
            raise ComponentConfigError(
                "LoadAwareScheduling.dominantResourceWeight: "
                f"expected a non-negative integer, got {w!r}")
        cfg = cfg.replace(loadaware_dominant_weight=_scalar(
            w, cfg.loadaware_dominant_weight))
    if "usageThresholds" in args:
        cfg = cfg.replace(usage_thresholds=_int_vector(
            torch.zeros_like(cfg.usage_thresholds),
            args["usageThresholds"],
            "LoadAwareScheduling.usageThresholds", hi=100))
    if "aggregated" in args:
        agg = args["aggregated"]
        _check_keys(agg, {"usageThresholds"},
                    "LoadAwareScheduling.aggregated")
        cfg = cfg.replace(agg_usage_thresholds=_int_vector(
            torch.zeros_like(cfg.agg_usage_thresholds),
            agg.get("usageThresholds", {}),
            "LoadAwareScheduling.aggregated.usageThresholds", hi=100))
    if "estimatedScalingFactors" in args:
        cfg = cfg.replace(estimator_factors=_int_vector(
            cfg.estimator_factors, args["estimatedScalingFactors"],
            "LoadAwareScheduling.estimatedScalingFactors", hi=100))
    return cfg


def _apply_fitplus(cfg: ScoringConfig, args: dict) -> ScoringConfig:
    _check_keys(args, {"resources"}, "NodeResourcesFitPlus")
    weights = torch.zeros_like(cfg.fitplus_resource_weights)
    most = torch.zeros_like(cfg.fitplus_most_allocated)
    for name, spec in (args.get("resources") or {}).items():
        if not isinstance(spec, dict):
            raise ComponentConfigError(
                f"NodeResourcesFitPlus.resources[{name}]: expected "
                f"{{weight, type}}")
        _check_keys(spec, {"weight", "type"},
                    f"NodeResourcesFitPlus.resources[{name}]")
        strategy = spec.get("type", "LeastAllocated")
        if strategy not in ("LeastAllocated", "MostAllocated"):
            raise ComponentConfigError(
                f"NodeResourcesFitPlus.resources[{name}]: unsupported "
                f"scoring strategy {strategy!r} (LeastAllocated or "
                f"MostAllocated)")
        dim = _resource_dim(name, "NodeResourcesFitPlus.resources")
        weight = spec.get("weight", 1)
        if not isinstance(weight, int) or isinstance(weight, bool) \
                or weight < 0:
            raise ComponentConfigError(
                f"NodeResourcesFitPlus.resources[{name}].weight: "
                f"expected a non-negative integer, got {weight!r}")
        weights[dim] = _int32(weight)
        most[dim] = strategy == "MostAllocated"
    return cfg.replace(fitplus_resource_weights=weights,
                       fitplus_most_allocated=most)


def _apply_scarce(cfg: ScoringConfig, args: dict) -> ScoringConfig:
    _check_keys(args, {"resources", "weight"}, "ScarceResourceAvoidance")
    dims = torch.zeros_like(cfg.scarce_dims)
    for name in args.get("resources") or []:
        dims[_resource_dim(name, "ScarceResourceAvoidance.resources")] = True
    weight = args.get("weight", 1)
    if not isinstance(weight, int) or isinstance(weight, bool) \
            or weight < 0:
        raise ComponentConfigError(
            f"ScarceResourceAvoidance.weight: expected a non-negative "
            f"integer, got {weight!r}")
    return cfg.replace(scarce_dims=dims,
                       scarce_plugin_weight=_scalar(
                           weight, cfg.scarce_plugin_weight))


def load_scheduler_config(path: str,
                          scheduler_name: str = "koord-scheduler",
                          device=None) -> SchedulerComponentConfig:
    """Parse + default + validate one profile's pluginConfig; the scoring
    tensors on ``device`` (None means the GPU)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, dict):
        raise ComponentConfigError(f"{path}: not a config document")
    kind = doc.get("kind", "KubeSchedulerConfiguration")
    if kind != "KubeSchedulerConfiguration":
        raise ComponentConfigError(f"{path}: unexpected kind {kind!r}")

    profiles = doc.get("profiles") or []
    profile = None
    for p in profiles:
        if p.get("schedulerName", "koord-scheduler") == scheduler_name:
            profile = p
            break
    if profile is None:
        raise ComponentConfigError(
            f"{path}: no profile named {scheduler_name!r}")

    out = SchedulerComponentConfig(scoring=ScoringConfig.default(device))
    appliers = {
        "LoadAwareScheduling": _apply_loadaware,
        "NodeResourcesFitPlus": _apply_fitplus,
        "ScarceResourceAvoidance": _apply_scarce,
    }
    for entry in profile.get("pluginConfig") or []:
        name = entry.get("name")
        args = entry.get("args") or {}
        if name in appliers:
            out.scoring = appliers[name](out.scoring, args)
        elif name == "Coscheduling":
            _check_keys(args, {"defaultTimeout", "enablePreemption"},
                        "Coscheduling")
            if "defaultTimeout" in args:
                out.gang_default_timeout_sec = _parse_duration(
                    args["defaultTimeout"], "Coscheduling.defaultTimeout")
            if "enablePreemption" in args:
                if not isinstance(args["enablePreemption"], bool):
                    raise ComponentConfigError(
                        "Coscheduling.enablePreemption: expected a bool")
                out.enable_preemption = args["enablePreemption"]
        else:
            raise ComponentConfigError(
                f"{path}: unknown pluginConfig name {name!r} "
                f"(supported: {sorted(appliers) + ['Coscheduling']})")
    return out
