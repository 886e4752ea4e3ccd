"""Parity of the port's scheduler component config
(``koordinator_tpu_torch/cmd/component_config.py``) with the JAX package's:
the same YAML loads into equal ``ScoringConfig`` values (the port's int32
and bool tensors against the JAX arrays) and the same scheduler knobs, and a
bad document fails with the same error type and message on both; the port's
binary wires a config file as the JAX binary does.  Mirrors
tests/test_component_config.py's scheduler cases (the descheduler's config
waits for the descheduler's port).
"""

import textwrap

import numpy as np
import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


FULL = textwrap.dedent("""
    apiVersion: kubescheduler.config.k8s.io/v1
    kind: KubeSchedulerConfiguration
    profiles:
    - schedulerName: koord-scheduler
      pluginConfig:
      - name: LoadAwareScheduling
        args:
          resourceWeights: {cpu: 2, memory: 1}
          dominantResourceWeight: 1
          usageThresholds: {cpu: 70, memory: 90}
          aggregated:
            usageThresholds: {cpu: 60}
          estimatedScalingFactors: {cpu: 80}
      - name: NodeResourcesFitPlus
        args:
          resources:
            cpu: {weight: 3, type: MostAllocated}
            memory: {weight: 1, type: LeastAllocated}
            kubernetes.io/batch-cpu: {weight: 2}
      - name: ScarceResourceAvoidance
        args: {resources: [gpu, batch_memory], weight: 2}
      - name: Coscheduling
        args: {defaultTimeout: 5m, enablePreemption: true}
""")

HEAD = textwrap.dedent("""
    kind: KubeSchedulerConfiguration
    profiles:
    - schedulerName: koord-scheduler
      pluginConfig:
""")

DOCS = {
    "full": FULL,
    "empty": textwrap.dedent("""
        kind: KubeSchedulerConfiguration
        profiles:
        - schedulerName: koord-scheduler
    """),
    "second_profile": textwrap.dedent("""
        kind: KubeSchedulerConfiguration
        profiles:
        - schedulerName: other
          pluginConfig: [{name: Typo}]
        - schedulerName: koord-scheduler
          pluginConfig:
          - name: Coscheduling
            args: {defaultTimeout: 1500ms, enablePreemption: false}
    """),
    "typo": HEAD + "  - name: Typo\n    args: {}\n",
    "unknown_arg": HEAD + "  - name: LoadAwareScheduling\n"
                          "    args: {usageThreshold: {}}\n",
    "out_of_range": HEAD + "  - name: LoadAwareScheduling\n"
                           "    args: {usageThresholds: {cpu: 150}}\n",
    "unknown_resource": HEAD + "  - name: LoadAwareScheduling\n"
                               "    args: {usageThresholds: {floppy: 10}}\n",
    "strategy": HEAD + "  - name: NodeResourcesFitPlus\n"
                       "    args: {resources: {cpu: {type: Balanced}}}\n",
    "duration": HEAD + "  - name: Coscheduling\n"
                       "    args: {defaultTimeout: soon}\n",
    "negative_duration": HEAD + "  - name: Coscheduling\n"
                                "    args: {defaultTimeout: 0s}\n",
    "not_int": HEAD + "  - name: LoadAwareScheduling\n"
                      "    args: {resourceWeights: {cpu: 1.5}}\n",
    "bool_weight": HEAD + "  - name: ScarceResourceAvoidance\n"
                          "    args: {weight: true}\n",
    "overflow": HEAD + "  - name: LoadAwareScheduling\n"
                       "    args: {resourceWeights: {cpu: 4294967296}}\n",
    "overflow_scalar": HEAD + "  - name: LoadAwareScheduling\n"
                              "    args: {dominantResourceWeight: "
                              "4294967296}\n",
    "preempt_not_bool": HEAD + "  - name: Coscheduling\n"
                               "    args: {enablePreemption: yes please}\n",
    "no_profile": textwrap.dedent("""
        kind: KubeSchedulerConfiguration
        profiles:
        - schedulerName: other-scheduler
    """),
    "wrong_kind": "kind: Pod\n",
    "not_a_doc": "- 1\n- 2\n",
}

FIELDS = ("loadaware_resource_weights", "loadaware_dominant_weight",
          "loadaware_plugin_weight", "usage_thresholds",
          "agg_usage_thresholds", "estimator_factors", "estimator_defaults",
          "fitplus_resource_weights", "fitplus_most_allocated",
          "fitplus_plugin_weight", "scarce_dims", "scarce_plugin_weight")


def load(pkg: str, path: str):
    """(scoring fields as numpy, timeout, preemption) or (error type name,
    message)."""
    if pkg == "jax":
        from koordinator_tpu.cmd.component_config import load_scheduler_config

        kw = {}
    else:
        from koordinator_tpu_torch.cmd.component_config import (
            load_scheduler_config,
        )

        kw = {"device": "cpu"}
    try:
        out = load_scheduler_config(path, **kw)
    except Exception as e:  # compared by type and message
        return type(e).__name__, str(e).replace("koordinator_tpu_torch",
                                                "koordinator_tpu")
    scoring = {}
    for f in FIELDS:
        value = getattr(out.scoring, f)
        value = value.numpy() if hasattr(value, "numpy") else np.asarray(
            value)
        scoring[f] = (str(value.dtype), value.tolist())
    return scoring, out.gang_default_timeout_sec, out.enable_preemption


@pytest.mark.parametrize("name", sorted(DOCS))
def test_same_yaml_loads_alike(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text(DOCS[name])
    got, want = load("torch", str(path)), load("jax", str(path))
    if name in ("overflow", "overflow_scalar"):
        # both refuse an integer past int32; the wording is each library's
        assert got[0] == want[0] == "OverflowError"
        return
    assert got == want


def test_port_config_tensors_are_int32_on_the_device(tmp_path):
    import torch

    from koordinator_tpu_torch.cmd.component_config import (
        load_scheduler_config,
    )

    path = tmp_path / "full.yaml"
    path.write_text(FULL)
    out = load_scheduler_config(str(path), device="cpu")
    for f in FIELDS:
        t = getattr(out.scoring, f)
        assert t.device.type == "cpu"
        assert t.dtype == (torch.bool if f in ("fitplus_most_allocated",
                                               "scarce_dims")
                           else torch.int32), f


def test_binary_wires_config_file(tmp_path):
    from koordinator_tpu_torch.cmd.binaries import main_koord_scheduler
    from koordinator_tpu_torch.scheduler.scheduler import GangRecord

    path = tmp_path / "full.yaml"
    path.write_text(FULL)
    with pytest.raises(SystemExit, match="no eviction transport"):
        main_koord_scheduler(["--config", str(path),
                              "--disable-leader-election"], device="cpu")
    evictions = []
    asm = main_koord_scheduler(
        ["--config", str(path), "--disable-leader-election"],
        preempt_fn=lambda victim, preemptor: evictions.append(victim),
        device="cpu")
    try:
        sched = asm.component
        assert int(sched.config.usage_thresholds[0]) == 70
        assert sched.config.usage_thresholds.device.type == "cpu"
        assert sched.gang_default_timeout_sec == 300.0
        assert sched.enable_preemption is True
        sched.register_gang(GangRecord(name="g", min_member=2))
        assert sched.gangs["g"].wait_time_sec == 300.0
    finally:
        asm.stop()
