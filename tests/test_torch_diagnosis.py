"""Parity of the port's diagnoses (``koordinator_tpu_torch/scheduler/
diagnosis.py``) with ``koordinator_tpu/scheduler/diagnosis.py``:
``explain_pod`` (the host recompute), ``diagnosis_from_counts`` (from a
row of the reject-reason counts) and ``PodDiagnosis.message()`` must give
equal records, field by field."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_explain import CASES, case_problem
from tests.torch_parity import port, set_torch_threads

set_torch_threads()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("admitted", [True, False])
def test_explain_pod_equals_jax(name, admitted):
    from koordinator_tpu.scheduler import diagnosis as jd

    from koordinator_tpu_torch.scheduler import diagnosis as td

    state, pods, cfg = case_problem(name, seed=sorted(CASES).index(name))
    ts, tp = port(state, "ClusterState"), port(pods, "PodBatch")
    tc = port(cfg, "ScoringConfig")
    for i in (0, 3, 17, 36):
        want = jd.explain_pod(state, pods, cfg, i, quota_admitted=admitted)
        got = td.explain_pod(ts, tp, tc, i, quota_admitted=admitted)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), i
        assert got.message() == want.message()


@pytest.mark.parametrize("name", ["factored", "dense", "invalid_tail",
                                  "everything"])
def test_diagnosis_from_counts_equals_jax(name):
    from koordinator_tpu.ops import explain as jex
    from koordinator_tpu.scheduler import diagnosis as jd

    from koordinator_tpu_torch.ops import explain as tex
    from koordinator_tpu_torch.scheduler import diagnosis as td

    state, pods, cfg = case_problem(name, seed=4)
    jc, jf = jex.explain_counts(state, pods, cfg)
    tc_, tf = tex.explain_counts(port(state, "ClusterState"),
                                 port(pods, "PodBatch"),
                                 port(cfg, "ScoringConfig"))
    jc, jf = np.asarray(jc), np.asarray(jf)
    tc_, tf = tc_.numpy(), tf.numpy()
    for i in range(pods.capacity):
        for admitted in (True, False):
            want = jd.diagnosis_from_counts(jc[i], int(jf[i]), 41,
                                            quota_admitted=admitted)
            got = td.diagnosis_from_counts(tc_[i], int(tf[i]), 41,
                                           quota_admitted=admitted)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.message() == want.message()


@pytest.mark.parametrize("fields", [
    dict(),
    dict(quota_rejected=True),
    dict(insufficient_resources=0),
    dict(insufficient_resources=0, usage_over_threshold=3,
         affinity_mismatch=2, feasible_nodes=1),
    dict(preempt_node="n3", preempt_victims=["v1", "v2"]),
    dict(quota_rejected=True, preempt_node="n1", preempt_victims=[]),
])
def test_message_equals_jax(fields):
    from koordinator_tpu.scheduler.diagnosis import PodDiagnosis as JD

    from koordinator_tpu_torch.scheduler.diagnosis import PodDiagnosis as TD

    base = dict(total_nodes=4, feasible_nodes=0, insufficient_resources=4,
                usage_over_threshold=0, affinity_mismatch=0,
                quota_rejected=False, invalid=0)
    base.update(fields)
    assert TD(**base).message() == JD(**base).message()
    assert dataclasses.asdict(TD(**base)) == dataclasses.asdict(JD(**base))
