"""Parity of the port's Filter + Score (koordinator_tpu_torch.ops.filtering,
.scoring, .assignment.score_pods) with the JAX package, bit for bit.

Every output is int32 or bool, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import config, port, problem, same, set_torch_threads

set_torch_threads()

#: (seed, problem mode, config variant, invalid tail nodes): 24 seeded cases
#: covering the instantaneous and aggregated thresholds, the threshold
#: rounding edge, selector classes (with out-of-range class ids), a dense
#: feasibility mask and every score plugin's knobs
SCORE_CASES = (
    [(s, "factored", "default", 0) for s in range(6)]
    + [(s, "factored", "agg", 0) for s in range(6, 10)]
    + [(s, "edge", "default", 0) for s in range(10, 13)]
    + [(s, "edge", "agg", 0) for s in range(13, 15)]
    + [(s, "out_of_range", "default", 0) for s in range(15, 18)]
    + [(s, "dense", "default", 0) for s in range(18, 21)]
    + [(21, "factored", "dominant", 0), (22, "factored", "most_allocated", 0),
       (23, "edge", "everything", 6)]
)


@pytest.mark.parametrize("seed,mode,variant,tail", SCORE_CASES)
def test_score_pods_matches_jax(seed, mode, variant, tail):
    from koordinator_tpu.ops.assignment import score_pods as jax_score_pods

    from koordinator_tpu_torch.ops.assignment import score_pods

    js, jp = problem(seed, mode, invalid_tail=tail)
    jcfg = config(variant)
    want_scores, want_feas = jax_score_pods(js, jp, jcfg)
    scores, feas = score_pods(port(js, "ClusterState"), port(jp, "PodBatch"),
                              port(jcfg, "ScoringConfig"))
    assert same(want_scores, scores)
    assert same(want_feas, feas)
    # the cases must exercise both verdicts
    assert 0 < int(feas.sum()) < feas.numel()


def test_rounding_edge_is_exercised():
    """The edge problem puts pods on both sides of the round-half-up
    boundary: some (pod, node) pairs pass at 65% and some fail at 66%."""
    from koordinator_tpu_torch.ops import filtering
    from koordinator_tpu_torch.ops.assignment import pod_estimates

    js, jp = problem(10, "edge")
    state, pods = port(js, "ClusterState"), port(jp, "PodBatch")
    cfg = port(config("default"), "ScoringConfig")
    est = pod_estimates(pods, cfg)
    ok = filtering.usage_threshold_mask(
        state.node_usage, state.node_allocatable, cfg.usage_thresholds, est)
    cpu_used = state.node_usage[None, :, 0] + est[:, None, 0]
    assert bool((ok & (cpu_used == 654)).any())
    assert bool((~ok & (cpu_used == 655)).any())


@pytest.mark.parametrize("seed", range(4))
def test_filter_primitives_match_jax(seed):
    from koordinator_tpu.ops import filtering as jf

    from koordinator_tpu_torch.ops import filtering as tf

    rng = np.random.default_rng(seed)
    free = rng.integers(-50, 400, (12, 10)).astype(np.int32)
    req = rng.integers(0, 300, (9, 10)).astype(np.int32)
    req[rng.random((9, 10)) < 0.4] = 0
    assert same(jf.fit_mask(free, req),
                tf.fit_mask(torch.from_numpy(free), torch.from_numpy(req)))
    alloc = rng.integers(0, 2_000, (12, 10)).astype(np.int32)
    usage = (alloc * rng.random((12, 10))).astype(np.int32)
    thr = rng.integers(0, 100, 10).astype(np.int32)
    est = rng.integers(0, 200, (9, 10)).astype(np.int32)
    t = torch.from_numpy
    assert same(jf.usage_threshold_mask(usage, alloc, thr),
                tf.usage_threshold_mask(t(usage), t(alloc), t(thr)))
    assert same(jf.usage_threshold_mask(usage, alloc, thr, est),
                tf.usage_threshold_mask(t(usage), t(alloc), t(thr), t(est)))


@pytest.mark.parametrize("seed", range(4))
def test_score_primitives_match_jax(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import scoring as js

    from koordinator_tpu_torch.ops import scoring as ts

    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    alloc = rng.integers(0, 50_000, (12, 10)).astype(np.int32)
    alloc[rng.random((12, 10)) < 0.3] = 0
    requested = (alloc * rng.random((12, 10))).astype(np.int32)
    used = (alloc * rng.random((12, 10)) * 1.2).astype(np.int32)
    pod_req = rng.integers(0, 5_000, (7, 10)).astype(np.int32)
    pod_req[rng.random((7, 10)) < 0.5] = 0
    w = rng.integers(0, 4, 10).astype(np.int32)
    most = rng.random(10) < 0.5
    scarce = rng.random(10) < 0.3
    factors = rng.integers(50, 101, 10).astype(np.int32)
    defaults = rng.integers(0, 300, 10).astype(np.int32)

    assert same(js.loadaware_score(used, alloc, w, 2),
                ts.loadaware_score(t(used), t(alloc), t(w), 2))
    assert same(js.fitplus_score(requested, alloc, pod_req, w, most),
                ts.fitplus_score(t(requested), t(alloc), t(pod_req), t(w),
                                 t(most)))
    assert same(js.scarce_resource_score(pod_req, alloc, scarce),
                ts.scarce_resource_score(t(pod_req), t(alloc), t(scarce)))
    assert same(js.estimate_pod_usage_by_band(jnp.asarray(pod_req), factors,
                                              defaults),
                ts.estimate_pod_usage_by_band(t(pod_req), t(factors),
                                              t(defaults)))


def test_scoring_config_default_matches_jax():
    from koordinator_tpu.ops.assignment import ScoringConfig

    from koordinator_tpu_torch.ops.assignment import ScoringConfig as TCfg
    from tests.torch_parity import assert_same_fields

    assert_same_fields(ScoringConfig.default(), TCfg.default(device="cpu"),
                       "ScoringConfig")


def test_factored_feasibility_out_of_range_class_is_infeasible():
    js, jp = problem(15, "out_of_range")
    state, pods = port(js, "ClusterState"), port(jp, "PodBatch")
    feas = pods.feasible_rows(state)
    out = state.node_class >= pods.selector_mask.shape[1]
    assert bool(out.any())
    assert not bool(feas[:, out].any())
