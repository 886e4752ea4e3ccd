"""Parity of the port's reduced scheduler and snapshot with the JAX
``Scheduler(incremental_solve=False)``, the port's scheduler set the same
way: the same NodeSpec/PodSpec lists give the same binds and failed-pod sets
round after round.  tests/test_torch_incremental.py holds both schedulers'
defaults (the incremental candidate cache) against each other.

Node capacity stays below 1,024 so the JAX solver kit does not shard over
the test platform's virtual devices; rounds hold at least 1,024 pods so the
batch solver (and its greedy rescue) runs.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    R,
    failure_docs,
    quota_trees,
    set_torch_threads,
)

set_torch_threads()


def _node_dicts(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = np.zeros(R, np.int32)
        a[0] = rng.integers(8_000, 64_000)
        a[1] = rng.integers(16_384, 262_144)
        out.append(dict(
            name=f"n{i}", allocatable=a,
            usage=(a * rng.random(R) * 0.3).astype(np.int32),
            labels={"zone": f"z{i % 3}"},
            taints={"dedicated": "infra"} if i % 9 == 0 else {}))
    return out


def _pod_dicts(seed: int, n: int, start: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        q = np.zeros(R, np.int32)
        q[0] = rng.integers(100, 4_000)
        q[1] = rng.integers(128, 8_192)
        out.append(dict(
            name=f"p{start + j}", requests=q,
            priority=int(rng.integers(3_000, 9_999)),
            node_selector={"zone": f"z{j % 3}"} if j % 6 == 0 else {},
            tolerations={"dedicated": "infra"} if j % 4 == 0 else {},
            quota=("qa", "qb", "qc", None)[j % 4],
            non_preemptible=(j % 11 == 0),
            creation=float(start + j)))
    return out


def _pair(nodes, capacity, rot_start=None):
    """(JAX scheduler, port scheduler, JAX binds, port binds) over the same
    nodes and quota tree."""
    from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode

    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
    )

    jtree, ttree = quota_trees(0, loose=True)
    jsnap, tsnap = JSnap(capacity=capacity), ClusterSnapshot(capacity,
                                                             device="cpu")
    for n in nodes:
        jsnap.upsert_node(JNode(**n))
        tsnap.upsert_node(NodeSpec(**n))
    jbinds, tbinds = [], []
    jsched = JSched(jsnap, quota_tree=jtree,
                    bind_fn=lambda p, n: jbinds.append((p, n)),
                    incremental_solve=False)
    tsched = Scheduler(tsnap, quota_tree=ttree,
                       bind_fn=lambda p, n: tbinds.append((p, n)),
                       incremental_solve=False, device="cpu")
    if rot_start is not None:
        jsched._rot_counter = tsched._rot_counter = rot_start
    return jsched, tsched, jbinds, tbinds


def _enqueue(jsched, tsched, pods):
    from koordinator_tpu.scheduler.snapshot import PodSpec as JPod

    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    for p in pods:
        jsched.enqueue(JPod(**p))
        tsched.enqueue(PodSpec(**p))


def _assert_round_equal(jr, tr, jsched, tsched):
    assert tr.assignments == jr.assignments
    assert failure_docs(tr) == failure_docs(jr)
    assert tr.round_pods == jr.round_pods
    assert tsched.last_solver == jsched.last_solver
    assert np.array_equal(np.asarray(jsched.snapshot.state.node_requested),
                          tsched.snapshot.state.node_requested.numpy())
    for name, q in jsched.quota_tree.nodes.items():
        assert np.array_equal(q.used, tsched.quota_tree.nodes[name].used)


def test_two_batch_rounds_match_jax():
    """Round 1: 1,100 pods on 64 nodes (contended: the greedy rescue
    places pods the batch solver left).  Round 2: the leftovers plus 1,000
    new pods.  Binds (in order), failed sets, node accounting and quota
    usage all match."""
    jsched, tsched, jbinds, tbinds = _pair(_node_dicts(3, 64), capacity=64)
    _enqueue(jsched, tsched, _pod_dicts(3, 1_100))
    jr, tr = jsched.schedule_round(), tsched.schedule_round()
    assert jsched.last_solve_path == "disabled"
    assert tsched.last_solver == "batch"
    _assert_round_equal(jr, tr, jsched, tsched)
    assert tr.rescued > 0 and len(tr.failures) > 0

    _enqueue(jsched, tsched, _pod_dicts(2, 1_000, start=10_000))
    jr, tr = jsched.schedule_round(), tsched.schedule_round()
    assert tsched.last_solver == "batch"
    _assert_round_equal(jr, tr, jsched, tsched)
    assert tbinds == jbinds
    assert len(tbinds) > 1_000


def test_greedy_round_with_wrapping_rotation_ids_matches_jax():
    """Under the batch threshold the exact greedy solve runs; rotation ids
    are started just below 2**31 so the registry's 31-bit wrap happens
    inside the round."""
    jsched, tsched, jbinds, tbinds = _pair(_node_dicts(5, 24), capacity=32,
                                           rot_start=2**31 - 40)
    _enqueue(jsched, tsched, _pod_dicts(5, 120))
    jr, tr = jsched.schedule_round(), tsched.schedule_round()
    assert tsched.last_solver == jsched.last_solver == "greedy"
    _assert_round_equal(jr, tr, jsched, tsched)
    assert tbinds == jbinds
    assert 0 < tsched._rot_counter < 2**31 - 40


def test_snapshot_lifecycle_matches_jax():
    """Upsert, remove, row reuse and growth leave the same device state;
    the flush writes rows in place."""
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap
    from koordinator_tpu.scheduler.snapshot import NodeSpec as JNode

    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
    )
    from tests.torch_parity import assert_same_fields

    nodes = _node_dicts(7, 70)
    js, ts = JSnap(capacity=64), ClusterSnapshot(64, device="cpu")
    for n in nodes[:60]:
        js.upsert_node(JNode(**n))
        ts.upsert_node(NodeSpec(**n))
    js.flush()
    ts.flush()
    for name in ("n3", "n10", "n11"):
        js.remove_node(name)
        ts.remove_node(name)
    for n in nodes[60:]:                 # reuses the freed rows, then grows
        js.upsert_node(JNode(**n))
        ts.upsert_node(NodeSpec(**n))
    assert ts.capacity == js.capacity == 128
    assert js.flush() == ts.flush()
    assert_same_fields(js.state, ts.state, "ClusterState")
    assert js.node_index == ts.node_index
    assert [js.node_name(r) for r in range(128)] == [
        ts.node_name(r) for r in range(128)]
    assert js.class_capacity == ts.class_capacity
    # in place: a flush without growth keeps the tensors
    alloc_ptr = ts.state.node_allocatable.data_ptr()
    spec = dict(nodes[0], usage=np.ones(R, np.int32))
    ts.upsert_node(NodeSpec(**spec))
    assert ts.flush() == 1
    assert ts.state.node_allocatable.data_ptr() == alloc_ptr


def test_entry_points_without_a_device_raise_when_no_gpu(monkeypatch):
    """Left without ``device=``, the port's entry points run on CUDA; with
    no GPU present they raise instead of carrying on on the CPU."""
    from koordinator_tpu_torch import resolve_device
    from koordinator_tpu_torch.ops.assignment import ScoringConfig
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot
    from koordinator_tpu_torch.state.cluster_state import ClusterState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterSnapshot(capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringConfig.default()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterState.from_arrays(np.ones((2, R), np.int32))
    assert resolve_device("cpu") == torch.device("cpu")
