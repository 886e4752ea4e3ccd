"""The port's solver kit (``koordinator_tpu_torch/scheduler/solver_kit.py``)
against the JAX package's: a kit with no mesh (one shard, no sharded twins,
the quality and forecast entries unset, as the JAX kit has them with its
mesh off); two port schedulers handed one kit bind as two with their own
kits, round by round, and share its first-call accounting; rounds through
the kit (cold, incremental, fallback, greedy, rescue and Diagnose) bind as
the JAX ``Scheduler(mesh="off")`` does; and ``sharding_report``'s
``recompiles_by_shape`` has the same ``fn[shape]`` keys on both packages
(JAX's counts may exceed 1 where static arguments recompile; the port's are
1 a kit).
"""

import numpy as np
import pytest

from tests.torch_parity import (
    R,
    failure_docs,
    reset_observability,
    set_torch_threads,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def vec(cpu, mem):
    v = np.zeros(R, np.int32)
    v[0], v[1] = cpu, mem
    return v


def node_spec(rng, name):
    return dict(name=name,
                allocatable=vec(rng.integers(8_000, 32_000),
                                rng.integers(16_384, 65_536)),
                usage=vec(rng.integers(0, 2_000), rng.integers(0, 4_096)),
                labels={"zone": f"z{rng.integers(0, 2)}"})


def pod_spec(rng, name, creation):
    return dict(name=name,
                requests=vec(rng.integers(200, 4_000),
                             rng.integers(256, 8_192)),
                priority=int(rng.integers(3_000, 9_999)),
                node_selector=({"zone": "z1"} if rng.random() < 0.2 else {}),
                creation=creation)


def churn(seed: int, n_rounds: int = 6):
    """Each round's operations: (node upserts, pod adds); a backlog of pods
    no node fits stands from the first (their pass-2 attempts place
    nothing, the rescue and Diagnose see them)."""
    rng = np.random.default_rng(seed)
    out = []
    pod_i = 0
    for rnd in range(n_rounds):
        nodes = ([node_spec(rng, f"n{i}") for i in range(40)] if rnd == 0
                 else [node_spec(rng, f"n{i}")
                       for i in np.unique(rng.integers(0, 40, 2))])
        pods = []
        if rnd == 0:
            pods += [dict(name=f"big{i}", requests=vec(90_000, 10_000),
                          priority=4_000, creation=float(i))
                     for i in range(12)]
        # round 3 is a greedy round: fewer arrivals than the threshold
        # and the standing backlog
        count = 2 if rnd == 3 else int(rng.integers(20, 60))
        for _ in range(count):
            pods.append(pod_spec(rng, f"p{pod_i}", 100.0 + pod_i))
            pod_i += 1
        out.append((nodes, pods))
    return out


def port_scheduler(kit=None, threshold=32):
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    sched = Scheduler(ClusterSnapshot(64, device="cpu"), device="cpu",
                      batch_solver_threshold=threshold, solver_kit=kit)
    sched.incremental_dirty_threshold = 1.0
    return sched


def feed(sched, nodes, pods, pkg: str) -> None:
    if pkg == "jax":
        from koordinator_tpu.scheduler.snapshot import NodeSpec, PodSpec
    else:
        from koordinator_tpu_torch.scheduler.snapshot import NodeSpec, PodSpec
    for spec in nodes:
        spec = dict(spec)
        name = spec["name"]
        if name in sched.snapshot.node_specs:
            spec["allocatable"] = sched.snapshot.node_specs[name].allocatable
            if not isinstance(spec["allocatable"], np.ndarray):
                spec["allocatable"] = np.asarray(spec["allocatable"])
        sched.snapshot.upsert_node(NodeSpec(**spec))
    for spec in pods:
        sched.enqueue(PodSpec(**spec))


def outcome(res, sched) -> tuple:
    return (dict(res.assignments), failure_docs(res),
            sched.last_solve_path if sched.last_solver == "batch"
            else "greedy")


def test_kit_without_a_mesh():
    from koordinator_tpu_torch.scheduler.solver_kit import SolverKit

    kit = SolverKit(device="cpu")
    assert kit.mesh is None and kit.shards == kit.pod_shards == 1
    assert kit.node_sharding is None and kit.pod_sharding is None
    assert not kit.sharding_active_for(65_536)
    assert not kit.pods_shardable(1_024)
    for name in ("solve_sh", "select_scored_sh", "refresh_cands_sh",
                 "pass1_sh", "pass2_sh", "quality_solve",
                 "quality_solve_sh", "forecast_solve", "forecast_solve_sh",
                 "topo_diameter"):
        assert getattr(kit, name) is None, name
    assert kit.device.type == "cpu"
    sched = port_scheduler()
    assert sched.kit.device == sched.device and sched.mesh is None
    assert sched.solver_shard_count == 1
    with pytest.raises(ValueError, match="kit's device"):
        port_scheduler(kit=SolverKit(device="meta"))


def test_shared_kit_binds_as_own_kits():
    from koordinator_tpu_torch import metrics
    from koordinator_tpu_torch.scheduler.solver_kit import SolverKit

    kit = SolverKit(device="cpu")
    shared = [port_scheduler(kit), port_scheduler(kit)]
    own = [port_scheduler(), port_scheduler()]
    assert shared[0].kit is shared[1].kit is kit
    assert own[0].kit is not own[1].kit
    scripts = [churn(3), churn(4)]
    for rnd in range(len(scripts[0])):
        for i in (0, 1):
            nodes, pods = scripts[i][rnd]
            for sched in (shared[i], own[i]):
                feed(sched, nodes, pods, "torch")
            got = outcome(shared[i].schedule_round(), shared[i])
            want = outcome(own[i].schedule_round(), own[i])
            assert got == want, f"scheduler {i} round {rnd}"
    # one count a bucket a kit: the shared kit's buckets count once for
    # both schedulers, each own kit once more
    shared_seen = {(e.name, s) for e in vars(kit).values()
                   if hasattr(e, "_seen") for s in e._seen}
    own_seen = [{(e.name, s) for e in vars(o.kit).values()
                 if hasattr(e, "_seen") for s in e._seen} for o in own]
    assert shared_seen == own_seen[0] | own_seen[1]
    for fn, shape in shared_seen:
        assert metrics.solver_recompiles.value(
            {"fn": fn, "shape": shape}) == 1 + sum(
                (fn, shape) in s for s in own_seen)


def test_rounds_through_the_kit_bind_as_jax():
    from koordinator_tpu import metrics as jmetrics
    from koordinator_tpu.scheduler.scheduler import Scheduler as JSched
    from koordinator_tpu.scheduler.snapshot import ClusterSnapshot as JSnap

    from koordinator_tpu_torch import metrics

    jsched = JSched(JSnap(capacity=64), batch_solver_threshold=32,
                    mesh="off")
    jsched.incremental_dirty_threshold = 1.0
    tsched = port_scheduler()
    paths = []
    for rnd, (nodes, pods) in enumerate(churn(11)):
        feed(jsched, nodes, pods, "jax")
        feed(tsched, nodes, pods, "torch")
        want = outcome(jsched.schedule_round(), jsched)
        got = outcome(tsched.schedule_round(), tsched)
        assert got == want, f"round {rnd}"
        paths.append(got[2])
        assert np.array_equal(
            np.asarray(jsched.snapshot.state.node_requested),
            tsched.snapshot.state.node_requested.numpy())
    assert paths[0] == "full_cold" and "incremental" in paths
    assert "greedy" in paths
    treport, jreport = tsched.sharding_report(), jsched.sharding_report()
    assert set(treport["recompiles_by_shape"]) == set(
        jreport["recompiles_by_shape"])
    assert set(treport["recompiles_by_shape"].values()) == {1}
    for key in ("explain_counts", "align_candidate_cache",
                "refresh_candidates", "assign_round_pass",
                "select_candidates", "gang_assign", "capacity_slack"):
        assert any(k.startswith(key + "[")
                   for k in treport["recompiles_by_shape"]), key
    for key in ("solver_shard_count", "active", "mesh", "pod_shard_count",
                "shard_min_nodes", "device_bytes_by_shard"):
        assert treport[key] == jreport[key], key
    for m in (metrics, jmetrics):
        assert m.solver_shard_count.value() == 1.0
    assert (metrics.solver_device_bytes.value({"kind": "cluster_state"})
            == jmetrics.solver_device_bytes.value({"kind": "cluster_state"}))
    assert (metrics.solver_device_bytes.value({"kind": "candidate_cache"})
            == jmetrics.solver_device_bytes.value(
                {"kind": "candidate_cache"}))
