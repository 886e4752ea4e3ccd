"""Parity of the port's Scheduler with network topology gangs, NUMA cpusets
and GPU device share against the JAX ``Scheduler(mesh="off")``, round by
round.

A ``PlacementTwin`` (the preemption suite's twin: binds in order, failures
field by field, pending, node accounting, bound records, quota, nominations,
evictions) gives each scheduler its own ``topology_tree``, ``cpu_manager``
and ``device_manager`` and compares, after every round and every delete,
eviction and restore: ``resource_status``, every CPU manager's reference
counts, allocations and orphans, and every device type's tensors, rows,
records and annotations.

The scenarios mirror tests/test_scheduler.py's topology gang cases
(:190-260) and fine-grained allocator cases (:691-870), the device-plugin
gate (its wall-clock stamps masked), and seeded multi-round clusters on a
spine/block/node tree with topology gangs gathering at the block and spine
layers (one with a node-layer multiple), LSR pods taking whole cores and
GPU pods whole and shared, through the batch path (``full_gang``) and the
greedy one, with deletes between rounds; then a fresh twin restored from
the bound pods' ``resource_status`` through ``add_bound_pod``, whose
managers must equal the live ones.
"""

import numpy as np
import pytest

from tests.test_torch_scheduler_preemption import PreemptTwin
from tests.torch_parity import CPU, MEM, R, set_torch_threads

set_torch_threads()

GPU, GPU_MEM = 3, 4
LSR, LS = 3, 2


def vec(cpu=0, mem=0, gpu=0, gpu_mem=0):
    v = np.zeros(R, np.int32)
    v[CPU], v[MEM], v[GPU], v[GPU_MEM] = cpu, mem, gpu, gpu_mem
    return v


def node(name, cpu=16_000, mem=65_536, gpu=0, gpu_mem=0, usage_cpu=0,
         labels=None):
    usage = np.zeros(R, np.int32)
    usage[CPU] = usage_cpu
    return dict(name=name, allocatable=vec(cpu, mem, gpu, gpu_mem),
                usage=usage, labels=labels or {})


def pod(name, cpu=1_000, mem=1_024, gpu=0, gpu_mem=0, **kw):
    return dict(name=name, requests=vec(cpu, mem, gpu, gpu_mem), **kw)


def gpu_devices(n_gpus=8, mem=81_920, group_size=4):
    return [{"core": 100, "memory": mem, "group": j // group_size}
            for j in range(n_gpus)]


def cpu_state(m) -> dict:
    return {
        "nodes": {name: (st.ref_count.tolist(), st.max_ref,
                         {k: (v.cpus, v.exclusive_policy)
                          for k, v in st.allocations.items()})
                  for name, st in m._nodes.items()},
        "orphans": {n: {k: v.cpus for k, v in o.items()}
                    for n, o in m._orphans.items()},
    }


def device_state(m) -> dict:
    from koordinator_tpu_torch.convert import fields_of

    return {
        "state": {t: {f: v.tolist() for f, v in
                      fields_of(st, "DeviceState").items()}
                  for t, st in m._state.items()},
        "rows": m._node_rows,
        "allocs": {k: [(a.device_type, a.minors, a.core, a.memory)
                       for a in v] for k, v in m._allocs.items()},
    }


TIME_KEYS = ("scheduling.koordinator.sh/bind-timestamp", "predicate-time",
             "cambricon.com/dsmlu.lock", "hami.io/mutex.lock")


def masked(status: dict) -> dict:
    """``resource_status`` with the device-plugin adapter's wall-clock
    UnixNano stamps masked."""
    out = {}
    for pod_name, s in status.items():
        s = dict(s)
        dp = s.get("device-plugin")
        if dp is not None and "annotations" in dp:
            dp = {k: ({a: ("<t>" if a in TIME_KEYS else b)
                       for a, b in v.items()} if isinstance(v, dict) else v)
                  for k, v in dp.items()}
            s["device-plugin"] = dp
        out[pod_name] = s
    return out


class PlacementTwin(PreemptTwin):
    """Both schedulers with their own topology tree, CPU manager and
    device manager, and all of their state in the comparison."""

    def __init__(self, nodes, tree_paths=None, cpu_topos=None, gpus=None,
                 config=None, **kw):
        kw.setdefault("enable_preemption", False)
        super().__init__(nodes, **kw)
        if config is not None:
            from tests.torch_parity import port

            self.j.config = config
            self.p.config = port(config, "ScoringConfig")
        if tree_paths is not None:
            from koordinator_tpu.ops.network_topology import TopologyTree as JT

            from koordinator_tpu_torch.ops.network_topology import (
                TopologyTree as TT,
            )

            jt, tt = JT(tree_paths[0]), TT(tree_paths[0])
            for path in tree_paths[1]:
                jt.add_node(path)
                tt.add_node(path)
            cap = self.j.snapshot.state.capacity
            self.j.topology_tree = jt.build(capacity=cap)
            self.p.topology_tree = tt.build(capacity=cap, device="cpu")
        self.cpu_topos, self.gpus = cpu_topos, gpus
        self.j.cpu_manager, self.p.cpu_manager = self.managers()[0]
        self.j.device_manager, self.p.device_manager = self.managers()[1]

    def managers(self):
        """((JAX, port) CPU managers, (JAX, port) device managers), fresh,
        with the twin's topologies and GPUs registered."""
        from koordinator_tpu.ops.numa import CPUTopology as JTopo
        from koordinator_tpu.scheduler.cpu_manager import CPUManager as JC
        from koordinator_tpu.scheduler.device_manager import (
            DeviceManager as JD,
        )

        from koordinator_tpu_torch.ops.numa import CPUTopology as TTopo
        from koordinator_tpu_torch.scheduler.cpu_manager import CPUManager
        from koordinator_tpu_torch.scheduler.device_manager import (
            DeviceManager,
        )

        jc, tc = JC(), CPUManager(device="cpu")
        for name, args in (self.cpu_topos or {}).items():
            jc.register_node(name, JTopo.uniform(**args))
            tc.register_node(name, TTopo.uniform(**args, device="cpu"))
        jd, td = JD(), DeviceManager(device="cpu")
        if self.gpus:
            names = sorted(self.gpus)
            for m in (jd, td):
                m.register("gpu", names, [self.gpus[n] for n in names])
        return (jc, tc), (jd, td)

    def gang(self, name, min_member, topology=None):
        from koordinator_tpu.ops.network_topology import (
            TopologyRequirements as JR,
        )
        from koordinator_tpu.scheduler.scheduler import GangRecord as JG

        from koordinator_tpu_torch.ops.network_topology import (
            TopologyRequirements as TR,
        )
        from koordinator_tpu_torch.scheduler.scheduler import GangRecord

        for cls, req, s in ((JG, JR, self.j), (GangRecord, TR, self.p)):
            s.register_gang(cls(name=name, min_member=min_member,
                                topology=None if topology is None
                                else req(**topology)))

    def add_bound(self, name, node_name, requests, resource_status=None,
                  priority=0, qos=0):
        from koordinator_tpu.scheduler.scheduler import BoundPod as JB

        from koordinator_tpu_torch.scheduler.scheduler import BoundPod
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec

        gen = self.j.snapshot.node_generation.get(node_name, 0)
        self.j.add_bound_pod(JB(name=name, node=node_name, requests=requests,
                                priority=priority, node_generation=gen),
                             resource_status=resource_status)
        self.p.add_bound_pod(BoundPod(PodSpec(name=name, requests=requests,
                                              priority=priority, qos=qos),
                                      node_name, gen),
                             resource_status=resource_status)
        self.check_fine_grained()

    def delete(self, *names):
        for name in names:
            self.both("delete_pod", name)
        self.check_fine_grained()

    def check(self, jr, tr):
        super().check(jr, tr)
        self.check_fine_grained()

    def check_fine_grained(self):
        j, p = self.j, self.p
        assert masked(p.resource_status) == masked(j.resource_status)
        assert cpu_state(p.cpu_manager) == cpu_state(j.cpu_manager)
        assert device_state(p.device_manager) == device_state(
            j.device_manager)
        assert ({n: {k: "<t>" for k in v}
                 for n, v in p._device_node_locks.items()}
                == {n: {k: "<t>" for k in v}
                    for n, v in j._device_node_locks.items()})


def block_tree(n_blocks=2, per_block=2):
    paths = [[f"b{i // per_block}", f"n{i}"]
             for i in range(n_blocks * per_block)]
    return (["block", "node"], paths)


# -- tests/test_scheduler.py:190-260, topology gangs ---------------------------


def test_topology_gang_gathers_in_one_block():
    tw = PlacementTwin([node(f"n{i}", cpu=8_000) for i in range(4)],
                       tree_paths=block_tree())
    tw.gang("g", 2, dict(desired_slots=2, must_gather_layer=1))
    tw.enqueue(*[pod(f"g{i}", cpu=8_000, gang="g") for i in range(2)])
    res = tw.round()
    assert sorted(res.assignments.values()) in (["n0", "n1"], ["n2", "n3"])
    assert tw.p.last_topology_parts_s["gangs"] == 1


def test_topology_gang_infeasible_backs_off():
    tw = PlacementTwin([node(f"n{i}", cpu=8_000) for i in range(4)],
                       tree_paths=block_tree())
    tw.gang("g", 3, dict(desired_slots=3, must_gather_layer=1))
    tw.enqueue(*[pod(f"g{i}", cpu=8_000, gang="g") for i in range(3)])
    assert not tw.round().assignments


def test_topology_gang_surplus_members_not_invalidated():
    tw = PlacementTwin([node(f"n{i}", cpu=8_000) for i in range(4)],
                       tree_paths=block_tree())
    tw.gang("g", 2, dict(desired_slots=2, must_gather_layer=1))
    tw.enqueue(*[pod(f"g{i}", cpu=4_000, gang="g") for i in range(3)])
    assert len(tw.round().assignments) == 3


def test_register_gang_accepts_topology_requirements():
    from koordinator_tpu_torch.ops.network_topology import TopologyRequirements
    from koordinator_tpu_torch.scheduler.scheduler import GangRecord

    tw = PlacementTwin([node("n0")], tree_paths=block_tree(1, 1))
    rec = GangRecord(name="g", min_member=1,
                     topology=TopologyRequirements(desired_slots=1))
    tw.p.register_gang(rec)
    assert tw.p.gangs["g"].topology.desired_slots == 1


# -- tests/test_scheduler.py:691-870, the fine-grained allocators -------------


TOPO_2NUMA = dict(sockets=1, numa_per_socket=2, cores_per_numa=4)
GPU_N1 = node("n1", gpu=400, gpu_mem=81_920 * 4)


def test_lsr_pod_gets_exclusive_cpuset_at_bind():
    tw = PlacementTwin([node("n1")], cpu_topos={"n1": TOPO_2NUMA},
                       gpus={"n1": gpu_devices(4)})
    tw.enqueue(pod("lsr-1", cpu=4_000, qos=LSR), pod("ls-1", cpu=4_000,
                                                     qos=LS))
    tw.round()
    status = tw.p.resource_status["lsr-1"]["resource-status"]
    assert len(status["cpuset"].split(",")) == 4
    assert "ls-1" not in tw.p.resource_status
    tw.delete("lsr-1")
    assert tw.p.cpu_manager.node("n1").ref_count.sum() == 0


def test_gpu_pod_gets_device_allocation_at_bind():
    tw = PlacementTwin([GPU_N1], cpu_topos={"n1": TOPO_2NUMA},
                       gpus={"n1": gpu_devices(4)})
    tw.enqueue(pod("gpu-1", gpu=200, gpu_mem=16_384))
    tw.round()
    assert len(tw.p.resource_status["gpu-1"]["device-allocated"]["gpu"]) == 2
    tw.delete("gpu-1")


@pytest.mark.parametrize("victim", ["lsr", "gpu"])
def test_preemption_releases_victim_fine_grained_allocs(victim):
    tw = PlacementTwin([node("n1", cpu=8_000, gpu=400, gpu_mem=4 * 81_920)],
                       cpu_topos={"n1": TOPO_2NUMA},
                       gpus={"n1": gpu_devices(4)}, enable_preemption=True)
    if victim == "lsr":
        tw.enqueue(pod("low", cpu=6_000, qos=LSR, priority=3_000))
    else:
        tw.enqueue(pod("low", cpu=6_000, gpu=400, priority=3_000))
    tw.round()
    assert "low" in tw.p.resource_status
    tw.enqueue(pod("prod-high", cpu=6_000, gpu=300 if victim == "gpu" else 0,
                   priority=9_500))
    tw.round()   # PostFilter: evict the low pod, nominate
    assert "low" not in tw.p.bound and "low" not in tw.p.resource_status
    assert tw.p.cpu_manager.node("n1").ref_count.sum() == 0
    assert not tw.p.device_manager._allocs
    tw.round()   # the nomination binds, and takes its own minors
    assert ("prod-high" in tw.p.resource_status) == (victim == "gpu")


def test_restart_replay_restores_pinned_cpus_and_minors():
    tw = PlacementTwin([GPU_N1], cpu_topos={"n1": TOPO_2NUMA},
                       gpus={"n1": gpu_devices(4)})
    tw.add_bound("old-lsr", "n1", vec(4_000, 1_024),
                 {"resource-status": {"cpuset": "0,1,2,3"}}, priority=9_000)
    tw.add_bound("old-gpu", "n1", vec(1_000, 1_024), {"device-allocated": {
        "gpu": [{"minor": 0, "resources": {"core": 100, "memory": 81_920}},
                {"minor": 1, "resources": {"core": 100, "memory": 81_920}}]}},
        priority=9_000)
    tw.enqueue(pod("new-lsr", cpu=4_000, qos=LSR),
               pod("new-gpu", gpu=300))
    tw.round()
    assert not set(tw.p.cpu_manager.node("n1").allocations["new-lsr"].cpus
                   ) & {0, 1, 2, 3}
    # minors 0-1 held: the 3-device ask binds unpinned (degrade, not fail)
    assert "new-gpu" in tw.p.bound and "new-gpu" not in tw.p.resource_status
    tw.both("remove_bound_pod", "old-gpu")
    tw.delete("new-gpu")
    tw.enqueue(pod("gpu-3", gpu=300))
    tw.round()
    assert len(tw.p.resource_status["gpu-3"]["device-allocated"]["gpu"]) == 3


def test_restore_rejects_malformed_and_stale_annotations():
    tw = PlacementTwin([GPU_N1], cpu_topos={"n1": TOPO_2NUMA},
                       gpus={"n1": gpu_devices(4)})
    tw.add_bound("ranged", "n1", vec(2_000, 512),
                 {"resource-status": {"cpuset": "0-1"}})
    tw.add_bound("stale", "n1", vec(2_000, 512), {
        "resource-status": {"cpuset": "500-501"},
        "device-allocated": {"gpu": [{"minor": 99}], "fpga": [{"minor": 0}]}})
    tw.add_bound("junk", "n1", vec(1_000, 512), {
        "resource-status": {"cpuset": "0-4000000000"},
        "device-allocated": "nonsense"})
    assert "stale" not in tw.p.resource_status
    grant = {"device-allocated": {"gpu": [
        {"minor": 0, "resources": {"core": 100, "memory": 81_920}}]}}
    for _ in range(2):
        tw.add_bound("gpu-replay", "n1", vec(1_000, 512), grant)
    tw.both("remove_bound_pod", "gpu-replay")
    tw.check_fine_grained()


def test_koordlet_nrt_annotation_registers_topology():
    from koordinator_tpu.koordlet.nodetopo import NodeTopology, NUMAZone
    from koordinator_tpu.koordlet.system import procfs
    from koordinator_tpu.scheduler.cpu_manager import (
        register_node_from_annotations as jreg,
    )

    from koordinator_tpu_torch.scheduler.cpu_manager import (
        register_node_from_annotations,
    )

    cpus = tuple(procfs.CPUInfo(cpu=i, core=i // 2, socket=0, node=i // 4)
                 for i in range(8))
    ann = NodeTopology(
        zones=(NUMAZone("node0", 4_000, 1 << 30, (0, 1, 2, 3)),
               NUMAZone("node1", 4_000, 1 << 30, (4, 5, 6, 7))),
        cpu_topology=cpus).to_annotations()
    tw = PlacementTwin([node("n1")])
    assert jreg(tw.j.cpu_manager, "n1", ann)
    assert register_node_from_annotations(tw.p.cpu_manager, "n1", ann)
    tw.enqueue(pod("lsr-1", cpu=2_000, qos=LSR))
    tw.round()
    assert len(tw.p.resource_status["lsr-1"]["resource-status"][
        "cpuset"].split(",")) == 2


def test_device_plugin_gate_on_bind_path():
    from koordinator_tpu.features import SCHEDULER_GATES as JG

    from koordinator_tpu_torch.features import SCHEDULER_GATES as TG

    tw = PlacementTwin(
        [dict(node("n1", gpu=800, gpu_mem=8_192),
              labels={"node.koordinator.sh/gpu-vendor": "cambricon"})],
        gpus={"n1": [{"core": 100, "memory": 4_096, "group": 0},
                     {"core": 100, "memory": 4_096, "group": 0}]})
    old = (JG.enabled("DevicePluginAdaption"),
           TG.enabled("DevicePluginAdaption"))
    try:
        JG.set("DevicePluginAdaption", True)
        TG.set("DevicePluginAdaption", True)
        tw.enqueue(pod("g1", gpu=50, gpu_mem=1_024),
                   pod("g2", gpu=200, gpu_mem=2_048))
        tw.round()
        assert "device-plugin" in tw.p.resource_status["g1"]
        # the node lock is held: a third pod's adaptation errors
        tw.enqueue(pod("g3", gpu=25, gpu_mem=512))
        tw.round()
        tw.both("clear_device_node_lock", "n1", "cambricon.com/dsmlu.lock")
        tw.check_fine_grained()
    finally:
        JG.set("DevicePluginAdaption", old[0])
        TG.set("DevicePluginAdaption", old[1])


# -- seeded rounds: topology gangs, cpusets and GPUs together -----------------


def cluster_spec(seed, spines=2, blocks=3, per_block=4):
    rng = np.random.default_rng(seed)
    n = spines * blocks * per_block
    nodes, paths, topos, gpus = [], [], {}, {}
    for i in range(n):
        s, b = i // (blocks * per_block), (i // per_block) % blocks
        name = f"n{i}"
        is_gpu = i % 5 == 0
        cpu = int(rng.choice([16_000, 24_000, 32_000]))
        nodes.append(node(name, cpu=cpu, mem=131_072,
                          gpu=800 if is_gpu else 0,
                          gpu_mem=8 * 81_920 if is_gpu else 0,
                          usage_cpu=int(rng.integers(0, cpu // 3))))
        paths.append([f"s{s}", f"b{s}.{b}", name])
        topos[name] = dict(sockets=1, numa_per_socket=2,
                           cores_per_numa=cpu // 4_000, threads_per_core=2)
        if is_gpu:
            gpus[name] = gpu_devices(8)
    return nodes, (["spine", "block", "node"], paths), topos, gpus


def arrivals(rng, start, count, gangs=()):
    out = []
    for i in range(start, start + count):
        kind = rng.random()
        if kind < 0.25:
            out.append(pod(f"lsr{i}", cpu=int(rng.integers(1, 5)) * 1_000,
                           qos=LSR, priority=int(rng.integers(0, 5_000))))
        elif kind < 0.4:
            whole = rng.random() < 0.5
            out.append(pod(f"gpu{i}", cpu=1_000,
                           gpu=int(rng.choice([100, 200])) if whole
                           else int(rng.integers(25, 51)),
                           gpu_mem=0 if whole else 4_096,
                           priority=int(rng.integers(0, 5_000))))
        else:
            out.append(pod(f"p{i}", cpu=int(rng.integers(200, 3_000)),
                           priority=int(rng.integers(0, 5_000))))
    for name, size, cpu in gangs:
        out += [pod(f"{name}-{k}", cpu=cpu, gang=name, priority=6_000)
                for k in range(size)]
    return out


@pytest.mark.parametrize("threshold", [16, 1024], ids=["batch", "greedy"])
@pytest.mark.parametrize("seed", range(2))
def test_seeded_rounds_then_restore(seed, threshold):
    from tests.torch_parity import config

    rng = np.random.default_rng(seed)
    nodes, paths, topos, gpus = cluster_spec(seed)
    kw = dict(tree_paths=paths, cpu_topos=topos, gpus=gpus,
              config=config("default"), capacity=32,
              batch_solver_threshold=threshold)
    tw = PlacementTwin(nodes, **kw)
    tw.gang("blk", 4, dict(desired_slots=4, must_gather_layer=2))
    tw.gang("blk2", 4, dict(desired_slots=4, must_gather_layer=2,
                            layer_multiples=(1, 1, 1, 2)))
    tw.gang("spn", 6, dict(desired_slots=6, must_gather_layer=1))
    tw.gang("wide", 3, dict(desired_slots=0, must_gather_layer=2))
    tw.enqueue(*arrivals(rng, 0, 30, [("blk", 4, 6_000), ("blk2", 4, 5_000),
                                      ("spn", 6, 8_000),
                                      ("wide", 5, 30_000)]))
    res = tw.round()
    assert res.assignments
    if threshold == 16:
        assert tw.p.last_solve_path == "full_gang"
        assert tw.p.last_topology_parts_s["gangs"] == 4
    # deletes of a quarter of the bound LSR and GPU pods, then arrivals
    fine = sorted(n for n in tw.p.bound if n.startswith(("lsr", "gpu")))
    tw.delete(*fine[: len(fine) // 4])
    tw.gang("late", 3, dict(desired_slots=3, must_gather_layer=2))
    tw.enqueue(*arrivals(rng, 100, 12, [("late", 3, 4_000)]))
    tw.round()
    # a fresh twin restored from the bound pods' resource_status
    fresh = PlacementTwin(nodes, **kw)
    for name in sorted(tw.p.bound):
        bp = tw.p.bound[name]
        fresh.add_bound(name, bp.node, bp.requests,
                        tw.p.resource_status.get(name), priority=bp.priority,
                        qos=bp.pod.qos)
    assert cpu_state(fresh.p.cpu_manager) == cpu_state(tw.p.cpu_manager)
    # a restore keeps a record a minor (a live grant keeps one a call):
    # the device tensors, rows and annotations are the state that counts
    for m in (fresh.p.device_manager, tw.p.device_manager):
        assert {k: v for k, v in device_state(m).items() if k != "allocs"} \
            == {k: v for k, v in device_state(tw.p.device_manager).items()
                if k != "allocs"}
        assert ({(p, n): m.device_allocated_annotation(n, p)
                 for p, n in tw.p.device_manager._allocs}
                == {(p, n): tw.p.device_manager.device_allocated_annotation(
                    n, p) for p, n in tw.p.device_manager._allocs})
    assert fresh.p.resource_status == tw.p.resource_status
    fresh.enqueue(*arrivals(rng, 200, 12))
    fresh.round()
