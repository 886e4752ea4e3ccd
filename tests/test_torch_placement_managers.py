"""Parity of the port's fine-grained allocators (``koordinator_tpu_torch/
scheduler/cpu_manager.py``, ``device_manager.py`` and
``device_plugin_adapter.py``) with the JAX package's, bit for bit.

A twin drives the JAX manager and the port's with the same seeded sequence
of operations (registrations and re-registrations, allocations under every
bind policy, strategy and exclusivity, restores with stale and malformed
annotations, releases, node removals and flaps, inventory churn) and
compares every return value and, after each operation, the whole state:
reference counts, allocation records, orphans, device tensors, node rows,
annotation payloads.  The vendor device-plugin adapter runs on both under a
fixed clock (its annotations are wall-clock UnixNano stamps), every
vendor's dialect and error.
"""

import json

import numpy as np
import pytest

from tests.torch_parity import set_torch_threads

set_torch_threads()


def topo_pair(rng, kind: int):
    """(JAX CPUTopology, port CPUTopology) of one of three layouts."""
    from koordinator_tpu.ops.numa import CPUTopology as J

    from koordinator_tpu_torch.ops.numa import CPUTopology as T

    args = [dict(sockets=1, numa_per_socket=2, cores_per_numa=4),
            dict(sockets=2, numa_per_socket=1, cores_per_numa=3),
            dict(sockets=1, numa_per_socket=2, cores_per_numa=2,
                 threads_per_core=1)][kind]
    return J.uniform(**args), T.uniform(**args, device="cpu")


class CPUTwin:
    def __init__(self):
        from koordinator_tpu.scheduler.cpu_manager import CPUManager as J

        from koordinator_tpu_torch.scheduler.cpu_manager import CPUManager

        self.j, self.p = J(), CPUManager(device="cpu")

    def call(self, method, *args, **kw):
        a = getattr(self.j, method)(*args, **kw)
        b = getattr(self.p, method)(*args, **kw)
        assert a == b, (method, args, kw, a, b)
        self.check()
        return b

    def register(self, name, pair, max_ref=1):
        self.j.register_node(name, pair[0], max_ref=max_ref)
        self.p.register_node(name, pair[1], max_ref=max_ref)
        self.check()

    def check(self):
        assert sorted(self.j._nodes) == sorted(self.p._nodes)
        for name, js in self.j._nodes.items():
            ts = self.p._nodes[name]
            assert np.array_equal(js.ref_count, ts.ref_count), name
            assert js.max_ref == ts.max_ref
            assert ({k: (v.cpus, v.exclusive_policy)
                     for k, v in js.allocations.items()}
                    == {k: (v.cpus, v.exclusive_policy)
                        for k, v in ts.allocations.items()})
            for pod in js.allocations:
                assert (self.j.resource_status(name, pod)
                        == self.p.resource_status(name, pod))
        assert ({n: {k: v.cpus for k, v in o.items()}
                 for n, o in self.j._orphans.items()}
                == {n: {k: v.cpus for k, v in o.items()}
                    for n, o in self.p._orphans.items()})


@pytest.mark.parametrize("seed", range(4))
def test_cpu_manager_sequences(seed):
    rng = np.random.default_rng(seed)
    tw = CPUTwin()
    nodes = ["n0", "n1", "n2"]
    pairs = {n: topo_pair(rng, int(rng.integers(0, 3))) for n in nodes}
    for n in nodes:
        tw.register(n, pairs[n], max_ref=int(rng.choice([1, 1, 2])))
    pods = [f"p{i}" for i in range(10)]
    for _ in range(60):
        op = rng.random()
        node = str(rng.choice(nodes + ["ghost"]))
        pod = str(rng.choice(pods))
        if op < 0.5:
            tw.call("allocate", node, pod, int(rng.integers(0, 9)),
                    bind_policy=int(rng.integers(0, 3)),
                    strategy=int(rng.integers(0, 2)),
                    exclusive_policy=int(rng.integers(0, 3)))
        elif op < 0.65:
            tw.call("release", node, pod)
        elif op < 0.75:
            cpus = sorted({int(c) for c in rng.integers(-1, 18,
                                                        rng.integers(0, 4))})
            tw.call("restore", node, pod, cpus,
                    exclusive_policy=int(rng.integers(0, 3)))
        elif op < 0.85 and node != "ghost":
            tw.call("remove_node", node)
        elif node != "ghost":
            # a heartbeat (same topology) or a changed one
            if rng.random() < 0.5:
                pairs[node] = topo_pair(rng, int(rng.integers(0, 3)))
            tw.register(node, pairs[node], max_ref=int(rng.choice([1, 2])))


def test_cpu_manager_reference_cases():
    """tests/test_numa.py's manager cases on both packages."""
    rng = np.random.default_rng(0)
    tw = CPUTwin()
    tw.register("n0", topo_pair(rng, 0))
    a = tw.call("allocate", "n0", "pod-a", 4, bind_policy=1,
                exclusive_policy=1)
    b = tw.call("allocate", "n0", "pod-b", 4, bind_policy=1,
                exclusive_policy=1)
    assert a and b and not set(a) & set(b)
    assert tw.call("allocate", "n0", "pod-c", 10) is None
    tw.call("release", "n0", "pod-a")
    assert len(tw.call("allocate", "n0", "pod-c", 10)) == 10
    assert tw.call("allocate", "n0", "pod-c", 100) is None   # old kept
    tw.call("allocate", "n0", "pod-d", 2, exclusive_policy=2)
    tw.call("remove_node", "n0")
    tw.register("n0", topo_pair(rng, 0))       # orphans restored
    tw.call("clear")


def test_cpuset_parsing_and_annotation_registration():
    from koordinator_tpu.scheduler import cpu_manager as jc

    from koordinator_tpu_torch.scheduler import cpu_manager as tc

    for s in ("0-3,8", " 1, 2 ,5-6", "", "7", "3-1", "0-4000000000", "x",
              "0-1023", "0-1024"):
        try:
            want = jc.parse_cpuset_bounded(s)
        except ValueError:
            with pytest.raises(ValueError):
                tc.parse_cpuset_bounded(s)
            continue
        assert tc.parse_cpuset_bounded(s) == want
    detail = [{"cpu": i, "core": i // 2, "socket": 0, "node": i // 4}
              for i in range(8)]
    anns = [{"node.koordinator.sh/cpu-topology": json.dumps(
                {"detail": detail})},
            {"node.koordinator.sh/cpu-topology": json.dumps({"detail": []})},
            {"node.koordinator.sh/cpu-topology": "{not json"},
            {"node.koordinator.sh/cpu-topology": json.dumps(
                {"detail": [{"cpu": 0}]})},
            {}]
    for ann in anns:
        jm, tm = jc.CPUManager(), tc.CPUManager(device="cpu")
        assert (jc.register_node_from_annotations(jm, "n", ann)
                == tc.register_node_from_annotations(tm, "n", ann))
        assert (jm.node("n") is None) == (tm.node("n") is None)
        if jm.node("n") is not None:
            for f in ("core_of", "numa_of", "socket_of", "valid"):
                assert np.array_equal(np.asarray(getattr(
                    jm.node("n").topology, f)),
                    getattr(tm.node("n").topology, f).numpy())


def gpu_node(n_gpus=8, mem=81_920, group_size=4, healthy=True):
    return [{"core": 100, "memory": mem, "group": j // group_size,
             "healthy": healthy} for j in range(n_gpus)]


class DeviceTwin:
    def __init__(self):
        from koordinator_tpu.scheduler.device_manager import DeviceManager as J

        from koordinator_tpu_torch.scheduler.device_manager import (
            DeviceManager,
        )

        self.j, self.p = J(), DeviceManager(device="cpu")

    def call(self, method, *args, **kw):
        a = getattr(self.j, method)(*args, **kw)
        b = getattr(self.p, method)(*args, **kw)
        assert a == b, (method, args, a, b)
        self.check()
        return b

    def check(self):
        from koordinator_tpu_torch.convert import fields_of

        j, p = self.j, self.p
        assert sorted(j._state) == sorted(p._state)
        for t, js in j._state.items():
            want = fields_of(js, "DeviceState")
            got = fields_of(p._state[t], "DeviceState")
            for f, v in want.items():
                assert np.array_equal(v, got[f]), (t, f)
        assert j._node_rows == p._node_rows
        assert j._raw == p._raw
        assert ({k: [(a.device_type, a.minors, a.core, a.memory) for a in v]
                 for k, v in j._allocs.items()}
                == {k: [(a.device_type, a.minors, a.core, a.memory)
                        for a in v] for k, v in p._allocs.items()})
        for pod, node in j._allocs:
            assert (j.device_allocated_annotation(node, pod)
                    == p.device_allocated_annotation(node, pod))


@pytest.mark.parametrize("seed", range(4))
def test_device_manager_sequences(seed):
    rng = np.random.default_rng(seed)
    tw = DeviceTwin()
    nodes = ["n0", "n1", "n2"]
    tw.call("register", "gpu", nodes[:2],
            [gpu_node(8), gpu_node(4, group_size=2)])
    tw.call("register", "rdma", ["n1", "n0"],
            [[{"core": 100, "group": 0}], [{"core": 100, "group": 1}]])
    pods = [f"p{i}" for i in range(8)]
    for _ in range(50):
        op = rng.random()
        node = str(rng.choice(nodes + ["ghost"]))
        pod = str(rng.choice(pods))
        dtype = str(rng.choice(["gpu", "gpu", "rdma", "fpga"]))
        if op < 0.45:
            core = int(rng.choice([25, 50, 100, 200, 300, 800, 350]))
            tw.call("allocate", dtype, node, pod, core,
                    memory=int(rng.choice([0, 4_096, 40_960])),
                    strategy=int(rng.integers(0, 2)))
        elif op < 0.6:
            tw.call("release", node, pod)
        elif op < 0.7:
            grants = [{"minor": int(rng.integers(-1, 10)),
                       "resources": {"core": int(rng.choice([50, 100])),
                                     "memory": 1_024}}
                      for _ in range(int(rng.integers(0, 3)))]
            grants.append({"minor": "bad"})
            tw.call("restore", node, pod, {dtype: grants, "x": "y"})
        elif op < 0.8 and node != "ghost":
            tw.call("register_node_devices", "gpu", node,
                    gpu_node(int(rng.choice([2, 4, 8])),
                             group_size=int(rng.choice([2, 4]))))
        elif op < 0.9 and node != "ghost":
            tw.call("deregister_node_devices", str(rng.choice(["gpu",
                                                               "rdma"])),
                    node)
        else:
            tw.call("remove_node", node)
        assert (tw.j.registered_types_for(node)
                == tw.p.registered_types_for(node))


def test_device_manager_reference_cases():
    """tests/test_deviceshare.py's manager cases on both packages."""
    tw = DeviceTwin()
    tw.call("register", "gpu", ["n0", "n1"], [gpu_node(4), gpu_node(4)])
    assert len(tw.call("allocate", "gpu", "n0", "pod-a", 200,
                       memory=16_384)) == 2
    assert tw.call("allocate", "gpu", "n0", "pod-b", 300) is None
    tw.call("allocate", "gpu", "n0", "pod-a", 200)       # re-allocate
    assert tw.call("allocate", "gpu", "n0", "pod-a", 800) is None
    tw.call("release", "n0", "pod-a")
    assert tw.call("allocate", "gpu", "n0", "pod-b", 300) is not None
    tw.call("register_node_devices", "gpu", "n0", gpu_node(2))   # shrink
    tw.call("register_node_devices", "gpu", "n0", gpu_node(4))   # regrow
    tw.call("clear")


ADAPT_CASES = [
    ({"gpu": [{"minor": 1, "resources": {"core": 100, "memory": 1_024}},
              {"minor": 3, "resources": {"core": 100, "memory": 1_024}}]},
     "", "", {}),
    ({"gpu": [{"minor": 2, "resources": {"core": 100, "memory": 1_024}}]},
     "huawei", "", {}),
    ({"gpu": [{"minor": 2, "template": "vir04",
               "resources": {"core": 50, "memory": 1_024}}]},
     "huawei", "", {}),
    ({"gpu": [{"minor": 0, "resources": {"core": 100, "memory": 0}},
              {"minor": 1, "resources": {"core": 100, "memory": 0}}]},
     "huawei", "Ascend-310P3-300I-DUO", {}),
    ({"gpu": [{"minor": 1, "resources": {"core": 50, "memory": 2_048}}]},
     "cambricon", "", {}),
    ({"gpu": [{"minor": 1, "resources": {"core": 50, "memory": 100}}]},
     "cambricon", "", {}),
    ({"gpu": [{"minor": 1, "resources": {"memory": 2_048}}]},
     "cambricon", "", {}),
    ({"gpu": [{"minor": 0, "resources": {}}, {"minor": 1, "resources": {}}]},
     "cambricon", "", {}),
    ({"gpu": [{"minor": 1, "resources": {"core": 50, "memory": 2_048}}]},
     "cambricon", "", {"cambricon.com/dsmlu.lock": str(int(90e9))}),
    ({"gpu": [{"minor": 1, "resources": {"core": 50, "memory": 2_048}}]},
     "cambricon", "", {"cambricon.com/dsmlu.lock": "junk"}),
    ({"gpu": [{"minor": 0, "id": "uuid-0",
               "resources": {"core": 25, "memory": 512}}]},
     "metax", "", {}),
    ({"gpu": [{"minor": 0, "resources": {"core": 25, "memory": 0}}]},
     "metax", "", {}),
    ({"gpu": [{"minor": 0, "resources": {"core": 25, "memory": 512}}]},
     "metax", "", {"hami.io/mutex.lock": str(int(10e9))}),
    ({"rdma": [{"minor": 0}]}, "huawei", "", {}),
]


@pytest.mark.parametrize("case", range(len(ADAPT_CASES)))
def test_device_plugin_adapter(case):
    from koordinator_tpu.scheduler import device_plugin_adapter as jd

    from koordinator_tpu_torch.scheduler import device_plugin_adapter as td

    alloc, vendor, model, locks = ADAPT_CASES[case]
    labels = {td.LABEL_GPU_ISOLATION_PROVIDER: td.ISOLATION_PROVIDER_HAMI_CORE}
    out = []
    for mod in (jd, td):
        try:
            res = mod.adapt_for_device_plugin(
                alloc, gpu_vendor=vendor, gpu_model=model, pod_labels=labels,
                node_annotations=dict(locks), clock=lambda: 100.0)
            out.append(("ok", res.pod_annotations, res.pod_labels,
                        res.node_annotations))
        except mod.AdaptError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]
