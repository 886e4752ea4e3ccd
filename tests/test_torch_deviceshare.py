"""Parity of the port's device-share ops (``koordinator_tpu_torch/ops/
deviceshare.py``) with the JAX package's, bit for bit (every output is
int32 or bool: exact equality, no tolerance).

Seeded device states (whole and partly allocated devices, unhealthy ones,
topology groups including ids past the device capacity and negative ones)
and requests (shared, whole, over-asking) go through both packages:
``device_fit``, ``device_score`` under both strategies, ``allocate_on_node``
with and without a preferred group, its commit and release,
``joint_allocate`` with the NIC required or not, and
``partition_allocate``.  The traps: the group crowding's segment sum over
``clip(groups, 0)`` (ids past the capacity dropped, their gathers clamped),
the INT32_MAX key of groups that cannot satisfy the request, and the choice
between the whole-device and shared paths.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import port, same, set_torch_threads

set_torch_threads()


def states(seed: int, nodes: int = 6):
    """(JAX DeviceState, its port) of a seeded cluster."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.deviceshare import DeviceState

    rng = np.random.default_rng(seed)
    per_node = []
    for _ in range(nodes):
        n = int(rng.integers(0, 9))
        group_size = int(rng.choice([1, 2, 4]))
        devs = []
        for j in range(n):
            d = {"core": 100, "memory": int(rng.choice([16_384, 81_920])),
                 "group": j // group_size, "healthy": bool(rng.random() > 0.1)}
            if rng.random() < 0.1:
                d["group"] = int(rng.choice([-1, 9, 40]))
            devs.append(d)
        per_node.append(devs)
    dev = DeviceState.build(per_node)
    # partly allocate some devices
    free = np.array(dev.free)
    used = rng.random(free.shape[:2]) < 0.3
    free[used, 0] -= rng.integers(1, 101, int(used.sum()))
    free[used, 1] -= rng.integers(0, 8_192, int(used.sum()))
    dev = dev.replace(free=jnp.asarray(free))
    return dev, port(dev, "DeviceState")


REQUESTS = [(0, 25, 4_096), (0, 50, 0), (0, 100, 81_920), (1, 100, 0),
            (2, 100, 40_960), (3, 100, 0), (4, 100, 81_920), (0, 0, 0),
            (5, 100, 1)]


@pytest.mark.parametrize("seed", range(3))
def test_fit_and_score(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import deviceshare as jd

    from koordinator_tpu_torch.ops import deviceshare as td

    jdev, tdev = states(seed)
    for n_whole, core, mem in REQUESTS:
        args_j = (jnp.int32(n_whole), jnp.int32(core), jnp.int32(mem))
        assert same(jd.device_fit(jdev, *args_j),
                    td.device_fit(tdev, n_whole, core, mem))
        for strategy in (jd.DEV_BINPACK, jd.DEV_SPREAD):
            assert same(jd.device_score(jdev, *args_j, strategy=strategy),
                        td.device_score(tdev, n_whole, core, mem,
                                        strategy=strategy))


@pytest.mark.parametrize("seed", range(4))
def test_allocate_commit_release(seed):
    import jax.numpy as jnp

    from koordinator_tpu.ops import deviceshare as jd

    from koordinator_tpu_torch.convert import fields_of
    from koordinator_tpu_torch.ops import deviceshare as td

    jdev, tdev = states(seed + 10)
    nodes = jdev.shape[0]
    for node in range(min(nodes, 6)):
        for n_whole, core, mem in REQUESTS:
            for strategy in (jd.DEV_BINPACK, jd.DEV_SPREAD):
                for pg in (None, -1, 0, 1):
                    js, jok = jd.allocate_on_node(
                        jdev, jnp.int32(node), jnp.int32(n_whole),
                        jnp.int32(core), jnp.int32(mem), strategy=strategy,
                        prefer_group=None if pg is None else jnp.int32(pg))
                    ts, tok = td.allocate_on_node(
                        tdev, node, n_whole, core, mem, strategy=strategy,
                        prefer_group=pg)
                    assert same(js, ts) and same(jok, tok), (
                        node, n_whole, core, mem, strategy, pg)
            # commit, then release, the binpack choice
            js, _ = jd.allocate_on_node(jdev, jnp.int32(node),
                                        jnp.int32(n_whole), jnp.int32(core),
                                        jnp.int32(mem))
            ts, _ = td.allocate_on_node(tdev, node, n_whole, core, mem)
            jdev = jd.commit_allocation(jdev, jnp.int32(node), js,
                                        jnp.int32(core), jnp.int32(mem))
            tdev = td.commit_allocation(tdev, node, ts, core, mem)
            assert np.array_equal(fields_of(jdev, "DeviceState")["free"],
                                  tdev.free.numpy())
        back_j = jd.release_allocation(jdev, jnp.int32(node), js,
                                       jnp.int32(5), jnp.int32(7))
        back_t = td.release_allocation(tdev, node, ts, 5, 7)
        assert np.array_equal(np.asarray(back_j.free), back_t.free.numpy())


@pytest.mark.parametrize("required", [False, True])
def test_joint_allocate(required):
    import jax.numpy as jnp

    from koordinator_tpu.ops import deviceshare as jd

    from koordinator_tpu_torch.ops import deviceshare as td

    jgpu, tgpu = states(21)
    jnic, tnic = states(22)
    for node in range(min(jgpu.shape[0], jnic.shape[0])):
        for n_whole, core, mem in REQUESTS[:7]:
            for nic_core in (0, 50, 100):
                jo = jd.joint_allocate(
                    jgpu, jnic, jnp.int32(node), jnp.int32(n_whole),
                    jnp.int32(core), jnp.int32(mem), jnp.int32(nic_core),
                    jnp.int32(0), nic_required=required)
                to = td.joint_allocate(tgpu, tnic, node, n_whole, core, mem,
                                       nic_core, 0, nic_required=required)
                for a, b in zip(jo, to):
                    assert same(a, b), (node, n_whole, core, nic_core)


def test_partition_allocate_and_split_request():
    import jax.numpy as jnp

    from koordinator_tpu.ops import deviceshare as jd

    from koordinator_tpu_torch.ops import deviceshare as td

    rng = np.random.default_rng(5)
    jdev, tdev = states(30)
    d = jdev.shape[1]
    for node in range(jdev.shape[0]):
        t = rng.random((5, d)) < 0.4
        t[0, :4] = True
        for n in range(0, 6):
            js, jok = jd.partition_allocate(jdev, jnp.int32(node),
                                            jnp.asarray(t), jnp.int32(n))
            ts, tok = td.partition_allocate(tdev, node, torch.from_numpy(t), n)
            assert same(js, ts) and same(jok, tok), (node, n)
    for core in (0, 1, 50, 99, 100, 101, 200, 350, 800):
        for mem in (0, 1, 1_000, 81_920):
            assert jd.split_request(core, mem) == td.split_request(core, mem)
