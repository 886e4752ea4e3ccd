"""K8, the gang offer-slot count (``koordinator_tpu_torch/kernels/
offer_slots.py``), on the CPU: its plain version and the kernel's mirror
(``offer_slots_mirror``: the member rows' running sums, then the zero rows
from the members' totals alone) against the JAX package's
``gang_offer_slots`` on each gang's front-packed matrix, bit for bit
(int32: exact equality, no tolerance).  The CUDA kernel itself runs only on
the card (``chip_smoke.py`` ``phase_offer_slots_edges`` holds it against
the plain version on the same edges).

The edges: thresholds off (no config, and a config with no threshold),
thresholds running past the members into the zero rows, a node that fits
nothing, ``node_valid`` false, a negative request, P = 16 and P = 65,536,
the aggregated thresholds, a gang with no member row, several gangs in one
call, and node chunks of the plain version down to one node.  The kernel's
tiling constants are read from its source.
"""

import os
import re

import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, MEM, R, port, set_torch_threads

set_torch_threads()

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "koordinator_tpu_torch", "kernels", "csrc", "offer_slots.cu")


def node_state(seed: int, n: int = 12, tight: bool = False):
    """A JAX ClusterState of ``n`` nodes: cpu 4,000-32,000 and memory
    8,192-65,536, usage and requests up to half of it; ``tight`` makes
    node 0 fit nothing (its requested over its allocatable) and node 1 a
    node at the cpu threshold's edge."""
    from koordinator_tpu.state.cluster_state import ClusterState

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, R), np.int32)
    alloc[:, CPU] = rng.integers(4_000, 32_000, n)
    alloc[:, MEM] = rng.integers(8_192, 65_536, n)
    usage = (alloc * rng.random((n, R)) * 0.5).astype(np.int32)
    agg = (alloc * rng.random((n, R)) * 0.6).astype(np.int32)
    requested = (alloc * rng.random((n, R)) * 0.5).astype(np.int32)
    if tight:
        requested[0] = alloc[0] + 1
        alloc[1, CPU] = 10_000
        usage[1, CPU] = 6_300
    return ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                    agg_usage=agg, capacity=n)


def gang_rows(seed: int, m: int, negative: bool = False):
    rng = np.random.default_rng(seed + 100)
    req = np.zeros((m, R), np.int32)
    req[:, CPU] = rng.integers(0, 3_000, m)
    req[:, MEM] = rng.integers(0, 4_096, m)
    req[rng.random(m) < 0.2, CPU] = 0        # the estimator's default
    if negative and m:
        req[rng.integers(0, m), CPU] = -2_000
        req[rng.integers(0, m), MEM] = -70_000
    return req


def configs():
    """(JAX config or None, label) of the threshold regimes."""
    import jax.numpy as jnp

    from tests.torch_parity import config

    base = config("default")
    return [(None, "no_config"),
            (base.replace(usage_thresholds=jnp.zeros(R, jnp.int32)),
             "thresholds_off"),
            (base, "instantaneous"), (config("agg"), "aggregated"),
            (base.replace(estimator_defaults=jnp.zeros(R, jnp.int32)),
             "zero_defaults")]


def jax_slots(state, rows, p_rows, node_valid, cfg):
    import jax.numpy as jnp

    from koordinator_tpu.ops.network_topology import gang_offer_slots

    mat = np.zeros((p_rows, R), np.int32)
    mat[: len(rows)] = rows
    return np.asarray(gang_offer_slots(state, jnp.asarray(mat),
                                       jnp.asarray(node_valid), cfg))


def both(state, gangs, p_rows, valid, cfg):
    """(JAX (G, N), plain (G, N), mirror (G, N)) for ``gangs`` (a list of
    (M_g, R) member rows) in one call of each port function."""
    from koordinator_tpu_torch.kernels import offer_slots as k8

    want = np.stack([jax_slots(state, rows, p_rows, valid[g], cfg)
                     for g, rows in enumerate(gangs)])
    tstate = port(state, "ClusterState")
    tcfg = None if cfg is None else port(cfg, "ScoringConfig")
    reqs = torch.from_numpy(np.concatenate(gangs).astype(np.int32)
                            if gangs else np.zeros((0, R), np.int32))
    offsets = np.concatenate([[0], np.cumsum([len(g) for g in gangs])])
    tv = torch.from_numpy(np.asarray(valid))
    plain = k8.offer_slots(tstate, reqs, offsets.tolist(), p_rows, tv, tcfg)
    mirror = k8.offer_slots_mirror(tstate, reqs, offsets.tolist(), p_rows,
                                   tv, tcfg)
    return want, plain.numpy(), mirror.numpy()


@pytest.mark.parametrize("p_rows", [16, 64, 1_024])
@pytest.mark.parametrize("seed", range(2))
def test_regimes(seed, p_rows):
    state = node_state(seed, tight=True)
    rng = np.random.default_rng(seed)
    gangs = [gang_rows(seed + g, int(rng.integers(0, min(p_rows, 12) + 1)),
                       negative=(g == 2)) for g in range(4)]
    valid = rng.random((len(gangs), state.capacity)) < 0.85
    valid[:, 1] = True
    for cfg, label in configs():
        want, plain, mirror = both(state, gangs, p_rows, valid, cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        if cfg is not None and label == "instantaneous":
            # the zero rows' estimates carry some counts past the members
            sizes = np.array([len(g) for g in gangs])[:, None]
            assert ((want > sizes) & (want < p_rows)).any()


def test_edges():
    """A node that fits nothing, node_valid false, a negative request
    walking back under the free capacity past a failed row, a gang with no
    member row, and a gang filling all P rows."""
    state = node_state(7, tight=True)
    n = state.capacity
    req = gang_rows(7, 16, negative=True)
    req[3, CPU] = 40_000           # fails every node; the next row is -
    req[4, CPU] = -40_000          # negative, so the sums fit again
    valid = np.ones((4, n), bool)
    valid[1, ::2] = False
    gangs = [req[:6], req[:16], np.zeros((0, R), np.int32), req[6:16]]
    for cfg, label in configs():
        want, plain, mirror = both(state, gangs, 16, valid, cfg)
        assert np.array_equal(want, plain), label
        assert np.array_equal(want, mirror), label
        assert (want[:, 0] == 0).all() and (want[1, ::2] == 0).all()


def test_p_65536_and_chunks():
    """P = 65,536 (the flagship's batch rows) over a few nodes, the plain
    version at chunks of 1 and 3 nodes too."""
    from koordinator_tpu_torch.kernels import offer_slots as k8

    state = node_state(3, n=4)
    rows = gang_rows(3, 24)
    rows[8:] = 0                   # the first 8 fit some nodes
    valid = np.ones((1, 4), bool)
    for cfg, label in configs()[1:3]:
        want, plain, mirror = both(state, [rows], 65_536, valid, cfg)
        assert np.array_equal(want, plain) and np.array_equal(want, mirror), (
            label)
        tcfg = port(cfg, "ScoringConfig")
        for chunk in (1, 3):
            got = k8.offer_slots_plain(port(state, "ClusterState"),
                                       torch.from_numpy(rows), [0, 24],
                                       65_536, torch.from_numpy(valid), tcfg,
                                       chunk=chunk)
            assert np.array_equal(want, got.numpy()), (label, chunk)
        if label == "thresholds_off":
            # a node either stops among the members or takes all 65,536
            assert ((want < 24) | (want == 65_536)).all()
            assert (want == 65_536).any()


def test_kernel_constants_from_source():
    from koordinator_tpu_torch.kernels import offer_slots as k8

    src = open(SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kNodesPerCta") == k8.NODES_PER_CTA
    assert const("kRowsPerStage") == k8.ROWS_PER_STAGE
    # a warp scans a stage at four rows a lane
    assert k8.ROWS_PER_STAGE == 4 * 32
    assert "koord_offer_slots" in src


def test_wrapper_takes_plain_version_on_cpu_only():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels import offer_slots as k8

    state = port(node_state(1), "ClusterState")
    before = build.LAUNCHES["offer_slots"]
    rows = torch.from_numpy(gang_rows(1, 5))
    valid = torch.ones((1, state.capacity), dtype=torch.bool)
    got = k8.offer_slots(state, rows, [0, 5], 32, valid)
    assert torch.equal(got, k8.offer_slots_plain(state, rows, [0, 5], 32,
                                                 valid))
    assert build.LAUNCHES["offer_slots"] == before
    # offsets the kernel could not read safely are refused on either path
    for offs, p_rows in (([0, 6], 32), ([0, 3, 2], 32), ([1, 5], 32),
                         ([0, 5], 4), ([0, 5, 5], 32)):
        with pytest.raises(ValueError, match="offsets"):
            k8.offer_slots(state, rows, offs, p_rows, valid)
