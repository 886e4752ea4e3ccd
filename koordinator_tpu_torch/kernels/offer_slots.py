"""K8: the gang offer-slot count of network-topology gang placement.

:func:`offer_slots` is the wrapper: CPU tensors take
:func:`offer_slots_plain`, CUDA tensors launch ``csrc/offer_slots.cu``,
one launch over all the gangs given.  Gang g's request matrix is
``koordinator_tpu/ops/network_topology.py`` ``gang_offer_slots``'
front-packed (P, R) matrix: its member rows ``requests[offsets[g]:
offsets[g + 1]]`` in order, then zero rows up to ``p_rows``.  The count on
node n is the number of leading rows whose cumulative request fits the
node's free capacity and, with a config, whose cumulative band-translated
usage estimate passes ``_threshold_mask``; 0 where ``node_valid[g, n]`` is
false.

The plain version is JAX's algebra in PyTorch: the matrix built, its
int32 (wrapping) cumulative sums, the tests one dimension at a time over
chunks of nodes, and the first failing row as the count (JAX's cumprod
and sum).  The kernel reads only the member rows: the zero rows' sums are
the members' total and, for the estimate, k estimates of a zero request
more, so it tests them from registers (see the source's header).
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops import scoring
from koordinator_tpu_torch.ops.filtering import MAX_SCALE
from koordinator_tpu_torch.ops.preemption import wrap32
from koordinator_tpu_torch.state.cluster_state import ClusterState

#: (nodes x rows) elements the plain version holds in one intermediate
#: when no chunk is given
PLAIN_CHUNK_ELEMENTS = 1 << 24

#: the kernel's nodes a CTA and member rows a stage
#: (csrc/offer_slots.cu kNodesPerCta, kRowsPerStage)
NODES_PER_CTA = 128
ROWS_PER_STAGE = 128

#: the most gangs one launch takes (grid.y)
MAX_GANGS = 65_535


def gang_matrix(requests: torch.Tensor, offsets, g: int, p_rows: int
                ) -> torch.Tensor:
    """Gang g's front-packed (p_rows, R) request matrix."""
    lo, hi = int(offsets[g]), int(offsets[g + 1])
    mat = torch.zeros((p_rows, requests.shape[1]), dtype=torch.int32,
                      device=requests.device)
    mat[: hi - lo] = requests[lo:hi]
    return mat


def _thresholds(state: ClusterState, cfg):
    """_threshold_mask's policy: (usage, thresholds), the aggregated
    ones when any aggregated threshold is set."""
    if bool(torch.any(cfg.agg_usage_thresholds > 0)):
        return state.node_agg_usage, cfg.agg_usage_thresholds
    return state.node_usage, cfg.usage_thresholds


def _offsets_list(offsets) -> list[int]:
    return [int(v) for v in (offsets.tolist() if torch.is_tensor(offsets)
                             else offsets)]


def offer_slots_plain(state: ClusterState, requests: torch.Tensor, offsets,
                      p_rows: int, node_valid: torch.Tensor, cfg=None,
                      chunk: int | None = None) -> torch.Tensor:
    """(G, N) int32: JAX's ``gang_offer_slots`` for each gang, over node
    chunks of ``chunk`` rows (enough to keep (chunk, P) at
    :data:`PLAIN_CHUNK_ELEMENTS` when None)."""
    n = state.capacity
    offs = _offsets_list(offsets)
    g_count = node_valid.shape[0]
    dev = node_valid.device
    step = (max(1, PLAIN_CHUNK_ELEMENTS // max(p_rows, 1)) if chunk is None
            else max(1, chunk))
    free = state.node_allocatable - state.node_requested       # (N, R)
    out = torch.zeros((g_count, n), dtype=torch.int32, device=dev)
    if p_rows == 0:
        return out
    if cfg is not None:
        usage, thresholds = _thresholds(state, cfg)
        total = state.node_allocatable
        limit = (thresholds + 1) * total
        half = total // 2
        thr_dims = [d for d, t in enumerate(thresholds.tolist()) if t > 0]
    for g in range(g_count):
        mat = gang_matrix(requests, offs, g, p_rows)
        cum = wrap32(torch.cumsum(mat.to(torch.int64), dim=0))
        if cfg is not None:
            est = scoring.estimate_pod_usage_by_band(
                mat, cfg.estimator_factors, cfg.estimator_defaults)
            cum_est = wrap32(torch.cumsum(est.to(torch.int64), dim=0))
        for a in range(0, n, step):
            b = min(a + step, n)
            fits = torch.ones((b - a, p_rows), dtype=torch.bool, device=dev)
            for d in range(NUM_RESOURCE_DIMS):
                fits &= cum[None, :, d] <= free[a:b, None, d]
            if cfg is not None:
                for d in thr_dims:
                    x = (MAX_SCALE * (usage[a:b, None, d]
                                      + cum_est[None, :, d])
                         + half[a:b, None, d])
                    fits &= ~((total[a:b, None, d] > 0)
                              & (x >= limit[a:b, None, d]))
            fail = ~fits
            first = torch.where(fail.any(dim=1),
                                fail.to(torch.uint8).argmax(dim=1), p_rows)
            out[g, a:b] = torch.where(node_valid[g, a:b], first, 0).to(
                torch.int32)
    return out


def offer_slots_mirror(state: ClusterState, requests: torch.Tensor, offsets,
                       p_rows: int, node_valid: torch.Tensor, cfg=None
                       ) -> torch.Tensor:
    """(G, N) int32: the kernel's walk in PyTorch, for the CPU tests.  The
    member rows' running sums, then the rows past the members from the
    members' totals alone: the request's constant, the estimate's growing
    by a zero request's estimate a row (``wmul(k, z)``), the walk ending
    at once for a node none of whose thresholded terms grows."""
    n, r = state.capacity, NUM_RESOURCE_DIMS
    offs = _offsets_list(offsets)
    dev = node_valid.device
    free = state.node_allocatable - state.node_requested
    out = torch.zeros((node_valid.shape[0], n), dtype=torch.int32, device=dev)
    if cfg is not None:
        usage, thresholds = _thresholds(state, cfg)
        a = state.node_allocatable
        thx = wrap32(MAX_SCALE * usage.to(torch.int64) + (a >> 1))
        thy = wrap32((thresholds.to(torch.int64) + 1) * a)
        thr_on = (thresholds > 0)[None, :] & (a > 0)            # (N, R)
        z = scoring.estimate_pod_usage_by_band(
            torch.zeros((1, r), dtype=torch.int32, device=dev),
            cfg.estimator_factors, cfg.estimator_defaults)[0].to(torch.int64)
    for g in range(node_valid.shape[0]):
        rows = requests[offs[g]:offs[g + 1]]
        m = rows.shape[0]
        cum = wrap32(torch.cumsum(rows.to(torch.int64), dim=0))
        carry = cum[-1] if m else torch.zeros(r, dtype=torch.int32,
                                               device=dev)
        fits = torch.all(cum[None, :, :] <= free[:, None, :], dim=-1)
        if cfg is not None:
            est = scoring.estimate_pod_usage_by_band(
                rows, cfg.estimator_factors, cfg.estimator_defaults)
            cum_e = wrap32(torch.cumsum(est.to(torch.int64), dim=0))
            ce = cum_e[-1].to(torch.int64) if m else torch.zeros(
                r, dtype=torch.int64, device=dev)
            x = wrap32(thx[:, None, :].to(torch.int64)
                       + MAX_SCALE * cum_e[None, :, :].to(torch.int64))
            fits &= ~torch.any(thr_on[:, None, :] & (x >= thy[:, None, :]),
                               dim=-1)
        # a column of passes ahead of the member rows keeps argmax
        # defined with no member row
        fail = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                          ~fits], dim=1)
        failed = fail.any(dim=1)
        alive = node_valid[g] & ~failed
        res = torch.where(failed, fail.to(torch.uint8).argmax(dim=1) - 1, 0)
        if m < p_rows:
            tail_fit = torch.all(carry[None, :] <= free, dim=1)
            res = torch.where(alive & ~tail_fit, m, res)
            walking = alive & tail_fit
            res = torch.where(walking, p_rows, res)
            if cfg is not None:
                vary = torch.any(thr_on & (z != 0)[None, :], dim=1)
                for k in range(1, p_rows - m + 1):
                    if not bool(walking.any()):
                        break
                    e = wrap32(ce + wrap32(torch.tensor(k) * z))
                    x = wrap32(thx.to(torch.int64) + MAX_SCALE * e[None, :])
                    bad = torch.any(thr_on & (x >= thy), dim=1)
                    res = torch.where(walking & bad, m + k - 1, res)
                    walking = walking & ~bad & vary
        else:
            res = torch.where(alive, p_rows, res)
        out[g] = torch.where(node_valid[g], res, 0).to(torch.int32)
    return out


def offer_slots(state: ClusterState, requests: torch.Tensor, offsets,
                p_rows: int, node_valid: torch.Tensor, cfg=None
                ) -> torch.Tensor:
    """K8's wrapper; see :func:`offer_slots_plain`.  ``requests`` (S, R)
    int32 member rows, ``offsets`` (G + 1,) their row offsets a gang (a
    host sequence, or a tensor read back to check it), ``node_valid``
    (G, N) bool."""
    g_count = node_valid.shape[0]
    # the kernel reads requests[offsets[g]:offsets[g + 1]] unchecked
    offs = _offsets_list(offsets)
    sizes = [b - a for a, b in zip(offs, offs[1:])]
    if (len(offs) != g_count + 1 or (offs and offs[0] != 0)
            or any(m < 0 or m > p_rows for m in sizes)
            or (offs and offs[-1] > requests.shape[0])):
        raise ValueError("offer_slots: offsets must rise from 0 by at most "
                         f"{p_rows} rows a gang within the {requests.shape[0]}"
                         " member rows")
    if build.on_cpu(state.node_allocatable, requests, node_valid):
        return offer_slots_plain(state, requests, offs, p_rows, node_valid,
                                 cfg)
    n, r = state.capacity, NUM_RESOURCE_DIMS
    dev = node_valid.device
    if not 0 <= g_count <= MAX_GANGS:
        raise ValueError(f"offer_slots: {g_count} gangs, at most {MAX_GANGS}")
    offsets = torch.tensor(offs, dtype=torch.int32).to(dev)
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(requests, "requests", torch.int32, (None, r))
    build.expect(node_valid, "node_valid", torch.bool, (g_count, n))
    build.expect(offsets, "offsets", torch.int32, (g_count + 1,))
    slots = torch.empty((g_count, n), dtype=torch.int32, device=dev)
    if g_count == 0 or n == 0:
        return slots
    est = zero_est = cfgv = None
    base = state.node_usage
    cfg_len = 0
    if cfg is not None:
        est = scoring.estimate_pod_usage_by_band(
            requests, cfg.estimator_factors,
            cfg.estimator_defaults).contiguous()
        zero_est = scoring.estimate_pod_usage_by_band(
            torch.zeros((1, r), dtype=torch.int32, device=dev),
            cfg.estimator_factors, cfg.estimator_defaults).reshape(r)
        cfgv, agg_enabled = _config_vector(cfg)
        cfg_len = cfgv.numel()
        if agg_enabled:
            base = state.node_agg_usage
    err = build.lib().koord_offer_slots(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(base), n, build.ptr(requests), build.ptr(est),
        build.ptr(offsets), g_count, p_rows, build.ptr(node_valid),
        build.ptr(zero_est), build.ptr(cfgv), cfg_len, build.ptr(slots),
        build.stream_of(slots))
    build.check(err, "offer_slots")
    build.LAUNCHES["offer_slots"] += 1
    return slots
