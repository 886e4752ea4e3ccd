"""K8: the gang offer-slot count of network-topology gang placement.

:func:`offer_slots` is the wrapper: CPU tensors take
:func:`offer_slots_plain`, CUDA tensors launch ``csrc/offer_slots.cu``,
one scan and one walk over all the gangs given.  Gang g's request matrix is
``koordinator_tpu/ops/network_topology.py`` ``gang_offer_slots``'
front-packed (P, R) matrix: its member rows in order, then zero rows up to
``p_rows``.  The count on node n is the number of leading rows whose
cumulative request fits the node's free capacity and, with a config,
whose cumulative band-translated usage estimate passes
``_threshold_mask``; 0 where the gang's node validity is false.

Two modes name the members and the validity:
- the member mode (``rows`` and ``feasible``): gang g's members are
  ``requests[rows[offsets[g]:offsets[g + 1]]]`` and its validity is
  ``gang_candidate_prep``'s, the state's ``node_valid`` and every member's
  row of the (P, N) ``feasible`` mask;
- the explicit mode (``node_valid``): its members are
  ``requests[offsets[g]:offsets[g + 1]]`` and its validity
  ``node_valid[g]`` (G, N).

The plain version is JAX's algebra in PyTorch, one gang at a time: the
validity as ``gang_candidate_prep`` folds it, the matrix built, its int32
(wrapping) cumulative sums, the tests one dimension at a time over chunks
of nodes, and the first failing row as the count (JAX's cumprod and sum).
The kernel scans each gang's member rows once, then walks tiles of nodes
over slices of the gangs; the zero rows' sums are the members' total and,
for the estimate, k estimates of a zero request more, so it tests them
from registers (see the source's header).  :func:`offer_slots_mirror` is
that scan and walk in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS, ResourceDim
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops import scoring
from koordinator_tpu_torch.ops.filtering import MAX_SCALE
from koordinator_tpu_torch.ops.preemption import wrap32
from koordinator_tpu_torch.state.cluster_state import ClusterState

#: (nodes x rows) elements the plain version holds in one intermediate
#: when no chunk is given
PLAIN_CHUNK_ELEMENTS = 1 << 24

#: the walk's nodes a CTA and cumulative rows a stage, and a cumulative
#: row's ints (csrc/offer_slots.cu kNodesPerCta, kRowsPerStage, kRowInts)
NODES_PER_CTA = 128
ROWS_PER_STAGE = 64
ROW_INTS = 24

#: the first bit of the estimate's live dimensions in a gang's live mask
#: (csrc/offer_slots.cu kLiveEst)
LIVE_EST = 16


def offer_grid(g_count: int, n: int, resident: int) -> tuple[int, int]:
    """(node tiles, gangs a CTA walks): tiles of NODES_PER_CTA nodes, and
    the gangs cut into as many slices as ``resident`` CTAs hold beside the
    tiles, one gang a slice at least; the walk's grid is tiles x slices."""
    tiles = -(-n // NODES_PER_CTA)
    slices = max(1, min(g_count, resident // max(tiles, 1)))
    return tiles, -(-g_count // slices)


def gang_matrix(requests: torch.Tensor, offsets, g: int, p_rows: int,
                rows=None) -> torch.Tensor:
    """Gang g's front-packed (p_rows, R) request matrix."""
    lo, hi = int(offsets[g]), int(offsets[g + 1])
    mat = torch.zeros((p_rows, requests.shape[1]), dtype=torch.int32,
                      device=requests.device)
    if rows is None:
        mat[: hi - lo] = requests[lo:hi]
    else:
        mat[: hi - lo] = requests[_index(rows[lo:hi], requests.device)]
    return mat


def _index(rows, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.int64)).to(device)


def _thresholds(state: ClusterState, cfg):
    """_threshold_mask's policy: (usage, thresholds), the aggregated
    ones when any aggregated threshold is set."""
    if bool(torch.any(cfg.agg_usage_thresholds > 0)):
        return state.node_agg_usage, cfg.agg_usage_thresholds
    return state.node_usage, cfg.usage_thresholds


def _host_csr(requests: torch.Tensor, offsets, p_rows: int, node_valid,
              rows, feasible) -> tuple[np.ndarray, np.ndarray | None]:
    """(offsets, member rows or None) as int64 host arrays, checked: the
    kernel reads every member row and the mask's rows unchecked."""
    if (rows is None) != (feasible is None) or (rows is None) == (
            node_valid is None):
        raise ValueError("offer_slots: give node_valid, or rows with "
                         "feasible")
    offs = np.asarray(offsets.cpu() if torch.is_tensor(offsets) else offsets,
                      np.int64).reshape(-1)
    span = requests.shape[0]
    if rows is not None:
        rows = np.asarray(rows.cpu() if torch.is_tensor(rows) else rows,
                          np.int64).reshape(-1)
        if rows.size and (rows.min() < 0 or rows.max() >= span):
            raise ValueError(f"offer_slots: member rows must index the {span}"
                             " request rows")
        span = rows.size
    sizes = np.diff(offs)
    if (offs.size == 0 or offs[0] != 0 or (sizes < 0).any()
            or (sizes > p_rows).any() or offs[-1] > span
            or (node_valid is not None
                and node_valid.shape[0] != offs.size - 1)):
        raise ValueError("offer_slots: offsets must rise from 0 by at most "
                         f"{p_rows} rows a gang within the {span} member rows,"
                         " one gang a row of node_valid")
    return offs, rows


def _gang_valid(state: ClusterState, g: int, offs, node_valid, rows,
                feasible) -> torch.Tensor:
    """(N,) gang g's node validity as gang_candidate_prep folds it."""
    if rows is None:
        return node_valid[g]
    members = rows[offs[g]:offs[g + 1]]
    if not members.size:
        return state.node_valid
    return state.node_valid & torch.all(
        feasible[_index(members, feasible.device)], dim=0)


def offer_slots_plain(state: ClusterState, requests: torch.Tensor, offsets,
                      p_rows: int, node_valid: torch.Tensor | None = None,
                      cfg=None, chunk: int | None = None, *, rows=None,
                      feasible: torch.Tensor | None = None) -> torch.Tensor:
    """(G, N) int32: JAX's ``gang_offer_slots`` for each gang, with the
    validity ``gang_candidate_prep`` gives it in the member mode, over node
    chunks of ``chunk`` rows (enough to keep (chunk, P) at
    :data:`PLAIN_CHUNK_ELEMENTS` when None)."""
    offs, rows = _host_csr(requests, offsets, p_rows, node_valid, rows,
                           feasible)
    n = state.capacity
    g_count = offs.size - 1
    dev = state.node_allocatable.device
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
        valid = _gang_valid(state, g, offs, node_valid, rows, feasible)
        mat = gang_matrix(requests, offs, g, p_rows, rows)
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
            out[g, a:b] = torch.where(valid[a:b], first, 0).to(torch.int32)
    return out


def band_estimate(requests: torch.Tensor, factors: torch.Tensor,
                  defaults: torch.Tensor) -> torch.Tensor:
    """(.., R) int32: the scan's band estimate of each request row
    (csrc/offer_slots.cu ``band_estimate``): the batch and mid bands summed
    into cpu and memory and zeroed, then (q * factor + 50) // 100 wrapping
    in int32, or the default where q is 0 and the default positive; equal
    to ``scoring.estimate_pod_usage_by_band``."""
    def w(x):
        return wrap32(x).to(torch.int64)

    q = requests.to(torch.int64)
    t = q.clone()
    cpu, mem = ResourceDim.CPU, ResourceDim.MEMORY
    t[..., cpu] = w(q[..., cpu] + q[..., ResourceDim.BATCH_CPU]
                    + q[..., ResourceDim.MID_CPU])
    t[..., mem] = w(q[..., mem] + q[..., ResourceDim.BATCH_MEMORY]
                    + q[..., ResourceDim.MID_MEMORY])
    for d in (ResourceDim.BATCH_CPU, ResourceDim.BATCH_MEMORY,
              ResourceDim.MID_CPU, ResourceDim.MID_MEMORY):
        t[..., d] = 0
    f = factors.to(torch.int64)
    dflt = defaults.to(torch.int64)
    scaled = torch.div(w(w(t * f) + 50), 100, rounding_mode="floor")
    return torch.where((t == 0) & (dflt > 0), dflt, scaled).to(torch.int32)


def offer_scan(requests: torch.Tensor, offs: np.ndarray, rows, cfg
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan launch in PyTorch: ((S, 2R) cumulative rows, (G + 1, 2R)
    totals, (G,) live dimensions), the request's sums then the estimate's
    (zero without a config).  Each gang's member rows gathered in order,
    their running sums wrapping in int32; a gang's totals are its last row
    (zero for a gang with none); row G holds the estimate of a zero
    request.  A gang's live dimensions: bit r when a member requests dim
    r, bit LIVE_EST + r when a member's estimate of it is not 0."""
    r = NUM_RESOURCE_DIMS
    s_count = int(offs[-1])
    dev = requests.device
    rows_in = (requests[_index(rows[:s_count], dev)] if rows is not None
               else requests[:s_count])
    zero = torch.zeros((1, r), dtype=torch.int32, device=dev)
    if cfg is not None:
        est = band_estimate(rows_in, cfg.estimator_factors,
                            cfg.estimator_defaults)
        zero_est = band_estimate(zero, cfg.estimator_factors,
                                 cfg.estimator_defaults)
    else:
        est, zero_est = torch.zeros_like(rows_in), zero
    seq = torch.cat([rows_in, est], dim=1).to(torch.int64)
    run = torch.cat([torch.zeros((1, 2 * r), dtype=torch.int64, device=dev),
                     torch.cumsum(seq, dim=0)])
    lo, hi = torch.from_numpy(offs[:-1]), torch.from_numpy(offs[1:])
    gang = torch.repeat_interleave(torch.arange(lo.numel()), hi - lo)
    cum = wrap32(run[1:] - run[lo][gang.to(dev)])
    totals = torch.cat([wrap32(run[hi] - run[lo]),
                        torch.cat([zero, zero_est], dim=1)])
    seen = torch.zeros((lo.numel(), 2 * r), dtype=torch.int64, device=dev)
    seen.index_add_(0, gang.to(dev), (seq != 0).to(torch.int64))
    shift = torch.cat([torch.arange(r), LIVE_EST + torch.arange(r)]).to(dev)
    live = ((seen > 0).to(torch.int64) << shift).sum(dim=1)
    return cum, totals, live


def offer_slots_mirror(state: ClusterState, requests: torch.Tensor, offsets,
                       p_rows: int, node_valid: torch.Tensor | None = None,
                       cfg=None, *, rows=None,
                       feasible: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """(G, N) int32: the kernel's scan and walk in PyTorch, for the CPU
    tests.  The scan's cumulative rows, totals and live dimensions
    (:func:`offer_scan`); then for each tile of NODES_PER_CTA nodes, its
    node terms, and each gang in turn (the kernel's slices of the gangs
    change only which CTA walks a gang, :func:`offer_grid`): a gang's
    validity (every member's feasible row ANDed, or its row of
    ``node_valid``), its member rows a stage of ROWS_PER_STAGE at a time
    to the first failure (on cpu and memory alone when only
    those are live, the other dimensions' constant tests taken once a
    node), then the rows past the members from the totals alone (the
    request's constant, the estimate's growing by a zero request's
    estimate a row, its first failure in closed form,
    :func:`zero_rows_fail`)."""
    offs, rows = _host_csr(requests, offsets, p_rows, node_valid, rows,
                           feasible)
    n, r = state.capacity, NUM_RESOURCE_DIMS
    g_count = offs.size - 1
    dev = state.node_allocatable.device
    out = torch.zeros((g_count, n), dtype=torch.int32, device=dev)
    cum, totals, live = offer_scan(requests, offs, rows, cfg)
    cum, totals = cum.to(torch.int64), totals.to(torch.int64)
    z = totals[g_count, r:]
    a_all = state.node_allocatable.to(torch.int64)
    thr_mask = 0
    if cfg is not None:
        usage, thresholds = _thresholds(state, cfg)
        thx_all = wrap32(MAX_SCALE * usage.to(torch.int64)
                         + (a_all >> 1)).to(torch.int64)
        thy_all = wrap32((thresholds.to(torch.int64) + 1) * a_all).to(
            torch.int64)
        thr_mask = sum(1 << d for d, v in enumerate(thresholds.tolist())
                       if v > 0)
    for a in range(0, n, NODES_PER_CTA):
        b = min(a + NODES_PER_CTA, n)
        # the tile's node terms; hi_bad: a test past cpu and memory that
        # fails with nothing requested or estimated there
        fr = (a_all[a:b] - state.node_requested[a:b].to(torch.int64))
        fr = wrap32(fr).to(torch.int64)
        hi_bad = torch.any(fr[:, 2:] < 0, dim=1)
        if cfg is not None:
            thx, thy = thx_all[a:b], thy_all[a:b]
            thr_on = (thresholds > 0)[None, :] & (a_all[a:b] > 0)
            hi_bad |= torch.any(thr_on[:, 2:] & (thx[:, 2:] >= thy[:, 2:]),
                                dim=1)
        for g in range(g_count):
            lo, m = int(offs[g]), int(offs[g + 1] - offs[g])
            if rows is None:
                alive = node_valid[g, a:b].clone()
            else:
                alive = state.node_valid[a:b].clone()
                for row in rows[lo:lo + m]:
                    alive &= feasible[int(row), a:b]
            # only cpu and memory vary over the member rows
            g_live = int(live[g])
            two = (g_live & 0xFFFC == 0
                   and (g_live >> LIVE_EST) & thr_mask & ~3 == 0)
            dims = 2 if two else r
            if two and m:
                alive &= ~hi_bad
            res = torch.zeros(b - a, dtype=torch.int64, device=dev)
            for c in range(0, m, ROWS_PER_STAGE):
                stage = cum[lo + c: lo + min(m, c + ROWS_PER_STAGE)]
                ok = torch.all(stage[None, :, :dims]
                               <= fr[:, None, :dims], dim=-1)
                if cfg is not None:
                    x = wrap32(thx[:, None, :dims]
                               + MAX_SCALE * stage[None, :, r:r + dims])
                    ok &= ~torch.any(thr_on[:, None, :dims]
                                     & (x >= thy[:, None, :dims]),
                                     dim=-1)
                failed = alive & ~ok.all(dim=1)
                first = (~ok).to(torch.uint8).argmax(dim=1)
                res = torch.where(failed, c + first, res)
                alive &= ~failed
            # the rows past the members
            if m >= p_rows:
                res = torch.where(alive, p_rows, res)
            else:
                fit = torch.all(totals[g, None, :r] <= fr, dim=1)
                res = torch.where(alive & ~fit, m, res)
                walking = alive & fit
                res = torch.where(walking, p_rows, res)
                if cfg is not None:
                    res = torch.where(walking, m + zero_rows_fail(
                        thx, thy, thr_on, totals[g, r:], z, p_rows - m),
                        res)
            out[g, a:b] = res.to(torch.int32)
    return out


def zero_rows_fail(thx: torch.Tensor, thy: torch.Tensor, thr_on, ce, z,
                   span: int) -> torch.Tensor:
    """(n,) int64: for nodes the members' request fits, how many of the
    ``span`` zero rows past the members pass before the first that fails
    (csrc/offer_slots.cu ``zero_rows_fail``).  The k-th (from 1) fails on
    thresholded dim r when thx + 100 * (ce + k * z) >= thy, wrapping in
    int32: in closed form, 1 + ceil((thy - x(1)) / b) with b = 100 * z, for
    0 < b <= 2^31 - thy (the sums climb without jumping the threshold) and
    thy - x(1) below 2^31; row by row otherwise, as far as the first
    failure found."""
    n, r_dims = thx.shape
    first = torch.full((n,), span + 1, dtype=torch.int64, device=thx.device)
    walk = torch.zeros((n, r_dims), dtype=torch.bool, device=thx.device)
    for r in range(r_dims):
        on = thr_on[:, r]
        x1 = wrap32(thx[:, r] + MAX_SCALE * int(wrap32(int(ce[r])
                                                       + int(z[r])))).to(
            torch.int64)
        b = int(wrap32(MAX_SCALE * int(z[r])))
        fail1 = on & (x1 >= thy[:, r])
        first = torch.where(fail1, 1, first)
        rest = on & ~fail1
        if b < 0:
            walk[:, r] = rest
        elif b > 0:
            jump = (b > 2**31 - thy[:, r]) | (thy[:, r] - x1 > 2**31 - 1)
            walk[:, r] = rest & jump
            k = 1 + torch.div(thy[:, r] - x1 + b - 1, b, rounding_mode="floor")
            first = torch.where(rest & ~jump, torch.minimum(first, k), first)
    k = 2
    while bool((walk.any(dim=1) & (first > k)).any()):
        e = wrap32(ce.to(torch.int64) + wrap32(k * z.to(torch.int64)))
        x = wrap32(thx + MAX_SCALE * e.to(torch.int64)[None, :])
        bad = torch.any(walk & (x >= thy), dim=1) & (first > k)
        first = torch.where(bad, k, first)
        k += 1
    return first - 1


def offer_slots(state: ClusterState, requests: torch.Tensor, offsets,
                p_rows: int, node_valid: torch.Tensor | None = None,
                cfg=None, *, rows=None, feasible: torch.Tensor | None = None
                ) -> torch.Tensor:
    """K8's wrapper; see the module's note for the two modes.
    ``requests`` (S or P, R) int32, ``offsets`` (G + 1,) and ``rows`` (S,)
    on the host (sequences or numpy arrays), ``node_valid`` (G, N) bool,
    ``feasible`` (P, N) bool.  On the card: one copy of the offsets and
    rows to it, a scan and a walk, no copy back."""
    offs, rows = _host_csr(requests, offsets, p_rows, node_valid, rows,
                           feasible)
    if build.on_cpu(state.node_allocatable, requests, node_valid, feasible):
        return offer_slots_plain(state, requests, offs, p_rows, node_valid,
                                 cfg, rows=rows, feasible=feasible)
    n, r = state.capacity, NUM_RESOURCE_DIMS
    g_count = offs.size - 1
    dev = state.node_allocatable.device
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(requests, "requests", torch.int32, (None, r))
    if rows is None:
        build.expect(node_valid, "node_valid", torch.bool, (g_count, n))
        valid = node_valid
    else:
        build.expect(feasible, "feasible", torch.bool,
                     (requests.shape[0], n))
        build.expect(state.node_valid, "node_valid", torch.bool, (n,))
        valid = state.node_valid
    slots = torch.empty((g_count, n), dtype=torch.int32, device=dev)
    if g_count == 0 or n == 0:
        return slots
    host = offs if rows is None else np.concatenate([offs, rows])
    csr = torch.from_numpy(host.astype(np.int32)).to(dev)
    rows_t = None if rows is None else csr[g_count + 1:]
    cum = torch.empty((int(offs[-1]), ROW_INTS), dtype=torch.int32,
                      device=dev)
    totals = torch.empty((g_count + 1, ROW_INTS), dtype=torch.int32,
                         device=dev)
    factors = defaults = cfgv = None
    base = state.node_usage
    cfg_len = 0
    if cfg is not None:
        factors, defaults = cfg.estimator_factors, cfg.estimator_defaults
        build.expect(factors, "estimator_factors", torch.int32, (r,))
        build.expect(defaults, "estimator_defaults", torch.int32, (r,))
        cfgv, agg_enabled = _config_vector(cfg)
        cfg_len = cfgv.numel()
        if agg_enabled:
            base = state.node_agg_usage
    with torch.cuda.device(dev):
        resident = int(build.lib().koord_offer_slots_resident(
            int(cfg is not None)))
    if resident <= 0:
        raise RuntimeError("offer_slots: the walk fits no SM")
    _, gps = offer_grid(g_count, n, resident)
    err = build.lib().koord_offer_slots(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(base), n, build.ptr(requests), build.ptr(rows_t),
        build.ptr(csr), g_count, p_rows, gps, build.ptr(valid),
        build.ptr(feasible), build.ptr(factors), build.ptr(defaults),
        build.ptr(cfgv), cfg_len, build.ptr(cum), build.ptr(totals),
        build.ptr(slots), build.stream_of(slots))
    build.check(err, "offer_slots")
    build.LAUNCHES["offer_slots"] += 2   # the scan, then the walk
    return slots
