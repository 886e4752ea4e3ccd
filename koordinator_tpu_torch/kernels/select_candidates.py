"""K1: fused Filter + Score + stratified top-k candidate selection.

:func:`select_candidates_kernel` is the wrapper: CPU tensors take
:func:`select_candidates_plain`, CUDA tensors launch
``csrc/select_candidates.cu``.  The plain version is the JAX package's exact
candidate stage in PyTorch (``ops/batch_assign.py`` ``score_pods`` ->
``_rank_parts`` -> ``_topk_by_rank``), scored one pod chunk at a time.

The ranking helpers live here, beside the plain version that uses them, and
``ops/batch_assign.py`` re-exports them.  Only the PACKED key regime is
ported: node capacities up to 2**15, where one int32 carries the quantized
score over a rotated node tie-break.  A wider capacity raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    pod_estimates,
    score_pods,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: tie-break field width of the packed ranking key: the node index occupies
#: the low bits, the quantized score the high bits, of one int32
_TB_BITS = 15
_SCORE_CLIP = (1 << 30 - _TB_BITS) - 1

#: node capacities up to this fit the packed single-int32 key
PACKED_NODE_CAPACITY = 1 << _TB_BITS

#: hard node-capacity ceiling of the solver's int32 key arithmetic
MAX_NODE_CAPACITY = 1 << 30

#: per-stratum candidate count the kernel keeps in registers
KERNEL_MAX_PER_STRATUM = 16


def check_node_capacity(n: int) -> None:
    """Raise if a node capacity exceeds the ranking key's ceiling, or needs
    the wide key regime, which the port does not implement."""
    if n > MAX_NODE_CAPACITY:
        raise ValueError(
            f"node capacity {n} exceeds the batched solver's ranking-key "
            f"ceiling of {MAX_NODE_CAPACITY} (= 2**30)")
    if n > PACKED_NODE_CAPACITY:
        raise ValueError(
            f"node capacity {n} needs the wide key regime (capacity > "
            f"2**{_TB_BITS}, a two-key ranking), which is not ported: the "
            "port ranks only in the packed single-int32 regime")


def _rank_parts(scores: torch.Tensor, feasible: torch.Tensor,
                spread_bits: int = 0, rot_id: torch.Tensor | None = None,
                node_ids: torch.Tensor | None = None,
                n_total: int | None = None):
    """(key, tb): the packed ranking key ``(clip(score) >> sb) << 15 | tb``
    (-1 where infeasible) and the per-pod rotated tie-break
    ``(N-1) - ((node - rot_id*7919) mod N)``.  ``rot_id * 7919`` and the
    difference wrap in int32 as in JAX; ``%`` floors.  ``node_ids`` /
    ``n_total`` rank a gathered column subset (the incremental refresh's
    dirty columns) by their global node ids."""
    p, n = scores.shape
    n_total = n if n_total is None else n_total
    check_node_capacity(n_total)
    if rot_id is None:
        rot_id = torch.arange(p, dtype=torch.int32, device=scores.device)
    rot = (rot_id.to(torch.int32) * 7919)[:, None]
    ids = (torch.arange(n, dtype=torch.int32, device=scores.device)
           if node_ids is None else node_ids.to(torch.int32))[None, :]
    tb = (n_total - 1) - ((ids - rot) % n_total)
    q = torch.clamp(scores, 0, _SCORE_CLIP) >> spread_bits
    key = (q << _TB_BITS) | tb
    return torch.where(feasible, key, -1), tb


def _candidate_tb(node: torch.Tensor, rot_id: torch.Tensor,
                  n_total: int) -> torch.Tensor:
    """The (P, k) rotated tie-break of candidate node rows (the same pure
    function of (rot_id, node) that :func:`_rank_parts` packs)."""
    rot = (rot_id.to(torch.int32) * 7919)[:, None]
    return (n_total - 1) - ((node - rot) % n_total)


def _topk_by_rank(key: torch.Tensor, tb: torch.Tensor, k: int,
                  n_total: int):
    """Per-row top-k columns by key, descending, lowest column first among
    equal keys (``lax.top_k``'s order; ``torch.topk`` promises none, so a
    stable descending sort stands in).  Returns (key_sel, col_idx int32)."""
    check_node_capacity(n_total)
    vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def _stratum_splits(k: int, n: int) -> list[int]:
    """Split k as evenly as possible over n strata (first strata get the
    remainder)."""
    base, rem = divmod(k, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _reduce_candidates(scores, feasible, strata, k: int, rot_id=None):
    """(scores, feasible) -> (cand_key, cand_node, cand_score): each
    stratum picks its share of k by its own quantized key; the first
    stratum's key orders every candidate (gathered, so infeasible slots of
    short lists read -1)."""
    n_total = scores.shape[1]
    order_key, order_tb = _rank_parts(scores, feasible, strata[0], rot_id,
                                      n_total=n_total)
    cols = []
    for sb, k_i in zip(strata, _stratum_splits(k, len(strata))):
        if k_i == 0:
            continue
        key, tb = ((order_key, order_tb) if sb == strata[0]
                   else _rank_parts(scores, feasible, sb, rot_id,
                                    n_total=n_total))
        cols.append(_topk_by_rank(key, tb, k_i, n_total)[1])
    cand_cols = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    cols_l = cand_cols.long()
    cand_key = torch.gather(order_key, 1, cols_l)
    raw = torch.gather(torch.clamp(scores, 0, _SCORE_CLIP), 1, cols_l)
    return cand_key, cand_cols, torch.where(cand_key >= 0, raw, -1)


# -- what the kernel computes instead of the plain version's steps ----------
#
# The functions below mirror, in PyTorch, three pieces of arithmetic the CUDA
# kernels (csrc/koord_score.cuh, csrc/select_candidates.cu) do differently
# from the plain version, so the CPU tests can hold each against the JAX
# package: floor division by an invariant divisor without a divide, the node
# recovered from an int32 ranking key, and lax.top_k's -1 slots.


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 value (0 for 0)."""
    out = torch.zeros_like(x)
    for b in range(63):
        out += (x >> b) > 0
    return out


def magic_divisor(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l), int64, for divisors ``d`` in 1..2**31-1: ``l`` is
    ceil(log2 d) and ``m`` = ceil(2**(31+l) / d) < 2**32 (the kernels'
    ``magic_for``)."""
    d = d.to(torch.int64)
    if bool(torch.any(d < 1)):
        raise ValueError("magic divisors are for d >= 1")
    l = _bit_length(d - 1)
    m = ((torch.ones_like(d) << (31 + l)) + d - 1) // d
    return m, l


def magic_floordiv(x: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """floor(x / d) for int32 ``x`` of either sign, from ``d``'s magic
    (the kernels' ``magic_fdiv``).  A negative x is folded to ~x = -x-1 >= 0
    and back: floor(x / d) = ~floor(~x / d).  For 0 <= u < 2**31,
    u * m < 2**63 and (u * m) >> (31 + l) == u // d (Granlund-Montgomery,
    because 0 <= m * d - 2**(31+l) < d <= 2**l)."""
    x = x.to(torch.int64)
    s = torch.where(x < 0, -1, 0)
    u = x ^ s
    q = ((u * m) >> 31) >> l
    return (q ^ s).to(torch.int32)


#: ScarceResourceAvoidance's (n_diff - n_inter) * 100 // n_diff, n_diff in
#: 1..R, as (x * SCARCE_RECIP[n]) >> 20: exact for 0 <= x <= 100 * R
#: because x * (ceil(2**20/n) - 2**20/n) / 2**20 < 1/n there
SCARCE_RECIP = tuple(((1 << 20) + n - 1) // n if n else 0
                     for n in range(NUM_RESOURCE_DIMS + 1))


def scarce_floordiv(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x // n for 0 <= x <= 100 * R and 1 <= n <= R, the kernels' way."""
    recip = torch.tensor(SCARCE_RECIP, dtype=torch.int64)[n.long()]
    return ((x.to(torch.int64) * recip) >> 20).to(torch.int32)


def tie_break_preimages(tb: torch.Tensor, rot_id: torch.Tensor,
                        n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The nodes whose rotated tie-break (:func:`_candidate_tb`) is ``tb``:
    (first, second), second -1 when there is one, first < second.

    ``_candidate_tb`` computes ``(n - rot*7919) mod N`` on the int32-wrapped
    difference.  With R = rot*7919 (wrapped), the difference wraps exactly
    for the nodes n >= 2**31 + R, which exist only when R < N - 2**31; for
    them the result is ``(n - R - 2**32) mod N``.  So a tie-break value has
    one preimage below that boundary, ``(v + R) mod N``, and one at or above
    it, ``(v + R + 2**32) mod N``, each counted only if it lies on its side
    (v = N-1-tb).  Without the wrap the tie-break is a permutation and
    ``first`` is the node; with it two nodes may share a tie-break, unless
    2**32 is a multiple of N."""
    rot = (rot_id.to(torch.int32) * 7919).to(torch.int64)
    v = (n_total - 1) - tb.to(torch.int64)
    boundary = rot + 2**31          # first node whose difference wraps
    n1 = (v + rot) % n_total
    n2 = (v + rot + 2**32) % n_total
    ok1 = n1 < boundary
    ok2 = n2 >= boundary
    first = torch.where(ok1, n1, torch.where(ok2, n2, -1))
    second = torch.where(ok1 & ok2, n2, -1)
    return first.to(torch.int32), second.to(torch.int32)


def topk_from_int32_keys(key: torch.Tensor, k: int, rot_id: torch.Tensor,
                         n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k (key_sel, col_idx) as the kernel forms it: it keeps
    only the best k int32 keys, in descending order, and a count f of the
    row's feasible columns, and recovers the columns afterwards.

    - Slot j < f holds a feasible key v; its column is the preimage of v's
      tie-break (:func:`tie_break_preimages`) whose own key is v.  When two
      preimages carry the same key (the wrapped tie-break), the kernel's
      insertion keeps them in column order, so the first copy of v takes
      the lower column and a second copy the higher: lax.top_k's order.
    - Slot j >= f is a -1 slot: lax.top_k fills those with the row's
      infeasible columns in ascending order, so slot j takes the
      (j - f)-th infeasible column.  They lie among the first k columns.
    Equals ``_topk_by_rank`` in the packed regime."""
    p, n = key.shape
    k = min(k, n)
    vals = torch.sort(key, dim=1, descending=True, stable=True).values[:, :k]
    f = (key >= 0).sum(dim=1, keepdim=True)
    j = torch.arange(k, device=key.device)[None, :]
    first, second = tie_break_preimages(vals & ((1 << _TB_BITS) - 1),
                                        rot_id[:, None].expand(p, k),
                                        n_total)
    key_first = torch.gather(key, 1, first.clamp(min=0).long())
    dup = torch.zeros_like(vals, dtype=torch.bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    node = torch.where(dup | (key_first != vals), second, first)
    infeasible_first = torch.sort((key >= 0).to(torch.int8), dim=1,
                                  stable=True).indices[:, :k]
    fill = torch.gather(infeasible_first, 1, (j - f).clamp(min=0))
    cols = torch.where(j < f, node, fill.to(torch.int32))
    return torch.where(j < f, vals, -1), cols.to(torch.int32)


def _pod_rows(pods: PodBatch, start: int, stop: int) -> PodBatch:
    def cut(a):
        return None if a is None else a[start:stop]

    return PodBatch(
        requests=cut(pods.requests), priority=cut(pods.priority),
        qos=cut(pods.qos), gang_id=cut(pods.gang_id),
        quota_id=cut(pods.quota_id),
        non_preemptible=cut(pods.non_preemptible), valid=cut(pods.valid),
        rot_id=cut(pods.rot_id), feasible=cut(pods.feasible),
        selector_mask=cut(pods.selector_mask))


def select_candidates_plain(state: ClusterState, pods: PodBatch,
                            cfg: ScoringConfig, k: int = 32,
                            strata=(5, 15), chunk: int | None = None):
    """The plain version: score_pods over pod chunks of ``chunk`` rows
    (all rows when None), each reduced to (chunk, k) before the next chunk
    is scored.  Rows are independent, so every chunking gives the same
    bits.  Returns (cand_key, cand_node, cand_score), each (P, k) int32."""
    k = min(k, state.capacity)
    p = pods.capacity
    step = p if chunk is None else max(1, min(chunk, p))
    outs = []
    for start in range(0, p, step):
        sub = _pod_rows(pods, start, min(start + step, p))
        scores, feasible = score_pods(state, sub, cfg)
        outs.append(_reduce_candidates(scores, feasible, tuple(strata), k,
                                       sub.rot_id))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _config_vector(cfg: ScoringConfig) -> tuple[torch.Tensor, bool]:
    """(the packed int32 config on the host, whether the aggregated usage
    thresholds apply), with one copy from the device, kept on ``cfg`` and
    taken again only when a field is another tensor or was written in
    place since.  The kernels' C functions read the vector on the host
    and pass the config to the card as a kernel parameter (layout: the k*
    offsets of csrc/koord_score.cuh).  The aggregated-percentile policy,
    when configured, replaces the instantaneous thresholds."""
    fields = tuple(getattr(cfg, f.name) for f in dataclasses.fields(cfg))
    versions = tuple(t._version for t in fields)
    memo = cfg.__dict__.get("_packed")
    if memo is not None:
        last_fields, last_versions, packed = memo
        if (versions == last_versions
                and all(a is b for a, b in zip(fields, last_fields))):
            return packed
    packed = _pack_config(cfg)
    cfg.__dict__["_packed"] = (fields, versions, packed)
    return packed


def _pack_config(cfg: ScoringConfig) -> tuple[torch.Tensor, bool]:
    def one(t):
        return t.reshape(1).to(torch.int32)

    r = NUM_RESOURCE_DIMS
    full = torch.cat([
        cfg.loadaware_resource_weights.to(torch.int32),
        one(cfg.loadaware_dominant_weight), one(cfg.loadaware_plugin_weight),
        cfg.usage_thresholds.to(torch.int32),
        cfg.fitplus_resource_weights.to(torch.int32),
        cfg.fitplus_most_allocated.to(torch.int32),
        cfg.scarce_dims.to(torch.int32),
        one(cfg.fitplus_plugin_weight), one(cfg.scarce_plugin_weight),
        cfg.agg_usage_thresholds.to(torch.int32),
    ]).cpu()
    agg = full[-r:]
    agg_enabled = bool(torch.any(agg > 0))
    vec = full[:-r].clone()
    if agg_enabled:
        vec[r + 2:2 * r + 2] = agg
    return vec.contiguous(), agg_enabled


def select_candidates_kernel(state: ClusterState, pods: PodBatch,
                             cfg: ScoringConfig, k: int = 32,
                             strata=(5, 15), chunk: int | None = None):
    """K1's wrapper: (cand_key, cand_node, cand_score), each (P, k) int32.

    CPU tensors take :func:`select_candidates_plain` (``chunk`` sets its
    pod-chunk width).  CUDA tensors launch the kernel, which streams the
    node axis and never writes a (P, N) tensor, so ``chunk`` does not
    apply to it."""
    strata = tuple(strata)
    check_node_capacity(state.capacity)
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds):
        return select_candidates_plain(state, pods, cfg, k, strata, chunk)

    n, r = state.capacity, NUM_RESOURCE_DIMS
    p = pods.capacity
    k = min(k, n)
    splits = _stratum_splits(k, len(strata))
    if len(strata) > 2 or max(splits) > KERNEL_MAX_PER_STRATUM:
        raise ValueError(
            f"the kernel takes at most 2 strata of at most "
            f"{KERNEL_MAX_PER_STRATUM} candidates each (got strata={strata}, "
            f"k={k})")
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(state.node_valid, "node_valid", torch.bool, (n,))
    build.expect(state.node_class, "node_class", torch.int32, (n,))
    build.expect(pods.requests, "requests", torch.int32, (p, r))
    build.expect(pods.valid, "valid", torch.bool, (p,))
    build.expect(pods.rot_id, "rot_id", torch.int32, (p,))
    if pods.selector_mask is not None:
        sel = pods.selector_mask
        build.expect(sel, "selector_mask", torch.bool, (p, None))
        c = sel.shape[1]
        if c > 64:
            raise ValueError(f"the kernel takes at most 64 node classes, "
                             f"got {c}")
        feas_t = None
    else:
        build.expect(pods.feasible, "feasible", torch.bool, (p, n))
        sel, c = None, 1
        feas_t = pods.feasible.t().contiguous()   # (N, P): coalesced reads
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage

    dev = pods.requests.device
    key = torch.empty((p, k), dtype=torch.int32, device=dev)
    node = torch.empty((p, k), dtype=torch.int32, device=dev)
    score = torch.empty((p, k), dtype=torch.int32, device=dev)
    if p == 0:
        return key, node, score
    sb = list(strata) + [0] * (2 - len(strata))
    ks = splits + [0] * (2 - len(splits))
    lib = build.lib()
    rows = torch.empty(lib.koord_select_candidates_scratch_bytes(n),
                       dtype=torch.uint8, device=dev)
    err = lib.koord_select_candidates(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(pods.requests), build.ptr(est), build.ptr(pods.valid),
        build.ptr(pods.rot_id), build.ptr(sel), c, build.ptr(feas_t),
        build.ptr(cfgv), cfgv.numel(), p, n, len(strata),
        sb[0], sb[1], ks[0], ks[1], build.ptr(rows),
        build.ptr(key), build.ptr(node), build.ptr(score),
        build.stream_of(key))
    build.check(err, "select_candidates")
    build.LAUNCHES["select_candidates"] += 1
    return key, node, score
