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


def _config_vector(cfg: ScoringConfig, agg_enabled: bool) -> torch.Tensor:
    """The packed int32 config the kernel reads (layout: k* offsets at the
    top of csrc/select_candidates.cu)."""
    thr = cfg.agg_usage_thresholds if agg_enabled else cfg.usage_thresholds

    def one(t):
        return t.reshape(1).to(torch.int32)

    return torch.cat([
        cfg.loadaware_resource_weights.to(torch.int32),
        one(cfg.loadaware_dominant_weight), one(cfg.loadaware_plugin_weight),
        thr.to(torch.int32),
        cfg.fitplus_resource_weights.to(torch.int32),
        cfg.fitplus_most_allocated.to(torch.int32),
        cfg.scarce_dims.to(torch.int32),
        one(cfg.fitplus_plugin_weight), one(cfg.scarce_plugin_weight),
    ]).contiguous()


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
    agg_enabled = bool(torch.any(cfg.agg_usage_thresholds > 0))
    base = state.node_agg_usage if agg_enabled else state.node_usage
    cfgv = _config_vector(cfg, agg_enabled)

    dev = pods.requests.device
    key = torch.empty((p, k), dtype=torch.int32, device=dev)
    node = torch.empty((p, k), dtype=torch.int32, device=dev)
    score = torch.empty((p, k), dtype=torch.int32, device=dev)
    if p == 0:
        return key, node, score
    sb = list(strata) + [0] * (2 - len(strata))
    ks = splits + [0] * (2 - len(splits))
    err = build.lib().koord_select_candidates(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(pods.requests), build.ptr(est), build.ptr(pods.valid),
        build.ptr(pods.rot_id), build.ptr(sel), c, build.ptr(feas_t),
        build.ptr(cfgv), cfgv.numel(), p, n, len(strata),
        sb[0], sb[1], ks[0], ks[1],
        build.ptr(key), build.ptr(node), build.ptr(score),
        build.stream_of(key))
    build.check(err, "select_candidates")
    build.LAUNCHES["select_candidates"] += 1
    return key, node, score
