"""Batch-parallel assignment: propose/accept rounds instead of an O(P) scan
(port of ``koordinator_tpu/ops/batch_assign.py`` up to the incremental
candidate cache).

    1. ONE fused Filter+Score pass over the (P, N) problem with a per-pod
       rotated tie-break, reduced to each pod's k best candidate nodes —
       the K1 kernel (``kernels/select_candidates.py``);
    2. up to ``rounds`` propose/accept rounds on the (P, k) candidates:
       every active pod proposes its best candidate that still fits (K3a,
       ``kernels/round_fit_choose.py``), and conflicts resolve by a
       segmented prefix sum over requests in priority order, per node and
       per quota-ancestor level, all levels in one call a round (K3b,
       ``kernels/prefix_accept.py``).

Ported scope: both key regimes (the packed single-int32 key up to 2**15
node rows, the wide (key, tie-break) ranking past it, up to the 2**30
ceiling) and every candidate method of the JAX package: ``exact`` and
``chunked_exact`` (K1), ``approx`` and ``chunked`` (K1a: the approx
reduction, whose float32 key keeps the tie-break's high bits and breaks
its ties lowest column first), and ``auto``, which is ``exact`` here as in
JAX off the TPU.

PyTorch idiom in place of the JAX control flow: ``lexsort`` is one stable
sort, ``segment_sum`` is ``index_add_``, and the ``while_loop`` is a Python
loop of at most ``rounds`` rounds that stops when no pod is active.  The
JAX round skips the sorted acceptance when no segment is oversubscribed;
the sorted path returns the same bits in that case, so the port always
runs it.

The incremental section at the end carries a (P, k) candidate cache across
scheduler rounds and refreshes it over the dirty node columns (K2,
``kernels/refresh_candidates.py``) instead of re-selecting over (P, N).
"""

from __future__ import annotations

import dataclasses

import torch

from koordinator_tpu_torch.kernels.prefix_accept import (  # noqa: F401
    accept_plan,
    round_prefix_accept,
    segmented_prefix_accept_plain as _prefix_accept_sorted_choice,
)
from koordinator_tpu_torch.kernels.refresh_candidates import (  # noqa: F401
    _candidate_keys,
    refresh_candidates_kernel,
)
from koordinator_tpu_torch.kernels.round_fit_choose import (  # noqa: F401
    _choose_candidate,
    round_fit_choose,
)
from koordinator_tpu_torch.kernels.select_candidates import (  # noqa: F401
    _SCORE_CLIP,
    _TB_BITS,
    MAX_NODE_CAPACITY,
    PACKED_NODE_CAPACITY,
    _candidate_tb,
    _packed_regime,
    _rank_parts,
    _reduce_candidates,
    _stratum_splits,
    _topk_by_rank,
    check_node_capacity,
    select_candidates_kernel,
)
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    pod_estimates,
    priority_order,
)
from koordinator_tpu_torch.quota.admission import (
    QuotaDeviceState,
    charge_quota_batch,
    quota_admission_mask,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: the JAX package's candidate-selection strategies, all ported ("auto" is
#: "exact" here, as in JAX off the TPU)
CANDIDATE_METHODS = ("auto", "exact", "approx", "chunked", "chunked_exact")
#: pod-chunk width of the chunked methods' plain version: peak score
#: memory is (CANDIDATE_CHUNK, N) instead of (P, N)
CANDIDATE_CHUNK = 4096


def kernel_method(method: str) -> str:
    """The reduction a candidate method runs: "exact" (K1) or "approx"
    (K1a).  The chunked methods give their unchunked twin's rows."""
    if method not in CANDIDATE_METHODS:
        raise ValueError(f"unknown candidate method {method!r}; "
                         f"one of {CANDIDATE_METHODS}")
    return "approx" if method in ("approx", "chunked") else "exact"

#: the selection defaults every solve path shares (the JAX scheduler's
#: ``cand_k``, ``cand_spread`` and ``solve_rounds``): the scheduler's
#: incremental rounds use them as gang_assign's full rounds do, so the two
#: paths solve the same problem
CAND_K = 32
CAND_SPREAD = (5, 15)
SOLVE_ROUNDS = 12


def select_candidates(
    state: ClusterState,
    pods: PodBatch,
    cfg: ScoringConfig,
    k: int = CAND_K,
    spread_bits=CAND_SPREAD,
    method: str = "auto",
    with_scores: bool = False,
):
    """(cand_key, cand_node), each (P, k), plus (P, k) cand_score (the
    clipped composite score, -1 on invalid slots) with ``with_scores``.

    ``spread_bits`` may be an int or a tuple (STRATIFIED selection: k splits
    evenly over the strata, each picks its share by its own quantized key,
    and the first stratum's key orders all candidates in the rounds).
    ``exact`` and ``chunked_exact`` give the same rows, as do ``approx``
    and ``chunked``; on the GPU each pair runs one streaming kernel (K1,
    K1a), which never writes a (P, N) tensor."""
    reduction = kernel_method(method)
    strata = (tuple(spread_bits) if isinstance(spread_bits, (tuple, list))
              else (spread_bits,))
    chunk = (CANDIDATE_CHUNK if method in ("chunked", "chunked_exact")
             else None)
    key, node, score = select_candidates_kernel(state, pods, cfg, k, strata,
                                                chunk=chunk,
                                                method=reduction)
    return (key, node, score) if with_scores else (key, node)


def _assign_rounds(state: ClusterState, pods: PodBatch, quota, cand_key,
                   cand_node, rounds: int):
    """The propose/accept stage over (P, k) candidates.  Returns
    (assignments, new_state, new_quota); the input state is not modified
    (the round's node accounting is a copy updated in place)."""
    check_node_capacity(state.capacity)
    order = priority_order(pods)
    plan = (accept_plan(order, pods.requests) if quota is None else
            accept_plan(order, pods.requests, pods.quota_id,
                        pods.non_preemptible, quota.chain, quota.checked))
    active = pods.valid & torch.any(cand_key >= 0, dim=1)
    requested = state.node_requested.clone()
    assignments = torch.full((pods.capacity,), -1, dtype=torch.int32,
                             device=requested.device)
    alloc, node_valid = state.node_allocatable, state.node_valid
    for _ in range(rounds):
        if not bool(torch.any(active)):
            break
        free = torch.where(node_valid[:, None], alloc - requested, 0)
        choice, has = round_fit_choose(cand_key, cand_node, free,
                                       pods.requests, active, pods.rot_id)
        act = active & has
        if quota is not None:
            act = act & quota_admission_mask(quota, pods.requests,
                                             pods.quota_id,
                                             pods.non_preemptible)
        # the node level and every quota level, one call (one K3b launch)
        accept = round_prefix_accept(
            plan, choice, act, free,
            *((quota.headroom, quota.min_headroom) if quota is not None
              else ()))
        safe = torch.where(accept, choice, 0).long()
        requested.index_add_(0, safe,
                             torch.where(accept[:, None], pods.requests, 0))
        if quota is not None:
            quota = charge_quota_batch(quota, pods.requests, pods.quota_id,
                                       accept, pods.non_preemptible)
        assignments = torch.where(accept, choice, assignments)
        # free capacity and quota headroom only shrink within a solve, so a
        # pod with no fitting admitted candidate now can never gain one
        active = act & ~accept
    return assignments, state.replace(node_requested=requested), quota


def batch_assign(
    state: ClusterState,
    pods: PodBatch,
    cfg: ScoringConfig,
    quota: QuotaDeviceState | None = None,
    k: int = CAND_K,
    rounds: int = SOLVE_ROUNDS,
    spread_bits=CAND_SPREAD,
    method: str = "auto",
):
    """Assign a pending batch in data-parallel propose/accept rounds.

    Same returns as ``greedy_assign``: (assignments, new_state, new_quota),
    assignments (P,) int32 with -1 = unassigned.  The default stratified
    ``spread_bits=(5, 15)`` splits k between a score-faithful stratum and a
    pure-rotation coverage stratum."""
    cand_key, cand_node = select_candidates(
        state, pods, cfg, k=k, spread_bits=spread_bits, method=method)
    return _assign_rounds(state, pods, quota, cand_key, cand_node, rounds)


# ---------------------------------------------------------------------------
# Incremental delta-driven solve: a candidate cache carried across rounds
# ---------------------------------------------------------------------------
#
# A steady-state round arrives as a small delta (a few node updates, a few
# pod arrivals).  The cache keeps the (P, k) candidates across rounds and
# refreshes them in O(P*D + Pd*N) for D dirty nodes and Pd dirty pods:
#
#   1. a pod whose cached candidates touch NO dirty node keeps them: its
#      cached top-k over the clean nodes is the clean-column top-k, so
#      merging in a fresh top-k over the dirty COLUMNS reproduces the full
#      pass's top-k exactly, per stratum (K2);
#   2. a pod that is new or changed, or whose cached candidates touch a
#      dirty node, is rescored fully: the scheduler compacts such pods into
#      a small batch (K1) and scatters the fresh rows over K2's output.
#
# A stale candidate could only cost recall, never correctness: acceptance
# re-checks fit and quota exactly every round.


@dataclasses.dataclass
class CandidateCache:
    """Device-resident candidate state carried across scheduler rounds."""

    cand_key: torch.Tensor    # (P, k) int32 stratum-0 ranking key, -1 invalid
    cand_node: torch.Tensor   # (P, k) int32 node rows
    cand_score: torch.Tensor  # (P, k) int32 raw clipped score, -1 invalid


def align_candidate_cache(cache: CandidateCache, map_rows: torch.Tensor,
                          map_ok: torch.Tensor, dirty_mask: torch.Tensor):
    """Gather cached rows into the CURRENT batch's row order and flag pods
    whose cached candidates touch a dirty node.  Keys and scores depend on
    (rot_id, node, score) only, so a gathered row is the pod's cached
    candidate set whatever the queue did around it.

    ``map_rows`` (P,) is the cached row of each current row, ``map_ok``
    (P,) whether it has one, ``dirty_mask`` (N,) the changed nodes.
    Returns (aligned cache, touch): ``touch[i]`` means row i's cached
    candidates meet a dirty node, so the pod must be rescored fully."""
    rows = map_rows.long()
    node = cache.cand_node[rows]
    score = torch.where(map_ok[:, None], cache.cand_score[rows], -1)
    key = torch.where(map_ok[:, None], cache.cand_key[rows], -1)
    touch = torch.any(dirty_mask[node.long()] & (score >= 0), dim=1)
    return CandidateCache(key, node, score), touch


def refresh_candidates(state: ClusterState, pods: PodBatch,
                       cfg: ScoringConfig, cache: CandidateCache,
                       dirty_rows: torch.Tensor, dirty_valid: torch.Tensor,
                       k: int = CAND_K, spread_bits=CAND_SPREAD):
    """Merge fresh dirty-COLUMN candidates into an aligned cache (K2):
    score the (P, D) dirty sub-problem, invalidate cached slots on dirty
    nodes, recompute each stratum's keys from the cached raw scores, and
    keep the best k_i per stratum of cached and fresh.  ``dirty_rows``
    (D,) int32 is padded; ``dirty_valid`` marks its real entries.

    Returns (cand_key, new_cache); cand_node rides the cache."""
    strata = (tuple(spread_bits) if isinstance(spread_bits, (tuple, list))
              else (spread_bits,))
    key, node, score = refresh_candidates_kernel(
        state, pods, cfg, cache.cand_node, cache.cand_score, dirty_rows,
        dirty_valid, k, strata)
    return key, CandidateCache(key, node, score)


def scatter_candidate_rows(cache: CandidateCache, rows: torch.Tensor,
                           src_key: torch.Tensor, src_node: torch.Tensor,
                           src_score: torch.Tensor) -> CandidateCache:
    """Overwrite the fully rescored (dirty-pod) rows into the cache: the
    compacted selection's output scattered back to batch rows.  A row
    outside the cache after Python's negative-index rule is dropped (JAX's
    ``mode="drop"``); it lands in a scratch row that is cut away, so no
    host sync is needed to filter it."""
    p = cache.cand_key.shape[0]
    idx = rows.long()
    idx = torch.where(idx < 0, idx + p, idx)
    idx = torch.where((idx >= 0) & (idx < p), idx, p)

    def put(dst, src):
        out = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
        return out.index_copy_(0, idx, src.to(dst.dtype))[:p]

    return CandidateCache(cand_key=put(cache.cand_key, src_key),
                          cand_node=put(cache.cand_node, src_node),
                          cand_score=put(cache.cand_score, src_score))


def assign_round_pass(state: ClusterState, pods: PodBatch, quota,
                      cand_key: torch.Tensor, cand_node: torch.Tensor,
                      cfg: ScoringConfig, rounds: int = SOLVE_ROUNDS):
    """First solve pass over precomputed candidates, with the est-usage
    accumulation and quota recharge ``gang_assign`` applies between
    passes: bit-identical to gang_assign's first pass over a GANGLESS
    batch (the scheduler's incremental path runs only on such rounds).

    Returns (assignments, new_state, new_quota, est_accum)."""
    a, new_state, _ = _assign_rounds(state, pods, quota, cand_key,
                                     cand_node, rounds)
    keep = a >= 0
    est = pod_estimates(pods, cfg)
    node = torch.where(keep, a, 0).long()
    est_accum = torch.zeros_like(state.node_usage).index_add_(
        0, node, torch.where(keep[:, None], est, 0))
    new_quota = quota
    if quota is not None:
        # the in-rounds quota feedback is discarded and recharged whole, as
        # gang_assign does after rollback
        new_quota = charge_quota_batch(quota, pods.requests, pods.quota_id,
                                       keep, pods.non_preemptible)
    return a, new_state, new_quota, est_accum


def assign_followup_pass(state: ClusterState, est_accum: torch.Tensor,
                         pods: PodBatch, quota, cfg: ScoringConfig,
                         k: int = CAND_K, rounds: int = SOLVE_ROUNDS,
                         spread_bits=CAND_SPREAD,
                         method: str = "auto"):
    """A later gang_assign pass over the (compacted) leftover pods:
    candidates re-selected against the est-augmented state, assignments
    committed into the un-augmented accounting.  Selection is row-
    independent and rot_id rides the compacted batch, so solving the
    compacted leftovers equals solving the full batch with every other
    pod masked invalid.

    Returns (assignments, new_state, new_quota, est_accum')."""
    solve_state = state.replace(
        node_usage=state.node_usage + est_accum,
        node_agg_usage=state.node_agg_usage + est_accum)
    a, _, _ = batch_assign(solve_state, pods, cfg, quota, k=k, rounds=rounds,
                           spread_bits=spread_bits, method=method)
    keep = (a >= 0) & pods.valid
    node = torch.where(keep, a, 0).long()
    add = torch.where(keep[:, None], pods.requests, 0)
    new_state = state.replace(
        node_requested=state.node_requested.clone().index_add_(0, node, add))
    est = pod_estimates(pods, cfg)
    est_accum = est_accum.clone().index_add_(
        0, node, torch.where(keep[:, None], est, 0))
    new_quota = quota
    if quota is not None:
        new_quota = charge_quota_batch(quota, pods.requests, pods.quota_id,
                                       keep, pods.non_preemptible)
    return a, new_state, new_quota, est_accum
