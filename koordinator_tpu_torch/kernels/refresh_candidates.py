"""K2: incremental refresh of the candidate cache over the dirty node columns.

:func:`refresh_candidates_kernel` is the wrapper: CPU tensors take
:func:`refresh_candidates_plain`, CUDA tensors launch
``csrc/refresh_candidates.cu``.  The plain version is the JAX package's
``refresh_candidates`` (``ops/batch_assign.py``): score the (P, D) dirty
sub-problem, invalidate cached slots on dirty nodes, recompute each
stratum's keys from the cached raw scores, and keep per stratum the best
k_i of cached and fresh, position-stable over ``[cached, fresh]``.
:func:`refresh_from_int32_lists` (packed regime: int32 value lists, nodes
recovered afterwards) and :func:`refresh_from_wide_lists` (wide regime:
(64-bit rank, 32-bit word) pairs, the word naming each entry) are the
kernel's ways to
the same rows, which the CPU tests hold against the JAX package.

Both key regimes are taken; only the factored (selector-class)
feasibility form is: the scheduler runs the refresh only on such
batches, and the JAX version cannot gather a dense (P, N) mask to the
dirty columns.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import (
    _SCORE_CLIP,
    _TB_BITS,
    KERNEL_MAX_PER_STRATUM,
    WIDE_TB_BITS,
    _candidate_tb,
    _config_vector,
    _packed_regime,
    _rank_parts,
    _stratum_splits,
    _topk_by_rank,
    check_node_capacity,
    tie_break_preimages,
)
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    pod_estimates,
    score_pods,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: the longest dirty list the kernel takes in the packed regime (at most
#: 2**15 node rows, so the scheduler's padded lists stay far below it;
#: longer lists have not been held against the plain version)
MAX_DIRTY_COLUMNS = 0xFFFF - KERNEL_MAX_PER_STRATUM

#: the wide regime's list word: a fresh entry's bit over its dirty column
_FRESH = 1 << 31
_COL_MAX = _FRESH - 1


def _candidate_keys(score: torch.Tensor, node: torch.Tensor,
                    rot_id: torch.Tensor, spread_bits: int,
                    n_total: int) -> torch.Tensor:
    """Ranking key recomputed from a cached candidate's raw clipped score
    and node row: bit-identical to the key ``_rank_parts`` gives the same
    (pod, node) pair in either regime.  ``score < 0`` marks an invalid
    slot."""
    q = score >> spread_bits
    if _packed_regime(n_total):
        q = (q << _TB_BITS) | _candidate_tb(node, rot_id, n_total)
    return torch.where(score >= 0, q, -1)


def dirty_node_mask(dirty_rows: torch.Tensor, dirty_valid: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(N,) bool: the rows named by the valid entries of ``dirty_rows``.
    An OR, so a padded entry (row 0, invalid) never clears a real bit."""
    hits = torch.zeros(n, dtype=torch.int32, device=dirty_rows.device)
    hits.index_add_(0, dirty_rows.long(), dirty_valid.to(torch.int32))
    return hits > 0


def _check_factored(pods: PodBatch) -> None:
    if pods.selector_mask is None:
        raise ValueError("the candidate refresh takes factored selector "
                         "masks only (a dense (P, N) mask has no dirty-"
                         "column form)")


def refresh_candidates_plain(state: ClusterState, pods: PodBatch,
                             cfg: ScoringConfig, cand_node: torch.Tensor,
                             cand_score: torch.Tensor,
                             dirty_rows: torch.Tensor,
                             dirty_valid: torch.Tensor, k: int = 32,
                             strata=(5, 15)):
    """The plain version: (cand_key, cand_node, cand_score), each (P, k)
    int32, from an aligned cache's nodes and raw scores and the (D,)
    padded dirty rows."""
    _check_factored(pods)
    n = state.capacity
    check_node_capacity(n)
    k = min(k, n)
    d = dirty_rows.shape[0]
    rot = pods.rot_id
    sub = state.gather_rows(dirty_rows, dirty_valid)
    scores, feasible = score_pods(sub, pods, cfg)            # (P, D)
    clipped = torch.clamp(scores, 0, _SCORE_CLIP)
    dirty_mask = dirty_node_mask(dirty_rows, dirty_valid, n)
    stale_score = torch.where(dirty_mask[cand_node.long()], -1, cand_score)

    nodes_out, scores_out = [], []
    off = 0
    for sb, k_i in zip(strata, _stratum_splits(k, len(strata))):
        if k_i == 0:
            continue
        seg_node = cand_node[:, off:off + k_i]
        seg_score = stale_score[:, off:off + k_i]
        off += k_i
        dkey, dtb = _rank_parts(scores, feasible, sb, rot,
                                node_ids=dirty_rows, n_total=n)
        if k_i < d:
            dval, idx = _topk_by_rank(dkey, dtb, k_i, n)
            d_node = dirty_rows[idx.long()]
            d_score = torch.where(
                dval >= 0, torch.gather(clipped, 1, idx.long()), -1)
        else:
            dval = dkey
            d_node = dirty_rows[None, :].expand(dkey.shape[0], d)
            d_score = torch.where(dval >= 0, clipped, -1)
        c_key = _candidate_keys(seg_score, seg_node, rot, sb, n)
        m_key = torch.cat([c_key, dval], dim=1)
        m_node = torch.cat([seg_node, d_node], dim=1)
        m_score = torch.cat([seg_score, d_score], dim=1)
        mval, midx = _topk_by_rank(m_key, _candidate_tb(m_node, rot, n),
                                   k_i, n)
        midx = midx.long()
        nodes_out.append(torch.gather(m_node, 1, midx))
        scores_out.append(torch.where(
            mval >= 0, torch.gather(m_score, 1, midx), -1))
    node = torch.cat(nodes_out, dim=1)
    score = torch.cat(scores_out, dim=1)
    return _candidate_keys(score, node, rot, strata[0], n), node, score


def refresh_from_int32_lists(state: ClusterState, pods: PodBatch,
                             cfg: ScoringConfig, cand_node: torch.Tensor,
                             cand_score: torch.Tensor,
                             dirty_rows: torch.Tensor,
                             dirty_valid: torch.Tensor, k: int = 32,
                             strata=(5, 15)):
    """:func:`refresh_candidates_plain`'s rows, formed as the kernel forms
    them.  Per stratum the kernel keeps only the best k_i int32 values
    ``(key << 1) | cached`` of the valid cached slots and the feasible
    dirty columns, then recovers each kept value's node and score:

    - a cached value: the t-th copy of a value takes the t-th cached slot
      (slot order) whose recomputed key it is;
    - a fresh value: the preimage of its tie-break
      (:func:`tie_break_preimages`) that a valid dirty column holds with
      that key, re-scored; when both preimages do, the t-th copy takes the
      t-th of their columns in the dirty list;
    - slot j past the f valid values: the (j - f)-th invalid cached slot,
      its node kept (every -1 slot the JAX merge keeps is a cached one).
    """
    _check_factored(pods)
    n = state.capacity
    check_node_capacity(n)
    k = min(k, n)
    rot = pods.rot_id
    sub = state.gather_rows(dirty_rows, dirty_valid)
    scores, feasible = score_pods(sub, pods, cfg)            # (P, D)
    clipped = torch.clamp(scores, 0, _SCORE_CLIP).tolist()
    dirty = dirty_node_mask(dirty_rows, dirty_valid, n)
    in_nodes = (cand_node >= 0) & (cand_node < n)
    stale = in_nodes & dirty[cand_node.long().clamp(0, n - 1)]
    rows, valid = dirty_rows.tolist(), dirty_valid.tolist()
    low = -(2**31)
    nodes_out, scores_out = [], []
    off = 0
    for sb, k_i in zip(strata, _stratum_splits(k, len(strata))):
        if k_i == 0:
            continue
        c_node = cand_node[:, off:off + k_i]
        c_score = torch.where(stale[:, off:off + k_i], -1,
                              cand_score[:, off:off + k_i])
        off += k_i
        c_key = _candidate_keys(c_score, c_node, rot, sb, n)
        d_key = _rank_parts(scores, feasible, sb, rot, node_ids=dirty_rows,
                            n_total=n)[0]
        values = torch.cat([torch.where(c_key >= 0, (c_key << 1) | 1, low),
                            torch.where(d_key >= 0, d_key << 1, low)], dim=1)
        kept = torch.sort(values, dim=1, descending=True).values[:, :k_i]
        first, second = tie_break_preimages(
            (kept >> 1) & ((1 << _TB_BITS) - 1),
            rot[:, None].expand_as(kept), n)
        node = torch.empty_like(kept)
        score = torch.empty_like(kept)
        for i, row in enumerate(kept.tolist()):
            ckeys, cnodes = c_key[i].tolist(), c_node[i].tolist()
            cscores = c_score[i].tolist()
            dkeys = d_key[i].tolist()
            prev, copy = None, 0
            spare = (j for j, key in enumerate(ckeys) if key < 0)
            for j, w in enumerate(row):
                copy = copy + 1 if w == prev else 0
                prev = w
                if w < 0:
                    slot = next(spare)
                    node[i, j], score[i, j] = cnodes[slot], -1
                elif w & 1:
                    slot = [s for s, key in enumerate(ckeys)
                            if key == w >> 1][copy]
                    node[i, j], score[i, j] = cnodes[slot], cscores[slot]
                else:
                    pre = [int(first[i, j]), int(second[i, j])]
                    cols = [c for c in range(len(rows))
                            if valid[c] and rows[c] in pre
                            and dkeys[c] == w >> 1]
                    col = cols[copy if len({rows[c] for c in cols}) > 1
                               else 0]
                    node[i, j], score[i, j] = rows[col], clipped[i][col]
        nodes_out.append(node)
        scores_out.append(score)
    node = torch.cat(nodes_out, dim=1)
    score = torch.cat(scores_out, dim=1)
    return _candidate_keys(score, node, rot, strata[0], n), node, score


def refresh_from_wide_lists(state: ClusterState, pods: PodBatch,
                            cfg: ScoringConfig, cand_node: torch.Tensor,
                            cand_score: torch.Tensor,
                            dirty_rows: torch.Tensor,
                            dirty_valid: torch.Tensor, k: int = 32,
                            strata=(5, 15)):
    """:func:`refresh_candidates_plain`'s rows in the wide regime, formed
    as the kernel forms them.  Every entry is a pair (``wide_rank(key,
    tb)``, word) of an int64 and a uint32, ordered lexicographically, so
    the pair order is the JAX merge's whole order and the word names the
    entry:

    - stage 1, the fresh top-k_i of the dirty columns: word = the
      column, so equal (key, tb) keep the higher column first, as JAX's
      dirty top-k does (infeasible and padded columns enter with key -1);
    - stage 2, the merge of the k_i cached slots (word = the slot) with
      the fresh entries (word = a fresh bit over the column, the column
      inverted when the dirty list is longer than k_i): among equal
      (key, tb) JAX keeps the higher merge position first, which is every
      fresh entry before a cached one, the higher cached slot first, and
      among fresh ones the reverse of stage 1's order when stage 1 cut
      the list (positions k_i + rank), else the higher column first
      (positions k_i + column);
    - decoding reads the word: a cached slot keeps its node (and its
      score when the key is valid), a fresh entry takes its dirty
      column's node and clipped score.

    The word is not packed into the rank, so no node capacity or dirty
    list length runs out of bits."""
    _check_factored(pods)
    n = state.capacity
    check_node_capacity(n)
    k = min(k, n)
    d = dirty_rows.shape[0]
    rot = pods.rot_id
    sub = state.gather_rows(dirty_rows, dirty_valid)
    scores, feasible = score_pods(sub, pods, cfg)            # (P, D)
    clipped = torch.clamp(scores, 0, _SCORE_CLIP).tolist()
    dirty = dirty_node_mask(dirty_rows, dirty_valid, n)
    in_nodes = (cand_node >= 0) & (cand_node < n)
    stale = in_nodes & dirty[cand_node.long().clamp(0, n - 1)]
    rows = dirty_rows.tolist()
    d_tb = _candidate_tb(dirty_rows[None, :].expand(rot.shape[0], d), rot,
                         n).tolist()

    def rank(key, tb):
        return (key << WIDE_TB_BITS) | tb

    nodes_out, scores_out = [], []
    off = 0
    for sb, k_i in zip(strata, _stratum_splits(k, len(strata))):
        if k_i == 0:
            continue
        c_node = cand_node[:, off:off + k_i]
        c_score = torch.where(stale[:, off:off + k_i], -1,
                              cand_score[:, off:off + k_i])
        off += k_i
        c_key = _candidate_keys(c_score, c_node, rot, sb, n).tolist()
        c_tb = _candidate_tb(c_node, rot, n).tolist()
        d_key = _rank_parts(scores, feasible, sb, rot, node_ids=dirty_rows,
                            n_total=n)[0].tolist()
        node = torch.empty((rot.shape[0], k_i), dtype=torch.int32)
        score = torch.empty_like(node)
        for i in range(rot.shape[0]):
            stage1 = sorted(((rank(d_key[i][c], d_tb[i][c]), c)
                             for c in range(d)), reverse=True)[:k_i]
            fresh = [(v, _FRESH | (_COL_MAX - c if d > k_i else c))
                     for v, c in stage1]
            cached = [(rank(c_key[i][j], c_tb[i][j]), j) for j in range(k_i)]
            merged = sorted(cached + fresh, reverse=True)[:k_i]
            for j, (v, w) in enumerate(merged):
                valid = v >= 0
                if w & _FRESH:
                    col = w & _COL_MAX
                    col = _COL_MAX - col if d > k_i else col
                    node[i, j] = rows[col]
                    score[i, j] = clipped[i][col] if valid else -1
                else:
                    node[i, j] = c_node[i, w]
                    score[i, j] = c_score[i, w] if valid else -1
        nodes_out.append(node)
        scores_out.append(score)
    node = torch.cat(nodes_out, dim=1)
    score = torch.cat(scores_out, dim=1)
    return _candidate_keys(score, node, rot, strata[0], n), node, score


def merge_pair_lists(a: list, b: list) -> list:
    """The kernel's butterfly step on two descending lists of K (rank,
    word) pairs (``merge_pairs`` in ``csrc/refresh_candidates.cu``):
    ``c[i] = max(a[i], b[K-1-i])`` is bitonic and holds the top K of the
    union, which a bitonic merger sorts descending."""
    k = len(a)
    c = [max(x, y) for x, y in zip(a, reversed(b))]
    half = k // 2
    while half:
        for i in range(k):
            if not i & half and c[i + half] > c[i]:
                c[i], c[i + half] = c[i + half], c[i]
        half //= 2
    return c


def refresh_candidates_kernel(state: ClusterState, pods: PodBatch,
                              cfg: ScoringConfig, cand_node: torch.Tensor,
                              cand_score: torch.Tensor,
                              dirty_rows: torch.Tensor,
                              dirty_valid: torch.Tensor, k: int = 32,
                              strata=(5, 15)):
    """K2's wrapper; see :func:`refresh_candidates_plain`."""
    if build.on_cpu(state.node_allocatable, pods.requests, cand_node,
                    dirty_rows, cfg.usage_thresholds):
        return refresh_candidates_plain(state, pods, cfg, cand_node,
                                        cand_score, dirty_rows, dirty_valid,
                                        k, tuple(strata))
    launch, out = prepare_refresh(state, pods, cfg, cand_node, cand_score,
                                  dirty_rows, dirty_valid, k, strata)
    launch()
    return out


def prepare_refresh(state: ClusterState, pods: PodBatch, cfg: ScoringConfig,
                    cand_node: torch.Tensor, cand_score: torch.Tensor,
                    dirty_rows: torch.Tensor, dirty_valid: torch.Tensor,
                    k: int = 32, strata=(5, 15)):
    """(launch, (cand_key, cand_node, cand_score)): the wrapper's checks
    and buffers for CUDA tensors; ``launch()`` launches the kernel (the
    pack of the dirty rows, then the refresh) into the outputs."""
    strata = tuple(strata)
    _check_factored(pods)
    n, r = state.capacity, NUM_RESOURCE_DIMS
    check_node_capacity(n)
    p = pods.capacity
    k = min(k, n)
    d = dirty_rows.shape[0]
    splits = _stratum_splits(k, len(strata))
    if len(strata) > 2 or max(splits) > KERNEL_MAX_PER_STRATUM:
        raise ValueError(
            f"the kernel takes at most 2 strata of at most "
            f"{KERNEL_MAX_PER_STRATUM} candidates each (got strata={strata}, "
            f"k={k})")
    if _packed_regime(n) and d > MAX_DIRTY_COLUMNS:
        raise ValueError(f"the kernel takes at most {MAX_DIRTY_COLUMNS} "
                         f"dirty columns at {n} node rows, got {d}")
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(state.node_valid, "node_valid", torch.bool, (n,))
    build.expect(state.node_class, "node_class", torch.int32, (n,))
    build.expect(pods.requests, "requests", torch.int32, (p, r))
    build.expect(pods.valid, "valid", torch.bool, (p,))
    build.expect(pods.rot_id, "rot_id", torch.int32, (p,))
    build.expect(pods.selector_mask, "selector_mask", torch.bool, (p, None))
    build.expect(cand_node, "cand_node", torch.int32, (p, k))
    build.expect(cand_score, "cand_score", torch.int32, (p, k))
    build.expect(dirty_rows, "dirty_rows", torch.int32, (d,))
    build.expect(dirty_valid, "dirty_valid", torch.bool, (d,))
    c = pods.selector_mask.shape[1]
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage

    dev = pods.requests.device
    key = torch.empty((p, k), dtype=torch.int32, device=dev)
    node = torch.empty((p, k), dtype=torch.int32, device=dev)
    score = torch.empty((p, k), dtype=torch.int32, device=dev)
    if p == 0:
        return (lambda: None), (key, node, score)
    sb = list(strata) + [0] * (2 - len(strata))
    ks = splits + [0] * (2 - len(splits))
    lib = build.lib()
    # the packed dirty rows, and each dirty node's column (the kernel
    # checks an entry against the row list, so neither is cleared)
    rows = torch.empty(lib.koord_refresh_candidates_scratch_bytes(d),
                       dtype=torch.uint8, device=dev)
    col_of = torch.empty(n, dtype=torch.int32, device=dev)
    # the selector rows as words, packed by the launch
    words = torch.empty((p, -(-c // 64)), dtype=torch.int64, device=dev)
    args = (
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(pods.requests), build.ptr(est), build.ptr(pods.valid),
        build.ptr(pods.rot_id), build.ptr(pods.selector_mask), c,
        build.ptr(words),
        build.ptr(cfgv), cfgv.numel(), build.ptr(cand_node),
        build.ptr(cand_score), build.ptr(dirty_rows),
        build.ptr(dirty_valid), d, p, n, len(strata),
        sb[0], sb[1], ks[0], ks[1], build.ptr(rows), build.ptr(col_of),
        build.ptr(key), build.ptr(node), build.ptr(score),
        build.stream_of(key))
    keep = (est, base, cfgv, rows, col_of, words)  # alive while launch() is

    def launch():
        _ = keep
        build.check(lib.koord_refresh_candidates(*args),
                    "refresh_candidates")
        build.LAUNCHES["refresh_candidates"] += 1

    return launch, (key, node, score)
