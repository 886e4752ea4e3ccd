"""K1 and K1a: fused Filter + Score + stratified top-k candidate selection.

:func:`select_candidates_kernel` is the wrapper: CPU tensors take
:func:`select_candidates_plain`, CUDA tensors launch
``csrc/select_candidates.cu`` (K1 for the exact reduction, K1a for the
approx one).  The plain version is the JAX package's candidate stage in
PyTorch (``ops/batch_assign.py`` ``score_pods`` -> ``_rank_parts`` ->
``_topk_by_rank``, or the approx branch of ``_reduce_candidates``), scored
one pod chunk at a time.

The ranking helpers live here, beside the plain version that uses them, and
``ops/batch_assign.py`` re-exports them.  Both key regimes of the JAX
package are ported: up to ``PACKED_NODE_CAPACITY`` (2**15) node rows one
int32 carries the quantized score over a rotated node tie-break (the
PACKED regime); past it the key is the quantized score alone and the
tie-break ranks second (the WIDE regime), up to the 2**30 ceiling of
``check_node_capacity``.
"""

from __future__ import annotations

import ctypes
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


#: bits of the rotated tie-break in the wide regime's 64-bit composite
#: rank ``key << 30 | tb`` (the kernels' lists; tb < N <= 2**30)
WIDE_TB_BITS = 30


def check_node_capacity(n: int) -> None:
    """Raise if a node capacity exceeds the ranking key's ceiling: node
    rows index as nonnegative int32 and the rotated tie-break arithmetic
    must stay inside int32."""
    if n > MAX_NODE_CAPACITY:
        raise ValueError(
            f"node capacity {n} exceeds the batched solver's ranking-key "
            f"ceiling of {MAX_NODE_CAPACITY} (= 2**30)")


def _packed_regime(n_total: int) -> bool:
    """True when ``n_total`` node rows fit the packed int32 key."""
    return n_total <= PACKED_NODE_CAPACITY


def _rank_parts(scores: torch.Tensor, feasible: torch.Tensor,
                spread_bits: int = 0, rot_id: torch.Tensor | None = None,
                node_ids: torch.Tensor | None = None,
                n_total: int | None = None):
    """(key, tb): the ranking key (-1 where infeasible) and the per-pod
    rotated tie-break ``(N-1) - ((node - rot_id*7919) mod N)``.  The key
    is ``(clip(score) >> sb) << 15 | tb`` in the packed regime and
    ``clip(score) >> sb`` alone in the wide one, where callers rank by
    (key, tb).  ``rot_id * 7919`` and the difference wrap in int32 as in
    JAX; ``%`` floors.  ``node_ids`` / ``n_total`` rank a gathered column
    subset (the incremental refresh's dirty columns) by their global node
    ids."""
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
    key = (q << _TB_BITS) | tb if _packed_regime(n_total) else q
    return torch.where(feasible, key, -1), tb


def _candidate_tb(node: torch.Tensor, rot_id: torch.Tensor,
                  n_total: int) -> torch.Tensor:
    """The (P, k) rotated tie-break of candidate node rows (the same pure
    function of (rot_id, node) that :func:`_rank_parts` packs)."""
    rot = (rot_id.to(torch.int32) * 7919)[:, None]
    return (n_total - 1) - ((node - rot) % n_total)


def _topk_by_rank(key: torch.Tensor, tb: torch.Tensor, k: int,
                  n_total: int):
    """Per-row top-k columns by (key, tb) rank, descending.  Returns
    (key_sel, col_idx int32).

    Packed regime: by key, lowest column first among equal keys
    (``lax.top_k``'s order; ``torch.topk`` promises none, so a stable
    descending sort stands in).  Wide regime: lexicographically by
    (key, tb), and among equal pairs the HIGHER column first: JAX sorts
    (key, tb, column) ascending and flips the tail, so a stable
    descending sort of the reversed row stands in."""
    check_node_capacity(n_total)
    if _packed_regime(n_total):
        vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k].to(torch.int32)
    n = key.shape[1]
    idx = torch.sort(wide_rank(key, tb).flip(1), dim=1, descending=True,
                     stable=True).indices[:, :k]
    idx = (n - 1) - idx
    return torch.gather(key, 1, idx), idx.to(torch.int32)


def _stratum_splits(k: int, n: int) -> list[int]:
    """Split k as evenly as possible over n strata (first strata get the
    remainder)."""
    base, rem = divmod(k, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def approx_shifts(sb: int, n_total: int) -> tuple[int, int]:
    """(shift, d) of the approx methods' key for spread bits ``sb``: the
    quantized score rides bits ``shift`` and up, and the tie-break
    contributes its bits from ``d`` up (its low ``d`` bits are dropped),
    so the key ``(q << shift) | (tb >> d)`` stays within float32's 24-bit
    mantissa.  The packed regime takes the high bits of the 15-bit
    tie-break field, the wide one of the tie-break's bits(N - 1)."""
    score_bits = (30 - _TB_BITS) - sb
    if _packed_regime(n_total):
        shift = min(_TB_BITS, max(24 - score_bits, 0))
        return shift, _TB_BITS - shift
    tb_bits = max((n_total - 1).bit_length(), 1)
    shift = max(24 - score_bits, 0)
    return shift, max(tb_bits - shift, 0)


def approx_keys(key: torch.Tensor, tb: torch.Tensor, sb: int,
                n_total: int) -> torch.Tensor:
    """(P, N) int64: the integer value of the JAX package's float32 key of
    the approx methods (exact in float32: it has at most 24 bits), -1
    where infeasible.  ``key``/``tb`` are :func:`_rank_parts`' at ``sb``;
    the quantized score is ``key >> 15`` packed and ``key`` wide."""
    shift, d = approx_shifts(sb, n_total)
    key = key.to(torch.int64)
    q = key >> _TB_BITS if _packed_regime(n_total) else key
    return torch.where(key >= 0, (q << shift) | (tb.to(torch.int64) >> d),
                       -1)


def _topk_approx(key: torch.Tensor, tb: torch.Tensor, sb: int, k: int,
                 n_total: int) -> torch.Tensor:
    """The approx methods' per-row top-k columns (int32): by the
    :func:`approx_keys` key descending, the lowest column first among
    equal keys (``approx_max_k``'s order on the CPU; infeasible columns
    are -1 and come last, lowest first).  At k = 1 the CPU lowering
    reduces to the row's LAST maximum instead: the highest column among
    equal keys (column N - 1 on a row with no feasible column)."""
    a = approx_keys(key, tb, sb, n_total)
    if k == 1:
        n = a.shape[1]
        return ((n - 1) - torch.argmax(a.flip(1), dim=1, keepdim=True)
                ).to(torch.int32)
    idx = torch.sort(a, dim=1, descending=True, stable=True).indices
    return idx[:, :k].to(torch.int32)


def _reduce_candidates(scores, feasible, strata, k: int, rot_id=None,
                       method: str = "exact"):
    """(scores, feasible) -> (cand_key, cand_node, cand_score): each
    stratum picks its share of k by its own quantized key; the first
    stratum's key orders every candidate (gathered, so infeasible slots of
    short lists read -1).  ``method="approx"`` ranks a stratum by the
    approx key (:func:`_topk_approx`) where its share is below the column
    count, and exactly otherwise, as the JAX package does."""
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
        if method == "approx" and k_i < n_total:
            cols.append(_topk_approx(key, tb, sb, k_i, n_total))
        else:
            cols.append(_topk_by_rank(key, tb, k_i, n_total)[1])
    cand_cols = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    cols_l = cand_cols.long()
    cand_key = torch.gather(order_key, 1, cols_l)
    raw = torch.gather(torch.clamp(scores, 0, _SCORE_CLIP), 1, cols_l)
    return cand_key, cand_cols, torch.where(cand_key >= 0, raw, -1)


# -- what the kernel computes instead of the plain version's steps ----------
#
# The functions below mirror, in PyTorch, the arithmetic the CUDA kernels
# (csrc/koord_score.cuh, csrc/select_candidates.cu) do differently from the
# plain version, so the CPU tests can hold each against the JAX package:
# floor division by an invariant divisor without a divide, the node
# recovered from an int32 (packed) or 64-bit (wide) ranking key, the -1
# slots of either regime, and the selector rows as 64-bit words.


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


def wide_rank(key: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """The wide regime's 64-bit composite rank ``key << 30 | tb`` (the
    kernels' ``wide_rank``): for key >= -1 and 0 <= tb < 2**30 it is
    key * 2**30 + tb, whose int64 order is the (key, tb) order."""
    return (key.to(torch.int64) << WIDE_TB_BITS) | tb.to(torch.int64)


def wide_fill_order(rot_id: int, n_total: int):
    """The columns of one row in the wide regime's order of its -1 slots:
    tie-break descending, the higher column first between the two nodes
    that share a wrapped tie-break (:func:`tie_break_preimages`).  Yields
    every column once, as the kernels' fill walk visits them."""
    rot = torch.tensor([rot_id], dtype=torch.int32)
    for t in range(n_total):
        first, second = tie_break_preimages(
            torch.tensor([n_total - 1 - t], dtype=torch.int32), rot, n_total)
        for n in (int(second), int(first)):
            if n >= 0:
                yield n


def topk_from_wide_keys(key: torch.Tensor, tb: torch.Tensor, k: int,
                        rot_id: torch.Tensor, n_total: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k (key_sel, col_idx) as the kernel forms it in the wide
    regime: it keeps only the best k composite ranks (:func:`wide_rank`)
    of the row's feasible columns and their count f, and recovers the
    columns afterwards.

    - Slot j < f holds a rank v; its column is the preimage of v's
      tie-break whose own rank is v.  When both preimages carry v, the
      first copy takes the HIGHER column and a second copy the lower: the
      wide order among equal (key, tb).
    - Slot j >= f is a -1 slot: the row's infeasible columns in
      :func:`wide_fill_order`.
    Equals ``_topk_by_rank`` in the wide regime for ``tb`` from
    ``_rank_parts``."""
    p, n = key.shape
    k = min(k, n)
    rank = wide_rank(key, tb)
    keys_out = torch.full((p, k), -1, dtype=torch.int32)
    cols_out = torch.empty((p, k), dtype=torch.int32)
    mask = (1 << WIDE_TB_BITS) - 1
    for i in range(p):
        row = rank[i].tolist()
        feas = [v for v, kk in zip(row, key[i].tolist()) if kk >= 0]
        vals = sorted(feas, reverse=True)[:k]
        prev = None
        for j, v in enumerate(vals):
            t = torch.tensor([v & mask], dtype=torch.int32)
            first, second = (int(x) for x in tie_break_preimages(
                t, rot_id[i:i + 1], n_total))
            take_second = (second >= 0 and row[second] == v
                           and prev != v)
            cols_out[i, j] = second if take_second else first
            keys_out[i, j] = v >> WIDE_TB_BITS
            prev = v
        fill = (c for c in wide_fill_order(int(rot_id[i]), n_total)
                if key[i, c] < 0)
        for j in range(len(vals), k):
            cols_out[i, j] = next(fill)
    return keys_out, cols_out


#: bits of the column in K1a's 64-bit rank ``a << 31 | (2**31-1 - col)``
APPROX_COL_BITS = 31


def approx_rank(a: torch.Tensor, col: torch.Tensor,
                last: bool = False) -> torch.Tensor:
    """K1a's 64-bit list entry for an approx key ``a`` (0 <= a < 2**30) at
    column ``col``: ``a << 31 | (2**31 - 1 - col)``, whose int64 order is
    (a descending, column ascending) read from the top; with ``last``
    (a stratum of one candidate) ``a << 31 | col``, the higher column
    first."""
    mask = (1 << APPROX_COL_BITS) - 1
    col = col.to(torch.int64)
    return (a.to(torch.int64) << APPROX_COL_BITS) | (col if last
                                                     else mask - col)


def topk_from_approx_ranks(a: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row top-k columns (int32) as K1a forms them from the
    :func:`approx_keys` key ``a``: it keeps the best k :func:`approx_rank`
    entries of the row's feasible columns and their count f, reads slot
    j < f's column from the entry's low 31 bits, and fills slot j >= f
    with the row's (j - f)-th infeasible column, ascending (at k = 1,
    ranks with ``last`` and a row with no feasible column takes column
    N - 1).  Equals :func:`_topk_approx`."""
    p, n = a.shape
    k = min(k, n)
    last = k == 1
    cols = torch.arange(n, dtype=torch.int64)[None, :].expand(p, n)
    rank = torch.where(a >= 0, approx_rank(a.clamp(min=0), cols, last), -1)
    vals = torch.sort(rank, dim=1, descending=True).values[:, :k]
    mask = (1 << APPROX_COL_BITS) - 1
    node = (vals & mask) if last else mask - (vals & mask)
    f = (a >= 0).sum(dim=1, keepdim=True)
    j = torch.arange(k)[None, :]
    infeasible_first = torch.sort((a >= 0).to(torch.int8), dim=1,
                                  stable=True).indices[:, :k]
    fill = (torch.full_like(infeasible_first, n - 1) if last else
            torch.gather(infeasible_first, 1, (j - f).clamp(min=0)))
    return torch.where(j < f, node, fill).to(torch.int32)


def approx_band(rot_id: torch.Tensor, n_total: int) -> torch.Tensor:
    """(P,) bool: the rows K1a ranks on its 64-bit instance in the packed
    regime, those whose tie-break gives two nodes one value
    (:func:`tie_break_preimages` finds a second preimage): int32(rot_id *
    7919) lies within N above -2**31, past -2**31 itself, and 2**32 is not
    a multiple of N."""
    wrap_from = (rot_id.to(torch.int32) * 7919).to(torch.int64) + 2**31
    return (wrap_from > 0) & (wrap_from < n_total) & (2**32 % n_total != 0)


def _approx_int32_parts(sb: int, k: int, rot_id: torch.Tensor,
                        n_total: int):
    """(d, x, t, tb0) of K1a's int32 rank for a stratum of ``k`` at spread
    bits ``sb``: the tie-break bits the approx key drops (0 when the
    stratum takes every column and ranks exactly), the low bits'
    complement (a stratum of one candidate), the rotation of the run that
    holds column 0 and column 0's tie-break (P, 1)."""
    d = approx_shifts(sb, n_total)[1] if k < n_total else 0
    mask = (1 << d) - 1
    tb0 = _candidate_tb(torch.zeros((rot_id.shape[0], 1), dtype=torch.int32),
                        rot_id, n_total).to(torch.int64)
    z1 = (tb0 & mask) + 1
    last = k == 1
    return d, (mask if last else 0), (z1 if last else -z1), tb0


def approx_rank_int32(key: torch.Tensor, tb: torch.Tensor, sb: int, k: int,
                      rot_id: torch.Tensor, n_total: int) -> torch.Tensor:
    """(P, N) int32: K1a's packed-regime list entry of every column (-1
    where infeasible) for a stratum of ``k`` at spread bits ``sb``
    (``key``/``tb`` from :func:`_rank_parts` at ``sb``).  K1's key
    ``q << 15 | tb`` with the tie-break's low d bits (those the approx key
    drops) complemented when k = 1, and, in the run of 2**d values that
    holds column 0's tie-break, rotated so that the run reads from column
    0 upwards: on a row off :func:`approx_band` its descending order is
    :func:`approx_rank`'s (approx key descending, the lowest column first,
    at k = 1 the highest)."""
    d, x, t, tb0 = _approx_int32_parts(sb, k, rot_id, n_total)
    mask = (1 << d) - 1
    tb = tb.to(torch.int64)
    add = torch.where(((tb ^ tb0) >> d) == 0, t, 0)
    tb_r = (tb & ~mask) | (((tb ^ x) + add) & mask)
    key = key.to(torch.int64)
    return torch.where(key >= 0, ((key >> _TB_BITS) << _TB_BITS) | tb_r,
                       -1).to(torch.int32)


def topk_from_approx_int32(key: torch.Tensor, tb: torch.Tensor, sb: int,
                           k: int, rot_id: torch.Tensor,
                           n_total: int) -> torch.Tensor:
    """Per-row top-k columns (int32) as K1a forms them in the packed
    regime.  Rows off :func:`approx_band`: the best k
    :func:`approx_rank_int32` entries and the count f of feasible columns;
    slot j < f inverts the rotation to the tie-break and takes its one
    preimage (the node), slot j >= f the (j - f)-th infeasible column,
    ascending (at k = 1 column N - 1).  Band rows: the 64-bit instance,
    :func:`topk_from_approx_ranks`, for every stratum.  Equals :func:`_topk_approx` for a
    stratum below the column count, and ``_topk_by_rank`` at or above it."""
    p, n = key.shape
    k = min(k, n)
    d, x, t, tb0 = _approx_int32_parts(sb, k, rot_id, n_total)
    mask = (1 << d) - 1
    vals = torch.sort(approx_rank_int32(key, tb, sb, k, rot_id, n_total),
                      dim=1, descending=True).values[:, :k].to(torch.int64)
    v = vals & ((1 << _TB_BITS) - 1)
    add = torch.where(((v ^ tb0) >> d) == 0, t, 0)
    tb_v = (v & ~mask) | ((((v & mask) - add) & mask) ^ x)
    first, _ = tie_break_preimages(tb_v, rot_id[:, None].expand(p, k),
                                   n_total)
    f = (key >= 0).sum(dim=1, keepdim=True)
    j = torch.arange(k)[None, :]
    infeasible_first = torch.sort((key >= 0).to(torch.int8), dim=1,
                                  stable=True).indices[:, :k]
    fill = (torch.full_like(infeasible_first, n - 1) if k == 1 else
            torch.gather(infeasible_first, 1, (j - f).clamp(min=0)))
    cols = torch.where(j < f, first.to(torch.int64), fill)
    band = approx_band(rot_id, n_total)
    if bool(band.any()):
        # an exact stratum's approx key is K1's key ((shift, d) = (15, 0))
        a = (approx_keys(key, tb, sb, n_total) if k < n_total
             else key.to(torch.int64))
        wide = topk_from_approx_ranks(a, k)
        cols = torch.where(band[:, None], wide.to(torch.int64), cols)
    return cols.to(torch.int32)


def selector_words(sel: torch.Tensor) -> torch.Tensor:
    """A (P, C) selector mask as (P, W) int64 words, W = ceil(C / 64): bit
    c % 64 of word c // 64 is column c (the layout the kernels' launches
    pack, csrc/koord_score.cuh pack_selector_words)."""
    p, c = sel.shape
    w = max(1, -(-c // 64))
    bits = torch.zeros((p, w * 64), dtype=torch.uint8, device=sel.device)
    bits[:, :c] = sel
    shift = torch.arange(8, dtype=torch.uint8, device=sel.device)
    packed = (bits.view(p, w * 8, 8) << shift).sum(-1, dtype=torch.uint8)
    return packed.contiguous().view(torch.int64)


def selector_bit(words: torch.Tensor, cls: torch.Tensor,
                 c: int) -> torch.Tensor:
    """(P, N) bool: the kernels' selector test of every pod against every
    node class, ``selector_mask[:, min(class, C-1)] & (class < C)`` read
    from the words (a negative class indexes from the end, as the plain
    gather does)."""
    ok = cls < c
    col = torch.where(cls < 0, cls + c, cls).long().clamp(0, c - 1)
    word = torch.gather(words, 1, (col >> 6)[None, :]
                        .expand(words.shape[0], -1))
    return ok[None, :] & (((word >> (col & 63)[None, :]) & 1) == 1)


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
                            strata=(5, 15), chunk: int | None = None,
                            method: str = "exact"):
    """The plain version: score_pods over pod chunks of ``chunk`` rows
    (all rows when None), each reduced to (chunk, k) before the next chunk
    is scored.  Rows are independent, so every chunking gives the same
    bits.  ``method`` is the reduction, "exact" or "approx".  Returns
    (cand_key, cand_node, cand_score), each (P, k) int32."""
    _check_method(method)
    k = min(k, state.capacity)
    p = pods.capacity
    step = p if chunk is None else max(1, min(chunk, p))
    outs = []
    for start in range(0, p, step):
        sub = _pod_rows(pods, start, min(start + step, p))
        scores, feasible = score_pods(state, sub, cfg)
        outs.append(_reduce_candidates(scores, feasible, tuple(strata), k,
                                       sub.rot_id, method))
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


#: the reductions of the kernel: K1 ranks exactly, K1a by the approx key
KERNEL_METHODS = ("exact", "approx")


def _check_method(method: str) -> None:
    if method not in KERNEL_METHODS:
        raise ValueError(f"unknown reduction {method!r}; one of "
                         f"{KERNEL_METHODS}")


def select_candidates_kernel(state: ClusterState, pods: PodBatch,
                             cfg: ScoringConfig, k: int = 32,
                             strata=(5, 15), chunk: int | None = None,
                             method: str = "exact", ranked=None):
    """K1's wrapper: (cand_key, cand_node, cand_score), each (P, k) int32.
    ``method="approx"`` launches K1a, the instances whose lists rank by
    the approx key: in the packed regime the int32 one
    (:func:`approx_rank_int32`) over the rows off the band
    (:func:`approx_band`) and the 64-bit one (:func:`approx_rank`) over
    the band's, in the wide regime the 64-bit one over every row.
    ``ranked``, a (2,) int32 CUDA tensor, gets the rows K1a's int32 and
    64-bit instances ranked added to it, as the kernel counts them.

    CPU tensors take :func:`select_candidates_plain` (``chunk`` sets its
    pod-chunk width).  CUDA tensors launch the kernel, which streams the
    node axis and never writes a (P, N) tensor, so ``chunk`` does not
    apply to it."""
    strata = tuple(strata)
    _check_method(method)
    check_node_capacity(state.capacity)
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds):
        return select_candidates_plain(state, pods, cfg, k, strata, chunk,
                                       method)

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
    # K1a's key per stratum; a share of every column ranks exactly, as
    # (shift, d) = (15, 0) makes the packed approx key the exact one
    shifts = []
    for sb_i, k_i in zip(sb, ks):
        if method == "exact":
            shifts += [0, 0]
        elif k_i < n:
            shifts += list(approx_shifts(sb_i, n))
        else:
            shifts += [_TB_BITS, 0]   # k_i >= n only in the packed regime
    lib = build.lib()
    rows = torch.empty(lib.koord_select_candidates_scratch_bytes(n),
                       dtype=torch.uint8, device=dev)
    # the selector rows as words, packed by the kernel's launch
    words = (None if sel is None else
             torch.empty((p, -(-c // 64)), dtype=torch.int64, device=dev))
    if ranked is not None:
        build.expect(ranked, "ranked", torch.int32, (2,))
        if ranked.device != dev:
            raise ValueError(f"ranked: on {ranked.device}, expected {dev}")
    launched = ctypes.c_int(0)
    err = lib.koord_select_candidates(
        build.ptr(state.node_allocatable), build.ptr(state.node_requested),
        build.ptr(state.node_usage), build.ptr(base),
        build.ptr(state.node_valid), build.ptr(state.node_class),
        build.ptr(pods.requests), build.ptr(est), build.ptr(pods.valid),
        build.ptr(pods.rot_id), build.ptr(sel), c, build.ptr(words),
        build.ptr(feas_t),
        build.ptr(cfgv), cfgv.numel(), p, n, len(strata),
        sb[0], sb[1], ks[0], ks[1], int(method == "approx"), *shifts,
        build.ptr(rows), build.ptr(ranked), build.ptr(key), build.ptr(node),
        build.ptr(score), ctypes.addressof(launched), build.stream_of(key))
    name = "select_candidates" + ("_approx" if method == "approx" else "")
    build.check(err, name)
    build.LAUNCHES[name] += launched.value   # K1a packed: two instances
    return key, node, score
