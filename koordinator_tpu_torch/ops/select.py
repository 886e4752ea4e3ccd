"""Shared top-k selection idiom for allocation kernels (port of
``koordinator_tpu/ops/select.py``).

Both the cpuset accumulator (ops/numa.take_cpus) and the device allocator
(ops/deviceshare.allocate_on_node) reduce to: order candidates by a
lexicographic priority, take the first k eligible.  :func:`lexsort` is
``jnp.lexsort``: the LAST key is the primary one, and the order is stable,
so it sorts stably by each key in turn from the first (least significant)
to the last.  :func:`segment_sum` and :func:`gather` are the JAX semantics
of ``jax.ops.segment_sum`` (out-of-range ids dropped) and of array
indexing (out-of-range indices clamped) that these modules rely on.
"""

from __future__ import annotations

import torch


def lexsort(keys) -> torch.Tensor:
    """(C,) int64 order of ``keys`` (a sequence of (C,) tensors, the last
    one primary), as ``jnp.lexsort`` gives it.  Bool keys sort False
    first."""
    order = None
    for key in keys:
        if key.dtype == torch.bool:
            key = key.to(torch.int8)
        if order is None:
            order = torch.sort(key, stable=True).indices
        else:
            order = order[torch.sort(key[order], stable=True).indices]
    return order


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num: int
                ) -> torch.Tensor:
    """``jax.ops.segment_sum`` along the last axis, int32: (..., C) values
    summed into (..., num) by ``ids``; ids outside [0, num) are dropped."""
    ok = (ids >= 0) & (ids < num)
    out = torch.zeros(values.shape[:-1] + (num,), dtype=torch.int32,
                      device=values.device)
    return out.scatter_add_(-1, torch.where(ok, ids, 0).long(),
                            torch.where(ok, values.to(torch.int32), 0))


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along the last axis as JAX indexes: a negative index
    counts from the end, and an index still out of range is clamped."""
    n = table.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()
    if table.dim() == 1:
        return table[idx]
    return torch.gather(table, -1, idx)


def int32_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a Python int or a tensor) as an int32 tensor on ``like``'s
    device, as the JAX functions take their ``jnp.int32`` scalars."""
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


def take_by_rank(keys, eligible: torch.Tensor, k
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ((C,) bool selection, ok).  Selection is empty unless at
    least k eligible candidates exist."""
    c = eligible.shape[0]
    order = lexsort(keys)
    rank = torch.empty(c, dtype=torch.int32, device=eligible.device)
    rank[order] = torch.arange(c, dtype=torch.int32, device=eligible.device)
    selected = (rank < k) & eligible
    ok = torch.sum(selected, dtype=torch.int32) >= k
    return selected & ok, ok
