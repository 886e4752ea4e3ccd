"""Elastic-quota admission on device (port of
``koordinator_tpu/quota/admission.py``).

The host flattens the quota tree into an ancestor-chain index matrix (Q, D)
and int32 headroom tensors (int64 headroom clamped: a clamped headroom only
matters when it exceeds any possible pod request).
:func:`quota_admission_mask` answers a whole pod batch at once and
:func:`charge_quota_batch` applies Reserve-time accounting to every ancestor
(``elasticquota/plugin.go`` checkQuotaRecursive, :256-304).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.quota.tree import UNBOUNDED, QuotaTree

#: int32 headroom clamp; far above any single pod request, far below int32
#: max so Reserve-time subtraction cannot underflow across a batch.
HEADROOM_CLAMP = 2**30


@dataclasses.dataclass
class QuotaDeviceState:
    """Flattened quota tree on device. Q quota rows, D max chain depth."""

    headroom: torch.Tensor      # (Q, R) int32: runtime - used, clamped
    min_headroom: torch.Tensor  # (Q, R) int32: min - nonPreemptibleUsed, clamped
    checked: torch.Tensor       # (Q, R) bool: dims declared in the quota's max
    chain: torch.Tensor         # (Q, D) int32 ancestor indices (self first), -1 pad
    valid: torch.Tensor         # (Q,) bool

    def replace(self, **changes) -> "QuotaDeviceState":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.headroom.shape[0]

    @classmethod
    def from_tree(
        cls, tree: QuotaTree, max_depth: int = 8, capacity: int | None = None,
        device=None,
    ) -> tuple["QuotaDeviceState", dict[str, int]]:
        """Flatten; returns (state, name->row index map)."""
        dev = resolve_device(device)
        names = sorted(tree.nodes)
        q = len(names)
        cap = capacity if capacity is not None else max(
            8, 1 << (q - 1).bit_length() if q else 3)
        if cap < q:
            raise ValueError(f"capacity {cap} < {q} quotas in tree")
        index = {n: i for i, n in enumerate(names)}

        headroom = np.zeros((cap, NUM_RESOURCE_DIMS), np.int32)
        min_headroom = np.zeros((cap, NUM_RESOURCE_DIMS), np.int32)
        checked = np.zeros((cap, NUM_RESOURCE_DIMS), bool)
        chain = np.full((cap, max_depth), -1, np.int32)
        valid = np.zeros(cap, bool)

        for name, i in index.items():
            node = tree.nodes[name]
            hr = node.runtime - node.used
            mh = node.min - node.non_preemptible_used
            headroom[i] = np.clip(hr, -HEADROOM_CLAMP, HEADROOM_CLAMP)
            min_headroom[i] = np.clip(mh, -HEADROOM_CLAMP, HEADROOM_CLAMP)
            checked[i] = node.max != UNBOUNDED
            anc = tree.ancestors(name)
            if len(anc) > max_depth:
                raise ValueError(f"quota chain deeper than {max_depth}: {anc}")
            chain[i, : len(anc)] = [index[a] for a in anc]
            valid[i] = True

        def t(a):
            return torch.from_numpy(a).to(dev)

        state = cls(headroom=t(headroom), min_headroom=t(min_headroom),
                    checked=t(checked), chain=t(chain), valid=t(valid))
        return state, index


def quota_admission_mask(
    quota: QuotaDeviceState,
    pod_requests: torch.Tensor,     # (P, R) int32
    pod_quota_id: torch.Tensor,     # (P,) int32, -1 = no quota (always admitted)
    non_preemptible: torch.Tensor | None = None,  # (P,) bool
    check_parents: bool = True,
) -> torch.Tensor:
    """(P,) bool: pod fits its quota chain's headroom on every checked dim.

    The pod request is masked once by its own quota's declared max dims and
    those dims are checked at every ancestor; non-preemptible pods also check
    min headroom at their own quota.
    """
    qid = torch.clamp(pod_quota_id, min=0).long()
    chain = quota.chain[qid]                       # (P, D)
    depth = chain.shape[1] if check_parents else 1
    chain = chain[:, :depth]
    level_ok = chain >= 0
    safe = torch.clamp(chain, min=0).long()

    headroom = quota.headroom[safe]                # (P, D, R)
    checked = quota.checked[qid][:, None, :]       # (P, 1, R)
    req = pod_requests[:, None, :]
    fits = (req <= headroom) | ~checked | (req == 0)
    ok = torch.all(torch.all(fits, dim=-1) | ~level_ok, dim=-1)

    if non_preemptible is not None:
        own = quota.min_headroom[qid]
        np_fits = torch.all(
            (pod_requests <= own) | ~quota.checked[qid] | (pod_requests == 0),
            dim=-1)
        ok = ok & (np_fits | ~non_preemptible)

    # a stale/padded quota row must reject; only quota_id < 0 bypasses
    ok = ok & quota.valid[qid]
    return ok | (pod_quota_id < 0)


def charge_quota_batch(
    quota: QuotaDeviceState,
    requests: torch.Tensor,        # (P, R) int32
    quota_ids: torch.Tensor,       # (P,) int32, -1 = no-op
    mask: torch.Tensor,            # (P,) bool — which pods actually charge
    non_preemptible: torch.Tensor, # (P,) bool
    sign: int = 1,
) -> QuotaDeviceState:
    """Reserve/Unreserve accounting for a pod batch in one scatter-add
    (returns a new state; the input's tensors are not modified)."""
    qid = torch.clamp(quota_ids, min=0).long()
    chain = quota.chain[qid]                  # (P, D)
    active = ((chain >= 0) & (quota_ids >= 0)[:, None] & mask[:, None]
              & quota.valid[qid][:, None])
    safe = torch.clamp(chain, min=0).long()
    delta = torch.where(active[:, :, None], -sign * requests[:, None, :], 0)
    r = requests.shape[-1]
    headroom = quota.headroom.clone().index_add_(
        0, safe.reshape(-1), delta.reshape(-1, r))
    np_active = mask & (quota_ids >= 0) & non_preemptible & quota.valid[qid]
    min_delta = torch.where(np_active[:, None], -sign * requests, 0)
    min_headroom = quota.min_headroom.clone().index_add_(0, qid, min_delta)
    return quota.replace(headroom=headroom, min_headroom=min_headroom)


def charge_quota(
    quota: QuotaDeviceState,
    request: torch.Tensor,    # (R,) int32
    quota_id,                 # () int32, -1 = no-op
    sign: int = 1,
    non_preemptible=False,
) -> QuotaDeviceState:
    """Single-pod convenience wrapper over :func:`charge_quota_batch`."""
    dev = request.device
    return charge_quota_batch(
        quota,
        request[None, :],
        torch.as_tensor(quota_id, dtype=torch.int32, device=dev).reshape(1),
        torch.ones(1, dtype=torch.bool, device=dev),
        torch.as_tensor(non_preemptible, dtype=torch.bool,
                        device=dev).reshape(1),
        sign=sign,
    )
