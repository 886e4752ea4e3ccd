"""Reservation-aware scheduling (port of ``koordinator_tpu/ops/reservation.py``).

A Reservation (scheduling.koordinator.sh/v1alpha1) holds capacity on a node
for the pods its owner matchers select.  The scheduler charges a
reservation's whole reserved vector to its node's ``node_requested`` when it
becomes Available, so plain pods cannot see that capacity; these functions
hand the *remaining* (reserved - allocated) back to owner-matched pods only.

The Available set is a fixed-capacity tensor struct (:class:`ReservationSet`,
V rows) and the restore / fit / score logic is batched over
(pods x reservations) and (pods x nodes).

Allocate policies:
- Aligned (default): an owner pod allocates from the reservation first and
  any spill comes from ordinary node free capacity.
- Restricted: for every resource the reservation names, the pod's request
  must fit within the reservation's remainder; unreserved dims spill to node
  free capacity.
AllocateOnce: the first owner that allocates consumes the whole reservation.

:func:`reservation_greedy_assign` is the reservation-first exact scan the
scheduler's pre-pass runs: on CUDA tensors the K4r kernel
(``kernels/greedy_scan.py``), on CPU tensors its plain version,
``ops/assignment.py`` :func:`greedy_scan_plain`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops import scoring
from koordinator_tpu_torch.state.cluster_state import (
    ClusterState,
    PodBatch,
    _bucket,
)

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class ReservationSet:
    """Fixed-capacity padded reservation tensors (V rows)."""

    valid: torch.Tensor          # (V,) bool — row holds an Available reservation
    node_idx: torch.Tensor       # (V,) int32 — node the reservation sits on, -1 none
    reserved: torch.Tensor       # (V, R) int32 — total reserved
    allocated: torch.Tensor      # (V, R) int32 — allocated to owner pods
    allocate_once: torch.Tensor  # (V,) bool
    restricted: torch.Tensor     # (V,) bool — Restricted vs Aligned policy

    def replace(self, **changes) -> "ReservationSet":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def active(self) -> torch.Tensor:
        """(V,) bool — row holds a valid reservation placed on a node."""
        return self.valid & (self.node_idx >= 0)

    @property
    def remaining(self) -> torch.Tensor:
        """(V, R) reserved-but-unallocated, zero for invalid/unplaced rows."""
        return torch.where(self.active[:, None],
                           self.reserved - self.allocated, 0)

    @classmethod
    def zeros(cls, capacity: int = 16, dims: int = NUM_RESOURCE_DIMS,
              device=None) -> "ReservationSet":
        dev = resolve_device(device)
        return cls(
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
            node_idx=torch.full((capacity,), -1, dtype=torch.int32,
                                device=dev),
            reserved=torch.zeros((capacity, dims), dtype=torch.int32,
                                 device=dev),
            allocated=torch.zeros((capacity, dims), dtype=torch.int32,
                                  device=dev),
            allocate_once=torch.zeros(capacity, dtype=torch.bool, device=dev),
            restricted=torch.zeros(capacity, dtype=torch.bool, device=dev),
        )

    @classmethod
    def build(
        cls,
        reserved: np.ndarray,           # (V, R)
        node_idx: np.ndarray,           # (V,)
        allocated: np.ndarray | None = None,
        allocate_once: np.ndarray | None = None,
        restricted: np.ndarray | None = None,
        capacity: int | None = None,
        device=None,
    ) -> "ReservationSet":
        dev = resolve_device(device)
        n = len(reserved)
        cap = capacity or _bucket(max(n, 1), minimum=16)
        dims = reserved.shape[1] if n else NUM_RESOURCE_DIMS

        def pad2(a):
            out = np.zeros((cap, dims), np.int32)
            out[:n] = a
            return torch.from_numpy(out).to(dev)

        def pad1(a, fill, dtype):
            out = np.full(cap, fill, dtype)
            if a is not None:
                out[:n] = a
            return torch.from_numpy(out).to(dev)

        valid = np.zeros(cap, bool)
        valid[:n] = True
        return cls(
            valid=torch.from_numpy(valid).to(dev),
            node_idx=pad1(np.asarray(node_idx, np.int32), -1, np.int32),
            reserved=pad2(reserved),
            allocated=pad2(allocated if allocated is not None
                           else np.zeros_like(reserved)),
            allocate_once=pad1(allocate_once, False, bool),
            restricted=pad1(restricted, False, bool),
        )


def reservation_fit(
    rsv: ReservationSet,
    node_free: torch.Tensor,   # (N, R) free WITHOUT reservation remainders
    requests: torch.Tensor,    # (P, R)
    match: torch.Tensor,       # (P, V) owner-matcher result (host-computed)
) -> torch.Tensor:
    """(P, V) bool — pod p could allocate through reservation v on its node,
    per allocate policy."""
    # the JAX gather clamps an index past the end to the last row
    rows = rsv.node_idx.clamp(0, node_free.shape[0] - 1).long()
    free_at = node_free[rows]                       # (V, R)
    rem = rsv.remaining                             # (V, R)
    # exhausted rows (a consumed allocate-once) are no reservation anyone
    # can allocate through, and get no score boost
    active = rsv.active & (rem > 0).any(-1)
    req = requests[:, None, :]                      # (P, 1, R)
    # a dimension the pod does not request never excludes (free may be
    # negative there after allocatable shrank)
    unrequested = req == 0
    aligned_ok = ((req <= (rem + free_at)[None]) | unrequested).all(-1)
    dim_reserved = rsv.reserved > 0                 # (V, R)
    restricted_ok = (
        torch.where(dim_reserved[None], req <= rem[None], req <= free_at[None])
        | unrequested
    ).all(-1)
    fits = torch.where(rsv.restricted[None, :], restricted_ok, aligned_ok)
    return fits & match & active[None, :]


def reservation_node_mask(
    fits: torch.Tensor,        # (P, V)
    rsv: ReservationSet,
    n_nodes: int,
) -> torch.Tensor:
    """(P, N) bool — node has at least one fitting matched reservation."""
    placed = (rsv.node_idx >= 0) & (rsv.node_idx < n_nodes)
    p_idx, v_idx = (fits & placed[None, :]).nonzero(as_tuple=True)
    out = torch.zeros((fits.shape[0], n_nodes), dtype=torch.bool,
                      device=fits.device)
    out[p_idx, rsv.node_idx[v_idx].long()] = True
    return out


def nominate_reservation(
    fits: torch.Tensor,        # (P, V)
    rsv: ReservationSet,
    node: torch.Tensor,        # (P,) chosen node per pod
) -> torch.Tensor:
    """(P,) int32 — the reservation each pod allocates through, -1 for none.

    Among fitting matched reservations on the chosen node, the one with the
    smallest total remainder (best fit keeps big reservations whole); ties
    to the lowest row."""
    on_node = (fits & (rsv.node_idx[None, :] == node[:, None])
               & (node[:, None] >= 0))
    # the JAX package sums int32 in int32: wrap the int64 sum the same way
    total_rem = rsv.remaining.sum(-1).to(torch.int32)    # (V,)
    keyed = torch.where(on_node, total_rem[None, :], INT32_MAX)
    best = torch.argmin(keyed, dim=-1)                   # first minimum
    has = on_node.any(-1)
    return torch.where(has, best, -1).to(torch.int32)


def allocate_from_reservation(
    rsv: ReservationSet,
    r_idx,                     # int or () tensor, -1 = no reservation
    request: torch.Tensor,     # (R,)
) -> tuple[ReservationSet, torch.Tensor]:
    """Charge one pod's allocation to a reservation row.

    Returns (new_rsv, spill): spill is the part of the request NOT covered
    by the reservation remainder (to be charged to the node).  An
    allocate-once row that is active is consumed whole (allocated :=
    reserved)."""
    r = int(r_idx)
    if r < 0:
        return rsv, request
    rem = rsv.remaining[r]
    take = torch.minimum(request, rem)
    spill = request - take
    allocated = rsv.allocated.clone()
    if bool(rsv.active[r]) and bool(rsv.allocate_once[r]):
        allocated[r] = rsv.reserved[r]
    else:
        allocated[r] = rsv.allocated[r] + take
    return rsv.replace(allocated=allocated), spill


def score_pods_with_reservations(
    state: ClusterState,
    pods: PodBatch,
    cfg,
    rsv: ReservationSet,
    match: torch.Tensor,       # (P, V)
    boost: int = 10_000,
):
    """Batched Filter+Score with reservation restore.

    Returns (scores, feasible, fits): feasibility is extended to nodes
    reachable only through a matched reservation, and such nodes get a score
    boost.  The restore extends *fit* only: the LoadAware usage threshold
    still filters an overloaded node for owner pods."""
    from koordinator_tpu_torch.ops.assignment import _threshold_mask, score_pods

    scores, feasible = score_pods(state, pods, cfg)
    fits = reservation_fit(rsv, state.free, pods.requests, match)
    via_rsv = reservation_node_mask(fits, rsv, state.capacity)
    pod_est = scoring.estimate_pod_usage_by_band(
        pods.requests, cfg.estimator_factors, cfg.estimator_defaults)
    via_rsv = (
        via_rsv
        & _threshold_mask(cfg, state.node_usage, state.node_agg_usage,
                          state.node_allocatable, pod_est)
        & pods.feasible_rows(state)
        & state.node_valid[None, :]
        & pods.valid[:, None]
    )
    feasible = feasible | via_rsv
    scores = scores + torch.where(via_rsv, boost, 0).to(scores.dtype)
    return scores, feasible, fits


def reservation_greedy_assign(
    state: ClusterState,
    pods: PodBatch,
    cfg,
    rsv: ReservationSet,
    match: torch.Tensor,       # (P, V) bool
    quota=None,
    boost: int = 10_000,
):
    """Sequential assignment with reservation-first accounting: each step
    extends feasibility with the pod's matched reservations, prefers
    reserved nodes, and charges the chosen reservation's remainder first
    and only the spill to ``node_requested``.

    Returns (assignments, rsv_choice, new_state, new_rsv, new_quota).  The
    K4r kernel's wrapper: CPU tensors take :func:`greedy_scan_plain`."""
    # imported here: the kernel module imports ops.assignment
    from koordinator_tpu_torch.kernels import greedy_scan

    return greedy_scan.reservation_scan_kernel(
        state, pods, cfg, rsv, match, quota, boost)
