"""Cluster state as fixed-capacity padded tensors (port of
``koordinator_tpu/state/cluster_state.py``).

- **Fixed capacity + masks.** State tensors are allocated at a power-of-two
  capacity and carry validity masks; padded rows are invalid.
- **Delta scatter updates.** The host keeps a name -> row map and ships only
  changed rows.  Where the JAX code donated the (N, R) buffer to a jitted
  row-set, the port writes the rows in place with ``index_copy_``.
- **Integer exactness.** Resource math is int32 in canonical units
  (see api/resources.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.device import resolve_device

#: Per-dimension quantity bound: integer score/percentage math multiplies by
#: 100, so quantities must stay below 2^31/100 to avoid int32 overflow.
MAX_QUANTITY = (2**31 - 1) // 100


def _check_bounds(a: np.ndarray | None, what: str) -> None:
    if a is not None and np.asarray(a).size and np.asarray(a).max() > MAX_QUANTITY:
        raise ValueError(
            f"{what} exceeds MAX_QUANTITY={MAX_QUANTITY}; rescale units "
            "(see api/resources.py)"
        )


def _bucket(n: int, minimum: int = 64) -> int:
    """Smallest power-of-two capacity >= n."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class ClusterState:
    """Per-node tensors, shape (N, R) / (N,). N is the padded node capacity."""

    node_allocatable: torch.Tensor  # (N, R) int32
    node_requested: torch.Tensor    # (N, R) int32 — requests of pods bound to the node
    node_usage: torch.Tensor        # (N, R) int32 — latest real usage (NodeMetric)
    node_agg_usage: torch.Tensor    # (N, R) int32 — aggregated percentile usage
    node_prod_usage: torch.Tensor   # (N, R) int32 — usage by prod-band pods only
    node_valid: torch.Tensor        # (N,)  bool
    #: (N,) int32 label/taint equivalence-class id per node (pod
    #: feasibility factors into a (P, C) selector mask + this map)
    node_class: torch.Tensor

    def replace(self, **changes) -> "ClusterState":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.node_allocatable.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_allocatable.device

    @property
    def free(self) -> torch.Tensor:
        """(N, R) request-free capacity; 0 for invalid nodes."""
        free = self.node_allocatable - self.node_requested
        return torch.where(self.node_valid[:, None], free, 0)

    @classmethod
    def zeros(cls, capacity: int, dims: int = NUM_RESOURCE_DIMS,
              device=None) -> "ClusterState":
        dev = resolve_device(device)

        def z():
            return torch.zeros((capacity, dims), dtype=torch.int32, device=dev)

        return cls(
            node_allocatable=z(),
            node_requested=z(),
            node_usage=z(),
            node_agg_usage=z(),
            node_prod_usage=z(),
            node_valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
            node_class=torch.zeros(capacity, dtype=torch.int32, device=dev),
        )

    @classmethod
    def from_arrays(
        cls,
        allocatable: np.ndarray,
        requested: np.ndarray | None = None,
        usage: np.ndarray | None = None,
        agg_usage: np.ndarray | None = None,
        prod_usage: np.ndarray | None = None,
        capacity: int | None = None,
        node_class: np.ndarray | None = None,
        device=None,
    ) -> "ClusterState":
        """Build padded device state from (n, R) host arrays of n real nodes."""
        dev = resolve_device(device)
        n, dims = allocatable.shape
        cap = capacity if capacity is not None else _bucket(n)
        _check_bounds(allocatable, "node allocatable")

        def pad(a):
            out = np.zeros((cap, dims), dtype=np.int32)
            if a is not None:
                out[:n] = a
            return torch.from_numpy(out).to(dev)

        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        nclass = np.zeros(cap, dtype=np.int32)
        if node_class is not None:
            nclass[:n] = node_class
        return cls(
            node_allocatable=pad(allocatable),
            node_requested=pad(requested),
            node_usage=pad(usage),
            node_agg_usage=pad(agg_usage if agg_usage is not None else usage),
            node_prod_usage=pad(prod_usage if prod_usage is not None else usage),
            node_valid=torch.from_numpy(valid).to(dev),
            node_class=torch.from_numpy(nclass).to(dev),
        )

    def scatter_update(self, rows: torch.Tensor, **updates: torch.Tensor
                       ) -> "ClusterState":
        """Apply a delta IN PLACE: replace the given rows of the named
        tensors (``index_copy_``; the JAX code's donated row-set).

        ``rows`` is (K,) int64/int32; each value is (K, R) (or (K,) for
        masks).  Returns ``self`` for chaining."""
        rows = rows.to(device=self.device, dtype=torch.long)
        for name, value in updates.items():
            cur = getattr(self, name)
            cur.index_copy_(0, rows, value.to(device=cur.device,
                                              dtype=cur.dtype))
        return self

    def gather_rows(self, rows: torch.Tensor,
                    row_valid: torch.Tensor | None = None) -> "ClusterState":
        """Sub-state of the given node rows (shape (K, R) / (K,));
        ``row_valid`` additionally masks padded entries of ``rows``."""
        rows = rows.to(device=self.device, dtype=torch.long)
        valid = self.node_valid[rows]
        if row_valid is not None:
            valid = valid & row_valid
        return ClusterState(
            node_allocatable=self.node_allocatable[rows],
            node_requested=self.node_requested[rows],
            node_usage=self.node_usage[rows],
            node_agg_usage=self.node_agg_usage[rows],
            node_prod_usage=self.node_prod_usage[rows],
            node_valid=valid,
            node_class=self.node_class[rows],
        )


#: PodBatch fields that are per-pod along axis 0 (gathered by compact())
_POD_FIELDS = ("requests", "priority", "qos", "gang_id", "quota_id",
               "non_preemptible", "valid", "rot_id", "feasible",
               "selector_mask")


@dataclasses.dataclass
class PodBatch:
    """A batch of pending pods, shape (P, R) / (P,). P is padded pod capacity.

    Placement constraints come in one of two forms: the factored
    ``selector_mask`` (P, C) over node equivalence classes, expanded as
    ``selector_mask[:, node_class]``, or a dense (P, N) ``feasible`` mask.
    Exactly one is set; use :meth:`feasible_rows`.
    """

    requests: torch.Tensor    # (P, R) int32
    priority: torch.Tensor    # (P,) int32
    qos: torch.Tensor         # (P,) int8
    gang_id: torch.Tensor     # (P,) int32, -1 = not in a gang
    quota_id: torch.Tensor    # (P,) int32, -1 = none
    non_preemptible: torch.Tensor  # (P,) bool
    valid: torch.Tensor       # (P,) bool
    #: (P,) int32 tie-break rotation identity of the candidate ranking
    rot_id: torch.Tensor
    feasible: torch.Tensor | None       # (P, N) bool dense mask, or None
    selector_mask: torch.Tensor | None  # (P, C) bool class mask, or None

    def replace(self, **changes) -> "PodBatch":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.requests.shape[0]

    @property
    def device(self) -> torch.device:
        return self.requests.device

    def feasible_rows(self, state: ClusterState) -> torch.Tensor:
        """(P, N) feasibility, expanding the factored form.  A node whose
        class id is outside the selector-mask width is infeasible for every
        pod (fail safe: the pod retries against a rebuilt batch)."""
        if self.feasible is not None:
            return self.feasible
        c = self.selector_mask.shape[1]
        in_range = state.node_class < c
        nc = torch.clamp(state.node_class, max=c - 1).long()
        return self.selector_mask[:, nc] & in_range[None, :]

    def feasible_row(self, state: ClusterState, idx) -> torch.Tensor:
        """(N,) feasibility of one pod (cheap in the factored form)."""
        if self.feasible is not None:
            return self.feasible[idx]
        c = self.selector_mask.shape[1]
        in_range = state.node_class < c
        nc = torch.clamp(state.node_class, max=c - 1).long()
        return self.selector_mask[idx][nc] & in_range

    def compact(self, keep, min_capacity: int = 32
                ) -> tuple["PodBatch", np.ndarray]:
        """(small_batch, kept_indices): gather the ``keep`` rows into a new
        batch padded to a power-of-two capacity; padded rows are invalid."""
        keep = keep.cpu().numpy() if torch.is_tensor(keep) else keep
        idx = np.flatnonzero(np.asarray(keep))
        cap = max(min_capacity, 1 << (max(len(idx), 1) - 1).bit_length())
        pad = np.zeros(cap, np.int64)
        pad[: len(idx)] = idx
        gidx = torch.from_numpy(pad).to(self.device)
        valid_pad = np.zeros(cap, bool)
        valid_pad[: len(idx)] = True

        small = {}
        for name in _POD_FIELDS:
            a = getattr(self, name)
            small[name] = None if a is None else a.index_select(0, gidx)
        small["valid"] = small["valid"] & torch.from_numpy(valid_pad).to(
            self.device)
        return PodBatch(**small), idx

    @classmethod
    def build(
        cls,
        requests: np.ndarray,
        priority: np.ndarray | None = None,
        qos: np.ndarray | None = None,
        gang_id: np.ndarray | None = None,
        quota_id: np.ndarray | None = None,
        non_preemptible: np.ndarray | None = None,
        feasible: np.ndarray | None = None,
        selector_mask: np.ndarray | None = None,
        node_capacity: int = 64,
        class_capacity: int = 1,
        capacity: int | None = None,
        rot_id: np.ndarray | None = None,
        device=None,
    ) -> "PodBatch":
        dev = resolve_device(device)
        p, dims = requests.shape
        cap = capacity if capacity is not None else _bucket(p)
        _check_bounds(requests, "pod requests")

        req = np.zeros((cap, dims), dtype=np.int32)
        req[:p] = requests

        def t(a):
            return torch.from_numpy(a).to(dev)

        def pad1(a, fill, dtype):
            out = np.full(cap, fill, dtype=dtype)
            if a is not None:
                out[:p] = a
            return t(out)

        if feasible is not None:
            feas = np.zeros((cap, node_capacity), dtype=bool)
            feas[:p, : feasible.shape[1]] = feasible
            feas_arr, sel_arr = t(feas), None
        else:
            sel = np.zeros((cap, class_capacity), dtype=bool)
            if selector_mask is not None:
                sel[:p, : selector_mask.shape[1]] = selector_mask
            else:
                sel[:p] = True  # unconstrained pods allow every class
            feas_arr, sel_arr = None, t(sel)

        valid = np.zeros(cap, dtype=bool)
        valid[:p] = True
        # rotation identity defaults to the batch row; padded rows keep
        # their row index (inert: invalid)
        rot = np.arange(cap, dtype=np.int32)
        if rot_id is not None:
            rot[:p] = rot_id

        return cls(
            requests=t(req),
            priority=pad1(priority, 0, np.int32),
            qos=pad1(qos, 0, np.int8),
            gang_id=pad1(gang_id, -1, np.int32),
            quota_id=pad1(quota_id, -1, np.int32),
            non_preemptible=pad1(non_preemptible, False, bool),
            valid=t(valid),
            rot_id=t(rot),
            feasible=feas_arr,
            selector_mask=sel_arr,
        )
