"""The quota tree and its fair-share runtime calculation (host side, exact;
the port's own copy of ``koordinator_tpu/quota/tree.py``).

Semantics ported from the reference's
``pkg/scheduler/plugins/elasticquota/core/runtime_quota_calculator.go``:

- ``redistribution`` (:119): each child's runtime starts at
  autoScaleMin = max(min, guarantee) if it requests more than that, else at its
  request (or autoScaleMin when the group refuses to lend, allowLentResource
  false). The remaining parent resource is then water-filled over the
  still-hungry children proportionally to sharedWeight, iterating as children
  saturate at their request.
- ``computeHamiltonDeltas`` (:194): each round's pool splits by the largest-
  remainder (Hamilton) method — base_i = floor(w_i * pool / W), then +1 to the
  largest remainders (ties by quota name ascending) until the residual is gone,
  so every round conserves the pool exactly.

The reference does this in int64 with 128-bit intermediates (bits.Mul64);
Python integers are arbitrary-precision, so the math here is exactly
equivalent. This runs at control-plane cadence (quota/request changes), not in
the scheduling hot path — matching the reference, where GroupQuotaManager
caches runtimeQuota between updates. The hot-path admission check runs on
device via :mod:`koordinator_tpu_torch.quota.admission`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS

#: "no limit" sentinel for max (reference: resource absent from Max means
#: unbounded and unchecked at admission).
UNBOUNDED = -1

ROOT = "root"


@dataclasses.dataclass
class QuotaNode:
    name: str
    parent: str
    min: np.ndarray            # (R,) int64
    max: np.ndarray            # (R,) int64, UNBOUNDED = no cap
    shared_weight: np.ndarray  # (R,) int64; defaults to max (reference default)
    guarantee: np.ndarray      # (R,) int64
    allow_lent: bool = True
    #: opt-in to proportional min shrinking when the parent's resource can no
    #: longer cover the children's min sum (scale_minquota_when_over_root_res
    #: semantics; annotation-driven in the reference)
    enable_scale_min: bool = False
    # computed:
    request: np.ndarray = None         # (R,) raw request (pods or children)
    limited_request: np.ndarray = None # (R,) min(request, max)
    runtime: np.ndarray = None         # (R,)
    used: np.ndarray = None            # (R,)
    non_preemptible_used: np.ndarray = None

    def __post_init__(self):
        z = np.zeros(NUM_RESOURCE_DIMS, dtype=np.int64)
        for f in ("request", "limited_request", "runtime", "used",
                  "non_preemptible_used"):
            if getattr(self, f) is None:
                setattr(self, f, z.copy())


def hamilton_deltas(
    pool: int, total_weight: int, weights: list[int], names: list[str]
) -> list[int]:
    """Largest-remainder split of ``pool`` proportional to ``weights``.

    Exact parity with computeHamiltonDeltas (:194): zero-weight entries get
    nothing; residual +1s go to the largest remainders, ties by name asc.
    """
    n = len(weights)
    deltas = [0] * n
    if total_weight <= 0 or pool <= 0 or n == 0:
        return deltas
    remainders = []
    distributed = 0
    for i, w in enumerate(weights):
        if w <= 0:
            continue
        prod = w * pool  # arbitrary precision == the reference's 128-bit path
        base, rem = divmod(prod, total_weight)
        deltas[i] = base
        distributed += base
        remainders.append((i, rem, names[i]))
    residual = pool - distributed
    if residual <= 0 or not remainders:
        return deltas
    remainders.sort(key=lambda e: (-e[1], e[2]))
    for i in range(min(residual, len(remainders))):
        deltas[remainders[i][0]] += 1
    return deltas


class QuotaTree:
    """Hierarchical quota tree with koordinator's runtime semantics."""

    def __init__(self, total_resource: np.ndarray,
                 scale_min_enabled: bool = False):
        self.total_resource = np.asarray(total_resource, dtype=np.int64)
        self.nodes: dict[str, QuotaNode] = {}
        self.children: dict[str, list[str]] = {ROOT: []}
        #: EnableScaleMinQuota feature gate (GroupQuotaManager
        #: scaleMinQuotaEnabled): shrink enable_scale_min children's min
        #: proportionally when a parent's resource drops below the min sum
        self.scale_min_enabled = scale_min_enabled
        # runtime cache: the reference recomputes runtimeQuota only when
        # quota specs or requests change (core/group_quota_manager.go keeps
        # runtime between updates); we fingerprint every input of the
        # water-filling and skip refresh_runtime when nothing moved
        self._runtime_key: tuple | None = None
        self.runtime_refreshes = 0

    def add(
        self,
        name: str,
        min: np.ndarray,
        max: np.ndarray,
        parent: str = ROOT,
        shared_weight: np.ndarray | None = None,
        guarantee: np.ndarray | None = None,
        allow_lent: bool = True,
        enable_scale_min: bool = False,
    ) -> None:
        if name in self.nodes or name == ROOT:
            raise ValueError(f"quota {name!r} already exists")
        if parent != ROOT and parent not in self.nodes:
            raise ValueError(f"parent quota {parent!r} not found")
        mn = np.asarray(min, dtype=np.int64)
        mx = np.asarray(max, dtype=np.int64)
        # sharedWeight defaults to max (reference: GetSharedWeight falls back
        # to Max when the annotation is absent); UNBOUNDED dims weigh as the
        # cluster total.
        if shared_weight is None:
            sw = np.where(mx == UNBOUNDED, self.total_resource, mx)
        else:
            sw = np.asarray(shared_weight, dtype=np.int64)
        g = (np.zeros(NUM_RESOURCE_DIMS, np.int64) if guarantee is None
             else np.asarray(guarantee, dtype=np.int64))
        self.nodes[name] = QuotaNode(
            name=name, parent=parent, min=mn, max=mx,
            shared_weight=sw, guarantee=g, allow_lent=allow_lent,
            enable_scale_min=enable_scale_min,
        )
        self.children.setdefault(name, [])
        self.children[parent].append(name)

    def set_request(self, name: str, request: np.ndarray) -> None:
        """Set a leaf quota's raw pod-request sum."""
        self.nodes[name].request = np.asarray(request, dtype=np.int64)

    def set_used(self, name: str, used: np.ndarray,
                 non_preemptible: np.ndarray | None = None) -> None:
        self.nodes[name].used = np.asarray(used, dtype=np.int64)
        if non_preemptible is not None:
            self.nodes[name].non_preemptible_used = np.asarray(
                non_preemptible, dtype=np.int64
            )

    # -- request aggregation ------------------------------------------------

    def aggregate_requests(self) -> None:
        """limitedRequest = min(request, max) per node; parents' request =
        sum of children's limitedRequest (reference groupReqLimit model)."""
        for name in self._topo_order(reverse=True):
            node = self.nodes[name]
            kids = self.children[name]
            if kids:
                node.request = np.sum(
                    [self.nodes[k].limited_request for k in kids], axis=0,
                    dtype=np.int64,
                )
            node.limited_request = np.where(
                node.max == UNBOUNDED, node.request,
                np.minimum(node.request, node.max),
            )

    # -- runtime ------------------------------------------------------------

    def _fingerprint(self) -> tuple:
        """Every input of the runtime computation, cheap to compare."""
        rows = tuple(
            (name, n.parent,
             # parents' request is derived by aggregation — only leaf
             # requests are true inputs
             n.request.tobytes() if not self.children[name] else b"",
             n.min.tobytes(), n.max.tobytes(), n.shared_weight.tobytes(),
             n.guarantee.tobytes(), n.allow_lent, n.enable_scale_min)
            for name, n in sorted(self.nodes.items())
        )
        return (self.total_resource.tobytes(), self.scale_min_enabled, rows)

    def refresh_runtime(self, force: bool = False) -> bool:
        """Recompute every node's runtime, top-down. No-ops (returns False)
        when no spec/request input changed since the last refresh."""
        key = self._fingerprint()
        if not force and key == self._runtime_key:
            return False
        self.aggregate_requests()
        self._redistribute(self.children[ROOT], self.total_resource)
        for name in self._topo_order():
            kids = self.children[name]
            if kids:
                self._redistribute(kids, self.nodes[name].runtime)
        self._runtime_key = key
        self.runtime_refreshes += 1
        return True

    def _scaled_mins(
        self, names: list[str], total: np.ndarray
    ) -> dict[str, np.ndarray]:
        """Effective per-child min after scale-min-when-over-root-res.

        Per dimension where the children's min sum exceeds the group's total:
        non-scaling children keep their full min; the remainder (total minus
        their sum, floored at 0) is split over scaling children proportional
        to their original min (getScaledMinQuota semantics, floor division).
        """
        mins = {n: self.nodes[n].min.copy() for n in names}
        if not self.scale_min_enabled:
            return mins
        enable = [n for n in names if self.nodes[n].enable_scale_min]
        if not enable:
            return mins
        disable_sum = np.zeros(NUM_RESOURCE_DIMS, np.int64)
        enable_sum = np.zeros(NUM_RESOURCE_DIMS, np.int64)
        for n in names:
            if self.nodes[n].enable_scale_min:
                enable_sum += self.nodes[n].min
            else:
                disable_sum += self.nodes[n].min
        need_scale = (disable_sum + enable_sum) > total
        if not need_scale.any():
            return mins
        avail = np.maximum(total - disable_sum, 0)
        for n in enable:
            orig = self.nodes[n].min
            scaled = np.where(
                enable_sum > 0, avail * orig // np.maximum(enable_sum, 1), 0
            )
            mins[n] = np.where(need_scale, scaled, orig).astype(np.int64)
        return mins

    def _redistribute(self, names: list[str], total: np.ndarray) -> None:
        """redistribution() (:119) independently per resource dimension."""
        # deterministic order = name asc (map iteration in Go is unordered but
        # Hamilton ties are name-broken; we sort for reproducibility)
        names = sorted(names)
        for node in (self.nodes[n] for n in names):
            node.runtime = np.zeros(NUM_RESOURCE_DIMS, dtype=np.int64)
        eff_min = self._scaled_mins(names, np.asarray(total, np.int64))
        for dim in range(NUM_RESOURCE_DIMS):
            self._redistribute_dim(names, int(total[dim]), dim, eff_min)

    def _redistribute_dim(
        self, names: list[str], total: int, dim: int,
        eff_min: dict[str, np.ndarray] | None = None,
    ) -> None:
        to_partition = total
        hungry: list[QuotaNode] = []
        total_weight = 0
        for node in (self.nodes[n] for n in names):
            base_min = (
                int(eff_min[node.name][dim]) if eff_min is not None
                else int(node.min[dim])
            )
            auto_min = max(base_min, int(node.guarantee[dim]))
            request = int(node.limited_request[dim])
            if request > auto_min:
                hungry.append(node)
                total_weight += int(node.shared_weight[dim])
                node.runtime[dim] = auto_min
            else:
                node.runtime[dim] = request if node.allow_lent else auto_min
            to_partition -= int(node.runtime[dim])
        if to_partition > 0:
            self._iterate_dim(to_partition, total_weight, hungry, dim)

    def _iterate_dim(
        self, pool: int, total_weight: int, nodes: list[QuotaNode], dim: int
    ) -> None:
        while pool > 0 and total_weight > 0 and nodes:
            deltas = hamilton_deltas(
                pool, total_weight,
                [int(n.shared_weight[dim]) for n in nodes],
                [n.name for n in nodes],
            )
            still_hungry: list[QuotaNode] = []
            next_weight = 0
            returned = 0
            for node, delta in zip(nodes, deltas):
                node.runtime[dim] += delta
                request = int(node.limited_request[dim])
                if node.runtime[dim] < request:
                    still_hungry.append(node)
                    next_weight += int(node.shared_weight[dim])
                else:
                    returned += int(node.runtime[dim]) - request
                    node.runtime[dim] = request
            pool, total_weight, nodes = returned, next_weight, still_hungry

    # -- traversal ----------------------------------------------------------

    def _topo_order(self, reverse: bool = False) -> Iterable[str]:
        order: list[str] = []
        stack = list(self.children[ROOT])
        while stack:
            name = stack.pop()
            order.append(name)
            stack.extend(self.children[name])
        return reversed(order) if reverse else order

    def ancestors(self, name: str, include_self: bool = True) -> list[str]:
        chain = [name] if include_self else []
        cur = self.nodes[name].parent
        while cur != ROOT:
            chain.append(cur)
            cur = self.nodes[cur].parent
        return chain

    def runtime_of(self, name: str) -> np.ndarray:
        return self.nodes[name].runtime

    def admits(
        self,
        name: str,
        request: np.ndarray,
        non_preemptible: bool = False,
        check_parents: bool = True,
    ) -> bool:
        """Host-side mirror of admission.quota_admission_mask for one pod
        (checkQuotaRecursive, elasticquota/plugin.go:256-304): used + request
        <= runtime on the pod's quota's declared max dims, up the chain."""
        node = self.nodes.get(name)
        if node is None:
            return True  # no quota: always admitted
        req = np.asarray(request, dtype=np.int64)
        checked = (node.max != UNBOUNDED) & (req > 0)
        chain = self.ancestors(name) if check_parents else [name]
        for anc in chain:
            a = self.nodes[anc]
            if np.any(checked & (a.used + req > a.runtime)):
                return False
        if non_preemptible and np.any(
            checked & (node.non_preemptible_used + req > node.min)
        ):
            return False
        return True
