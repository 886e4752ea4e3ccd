"""Network-topology-aware gang placement (port of
``koordinator_tpu/ops/network_topology.py``).

The reference packs a gang onto the network topology tree (spine/block/node
from the ClusterNetworkTopology CRD) by: computing per-node "offer slots" (how
many gang pods fit), aggregating slots/scores/existing-pod counts up the tree,
rounding slots down to per-layer pod-count multiples, picking the deepest
topology node that can hold the whole gang (preferring subtrees with existing
peer pods, then tighter fit, then score), and recursively distributing slots
(``coscheduling/core/network_topology_solver.go:53 PlacePods``, ``:239
constrainOfferSlotByPodCountMultiple``, ``:303 searchOfferSlotSatisfiedNodes``,
``:353 distributeOfferSlot``; tree built per
``frameworkext/networktopology/tree.go:43``).

Split: the offer slots are K8 (``kernels/offer_slots.py``), one call over
all of a round's topology gangs with their node validity folded in
(:func:`gang_offer_slots_many`); the tree
aggregation, layer-multiple rounding, candidate eligibility and
lexicographic ranking are torch ops on the state's device; the recursive
walk over the *chosen* subtree stays host-side Python, as in JAX: it
touches only the T topology nodes, not the N x P problem.

Tree encoding: T topology nodes across L layers (0 = cluster root, L-1 =
physical-node layer).  ``topo_parent`` (T,) parent ids (root points at
itself); ``node_path`` (N, L) gives every physical node's ancestor chain, so
one segment sum of tiled per-node values aggregates the whole tree at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.kernels.offer_slots import offer_slots
from koordinator_tpu_torch.ops.select import gather, lexsort, segment_sum
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch


@dataclasses.dataclass
class TopologyArrays:
    """Device-side encoding of the ClusterNetworkTopology tree."""

    topo_layer: torch.Tensor    # (T,) int32 layer index of each topology node
    topo_parent: torch.Tensor   # (T,) int32 parent topo id; root -> itself
    node_path: torch.Tensor     # (N, L) int32 ancestor topo id per layer
    node_topo: torch.Tensor     # (N,) int32 leaf topo id of each physical node
    topo_to_node: torch.Tensor  # (T,) int32 physical node of a leaf, else -1

    @property
    def num_topo(self) -> int:
        return self.topo_layer.shape[0]

    @property
    def num_layers(self) -> int:
        return self.node_path.shape[1]


@dataclasses.dataclass(frozen=True)
class TopologyRequirements:
    """Gang network requirements (mirrors JobTopologyRequirements,
    ``network_topology_types.go:33``)."""

    desired_slots: int
    must_gather_layer: int = -1       # layer index; -1 = whole cluster
    layer_multiples: tuple = ()       # (L,) pod-count multiple per layer (1 = none)


class TopologyTree:
    """Host-side tree builder: nodes join by their label path (parent->child
    layer names), as tree.AddNode derives TreeNodeMeta from node labels
    (``networktopology/tree.go:108,141``)."""

    def __init__(self, layer_names: list[str]):
        # layer_names: top-down, excluding the implicit cluster root and
        # including the node layer last, e.g. ["spine", "block", "node"].
        self.layer_names = ["cluster", *layer_names]
        self.num_layers = len(self.layer_names)
        self._index: dict[tuple[int, str], int] = {(0, ""): 0}
        self._parent = [0]
        self._layer = [0]
        self._paths: list[np.ndarray] = []
        self._leaf_topo: list[int] = []

    def add_node(self, path: list[str]) -> int:
        """Register a physical node by its label path (one name per non-root
        layer; the last entry is the node's own name).  Returns node index."""
        if len(path) != self.num_layers - 1:
            raise ValueError(
                f"path needs {self.num_layers - 1} entries, got {len(path)}")
        parent = 0
        ids = [0]
        for depth, name in enumerate(path, start=1):
            key = (depth, name)
            tid = self._index.get(key)
            if tid is None:
                tid = len(self._parent)
                self._index[key] = tid
                self._parent.append(parent)
                self._layer.append(depth)
            ids.append(tid)
            parent = tid
        self._paths.append(np.array(ids, np.int32))
        self._leaf_topo.append(parent)
        return len(self._paths) - 1

    def build(self, capacity: int | None = None, device=None
              ) -> TopologyArrays:
        dev = resolve_device(device)
        n = len(self._paths)
        cap = capacity if capacity is not None else n
        t = len(self._parent)
        node_path = np.zeros((cap, self.num_layers), np.int32)
        if n:
            node_path[:n] = np.stack(self._paths)
        node_topo = np.zeros(cap, np.int32)
        node_topo[:n] = self._leaf_topo
        topo_to_node = np.full(t, -1, np.int32)
        for i, tid in enumerate(self._leaf_topo):
            topo_to_node[tid] = i

        def d(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

        return TopologyArrays(topo_layer=d(self._layer),
                              topo_parent=d(self._parent),
                              node_path=d(node_path), node_topo=d(node_topo),
                              topo_to_node=d(topo_to_node))


def gang_offer_slots(state: ClusterState, gang_requests: torch.Tensor,
                     node_valid: torch.Tensor, cfg=None) -> torch.Tensor:
    """(N,) int32: how many gang pods fit on each node, replacing the
    sequential filter-and-add loop (``network_topology_solver.go:113
    calculateNodeOfferSlot``) with a prefix feasibility test (K8).

    ``gang_requests`` is the (P, R) request matrix of the gang's pods
    (invalid rows zero).  Slots on node n = the longest prefix of the pod
    list whose cumulative request fits the node's free capacity.  When
    ``cfg`` (a ScoringConfig) is given, the k-th slot must also pass the
    load-aware usage thresholds with k pods' estimated usage added.
    """
    p = gang_requests.shape[0]
    return offer_slots(state, gang_requests.to(torch.int32).contiguous(),
                       [0, p], p, node_valid[None, :].contiguous(), cfg)[0]


def member_csr(gang_masks) -> tuple[np.ndarray, np.ndarray]:
    """(rows, offsets): the CSR of the gangs' member rows that K8 reads,
    gang k's ``rows[offsets[k]:offsets[k + 1]]``, the set rows of its
    (P,) bool mask in ascending order."""
    rows = [np.flatnonzero(np.asarray(m)) for m in gang_masks]
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    return (np.concatenate(rows) if rows else np.zeros(0, np.int64),
            offsets)


def gang_offer_slots_many(state: ClusterState, pods: PodBatch,
                          gang_masks: list[np.ndarray], cfg=None,
                          feasible: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """(G, N) int32: :func:`gang_candidate_prep`'s offer slots of each
    gang in ``gang_masks`` ((P,) bool member masks over ``pods``' rows),
    in one K8 call over their CSR (:func:`member_csr`): each gang's
    members front-packed in row order, its node validity the state's and
    every member's feasible nodes (``feasible``:
    ``pods.feasible_rows(state)``, computed when None), both folded in the
    kernel."""
    if feasible is None:
        feasible = pods.feasible_rows(state)
    rows, offsets = member_csr(gang_masks)
    return offer_slots(state, pods.requests, offsets, pods.capacity,
                       cfg=cfg, rows=rows, feasible=feasible)


def aggregate_tree(topo: TopologyArrays, offer_slots: torch.Tensor,
                   node_scores: torch.Tensor, node_existing: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum per-physical-node values into every ancestor topology node in one
    segment sum over the tiled (N*L,) ancestor paths
    (``network_topology_solver.go:212 evaluateTopologyNode``).  Only the
    tree's own N rows are summed; the state may be padded larger."""
    t = topo.num_topo
    n = topo.node_path.shape[0]
    seg = topo.node_path.reshape(-1)

    def up(v):
        tiled = torch.repeat_interleave(v[:n], topo.num_layers)
        return segment_sum(tiled, seg[: tiled.shape[0]], t)

    return up(offer_slots), up(node_scores), up(node_existing)


def constrain_multiples(topo: TopologyArrays, topo_slots: torch.Tensor,
                        layer_multiples: torch.Tensor) -> torch.Tensor:
    """Bottom-up rounding of each topology node's slots to its layer's
    pod-count multiple (``network_topology_solver.go:249
    doConstrainOfferSlot``): a node's slots become the sum of its children's
    constrained slots, rounded down to the layer multiple."""
    t = topo.num_topo
    num_layers = layer_multiples.shape[0]
    mults = layer_multiples.tolist()
    slots = topo_slots

    def round_layer(s, layer):
        m = max(int(mults[layer]), 1)
        return torch.where(topo.topo_layer == layer, (s // m) * m, s)

    # Leaf layer rounds in place; each upper layer is rebuilt from children.
    slots = round_layer(slots, num_layers - 1)
    for layer in range(num_layers - 2, -1, -1):
        child = topo.topo_layer == layer + 1
        summed = segment_sum(torch.where(child, slots, 0), topo.topo_parent, t)
        slots = torch.where(topo.topo_layer == layer, summed, slots)
        slots = round_layer(slots, layer)
    return slots


def eligible_candidates(topo: TopologyArrays, topo_slots: torch.Tensor,
                        desired, must_gather_layer
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ok, deepest_layer): ok marks topology nodes reachable by descending
    only through slot-satisfied ancestors from the must-gather layer
    (``network_topology_solver.go:272,303``); deepest_layer is the lowest
    layer containing any candidate: the reference keeps only the last
    (deepest) satisfied layer's candidates."""
    sat = topo_slots >= int(desired)
    start_layer = max(int(must_gather_layer), 0)  # -1 = whole cluster
    ok = sat & (topo.topo_layer == start_layer)
    for _ in range(topo.num_layers - 1):
        ok = ok | (sat & gather(ok, topo.topo_parent)
                   & (topo.topo_layer > start_layer))
    deepest = torch.amax(torch.where(ok, topo.topo_layer, -1))
    return ok & (topo.topo_layer == deepest), deepest


def _ancestor_chain_keys(topo: TopologyArrays, values: torch.Tensor
                         ) -> torch.Tensor:
    """(T, L) matrix: values[t], values[parent(t)], ... padded with the
    root's value: the layer-by-layer comparison chain of
    topologyNodeLessFunc (``network_topology_solver.go:334``)."""
    cols = []
    cur = torch.arange(topo.num_topo, device=values.device)
    for _ in range(topo.num_layers):
        cols.append(gather(values, cur))
        cur = gather(topo.topo_parent, cur)
    return torch.stack(cols, dim=1)


def rank_candidates(topo: TopologyArrays, candidates: torch.Tensor,
                    topo_slots: torch.Tensor, topo_scores: torch.Tensor,
                    topo_existing: torch.Tensor,
                    prefer_lower_slots: bool = True) -> torch.Tensor:
    """Order candidate topology nodes by the reference's lexicographic rule:
    existing peers (desc) up the chain, then offer slots (asc when selecting
    a candidate, desc when filling children) up the chain, then score
    (desc), then id.  Returns topo ids sorted best-first (non-candidates
    last)."""
    ex = _ancestor_chain_keys(topo, topo_existing)
    sl = _ancestor_chain_keys(topo, topo_slots)
    sign = 1 if prefer_lower_slots else -1
    # lexsort: the last key is the primary one
    keys = [torch.arange(topo.num_topo, dtype=torch.int32,
                         device=topo_slots.device), -topo_scores]
    for layer in range(topo.num_layers - 1, -1, -1):
        keys.append(sign * sl[:, layer])
    for layer in range(topo.num_layers - 1, -1, -1):
        keys.append(-ex[:, layer])
    keys.append(~candidates)  # candidates first
    return lexsort(keys)


def _distribute_host(topo_parent: np.ndarray, topo_layer: np.ndarray,
                     topo_to_node: np.ndarray, slots: np.ndarray,
                     scores: np.ndarray, existing: np.ndarray, root: int,
                     desired: int, layer_multiples: np.ndarray
                     ) -> tuple[list[int], list[int]]:
    """Recursive slot distribution over the chosen subtree
    (``network_topology_solver.go:353 distributeOfferSlot``).  Host-side:
    only touches the T-sized tree.  Returns (ordered physical node ids,
    counts)."""
    t = len(topo_parent)
    children: dict[int, list[int]] = {}
    for tid in range(t):
        p = int(topo_parent[tid])
        if p != tid:
            children.setdefault(p, []).append(tid)

    def chain(tid):
        out = [tid]
        while topo_parent[out[-1]] != out[-1]:
            out.append(int(topo_parent[out[-1]]))
        return out

    def sort_key(tid):
        ch = chain(tid)
        return (
            tuple(-existing[c] for c in ch),
            tuple(-slots[c] for c in ch),  # fill higher-slot children first
            -scores[tid],
            tid,
        )

    nodes: list[int] = []
    counts: list[int] = []

    def walk(tid, want) -> int:
        layer = int(topo_layer[tid])
        mult = int(layer_multiples[layer]) if layer < len(layer_multiples) else 1
        take = min(int(slots[tid]), want)
        if mult > 1:
            take = (take // mult) * mult
        phys = int(topo_to_node[tid]) if tid < len(topo_to_node) else -1
        if phys >= 0 or tid not in children:
            if phys >= 0 and take > 0:
                nodes.append(phys)
                counts.append(take)
            return take if phys >= 0 else 0
        got = 0
        for child in sorted(children.get(tid, []), key=sort_key):
            got += walk(child, take - got)
            if got >= take:
                break
        return got

    got = walk(root, desired)
    return (nodes, counts) if got >= desired else ([], [])


def gang_candidate_prep(state: ClusterState, pods: PodBatch,
                        gang_mask: np.ndarray, topo: TopologyArrays,
                        req: TopologyRequirements,
                        node_scores: torch.Tensor | None = None,
                        node_existing: torch.Tensor | None = None,
                        cfg=None, slots: torch.Tensor | None = None):
    """Candidate-prep pipeline of the gang planner: whole-gang node
    feasibility intersection, desired-slots default, member-request
    front-packing, layer-multiple padding, then the offer-slots ->
    tree-aggregation -> multiples -> eligibility chain.  ``slots``, when
    given, are the gang's offer slots already counted
    (:func:`gang_offer_slots_many`'s row).

    Returns ``(member_idx, desired, mults, t_slots, t_scores, t_existing,
    cand)``.
    """
    n = state.capacity
    dev = state.device
    if node_scores is None:
        node_scores = torch.zeros(n, dtype=torch.int32, device=dev)
    if node_existing is None:
        node_existing = torch.zeros(n, dtype=torch.int32, device=dev)
    gang_mask = np.asarray(gang_mask)
    member_idx = np.flatnonzero(gang_mask)
    desired = req.desired_slots if req.desired_slots > 0 else len(member_idx)
    lm = np.asarray(req.layer_multiples or (), np.int32)
    mults = torch.from_numpy(np.pad(
        lm, (0, topo.num_layers - len(lm)), constant_values=1)).to(dev)
    if slots is None:
        slots = gang_offer_slots_many(state, pods, [gang_mask], cfg)[0]
    t_slots, t_scores, t_existing = aggregate_tree(
        topo, slots, node_scores, node_existing)
    t_slots = constrain_multiples(topo, t_slots, mults)
    cand, _ = eligible_candidates(topo, t_slots, desired,
                                  req.must_gather_layer)
    return member_idx, desired, mults, t_slots, t_scores, t_existing, cand


def plan_gang_placement(state: ClusterState, pods: PodBatch,
                        gang_mask: np.ndarray, topo: TopologyArrays,
                        req: TopologyRequirements,
                        node_scores: torch.Tensor | None = None,
                        node_existing: torch.Tensor | None = None,
                        cfg=None, slots: torch.Tensor | None = None
                        ) -> np.ndarray:
    """Full placement plan for one gang: (P,) int32 planned node per gang
    pod (-1 for non-members / infeasible).  Mirrors PlacePods
    (``network_topology_solver.go:53``): the plan is then fed to the solver
    one node at a time (the reference's FindOneNode path).  ``slots`` as
    in :func:`gang_candidate_prep`.
    """
    member_idx, desired, mults, t_slots, t_scores, t_existing, cand = (
        gang_candidate_prep(state, pods, gang_mask, topo, req, node_scores,
                            node_existing, cfg, slots))
    plan = np.full(pods.capacity, -1, np.int32)
    cand_np = cand.cpu().numpy()
    if not cand_np.any():
        return plan
    ranked = rank_candidates(topo, cand, t_slots, t_scores, t_existing)
    # host-side: walk ranked candidates until one distributes fully
    parent_np = topo.topo_parent.cpu().numpy()
    layer_np = topo.topo_layer.cpu().numpy()
    t2n = topo.topo_to_node.cpu().numpy()
    slots_np = t_slots.cpu().numpy()
    scores_np = t_scores.cpu().numpy()
    exist_np = t_existing.cpu().numpy()
    mults_np = mults.cpu().numpy()
    for tid in ranked.cpu().numpy():
        if not cand_np[tid]:
            break
        nodes, counts = _distribute_host(
            parent_np, layer_np, t2n, slots_np, scores_np, exist_np,
            int(tid), desired, mults_np)
        if nodes:
            flat = np.repeat(nodes, counts)[: len(member_idx)]
            plan[member_idx[: len(flat)]] = flat
            return plan
    return plan
