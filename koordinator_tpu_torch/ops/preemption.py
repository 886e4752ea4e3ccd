"""Batched preemption: victim selection, node choice and the preemption
chain (port of ``koordinator_tpu/ops/preemption.py``).

koordinator's PostFilter (elasticquota ``SelectVictimsOnNode``, the
Coscheduling job preemption, the reservation PostFilter) removes every
candidate from a node, checks the preemptor fits, then reprieves the
candidates most-important-first, PDB-violating ones first; a candidate stays
evicted only when adding it back would break the node fit or push the quota
past its limit.  The node is then chosen by ``pickOneNodeForPreemption``'s
lexicographic rule.

The JAX package runs the reprieve as ONE scan over the globally sorted
candidate list.  Each scan step touches only its candidate's node row, so the
scan splits exactly into independent per-node walks, each in the node's own
reprieve order; the plain versions here (``*_plain``) walk every node at once,
one candidate of each node a step.  On CUDA tensors :func:`select_victims`,
:func:`preempt_one` and :func:`preempt_chain` run K5
(``kernels/preemption.py``: one persistent launch a call, a warp per node
for the dry run over the rows in node order that a PostFilter's calls
share; after each preemptor the CTAs meet once, every CTA then chooses the
node and applies the commit to its own copies of the PDB budgets and the
assumed quota, and the node's owner updates the node).

int32 semantics follow the reference: ``free + freed``, ``headroom + freed``,
the chain's ``base - assumed`` and the per-node priority sums wrap; the
importance key ``-priority`` wraps too, so a candidate at priority -2**31
sorts as the most important.  The reference's PDB segment id ``node * B +
pdb`` is an int32 product whose bound ``N * B`` the JAX package cannot even
form at 2**31 or more (``jnp.where`` raises ``OverflowError``); below it no
segment id wraps, and the port raises the same error there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.quota.admission import HEADROOM_CLAMP
from koordinator_tpu_torch.state.cluster_state import ClusterState

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
#: sentinel priority placed below any real koordinator priority band
NEG_PRI = INT32_MIN + 1
#: fully-open quota headroom for preemptors without a quota inside
#: :func:`preempt_chain` (the admission clamp)
HEADROOM_OPEN = HEADROOM_CLAMP


def wrap32(x):
    """The reference's int32 wrap: an int64 tensor reduced to an int32
    tensor, or a Python int or a numpy int64 array reduced to its int32
    two's complement value (the kernels' mirrors)."""
    out = ((x + 2**31) & 0xFFFFFFFF) - 2**31
    return out.to(torch.int32) if torch.is_tensor(out) else out


def importance_key(priority: torch.Tensor) -> torch.Tensor:
    """int32 ``-priority`` as the reference's int32 negation computes it
    (-2**31 stays -2**31): candidates sort by it ascending, then by row."""
    return wrap32(-priority.to(torch.int64))


@dataclasses.dataclass
class ScheduledPods:
    """Bound (running) pods: the victim-candidate universe. Shape (V, ...)."""

    requests: torch.Tensor         # (V, R) int32
    node: torch.Tensor             # (V,) int32 node row the pod is bound to
    priority: torch.Tensor         # (V,) int32
    quota_id: torch.Tensor         # (V,) int32, -1 = none
    non_preemptible: torch.Tensor  # (V,) bool
    pdb_id: torch.Tensor           # (V,) int32, -1 = no PDB matches
    valid: torch.Tensor            # (V,) bool
    # K5's rows in node order (kernels/preemption.py victim_csr), carried
    # by every replace(): rebuilt where a field they were gathered from is
    # no longer the same tensor.  Not one of the reference's fields.
    csr: object | None = dataclasses.field(default=None, compare=False,
                                           repr=False)

    def replace(self, **changes) -> "ScheduledPods":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.requests.shape[0]

    @classmethod
    def build(
        cls,
        requests: np.ndarray,          # (v, R)
        node: np.ndarray,              # (v,)
        priority: np.ndarray | None = None,
        quota_id: np.ndarray | None = None,
        non_preemptible: np.ndarray | None = None,
        pdb_id: np.ndarray | None = None,
        capacity: int | None = None,
        device=None,
    ) -> "ScheduledPods":
        """Padded to ``max(8, next power of two)`` rows, as the reference
        pads, so that victim rows index alike."""
        dev = resolve_device(device)
        v = len(requests)
        cap = (capacity if capacity is not None
               else max(8, 1 << max(v - 1, 0).bit_length()))
        req = np.zeros((cap, requests.shape[1] if v else NUM_RESOURCE_DIMS),
                       np.int32)
        req[:v] = requests

        def pad1(a, fill, dtype):
            out = np.full(cap, fill, dtype=dtype)
            if a is not None:
                out[:v] = a
            return torch.from_numpy(out).to(dev)

        valid = np.zeros(cap, bool)
        valid[:v] = True
        return cls(
            requests=torch.from_numpy(req).to(dev),
            node=pad1(node, -1, np.int32),
            priority=pad1(priority, 0, np.int32),
            quota_id=pad1(quota_id, -1, np.int32),
            non_preemptible=pad1(non_preemptible, False, bool),
            pdb_id=pad1(pdb_id, -1, np.int32),
            valid=torch.from_numpy(valid).to(dev),
        )


def _fits(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """(..., R) fit check with the fit_mask convention (req == 0 never
    blocks)."""
    return torch.all((req <= free) | (req == 0), dim=-1)


def check_pdb_segments(node_capacity: int, n_pdbs: int) -> None:
    """Raise where the reference cannot form its PDB segment ids: ``N * B``
    must be an int32 (``_pdb_violating``'s sentinel segment)."""
    if node_capacity * n_pdbs > INT32_MAX:
        raise OverflowError(
            f"PDB segment ids node * B + pdb overflow int32 at "
            f"{node_capacity} node rows x {n_pdbs} PDBs (the JAX reference "
            "raises here too)")


def candidates(sched: ScheduledPods, preemptor_pri, preemptor_quota,
               same_quota_only) -> torch.Tensor:
    """(V,) bool victim candidates: valid, strictly lower priority,
    preemptible, bound, and (``same_quota_only``, a Python bool or a bool
    tensor) in the preemptor's quota."""
    cand = (sched.valid & (sched.priority < preemptor_pri)
            & ~sched.non_preemptible & (sched.node >= 0))
    if isinstance(same_quota_only, bool):
        if same_quota_only:
            cand = cand & (sched.quota_id == preemptor_quota)
    else:
        cand = cand & (~same_quota_only
                       | (sched.quota_id == preemptor_quota))
    return cand


def _pdb_violating(cand, order, node, pdb_id, pdb_allowed,
                   node_capacity: int) -> torch.Tensor:
    """(V,) bool: per-(node, pdb) rank in importance order >= the PDB's
    remaining budget (filterPodsWithPDBViolation): walking a node's
    candidates most-important-first, each PDB match takes one from that
    budget, and a candidate that takes it below zero is violating."""
    b = pdb_allowed.shape[0]
    check_pdb_segments(node_capacity, b)
    v = node.shape[0]
    has_pdb = cand & (pdb_id >= 0)
    seg = torch.where(has_pdb,
                      node.to(torch.int64) * b
                      + torch.clamp(pdb_id, min=0).to(torch.int64),
                      node_capacity * b)
    seg_in_order = seg[order]
    pos = torch.sort(seg_in_order, stable=True).indices
    seg_sorted = seg_in_order[pos]
    csum = torch.arange(v, device=node.device)
    is_start = torch.ones(v, dtype=torch.bool, device=node.device)
    is_start[1:] = seg_sorted[1:] != seg_sorted[:-1]
    start = torch.cummax(torch.where(is_start, csum, 0), dim=0).values
    rank_sorted = csum - start
    rank_in_order = torch.empty_like(rank_sorted)
    rank_in_order[pos] = rank_sorted
    rank = torch.empty_like(rank_in_order)
    rank[order] = rank_in_order
    # the reference's gather clamps an index past the last budget
    allowed = pdb_allowed[torch.clamp(pdb_id, 0, b - 1).long()]
    return has_pdb & (rank >= allowed)


@dataclasses.dataclass
class VictimSolve:
    """Per-node dry-run result for one preemptor."""

    eligible: torch.Tensor        # (N,) bool: the preemptor fits after
    victim: torch.Tensor          # (V,) bool: victims (across all nodes)
    violating: torch.Tensor       # (V,) bool: PDB-violating candidates
    num_victims: torch.Tensor     # (N,) int32
    num_violating: torch.Tensor   # (N,) int32
    max_victim_pri: torch.Tensor  # (N,) int32 (NEG_PRI when none)
    sum_victim_pri: torch.Tensor  # (N,) int32, wrapping


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """int32 segment sum (wrapping) of ``values`` (V, ...) by ``seg``."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=torch.int64,
                      device=values.device)
    out.index_add_(0, seg.long(), values.to(torch.int64))
    return wrap32(out)


def select_victims_plain(
    state: ClusterState,
    sched: ScheduledPods,
    preemptor_req: torch.Tensor,    # (R,) int32
    preemptor_pri,                  # () int32
    preemptor_quota,                # () int32, -1 = none
    pod_feasible: torch.Tensor,     # (N,) bool
    pdb_allowed: torch.Tensor,      # (B,) int32
    quota_headroom: torch.Tensor | None = None,   # (R,) int32
    same_quota_only=False,
) -> VictimSolve:
    """The JAX package's ``select_victims``, its scan split into the
    per-node walks: step t takes the t-th candidate of every node in that
    node's reprieve order (violating first, then the rest, each by
    importance: ``-priority`` ascending, row ascending)."""
    n_cap = state.capacity
    dev = sched.requests.device
    v = sched.capacity
    cand = candidates(sched, preemptor_pri, preemptor_quota, same_quota_only)
    pri_key = torch.where(cand, sched.priority, NEG_PRI)
    neg = importance_key(pri_key)
    imp_order = torch.sort(neg, stable=True).indices
    violating = _pdb_violating(cand, imp_order, sched.node, sched.pdb_id,
                               pdb_allowed, n_cap)

    safe_node = torch.clamp(sched.node, min=0)
    cand_i = cand.to(torch.int32)
    freed = _segment_sum(sched.requests * cand_i[:, None], safe_node, n_cap)
    free_all = state.free + freed
    has_cand = _segment_sum(cand_i, safe_node, n_cap) > 0
    quota_free = (None if quota_headroom is None
                  else quota_headroom[None, :] + freed)

    # each node's candidates in reprieve order: stable sorts from the last
    # key to the first over the rows in ascending order
    rows = torch.nonzero(cand).flatten()
    rows = rows[torch.sort(neg[rows], stable=True).indices]
    rows = rows[torch.sort(torch.where(violating[rows], 0, 1),
                           stable=True).indices]
    rows = rows[torch.sort(sched.node[rows], stable=True).indices]
    nd = sched.node[rows].long()
    m = rows.shape[0]
    victim = torch.zeros(v, dtype=torch.bool, device=dev)
    if m:
        idx = torch.arange(m, device=dev)
        is_start = torch.ones(m, dtype=torch.bool, device=dev)
        is_start[1:] = nd[1:] != nd[:-1]
        t = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
        by_t = torch.sort(t, stable=True).indices
        counts = torch.bincount(t).tolist()
        at = 0
        for count in counts:
            sel = by_t[at:at + count]
            at += count
            rr, nn = rows[sel], nd[sel]
            req = sched.requests[rr]
            ok = _fits(preemptor_req, free_all[nn] - req)
            if quota_free is not None:
                ok = ok & _fits(preemptor_req, quota_free[nn] - req)
            dec = torch.where(ok[:, None], req, 0)
            free_all[nn] = free_all[nn] - dec
            if quota_free is not None:
                quota_free[nn] = quota_free[nn] - dec
            victim[rr] = ~ok

    eligible = (_fits(preemptor_req, free_all) & pod_feasible
                & state.node_valid & has_cand)
    if quota_free is not None:
        eligible = eligible & _fits(preemptor_req, quota_free)
    num_victims = _segment_sum(victim.to(torch.int32), safe_node, n_cap)
    num_violating = _segment_sum((victim & violating).to(torch.int32),
                                 safe_node, n_cap)
    v_pri = torch.where(victim, sched.priority, NEG_PRI)
    max_victim_pri = torch.full((n_cap,), INT32_MIN, dtype=torch.int32,
                                device=dev)
    max_victim_pri.scatter_reduce_(0, safe_node.long(), v_pri, "amax")
    max_victim_pri = torch.where(num_victims > 0, max_victim_pri, NEG_PRI)
    sum_victim_pri = _segment_sum(torch.where(victim, sched.priority, 0),
                                  safe_node, n_cap)
    return VictimSolve(
        eligible=eligible, victim=victim, violating=violating,
        num_victims=num_victims, num_violating=num_violating,
        max_victim_pri=max_victim_pri, sum_victim_pri=sum_victim_pri)


def pick_node(solve: VictimSolve) -> torch.Tensor:
    """pickOneNodeForPreemption's lexicographic rule: 1. fewest PDB
    violations, 2. lowest highest-victim priority, 3. lowest priority sum,
    4. fewest victims, 5. lowest node row.  Returns () int32 node row, -1
    when no node is eligible."""
    mask = solve.eligible
    for key in (solve.num_violating, solve.max_victim_pri,
                solve.sum_victim_pri, solve.num_victims):
        key_m = torch.where(mask, key, INT32_MAX)
        mask = mask & (key == torch.min(key_m))
    n = mask.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=mask.device)
    first = torch.min(torch.where(mask, rows, n))
    return torch.where(torch.any(solve.eligible), first, -1).to(torch.int32)


@dataclasses.dataclass
class PreemptionOutcome:
    node: torch.Tensor            # () int32, -1 = preemption does not help
    victims: torch.Tensor         # (V,) bool: victims on the chosen node
    state: ClusterState           # victims removed, preemptor nominated
    sched: ScheduledPods          # victims invalidated
    pdb_allowed: torch.Tensor     # (B,) decremented for evicted members


def _commit(state, sched, pdb_allowed, preemptor_req, node, victim,
            nominate: bool):
    """preempt_one's commit: the victims on ``node`` leave, the preemptor
    is nominated there, their PDBs pay."""
    chosen = victim & (sched.node == node) & (node >= 0)
    removed = _segment_sum(sched.requests * chosen.to(torch.int32)[:, None],
                           torch.clamp(sched.node, min=0), state.capacity)
    requested = state.node_requested - removed
    if nominate:
        nom = torch.where(node >= 0, preemptor_req, 0)
        row = torch.clamp(node, min=0).long()
        requested[row] = requested[row] + nom
    b = pdb_allowed.shape[0]
    hit = chosen & (sched.pdb_id >= 0) & (sched.pdb_id < b)
    pdb_hit = _segment_sum(hit.to(torch.int32),
                           torch.clamp(sched.pdb_id, 0, b - 1), b)
    return PreemptionOutcome(
        node=node, victims=chosen,
        state=state.replace(node_requested=requested),
        sched=sched.replace(valid=sched.valid & ~chosen),
        pdb_allowed=pdb_allowed - pdb_hit)


def preempt_one_plain(state, sched, preemptor_req, preemptor_pri,
                      preemptor_quota, pod_feasible, pdb_allowed,
                      quota_headroom=None, same_quota_only=False,
                      nominate: bool = True) -> PreemptionOutcome:
    """The JAX package's ``preempt_one``: dry run, pick a node, commit."""
    solve = select_victims_plain(
        state, sched, preemptor_req, preemptor_pri, preemptor_quota,
        pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
        same_quota_only=same_quota_only)
    node = pick_node(solve)
    return _commit(state, sched, pdb_allowed, preemptor_req, node,
                   solve.victim, nominate)


@dataclasses.dataclass
class ChainOutcome:
    """Per-preemptor results of :func:`preempt_chain` (leading axis C)."""

    node: torch.Tensor            # (C,) int32, -1 = failed or inactive
    victims: torch.Tensor         # (C, V) bool
    state: ClusterState           # after every successful preemptor
    sched: ScheduledPods
    pdb_allowed: torch.Tensor     # (B,)
    #: (Q, R) the quota the chain's successes charged (the preemptors'
    #: requests less their victims'), by quota row; the reference keeps it
    #: inside its scan
    assumed: torch.Tensor | None = None


def open_headroom(base_headroom, dims: int, device) -> torch.Tensor:
    """The chain's (Q, R) base headroom: fully open when None."""
    if base_headroom is None:
        return torch.full((1, dims), HEADROOM_OPEN, dtype=torch.int32,
                          device=device)
    return base_headroom.to(torch.int32)


def preempt_chain_plain(state, sched, reqs, pris, qids, feasible,
                        same_quota, active, pdb_allowed,
                        base_headroom) -> ChainOutcome:
    """The JAX package's ``preempt_chain`` as a loop over the preemptors:
    each runs :func:`preempt_one_plain` against the carry (node accounting,
    valid rows, PDB budgets, and the quota charged by earlier successes:
    victims release to their own quota rows, the preemptor charges its
    own); failed or inactive rows leave the carry untouched."""
    base_hr = open_headroom(base_headroom, reqs.shape[1], reqs.device)
    q_rows = base_hr.shape[0]
    requested, valid, pdb = state.node_requested, sched.valid, pdb_allowed
    assumed = torch.zeros_like(base_hr)
    nodes, victims = [], []
    for j in range(reqs.shape[0]):
        qid, sq = qids[j], same_quota[j]
        # the reference's gather clamps the row
        safe_q = torch.clamp(qid, 0, q_rows - 1).long()
        hr = torch.where(sq, base_hr[safe_q] - assumed[safe_q], HEADROOM_OPEN)
        hr = torch.clamp(hr, -HEADROOM_OPEN, HEADROOM_OPEN)
        out = preempt_one_plain(
            state.replace(node_requested=requested),
            sched.replace(valid=valid), reqs[j], pris[j], qid, feasible[j],
            pdb, quota_headroom=hr, same_quota_only=sq)
        ok = active[j] & (out.node >= 0)
        chosen = out.victims & ok
        in_q = chosen & (sched.quota_id >= 0) & (sched.quota_id < q_rows)
        vic_by_q = _segment_sum(
            sched.requests * in_q.to(torch.int32)[:, None],
            torch.clamp(sched.quota_id, 0, q_rows - 1), q_rows)
        assumed = assumed - vic_by_q
        if bool(ok & (qid >= 0) & (qid < q_rows)):
            assumed[safe_q] = assumed[safe_q] + reqs[j]
        if bool(ok):
            requested = out.state.node_requested
            valid = out.sched.valid
            pdb = out.pdb_allowed
        nodes.append(torch.where(ok, out.node, -1))
        victims.append(chosen)
    v = sched.capacity
    return ChainOutcome(
        node=(torch.stack(nodes).to(torch.int32) if nodes else
              torch.zeros(0, dtype=torch.int32, device=reqs.device)),
        victims=(torch.stack(victims) if victims else
                 torch.zeros((0, v), dtype=torch.bool, device=reqs.device)),
        state=state.replace(node_requested=requested),
        sched=sched.replace(valid=valid), pdb_allowed=pdb, assumed=assumed)


# -- the entry points: K5 on CUDA tensors, the plain versions on the CPU ------


def select_victims(state, sched, preemptor_req, preemptor_pri,
                   preemptor_quota, pod_feasible, pdb_allowed,
                   quota_headroom=None, same_quota_only=False) -> VictimSolve:
    """Dry-run victim selection on every node at once (K5's dry run on CUDA
    tensors, :func:`select_victims_plain` on the CPU).
    ``same_quota_only=True`` gives elastic-quota semantics (canPreempt): only
    lower-priority pods of the preemptor's quota are candidates, and
    ``quota_headroom`` gates the reprieve; False gives the job-preemption
    rule (any lower-priority preemptible pod)."""
    # imported here: the kernel module imports this one
    from koordinator_tpu_torch.kernels import preemption as k5

    return k5.select_victims_kernel(
        state, sched, preemptor_req, preemptor_pri, preemptor_quota,
        pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
        same_quota_only=same_quota_only)


def preempt_one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
                pod_feasible, pdb_allowed, quota_headroom=None,
                same_quota_only=False,
                nominate: bool = True) -> PreemptionOutcome:
    """Full PostFilter for one preemptor: dry run, pick a node, commit (the
    victims' requests leave the node accounting, they are invalidated, their
    PDBs pay, and with ``nominate`` the preemptor's request is reserved on
    the chosen node).  K5 on CUDA tensors."""
    from koordinator_tpu_torch.kernels import preemption as k5

    return k5.preempt_one_kernel(
        state, sched, preemptor_req, preemptor_pri, preemptor_quota,
        pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
        same_quota_only=same_quota_only, nominate=nominate)


def preempt_chain(state, sched, reqs, pris, qids, feasible, same_quota,
                  active, pdb_allowed, base_headroom) -> ChainOutcome:
    """C single-pod PostFilters in order, each seeing the earlier ones'
    commits: the same as :func:`preempt_one` per preemptor with the host's
    commit in between (``same_quota`` picks the elastic-quota rule per row,
    whose headroom is ``base_headroom`` less what earlier rows charged, and
    the other rows run against ``HEADROOM_OPEN``).  K5 on CUDA tensors: one
    launch a chain, no host synchronisation between the preemptors."""
    from koordinator_tpu_torch.kernels import preemption as k5

    return k5.preempt_chain_kernel(state, sched, reqs, pris, qids, feasible,
                                   same_quota, active, pdb_allowed,
                                   base_headroom)
