"""K5: the preemption dry run, the node choice and the commit, chained over
the preemptors (``csrc/victim_select.cu``).

The wrappers :func:`select_victims_kernel`, :func:`preempt_one_kernel` and
:func:`preempt_chain_kernel` take the plain versions of
``ops/preemption.py`` on CPU tensors.  On CUDA tensors they build, once a
call, the CSR of the bound rows by node (:func:`victim_csr`: each node's
live rows in importance order) and launch, for each preemptor, K5a (a warp
per node: the candidate mask, the PDB ranks 32 rows at a time, the reprieve
walk with the lanes holding the resource dimensions) and K5b (one CTA: the
lexicographic choice over the nodes and the commit), all on the current
stream with no host synchronisation between preemptors.  A launch the card
refuses raises.

:func:`preempt_chain_mirror` runs the same decomposition in Python (the
per-node walk over the CSR, the 32-row PDB chunks with their carry from
the earlier chunks, the choice and the commit) so that the CPU tests can
hold the order the kernel computes in against the reference's global scan.

The chain's (C, V) victim mask keeps the reference's shape: at C = 256 and
V = 262,144 it is 64 MiB on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.ops.preemption import (
    HEADROOM_OPEN,
    INT32_MIN,
    NEG_PRI,
    ChainOutcome,
    PreemptionOutcome,
    VictimSolve,
    check_pdb_segments,
    importance_key,
    open_headroom,
    preempt_chain_plain,
    preempt_one_plain,
    select_victims_plain,
    wrap32,
)

WARP = 32
#: quota modes of K5a's fit test (csrc/victim_select.cu): none, one (R,)
#: headroom, the chain's per-row (Q, R) base less what earlier rows charged
NO_QUOTA, HEADROOM, CHAIN = 0, 1, 2
#: rows of the per-node dry-run record (csrc/victim_select.cu kNode*)
NODE_FIELDS = ("eligible", "num_violating", "max_victim_pri",
               "sum_victim_pri", "num_victims")


def victim_csr(sched, n_cap: int):
    """The bound rows by node: (offsets (N + 1,), rows (M,), row_count (N,))
    int32.  ``rows[offsets[n]:offsets[n + 1]]`` are node n's valid rows in
    importance order (``-priority`` as int32 ascending, row ascending): the
    reference's importance order restricted to the node.  ``row_count[n]``
    counts every row of the universe whose ``max(node, 0)`` is n (valid or
    not), as the reference's per-node maximum reduces over them."""
    dev = sched.node.device
    node = sched.node
    live = sched.valid & (node >= 0) & (node < n_cap)
    rows = torch.nonzero(live).flatten()
    key = ((node[rows].to(torch.int64) << 32)
           | (importance_key(sched.priority[rows]).to(torch.int64) + 2**31))
    rows = rows[torch.sort(key, stable=True).indices]
    counts = torch.bincount(node[rows].long(), minlength=n_cap)[:n_cap]
    offsets = torch.zeros(n_cap + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    row_count = torch.bincount(torch.clamp(node, min=0).long(),
                               minlength=n_cap)[:n_cap]
    return (offsets.to(torch.int32), rows.to(torch.int32),
            row_count.to(torch.int32))


def _scalar_rows(x, dtype, device) -> torch.Tensor:
    """A Python scalar or a 0-d tensor as a (1,) tensor on ``device`` (no
    host synchronisation for a tensor already there)."""
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(1)


class ChainLaunch:
    """K5's buffers for one call: copies of the carry (node accounting,
    valid rows, PDB budgets, the chain's assumed quota), the CSR, the
    per-node dry-run record and the outputs.  :meth:`launch` runs K5a, and
    K5b unless only the dry run is asked for, over a range of
    preemptors."""

    def __init__(self, state, sched, reqs, pris, qids, feasible, same_quota,
                 active, pdb_allowed, quota_mode: int, headroom=None,
                 nominate: bool = True):
        n, r = state.capacity, NUM_RESOURCE_DIMS
        v, c = sched.capacity, reqs.shape[0]
        b = pdb_allowed.shape[0]
        check_pdb_segments(n, b)
        for name in ("node_allocatable", "node_requested"):
            build.expect(getattr(state, name), name, torch.int32, (n, r))
        build.expect(state.node_valid, "node_valid", torch.bool, (n,))
        build.expect(sched.requests, "sched.requests", torch.int32, (v, r))
        for name in ("node", "priority", "quota_id", "pdb_id"):
            build.expect(getattr(sched, name), f"sched.{name}", torch.int32,
                         (v,))
        for name in ("non_preemptible", "valid"):
            build.expect(getattr(sched, name), f"sched.{name}", torch.bool,
                         (v,))
        build.expect(reqs, "reqs", torch.int32, (c, r))
        build.expect(pris, "pris", torch.int32, (c,))
        build.expect(qids, "qids", torch.int32, (c,))
        build.expect(feasible, "feasible", torch.bool, (c, n))
        build.expect(same_quota, "same_quota", torch.bool, (c,))
        build.expect(active, "active", torch.bool, (c,))
        build.expect(pdb_allowed, "pdb_allowed", torch.int32, (b,))
        q = 0
        if quota_mode == HEADROOM:
            build.expect(headroom, "headroom", torch.int32, (r,))
        elif quota_mode == CHAIN:
            q = headroom.shape[0]
            build.expect(headroom, "base_headroom", torch.int32, (q, r))
        dev = reqs.device
        self.offsets, self.rows, self.row_count = victim_csr(sched, n)
        m = self.rows.shape[0]
        self.requested = state.node_requested.clone()
        self.valid = sched.valid.clone()
        self.pdb = pdb_allowed.clone()
        self.assumed = (torch.zeros_like(headroom) if quota_mode == CHAIN
                        else None)
        self.flags = torch.empty(max(m, 1), dtype=torch.uint8, device=dev)
        self.pkey = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
        self.node_rec = torch.empty((len(NODE_FIELDS), n), dtype=torch.int32,
                                    device=dev)
        self.nodes = torch.full((c,), -1, dtype=torch.int32, device=dev)
        self.victims = torch.zeros((c, v), dtype=torch.bool, device=dev)
        self.c, self.m = c, m
        self._inputs = (state, sched, reqs, pris, qids, feasible, same_quota,
                        active, headroom)
        self._args = [
            build.ptr(state.node_allocatable), build.ptr(self.requested),
            build.ptr(state.node_valid), n,
            build.ptr(sched.requests), build.ptr(sched.priority),
            build.ptr(sched.quota_id), build.ptr(sched.non_preemptible),
            build.ptr(sched.pdb_id), build.ptr(self.valid), v,
            build.ptr(self.offsets), build.ptr(self.rows),
            build.ptr(self.row_count),
            build.ptr(reqs), build.ptr(pris), build.ptr(qids),
            build.ptr(feasible), build.ptr(same_quota), build.ptr(active), c,
            build.ptr(self.pdb), b,
            quota_mode,
            build.ptr(headroom) if quota_mode == HEADROOM else None,
            build.ptr(headroom) if quota_mode == CHAIN else None,
            build.ptr(self.assumed), q,
            int(nominate),
            build.ptr(self.flags), build.ptr(self.pkey),
            build.ptr(self.node_rec), build.ptr(self.nodes),
            build.ptr(self.victims),
        ]

    def launch(self, first: int = 0, count: int | None = None,
               commit: bool = True) -> None:
        """K5a, then with ``commit`` K5b, for each of the preemptors
        [first, first + count) in order; each launch adds to its kernel's
        count."""
        count = self.c - first if count is None else count
        if count <= 0:
            return
        lib = build.lib()
        err = lib.koord_preempt_chain(*self._args, first, count, int(commit),
                                      build.stream_of(self.requested))
        build.check(err, "preempt_chain")
        build.LAUNCHES["victim_select"] += count
        if commit:
            build.LAUNCHES["victim_commit"] += count

    def solve(self) -> VictimSolve:
        """The last dry run's :class:`VictimSolve` (victim and violating
        flags scattered back from the CSR positions to the rows)."""
        sched = self._inputs[1]
        v = sched.capacity
        rec = self.node_rec
        rows = self.rows.long()
        flags = self.flags[: self.m]
        victim = torch.zeros(v, dtype=torch.bool, device=rec.device)
        violating = torch.zeros_like(victim)
        victim[rows] = (flags & 1).bool()
        violating[rows] = (flags & 2).bool()
        return VictimSolve(
            eligible=rec[0].bool(), victim=victim, violating=violating,
            num_victims=rec[4].clone(), num_violating=rec[1].clone(),
            max_victim_pri=rec[2].clone(), sum_victim_pri=rec[3].clone())


def select_victims_kernel(state, sched, preemptor_req, preemptor_pri,
                          preemptor_quota, pod_feasible, pdb_allowed,
                          quota_headroom=None,
                          same_quota_only=False) -> VictimSolve:
    """K5a's wrapper: the dry run for one preemptor
    (:func:`select_victims_plain` on CPU tensors)."""
    if build.on_cpu(state.node_allocatable, sched.requests, preemptor_req,
                    pdb_allowed):
        return select_victims_plain(
            state, sched, preemptor_req, preemptor_pri, preemptor_quota,
            pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
            same_quota_only=same_quota_only)
    run = _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
               pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
               True)
    run.launch(commit=False)
    return run.solve()


def _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
         pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
         nominate) -> ChainLaunch:
    dev = preemptor_req.device
    return ChainLaunch(
        state, sched, preemptor_req.reshape(1, -1).contiguous(),
        _scalar_rows(preemptor_pri, torch.int32, dev),
        _scalar_rows(preemptor_quota, torch.int32, dev),
        pod_feasible.reshape(1, -1).contiguous(),
        _scalar_rows(same_quota_only, torch.bool, dev),
        torch.ones(1, dtype=torch.bool, device=dev), pdb_allowed,
        NO_QUOTA if quota_headroom is None else HEADROOM,
        headroom=quota_headroom, nominate=nominate)


def preempt_one_kernel(state, sched, preemptor_req, preemptor_pri,
                       preemptor_quota, pod_feasible, pdb_allowed,
                       quota_headroom=None, same_quota_only=False,
                       nominate: bool = True) -> PreemptionOutcome:
    """K5's wrapper for one preemptor (:func:`preempt_one_plain` on CPU
    tensors); the inputs are not modified."""
    if build.on_cpu(state.node_allocatable, sched.requests, preemptor_req,
                    pdb_allowed):
        return preempt_one_plain(
            state, sched, preemptor_req, preemptor_pri, preemptor_quota,
            pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
            same_quota_only=same_quota_only, nominate=nominate)
    run = _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
               pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
               nominate)
    run.launch()
    return PreemptionOutcome(
        node=run.nodes[0], victims=run.victims[0],
        state=state.replace(node_requested=run.requested),
        sched=sched.replace(valid=run.valid), pdb_allowed=run.pdb)


def preempt_chain_kernel(state, sched, reqs, pris, qids, feasible,
                         same_quota, active, pdb_allowed,
                         base_headroom) -> ChainOutcome:
    """K5's chain wrapper (:func:`preempt_chain_plain` on CPU tensors): two
    launches a preemptor; the inputs are not modified."""
    if build.on_cpu(state.node_allocatable, sched.requests, reqs,
                    pdb_allowed):
        return preempt_chain_plain(state, sched, reqs, pris, qids, feasible,
                                   same_quota, active, pdb_allowed,
                                   base_headroom)
    base_hr = open_headroom(base_headroom, reqs.shape[1],
                            reqs.device).contiguous()
    run = ChainLaunch(state, sched, reqs, pris, qids, feasible, same_quota,
                      active, pdb_allowed, CHAIN, headroom=base_hr)
    run.launch()
    return ChainOutcome(
        node=run.nodes, victims=run.victims,
        state=state.replace(node_requested=run.requested),
        sched=sched.replace(valid=run.valid), pdb_allowed=run.pdb,
        assumed=run.assumed)


# -- the CPU mirror of K5's decomposition ------------------------------------


def preempt_chain_mirror(state, sched, reqs, pris, qids, feasible,
                         same_quota, active, pdb_allowed, quota_mode: int,
                         headroom=None, commit: bool = True) -> dict:
    """K5 step by step in Python, on numpy copies of the inputs: for each
    preemptor, K5a's walk of every node (:func:`_dry_run_node`) and, with
    ``commit``, K5b's choice and commit (:func:`_commit_mirror`).  Returns
    the outputs as numpy arrays: ``nodes`` (C,), ``victims`` (C, V),
    ``requested``, ``valid``, ``pdb``, ``assumed`` (CHAIN mode), and the
    last dry run's per-node record ``node_rec`` (5, N) and CSR ``flags`` /
    ``rows``."""

    def np_(t):
        return None if t is None else t.detach().cpu().numpy()

    offsets, rows, row_count = (np_(t) for t in victim_csr(
        sched, state.capacity))
    ctx = dict(
        alloc=np_(state.node_allocatable).astype(np.int64),
        requested=np_(state.node_requested).astype(np.int64),
        node_valid=np_(state.node_valid),
        requests=np_(sched.requests).astype(np.int64),
        priority=np_(sched.priority).astype(np.int64),
        quota_id=np_(sched.quota_id), nonp=np_(sched.non_preemptible),
        pdb_id=np_(sched.pdb_id), valid=np_(sched.valid).copy(),
        offsets=offsets, rows=rows, row_count=row_count,
        pdb=np_(pdb_allowed).astype(np.int64),
        flags=np.zeros(len(rows), np.int64),
        pkey=np.zeros(len(rows), np.int64))
    reqs, pris, qids = np_(reqs), np_(pris), np_(qids)
    feasible, same_quota, active = np_(feasible), np_(same_quota), np_(active)
    headroom = np_(headroom)
    assumed = (np.zeros_like(headroom, dtype=np.int64)
               if quota_mode == CHAIN else None)
    n, v, c = state.capacity, sched.capacity, reqs.shape[0]
    nodes = np.full(c, -1, np.int32)
    victims = np.zeros((c, v), bool)
    rec = np.zeros((len(NODE_FIELDS), n), np.int64)
    for j in range(c):
        preq = [int(x) for x in reqs[j]]
        if quota_mode == NO_QUOTA:
            hr = None
        elif quota_mode == HEADROOM:
            hr = [int(x) for x in headroom]
        elif same_quota[j]:
            q = min(max(int(qids[j]), 0), headroom.shape[0] - 1)
            hr = [min(max(wrap32(int(headroom[q, d]) - int(assumed[q, d])),
                          -HEADROOM_OPEN), HEADROOM_OPEN)
                  for d in range(len(preq))]
        else:
            hr = [HEADROOM_OPEN] * len(preq)
        for nd in range(n):
            rec[:, nd] = _dry_run_node(
                ctx, nd, preq, int(pris[j]), int(qids[j]),
                bool(same_quota[j]), bool(feasible[j, nd]), hr)
        if commit:
            nodes[j] = _commit_mirror(ctx, rec, j, preq, int(qids[j]),
                                      bool(active[j]), assumed, victims)
    return dict(nodes=nodes, victims=victims,
                requested=wrap32(ctx["requested"]).astype(np.int32),
                valid=ctx["valid"],
                pdb=wrap32(ctx["pdb"]).astype(np.int32),
                assumed=(None if assumed is None else
                         wrap32(assumed).astype(np.int32)),
                node_rec=rec.astype(np.int32), flags=ctx["flags"],
                rows=rows)


def _dry_run_node(ctx, nd: int, preq, ppri: int, pq: int, sq: bool,
                  feasible: bool, hr) -> list[int]:
    """K5a's warp on node ``nd``: pass 1 over the node's CSR rows in chunks
    of 32 (candidate mask; each candidate's rank among the earlier ones of
    its PDB as the popcount of the lower lanes of its chunk with the same
    PDB, ``__match_any_sync``, plus the carry, the count of the earlier
    chunks' candidates of that PDB; violating; the freed vector), pass 2
    the reprieve, violating candidates first, then the others, each in
    CSR order, one candidate a step with the lanes holding the dimensions.
    Writes the CSR flags (bit 0 victim, 1 violating, 2 candidate) and
    returns the node's record (NODE_FIELDS)."""
    start, end = int(ctx["offsets"][nd]), int(ctx["offsets"][nd + 1])
    rows, flags, pkey = ctx["rows"], ctx["flags"], ctx["pkey"]
    b = len(ctx["pdb"])
    dims = len(preq)
    freed = [0] * dims
    has_cand = False
    for base in range(start, end, WARP):
        lanes = range(base, min(base + WARP, end))
        keys = []
        for pos in lanes:
            row = int(rows[pos])
            cand = (bool(ctx["valid"][row]) and ctx["priority"][row] < ppri
                    and not ctx["nonp"][row]
                    and (not sq or int(ctx["quota_id"][row]) == pq))
            pdb = int(ctx["pdb_id"][row]) if cand else -1
            keys.append((pos, row, cand, pdb if pdb >= 0 else -1))
        for i, (pos, row, cand, key) in enumerate(keys):
            # __match_any_sync: the lower lanes of the chunk with this key
            rank = sum(1 for k in keys[:i] if k[3] == key)
            # the carry: the earlier chunks' candidates with this key
            rank += sum(1 for p in range(start, base) if pkey[p] == key)
            pkey[pos] = key
            viol = key >= 0 and rank >= ctx["pdb"][min(key, b - 1)]
            flags[pos] = (4 if cand else 0) | (2 if viol else 0)
            if cand:
                has_cand = True
                for d in range(dims):
                    freed[d] = wrap32(freed[d]
                                      + int(ctx["requests"][row, d]))
    valid_node = bool(ctx["node_valid"][nd])
    free = [wrap32((wrap32(int(ctx["alloc"][nd, d])
                           - int(ctx["requested"][nd, d]))
                    if valid_node else 0) + freed[d]) for d in range(dims)]
    qfree = None if hr is None else [wrap32(hr[d] + freed[d])
                                     for d in range(dims)]
    nvic = nviol = sump = 0
    maxp = INT32_MIN
    for group in (2, 0):          # violating first, then the others
        for pos in range(start, end):
            if flags[pos] & 6 != 4 | group:
                continue
            row = int(rows[pos])
            req = [int(x) for x in ctx["requests"][row]]
            ok = all(p == 0 or p <= wrap32(free[d] - req[d])
                     for d, p in enumerate(preq))
            if qfree is not None:
                ok = ok and all(p == 0 or p <= wrap32(qfree[d] - req[d])
                                for d, p in enumerate(preq))
            if ok:
                free = [wrap32(free[d] - req[d]) for d in range(dims)]
                if qfree is not None:
                    qfree = [wrap32(qfree[d] - req[d])
                             for d in range(dims)]
            else:
                flags[pos] |= 1
                pri = int(ctx["priority"][row])
                nvic += 1
                nviol += group == 2
                maxp = max(maxp, pri)
                sump = wrap32(sump + pri)
    fits = all(p == 0 or p <= free[d] for d, p in enumerate(preq))
    if qfree is not None:
        fits = fits and all(p == 0 or p <= qfree[d]
                            for d, p in enumerate(preq))
    eligible = fits and has_cand and valid_node and feasible
    if nvic == 0:
        maxp = NEG_PRI
    elif maxp < NEG_PRI and int(ctx["row_count"][nd]) > nvic:
        # the reference's maximum also reduces the node's other rows, each
        # at NEG_PRI
        maxp = NEG_PRI
    return [int(eligible), nviol, maxp, sump, nvic]


def _commit_mirror(ctx, rec, j: int, preq, qid: int, active: bool, assumed,
                   victims) -> int:
    """K5b: the lexicographic minimum of (num_violating, max_victim_pri,
    sum_victim_pri, num_victims, row) over the eligible nodes, then, for an
    active row that found one, the commit over the node's CSR range (the
    preemptor nominated there).
    Returns the row's node output (-1 when it failed or is inactive)."""
    best = None
    for nd in range(rec.shape[1]):
        if rec[0, nd]:
            key = (int(rec[1, nd]), int(rec[2, nd]), int(rec[3, nd]),
                   int(rec[4, nd]), nd)
            best = key if best is None or key < best else best
    node = -1 if best is None else best[4]
    if not active or node < 0:
        return -1
    b = len(ctx["pdb"])
    for pos in range(int(ctx["offsets"][node]), int(ctx["offsets"][node + 1])):
        if not ctx["flags"][pos] & 1:
            continue
        row = int(ctx["rows"][pos])
        victims[j, row] = True
        ctx["valid"][row] = False
        ctx["requested"][node] -= ctx["requests"][row]
        pdb = int(ctx["pdb_id"][row])
        if 0 <= pdb < b:
            ctx["pdb"][pdb] -= 1
        q = int(ctx["quota_id"][row])
        if assumed is not None and 0 <= q < assumed.shape[0]:
            assumed[q] -= ctx["requests"][row]
    ctx["requested"][node] += np.asarray(preq, np.int64)
    if assumed is not None and 0 <= qid < assumed.shape[0]:
        assumed[qid] += np.asarray(preq, np.int64)
    return node
