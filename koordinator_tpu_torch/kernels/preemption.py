"""K5: the preemption dry run, the node choice and the commit, chained over
the preemptors in one persistent launch (``csrc/victim_select.cu``).

The wrappers :func:`select_victims_kernel`, :func:`preempt_one_kernel` and
:func:`preempt_chain_kernel` take the plain versions of
``ops/preemption.py`` on CPU tensors.  On CUDA tensors they launch K5 once a
call on the current stream, with no host synchronisation: every CTA
resident, each owning a block of nodes and its own copy of the PDB budgets
and the chain's assumed quota, a warp dry-running a node; after each
preemptor's dry run the CTAs meet once, then each finds the chosen node
from their partial keys and applies the commit to its copies (the node's
owner to the node too).  A launch the card refuses raises, and so does a
grid that cannot be resident.

K5 reads the bound rows in node order (:class:`VictimCSR`): built on the
device with no host synchronisation the first time a PostFilter calls K5,
and carried on the :class:`ScheduledPods` its calls pass along
(``replace(valid=...)`` keeps it), since within a PostFilter only ``valid``
changes, and the kernel reads that itself.

:func:`preempt_chain_mirror` runs the same decomposition in Python (the CTAs'
blocks of nodes and their own budgets and quota, the per-node walk over the
CSR with the 32-row PDB chunks and their carry, the partial keys, each
CTA's choice and its part of the commit, the victim list) so that the CPU
tests can hold the order the kernel computes in against the reference's
global scan.

The chain's (C, V) victim mask keeps the reference's shape: one comparison
of the victim list against the preemptor index fills it after the launch.
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
#: quota modes of K5's fit test (csrc/victim_select.cu): none, one (R,)
#: headroom, the chain's per-row (Q, R) base less what earlier rows charged
NO_QUOTA, HEADROOM, CHAIN = 0, 1, 2
#: ints of a partial key (csrc/victim_select.cu kKeyInts)
KEY_INTS = 5
#: rows of the per-node dry-run record (csrc/victim_select.cu kNode*)
NODE_FIELDS = ("eligible", "num_violating", "max_victim_pri",
               "sum_victim_pri", "num_victims")
#: the fields of ScheduledPods the CSR is gathered from
_CSR_SOURCES = ("node", "priority", "quota_id", "pdb_id", "non_preemptible",
                "requests")


class VictimCSR:
    """The bound rows in node order, every array in CSR order (length V):
    ``rows[offsets[n]:offsets[n + 1]]`` are the rows bound to node n in
    importance order (``-priority`` as int32 ascending, row ascending),
    whatever their validity; the rows bound to no node row follow
    ``offsets[N]``.  ``pri``, ``quota``, ``pdb`` (int32), ``nonp`` (uint8)
    and ``req`` (R, V) are those rows' fields.  ``row_count[n]`` counts
    every row whose ``max(node, 0)`` is n (valid or not), as the
    reference's per-node maximum reduces over them.  Built with one stable
    sort and no host synchronisation."""

    def __init__(self, sched, n_cap: int):
        node = sched.node
        dev = node.device
        self.n = n_cap
        self._sources = tuple(getattr(sched, f) for f in _CSR_SOURCES)
        live = (node >= 0) & (node < n_cap)
        seg = torch.where(live, node, n_cap).to(torch.int64)
        key = (seg << 32) | (importance_key(sched.priority).to(torch.int64)
                             + 2**31)
        order = torch.sort(key, stable=True).indices
        counts = torch.zeros(n_cap + 1, dtype=torch.int64, device=dev)
        counts.index_add_(0, seg, torch.ones_like(seg))
        offsets = torch.zeros(n_cap + 1, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(counts[:n_cap], 0)
        every = torch.where(node < n_cap, torch.clamp(node, min=0),
                            n_cap).to(torch.int64)
        row_count = torch.zeros(n_cap + 1, dtype=torch.int64, device=dev)
        row_count.index_add_(0, every, torch.ones_like(every))
        self.offsets = offsets.to(torch.int32)
        self.rows = order.to(torch.int32)
        self.row_count = row_count[:n_cap].to(torch.int32)
        self.pri = sched.priority[order].contiguous()
        self.quota = sched.quota_id[order].contiguous()
        self.pdb = sched.pdb_id[order].contiguous()
        self.nonp = sched.non_preemptible[order].to(torch.uint8)
        self.req = sched.requests[order].t().contiguous()

    def matches(self, sched, n_cap: int) -> bool:
        """True while ``sched`` holds the very tensors this was built
        from."""
        return n_cap == self.n and all(
            getattr(sched, f) is t for f, t in zip(_CSR_SOURCES,
                                                   self._sources))


def victim_csr(sched, n_cap: int) -> VictimCSR:
    """``sched``'s :class:`VictimCSR`: the one it carries, or a new one
    (then carried by ``sched`` and every ``replace`` of it)."""
    csr = sched.csr
    if csr is None or not csr.matches(sched, n_cap):
        csr = VictimCSR(sched, n_cap)
        sched.csr = csr
    return csr


def _scalar_rows(x, dtype, device) -> torch.Tensor:
    """A Python scalar or a 0-d tensor as a (1,) tensor on ``device`` (no
    host synchronisation for a tensor already there)."""
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(1)


def chain_grid(n_cap: int, n_pdbs: int, quota_cells: int,
               grid: int = 0) -> int:
    """The CTAs K5 launches over ``n_cap`` node rows, ``n_pdbs`` budgets
    and ``quota_cells`` cells of assumed quota: ``grid``, or with 0 as many
    as the card holds at once (at most one for each 16 nodes, a warp
    each).  Raises
    when that many CTAs cannot all be resident."""
    got = int(build.lib().koord_preempt_chain_grid(n_cap, n_pdbs,
                                                   quota_cells, grid))
    if got < 1:
        raise RuntimeError(
            f"K5: a grid of {grid or 'the default'} CTAs cannot be resident "
            "on this card (its CTAs wait for each other)")
    return got


class ChainLaunch:
    """K5's buffers for one call: copies of the carry (node accounting,
    valid rows, PDB budgets, the chain's assumed quota), the scratch (the
    rows' flag bytes, PDB keys, each CTA's own budgets and assumed quota
    where shared memory does not hold them, partial keys, the arrival
    counter) and the outputs (each preemptor's node, the victim list; with
    ``commit`` off the per-node record and the rows' flag bytes).
    :meth:`launch` runs it once over every preemptor."""

    def __init__(self, state, sched, reqs, pris, qids, feasible, same_quota,
                 active, pdb_allowed, quota_mode: int, headroom=None,
                 nominate: bool = True, commit: bool = True, grid: int = 0):
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
        self.csr = csr = victim_csr(sched, n)
        cells = q * r
        self.grid = chain_grid(n, b, cells, grid)
        lib = build.lib()
        self.c, self.commit = c, commit
        self.requested = state.node_requested.clone()
        self.valid = sched.valid.clone()
        self.pdb = torch.empty_like(pdb_allowed)
        self.assumed = (torch.empty_like(headroom) if quota_mode == CHAIN
                        else None)
        self.cflag = torch.empty(v, dtype=torch.uint8, device=dev)
        # the rows of no node are never dry-run: their flags stay 0
        self.cout = (torch.empty if commit else torch.zeros)(
            (2, v), dtype=torch.uint8, device=dev)
        self.pkey = torch.empty(v, dtype=torch.int32, device=dev)
        self.node_rec = (None if commit else torch.empty(
            (len(NODE_FIELDS), n), dtype=torch.int32, device=dev))
        self.nodes = torch.full((c,), -1, dtype=torch.int32, device=dev)
        self.victim_of = torch.full((v,), -1, dtype=torch.int32, device=dev)
        local = int(lib.koord_preempt_chain_local_ints(b, cells, self.grid))
        self.local = (torch.empty(local, dtype=torch.int32, device=dev)
                      if local else None)
        self.partial = torch.empty((2, KEY_INTS, self.grid),
                                   dtype=torch.int32, device=dev)
        self.order = torch.empty(n, dtype=torch.int32, device=dev)
        self.arrivals = torch.empty(1, dtype=torch.int32, device=dev)
        self._args = [
            build.ptr(state.node_allocatable), build.ptr(self.requested),
            build.ptr(state.node_valid), n,
            build.ptr(csr.offsets), build.ptr(csr.rows), build.ptr(csr.pri),
            build.ptr(csr.quota), build.ptr(csr.pdb), build.ptr(csr.nonp),
            build.ptr(csr.req), build.ptr(csr.row_count), v,
            build.ptr(self.valid), build.ptr(self.cflag),
            build.ptr(self.cout), build.ptr(self.pkey),
            build.ptr(reqs), build.ptr(pris), build.ptr(qids),
            build.ptr(feasible), build.ptr(same_quota), build.ptr(active), c,
            build.ptr(pdb_allowed), build.ptr(self.pdb), b,
            quota_mode,
            build.ptr(headroom) if quota_mode == HEADROOM else None,
            build.ptr(headroom) if quota_mode == CHAIN else None,
            build.ptr(self.assumed), q,
            int(nominate), int(commit),
            build.ptr(self.node_rec), build.ptr(self.nodes),
            build.ptr(self.victim_of), build.ptr(self.local),
            build.ptr(self.partial), build.ptr(self.order),
            build.ptr(self.arrivals), self.grid,
        ]

    def launch(self) -> None:
        """One launch over every preemptor; adds one to K5's count."""
        lib = build.lib()
        err = lib.koord_preempt_chain(*self._args,
                                      build.stream_of(self.requested))
        build.check(err, "preempt_chain")
        build.LAUNCHES["victim_select"] += 1

    def victims(self) -> torch.Tensor:
        """(C, V) bool: row v is preemptor j's victim where the victim list
        names j."""
        steps = torch.arange(self.c, dtype=torch.int32,
                             device=self.victim_of.device)
        return self.victim_of[None, :] == steps[:, None]

    def solve(self) -> VictimSolve:
        """The dry run's :class:`VictimSolve` (victim and violating flags
        scattered back from the CSR positions to the rows)."""
        rec = self.node_rec
        rows = self.csr.rows.long()
        flags = self.cout[(self.c - 1) & 1]
        victim = torch.zeros_like(self.valid)
        violating = torch.zeros_like(self.valid)
        victim[rows] = (flags & 1).bool()
        violating[rows] = (flags & 2).bool()
        return VictimSolve(
            eligible=rec[0].bool(), victim=victim, violating=violating,
            num_victims=rec[4], num_violating=rec[1],
            max_victim_pri=rec[2], sum_victim_pri=rec[3])


def select_victims_kernel(state, sched, preemptor_req, preemptor_pri,
                          preemptor_quota, pod_feasible, pdb_allowed,
                          quota_headroom=None, same_quota_only=False,
                          grid: int = 0) -> VictimSolve:
    """K5's dry run alone for one preemptor
    (:func:`select_victims_plain` on CPU tensors)."""
    if build.on_cpu(state.node_allocatable, sched.requests, preemptor_req,
                    pdb_allowed):
        return select_victims_plain(
            state, sched, preemptor_req, preemptor_pri, preemptor_quota,
            pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
            same_quota_only=same_quota_only)
    run = _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
               pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
               True, False, grid)
    run.launch()
    return run.solve()


def _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
         pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
         nominate, commit, grid) -> ChainLaunch:
    dev = preemptor_req.device
    return ChainLaunch(
        state, sched, preemptor_req.reshape(1, -1).contiguous(),
        _scalar_rows(preemptor_pri, torch.int32, dev),
        _scalar_rows(preemptor_quota, torch.int32, dev),
        pod_feasible.reshape(1, -1).contiguous(),
        _scalar_rows(same_quota_only, torch.bool, dev),
        torch.ones(1, dtype=torch.bool, device=dev), pdb_allowed,
        NO_QUOTA if quota_headroom is None else HEADROOM,
        headroom=quota_headroom, nominate=nominate, commit=commit, grid=grid)


def preempt_one_kernel(state, sched, preemptor_req, preemptor_pri,
                       preemptor_quota, pod_feasible, pdb_allowed,
                       quota_headroom=None, same_quota_only=False,
                       nominate: bool = True,
                       grid: int = 0) -> PreemptionOutcome:
    """K5's wrapper for one preemptor (:func:`preempt_one_plain` on CPU
    tensors): one launch; the inputs are not modified."""
    if build.on_cpu(state.node_allocatable, sched.requests, preemptor_req,
                    pdb_allowed):
        return preempt_one_plain(
            state, sched, preemptor_req, preemptor_pri, preemptor_quota,
            pod_feasible, pdb_allowed, quota_headroom=quota_headroom,
            same_quota_only=same_quota_only, nominate=nominate)
    run = _one(state, sched, preemptor_req, preemptor_pri, preemptor_quota,
               pod_feasible, pdb_allowed, quota_headroom, same_quota_only,
               nominate, True, grid)
    run.launch()
    return PreemptionOutcome(
        node=run.nodes[0], victims=run.victim_of == 0,
        state=state.replace(node_requested=run.requested),
        sched=sched.replace(valid=run.valid), pdb_allowed=run.pdb)


def preempt_chain_kernel(state, sched, reqs, pris, qids, feasible,
                         same_quota, active, pdb_allowed, base_headroom,
                         grid: int = 0) -> ChainOutcome:
    """K5's chain wrapper (:func:`preempt_chain_plain` on CPU tensors): one
    launch a chain; the inputs are not modified."""
    if build.on_cpu(state.node_allocatable, sched.requests, reqs,
                    pdb_allowed):
        return preempt_chain_plain(state, sched, reqs, pris, qids, feasible,
                                   same_quota, active, pdb_allowed,
                                   base_headroom)
    base_hr = open_headroom(base_headroom, reqs.shape[1],
                            reqs.device).contiguous()
    run = ChainLaunch(state, sched, reqs, pris, qids, feasible, same_quota,
                      active, pdb_allowed, CHAIN, headroom=base_hr,
                      grid=grid)
    run.launch()
    return ChainOutcome(
        node=run.nodes, victims=run.victims(),
        state=state.replace(node_requested=run.requested),
        sched=sched.replace(valid=run.valid), pdb_allowed=run.pdb,
        assumed=run.assumed)


# -- the CPU mirror of K5's decomposition ------------------------------------


def _min_key(a, b):
    """The lexicographic minimum of two node keys (None: no key)."""
    if a is None:
        return b
    return a if b is None or a < b else b


def preempt_chain_mirror(state, sched, reqs, pris, qids, feasible,
                         same_quota, active, pdb_allowed, quota_mode: int,
                         headroom=None, commit: bool = True,
                         grid: int = 3) -> dict:
    """K5 step by step in Python, on numpy copies of the inputs, with
    ``grid`` CTAs, each owning the nodes whose rows start in its share of
    the bound rows: the prologue (the flag bytes, each CTA's own budgets and
    assumed quota), then for each preemptor each CTA's warps walking its
    nodes (:func:`_dry_run_node`, on the CTA's own budgets and quota; with
    ``commit`` only those the preemptor can take) into the CTA's partial
    key and, with ``commit``, each CTA's reduction of the
    partial keys and its part of the commit (:func:`_commit_mirror`).  The
    CSR is ``sched``'s (:func:`victim_csr`: carried across calls).  Returns
    the outputs as numpy arrays: ``nodes`` (C,), ``victims`` (C, V) filled
    from the victim list ``victim_of`` (V,), ``requested``, ``valid``,
    ``pdb`` and ``assumed`` (CHAIN mode) as CTA 0 writes them out,
    ``partial`` (the last preemptor's partial keys), and the last dry
    run's per-node record ``node_rec`` (5, N) and flag bytes ``flags`` by
    CSR position with the CSR's ``rows``."""

    def np_(t):
        return None if t is None else t.detach().cpu().numpy()

    n, v, c = state.capacity, sched.capacity, reqs.shape[0]
    csr = victim_csr(sched, n)
    valid = np_(sched.valid).copy()
    offsets, rows = np_(csr.offsets), np_(csr.rows)
    ctx = dict(
        alloc=np_(state.node_allocatable).astype(np.int64),
        requested=np_(state.node_requested).astype(np.int64),
        node_valid=np_(state.node_valid),
        offsets=offsets, rows=rows, pri=np_(csr.pri).astype(np.int64),
        quota=np_(csr.quota), pdb_id=np_(csr.pdb),
        req=np_(csr.req).astype(np.int64), row_count=np_(csr.row_count),
        valid=valid, cflag=np.zeros(v, np.int64),
        cout=np.zeros((2, v), np.int64), pkey=np.zeros(v, np.int64))
    # each CTA's nodes: those whose rows start in its share of the rows
    total = int(offsets[n])
    firsts = [int(np.searchsorted(offsets[:n], total * g // grid,
                                  side="left")) for g in range(grid)] + [n]
    blocks = list(zip(firsts[:-1], firsts[1:]))
    # the prologue: each CTA's rows' state (bit 0 valid, 1 non-preemptible)
    # and its own budgets and assumed quota
    nonp = np_(csr.nonp)
    for n0, n1 in blocks:
        for pos in range(int(offsets[n0]), int(offsets[n1])):
            ctx["cflag"][pos] = int(valid[rows[pos]]) | (int(nonp[pos]) << 1)
    reqs, pris, qids = np_(reqs), np_(pris), np_(qids)
    feasible, same_quota, active = np_(feasible), np_(same_quota), np_(active)
    headroom = np_(headroom)
    own = [dict(pdb=np_(pdb_allowed).astype(np.int64),
                assumed=(np.zeros_like(headroom, dtype=np.int64)
                         if quota_mode == CHAIN else None))
           for _ in blocks]
    nodes = np.full(c, -1, np.int32)
    victim_of = np.full(v, -1, np.int64)
    rec = np.zeros((len(NODE_FIELDS), n), np.int64)
    partial = []
    for j in range(c):
        preq = [int(x) for x in reqs[j]]
        cout = ctx["cout"][j & 1]
        partial = []
        for (n0, n1), mine in zip(blocks, own):
            if quota_mode == NO_QUOTA:
                hr = None
            elif quota_mode == HEADROOM:
                hr = [int(x) for x in headroom]
            elif same_quota[j]:
                q = min(max(int(qids[j]), 0), headroom.shape[0] - 1)
                hr = [min(max(wrap32(int(headroom[q, d])
                                     - int(mine["assumed"][q, d])),
                              -HEADROOM_OPEN), HEADROOM_OPEN)
                      for d in range(len(preq))]
            else:
                hr = [HEADROOM_OPEN] * len(preq)
            best = None
            # the CTA's warps take its nodes as they come free: in the
            # order here, in any order on the card
            for nd in range(n0, n1):
                if commit and not (feasible[j, nd] and ctx["node_valid"][nd]):
                    continue        # never chosen: not walked
                rec[:, nd] = _dry_run_node(
                    ctx, cout, mine["pdb"], nd, preq, int(pris[j]),
                    int(qids[j]), bool(same_quota[j]),
                    bool(feasible[j, nd]), hr)
                if rec[0, nd]:
                    best = _min_key(best, (*(int(x) for x in rec[1:, nd]),
                                           nd))
            partial.append(best)
        if not commit:
            continue
        # every CTA reduces the partial keys in its own order (any order
        # gives the same minimum: the key ends in the node row) and applies
        # its part of the commit
        for g, ((n0, n1), mine) in enumerate(zip(blocks, own)):
            best = None
            for key in partial[g:] + partial[:g]:
                best = _min_key(best, key)
            node = -1 if best is None else best[4]
            out = _commit_mirror(ctx, cout, mine, j, node, n0 <= node < n1,
                                 preq, int(qids[j]), bool(active[j]),
                                 victim_of)
            if g == 0:
                nodes[j] = out
    assumed = own[0]["assumed"]
    return dict(nodes=nodes,
                victims=victim_of[None, :] == np.arange(c)[:, None],
                victim_of=victim_of.astype(np.int32),
                requested=wrap32(ctx["requested"]).astype(np.int32),
                valid=ctx["valid"],
                pdb=wrap32(own[0]["pdb"]).astype(np.int32),
                assumed=(None if assumed is None else
                         wrap32(assumed).astype(np.int32)),
                partial=partial, node_rec=rec.astype(np.int32),
                flags=ctx["cout"][(c - 1) & 1], rows=rows)


def _dry_run_node(ctx, cout, pdb, nd: int, preq, ppri: int, pq: int,
                  sq: bool, feasible: bool, hr) -> list[int]:
    """A warp on node ``nd``: pass 1 over the node's CSR positions in
    chunks of 32 (candidate mask from the flag byte and the CSR's fields;
    each candidate's rank among the earlier ones of its PDB as the popcount
    of the lower lanes of its chunk with the same PDB, ``__match_any_sync``,
    plus the carry, the count of the earlier chunks' candidates of that PDB
    from the stored keys; violating against the CTA's own budgets ``pdb``;
    the freed vector), pass 2 the reprieve, violating candidates first,
    then the others, each in CSR order, one candidate a step with the
    lanes holding the dimensions.  Writes the flag bytes ``cout`` (bit 0
    victim, 1 violating, 2 candidate) and returns the node's record
    (NODE_FIELDS)."""
    start, end = int(ctx["offsets"][nd]), int(ctx["offsets"][nd + 1])
    pkey, req = ctx["pkey"], ctx["req"]
    b = len(pdb)
    dims = len(preq)
    freed = [0] * dims
    has_cand = False
    for base in range(start, end, WARP):
        keys = []
        for pos in range(base, min(base + WARP, end)):
            fl = int(ctx["cflag"][pos])
            cand = (fl & 3 == 1 and ctx["pri"][pos] < ppri
                    and (not sq or int(ctx["quota"][pos]) == pq))
            key = int(ctx["pdb_id"][pos]) if cand else -1
            keys.append((pos, cand, key if key >= 0 else -1))
        for i, (pos, cand, key) in enumerate(keys):
            # __match_any_sync: the lower lanes of the chunk with this key
            rank = sum(1 for k in keys[:i] if k[2] == key)
            # the carry: the earlier chunks' candidates with this key
            rank += sum(1 for p in range(start, base) if pkey[p] == key)
            pkey[pos] = key
            viol = key >= 0 and rank >= pdb[min(key, b - 1)]
            cout[pos] = (4 if cand else 0) | (2 if viol else 0)
            if cand:
                has_cand = True
                for d in range(dims):
                    freed[d] = wrap32(freed[d] + int(req[d, pos]))
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
            if cout[pos] & 6 != 4 | group:
                continue
            rd = [int(req[d, pos]) for d in range(dims)]
            ok = all(p == 0 or p <= wrap32(free[d] - rd[d])
                     for d, p in enumerate(preq))
            if qfree is not None:
                ok = ok and all(p == 0 or p <= wrap32(qfree[d] - rd[d])
                                for d, p in enumerate(preq))
            if ok:
                free = [wrap32(free[d] - rd[d]) for d in range(dims)]
                if qfree is not None:
                    qfree = [wrap32(qfree[d] - rd[d]) for d in range(dims)]
            else:
                cout[pos] |= 1
                pri = int(ctx["pri"][pos])
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


def _commit_mirror(ctx, cout, mine, j: int, node: int, owner: bool, preq,
                   qid: int, active: bool, victim_of) -> int:
    """One CTA's part of preemptor ``j``'s commit on ``node`` (-1: none
    eligible), for an active row that found one: over the node's CSR
    range, each victim's PDB pays and its quota row of the CTA's assumed
    quota is released, and the preemptor charges its own (``mine``, every
    CTA alike); the node's ``owner`` also takes the victims out of the
    flag bytes, the valid rows and the node accounting, lists them, and
    nominates the preemptor there.  Returns the row's node output (-1 when
    it failed or is inactive)."""
    if not active or node < 0:
        return -1
    b = len(mine["pdb"])
    assumed = mine["assumed"]
    for pos in range(int(ctx["offsets"][node]), int(ctx["offsets"][node + 1])):
        if not cout[pos] & 1:
            continue
        pdb = int(ctx["pdb_id"][pos])
        if 0 <= pdb < b:
            mine["pdb"][pdb] -= 1
        q = int(ctx["quota"][pos])
        if assumed is not None and 0 <= q < assumed.shape[0]:
            assumed[q] -= ctx["req"][:, pos]
        if owner:
            row = int(ctx["rows"][pos])
            ctx["cflag"][pos] &= ~1
            ctx["valid"][row] = False
            victim_of[row] = j
            ctx["requested"][node] -= ctx["req"][:, pos]
    if owner:
        ctx["requested"][node] += np.asarray(preq, np.int64)
    if assumed is not None and 0 <= qid < assumed.shape[0]:
        assumed[qid] += np.asarray(preq, np.int64)
    return node
