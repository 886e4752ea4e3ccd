"""K3b: segmented priority-order prefix acceptance of a propose/accept round.

Two entry points launch ``csrc/segmented_prefix_accept.cu`` on CUDA tensors
and take their plain versions on CPU tensors:

- :func:`round_prefix_accept`: one round's whole acceptance, the node level
  and every quota level, in ONE launch.  Its plain version,
  :func:`round_prefix_accept_plain`, composes the levels one by one as the
  JAX package's round body does (``_prefix_accept`` and
  ``_quota_prefix_accept`` of its ``ops/batch_assign.py``).  What the
  levels share across a solve's rounds is built once by
  :func:`accept_plan`.
- :func:`segmented_prefix_accept`: one level over per-pod headroom, the
  JAX package's ``_prefix_accept_sorted_choice``; its plain version
  :func:`segmented_prefix_accept_plain` is that function line for line (a
  stable sort groups the segments in priority order, one cumulative sum
  with a running max of segment starts gives each pod's within-segment
  prefix).

The kernel sees a level as entries grouped by segment, each group in
priority order.  The node level regroups every round (a stable
``torch.sort`` of the round's choices).  A quota level's segments and the
pods that may ever be active there are fixed for a solve, so its grouping
is built once; in a round an inactive pod inside a group adds 0 and gets no
verdict, which leaves every active pod's within-segment inclusive sum as
the per-round regrouping gives it.  :func:`round_prefix_accept_mirror` is
the kernel's arithmetic in PyTorch (the entry list, a blocked segmented
scan with carries across tiles), which the CPU tests hold against the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build


def segmented_prefix_accept_plain(seg, requests, choice_free, order, active,
                                  num_segments: int):
    """(P,) bool: taken in ``order`` (priority descending) within each
    segment, the running sum of active requests, the pod's own included,
    fits the pod's segment headroom ``choice_free`` on every requested dim.
    Pods in the overflow segment ``num_segments`` are never accepted."""
    p = requests.shape[0]
    seg_o = seg[order]
    req_o = torch.where(active[order][:, None], requests[order], 0)
    free_o = choice_free[order]
    pos = torch.sort(seg_o, stable=True).indices    # group segments, keep order
    seg_s = seg_o[pos]
    req_s = req_o[pos]
    cum = torch.cumsum(req_s, dim=0, dtype=torch.int32)
    excl = cum - req_s
    is_start = torch.ones(p, dtype=torch.bool, device=seg.device)
    is_start[1:] = seg_s[1:] != seg_s[:-1]
    # cum is non-decreasing, so a running max of start markers yields the
    # most recent segment start's exclusive sum
    base = torch.cummax(torch.where(is_start[:, None], excl, -1), dim=0).values
    prefix = cum - base
    fits = torch.all((prefix <= free_o[pos]) | (req_s == 0), dim=-1)
    out = torch.zeros(p, dtype=torch.bool, device=seg.device)
    out[order[pos]] = fits
    return out & active & (seg != num_segments)


def prefix_accept_plain(choice, requests, free, order, active):
    """One level over an (S, R) headroom table, the JAX ``_prefix_accept``:
    inactive pods go to the overflow segment S; an active pod reads its
    segment's row (``choice`` clamped into the table)."""
    s = free.shape[0]
    safe = torch.clamp(choice, 0, s - 1).long()
    choice_free = torch.where(active[:, None], free[safe], 0)
    seg = torch.where(active, choice, s).to(torch.int32)
    return segmented_prefix_accept_plain(seg, requests, choice_free, order,
                                         active, s)


@dataclasses.dataclass
class AcceptPlan:
    """What one solve's acceptance levels share across its rounds.

    The quota part is None without a quota.  Its grouped entries list
    every (level, pod) pair that can be active in some round: level d <
    ``depth`` is chain column d (segment ``chain[qid, d]``, every pod with
    a quota whose chain reaches that column), level ``depth`` the min
    headroom of non-preemptible pods (segment ``qid``).  They are sorted
    by ``group`` = level * Q + segment, each group in priority order;
    ``row`` indexes the headroom table (``row - Q`` the min headroom table
    at the last level)."""

    order: torch.Tensor          # (P,) int64, priority descending
    requests: torch.Tensor       # (P, R) int32
    dims: int                    # bit r: some pod requests dim r
    quota_id: torch.Tensor | None = None        # (P,) int32, -1 none
    non_preemptible: torch.Tensor | None = None  # (P,) bool
    chain: torch.Tensor | None = None           # (Q, D) int32 ancestors
    quota_req: torch.Tensor | None = None       # (P, R) masked by checked
    entry_pod: torch.Tensor | None = None       # (M,) int32
    entry_group: torch.Tensor | None = None     # (M,) int32
    entry_row: torch.Tensor | None = None       # (M,) int32

    @property
    def depth(self) -> int:
        return 0 if self.chain is None else self.chain.shape[1]

    @property
    def n_quotas(self) -> int:
        return 0 if self.chain is None else self.chain.shape[0]


def _dims_mask(requests) -> int:
    """Bit r set when some row requests dim r (one copy to the host)."""
    nz = torch.any(requests != 0, dim=0).cpu().tolist()
    return sum(1 << r for r, on in enumerate(nz) if on)


def accept_plan(order, requests, quota_id=None, non_preemptible=None,
                chain=None, checked=None) -> AcceptPlan:
    """The solve-invariant part of every round's acceptance: the priority
    order, the requested dims, and (with a quota: ``quota_id``,
    ``non_preemptible``, the quota state's ``chain`` and ``checked``) the
    quota levels' grouped entries.  Two copies to the host, once a
    solve."""
    plan = AcceptPlan(order=order, requests=requests,
                      dims=_dims_mask(requests))
    if chain is None:
        return plan
    p = requests.shape[0]
    q, depth = chain.shape
    qid = torch.clamp(quota_id, min=0).long()
    has_quota = quota_id >= 0
    anc = chain[qid]                                       # (P, D)
    segs = torch.cat([anc.t(), qid.to(torch.int32)[None]])  # (D + 1, P)
    elig = torch.cat([((anc >= 0) & has_quota[:, None]).t(),
                      (has_quota & non_preemptible)[None]])
    segs_o, elig_o = segs[:, order], elig[:, order]
    level = torch.arange(depth + 1, dtype=torch.int32,
                         device=requests.device)[:, None]
    # ineligible pairs sort past every group; the sort is stable, so each
    # group keeps priority order
    key = torch.where(elig_o, level * q + segs_o, (depth + 1) * q)
    group, idx = torch.sort(key.reshape(-1), stable=True)
    m = int(elig.sum())
    idx = idx[:m]
    lvl = (idx // p).to(torch.int32)
    row = segs_o.reshape(-1)[idx] + torch.where(lvl == depth, q, 0)
    plan.quota_id, plan.non_preemptible, plan.chain = (
        quota_id, non_preemptible, chain)
    plan.quota_req = torch.where(checked[qid], requests, 0)
    plan.entry_pod = order[idx % p].to(torch.int32)
    plan.entry_group = group[:m].to(torch.int32).contiguous()
    plan.entry_row = row.to(torch.int32).contiguous()
    return plan


def _quota_levels(plan: AcceptPlan, headroom, min_headroom):
    """(segment, eligible, table) of every quota level, the chain columns
    first, then the min headroom of non-preemptible pods."""
    qid = torch.clamp(plan.quota_id, min=0).long()
    has_quota = plan.quota_id >= 0
    for d in range(plan.depth):
        anc = plan.chain[qid, d]
        yield torch.clamp(anc, min=0), has_quota & (anc >= 0), headroom
    yield (qid.to(torch.int32), has_quota & plan.non_preemptible,
           min_headroom)


def round_prefix_accept_plain(plan: AcceptPlan, choice, act, free,
                              headroom=None, min_headroom=None):
    """(P,) bool: one round's acceptance.  The node level (each active
    pod's ``choice`` against the free capacity ``free``), AND at every
    quota level where the pod is active its acceptance against the level's
    headroom, as the JAX round body composes ``_prefix_accept`` and
    ``_quota_prefix_accept``."""
    accept = prefix_accept_plain(choice, plan.requests, free, plan.order, act)
    if plan.chain is None:
        return accept
    ok = torch.ones_like(act)
    for seg, elig, table in _quota_levels(plan, headroom, min_headroom):
        act_l = act & elig
        acc = prefix_accept_plain(seg, plan.quota_req, table, plan.order,
                                  act_l)
        ok = ok & (acc | ~act_l)
    return accept & (ok | ~(plan.quota_id >= 0))


# -- the kernel's arithmetic, in PyTorch ------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums of int32 values to the int32 they wrap to."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def blocked_segmented_scan(values: torch.Tensor, start: torch.Tensor,
                           tile: int) -> torch.Tensor:
    """(E, R) within-run inclusive sums, wrapping as int32, computed the
    kernel's way: a segmented scan inside each tile of ``tile`` entries,
    and a carry from tile to tile (the look-back's result: the run's sum
    since its start, for a run that began in an earlier tile).  ``start``
    marks each run's first entry; entry 0 starts a run."""
    out = torch.empty_like(values)
    carry = torch.zeros(values.shape[1], dtype=torch.int64)
    v64 = values.to(torch.int64)
    for t0 in range(0, values.shape[0], tile):
        v, s = v64[t0:t0 + tile], start[t0:t0 + tile]
        cum = torch.cumsum(v, dim=0)
        run = torch.cumsum(s.to(torch.int64), dim=0) - 1   # -1: no start yet
        base = torch.zeros_like(cum) - carry               # carried run
        if bool(s.any()):
            at_start = (cum - v)[s]
            base = torch.where(run[:, None] >= 0, at_start[run.clamp(min=0)],
                               base)
        incl = cum - base
        out[t0:t0 + tile] = _wrap32(incl)
        carry = incl[-1]
    return out


def _entries_accept_mirror(group, pod, head, req, overflow, act, dims: int,
                           tile: int, n_node: int):
    """The kernel over one entry list: a run starts at each change of
    ``group`` and at entry ``n_node`` (the quota part's first); an active
    entry's value is its request on the requested dims (0 for an
    inactive one); an active entry whose run sum exceeds its headroom on a
    dim it requests, or that lies in the overflow, clears its pod."""
    start = torch.ones(group.shape[0], dtype=torch.bool)
    start[1:] = group[1:] != group[:-1]
    start[n_node:n_node + 1] = True
    on = torch.tensor([(dims >> r) & 1 for r in range(NUM_RESOURCE_DIMS)],
                      dtype=torch.bool)
    act_e = act[pod]
    values = torch.where(act_e[:, None] & on[None, :], req, 0)
    run = blocked_segmented_scan(values, start, tile)
    fits = ~overflow & torch.all((run <= head) | (values == 0), dim=-1)
    out = act.clone()
    out[pod[act_e & ~fits]] = False
    return out


def _node_entries(seg, order):
    """The node level's grouping: (segment, pod) of each entry, segments
    ascending, each in priority order (one stable sort)."""
    vals, pos = torch.sort(seg[order], stable=True)
    return vals, order[pos]


def segmented_prefix_accept_mirror(seg, requests, choice_free, order,
                                   active, num_segments: int,
                                   tile: int = 1024):
    """What the kernel computes for :func:`segmented_prefix_accept`."""
    node_seg, node_pod = _node_entries(seg, order)
    return _entries_accept_mirror(
        node_seg, node_pod, choice_free[node_pod], requests[node_pod],
        node_seg == num_segments, active, _dims_mask(requests), tile,
        node_seg.shape[0])


def round_prefix_accept_mirror(plan: AcceptPlan, choice, act, free,
                               headroom=None, min_headroom=None,
                               tile: int = 1024):
    """What the kernel computes for :func:`round_prefix_accept`: the node
    level's entries (regrouped from this round's choices), then the plan's
    quota entries, as one list."""
    s = free.shape[0]
    seg = torch.where(act, choice, s).to(torch.int32)
    node_seg, node_pod = _node_entries(seg, plan.order)
    group, pod = [node_seg], [node_pod]
    head = [free[torch.clamp(node_seg, 0, s - 1).long()]]
    req = [plan.requests[node_pod]]
    overflow = [node_seg == s]
    if plan.chain is not None:
        qpod = plan.entry_pod.long()
        group.append(plan.entry_group)
        pod.append(qpod)
        head.append(torch.cat([headroom, min_headroom])[plan.entry_row.long()])
        req.append(plan.quota_req[qpod])
        overflow.append(torch.zeros_like(qpod, dtype=torch.bool))
    return _entries_accept_mirror(
        torch.cat(group), torch.cat(pod), torch.cat(head), torch.cat(req),
        torch.cat(overflow), act, plan.dims, tile, node_seg.shape[0])


# -- the wrappers ---------------------------------------------------------------

def prepare_launch(node_seg, node_pos, order, node_req, node_free,
                   by_pod: bool, overflow: int, n_segments: int,
                   plan_quota, headroom, min_headroom, act, dims: int):
    """(launch, out): the kernel over the node entries (``node_seg``
    grouped, with ``node_pos`` into ``order``), then the quota entries of
    ``plan_quota`` (an AcceptPlan, or None).  ``out`` starts as ``act``;
    ``launch()`` zeroes the look-back's scratch and launches the kernel,
    which clears the rejected pods in ``out`` (launching it again gives
    the same ``out``)."""
    out = act.clone()
    n_node = node_seg.shape[0]
    n_quota = 0 if plan_quota is None else plan_quota.entry_pod.shape[0]
    if n_node + n_quota == 0:
        return (lambda: None), out
    lib = build.lib()
    scratch = torch.empty(
        lib.koord_segmented_prefix_accept_scratch_ints(n_node + n_quota),
        dtype=torch.int32, device=act.device)
    if plan_quota is None:
        q_args = (None, None, None, None, None, None, 0, 0)
    else:
        q_args = (build.ptr(plan_quota.entry_pod),
                  build.ptr(plan_quota.entry_group),
                  build.ptr(plan_quota.entry_row),
                  build.ptr(plan_quota.quota_req), build.ptr(headroom),
                  build.ptr(min_headroom), n_quota, plan_quota.n_quotas)
    args = (build.ptr(node_seg), build.ptr(node_pos), build.ptr(order),
            build.ptr(node_req), build.ptr(node_free), int(by_pod), n_node,
            overflow, n_segments, *q_args, build.ptr(act), dims,
            build.ptr(scratch), scratch.numel(), build.ptr(out),
            build.stream_of(out))
    keep = (node_seg, node_pos, scratch)   # alive while launch() is

    def launch():
        _ = keep
        scratch.zero_()
        build.check(lib.koord_segmented_prefix_accept(*args),
                    "segmented_prefix_accept")
        build.LAUNCHES["segmented_prefix_accept"] += 1

    return launch, out


def _launch(*prep_args):
    launch, out = prepare_launch(*prep_args)
    launch()
    return out


def round_prefix_accept(plan: AcceptPlan, choice, act, free, headroom=None,
                        min_headroom=None):
    """K3b's per-round wrapper; see :func:`round_prefix_accept_plain`.  On
    the card: one stable ``torch.sort`` groups the node level, then one
    launch accepts every level."""
    if build.on_cpu(choice, act, free, plan.requests, headroom):
        return round_prefix_accept_plain(plan, choice, act, free, headroom,
                                         min_headroom)
    p, n, r = act.shape[0], free.shape[0], NUM_RESOURCE_DIMS
    build.expect(choice, "choice", torch.int32, (p,))
    build.expect(act, "act", torch.bool, (p,))
    build.expect(free, "free", torch.int32, (n, r))
    build.expect(plan.requests, "requests", torch.int32, (p, r))
    build.expect(plan.order, "order", torch.int64, (p,))
    if plan.chain is not None:
        q = plan.n_quotas
        build.expect(headroom, "headroom", torch.int32, (q, r))
        build.expect(min_headroom, "min_headroom", torch.int32, (q, r))
        build.expect(plan.quota_req, "quota_req", torch.int32, (p, r))
    seg = torch.where(act, choice, n).to(torch.int32)
    node_seg, node_pos = torch.sort(seg[plan.order], stable=True)
    return _launch(node_seg, node_pos, plan.order, plan.requests, free,
                   False, n, n, plan if plan.chain is not None else None,
                   headroom, min_headroom, act, plan.dims)


def segmented_prefix_accept(seg, requests, choice_free, order, active,
                            num_segments: int):
    """K3b's one-level wrapper; see :func:`segmented_prefix_accept_plain`.
    On the card: the same kernel over the one level, headroom read per
    pod."""
    if build.on_cpu(seg, requests, choice_free, order, active):
        return segmented_prefix_accept_plain(seg, requests, choice_free,
                                             order, active, num_segments)
    p, r = requests.shape[0], NUM_RESOURCE_DIMS
    build.expect(seg, "seg", torch.int32, (p,))
    build.expect(requests, "requests", torch.int32, (p, r))
    build.expect(choice_free, "choice_free", torch.int32, (p, r))
    build.expect(order, "order", torch.int64, (p,))
    build.expect(active, "active", torch.bool, (p,))
    if p == 0:
        return active.clone()
    node_seg, node_pos = torch.sort(seg[order], stable=True)
    return _launch(node_seg, node_pos, order, requests, choice_free, True,
                   num_segments, p, None, None, None, active,
                   _dims_mask(requests))
