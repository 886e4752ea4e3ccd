"""K4 and K4r: the exact sequential greedy scan as one kernel on a cluster of
CTAs, without and with reservations.

:func:`greedy_scan_kernel` (K4) and :func:`reservation_scan_kernel` (K4r)
are the wrappers.  CPU tensors take their plain versions,
``ops/assignment.py`` :func:`greedy_assign_plain` and
:func:`greedy_scan_plain` (the JAX package's ``_greedy_scan`` as a Python
loop over pods); CUDA tensors launch ``csrc/greedy_scan.cu`` once for the
whole scan (16 CTAs, each owning a range of the nodes and, for K4r, the
reservation rows on them; see the source's header).  A launch the card
refuses (a cluster or shared-memory request it cannot meet, e.g. a quota
tree too large for each CTA's replica) raises.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _config_vector
from koordinator_tpu_torch.ops.assignment import (
    ScoringConfig,
    greedy_assign_plain,
    greedy_scan_plain,
    pod_estimates,
    priority_order,
)
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

#: ints of K4r's reservation record (csrc/greedy_scan.cu kRsvInts):
#: reserved (R), allocated (R), node, row, flags
RSV_INTS = 2 * NUM_RESOURCE_DIMS + 3
#: pods K4's control warp stages at a time, in priority order
#: (csrc/greedy_scan.cu kWin)
SCAN_WINDOW = 256
_ONCE, _RESTRICTED = 1, 2


def _scan_args(state: ClusterState, pods: PodBatch, cfg: ScoringConfig,
               quota, scratch_fn):
    """Check the scan's inputs and build the arguments K4 and K4r share,
    up to the pods' quota ids; returns (args before P and N, assignments,
    new_state, new_quota)."""
    n, r = state.capacity, NUM_RESOURCE_DIMS
    p = pods.capacity
    for name in ("node_allocatable", "node_requested", "node_usage",
                 "node_agg_usage"):
        build.expect(getattr(state, name), name, torch.int32, (n, r))
    build.expect(state.node_valid, "node_valid", torch.bool, (n,))
    build.expect(state.node_class, "node_class", torch.int32, (n,))
    build.expect(pods.requests, "requests", torch.int32, (p, r))
    build.expect(pods.valid, "valid", torch.bool, (p,))
    build.expect(pods.quota_id, "quota_id", torch.int32, (p,))
    build.expect(pods.non_preemptible, "non_preemptible", torch.bool, (p,))
    if pods.selector_mask is not None:
        build.expect(pods.selector_mask, "selector_mask", torch.bool,
                     (p, None))
        c = pods.selector_mask.shape[1]
        sel, feas = pods.selector_mask, None
    else:
        sel, feas, c = None, pods.feasible, 1
        build.expect(feas, "feasible", torch.bool, (p, n))
    dev = pods.requests.device
    requested = state.node_requested.clone()
    assignments = torch.full((p,), -1, dtype=torch.int32, device=dev)
    new_quota = None
    q_args = [None] * 5 + [0, 0]
    if quota is not None:
        q, d = quota.capacity, quota.chain.shape[1]
        build.expect(quota.headroom, "headroom", torch.int32, (q, r))
        build.expect(quota.min_headroom, "min_headroom", torch.int32, (q, r))
        build.expect(quota.checked, "checked", torch.bool, (q, r))
        build.expect(quota.chain, "chain", torch.int32, (q, d))
        build.expect(quota.valid, "valid", torch.bool, (q,))
        new_quota = quota.replace(headroom=quota.headroom.clone(),
                                  min_headroom=quota.min_headroom.clone())
        q_args = [new_quota.headroom, new_quota.min_headroom, quota.checked,
                  quota.chain, quota.valid, q, d]
    new_state = state.replace(node_requested=requested)
    if p == 0:
        return None, assignments, new_state, new_quota
    est = pod_estimates(pods, cfg).contiguous()
    cfgv, agg_enabled = _config_vector(cfg)
    base = state.node_agg_usage if agg_enabled else state.node_usage
    order = priority_order(pods).to(torch.int32)
    # the node columns' global home, needed only when they do not fit a
    # CTA's shared memory beside the quota replica
    nbytes = scratch_fn(n, q_args[5], q_args[6])
    if nbytes < 0:
        raise RuntimeError("greedy_scan: the card's shared memory could not "
                           "be queried")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    # the selector rows as words, packed by the launch
    words = (None if sel is None else
             torch.empty((p, -(-c // 64)), dtype=torch.int64, device=dev))
    args = [build.ptr(state.node_allocatable), build.ptr(requested),
            build.ptr(state.node_usage), build.ptr(base),
            build.ptr(state.node_valid), build.ptr(state.node_class),
            build.ptr(scratch), build.ptr(pods.requests), build.ptr(est),
            build.ptr(pods.valid), build.ptr(order), build.ptr(sel), c,
            build.ptr(words),
            build.ptr(feas), build.ptr(cfgv), cfgv.numel(),
            *(build.ptr(t) if torch.is_tensor(t) else t for t in q_args),
            build.ptr(pods.quota_id), build.ptr(pods.non_preemptible), p, n]
    # the temporaries must outlive the launch's enqueue
    keep = (est, cfgv, order, scratch, words)
    return (args, keep), assignments, new_state, new_quota


def greedy_scan_kernel(state: ClusterState, pods: PodBatch,
                       cfg: ScoringConfig, quota=None):
    """K4's wrapper: (assignments, new_state, new_quota) as
    :func:`greedy_assign_plain` returns them.  The kernel updates copies of
    ``node_requested`` and of the quota's headroom tensors in place; the
    inputs are not modified."""
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds,
                    None if quota is None else quota.headroom):
        return greedy_assign_plain(state, pods, cfg, quota)
    lib = build.lib()
    launch, assignments, new_state, new_quota = _scan_args(
        state, pods, cfg, quota, lib.koord_greedy_scan_scratch_bytes)
    if launch is None:
        return assignments, new_state, new_quota
    args, _keep = launch
    err = lib.koord_greedy_scan(*args, build.ptr(assignments),
                                build.stream_of(assignments))
    build.check(err, "greedy_scan")
    build.LAUNCHES["greedy_scan"] += 1
    return assignments, new_state, new_quota


def reservation_records(rsv, n_nodes: int, nodes_per_cta: int):
    """K4r's view of a reservation set: the placed rows (valid, on a node in
    [0, n_nodes)) as (V', RSV_INTS) int32 records sorted by node, stable so
    that the rows of one node stay in row order; the rows' order into the
    set (V',); and the most records on one CTA's node range.  The other
    rows can neither fit a pod nor be nominated: they stay as they are."""
    dev = rsv.node_idx.device
    placed = rsv.valid & (rsv.node_idx >= 0) & (rsv.node_idx < n_nodes)
    key = torch.where(placed, rsv.node_idx, n_nodes).to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    count = int(placed.sum())
    perm = perm[:count]
    node = rsv.node_idx[perm]
    flags = (rsv.allocate_once[perm].to(torch.int32) * _ONCE
             + rsv.restricted[perm].to(torch.int32) * _RESTRICTED)
    rows = torch.cat([rsv.reserved[perm], rsv.allocated[perm], node[:, None],
                      perm[:, None].to(torch.int32), flags[:, None]], dim=1)
    per_cta = torch.bincount(node.long() // nodes_per_cta, minlength=1)
    vmax = int(per_cta.max()) if count else 0
    return rows.contiguous(), perm, vmax


def reservation_scan_kernel(state: ClusterState, pods: PodBatch,
                            cfg: ScoringConfig, rsv, match,
                            quota=None, boost: int = 10_000):
    """K4r's wrapper: (assignments, rsv_choice, new_state, new_rsv,
    new_quota) as :func:`greedy_scan_plain` returns them with ``rsv``.

    On the card it raises unless every placed reservation row's remainder
    is non-negative with a total below 2**31 - 1 and no valid pod requests
    a negative amount: then the remainders only shrink through the scan
    (what the kernel's nomination relies on).  The inputs are not
    modified."""
    if build.on_cpu(state.node_allocatable, pods.requests,
                    cfg.usage_thresholds, rsv.reserved, match,
                    None if quota is None else quota.headroom):
        return greedy_scan_plain(state, pods, cfg, quota, rsv, match, boost)
    n, r, p, v = state.capacity, NUM_RESOURCE_DIMS, pods.capacity, rsv.capacity
    build.expect(rsv.valid, "rsv.valid", torch.bool, (v,))
    build.expect(rsv.node_idx, "rsv.node_idx", torch.int32, (v,))
    build.expect(rsv.reserved, "rsv.reserved", torch.int32, (v, r))
    build.expect(rsv.allocated, "rsv.allocated", torch.int32, (v, r))
    build.expect(rsv.allocate_once, "rsv.allocate_once", torch.bool, (v,))
    build.expect(rsv.restricted, "rsv.restricted", torch.bool, (v,))
    build.expect(match, "match", torch.bool, (p, v))
    lib = build.lib()
    records, perm, vmax = reservation_records(
        rsv, n, lib.koord_reservation_scan_nodes_per_cta(n))
    rem = records[:, :r].to(torch.int64) - records[:, r:2 * r]
    bad = ((rem < 0).any() | (rem.sum(1) >= 2**31 - 1).any()
           | ((pods.requests < 0).any(1) & pods.valid).any())
    if bool(bad):
        raise ValueError(
            "reservation_scan: the kernel takes remainders in "
            "[0, reserved] summing below 2**31 - 1 and non-negative "
            "requests")
    launch, assignments, new_state, new_quota = _scan_args(
        state, pods, cfg, quota, lib.koord_reservation_scan_scratch_bytes)
    rsv_choice = torch.full((p,), -1, dtype=torch.int32,
                            device=assignments.device)
    if launch is None:
        return assignments, rsv_choice, new_state, rsv, new_quota
    args, _keep = launch
    match_rec = match[:, perm].contiguous()
    err = lib.koord_reservation_scan(
        *args, build.ptr(records), records.shape[0], vmax,
        build.ptr(match_rec), boost, build.ptr(assignments),
        build.ptr(rsv_choice), build.stream_of(assignments))
    build.check(err, "reservation_scan")
    build.LAUNCHES["reservation_scan"] += 1
    allocated = rsv.allocated.clone()
    allocated[perm] = records[:, r:2 * r]
    return (assignments, rsv_choice, new_state,
            rsv.replace(allocated=allocated), new_quota)


# -- what the kernel computes instead of the plain version's steps ----------
#
# greedy_scan_mirror models, in PyTorch, how K4 and K4r order a step's work
# differently from greedy_scan_plain (csrc/greedy_scan.cu), so the CPU tests
# can hold it against the JAX package: the next pod found while the current
# one is scored and re-checked after its charge, and the reservation fit
# read through each node's range of records.


def greedy_scan_mirror(state: ClusterState, pods: PodBatch,
                       cfg: ScoringConfig, quota=None, rsv=None, match=None,
                       boost: int = 10_000, trace: dict | None = None,
                       window: int = SCAN_WINDOW):
    """K4's and K4r's step as the kernel orders it, in PyTorch: returns
    (assignments, rsv_choice, new_state, new_rsv, new_quota) as
    :func:`greedy_scan_plain` does.

    - Admission: ``find`` walks the pods in priority order from a position
      to the first one valid and admitted by the current headroom.  While
      a step's pod is scored, the next pod is found against the headroom
      before its charge (speculation); after the charge that pod alone is
      re-checked and, if the charge took its headroom, the search resumes
      past it.  A charge that raises a headroom (a negative request, or a
      headroom wrapping past int32's minimum) may admit a pod rejected
      before it: the search then runs again from the charged pod on.
      The search reads the pods through a window of ``window`` positions
      in priority order, staged anew where a search starts outside it
      (also behind it: the speculated pod may have moved it past the
      charged one); a read outside the window raises.
    - The reservation fit (K4r) is read through each node's range
      ``[first[n], first[n + 1])`` of :func:`reservation_records` (sorted
      by node): a node fits through a record when a matched record of its
      range fits the pod; the nomination re-tests the chosen node's range
      and takes the smallest total remainder, the lowest record (row) on
      ties.
    ``trace``, when given, gets ``headroom``: the (headroom, min_headroom)
    before the scan and after each charge of the quota, ``resumed``: how
    many speculated pods the re-check turned away, and ``rose``: how many
    charges raised a headroom."""
    from koordinator_tpu_torch.ops.assignment import (
        _composite_score,
        _threshold_mask,
    )
    from koordinator_tpu_torch.quota.admission import (
        charge_quota,
        quota_admission_mask,
    )

    n, r = state.capacity, NUM_RESOURCE_DIMS
    order = priority_order(pods).tolist()
    valid = pods.valid.tolist()
    qids = pods.quota_id.tolist()
    nps = pods.non_preemptible.tolist()
    est_all = pod_estimates(pods, cfg)
    feasible_all = pods.feasible_rows(state)
    alloc, node_valid = state.node_allocatable, state.node_valid
    requested = state.node_requested.clone()
    est_added = torch.zeros_like(state.node_usage)
    assignments = torch.full((pods.capacity,), -1, dtype=torch.int32)
    rsv_choice = None
    if rsv is not None:
        rsv_choice = torch.full((pods.capacity,), -1, dtype=torch.int32)
        records, perm, _ = reservation_records(rsv, n, 1)
        rec_node = records[:, 2 * r].contiguous()
        first = torch.searchsorted(rec_node, torch.arange(n + 1,
                                                          dtype=torch.int32))
        flags = records[:, 2 * r + 2]
        reserved = records[:, :r]
        allocated = records[:, r:2 * r].clone()
    if trace is not None:
        trace["resumed"] = trace["rose"] = 0
        trace["headroom"] = ([] if quota is None else
                             [(quota.headroom, quota.min_headroom)])

    def admits(i: int) -> bool:
        return quota is None or bool(quota_admission_mask(
            quota, pods.requests[i:i + 1], pods.quota_id[i:i + 1],
            pods.non_preemptible[i:i + 1])[0])

    win = [0, 0]                                 # the staged [lo, hi)

    def staged(pos: int) -> int:
        """The pod at ``pos``, read through the window as the kernel does."""
        if not win[0] <= pos < win[1]:
            raise IndexError(f"position {pos} outside the window {win}")
        return order[pos]

    def find(pos: int) -> int:
        while pos < len(order):
            if not win[0] <= pos < win[1]:
                win[:] = [pos, min(len(order), pos + window)]
            idx = staged(pos)
            if valid[idx] and admits(idx):
                return pos
            pos += 1
        return -1

    def record_fits(req, free):
        """(V',) bool: each record's fit for ``req`` on its node."""
        rem = reserved - allocated
        free_at = free[rec_node.long()]
        unreq = req[None, :] == 0
        aligned = ((req[None, :] <= rem + free_at) | unreq).all(-1)
        restricted = (torch.where(reserved > 0, req[None, :] <= rem,
                                  req[None, :] <= free_at) | unreq).all(-1)
        ok = torch.where((flags & _RESTRICTED) != 0, restricted, aligned)
        return ok & (rem > 0).any(-1)

    pos = find(0)
    while pos >= 0:
        idx = order[pos]
        nxt = find(pos + 1)                      # the speculated next pod
        if nxt >= 0:
            staged(nxt)                          # loaded while idx is scored
        req, est = pods.requests[idx], est_all[idx]
        free = torch.where(node_valid[:, None], alloc - requested, 0)
        fits = torch.all((req[None, :] <= free) | (req[None, :] == 0), -1)
        if rsv is not None:
            ok = match[idx, perm] & record_fits(req, free)
            # any fitting record in each node's range
            run = torch.cat([torch.zeros(1, dtype=torch.int64),
                             ok.to(torch.int64).cumsum(0)])
            via = (run[first[1:]] - run[first[:-1]]) > 0
            fits = fits | via
        feasible = (fits
                    & _threshold_mask(cfg, state.node_usage + est_added,
                                      state.node_agg_usage + est_added,
                                      alloc, est[None, :])[0]
                    & feasible_all[idx] & node_valid)
        scores = _composite_score(cfg, alloc, requested,
                                  state.node_usage + est_added, req[None, :],
                                  est[None, :])[0]
        if rsv is not None:
            scores = scores + torch.where(via, boost, 0).to(scores.dtype)
        masked = torch.where(feasible, scores, -1)
        best = int(torch.argmax(masked))
        charged = rose = False
        if int(masked[best]) >= 0:
            add = req
            if rsv is not None:
                lo, hi = int(first[best]), int(first[best + 1])
                cand = [j for j in range(lo, hi) if bool(ok[j])]
                if cand:
                    total = (reserved - allocated).sum(-1).to(torch.int32)
                    j = min(cand, key=lambda c: (int(total[c]), c))
                    rem = reserved[j] - allocated[j]
                    take = torch.minimum(req, rem)
                    allocated[j] = (reserved[j] if int(flags[j]) & _ONCE
                                    else allocated[j] + take)
                    add = req - take
                    rsv_choice[idx] = int(perm[j])
            requested[best] += add
            est_added[best] += est
            assignments[idx] = best
            if quota is not None:
                q = qids[idx]
                charged = q >= 0 and bool(quota.valid[q])
                was = quota
                quota = charge_quota(quota, req, q,
                                     non_preemptible=nps[idx])
                rose = bool((quota.headroom > was.headroom).any()
                            | (quota.min_headroom > was.min_headroom).any())
                if trace is not None:
                    trace["headroom"].append((quota.headroom,
                                              quota.min_headroom))
        if rose:
            nxt = find(pos + 1)                  # search again
            if trace is not None:
                trace["rose"] += 1
        elif charged and nxt >= 0 and not admits(order[nxt]):
            nxt = find(nxt + 1)                  # resume past it
        if nxt >= 0:
            staged(nxt)                          # loaded for the next step
            if trace is not None:
                trace["resumed"] += 1
        pos = nxt
    new_rsv = None
    if rsv is not None:
        out = rsv.allocated.clone()
        out[perm] = allocated
        new_rsv = rsv.replace(allocated=out)
    return (assignments, rsv_choice, state.replace(node_requested=requested),
            new_rsv, quota)
