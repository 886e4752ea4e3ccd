"""Quota overuse revoke: evict pods of quotas whose used exceeds runtime
(port of ``koordinator_tpu/quota/overuse_revoke.py``).

koordinator's ``quota_overuse_revoke.go``: a per-quota monitor flags quotas
whose used has exceeded runtime continuously for ``delay_evict_sec`` (the
runtime shrinks when other quotas' requests rise, so admitted pods can
overshoot); victim selection then walks the quota's pods least-important
first, removing them until used <= runtime, and finally tries to assign them
back most-important first (getToRevokePodList).

The JAX package runs both walks as two scans over every bound pod in one
global order; each step reads and writes only its own quota's ``used``, so
the scans split into independent per-quota walks.  On CUDA tensors
:func:`select_overuse_victims` runs K6 (``kernels/overuse_revoke.py``, a
warp per quota, 32 rows a step forward and the reprieve over staged tiles
back), on the CPU :func:`select_overuse_victims_plain`.  Used and
runtime are compared on the quota's declared-max (checked) dims, as the
admission does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from koordinator_tpu_torch.ops.preemption import ScheduledPods, wrap32


def overuse_keys(sched: ScheduledPods, q_cap: int, pdb_allowed=None):
    """Each row's list key and quota counts: (key (V,) int64, counts
    (Q + 1,), blocked (Q + 1,)), the plain version of K6's first launch.
    Candidates are the valid, preemptible pods of a quota row in [0, q_cap)
    that no exhausted PDB protects; a candidate's key is (quota << 32) |
    (priority + 2**31), every other row's (q_cap << 32) | (priority +
    2**31), so a stable sort lists each quota's candidates in ascending
    importance (priority, then row) and the other rows after them.
    ``counts[q]`` counts the rows keyed to q; ``blocked[q]`` is 1 where an
    exhausted PDB protects a pod of quota q."""
    quota = sched.quota_id
    dev = quota.device
    cand = sched.valid & ~sched.non_preemptible & (quota >= 0)
    blocked = torch.zeros_like(cand)
    if pdb_allowed is not None:
        b = pdb_allowed.shape[0]
        # exhausted budgets exclude pods inside the selection (the
        # reference's gather clamps the PDB row)
        blocked = cand & (sched.pdb_id >= 0) & (
            pdb_allowed[torch.clamp(sched.pdb_id, 0, b - 1).long()] <= 0)
        cand = cand & ~blocked
    in_range = quota < q_cap
    seg = torch.where(cand & in_range, quota, q_cap).to(torch.int64)
    key = (seg << 32) | (sched.priority.to(torch.int64) + 2**31)
    counts = torch.zeros(q_cap + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    held = torch.where(blocked & in_range, quota, q_cap).to(torch.int64)
    blocked_count = torch.zeros(q_cap + 1, dtype=torch.int32, device=dev)
    blocked_count.index_add_(0, held, torch.ones_like(held,
                                                      dtype=torch.int32))
    blocked_count[q_cap] = 0
    return key, counts, (blocked_count > 0).to(torch.int32)


def overuse_lists(sched: ScheduledPods, q_cap: int, pdb_allowed=None):
    """The walks' inputs (rows, offsets, has_blocked) from
    :func:`overuse_keys`, with one stable sort and no host
    synchronisation.  ``rows[offsets[q]:offsets[q + 1]]`` are quota q's
    candidates in ascending importance, int32, and every other row follows
    ``offsets[Q]`` (``rows`` holds all V); ``has_blocked`` (Q,) marks the
    quotas holding a pod an exhausted PDB protects.  Rows outside any
    quota map to quota 0 in the reference and change nothing there: they
    are left out."""
    key, counts, blocked = overuse_keys(sched, q_cap, pdb_allowed)
    rows = torch.sort(key, stable=True).indices
    offsets = torch.zeros(q_cap + 1, dtype=torch.int32, device=key.device)
    offsets[1:] = torch.cumsum(counts[:q_cap], 0)
    return rows.to(torch.int32), offsets, blocked[:q_cap] > 0


def select_overuse_victims_plain(sched: ScheduledPods, used, runtime,
                                 checked, pdb_allowed=None) -> torch.Tensor:
    """The JAX package's ``select_overuse_victims``, per quota.  Phase 1
    (ascending importance): while the quota is still over on a checked dim,
    remove the pod; the removals are a prefix of the quota's list, found
    from the running sums at once.  A quota over even with every candidate
    removed is hopeless: with a PDB-blocked pod in it, it is skipped (no
    pod goes), otherwise every candidate goes.  Phase 2 (descending): the
    removed pods of the other quotas come back one at a time, all quotas a
    step, while they fit under runtime on the checked dims.  Returns the
    (V,) bool revoke mask."""
    dev = sched.requests.device
    q_cap = used.shape[0]
    rows, offsets, has_blocked = overuse_lists(sched, q_cap, pdb_allowed)
    rows = rows[:int(offsets[-1])].long()
    qrow = sched.quota_id[rows].long()
    req = sched.requests[rows]
    m = rows.shape[0]
    start = offsets[:-1].long()
    length = (offsets[1:] - offsets[:-1]).long()
    # phase 1: used before each step, from the running sums (wrapping)
    cs = torch.cumsum(req.to(torch.int64), 0)
    before = cs - req.to(torch.int64)
    seg_base = torch.zeros((q_cap, req.shape[1]), dtype=torch.int64,
                           device=dev)
    if m:
        seg_base = before[torch.clamp(start, max=m - 1)]
    u_before = wrap32(used.to(torch.int64)[qrow] - (before - seg_base[qrow]))
    over = torch.any((u_before > runtime[qrow]) & checked[qrow], dim=-1)
    t = torch.arange(m, device=dev) - start[qrow]
    stop = length.clone()
    stop.scatter_reduce_(0, qrow, torch.where(over, length[qrow], t), "amin")
    tentative = t < stop[qrow]
    taken = torch.zeros((q_cap, req.shape[1]), dtype=torch.int64,
                        device=dev)
    taken.index_add_(0, qrow[tentative], req[tentative].to(torch.int64))
    u = wrap32(used.to(torch.int64) - taken)
    hopeless = torch.any((u > runtime) & checked, dim=-1)
    skip = hopeless & has_blocked

    # phase 2: the reprieve, each quota's removed pods in reverse; at step
    # s the quotas that removed more than s pods, longest walk first
    revoke = torch.zeros(sched.capacity, dtype=torch.bool, device=dev)
    order = torch.sort(stop, descending=True, stable=True).indices
    walks = sorted(stop.tolist(), reverse=True)
    active = len(walks)
    for s in range(walks[0] if walks else 0):
        while walks[active - 1] <= s:
            active -= 1
        qs = order[:active]
        pos = start[qs] + stop[qs] - 1 - s
        r, rq = rows[pos], req[pos]
        fits = torch.all((u[qs] + rq <= runtime[qs]) | (rq == 0)
                         | ~checked[qs], dim=-1)
        back = (fits & ~hopeless[qs]) | skip[qs]
        u[qs] = u[qs] + torch.where(back[:, None], rq, 0)
        revoke[r] = ~back
    return revoke


def select_overuse_victims(sched: ScheduledPods, used, runtime, checked,
                           pdb_allowed=None) -> torch.Tensor:
    """(V,) bool revoke mask across every quota at once: K6 on CUDA
    tensors, :func:`select_overuse_victims_plain` on the CPU.  ``used`` and
    ``runtime`` are (Q, R) int32, ``checked`` (Q, R) bool (the dims declared
    in the quota's max), ``pdb_allowed`` (B,) int32 budgets or None."""
    # imported here: the kernel module imports this one
    from koordinator_tpu_torch.kernels import overuse_revoke as k6

    return k6.overuse_revoke_kernel(sched, used, runtime, checked,
                                    pdb_allowed)


class QuotaOveruseRevokeController:
    """The host loop: the monitor's timers and the eviction callback around
    :func:`select_overuse_victims`.

    ``scheduler`` supplies the bound pods and the quota tree; victims are
    evicted through ``revoke_fn(pod_name, quota_name)`` and released through
    the scheduler's own accounting (node charge and quota used)."""

    def __init__(self, scheduler, revoke_fn, delay_evict_sec: float = 5.0,
                 clock=time.monotonic):
        if revoke_fn is None:
            # releasing a victim's accounting without anyone evicting it
            # would oversubscribe its node against a still-running pod
            raise ValueError("overuse revoke needs a revoke_fn that "
                             "performs the eviction")
        self.scheduler = scheduler
        self.revoke_fn = revoke_fn
        self.delay_evict_sec = delay_evict_sec
        self.clock = clock
        self._last_under: dict[str, float] = {}

    @staticmethod
    def _over_used(qnode) -> bool:
        from koordinator_tpu_torch.quota.tree import UNBOUNDED

        checked = qnode.max != UNBOUNDED
        return bool(np.any((qnode.used > qnode.runtime) & checked))

    def monitor(self) -> list[str]:
        """Quotas over-used continuously past the delay (monitor())."""
        tree = self.scheduler.quota_tree
        if tree is None:
            return []
        now = self.clock()
        triggered = []
        for name, qnode in tree.nodes.items():
            if self._over_used(qnode):
                since = self._last_under.setdefault(name, now)
                if now - since > self.delay_evict_sec:
                    triggered.append(name)
                    self._last_under[name] = now  # re-arm after trigger
            else:
                self._last_under[name] = now
        return triggered

    def revoke_once(self) -> list[str]:
        """One controller cycle: returns the evicted pod names."""
        triggered = set(self.monitor())
        if not triggered:
            return []
        sched_ = self.scheduler
        tree = sched_.quota_tree
        quota_index = {n: i for i, n in enumerate(sorted(tree.nodes))}
        sched, bound_names = sched_._build_scheduled(quota_index)
        if not bound_names:
            return []

        from koordinator_tpu_torch.quota.admission import HEADROOM_CLAMP
        from koordinator_tpu_torch.quota.tree import UNBOUNDED

        q = len(quota_index)
        used = np.zeros((max(q, 1), sched.requests.shape[1]), np.int32)
        runtime = np.zeros_like(used)
        checked = np.zeros(used.shape, bool)
        for name, i in quota_index.items():
            qnode = tree.nodes[name]
            used[i] = np.clip(qnode.used, 0, HEADROOM_CLAMP)
            runtime[i] = np.clip(qnode.runtime, 0, HEADROOM_CLAMP)
            # only triggered quotas take part; the others are never over
            if name in triggered:
                checked[i] = qnode.max != UNBOUNDED

        _, pdb_allowed = sched_._pdb_arrays()
        dev = sched.requests.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        revoke = select_overuse_victims(
            sched, t(used), t(runtime), t(checked),
            t(pdb_allowed)).cpu().numpy()
        evicted = []
        for v in np.flatnonzero(revoke):
            name = bound_names[v]
            bp = sched_.bound.get(name)
            if bp is None:
                continue
            # PDB budgets bind here as in the preemption path: a pod whose
            # budget is exhausted survives (the quota stays armed)
            matching = [rec for rec in sched_.pdbs.values()
                        if rec.matches(bp.labels)]
            if any(rec.allowed <= 0 for rec in matching):
                continue
            for rec in matching:
                rec.allowed -= 1
            quota = bp.quota
            sched_.remove_bound_pod(name)
            sched_._charge_quota_used(bp, sign=-1)
            self.revoke_fn(name, quota)
            evicted.append(name)
        return evicted
