"""K6: the quota overuse revoke walks (``csrc/overuse_revoke.cu``).

:func:`overuse_revoke_kernel` is the wrapper: CPU tensors take the plain
version, ``quota/overuse_revoke.py`` :func:`select_overuse_victims_plain`;
CUDA tensors launch K6 twice with one sort between, and no host
synchronisation: the keys launch (each row's (quota, priority) key, the
rows and PDB-blocked pods of each quota; its plain version
:func:`~koordinator_tpu_torch.quota.overuse_revoke.overuse_keys`), one
stable sort of the keys (each quota's candidates in ascending importance),
then the walks: a warp a quota, phase 1 forward 32 rows a step (lanes on
rows, prefix sums and a ballot), phase 2 back a pod a step (lanes on the
resource dimensions, the requests staged in shared memory a tile ahead).
Each launch adds one to K6's count.  A launch the card refuses raises.  :func:`overuse_revoke_mirror` is the same decomposition in Python,
held against the reference on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.ops.preemption import wrap32
from koordinator_tpu_torch.quota.overuse_revoke import (
    overuse_lists,
    select_overuse_victims_plain,
)

WARP = 32


def overuse_keys_launch(sched, q_cap: int, pdb_allowed=None):
    """K6's first launch: (key (V,) int64, counts (Q + 1,), blocked (Q + 1,)
    int32, as :func:`~koordinator_tpu_torch.quota.overuse_revoke.
    overuse_keys` returns them, and the (V,) revoke mask cleared)."""
    v = sched.capacity
    for name in ("quota_id", "priority", "pdb_id"):
        build.expect(getattr(sched, name), f"sched.{name}", torch.int32,
                     (v,))
    for name in ("valid", "non_preemptible"):
        build.expect(getattr(sched, name), f"sched.{name}", torch.bool,
                     (v,))
    b = 0
    if pdb_allowed is not None:
        b = pdb_allowed.shape[0]
        build.expect(pdb_allowed, "pdb_allowed", torch.int32, (b,))
    dev = sched.quota_id.device
    key = torch.empty(v, dtype=torch.int64, device=dev)
    counts = torch.empty(q_cap + 1, dtype=torch.int32, device=dev)
    blocked = torch.empty(q_cap + 1, dtype=torch.int32, device=dev)
    revoke = torch.empty(v, dtype=torch.bool, device=dev)
    err = build.lib().koord_overuse_keys(
        build.ptr(sched.quota_id), build.ptr(sched.priority),
        build.ptr(sched.valid), build.ptr(sched.non_preemptible),
        build.ptr(sched.pdb_id), build.ptr(pdb_allowed), b, v, q_cap,
        build.ptr(key), build.ptr(counts), build.ptr(blocked),
        build.ptr(revoke), build.stream_of(key))
    build.check(err, "overuse_keys")
    build.LAUNCHES["overuse_revoke"] += 1
    return key, counts, blocked, revoke


def overuse_revoke_launch(sched, used, runtime, checked, pdb_allowed=None):
    """K6: the keys launch, one stable sort, the walks' launch.  Returns
    (revoke (V,) bool, walk (Q,) int32, the number of pods phase 1
    removed from each quota)."""
    q, r = used.shape
    v = sched.capacity
    build.expect(sched.requests, "sched.requests", torch.int32,
                 (v, NUM_RESOURCE_DIMS))
    build.expect(used, "used", torch.int32, (q, r))
    build.expect(runtime, "runtime", torch.int32, (q, r))
    build.expect(checked, "checked", torch.bool, (q, r))
    key, counts, blocked, revoke = overuse_keys_launch(sched, q, pdb_allowed)
    rows = torch.sort(key, stable=True).indices
    walk = torch.empty(q, dtype=torch.int32, device=used.device)
    err = build.lib().koord_overuse_revoke(
        build.ptr(sched.requests), build.ptr(rows), build.ptr(counts),
        build.ptr(blocked), q, build.ptr(used), build.ptr(runtime),
        build.ptr(checked), build.ptr(revoke), build.ptr(walk),
        build.stream_of(used))
    build.check(err, "overuse_revoke")
    build.LAUNCHES["overuse_revoke"] += 1
    return revoke, walk


def overuse_revoke_kernel(sched, used, runtime, checked, pdb_allowed=None):
    """K6's wrapper: the (V,) bool revoke mask as
    :func:`select_overuse_victims_plain` returns it."""
    if build.on_cpu(sched.requests, used, runtime,
                    None if pdb_allowed is None else pdb_allowed):
        return select_overuse_victims_plain(sched, used, runtime, checked,
                                            pdb_allowed)
    return overuse_revoke_launch(sched, used, runtime, checked,
                                 pdb_allowed)[0]


def overuse_revoke_mirror(sched, used, runtime, checked, pdb_allowed=None):
    """K6's walk in Python, as the kernel decomposes it: for each quota,
    phase 1 down its list 32 rows a step (each row's used before its
    removal from the chunk's exclusive prefix sums; the first row of the
    chunk not over on a checked dim, a ballot, stops the walk there), then
    phase 2 back up the removed prefix over 32-row tiles: a skipped quota
    keeps every pod, a hopeless one loses every removed pod, the others
    reprieve each pod that fits, one a step.  Returns (revoke (V,) bool,
    walk (Q,)) as numpy arrays."""
    q_cap = used.shape[0]
    rows, offsets, has_blocked = (t.cpu().numpy() for t in overuse_lists(
        sched, q_cap, pdb_allowed))
    req = sched.requests.cpu().numpy().astype(np.int64)
    used, runtime = used.cpu().numpy(), runtime.cpu().numpy()
    checked = checked.cpu().numpy()
    revoke = np.zeros(sched.capacity, bool)
    walk = np.zeros(q_cap, np.int32)
    for q in range(q_cap):
        start, end = int(offsets[q]), int(offsets[q + 1])
        u = used[q].astype(np.int64)
        rt, ck = runtime[q], checked[q]
        k = end - start
        for base in range(start, end, WARP):
            r = req[rows[base:min(base + WARP, end)]]
            ex = np.cumsum(r, axis=0) - r
            before = wrap32(u[None, :] - ex)
            over = ((before > rt) & ck).any(axis=1)
            if not over.all():
                lane = int(np.argmin(over))          # the ballot's first
                k = base - start + lane
                u = before[lane]
                break
            u = wrap32(u - r.sum(axis=0))
        walk[q] = k
        if ((u > rt) & ck).any():                    # hopeless
            if not has_blocked[q]:
                revoke[rows[start:start + k]] = True
            continue
        for tile in range((k - 1) // WARP, -1, -1):
            lo = start + tile * WARP
            staged = rows[lo:min(lo + WARP, start + k)]
            for i in range(len(staged) - 1, -1, -1):
                rd = req[staged[i]]
                back = bool((((wrap32(u + rd) <= rt) | (rd == 0) | ~ck)).all())
                if back:
                    u = wrap32(u + rd)
                else:
                    revoke[staged[i]] = True
    return revoke, walk
