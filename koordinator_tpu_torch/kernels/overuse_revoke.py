"""K6: the quota overuse revoke walks (``csrc/overuse_revoke.cu``).

:func:`overuse_revoke_kernel` is the wrapper: CPU tensors take the plain
version, ``quota/overuse_revoke.py`` :func:`select_overuse_victims_plain`;
CUDA tensors get each quota's candidates in ascending importance
(:func:`~koordinator_tpu_torch.quota.overuse_revoke.overuse_lists`, torch
glue) and launch K6 once: a warp a quota, the lanes holding the resource
dimensions, walking phase 1 forward and phase 2 back.  A launch the card
refuses raises.  :func:`overuse_revoke_mirror` is the same walk in Python,
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


def overuse_revoke_launch(sched, used, runtime, checked, pdb_allowed=None):
    """Launch K6: returns (revoke (V,) bool, walk (Q,) int32, the number of
    pods phase 1 removed from each quota)."""
    q, r = used.shape
    v = sched.capacity
    build.expect(sched.requests, "sched.requests", torch.int32,
                 (v, NUM_RESOURCE_DIMS))
    build.expect(used, "used", torch.int32, (q, r))
    build.expect(runtime, "runtime", torch.int32, (q, r))
    build.expect(checked, "checked", torch.bool, (q, r))
    rows, offsets, has_blocked = overuse_lists(sched, q, pdb_allowed)
    dev = used.device
    revoke = torch.zeros(v, dtype=torch.bool, device=dev)
    walk = torch.zeros(q, dtype=torch.int32, device=dev)
    lib = build.lib()
    err = lib.koord_overuse_revoke(
        build.ptr(sched.requests), build.ptr(offsets), build.ptr(rows), q,
        build.ptr(used), build.ptr(runtime), build.ptr(checked),
        build.ptr(has_blocked), build.ptr(revoke), build.ptr(walk),
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
    """K6's walk in Python: for each quota, phase 1 down its list while the
    quota is over on a checked dim (a vote over the lanes), then phase 2
    back up the removed prefix: a skipped quota keeps every pod, a hopeless
    one loses every removed pod, the others reprieve each pod that fits.
    Returns (revoke (V,) bool, walk (Q,)) as numpy arrays."""
    q_cap = used.shape[0]
    rows, offsets, has_blocked = (t.cpu().numpy() for t in overuse_lists(
        sched, q_cap, pdb_allowed))
    req = sched.requests.cpu().numpy().astype(np.int64)
    used, runtime = used.cpu().numpy(), runtime.cpu().numpy()
    checked = checked.cpu().numpy()
    revoke = np.zeros(sched.capacity, bool)
    walk = np.zeros(q_cap, np.int32)
    dims = used.shape[1]
    for q in range(q_cap):
        start, end = int(offsets[q]), int(offsets[q + 1])
        u = [int(x) for x in used[q]]
        rt = [int(x) for x in runtime[q]]
        ck = [bool(x) for x in checked[q]]

        def over():
            return any(u[d] > rt[d] and ck[d] for d in range(dims))

        k = 0
        while start + k < end and over():
            row = int(rows[start + k])
            u = [wrap32(u[d] - int(req[row, d])) for d in range(dims)]
            k += 1
        walk[q] = k
        hopeless = over()
        skip = hopeless and bool(has_blocked[q])
        for pos in range(start + k - 1, start - 1, -1):
            row = int(rows[pos])
            rd = [int(x) for x in req[row]]
            if skip:
                back = True
            elif hopeless:
                back = False
            else:
                back = all(wrap32(u[d] + rd[d]) <= rt[d] or rd[d] == 0
                           or not ck[d] for d in range(dims))
            if back:
                u = [wrap32(u[d] + rd[d]) for d in range(dims)]
            else:
                revoke[row] = True
    return revoke, walk
