"""K3b: segmented priority-order prefix acceptance of a contended round.

:func:`segmented_prefix_accept` is the wrapper: CPU tensors take
:func:`segmented_prefix_accept_plain`, CUDA tensors sort the segment keys
(a stable ``torch.sort``) and launch ``csrc/segmented_prefix_accept.cu``.
The plain version is the JAX package's ``_prefix_accept_sorted_choice``
(``ops/batch_assign.py``): a stable sort groups the segments in priority
order, and one cumulative sum with a running max of segment starts gives
each pod's within-segment prefix.
"""

from __future__ import annotations

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


def segmented_prefix_accept(seg, requests, choice_free, order, active,
                            num_segments: int):
    """K3b's wrapper; see :func:`segmented_prefix_accept_plain`."""
    if build.on_cpu(seg, requests, choice_free, order, active):
        return segmented_prefix_accept_plain(seg, requests, choice_free,
                                             order, active, num_segments)
    p, r = requests.shape[0], NUM_RESOURCE_DIMS
    build.expect(seg, "seg", torch.int32, (p,))
    build.expect(requests, "requests", torch.int32, (p, r))
    build.expect(choice_free, "choice_free", torch.int32, (p, r))
    build.expect(order, "order", torch.int64, (p,))
    build.expect(active, "active", torch.bool, (p,))
    fits = torch.zeros(p, dtype=torch.bool, device=seg.device)
    if p == 0:
        return fits
    pos = torch.sort(seg[order], stable=True).indices
    err = build.lib().koord_segmented_prefix_accept(
        build.ptr(pos), build.ptr(order), build.ptr(seg), build.ptr(requests),
        build.ptr(choice_free), build.ptr(active), p, num_segments,
        build.ptr(fits), build.stream_of(fits))
    build.check(err, "segmented_prefix_accept")
    build.LAUNCHES["segmented_prefix_accept"] += 1
    return fits
