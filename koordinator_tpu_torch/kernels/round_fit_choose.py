"""K3a: one propose/accept round's candidate fit and choice.

:func:`round_fit_choose` is the wrapper: CPU tensors take
:func:`round_fit_choose_plain`, CUDA tensors launch
``csrc/round_fit_choose.cu``.  The plain version is the fit-and-choose part
of the JAX round body (``ops/batch_assign.py`` ``_assign_rounds.round_body``
with ``_choose_candidate``), in both key regimes: past
``PACKED_NODE_CAPACITY`` node rows the choice ranks by (key, tie-break),
the tie-break recomputed from each candidate's node and the pod's
rotation id.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.resources import NUM_RESOURCE_DIMS
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import (
    _candidate_tb,
    _packed_regime,
)


def _choose_candidate(cand_key: torch.Tensor, cand_tb, fits: torch.Tensor
                      ) -> torch.Tensor:
    """(P,) column of each pod's best FITTING candidate by (key, tb) rank;
    the first column wins a tie and column 0 is returned when nothing
    fits, as ``jnp.argmax`` does.  The packed key encodes the tie-break
    (``cand_tb`` is None); the wide regime takes the max key, then the
    max tb among the fitting columns at that key."""
    masked = torch.where(fits, cand_key, -1)
    if cand_tb is None:
        return torch.argmax(masked, dim=1)
    best_key = masked.max(dim=1, keepdim=True).values
    return torch.argmax(torch.where(fits & (masked == best_key), cand_tb, -1),
                        dim=1)


def round_fit_choose_plain(cand_key, cand_node, free, requests, active,
                           rot_id):
    """(choice, has), each (P,): the node of each active pod's best
    candidate that fits ``free`` (``req <= free | req == 0`` on every dim),
    and whether one fits.  Inactive pods report has = False and their
    slot-0 node.  ``free`` has one row a node of the capacity, which sets
    the key regime; the wide regime's tie-break takes the pods' ``rot_id``,
    the ids the candidates were ranked with."""
    n_total = free.shape[0]
    cand_valid = cand_key >= 0
    cand_free = free[cand_node.long()]                    # (P, k, R)
    req = requests[:, None, :]
    fits = torch.all((req <= cand_free) | (req == 0), dim=-1) & cand_valid
    cand_tb = None
    if not _packed_regime(n_total):
        cand_tb = _candidate_tb(cand_node, rot_id, n_total)
    best = _choose_candidate(cand_key, cand_tb, fits)[:, None]
    has = torch.gather(fits, 1, best)[:, 0] & active
    choice = torch.gather(cand_node, 1, best)[:, 0]
    return torch.where(active, choice, cand_node[:, 0]), has


def round_fit_choose(cand_key, cand_node, free, requests, active, rot_id):
    """K3a's wrapper; see :func:`round_fit_choose_plain`."""
    if build.on_cpu(cand_key, cand_node, free, requests, active, rot_id):
        return round_fit_choose_plain(cand_key, cand_node, free, requests,
                                      active, rot_id)
    p, k = cand_key.shape
    n, r = free.shape[0], NUM_RESOURCE_DIMS
    if k > 32:
        raise ValueError(f"the kernel takes at most 32 candidates, got {k}")
    build.expect(cand_key, "cand_key", torch.int32, (p, k))
    build.expect(cand_node, "cand_node", torch.int32, (p, k))
    build.expect(free, "free", torch.int32, (n, r))
    build.expect(requests, "requests", torch.int32, (p, r))
    build.expect(active, "active", torch.bool, (p,))
    build.expect(rot_id, "rot_id", torch.int32, (p,))
    # the packed key carries the tie-break: the kernel reads rot_id only
    # in the wide regime
    rot = None if _packed_regime(n) else rot_id
    choice = torch.empty(p, dtype=torch.int32, device=cand_key.device)
    has = torch.empty(p, dtype=torch.bool, device=cand_key.device)
    if p == 0:
        return choice, has
    err = build.lib().koord_round_fit_choose(
        build.ptr(cand_key), build.ptr(cand_node), build.ptr(free),
        build.ptr(requests), build.ptr(active), build.ptr(rot), p, k, n,
        build.ptr(choice), build.ptr(has), build.stream_of(choice))
    build.check(err, "round_fit_choose")
    build.LAUNCHES["round_fit_choose"] += 1
    return choice, has
