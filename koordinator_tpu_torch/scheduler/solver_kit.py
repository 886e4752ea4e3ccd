"""Shared solver entries: one set of instrumented entry points for N
schedulers (port of ``koordinator_tpu/scheduler/solver_kit.py``).

Every solve call of a :class:`~koordinator_tpu_torch.scheduler.scheduler.
Scheduler` goes through its kit.  A scheduler builds its own kit unless it
is handed one; two schedulers handed the same kit share its first-call
accounting (``ops/introspection.py``: ``solver_recompiles_total{fn, shape}``
counts the first call of an entry at each shape bucket), as the JAX
package's tenants share one jit cache.

The kit binds the port's entries under the JAX kit's names and shape
labels: ``solve`` (``gang_assign``), ``select_scored``, ``align_cands``,
``refresh_cands``, ``scatter_cands``, ``pass1``, ``pass2``, ``rsv_solve``,
``explain_counts`` and ``slack_sums`` instrumented, and ``preempt`` and
``preempt_chain`` plain, as the JAX kit leaves them.

The port solves on one device, with no mesh: ``mesh`` is None, both shard
counts are 1, no capacity shards, and every sharded twin (``*_sh``) is
None, as the JAX kit has them with its mesh off.  The quality, forecast
and topology-diameter entries stay None until the port has their modules.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.device import resolve_device


def _slack_sums(st):
    """Per-dim capacity-slack reduction ((N, R) -> two (R,) sums) over the
    live nodes; float32 accumulation (a 10k-node sum of int32 quantities
    overflows int32, and a ratio gauge needs no integer exactness)."""
    valid = st.node_valid[:, None]
    free = torch.where(valid, st.node_allocatable - st.node_requested, 0)
    alloc = torch.where(valid, st.node_allocatable, 0)
    return (free.to(torch.float32).sum(dim=0),
            alloc.to(torch.float32).sum(dim=0))


class SolverKit:
    """The device half's toolbox, shareable across Scheduler instances.
    ``device``: where the schedulers holding it keep their tensors (None
    means the GPU)."""

    def __init__(self, device=None):
        from koordinator_tpu_torch.ops import batch_assign as _ba
        from koordinator_tpu_torch.ops import explain as _ex
        from koordinator_tpu_torch.ops import introspection as insp
        from koordinator_tpu_torch.ops.gang import gang_assign
        from koordinator_tpu_torch.ops.preemption import (
            preempt_chain,
            preempt_one,
        )
        from koordinator_tpu_torch.ops.reservation import (
            reservation_greedy_assign,
        )

        self.device = resolve_device(device)
        # no solve mesh: one device.  shard_min_nodes is the JAX kit's
        # default floor, reported in the sharding document as it is there
        self.mesh = None
        self.shard_min_nodes = 1024
        self.shards = 1
        self.pod_shards = 1
        self.node_sharding = None
        self.pod_sharding = None
        self.sharding_active_for = lambda n_cap: False
        self.pods_shardable = lambda p_cap: False

        def _pn(args, kwargs):
            return f"P{args[1].capacity}xN{args[0].capacity}"

        self.solve = insp.instrument(gang_assign, "gang_assign",
                                     shape_of=_pn)
        self.select_scored = insp.instrument(
            _ba.select_candidates, "select_candidates", shape_of=_pn)
        self.align_cands = insp.instrument(
            _ba.align_candidate_cache, "align_candidate_cache",
            shape_of=lambda a, k: f"P{a[1].shape[0]}xN{a[3].shape[0]}")
        self.refresh_cands = insp.instrument(
            _ba.refresh_candidates, "refresh_candidates",
            shape_of=lambda a, k: (f"P{a[1].capacity}xN{a[0].capacity}"
                                   f"xD{a[4].shape[0]}"))
        self.scatter_cands = insp.instrument(
            _ba.scatter_candidate_rows, "scatter_candidate_rows",
            shape_of=lambda a, k: (f"P{a[0].cand_key.shape[0]}"
                                   f"xS{a[1].shape[0]}"))
        self.pass1 = insp.instrument(
            _ba.assign_round_pass, "assign_round_pass", shape_of=_pn)
        self.pass2 = insp.instrument(
            _ba.assign_followup_pass, "assign_followup_pass",
            shape_of=lambda a, k: f"P{a[2].capacity}xN{a[0].capacity}")
        self.solve_sh = None
        self.select_scored_sh = self.refresh_cands_sh = None
        self.pass1_sh = self.pass2_sh = None

        # quality mode, the forecast plane and the topology diameter: not
        # in the port yet
        self.quality_solve = self.quality_solve_sh = None
        self.topo_diameter = None
        self.forecast_solve = self.forecast_solve_sh = None

        self.rsv_solve = insp.instrument(
            reservation_greedy_assign, "reservation_greedy_assign",
            shape_of=_pn)
        self.preempt = preempt_one
        self.preempt_chain = preempt_chain
        #: reject-reason reduction over a round's compacted failed rows
        #: (K7): only (F, NUM_REASONS) comes back to the host
        self.explain_counts = insp.instrument(
            _ex.explain_counts, "explain_counts", shape_of=_pn)
        self.slack_sums = insp.instrument(
            _slack_sums, "capacity_slack",
            shape_of=lambda a, k: f"N{a[0].capacity}")
