"""Fine-grained CPU orchestration: cpuset accumulation + NUMA topology hints
(port of ``koordinator_tpu/ops/numa.py``).

The reference's nodenumaresource plugin (pkg/scheduler/plugins/
nodenumaresource/: cpu_accumulator.go takeCPUs, topology_hint.go) and the
scheduler-side topology manager (pkg/scheduler/frameworkext/
topologymanager/: policies none/best-effort/restricted/single-numa-node).

- **Filter is batched, count-based.** Whether a pod's cpuset request fits a
  node needs only per-NUMA/per-socket free counts: segment sums over the
  (nodes x cpus) topology tensors, over every node at once.
- **Reserve is single-node, sort-based.** The cpuset selection runs once on
  the chosen node: a lexicographic priority key per logical CPU from
  (eligibility, NUMA-satisfies-alone, NUMA allocate strategy, socket/core
  grouping, sibling rank), a stable sort, the first n taken.

Bind policies (apis/extension/numa_aware.go:101-107): FullPCPUs allocates
whole physical cores; SpreadByPCPUs allocates one sibling per core first.
NUMA allocate strategies: MostAllocated packs the fullest NUMA node first,
LeastAllocated spreads to the emptiest.

Every function is torch ops on the tensors' device; segment sums and
gathers keep JAX's out-of-range semantics (``ops/select.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.select import (
    gather,
    int32_like,
    segment_sum,
    take_by_rank,
)
from koordinator_tpu_torch.state.cluster_state import _bucket

#: Hint enumeration bound: masks are enumerated statically as 2^MAX_NUMA
#: combinations (the reference's bitmask.IterateBitMasks over NUMA nodes).
MAX_NUMA = 8

# CPUBindPolicy (numa_aware.go:101-107)
BIND_DEFAULT = 0
BIND_FULL_PCPUS = 1
BIND_SPREAD_BY_PCPUS = 2

# NUMAAllocateStrategy
STRATEGY_MOST_ALLOCATED = 0   # pack: prefer NUMA nodes with least free
STRATEGY_LEAST_ALLOCATED = 1  # spread: prefer NUMA nodes with most free

# CPUExclusivePolicy (numa_aware.go:114-118)
EXCLUSIVE_NONE = 0
EXCLUSIVE_PCPU_LEVEL = 1      # no other pod may share my physical cores
EXCLUSIVE_NUMA_LEVEL = 2      # no other pod may share my NUMA nodes

# Topology manager policies (frameworkext/topologymanager/policy_*.go)
POLICY_NONE = 0
POLICY_BEST_EFFORT = 1
POLICY_RESTRICTED = 2
POLICY_SINGLE_NUMA_NODE = 3

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class CPUTopology:
    """Per-logical-CPU topology arrays, padded to a static CPU capacity C
    ((N, C) when batched over nodes)."""

    core_of: torch.Tensor     # (C,) int32 physical core id (< C)
    numa_of: torch.Tensor     # (C,) int32 NUMA node id (< MAX_NUMA)
    socket_of: torch.Tensor   # (C,) int32
    valid: torch.Tensor       # (C,) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    @classmethod
    def build(cls, core_of, numa_of, socket_of, capacity: int | None = None,
              device=None) -> "CPUTopology":
        dev = resolve_device(device)
        n = len(core_of)
        cap = capacity or _bucket(max(n, 1), minimum=8)

        def pad(a):
            out = np.zeros(cap, np.int32)
            out[:n] = a
            return torch.from_numpy(out).to(dev)

        valid = np.zeros(cap, bool)
        valid[:n] = True
        return cls(pad(core_of), pad(numa_of), pad(socket_of),
                   torch.from_numpy(valid).to(dev))

    @classmethod
    def uniform(cls, sockets: int = 1, numa_per_socket: int = 1,
                cores_per_numa: int = 4, threads_per_core: int = 2,
                capacity: int | None = None, device=None) -> "CPUTopology":
        """Synthetic SMT topology (lscpu-shaped, util/system/lscpu.go)."""
        n = sockets * numa_per_socket * cores_per_numa * threads_per_core
        cpu = np.arange(n)
        core = cpu // threads_per_core
        numa = core // cores_per_numa
        sock = numa // numa_per_socket
        return cls.build(core, numa, sock, capacity=capacity, device=device)


def _round_up_to_cores(topo: CPUTopology, n_cpus) -> torch.Tensor:
    """Round a cpu count up to a multiple of threads-per-core."""
    core_size = segment_sum(topo.valid, topo.core_of, topo.capacity)
    tpc = torch.clamp(torch.amax(core_size, dim=-1), min=1)
    n = int32_like(n_cpus, core_size)
    return ((n + tpc - 1) // tpc) * tpc


def _counts(topo: CPUTopology, free: torch.Tensor):
    """Shared count tensors: per-core/NUMA free + full-core stats."""
    c = topo.capacity
    core_size = segment_sum(topo.valid, topo.core_of, c)
    core_free = segment_sum(free, topo.core_of, c)
    cpu_on_full_core = ((gather(core_free, topo.core_of)
                         == gather(core_size, topo.core_of)) & free)
    numa_free = segment_sum(free, topo.numa_of, MAX_NUMA)
    numa_full = segment_sum(cpu_on_full_core, topo.numa_of, MAX_NUMA)
    return cpu_on_full_core, numa_free, numa_full


def _free(topo: CPUTopology, ref_count, max_ref, banned):
    mr = int32_like(max_ref, ref_count)
    if mr.dim():
        mr = mr[..., None]
    free = topo.valid & (ref_count < mr)
    if banned is not None:
        free = free & ~banned
    return free


def cpuset_fit(topo: CPUTopology, ref_count: torch.Tensor, max_ref, n_cpus,
               full_pcpus: bool = False,
               banned: torch.Tensor | None = None) -> torch.Tensor:
    """() bool: can this node satisfy the cpuset request at all (Filter).
    ((N,) when ``topo``, ``ref_count`` and ``max_ref`` are batched.)"""
    free = _free(topo, ref_count, max_ref, banned)
    cpu_full, _, _ = _counts(topo, free)
    if full_pcpus:
        # Whole-core policy: a non-multiple request rounds up to whole
        # cores (a partially-taken core would reintroduce SMT interference)
        n_eff = _round_up_to_cores(topo, n_cpus)
        return torch.sum(cpu_full, dim=-1, dtype=torch.int32) >= n_eff
    return (torch.sum(free, dim=-1, dtype=torch.int32)
            >= int32_like(n_cpus, ref_count))


def cpuset_fit_batched(topos: CPUTopology, ref_counts: torch.Tensor,
                       max_ref: torch.Tensor, n_cpus,
                       full_pcpus: bool = False) -> torch.Tensor:
    """(N,) bool: the Filter over every node (the batched hot path)."""
    return cpuset_fit(topos, ref_counts, max_ref, n_cpus,
                      full_pcpus=full_pcpus)


def take_cpus(topo: CPUTopology, ref_count: torch.Tensor, max_ref, n_cpus,
              bind_policy: int = BIND_DEFAULT,
              strategy: int = STRATEGY_MOST_ALLOCATED,
              banned: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Select a cpuset on one node: returns ((C,) bool selection, ok).

    Sort keys (one stable sort replaces the accumulator's walks):
      1. eligible first (free; FullPCPUs additionally requires a fully-free
         core)
      2. CPUs whose NUMA node can satisfy the whole request alone
      3. NUMA nodes ordered by allocate strategy (pack vs spread)
      4. same core adjacent (FullPCPUs takes whole cores) or sibling-rank
         round-robin (SpreadByPCPUs takes one sibling per core first)
      5. cpu index (determinism)
    """
    c = topo.capacity
    dev = ref_count.device
    free = _free(topo, ref_count, max_ref, banned)
    cpu_full, numa_free, numa_full = _counts(topo, free)

    full = bind_policy == BIND_FULL_PCPUS
    eligible = cpu_full if full else free
    pool = numa_full if full else numa_free
    n_cpus = (_round_up_to_cores(topo, n_cpus) if full
              else int32_like(n_cpus, ref_count))

    # (2) does this cpu's NUMA node alone satisfy the request?
    numa_satisfies = gather(pool >= n_cpus, topo.numa_of) & eligible
    # (3) strategy order among NUMA nodes
    numa_key = gather(pool, topo.numa_of)
    numa_order = (numa_key if strategy == STRATEGY_MOST_ALLOCATED
                  else -numa_key)
    # (4) sibling rank: position of this cpu among the free cpus of its
    # core (O(C^2) one-node matrix: C is small and this runs once a
    # Reserve)
    same_core = topo.core_of[:, None] == topo.core_of[None, :]
    ar = torch.arange(c, device=dev)
    lower = ar[None, :] < ar[:, None]
    sibling_rank = torch.sum(same_core & lower & free[None, :], dim=-1,
                             dtype=torch.int32)
    if bind_policy == BIND_SPREAD_BY_PCPUS:
        intra = sibling_rank * c + topo.core_of    # round-robin over cores
    else:
        intra = topo.core_of * c + sibling_rank    # whole cores together
    return take_by_rank(
        (ar.to(torch.int32), intra, numa_order, ~numa_satisfies, ~eligible),
        eligible, n_cpus)


# -- NUMA topology hints + topology manager (frameworkext/topologymanager) --

#: (2^MAX_NUMA, MAX_NUMA) every NUMA-node bitmask combination, and each
#: mask's popcount (numpy: moved to the caller's device per call)
_MASKS_NP = ((np.arange(1 << MAX_NUMA)[:, None] >> np.arange(MAX_NUMA)) & 1
             ).astype(bool)
_POPCOUNT_NP = _MASKS_NP.sum(axis=-1).astype(np.int32)


def _masks(dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(_MASKS_NP).to(dev),
            torch.from_numpy(_POPCOUNT_NP).to(dev))


def numa_hints(numa_free: torch.Tensor, request) -> torch.Tensor:
    """(2^MAX_NUMA,) bool feasibility per NUMA mask (hint generation): a
    mask is feasible if the free capacity across its member nodes covers
    the request (GenerateMachineInfoHints-style per-provider hints)."""
    masks, popcount = _masks(numa_free.device)
    totals = torch.sum(masks.to(torch.int32) * numa_free.to(torch.int32)[None],
                       dim=-1, dtype=torch.int32)
    return (totals >= int32_like(request, totals)) & (popcount > 0)


def preferred_mask(feasible: torch.Tensor) -> torch.Tensor:
    """() int32: the feasible mask with fewest NUMA nodes (-1 if none).
    The topology manager's 'preferred' bit: minimal-width masks win
    (policy.go mergeProvidersHints narrowest-mask preference)."""
    _, popcount = _masks(feasible.device)
    ar = torch.arange(1 << MAX_NUMA, dtype=torch.int32,
                      device=feasible.device)
    key = torch.where(feasible, popcount * (1 << MAX_NUMA) + ar, INT32_MAX)
    best = torch.argmin(key).to(torch.int32)
    return torch.where(torch.any(feasible), best, -1).to(torch.int32)


def merge_hints(provider_feasible: torch.Tensor,
                policy: int = POLICY_BEST_EFFORT
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Topology manager Admit: merge (K, 2^MAX_NUMA) provider hints under
    a policy.  Returns (admit, mask): mask is the chosen NUMA bitmask index
    (-1 when the merge found none; best-effort still admits then, as
    policy_best_effort.go; restricted and single-numa-node reject)."""
    dev = provider_feasible.device
    merged = torch.all(provider_feasible, dim=0)
    if policy == POLICY_SINGLE_NUMA_NODE:
        merged = merged & (_masks(dev)[1] == 1)
    best = preferred_mask(merged)
    if policy in (POLICY_NONE, POLICY_BEST_EFFORT):
        admit = torch.tensor(True, device=dev)
    else:  # RESTRICTED / SINGLE_NUMA_NODE
        admit = best >= 0
    return admit, best


def numa_score(numa_free: torch.Tensor, numa_total: torch.Tensor, request,
               strategy: int = STRATEGY_MOST_ALLOCATED) -> torch.Tensor:
    """() int32 in [0, 100]: NUMA-affinity score for one node.  Fitting
    inside a single NUMA node is worth half the range; the other half
    follows the allocate strategy applied to the best candidate node
    (resource_manager.go's most/least-allocated NUMA scoring)."""
    req = int32_like(request, numa_free)
    fits = numa_free >= req
    fits_single = torch.any(fits)
    total = torch.clamp(numa_total, min=1)
    pct = (numa_free * 100) // total
    per_numa = torch.where(
        fits, 100 - pct if strategy == STRATEGY_MOST_ALLOCATED else pct, 0)
    strat = torch.amax(per_numa)
    return (torch.where(fits_single, 50, 0) + strat // 2).to(torch.int32)
