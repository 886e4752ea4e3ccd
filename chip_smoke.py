#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``koordinator_tpu_torch``) on the card, phase by phase,
printing one JSON line per phase and stopping with a non-zero exit at the
first failure:

1. device: the card's name and power limit, and its int32 issue rate
   (SMs x 64 a clock x the maximum SM clock), which the operations bounds
   use (the operations each kernel's inputs need, counted by pair_ops);
2. build: compiles the kernels from ``koordinator_tpu_torch/kernels/csrc``;
   then ``ptxas``: K1's and K1a's, K2's, K3b's, K4's and K4r's registers
   and spills from the compiler's log (a spill fails the run), and the
   CTAs an SM the card reports for K1 and K1a's two instances (the int32
   one must reach K1's);
3. kernels: K1 against its plain PyTorch version at 2,048 pods x 1,024 nodes
   under four configurations (instantaneous thresholds, aggregated
   thresholds, selector classes, dense feasibility), and K3a/K3b against
   theirs on the inputs of every round of a real solve of that problem
   (K3b: the round's whole acceptance, one launch a round);
   then ``k1_edges``: K1 at node counts off its tile and cluster sizes,
   rows with fewer feasible nodes than k, usage at the int32 wrap edge,
   rot ids whose tie-break wraps, and scoring configurations with the
   terms the default leaves off; ``k3b_edges``: K3b on a 65,536-row batch
   in one node and one quota segment, runs of its 1,024-entry tile and
   one either side, choice -1 rows, no active pod, no pod in the quota
   tree, and a segment summing to 2**31 - 1;
4. solve: ``batch_assign`` at 4,096 pods x 1,024 nodes with a quota tree,
   kernel path against the plain path on the card, K3a and K3b also held
   against their plain versions on every round;
5. main path: ``Scheduler.schedule_round`` on 50,000 pending pods over
   10,240 nodes (R = 10), twice from the same seed (warm-up, then the
   reported round), with each kernel's launch count over the reported round;
6. kernel table: K1, K3a, K3b at the main path's shapes against their plain
   versions, their bounds and, for K1, ``torch.topk`` over a (P, N) key
   (K3b: the first round's acceptance, the wrapper, its node-level sort
   and the bare launch timed apart);
7. refresh: K2 against its plain version at the main path's width (65,536
   rows, 50,000 valid, over 10,240 nodes, k = 32), its cache from K1, after
   a usage refresh of 1% of the nodes (D = 128 padded dirty columns), the
   wrapper and the bare launch timed apart; then ``refresh_edges``: D = 1,
   65 and 128 with rot ids whose tie-break wraps, two dirty nodes sharing
   the top tie-break of one pod;
8. greedy: K4 against its plain version at 1,000 pods x 10,240 nodes with a
   two-level quota tree and selector classes; then ``greedy_edges``: at
   1,000, 10,000 and 32,768 nodes (the last with its node columns in
   global memory), dense feasibility and selector classes, the quota tree
   with non-preemptible pods, the scoring configurations of ``k1_edges``;
   then ``step_edges``: K4 on quota leaves whose consecutive pods fit one
   at a time, on identical nodes (the 16 CTAs' best ranks tie), on a
   headroom that wraps and on a negative request charged after the next
   pod's search moved the 256-pod window past it; every
   K4 and K4r case prints its time a step (ms over the steps quota
   admits);
9. steady state: the flagship cluster behind an ElasticQuota tree (root, 4
   parents, 16 leaves; 80% of the pods in leaves that admit ~60% of their
   cpu), one cold round and five rounds that each follow a usage refresh
   of 1% of the nodes and 500 arrivals, on three schedulers: the JAX
   defaults, the dirty threshold at 1.0 (K2 every steady round) and the
   incremental path off.  Their binds must agree every round, and each
   launches K3b once per propose/accept round.  K3b is held against its
   plain version on every round of the cold round's solve (the node
   level, the chain's 8 columns and the non-preemptible level in one
   launch), and K4 on the last steady round's rescue (the ~17,000
   compacted quota-blocked leftovers over 10,240 nodes);
10. small rounds: on the filled cluster, with the pending queue withdrawn
   before each round (a quota-blocked backlog keeps every round above the
   batch threshold), three rounds of 500 arrivals (the greedy path, K4)
   against the same rounds through the plain versions;
11. reservations: the Reservation lifecycle through ``Scheduler`` on the
   flagship cluster.  Round 1: the 50,000-pod backlog and 1,024
   Reservation CRs (128 pinned to named nodes, 896 placed by reserve-pods
   through the batch solve; 25% allocate-once, 25% Restricted, owners
   app=svc-<i mod 64>).  Round 2: 3,000 owner pods; the pre-pass takes the
   2,048 of highest priority on K4r, the cap sends the rest to the batch
   solve.  Round 3: 500 bound owner pods removed, the 64 reservations with
   a TTL expired, 1,000 more owner pods.  After each round: no node over
   its allocatable, no reservation's allocated over its reserved, every
   pre-pass bind on its reservation's node, and the node accounting equal
   to the bound pods' and the reservations' charges.  K4r is held against
   its plain version at round 2's pre-pass (2,048 pods x 10,240 nodes x
   1,024 reservations); then ``reservation_edges``: every reservation on
   one node, 4,096 records on one CTA (read in place from the wrapper's
   array), mostly exhausted rows, the quota tree, 32,768 nodes (the node
   columns in the global scratch), and the step's edges: quota leaves
   whose consecutive pods fit one at a time (the next pod, found while
   the current one is scored, is turned away after its charge), nodes
   that tie across the 16 CTAs, and allocate-once and Restricted records
   on the chosen node;
   then ``wide_edges``: K1, K2 and K3a (with K3b) at 32,768 nodes (the
   packed key regime's last capacity), 40,960 and 65,536 (the wide
   regime), rows with fewer feasible nodes than k, wrapping rot ids and a
   pod whose only feasible nodes share a tie-break; ``class_edges``: K1,
   K2, K4 and K4r at 65, 128 and 1,024 node classes (2, 2 and 16 selector
   words a pod);
12. a GKE-scale cluster (``phase_gke``): the Scheduler on 65,000 nodes at
   capacity 65,536 (the wide key regime), labelled with 16 zones x 16
   instance types and 1/8 tainted dedicated=batch (512 classes, 8 words
   a pod), the flagship's 50,000-pod backlog behind phase 9's quota tree
   with zone, instance-type and toleration selectors; a cold round, two
   steady rounds under the forced threshold (a usage refresh of 1% of the
   nodes and 500 arrivals each), then 256 pinned reservations and 1,000
   owner pods (K4r's pre-pass).  The launch counts are set to 0 before
   each round and read after it; phase 11's and phase 9's accounting
   checks hold after every round; every kernel equals its plain version
   at the phase's shapes (K1 and K2 over all rows in 1,024-row chunks, K4
   on a whole steady round's rescue with its quota state, and on its
   first 1,024 rows without it), and each kernel's time, plain time and
   bound there go on a ``gke_kernel`` line.  ``k2_long_list``: K2 on a
   dirty list of 2^20 + 32 columns at 2^26 node rows (8 pods);
13. gangs (``phase_gangs``): Coscheduling through the Scheduler on the
   flagship cluster and backlog behind phase 9's quota tree, 10,000 of
   the 50,000 pods in 512 PodGroups of 8-32 members (min_member the
   size for 3/4 of them, size - 2 for 1/4; 64 in gang groups of 2-4; 16
   declaring more members than they have).  Three rounds on a fake
   clock: t = 0; t = 300 s with 500 gangless arrivals and 32 new
   PodGroups; t = 601 s, when the 16 incomplete gangs pass their 600 s
   WaitTime, are rejected, and PreEnqueue holds their pods out of the
   batch.  Every round takes the full gang path; after each, every gang
   and gang group is all-or-nothing, no node is over its allocatable and
   the node accounting equals the bound pods.  K1, K3a, K3b and K4 (the
   whole rescue, with its quota state) are held against their plain
   versions on round 1's inputs, PreEnqueue's mask applied as gang_assign
   applies it;
14. approx (``phase_approx``): phase 9's forced-threshold scheduler with
   ``cand_method="approx"``, a cold round and two steady rounds, every
   selection on K1a and none on K1; a second scheduler's cold round
   under ``"chunked"`` launches K1a alone and binds exactly as the approx
   one (on the card the two methods make the same launch: a check of the
   routing only).  K1a is held
   against its plain version at the cold round's shape (K1 timed beside
   it, ``torch.topk`` over the (P, N) float key the library yardstick),
   at 65,536 nodes over 4,096 rows in 1,024-row chunks, and on a
   full-capacity wrap case at 10,240 nodes (at k = 32, and at k = 2 and 3,
   strata of one candidate), each with the count of rows whose nodes
   differ from K1's; and on the cold batch with 8 rows at rot ids in the
   band (two nodes share a tie-break there), so that K1a's int32 and
   64-bit instances both launch, at k = 32, 2 and 3, with the rows each
   instance took;
15. preemption (``phase_preemption``): the flagship cluster filled to 95%
   of its cpu through ``add_bound_pods`` (~170,000 bound pods: 70%
   koord-batch, 20% koord-mid, 10% koord-prod and non-preemptible; 80% in
   16 leaf quotas; 32 PDBs over an app label with budgets 0-8), the overuse
   revoke on, and 1,200 koord-prod arrivals (60% in the leaves, 8 gangs of
   8-16 members, 16 that never preempt).  Round 1 runs PostFilter at the
   1,024 cap: the gangs as jobs (K5 through preempt_one), then chains of
   256 single preemptors (K5 through preempt_chain); round 2 binds the
   nominations; round 3, on a fake clock past the 5 s delay, raises
   leaf-0's demand, which shrinks its siblings' runtime under their used,
   and QuotaRevoke runs K6 over every bound pod.  Each round prints its
   wall time, PostFilter ms, preemptors tried and nominated, victims
   evicted, revoked pods and nominated binds; no node is over its
   allocatable, the accounting equals the bound pods and the nominations,
   every PDB paid for its evictions.  Every K5 chain and preempt_one call
   of the rounds, and the K6 call, equal their plain versions on their
   recorded inputs, and K5 launches once a chain and once a preempt_one;
   K5 is timed on the first full chain (the wrapper on the node-ordered
   rows the PostFilter carried, a preemptor's share, the kernel's device
   time, the rows' build apart, the floor of dependent steps), K6 on round
   3's call and, from ``preempt_edges``, on one quota of 50,000 pods.
   Before it ``preempt_edges``: K5 and K6 on their edges (a node with 110
   candidates, PDB budgets of 0 and rank ties, an all-tie choice, no
   eligible node, priorities at NEG_PRI and -2**31 with headroom at
   +-2**30, inactive rows, a later preemptor seeing an earlier one's
   nomination, two preemptors in a row on one node, a PDB budget one
   preemptor spends flipping the next one's node, grids of 1, 3 and 132
   CTAs, a PostFilter's two chains and a gang on the rows they carry,
   65,536 nodes, 4,096 PDBs, one quota of 50,000 pods, hopeless quotas
   with and without a PDB-blocked pod, K6's walk stopping at lane 0, lane
   31 and past the end).  Both phases run under a watchdog: past
   K5_PHASE_LIMIT_S seconds the run ends with code 4 and a message.

The Diagnose phase (K7, ``explain_counts``): every round of phases 9, 12,
13 and 15 runs with the Scheduler's default ``explain=True``, and
``checked_diagnose`` holds each round's K7 call against K7's plain
version on the same inputs, and the round's ``result.failures`` (field
by field) against the failures the plain counts give; K7 must have
launched exactly once on every round with a failure; the check's time is
taken off the round's wall.  K7 is held against its plain version, timed, on phase 9's
and phase 12's last steady rounds' failed rows and on phase 15's round 1;
``explain_edges`` (before phase 9) holds it on one pod, 45 pods over
1,000 nodes, 65 selector classes, a dense mask, the aggregated thresholds
and every scoring term, requests of 0 against a negative free, every node
infeasible, and padded node rows with invalid pods, and (for the
tiled design) on mixed requested-dimension sets in a warp, requests and
thresholds on all 10 dimensions, requests of 0 everywhere, one pod over
65,536 nodes, and grids of 1 and 3 CTAs forced through ``GridCap``
(ranges crossing blocks, a field past its 8-bit limit without its
flush); ``held_k7``'s lines carry K7's launch plan (``plan``: grid,
resident CTAs) and ``ptxas`` its CTAs an SM.  Phase 10's and 14's
failures are compared field by field too; the plain path (``plain_path``)
takes K7's plain version.

The line before the last is ``nvidia-smi``'s name and power limit; the last
is ``{"ok": true, "device": {...}}``.  Before them a ``diagnose`` line
gives the Diagnose phase's host ms a round at phases 9 (the forced
scheduler) and 15, and one JSON line lists the ten kernels (K7's at phase
9's last steady round, its launches over the forced scheduler's rounds,
with ``phase12``, ``phase13`` and ``phase15`` beside it): time, launches over the steady-state run of the forced-
threshold scheduler (the slice's main path; K4r's over the reservations
phase's three rounds; K1a's over phase 14's three rounds; K5's and K6's
over phase 15's three rounds, K5's time that of one chain of 256
preemptors beside ``ms_per_preemptor``), bound, plain
and library time, under ``phase12`` the same at phase 12's shapes with
its launches over phase 12's four rounds, and under ``phase13`` the
launches over phase 13's three rounds, with K1's, K3b's and K4's numbers
at its round 1;
K4's numbers are those at the steady round's rescue, K3b's at the cold
solve's first round behind the quota tree, K4r's at round 2's pre-pass,
K1a's at phase 14's cold round;
K2 and K3b add ``device_ms``
(the bare launch) beside ``ms`` (the wrapper), K3b also ``sort_ms`` (its
node-level grouping by torch.sort).  An earlier line (``earlier_design``)
puts this run's K1, K4, K3b and K2 times beside earlier ones at the same
shapes, each labelled with its commit: the earlier designs (K1 and K4:
commit e9fcd1c; K3b and K2: commit bf2978c), the flagship phases'
K1, K2 and K4 before the wide key regime (commit 30c463b), and K1a's,
K4's and K4r's before their redesign (commit 398251d).  They are
constants recorded in PERF.md, not measured here
(``profile_torch_round.py --kernels --root`` measures two designs in one
run).
Every comparison is exact equality (all outputs are int32 or bool).  Nothing
here imports JAX or the JAX package.  Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

R = 10
CPU, MEM = 0, 1
OUT_DIR = "chiprun_out"
CSRC = "koordinator_tpu_torch/kernels/csrc/"

#: H100 SXM memory rate (NVIDIA data sheet), against which bound_ms is
#: computed
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer issue rate of the card, set by main() from
#: int32_ops_per_s(): Hopper issues 32-bit integer add, multiply, compare,
#: bitwise and shift at 64 per clock per SM (CUDA C++ Programming Guide,
#: arithmetic instruction throughput, compute capability 9.0); the 128 a
#: clock of float32 FMA lanes (the 67 T/s of the data sheet) do not apply
INT32_OPS_PER_S: float | None = None
INT32_OPS_PER_CLOCK_PER_SM = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def int32_ops_per_s() -> float:
    """SMs x 64 x the card's maximum SM clock (nvidia-smi), in int32
    operations a second."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_CLOCK_PER_SM * mhz * 1e6


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the card's int32 issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


#: int32 operations of the Filter + Score + ranking of one (pod, node) pair,
#: by term, as pair_ops counts them: each term only over the dimensions it
#: reads, and the score and ranking only on pairs that pass the filter
PAIR_OPS = dict(
    pair=3,         # the node's validity or selector bit; fit and threshold
                    # verdicts combined
    fit_dim=2,      # a nonzero request: compare with the free capacity, and
    thr_dim=3,      # a threshold on an allocatable dim: add, compare, and
    la_dim=12,      # a LoadAware weight: used, free, clamp, x100, the
                    # division (4), the guard (2), weigh, sum
    la_min_dim=1,   # the dominant (min) term, when its weight is not 0
    la=6,           # the weight-sum division (4), weigh, add
    la_dominant=2,  # weigh the dominant term, add
    fp_dim=12,      # a FitPlus weight on a requested dim: the requested
                    # amount (2), clamp, x100, the division (4), the guard
                    # (2), weigh, sum
    fp=6,           # the weight-sum division (4), weigh, add
    scarce=10,      # two population counts, the masks, the ratio (4),
                    # weigh, add
    rank=8,         # clip (2), tie-break (3), pack (2), the list's compare
)


def filter_ops(cfg, requests, alloc) -> int:
    """The int32 operations of the Filter over every pair of the pods
    ``requests`` (p, R) and the nodes ``alloc`` (n, R): over the pod's
    nonzero requests and the node's thresholded allocatable dims
    (PAIR_OPS)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _config_vector,
    )

    v = _config_vector(cfg)[0].tolist()
    thr = torch.tensor([t > 0 for t in v[R + 2:2 * R + 2]],
                       device=alloc.device)
    o = PAIR_OPS
    p, n = requests.shape[0], alloc.shape[0]
    return (p * n * o["pair"]
            + n * int((requests != 0).sum()) * o["fit_dim"]
            + p * int(((alloc > 0) & thr).sum()) * o["thr_dim"])


def pair_ops(cfg, requests, alloc, feasible) -> int:
    """The int32 operations that Filter + Score + ranking must do over the
    pairs of the pods ``requests`` (p, R) and the nodes ``alloc`` (n, R),
    ``feasible`` (p, n) marking the pairs that pass the filter: the filter
    on every pair (filter_ops); the score and the ranking on the feasible
    pairs, each plugin only when its weight is not 0 and over the dims it
    weighs (PAIR_OPS)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _config_vector,
    )

    v = _config_vector(cfg)[0].tolist()
    dev = alloc.device
    fp_w = torch.tensor([w != 0 for w in v[2 * R + 2:3 * R + 2]],
                        device=dev)
    la_dims = sum(w != 0 for w in v[:R])
    la_dw, la_pw, fp_pw, sc_pw = v[R], v[R + 1], v[5 * R + 2], v[5 * R + 3]
    o = PAIR_OPS
    p = feasible.shape[0]
    ops = filter_ops(cfg, requests, alloc)
    per = torch.full((p,), o["rank"], dtype=torch.int64, device=dev)
    if la_pw:
        per += o["la"] + la_dims * o["la_dim"]
        if la_dw:
            per += o["la_dominant"] + la_dims * o["la_min_dim"]
    if fp_pw:
        per += o["fp"] + ((requests > 0) & fp_w).sum(1) * o["fp_dim"]
    if sc_pw:
        per += o["scarce"]
    return ops + int((feasible.sum(1) * per).sum())


def batch_ops(state, pods, cfg, columns=None, chunk: int | None = None
              ) -> int:
    """pair_ops over a batch's valid pods and every node (or the node rows
    ``columns``), the feasible pairs found by the plain Filter in chunks
    of ``chunk`` pods (the batch solve's width when None)."""
    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows
    from koordinator_tpu_torch.ops.assignment import score_pods
    from koordinator_tpu_torch.ops.batch_assign import CANDIDATE_CHUNK

    chunk = chunk or CANDIDATE_CHUNK
    alloc = state.node_allocatable
    if columns is not None:
        alloc = alloc[columns]
    ops = 0
    for i in range(0, pods.capacity, chunk):
        sub = _pod_rows(pods, i, min(i + chunk, pods.capacity))
        feas = score_pods(state, sub, cfg)[1][sub.valid]
        if columns is not None:
            feas = feas[:, columns]
        ops += pair_ops(cfg, sub.requests[sub.valid], alloc, feas)
        del feas
    return ops


def scan_ops(state, pods, cfg, rows, assignments) -> int:
    """pair_ops over K4's scan: each step that passes quota admission (the
    pod ``rows``, in scan order) filters and scores every node against the
    accounting its predecessors left, as greedy_assign_plain keeps it (the
    requests and the estimates added to usage of the pods placed)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows
    from koordinator_tpu_torch.ops.assignment import pod_estimates, score_pods

    est = pod_estimates(pods, cfg)
    requested = state.node_requested.clone()
    added = torch.zeros_like(state.node_usage)
    a = assignments.cpu().numpy()
    ops = 0
    for i in rows:
        now = state.replace(node_requested=requested,
                            node_usage=state.node_usage + added,
                            node_agg_usage=state.node_agg_usage + added)
        sub = _pod_rows(pods, i, i + 1)
        ops += pair_ops(cfg, sub.requests, state.node_allocatable,
                        score_pods(now, sub, cfg)[1])
        if a[i] >= 0:
            requested[a[i]] += pods.requests[i]
            added[a[i]] += est[i]
    return ops


#: seconds a K5/K6 phase may take before the run fails (a K5 launch whose
#: CTAs never meet would otherwise hold the card until the time limit)
K5_PHASE_LIMIT_S = 300.0


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Ends the process with code 4 and a message when the block takes
    more than ``seconds``."""
    import threading

    done = threading.Event()

    def bark():
        if not done.wait(seconds):
            print(f"chip_smoke: {what} did not finish within {seconds} s",
                  file=sys.stderr, flush=True)
            os._exit(4)

    threading.Thread(target=bark, daemon=True).start()
    try:
        yield
    finally:
        done.set()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn, device, reps: int = 3, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after ``warmup``:
    CUDA events on the card, the host clock on the CPU."""
    import torch

    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms_by_kernel(fn, names, device, reps: int = 2) -> dict:
    """Mean device milliseconds a launch of the kernels whose profiler
    keys contain each of ``names`` (each launched once a call of ``fn``),
    from a torch.profiler trace of ``reps`` calls after one untraced,
    over the launches the trace holds (a trace can miss some: the mean is
    not halved by a lost one); None for a name with no device time (off
    the card, or no device time in the trace)."""
    import torch

    if torch.device(device).type != "cuda":
        return dict.fromkeys(names)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    seen = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                total[name] += float(getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)))
                seen[name] += int(e.count)
    for name in names:
        if 0 < seen[name] != reps:
            print(f"device_ms_by_kernel: {seen[name]} launches of {name} "
                  f"in a trace of {reps} calls", file=sys.stderr, flush=True)
    return {n: (t / 1e3 / seen[n] if t > 0 else None)
            for n, t in total.items()}


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape and a.dtype == b.dtype, "shapes/dtypes agree")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# -- problems ----------------------------------------------------------------


def random_problem(seed: int, n_nodes: int, n_pods: int, device,
                   mode: str = "plain"):
    """(ClusterState, PodBatch) of a seeded problem on ``device``.  ``mode``:
    "plain" (one class, every node allowed), "classes" (selector classes,
    some node class ids past the mask width) or "dense" (a (P, N) mask)."""
    from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 64_000, n_nodes)
    alloc[:, MEM] = rng.integers(16_384, 262_144, n_nodes)
    alloc[:, 3] = rng.integers(0, 2, n_nodes) * 8_000
    usage = (alloc * rng.random((n_nodes, R)) * 0.6).astype(np.int32)
    agg = (alloc * rng.random((n_nodes, R)) * 0.7).astype(np.int32)
    requested = (alloc * rng.random((n_nodes, R)) * 0.4).astype(np.int32)
    node_class = rng.integers(0, 3, n_nodes).astype(np.int32)
    if mode == "classes":
        node_class[rng.random(n_nodes) < 0.1] = 9
    req = np.zeros((n_pods, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, n_pods)
    req[:, MEM] = rng.integers(128, 8_192, n_pods)
    req[rng.random(n_pods) < 0.2, 3] = 1_000
    req[rng.random(n_pods) < 0.1, CPU] = 0
    state = ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                     agg_usage=agg, capacity=n_nodes,
                                     node_class=node_class, device=device)
    kw = {}
    if mode == "classes":
        sel = rng.random((n_pods, 8)) < 0.7
        kw = dict(selector_mask=sel, class_capacity=8)
    elif mode == "dense":
        kw = dict(feasible=rng.random((n_pods, n_nodes)) < 0.8)
    pods = PodBatch.build(
        req, priority=rng.integers(3_000, 9_999, n_pods).astype(np.int32),
        rot_id=rng.integers(0, 2**31 - 1, n_pods).astype(np.int32),
        node_capacity=n_nodes, device=device, **kw)
    return state, pods


def scoring_config(variant: str, device):
    import torch

    from koordinator_tpu_torch.ops.assignment import ScoringConfig

    cfg = ScoringConfig.default(device)

    def vec(dtype=torch.int32, **at):
        v = torch.zeros(R, dtype=dtype)
        for dim, val in at.items():
            v[{"cpu": CPU, "mem": MEM, "gpu": 3}[dim]] = val
        return v.to(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    if variant == "agg":
        cfg = cfg.replace(agg_usage_thresholds=vec(cpu=55, mem=80))
    elif variant == "dominant":
        cfg = cfg.replace(loadaware_dominant_weight=scalar(2),
                          loadaware_resource_weights=vec(cpu=3, mem=1, gpu=2),
                          scarce_plugin_weight=scalar(2))
    elif variant == "most_allocated":
        cfg = cfg.replace(
            fitplus_most_allocated=vec(torch.bool, cpu=True),
            fitplus_resource_weights=vec(cpu=2, mem=1, gpu=3),
            fitplus_plugin_weight=scalar(3))
    elif variant == "all_ten":
        # a usage threshold on every dimension
        cfg = cfg.replace(usage_thresholds=torch.tensor(
            [65, 95, 40, 50, 60, 70, 80, 85, 90, 55], dtype=torch.int32,
            device=device))
    elif variant == "everything":
        # every term on, a negative LoadAware weight among them
        cfg = cfg.replace(
            agg_usage_thresholds=vec(mem=70),
            loadaware_dominant_weight=scalar(1),
            loadaware_resource_weights=vec(cpu=2, mem=1, gpu=-1),
            fitplus_most_allocated=vec(torch.bool, mem=True),
            scarce_plugin_weight=scalar(1),
            loadaware_plugin_weight=scalar(2))
    return cfg


def quota_setup(pods, device, seed: int = 0):
    """A quota tree (parent -> qa, qb; standalone qc), its device state, and
    ``pods`` with quota ids and some non-preemptible pods."""
    import torch

    from koordinator_tpu_torch.quota.admission import QuotaDeviceState
    from koordinator_tpu_torch.quota.tree import QuotaTree

    rng = np.random.default_rng(seed)
    tree = QuotaTree(np.full(R, 10**8, np.int64))
    mx = np.full(R, -1, np.int64)
    mx[CPU], mx[MEM] = 3_000_000, 12_000_000
    tree.add("parent", np.zeros(R, np.int64), mx)
    child = np.full(R, -1, np.int64)
    child[CPU] = 1_800_000
    mn = np.zeros(R, np.int64)
    mn[CPU] = 200_000
    tree.add("qa", mn, child, parent="parent")
    tree.add("qb", np.zeros(R, np.int64), child, parent="parent")
    solo = np.full(R, -1, np.int64)
    solo[MEM] = 3_000_000
    tree.add("qc", np.zeros(R, np.int64), solo)
    for name in ("qa", "qb", "qc"):
        req = np.zeros(R, np.int64)
        req[CPU], req[MEM] = 2_500_000, 8_000_000
        tree.set_request(name, req)
    tree.refresh_runtime()
    quota, _ = QuotaDeviceState.from_tree(tree, device=device)
    p = pods.capacity
    qid = rng.choice(np.array([1, 2, 3, -1], np.int32), size=p)
    npre = rng.random(p) < 0.2
    pods = pods.replace(quota_id=torch.from_numpy(qid).to(device),
                        non_preemptible=torch.from_numpy(npre).to(device))
    return quota, pods


@contextlib.contextmanager
def plain_path():
    """Route the solvers through the kernels' plain versions on any device
    (the wrappers would launch the kernels on CUDA tensors)."""
    from koordinator_tpu_torch.kernels import explain_counts as k7
    from koordinator_tpu_torch.kernels import greedy_scan, prefix_accept
    from koordinator_tpu_torch.kernels import refresh_candidates as k2
    from koordinator_tpu_torch.kernels import round_fit_choose
    from koordinator_tpu_torch.kernels import select_candidates as k1
    from koordinator_tpu_torch.ops import assignment
    from koordinator_tpu_torch.ops import batch_assign as ba

    saved = (ba.select_candidates_kernel, ba.refresh_candidates_kernel,
             ba.round_fit_choose, ba.round_prefix_accept,
             greedy_scan.greedy_scan_kernel, k7.explain_counts)
    ba.select_candidates_kernel = k1.select_candidates_plain
    ba.refresh_candidates_kernel = k2.refresh_candidates_plain
    ba.round_fit_choose = round_fit_choose.round_fit_choose_plain
    ba.round_prefix_accept = prefix_accept.round_prefix_accept_plain
    greedy_scan.greedy_scan_kernel = assignment.greedy_assign_plain
    k7.explain_counts = k7.explain_counts_plain
    try:
        yield
    finally:
        (ba.select_candidates_kernel, ba.refresh_candidates_kernel,
         ba.round_fit_choose, ba.round_prefix_accept,
         greedy_scan.greedy_scan_kernel, k7.explain_counts) = saved


@contextlib.contextmanager
def checked_rounds(stats: dict):
    """Run K3a and K3b's wrappers AND plain versions on every call the
    rounds make, requiring equal outputs (the wrapper's result goes on).
    K3b's call is a round's whole acceptance, every level in one launch;
    ``stats["k3b_rounds"]`` gets each round's (active pods, quota entries,
    accepted)."""
    from koordinator_tpu_torch.kernels import build, prefix_accept
    from koordinator_tpu_torch.kernels import round_fit_choose
    from koordinator_tpu_torch.ops import batch_assign as ba

    saved = (ba.round_fit_choose, ba.round_prefix_accept)

    def fit_choose(*args):
        got = round_fit_choose.round_fit_choose(*args)
        want = round_fit_choose.round_fit_choose_plain(*args)
        for g, w in zip(got, want):
            check(max_abs_err(g, w) == 0, "K3a equals its plain version")
        stats["k3a_calls"] += 1
        return got

    def prefix(plan, *args):
        before = build.LAUNCHES["segmented_prefix_accept"]
        got = prefix_accept.round_prefix_accept(plan, *args)
        check(build.LAUNCHES["segmented_prefix_accept"] - before
              == (1 if got.is_cuda else 0), "K3b launched once a round")
        want = prefix_accept.round_prefix_accept_plain(plan, *args)
        check(max_abs_err(got, want) == 0, "K3b equals its plain version")
        stats["k3b_calls"] += 1
        stats["k3b_accepted"] += int(got.sum())
        stats.setdefault("k3b_rounds", []).append(dict(
            active=int(args[1].sum()),
            quota_entries=(0 if plan.entry_pod is None
                           else plan.entry_pod.shape[0]),
            accepted=int(got.sum())))
        return got

    ba.round_fit_choose, ba.round_prefix_accept = fit_choose, prefix
    try:
        yield
    finally:
        ba.round_fit_choose, ba.round_prefix_accept = saved


def held_k1(device, state, pods, cfg, method: str, reps: int = 3,
            chunk: int | None = None, k: int = 32, where: str = "") -> dict:
    """K1 (method "exact") or K1a ("approx") against its plain version over
    every row, ``chunk`` rows at a time (all at once when None), and
    timed: returns the kernel's (cand_key, cand_node, cand_score) as
    ``out``, ``max_abs_err``, ``ms`` and ``plain_ms``.  The plain version
    scores CANDIDATE_CHUNK rows at a time: for "approx" that is the
    "chunked" method's plain path, which is bit-identical to approx's."""
    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        select_candidates_kernel,
        select_candidates_plain,
    )
    from koordinator_tpu_torch.ops.batch_assign import CANDIDATE_CHUNK

    p = pods.capacity
    got = select_candidates_kernel(state, pods, cfg, k, method=method)
    step = chunk or p
    err = 0
    sync(device)
    t0 = time.perf_counter()
    for i in range(0, p, step):
        want = select_candidates_plain(
            state, _pod_rows(pods, i, min(i + step, p)), cfg, k,
            chunk=CANDIDATE_CHUNK, method=method)
        err = max([err] + [max_abs_err(g[i:i + step], w)
                           for g, w in zip(got, want)])
        del want
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    name = "K1a" if method == "approx" else "K1"
    check(err == 0, f"{name} equals its plain version {where}".rstrip())
    ms = timed_ms(lambda: select_candidates_kernel(state, pods, cfg, k,
                                                   method=method),
                  device, reps=reps)
    return dict(out=got, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def k1_bound(state, pods, cfg, k: int = 32, chunk: int | None = None
             ) -> dict:
    """K1's and K1a's bound at a batch: the bytes they must move (the node
    tensors: 4 x (N, R) int32, valid, class; the pod rows: requests and
    estimates, valid, rot_id; the selector mask, or the feasible matrix
    without one; three (P, k) outputs) and the operations of the valid
    pods' pairs with every node (batch_ops, over ``chunk``-row chunks)."""
    n, p = state.capacity, pods.capacity
    sel = (pods.feasible if pods.selector_mask is None
           else pods.selector_mask).numel()
    nbytes = (n * (4 * R * 4 + 1 + 4) + p * (2 * R * 4 + 1 + 4) + sel
              + 3 * p * k * 4)
    ops = batch_ops(state, pods, cfg, chunk=chunk)
    bound_ms, by = bound(nbytes, ops)
    return dict(bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=by)


# -- phases ------------------------------------------------------------------


def phase_kernels(device, n_pods: int = 2_048, n_nodes: int = 1_024) -> None:
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
        select_candidates_plain,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba

    results = []
    for seed, (name, mode, variant) in enumerate((
            ("instantaneous", "plain", "default"),
            ("aggregated", "plain", "agg"),
            ("selector_classes", "classes", "default"),
            ("dense_feasible", "dense", "default"))):
        state, pods = random_problem(100 + seed, n_nodes, n_pods, device, mode)
        cfg = scoring_config(variant, device)
        got = select_candidates_kernel(state, pods, cfg)
        want = select_candidates_plain(state, pods, cfg)
        errs = [max_abs_err(g, w) for g, w in zip(got, want)]
        check(max(errs) == 0, f"K1 equals its plain version ({name})")
        valid_slots = int((got[0] >= 0).sum())
        check(valid_slots > 0, f"K1 found candidates ({name})")
        ms = timed_ms(lambda: select_candidates_kernel(state, pods, cfg),
                      device, reps=5)
        plain_ms = timed_ms(lambda: select_candidates_plain(state, pods, cfg),
                            device, reps=2)
        stats = {"k3a_calls": 0, "k3b_calls": 0, "k3b_accepted": 0}
        quota = None
        if mode == "classes":
            quota, pods = quota_setup(pods, device, seed)
        with checked_rounds(stats):
            a, _, _ = ba.batch_assign(state, pods, cfg, quota)
        check(stats["k3a_calls"] > 0 and stats["k3b_calls"] > 0,
              f"rounds ran ({name})")
        results.append(dict(config=name, k1_max_abs_err=max(errs),
                            valid_slots=valid_slots, k1_ms=ms,
                            k1_plain_ms=plain_ms, assigned=int((a >= 0).sum()),
                            k3a_checked=stats["k3a_calls"],
                            k3b_checked=stats["k3b_calls"],
                            k3b_accepted=stats["k3b_accepted"],
                            quota=quota is not None))
    emit("kernels", pods=n_pods, nodes=n_nodes, configs=results)


def danger_rot_ids(rng, count: int, n_nodes: int) -> np.ndarray:
    """Rot ids whose rot*7919 (int32-wrapped) lies within n_nodes above
    -2**31: the tie-break difference wraps for some nodes, and where
    2**32 is not a multiple of N two nodes can share a tie-break."""
    inv = pow(7919, -1, 2**32)
    target = (2**31 + rng.integers(0, n_nodes, count)) % 2**32
    rot = (target.astype(object) * inv) % 2**32
    return np.array([r - 2**32 if r >= 2**31 else r for r in rot], np.int32)


def _rot_in_band(rng, n_nodes: int) -> int:
    """A rot id in K1a's band at ``n_nodes``: rot * 7919 (int32-wrapped)
    lies 1..n_nodes-1 above -2**31 (past -2**31 itself, where every
    difference wraps and each tie-break keeps one preimage)."""
    while True:
        rot = int(danger_rot_ids(rng, 1, n_nodes)[0])
        off = (rot * 7919 + 2**31) % 2**32
        if 0 < off < n_nodes:
            return rot


def phase_k1_edges(device) -> None:
    """K1 against its plain version where its design has edges: node
    counts that are not a multiple of its 32-node tile or its 8-CTA
    cluster (10,000 and 1,000), rows with fewer feasible nodes than a
    stratum's 16 (0, 1..5 and 12 feasible), capacities and usage near the
    int32 wrap of 100 * (cap - used), rot ids whose tie-break difference
    wraps (two nodes may share a key), and scoring configurations that
    turn on the terms the default leaves off (dominant weight,
    most-allocated, scarce weight, a negative weight)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
        select_candidates_plain,
    )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    results = []
    cases = {"n10000_classes": "most_allocated", "n1000_dense": "everything",
             "few_feasible": "dominant", "wrap_edge": "default",
             "wrapped_tie_break": "default"}
    for seed, (name, variant) in enumerate(cases.items()):
        cfg = scoring_config(variant, device)
        rng = np.random.default_rng(300 + seed)
        if name == "n10000_classes":
            state, pods = random_problem(300, 10_000, 2_048, device,
                                         "classes")
        elif name == "n1000_dense":
            state, pods = random_problem(301, 1_000, 1_024, device, "dense")
        elif name == "few_feasible":
            state, pods = random_problem(302, 1_000, 1_024, device,
                                         "classes")
            cls = np.zeros(1_000, np.int32)
            cls[rng.choice(1_000, 5, replace=False)] = 1
            cls[rng.choice(np.flatnonzero(cls == 0), 12, replace=False)] = 2
            sel = np.zeros((1_024, 8), bool)
            which = rng.integers(0, 4, 1_024)
            sel[which == 0, 1] = True      # <= 5 feasible nodes
            sel[which == 1, 2] = True      # <= 12
            sel[which == 2, 7] = True      # no node has class 7: 0
            sel[which == 3] = rng.random((int((which == 3).sum()), 8)) < 0.5
            state = state.replace(node_class=dev(cls))
            pods = pods.replace(selector_mask=dev(sel))
        elif name == "wrap_edge":
            state, pods = random_problem(303, 2_000, 1_024, device, "plain")
            n = 2_000
            alloc = state.node_allocatable.cpu().numpy().copy()
            alloc[:, CPU] = rng.integers(2**30, 2**31 - 1, n)
            alloc[:, MEM] = rng.integers(2**24, 2**31 - 1, n)
            frac = rng.random((n, R))
            usage = (alloc * frac * 0.9).astype(np.int32)
            usage[: n // 2, CPU] = alloc[: n // 2, CPU] - rng.integers(
                0, 50_000_000, n // 2)
            req = (alloc * rng.random((n, R)) * 0.3).astype(np.int32)
            state = state.replace(node_allocatable=dev(alloc),
                                  node_usage=dev(usage),
                                  node_agg_usage=dev(usage),
                                  node_requested=dev(req))
        else:
            state, pods = random_problem(304, 10_000, 2_048, device,
                                         "classes")
            rot = pods.rot_id.cpu().numpy().copy()
            rot[::2] = danger_rot_ids(rng, (len(rot) + 1) // 2, 10_000)
            pods = pods.replace(rot_id=dev(rot))
        got = select_candidates_kernel(state, pods, cfg)
        want = select_candidates_plain(state, pods, cfg)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        check(err == 0, f"K1 equals its plain version ({name})")
        key = got[0]
        feasible_slots = (key >= 0).sum(dim=1)
        # stratum 1 (spread bits 15) ranks by tie-break alone: two of its
        # slots with one tie-break are two nodes sharing a key
        tb1 = torch.where(key[:, 16:] >= 0, key[:, 16:] & 0x7FFF, -1 -
                          torch.arange(16, device=key.device))
        shared = int((torch.sort(tb1, dim=1).values.diff(dim=1) == 0)
                     .any(dim=1).sum())
        results.append(dict(
            config=name, scoring=variant, pods=pods.capacity,
            nodes=state.capacity,
            max_abs_err=err, valid_slots=int(feasible_slots.sum()),
            rows_short_of_k=int(((feasible_slots < key.shape[1])
                                 & pods.valid).sum()),
            rows_with_shared_keys=shared))
    by = {r["config"]: r for r in results}
    check(by["few_feasible"]["rows_short_of_k"] > 0,
          "rows with fewer feasible nodes than k")
    check(by["wrapped_tie_break"]["rows_with_shared_keys"] > 0,
          "rows where two nodes share a key")
    emit("k1_edges", configs=results)


def phase_solve(device, n_pods: int = 4_096, n_nodes: int = 1_024) -> None:
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.ops.batch_assign import batch_assign

    state, pods = random_problem(7, n_nodes, n_pods, device, "classes")
    quota, pods = quota_setup(pods, device, 7)
    cfg = scoring_config("default", device)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    a, st, q = batch_assign(state, pods, cfg, quota)
    sync(device)
    kernel_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    stats = {"k3a_calls": 0, "k3b_calls": 0, "k3b_accepted": 0}
    with checked_rounds(stats):
        ca, _, _ = batch_assign(state, pods, cfg, quota)
    check(max_abs_err(a, ca) == 0 and stats["k3b_calls"] > 0,
          "K3a and K3b equal their plain versions on every round")
    with plain_path():
        t0 = time.perf_counter()
        pa, pst, pq = batch_assign(state, pods, cfg, quota)
        sync(device)
        plain_s = time.perf_counter() - t0
    check(max_abs_err(a, pa) == 0, "assignments equal")
    check(max_abs_err(st.node_requested, pst.node_requested) == 0,
          "node_requested equal")
    for f in ("headroom", "min_headroom", "checked", "chain", "valid"):
        check(max_abs_err(getattr(q, f), getattr(pq, f)) == 0,
              f"quota.{f} equal")
    check(int((a >= 0).sum()) > 0, "solve assigned pods")
    emit("solve", pods=n_pods, nodes=n_nodes, assigned=int((a >= 0).sum()),
         kernel_path_s=kernel_s, plain_path_s=plain_s, launches=launches,
         rounds_checked=stats["k3b_calls"], equal=True)


def main_path_specs(seed: int = 0, n_nodes: int = 10_240,
                    n_pods: int = 50_000):
    """NodeSpec / PodSpec lists seeded as the JAX package's flagship
    problem (__graft_entry__._build_problem) draws its arrays."""
    from koordinator_tpu_torch.scheduler.snapshot import NodeSpec, PodSpec

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 64_000, n_nodes)
    alloc[:, MEM] = rng.integers(16_384, 262_144, n_nodes)
    usage = (alloc * rng.random((n_nodes, R)) * 0.5).astype(np.int32)
    req = np.zeros((n_pods, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, n_pods)
    req[:, MEM] = rng.integers(128, 8_192, n_pods)
    prio = rng.integers(3000, 9999, n_pods).astype(np.int32)
    nodes = [NodeSpec(name=f"node-{i}", allocatable=alloc[i], usage=usage[i])
             for i in range(n_nodes)]
    pods = [PodSpec(name=f"pod-{j}", requests=req[j], priority=int(prio[j]),
                    creation=float(j)) for j in range(n_pods)]
    return nodes, pods


@contextlib.contextmanager
def solve_probe(log: list, device):
    """Time each solve the scheduler makes (CUDA events on the card) and
    keep its inputs, by wrapping the scheduler module's ``gang_assign`` (the
    full batch path and the greedy rescue and rounds) and
    ``Scheduler._solve_batch_incremental`` (the candidate-cache path)."""
    import torch

    from koordinator_tpu_torch.scheduler import scheduler as sched_mod

    real = sched_mod.gang_assign
    real_inc = sched_mod.Scheduler._solve_batch_incremental
    on_card = torch.device(device).type == "cuda"

    def timed(fn, **entry):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        log.append(dict(entry, ms=ms))
        return out

    def probe(state, batch, cfg, gangs, quota=None, **kw):
        return timed(lambda: real(state, batch, cfg, gangs, quota, **kw),
                     solver=kw.get("solver"), state=state, batch=batch,
                     cfg=cfg, quota=quota, gangs=gangs)

    def probe_inc(self, pods, batch, quota):
        return timed(lambda: real_inc(self, pods, batch, quota),
                     solver="batch", state=self.snapshot.state, batch=batch,
                     cfg=self.config, quota=quota)

    sched_mod.gang_assign = probe
    sched_mod.Scheduler._solve_batch_incremental = probe_inc
    try:
        yield
    finally:
        sched_mod.gang_assign = real
        sched_mod.Scheduler._solve_batch_incremental = real_inc


def gang_solve(solve: dict) -> dict:
    """A logged gang_assign solve as its first pass launches the kernels:
    the batch with PreEnqueue's mask applied (the pods of a gang short of
    min_member leave it), as gang_assign applies it before it solves."""
    from koordinator_tpu_torch.ops.gang import pre_enqueue_mask

    batch = solve["batch"]
    return dict(solve, batch=batch.replace(
        valid=batch.valid & pre_enqueue_mask(batch, solve["gangs"])))


def run_round(device, n_nodes: int, n_pods: int, seed: int = 0):
    """Build a fresh snapshot and queue, run one round; returns
    (result, scheduler, wall seconds, solve log, pods, nodes)."""
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    nodes, pods = main_path_specs(seed, n_nodes, n_pods)
    snap = ClusterSnapshot(capacity=n_nodes, device=device)
    for n in nodes:
        snap.upsert_node(n)
    binds = []
    sched = Scheduler(snap, bind_fn=lambda p, n: binds.append((p, n)),
                      device=device)
    sched.enqueue_many(pods)
    log: list = []
    with solve_probe(log, device):
        sync(device)
        t0 = time.perf_counter()
        result = sched.schedule_round()
        sync(device)
        wall = time.perf_counter() - t0
    check(len(binds) == len(result.assignments), "bind_fn saw every bind")
    return result, sched, wall, log, pods, nodes


def verify_round(result, sched, pods, nodes) -> None:
    """No overcommit on any requested dimension, and the node accounting
    equals the sum of the bound pods' requests."""
    state = sched.snapshot.state
    requested = state.node_requested.cpu().numpy().astype(np.int64)
    alloc = state.node_allocatable.cpu().numpy().astype(np.int64)
    check(bool(state.node_valid.all()), "every node row is valid")
    check(bool((requested <= alloc).all()), "no node overcommitted")
    expect = np.zeros_like(requested)
    by_name = {p.name: p for p in pods}
    for pod, node in result.assignments.items():
        expect[sched.snapshot.node_index[node]] += by_name[pod].requests
    check(np.array_equal(expect, requested), "accounting = sum of binds")
    check(len(result.assignments) + len(result.failures) == len(pods),
          "every pod bound or failed")
    check(len(result.assignments) > 0, "round bound pods")


def phase_main(device, n_nodes: int = 10_240, n_pods: int = 50_000):
    import torch

    from koordinator_tpu_torch.kernels import build

    rounds = []
    for label in ("warmup", "reported"):
        if label == "reported":
            build.reset_launch_counts()
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        result, sched, wall, log, pods, nodes = run_round(device, n_nodes,
                                                          n_pods)
        launches = dict(build.LAUNCHES)
        verify_round(result, sched, pods, nodes)
        peak = (torch.cuda.max_memory_allocated() if
                torch.device(device).type == "cuda" else None)
        rounds.append(dict(
            round=label, solver=sched.last_solver,
            assigned=len(result.assignments), failed=len(result.failures),
            rescued=result.rescued, wall_s=wall,
            solve_ms=[s["ms"] for s in log if s["solver"] == "batch"],
            rescue_ms=[s["ms"] for s in log if s["solver"] == "greedy"],
            peak_mem_bytes=peak))
    check(sched.last_solver == "batch", "the batch solver ran")
    for kernel in ("select_candidates", "round_fit_choose",
                   "segmented_prefix_accept"):
        check(launches[kernel] > 0, f"{kernel} launched on the cold round")
    emit("main_path", pods=n_pods, nodes=n_nodes, rounds=rounds,
         solve_path=sched.last_solve_path, launches=launches)
    return launches, log


def phase_table(device, launches: dict, log: list, reps: int = 3):
    """Each kernel at the main path's shapes (the reported round's first
    batch solve): time, its plain version's time, its bound, and for K1
    torch.topk over the (P, N) ranking key."""
    import torch

    from koordinator_tpu_torch.kernels.prefix_accept import accept_plan
    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
        round_fit_choose_plain,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        _rank_parts,
    )
    from koordinator_tpu_torch.ops.assignment import priority_order, score_pods
    from koordinator_tpu_torch.ops.batch_assign import CANDIDATE_CHUNK

    solve = next(s for s in log if s["solver"] == "batch")
    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    p, n = pods.capacity, state.capacity
    p_valid = int(pods.valid.sum())
    k = 32

    # K1
    k1 = held_k1(device, state, pods, cfg, "exact", reps=reps,
                 where="at the main path's shape")
    got = k1["out"]
    key = torch.empty((p, n), dtype=torch.int32, device=state.device)
    for i in range(0, p, CANDIDATE_CHUNK):
        sub = _pod_rows(pods, i, min(i + CANDIDATE_CHUNK, p))
        scores, feas = score_pods(state, sub, cfg)
        key[i:i + CANDIDATE_CHUNK] = _rank_parts(scores, feas, 5, sub.rot_id,
                                                 n_total=n)[0]
        del scores, feas
    topk_ms = timed_ms(lambda: torch.topk(key, k // 2, dim=1), device,
                       reps=reps)
    del key
    k1_b = k1_bound(state, pods, cfg, k)

    # K3a on the first round's inputs
    cand_key, cand_node = got[0], got[1]
    free = torch.where(state.node_valid[:, None],
                       state.node_allocatable - state.node_requested, 0)
    active = pods.valid & torch.any(cand_key >= 0, dim=1)
    choice, has = round_fit_choose(cand_key, cand_node, free, pods.requests,
                                   active, pods.rot_id)
    pchoice, phas = round_fit_choose_plain(cand_key, cand_node, free,
                                           pods.requests, active, pods.rot_id)
    k3a_err = max(max_abs_err(choice, pchoice), max_abs_err(has, phas))
    check(k3a_err == 0, "K3a equals its plain version at the main shape")
    k3a_ms = timed_ms(lambda: round_fit_choose(cand_key, cand_node, free,
                                               pods.requests, active,
                                               pods.rot_id),
                      device, reps=10)
    k3a_plain_ms = timed_ms(lambda: round_fit_choose_plain(
        cand_key, cand_node, free, pods.requests, active, pods.rot_id),
        device, reps=3)
    n_active = int(active.sum())
    k3a_bytes = (n_active * (k * (4 + 4 + R * 4) + R * 4)
                 + p * (1 + 4 + 1))
    k3a_bound = k3a_bytes / HBM_BYTES_PER_S * 1e3

    # K3b on the first round's acceptance (no quota: the node level)
    act = active & has
    plan = accept_plan(priority_order(pods), pods.requests)
    k3b = k3b_round_numbers(device, plan, choice, act, free)

    base = CSRC
    kernels = [
        dict(name="select_candidates", route="cuda",
             source=base + "select_candidates.cu",
             replaces="koordinator_tpu/ops/batch_assign.py:404",
             launches=launches["select_candidates"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1_b["bound_ms"],
             bound_by=k1_b["bound_by"], library_ms=topk_ms),
        dict(name="round_fit_choose", route="cuda",
             source=base + "round_fit_choose.cu",
             replaces="koordinator_tpu/ops/batch_assign.py:606",
             launches=launches["round_fit_choose"], max_abs_err=k3a_err,
             ms=k3a_ms, plain_ms=k3a_plain_ms, bound_ms=k3a_bound,
             bound_by="bytes", library_ms=None),
    ]
    emit("table", pods=p, valid_pods=p_valid, nodes=n, k=k,
         k1_ops=k1_b["ops"], k1_bytes=k1_b["bytes"], k3a_active=n_active,
         k3a_bytes=k3a_bytes, k3b_first_round=k3b)
    return kernels, k3b


def k3b_round_numbers(device, plan, choice, act, free, headroom=None,
                      min_headroom=None, reps: int = 10) -> dict:
    """K3b on one round's whole acceptance: kernel against plain version
    (exact), and its times: ``ms`` the wrapper (the node level's grouping
    by a stable torch.sort, then the launch), ``sort_ms`` that grouping
    alone, ``device_ms`` the launch alone (CUDA events around it), and
    ``plain_ms``.  The bound counts the bytes of the round over all
    levels: each input once (the choices, activity, priority order, the
    requested dims of the pods' requests and of the headroom tables, the
    quota entries) and the (P,) verdict."""
    import torch

    from koordinator_tpu_torch.kernels import prefix_accept as pa

    n = free.shape[0]
    args = (plan, choice, act, free, headroom, min_headroom)
    got = pa.round_prefix_accept(*args)
    want = pa.round_prefix_accept_plain(*args)
    err = max_abs_err(got, want)
    check(err == 0, "K3b equals its plain version on a round")

    def group():
        seg = torch.where(act, choice, n).to(torch.int32)
        return torch.sort(seg[plan.order], stable=True)

    node_seg, node_pos = group()
    quota = plan if plan.chain is not None else None
    launch, out = pa.prepare_launch(node_seg, node_pos, plan.order,
                                    plan.requests, free, False, n, n, quota,
                                    headroom, min_headroom, act, plan.dims)
    launch()
    check(max_abs_err(out, want) == 0, "K3b's bare launch equals the plain")
    p = act.shape[0]
    nd = bin(plan.dims).count("1")
    m = 0 if quota is None else plan.entry_pod.shape[0]
    nbytes = (p * (4 + 1 + 8 + 1) + p * nd * 4 + n * nd * 4
              + (0 if quota is None else
                 m * 12 + p * nd * 4 + 2 * plan.n_quotas * nd * 4))
    return dict(
        pods=p, active=int(act.sum()), quota_entries=m, dims=nd,
        accepted=int(got.sum()), max_abs_err=err,
        ms=timed_ms(lambda: pa.round_prefix_accept(*args), device,
                    reps=reps),
        sort_ms=timed_ms(group, device, reps=reps),
        device_ms=timed_ms(launch, device, reps=reps),
        plain_ms=timed_ms(lambda: pa.round_prefix_accept_plain(*args),
                          device, reps=3),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")



def phase_refresh(device, log: list, n_dirty: int = 102, reps: int = 10):
    """K2 at the main path's width: the reported round's batch over 10,240
    nodes, its cache from K1, then a usage refresh of ``n_dirty`` nodes
    (D padded to 128).  The kernel must equal its plain version exactly,
    and the refreshed rows whose cache missed every dirty node must equal a
    full K1 selection on the refreshed state."""
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        prepare_refresh,
        refresh_candidates_kernel,
        refresh_candidates_plain,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba
    from koordinator_tpu_torch.state.cluster_state import _bucket

    solve = next(s for s in log if s["solver"] == "batch")
    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    p, n, k, strata = pods.capacity, state.capacity, 32, (5, 15)
    p_valid = int(pods.valid.sum())
    cache = ba.CandidateCache(*select_candidates_kernel(state, pods, cfg, k,
                                                        strata))
    rng = np.random.default_rng(11)
    rows = np.sort(rng.choice(n, n_dirty, replace=False))
    usage = state.node_usage.clone()
    alloc = state.node_allocatable[rows].cpu().numpy()
    fresh = (alloc * rng.random(alloc.shape) * 0.5).astype(np.int32)
    usage[torch.from_numpy(rows).to(device)] = torch.from_numpy(fresh).to(
        device)
    state2 = state.replace(node_usage=usage)
    d = _bucket(n_dirty, minimum=64)
    drows = np.zeros(d, np.int32)
    drows[:n_dirty] = rows
    dvalid = np.zeros(d, bool)
    dvalid[:n_dirty] = True
    dirty = np.zeros(n, bool)
    dirty[rows] = True

    def dev(a):
        return torch.from_numpy(a).to(device)

    aligned, touch = ba.align_candidate_cache(
        cache, torch.arange(p, dtype=torch.int32, device=device),
        pods.valid, dev(dirty))
    args = (state2, pods, cfg, aligned.cand_node, aligned.cand_score,
            dev(drows), dev(dvalid), k, strata)
    got = refresh_candidates_kernel(*args)
    want = refresh_candidates_plain(*args)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(err == 0, "K2 equals its plain version at the main path's width")
    full = select_candidates_kernel(state2, pods, cfg, k, strata)
    keep = pods.valid & ~touch
    for g, f in zip(got, full):
        check(max_abs_err(g[keep], f[keep]) == 0,
              "K2 equals a full selection on the untouched rows")
    ms = timed_ms(lambda: refresh_candidates_kernel(*args), device,
                  reps=reps)
    launch, outs = prepare_refresh(*args)
    launch()
    check(max(max_abs_err(g, w) for g, w in zip(outs, want)) == 0,
          "K2's bare launch equals its plain version")
    device_ms = timed_ms(launch, device, reps=reps)
    plain_ms = timed_ms(lambda: refresh_candidates_plain(*args), device,
                        reps=1)
    # bytes: the cache read (node, score) and the three outputs written,
    # the pod inputs, the gathered dirty rows and the (N,) dirty mask;
    # bytes and operations count the n_dirty real columns, not the padding
    c = pods.selector_mask.shape[1]
    nbytes = (p * k * (2 * 4 + 3 * 4) + p * (2 * R * 4 + 1 + 4 + c)
              + n_dirty * (4 * R * 4 + 1 + 4 + 4 + 1) + n)
    ops = batch_ops(state2, pods, cfg, torch.from_numpy(rows).to(device))
    bound_ms, by = bound(nbytes, ops)
    emit("refresh", pods=p, valid_pods=p_valid, nodes=n, k=k,
         dirty_nodes=n_dirty, dirty_columns=d,
         touched_pods=int(touch.sum()), max_abs_err=err, ms=ms,
         device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
         bound_ms=bound_ms, bound_by=by)
    phase_refresh_edges(device, state, pods, cfg, cache)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def top_shared_pair(n: int):
    """(rot id, a, b): a rot id whose tie-break difference wraps so that
    nodes a < b share the top tie-break N - 1 (possible where 2**32 is
    not a multiple of N); None when no offset gives one."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _candidate_tb,
    )

    inv = pow(7919, -1, 2**32)
    nodes = torch.arange(n, dtype=torch.int32)[None, :]
    for o in list(range(n // 2, n)) + list(range(n // 2)):
        rot = ((2**31 + o) * inv) % 2**32
        rot = rot - 2**32 if rot >= 2**31 else rot
        tb = _candidate_tb(nodes, torch.tensor([rot], dtype=torch.int32),
                           n)[0]
        top = torch.nonzero(tb == n - 1).flatten().tolist()
        if len(top) == 2:
            return rot, top[0], top[1]
    return None


def phase_refresh_edges(device, state, pods, cfg, cache) -> None:
    """K2 against its plain version at the main path's width with D = 1,
    65 and 128 dirty columns, half the pods at rot ids whose tie-break
    wraps.  One valid pod gets a rot id under which two nodes share the
    top tie-break: both are made identical and roomy and listed dirty (the
    higher one first), so its stratum 1 keeps one key from two dirty
    nodes, and the kernel must take them in column order.  Rows shorter
    than k keep -1 slots of cached nodes."""
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_kernel,
        refresh_candidates_plain,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    p, n, k = pods.capacity, state.capacity, 32
    rng = np.random.default_rng(12)
    rot = pods.rot_id.cpu().numpy().copy()
    rot[::2] = danger_rot_ids(rng, (p + 1) // 2, n)
    pair = top_shared_pair(n)
    check(pair is not None, f"two nodes share a tie-break at N = {n}")
    i0 = int(torch.nonzero(pods.valid).flatten()[0])
    rot[i0], a, b = pair
    pods = pods.replace(rot_id=dev(rot))
    base = {f: getattr(state, f).clone() for f in (
        "node_allocatable", "node_requested", "node_usage",
        "node_agg_usage", "node_class")}
    for t in ("node_requested", "node_usage", "node_agg_usage"):
        base[t][[a, b]] = 0
    base["node_allocatable"][[a, b]] = base["node_allocatable"].max(dim=0
                                                                    ).values
    base["node_class"][b] = base["node_class"][a]
    results = []
    for d in (1, 65, 128):
        rows = [b, a] + [int(x) for x in rng.choice(n, d, replace=False)
                         if int(x) not in (a, b)]
        rows = np.array(rows[:d], np.int32)
        usage = base["node_usage"].cpu().numpy().copy()
        alloc = base["node_allocatable"].cpu().numpy()
        fresh = rows[~np.isin(rows, (a, b))]
        usage[fresh] = (alloc[fresh] * rng.random((len(fresh), R)) * 0.5
                        ).astype(np.int32)
        st = state.replace(**dict(base, node_usage=dev(usage)))
        dirty = np.zeros(n, bool)
        dirty[rows] = True
        aligned, _ = ba.align_candidate_cache(
            cache, torch.arange(p, dtype=torch.int32, device=device),
            pods.valid, dev(dirty))
        args = (st, pods, cfg, aligned.cand_node, aligned.cand_score,
                dev(rows), dev(np.ones(d, bool)), k, (5, 15))
        got = refresh_candidates_kernel(*args)
        want = refresh_candidates_plain(*args)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        check(err == 0, f"K2 equals its plain version (D = {d})")
        key = got[0]
        shared = int(((key[:, 1:] == key[:, :-1]) & (key[:, 1:] >= 0))
                     .any(dim=1).sum())
        results.append(dict(dirty_columns=d, max_abs_err=err,
                            rows_with_shared_keys=shared,
                            pair_rows=[int(x) for x in got[1][i0, 16:18]],
                            minus_one_slots=int((key < 0).sum())))
    check(results[-1]["pair_rows"] == [b, a],
          "the shared top tie-break kept in column order")
    emit("refresh_edges", pods=p, nodes=n, pair=[a, b], cases=results)


def greedy_case(device, seed: int, n_nodes: int, n_pods: int, mode: str,
                reps: int = 3, variant: str = "default") -> dict:
    """K4 against its plain version (the Python loop) on one seeded problem
    with a two-level quota tree (some pods non-preemptible): assignments,
    node accounting and every quota field equal.  Returns the case's
    numbers, its bound counted over the steps that pass admission."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_kernel
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    state, pods = random_problem(seed, n_nodes, n_pods, device, mode)
    quota, pods = quota_setup(pods, device, seed)
    cfg = scoring_config(variant, device)
    a, st, q = greedy_scan_kernel(state, pods, cfg, quota)
    sync(device)
    t0 = time.perf_counter()
    pa, pst, pq = greedy_assign_plain(state, pods, cfg, quota)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [max_abs_err(a, pa),
            max_abs_err(st.node_requested, pst.node_requested)]
    errs += [max_abs_err(getattr(q, f), getattr(pq, f))
             for f in ("headroom", "min_headroom", "checked", "chain",
                       "valid")]
    err = max(errs)
    check(err == 0, f"K4 equals its plain version ({n_nodes} nodes, {mode})")
    assigned = int((a >= 0).sum())
    check(0 < assigned < n_pods, "K4 placed some pods and quota held some")
    ms = timed_ms(lambda: greedy_scan_kernel(state, pods, cfg, quota),
                  device, reps=reps)
    rows = admitted_rows(pods, quota, a)
    scans = len(rows)
    c = 0 if pods.selector_mask is None else pods.selector_mask.shape[1]
    dense = 0 if pods.feasible is None else scans * n_nodes
    # the node tensors read and node_requested written once, the pod rows
    # and the quota state read and written; operations on the steps that
    # pass quota admission
    nbytes = (n_nodes * (4 * R * 4 + 1 + 4) + n_nodes * R * 4
              + pods.capacity * (2 * R * 4 + 1 + 4 + 4 + 1 + c) + dense
              + 2 * q.headroom.numel() * 4 * 2)
    ops = scan_ops(state, pods, cfg, rows, a)
    bound_ms, by = bound(nbytes, ops)
    return dict(pods=n_pods, nodes=n_nodes, mode=mode, scoring=variant,
                assigned=assigned,
                admitted_steps=scans, max_abs_err=err, ms=ms,
                us_per_step=ms * 1e3 / scans if scans else None,
                plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=bound_ms,
                bound_by=by)


def phase_greedy(device, n_pods: int = 1_000, n_nodes: int = 10_240,
                 reps: int = 3):
    """K4 at 1,000 pods x 10,240 nodes with selector classes and a
    two-level quota tree, against its plain version."""
    out = greedy_case(device, 21, n_nodes, n_pods, "classes", reps)
    emit("greedy", **out, bound_note="the chain of dependent steps, not "
         "bytes or operations, sets this kernel's floor")
    return {key: out[key] for key in ("max_abs_err", "ms", "us_per_step",
                                      "plain_ms", "bound_ms", "bound_by")}


def phase_greedy_edges(device, n_pods: int = 400) -> None:
    """K4 at node counts that do not divide into its 16 CTAs' ranges
    (1,000 and 10,000) and at 32,768 (the packed regime's ceiling, where
    the node columns stream from global memory), under dense feasibility
    and selector classes and the scoring configurations of
    phase_k1_edges, behind the quota tree with non-preemptible pods."""
    cases = []
    for i, (n_nodes, mode, variant) in enumerate((
            (1_000, "dense", "everything"), (1_000, "classes", "dominant"),
            (10_000, "dense", "most_allocated"), (10_000, "classes", "agg"),
            (32_768, "classes", "default"))):
        cases.append(greedy_case(device, 60 + i, n_nodes, n_pods, mode,
                                 reps=2, variant=variant))
    emit("greedy_edges", cases=cases)


def admitted_rows(pods, quota, assignments) -> list[int]:
    """The pod rows whose scan steps pass quota admission, in scan order,
    replayed on the host from the scan's assignments: K4 scans the N nodes
    only on those steps."""
    from koordinator_tpu_torch.ops.assignment import priority_order

    valid = pods.valid.cpu().numpy()
    order = priority_order(pods).cpu().numpy()
    req = pods.requests.cpu().numpy().astype(np.int64)
    qid = pods.quota_id.cpu().numpy()
    non_pre = pods.non_preemptible.cpu().numpy()
    a = assignments.cpu().numpy()
    head = quota.headroom.cpu().numpy().astype(np.int64)
    min_head = quota.min_headroom.cpu().numpy().astype(np.int64)
    checked = quota.checked.cpu().numpy()
    chain = quota.chain.cpu().numpy()
    qvalid = quota.valid.cpu().numpy()
    rows = []
    for i in order:
        if not valid[i]:
            continue
        q = int(qid[i])
        if q >= 0:
            need = checked[q] & (req[i] != 0)
            anc = chain[q][chain[q] >= 0]
            ok = bool(qvalid[q]) and not np.any(
                need & (req[i] > head[anc]))
            if non_pre[i]:
                ok = ok and not np.any(need & (req[i] > min_head[q]))
            if not ok:
                continue
        rows.append(int(i))
        if a[i] >= 0 and q >= 0 and qvalid[q]:
            head[anc] -= req[i]
            if non_pre[i]:
                min_head[q] -= req[i]
    return rows


def phase_rescue(device, solve: dict, reps: int = 3, label: str = "rescue",
                 what: str = "a steady round's rescue"):
    """K4 at the main path's shape: the greedy rescue's whole input (a
    steady round's: the compacted quota-blocked leftovers over 10,240
    nodes behind the 16-leaf tree), kernel against plain version:
    assignments, node accounting and every quota field equal."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_kernel
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    state, pods, cfg, quota = (solve["state"], solve["batch"], solve["cfg"],
                               solve["quota"])
    check(quota is not None, "the rescue's quota was recorded")
    a, st, q = greedy_scan_kernel(state, pods, cfg, quota)
    sync(device)
    t0 = time.perf_counter()
    pa, pst, pq = greedy_assign_plain(state, pods, cfg, quota)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [max_abs_err(a, pa),
            max_abs_err(st.node_requested, pst.node_requested)]
    errs += [max_abs_err(getattr(q, f), getattr(pq, f))
             for f in ("headroom", "min_headroom", "checked", "chain",
                       "valid")]
    err = max(errs)
    check(err == 0, f"K4 equals its plain version on {what}")
    ms = timed_ms(lambda: greedy_scan_kernel(state, pods, cfg, quota),
                  device, reps=reps)
    n, p = state.capacity, pods.capacity
    p_valid = int(pods.valid.sum())
    rows = admitted_rows(pods, quota, a)
    scans = len(rows)
    c = pods.selector_mask.shape[1]
    # the node tensors read and node_requested written once, the pod rows
    # and the quota state read and written; operations only on the steps
    # that pass quota admission
    nbytes = (n * (4 * R * 4 + 1 + 4) + n * R * 4
              + p * (2 * R * 4 + 1 + 4 + 4 + 1 + c)
              + 2 * quota.headroom.numel() * 4 * 2)
    ops = scan_ops(state, pods, cfg, rows, a)
    bound_ms, by = bound(nbytes, ops)
    us_per_step = ms * 1e3 / scans if scans else None
    emit(label, pods=p, valid_pods=p_valid, nodes=n,
         quotas=quota.capacity, admitted_steps=scans,
         assigned=int((a >= 0).sum()), max_abs_err=err, ms=ms,
         us_per_step=us_per_step, plain_ms=plain_ms, bytes=nbytes, ops=ops,
         bound_ms=bound_ms, bound_by=by, bound_note="the chain of dependent "
         "steps, not bytes or operations, sets this kernel's floor")
    return dict(max_abs_err=err, ms=ms, us_per_step=us_per_step,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                admitted_steps=scans)


def phase_quota_rounds(device, solve: dict, reps: int = 5,
                       label: str = "quota_rounds") -> dict:
    """K3b on every propose/accept round of a cold round's first solve at
    full size behind the quota tree (the steady phase's round 0): each
    round's whole acceptance (the node level, the chain's 8 columns, the
    non-preemptible level) in ONE launch, held exactly against the plain
    version that composes the levels one by one; the first round timed
    (k3b_round_numbers)."""
    import torch

    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels.prefix_accept import accept_plan
    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba
    from koordinator_tpu_torch.ops.assignment import priority_order
    from koordinator_tpu_torch.quota.admission import quota_admission_mask

    state, pods, cfg, quota = (solve["state"], solve["batch"], solve["cfg"],
                               solve["quota"])
    check(quota is not None, "the cold round's quota was recorded")
    stats = {"k3a_calls": 0, "k3b_calls": 0, "k3b_accepted": 0}
    before = dict(build.LAUNCHES)
    with checked_rounds(stats):
        ba.batch_assign(state, pods, cfg, quota)
    k3a = build.LAUNCHES["round_fit_choose"] - before["round_fit_choose"]
    k3b = (build.LAUNCHES["segmented_prefix_accept"]
           - before["segmented_prefix_accept"])
    check(k3b == k3a == stats["k3b_calls"] > 0,
          "K3b launched once per propose/accept round")
    key, node, _ = select_candidates_kernel(state, pods, cfg, 32)
    free = torch.where(state.node_valid[:, None],
                       state.node_allocatable - state.node_requested, 0)
    active = pods.valid & torch.any(key >= 0, dim=1)
    choice, has = round_fit_choose(key, node, free, pods.requests, active,
                                   pods.rot_id)
    act = active & has & quota_admission_mask(
        quota, pods.requests, pods.quota_id, pods.non_preemptible)
    plan = accept_plan(priority_order(pods), pods.requests, pods.quota_id,
                       pods.non_preemptible, quota.chain, quota.checked)
    first = k3b_round_numbers(device, plan, choice, act, free,
                              quota.headroom, quota.min_headroom, reps)
    emit(label, pods=pods.capacity, nodes=state.capacity,
         quotas=quota.capacity, chain_columns=quota.chain.shape[1],
         rounds=stats["k3b_rounds"], k3b_launches=k3b, first_round=first)
    return first


def k3b_edge_quota(device, q_rows: int = 8):
    """(chain, checked, headroom, min_headroom) of root 0 -> parents 1, 2
    -> leaves 3..6 (row 7 standalone), an 8-column chain."""
    import torch

    parent = [-1, 0, 0, 1, 1, 2, 2, -1]
    chain = np.full((q_rows, 8), -1, np.int32)
    for i in range(q_rows):
        cur, d = i, 0
        while cur >= 0:
            chain[i, d], cur, d = cur, parent[cur], d + 1
    checked = np.zeros((q_rows, R), bool)
    checked[:, CPU] = True
    checked[::2, MEM] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dev(chain), dev(checked)


def phase_k3b_edges(device) -> None:
    """K3b's per-round acceptance and its one-level form against their
    plain versions where the parallel scan has edges: a 65,536-row batch
    in one node and one leaf quota (a run across all 64 tiles of 1,024
    entries at every level), runs of a tile and one entry either side of
    it, rows whose choice is -1 (no fitting candidate, inactive), no
    active pod at any level, a quota tree no pod belongs to (no quota
    entries), and one segment whose sum reaches 2**31 - 1 (the edge of
    the documented domain: the global int32 sum does not overflow)."""
    import torch

    from koordinator_tpu_torch.kernels import prefix_accept as pa

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    chain, checked = k3b_edge_quota(device)
    rng = np.random.default_rng(500)
    results = []

    def run(name, req, choice, act, free, prio, qid=None, npre=None,
            head=None, min_head=None):
        order = torch.sort(-dev(prio), stable=True).indices
        if qid is None:
            plan = pa.accept_plan(order, dev(req))
            extra = ()
        else:
            plan = pa.accept_plan(order, dev(req), dev(qid), dev(npre),
                                  chain, checked)
            extra = (dev(head), dev(min_head))
        args = (plan, dev(choice), dev(act), dev(free), *extra)
        got = pa.round_prefix_accept(*args)
        want = pa.round_prefix_accept_plain(*args)
        err = max_abs_err(got, want)
        check(err == 0, f"K3b equals its plain version ({name})")
        results.append(dict(case=name, pods=len(act), active=int(act.sum()),
                            accepted=int(got.sum()), max_abs_err=err,
                            quota_entries=(0 if plan.entry_pod is None else
                                           plan.entry_pod.shape[0])))
        return got

    def pods(p, cpu_hi=4_000):
        req = np.zeros((p, R), np.int32)
        req[:, CPU] = rng.integers(100, cpu_hi, p)
        req[:, MEM] = rng.integers(128, 8_192, p)
        req[rng.random(p) < 0.1, CPU] = 0
        return req, rng.integers(3_000, 3_010, p).astype(np.int32)

    # one node, one leaf quota: the whole batch is one run at every level
    p = 65_536
    req, prio = pods(p)
    total = req.sum(axis=0).astype(np.int64)
    free = np.zeros((16, R), np.int32)
    free[0] = np.minimum(total // 2, 2**31 - 1)
    head = np.full((8, R), 2**30, np.int32)
    head[[3, 1, 0]] = np.minimum(total * 2 // 3, 2**30)
    min_head = np.full((8, R), 2**30, np.int32)
    min_head[3] = np.minimum(total // 40, 2**30)
    got = run("one_segment_65536", req, np.zeros(p, np.int32),
              np.ones(p, bool), free, prio, np.full(p, 3, np.int32),
              rng.random(p) < 0.05, head, min_head)
    check(0 < int(got.sum()) < p, "the one-segment batch is contended")
    # runs of a tile (1,024 entries) and one either side, at the node and
    # the leaf level; 30% of the rows with no fitting candidate
    sizes = [1_023, 1_024, 1_025, 1, 2_047, 2_048, 2_049, 1_024, 1_023]
    p = int(sum(sizes))
    req, prio = pods(p)
    prio[:] = 3_000                   # priority order is row order
    choice = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    free = np.zeros((len(sizes), R), np.int32)
    for g in range(len(sizes)):
        free[g] = req[choice == g].sum(axis=0) // 2
    qid = np.repeat(np.arange(3, 3 + 4), -(-p // 4))[:p].astype(np.int32)
    has = rng.random(p) < 0.7
    run("tile_runs", req, choice, np.ones(p, bool), free, prio)
    run("tile_runs_quota", req, np.where(has, choice, -1), has, free, prio,
        qid, rng.random(p) < 0.2, np.full((8, R), 4_000_000, np.int32),
        np.full((8, R), 200_000, np.int32))
    # nothing active; a tree with no pod in it
    run("no_active", req, choice, np.zeros(p, bool), free, prio, qid,
        np.ones(p, bool), head, min_head)
    got = run("no_quota_pods", req, choice, np.ones(p, bool), free, prio,
              np.full(p, -1, np.int32), np.zeros(p, bool), head, min_head)
    check(results[-1]["quota_entries"] == 0, "no quota entries")
    # the wrap edge: 4,096 pods whose cpu sums to 2**31 - 1 in one node,
    # the tail half of them just over their headroom
    p = 4_096
    req = np.zeros((p, R), np.int32)
    req[:, CPU] = (2**31 - 1) // p
    req[-1, CPU] += (2**31 - 1) - int(req[:, CPU].astype(np.int64).sum())
    free = np.full((2, R), 2**31 - 1, np.int32)
    got = run("wrap_edge", req, np.zeros(p, np.int32), np.ones(p, bool),
              free, np.zeros(p, np.int32))
    check(bool(got.all()), "the whole int32 range fits its headroom")
    choice_free = np.full((p, R), 2**31 - 1, np.int32)
    choice_free[p // 2:, CPU] = 2**31 - 2
    args = (dev(np.zeros(p, np.int32)), dev(req), dev(choice_free),
            torch.arange(p, device=device), dev(np.ones(p, bool)), 1)
    got = pa.segmented_prefix_accept(*args)
    err = max_abs_err(got, pa.segmented_prefix_accept_plain(*args))
    check(err == 0 and not bool(got[-1]) and bool(got[: p // 2].all()),
          "K3b's one-level form at the wrap edge")
    results.append(dict(case="wrap_edge_one_level", pods=p,
                        accepted=int(got.sum()), max_abs_err=err))
    emit("k3b_edges", cases=results)


N_LEAVES, N_PARENTS = 16, 4


def steady_specs(seed: int = 3, n_nodes: int = 10_240, n_pods: int = 50_000):
    """The flagship nodes and pods, 80% of the pods in one of 16 leaf
    quotas; returns (nodes, pods, leaf cpu max) with each leaf's max cpu
    at 60% of its pods' cpu requests."""
    import dataclasses

    nodes, pods = main_path_specs(seed, n_nodes, n_pods)
    rng = np.random.default_rng(seed + 100)
    leaf = rng.integers(0, N_LEAVES, n_pods)
    quota_on = rng.random(n_pods) < 0.8
    non_pre = rng.random(n_pods) < 0.05
    cpu = np.zeros(N_LEAVES, np.int64)
    out = []
    for j, pod in enumerate(pods):
        q = f"leaf-{leaf[j]}" if quota_on[j] else None
        if q is not None:
            cpu[leaf[j]] += int(pod.requests[CPU])
        out.append(dataclasses.replace(
            pod, quota=q, non_preemptible=bool(non_pre[j] and q)))
    return nodes, out, (cpu * 6) // 10


def steady_tree(nodes, leaf_max_cpu):
    """root -> 4 parents -> 16 leaves, cpu checked at both levels."""
    from koordinator_tpu_torch.quota.tree import QuotaTree

    total = np.sum([n.allocatable for n in nodes], axis=0).astype(np.int64)
    tree = QuotaTree(total)
    per = N_LEAVES // N_PARENTS
    for i in range(N_PARENTS):
        mx = np.full(R, -1, np.int64)
        mx[CPU] = int(leaf_max_cpu[i * per:(i + 1) * per].sum())
        tree.add(f"parent-{i}", np.zeros(R, np.int64), mx)
        for j in range(i * per, (i + 1) * per):
            leaf_mx = np.full(R, -1, np.int64)
            leaf_mx[CPU] = int(leaf_max_cpu[j])
            mn = np.zeros(R, np.int64)
            mn[CPU] = int(leaf_max_cpu[j]) // 20
            tree.add(f"leaf-{j}", mn, leaf_mx, parent=f"parent-{i}")
    return tree


def arrivals(rng, start: int, count: int):
    """``count`` new flagship-shaped pods, 20% of them with no quota."""
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    out = []
    for j in range(start, start + count):
        req = np.zeros(R, np.int32)
        req[CPU] = rng.integers(100, 4_000)
        req[MEM] = rng.integers(128, 8_192)
        q = (None if rng.random() < 0.2
             else f"leaf-{rng.integers(0, N_LEAVES)}")
        out.append(PodSpec(name=f"new-{j}", requests=req,
                           priority=int(rng.integers(3000, 9999)),
                           quota=q, creation=float(j)))
    return out


def usage_refresh(rng, nodes: list, count: int):
    """New NodeSpecs for ``count`` random nodes with fresh usage (the 1%
    NodeMetric delta of bench_stages.py's refresh_incremental_1pct)."""
    import dataclasses

    out = []
    for i in rng.choice(len(nodes), count, replace=False):
        spec = nodes[i]
        usage = (spec.allocatable * rng.random(R) * 0.5).astype(np.int32)
        nodes[i] = dataclasses.replace(spec, usage=usage)
        out.append(nodes[i])
    return out


STEADY_SCHEDULERS = (("defaults", {}), ("forced", {"threshold": 1.0}),
                     ("full", {"incremental": False}))


def steady_scheduler(device, nodes, pods, leaf_max, incremental=True,
                     threshold=None):
    """A scheduler over a fresh snapshot of ``nodes`` behind the 16-leaf
    quota tree, with ``pods`` pending."""
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    snap = ClusterSnapshot(capacity=len(nodes), device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    sched = Scheduler(snap, quota_tree=steady_tree(nodes, leaf_max),
                      incremental_solve=incremental, device=device)
    if threshold is not None:
        sched.incremental_dirty_threshold = threshold
    sched.enqueue_many(pods)
    return sched


def steady_delta(rng, nodes: list, rnd: int, n_arrivals: int = 500):
    """One steady round's delta: (node specs with refreshed usage for 1%
    of the nodes, the round's arrivals)."""
    return (usage_refresh(rng, nodes, len(nodes) // 100),
            arrivals(rng, (rnd - 1) * n_arrivals, n_arrivals))


def phase_steady(device, n_nodes: int = 10_240, n_pods: int = 50_000,
                 steady_rounds: int = 5, n_arrivals: int = 500):
    """The steady-state batch path on three schedulers over one sequence;
    their binds must agree every round, and every scheduler launches K3b
    once per propose/accept round (as often as K3a).  K3b is held against
    its plain version on every round of the forced scheduler's cold solve
    (phase_quota_rounds) and K4 on its last round's rescue (phase_rescue).
    Every round's Diagnose runs K7 and is checked against the plain path
    (checked_diagnose), its failures equal across the schedulers field by
    field; K7 is held against its plain version on the forced scheduler's
    last steady round's failed rows.  Returns (schedulers, the forced
    scheduler's launches over the whole run, the round records, K4's
    numbers at the rescue, K3b's at the cold solve's first round, K7's at
    the last steady round)."""
    import dataclasses

    from koordinator_tpu_torch.kernels import build

    nodes, pods, leaf_max = steady_specs(3, n_nodes, n_pods)
    scheds = {name: steady_scheduler(device, nodes, pods, leaf_max, **opt)
              for name, opt in STEADY_SCHEDULERS}
    rng = np.random.default_rng(5)
    enqueued = {}
    totals = {kname: 0 for kname in build.LAUNCHES}
    binds_by = {name: {} for name in scheds}
    records, dlog = [], []
    k7_call = None
    for rnd in range(1 + steady_rounds):
        if rnd > 0:
            refreshed, new = steady_delta(rng, nodes, rnd, n_arrivals)
            enqueued.update((p.name, p) for p in new)
            for sched in scheds.values():
                for spec in refreshed:
                    sched.snapshot.upsert_node(spec)
                sched.enqueue_many(new)
        results = {}
        for name, sched in scheds.items():
            log: list = []
            n_diag = len(dlog)
            build.reset_launch_counts()
            with solve_probe(log, device), checked_diagnose(dlog):
                sync(device)
                t0 = time.perf_counter()
                res = sched.schedule_round()
                sync(device)
                wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            diag = diagnose_fields(dlog[n_diag:])
            # the round's wall without the check's plain counts
            wall -= diag["diagnose_check_s"]
            check(launches["explain_counts"] == (1 if res.failures else 0),
                  f"round {rnd}, {name}: Diagnose launched K7")
            if name == "forced" and rnd == steady_rounds:
                k7_call = dlog[-1]["call"]
            if name == "forced":
                for kname, count in launches.items():
                    totals[kname] += count
                if rnd == 0:
                    k3b = phase_quota_rounds(device, next(
                        s for s in log if s["solver"] == "batch"))
                if rnd == steady_rounds:
                    rescues = [s for s in log if s["solver"] == "greedy"]
                    check(len(rescues) == 1, "the last steady round rescued")
                    rescue = phase_rescue(device, rescues[0])
            results[name] = res
            binds_by[name].update(res.assignments)
            records.append(dict(
                round=rnd, scheduler=name, path=sched.last_solve_path,
                dirty_node_frac=sched.last_dirty_node_frac,
                dirty_pod_frac=sched.last_dirty_pod_frac,
                pods=res.round_pods, wall_s=wall,
                solve_ms=[s["ms"] for s in log if s["solver"] == "batch"],
                rescue_ms=[s["ms"] for s in log if s["solver"] == "greedy"],
                k1=launches["select_candidates"],
                k2=launches["refresh_candidates"],
                k3a=launches["round_fit_choose"],
                k3b=launches["segmented_prefix_accept"],
                k4=launches["greedy_scan"], binds=len(res.assignments),
                rescued=res.rescued, failed=len(res.failures),
                k7=launches["explain_counts"], **diag))
            emit("steady_round", **records[-1])
            check(records[-1]["k3b"] == records[-1]["k3a"],
                  f"round {rnd}, {name}: one K3b launch a propose/accept "
                  "round")
        first = results["defaults"]
        first_failures = {n: dataclasses.asdict(d)
                          for n, d in first.failures.items()}
        for name, res in results.items():
            check(res.assignments == first.assignments,
                  f"round {rnd}: {name} binds equal the defaults'")
            check({n: dataclasses.asdict(d) for n, d in res.failures.items()}
                  == first_failures,
                  f"round {rnd}: {name} failures equal the defaults'")
        check(len(first.assignments) > 0, f"round {rnd} bound pods")
    forced = [r for r in records if r["scheduler"] == "forced"]
    check(forced[0]["path"] == "full_cold", "the first round is cold")
    check(all(r["path"] == "incremental" for r in forced[1:]),
          "the forced scheduler refreshed every steady round")
    for kname, count in totals.items():
        # K4r runs only where reservations exist (phase_reservations), K1a
        # only under an approx candidate method (phase_approx), K5 and K6
        # only with preemption and the overuse revoke on (phase_preemption)
        check(count > 0 or kname in ("reservation_scan",
                                     "select_candidates_approx",
                                     "victim_select", "overuse_revoke"),
              f"{kname} launched on the steady-state path")
    by_name = {p.name: p for p in pods}
    by_name.update(enqueued)
    for name, sched in scheds.items():
        st = sched.snapshot.state
        requested = st.node_requested.cpu().numpy().astype(np.int64)
        alloc = st.node_allocatable.cpu().numpy().astype(np.int64)
        check(bool((requested <= alloc).all()), f"{name}: no overcommit")
        expect = np.zeros_like(requested)
        for pod, node in binds_by[name].items():
            spec = by_name[pod]
            expect[sched.snapshot.node_index[node]] += spec.requests
        check(np.array_equal(expect, requested),
              f"{name}: accounting = sum of binds")
        for qname, q in sched.quota_tree.nodes.items():
            if not sched.quota_tree.children[qname]:
                check(bool((q.used[CPU] <= q.max[CPU])),
                      f"{name}: {qname} used within its max")
    check(k7_call is not None, "the last steady round ran K7")
    k7 = held_k7(device, k7_call, "at phase 9's last steady round")
    emit("steady", nodes=n_nodes, pods=n_pods, rounds=1 + steady_rounds,
         arrivals=n_arrivals, forced_launches=totals,
         backlog=len(scheds["defaults"].pending))
    return scheds, totals, records, rescue, k3b, k7


def phase_small(device, scheds: dict, rounds: int = 3,
                n_arrivals: int = 500):
    """Small rounds on the filled cluster: before each round the pending
    queue is withdrawn (the quota-blocked backlog and the last round's
    failures), so each round holds just its 500 arrivals and goes greedy
    (K4) on the defaults scheduler, and through the plain versions on the
    incremental-off one; binds equal."""
    from koordinator_tpu_torch.kernels import build

    kern, plain = scheds["defaults"], scheds["full"]
    rng = np.random.default_rng(9)
    out = []
    for rnd in range(rounds):
        for sched in (kern, plain):
            for name in list(sched.pending):
                sched.dequeue(name)
        new = arrivals(rng, 100_000 + rnd * n_arrivals, n_arrivals)
        kern.enqueue_many(new)
        plain.enqueue_many(new)
        build.reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        kr = kern.schedule_round()
        sync(device)
        kernel_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        with plain_path():
            t0 = time.perf_counter()
            pr = plain.schedule_round()
            sync(device)
            plain_s = time.perf_counter() - t0
        check(kern.last_solve_path == "greedy", "small rounds go greedy")
        check(launches["greedy_scan"] > 0, "K4 launched on a small round")
        check(kr.assignments == pr.assignments,
              f"small round {rnd}: binds equal the plain path's")
        check(failure_docs(kr) == failure_docs(pr),
              f"small round {rnd}: failures equal the plain path's")
        check(max_abs_err(kern.snapshot.state.node_requested,
                          plain.snapshot.state.node_requested) == 0,
              f"small round {rnd}: node accounting equal")
        out.append(dict(round=rnd, pods=kr.round_pods,
                        binds=len(kr.assignments), kernel_s=kernel_s,
                        plain_s=plain_s, k4=launches["greedy_scan"]))
    emit("small_rounds", rounds=out)
    return out


# -- reservations (K4r) -------------------------------------------------------

#: the reservations phase: Reservation CRs on the flagship cluster, 128 of
#: them pinned to named nodes, owner selectors over 64 apps, every 16th
#: with a 60 s TTL (64 expire in round 3)
N_RESERVATIONS = 1_024
N_PINNED = 128
N_APPS = 64

#: int32 operations of K4r's test of one reservation row for one pod, as
#: rsv_scan_ops counts them: the match bit on every row; on a matched row
#: the remainder and its sign per dim, the Aligned and Restricted compares
#: per requested dim, the policy's verdict and the node flag
RSV_ROW_OPS = dict(match=1, dim=2, req_dim=4, verdict=2)


def reservation_specs(rng, nodes, count: int, pinned: int):
    """cpu 2,000-8,000 mcores and memory 4,096-16,384 MiB each; the first
    ``pinned`` on distinct named nodes, the rest placed by reserve-pods;
    25% allocate-once and 25% Restricted; owners app=svc-<i mod 64>."""
    from koordinator_tpu_torch.scheduler.reservations import (
        OwnerMatcher,
        ReservationSpec,
    )

    pin = rng.choice(len(nodes), pinned, replace=False)
    out = []
    for i in range(count):
        req = np.zeros(R, np.int32)
        req[CPU] = rng.integers(2_000, 8_001)
        req[MEM] = rng.integers(4_096, 16_385)
        out.append(ReservationSpec(
            name=f"rsv-{i}", requests=req,
            owners=[OwnerMatcher(labels={"app": f"svc-{i % N_APPS}"})],
            allocate_once=(i % 4 == 1), restricted=(i % 4 == 2),
            node=nodes[pin[i]].name if i < pinned else None,
            ttl_sec=60.0 if i % 16 == 3 else None))
    return out


def owner_pods(rng, start: int, count: int):
    """Owner pods: cpu 250-2,000, memory 512-4,096, priorities
    3,000-9,999, app=svc-<j mod 64>."""
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    out = []
    for j in range(start, start + count):
        req = np.zeros(R, np.int32)
        req[CPU] = rng.integers(250, 2_001)
        req[MEM] = rng.integers(512, 4_097)
        out.append(PodSpec(name=f"owner-{j}", requests=req,
                           priority=int(rng.integers(3_000, 10_000)),
                           labels={"app": f"svc-{j % N_APPS}"},
                           creation=float(1_000_000 + j)))
    return out


@contextlib.contextmanager
def prepass_probe(log: list, device):
    """Keep the inputs and outputs of every reservation pre-pass scan the
    scheduler runs, with its time (CUDA events on the card)."""
    import torch

    from koordinator_tpu_torch.scheduler import scheduler as sched_mod

    real = sched_mod.reservation_greedy_assign
    on_card = torch.device(device).type == "cuda"

    def probe(state, pods, cfg, rsv, match, quota=None, boost=10_000):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = real(state, pods, cfg, rsv, match, quota, boost)
        if on_card:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        log.append(dict(state=state, pods=pods, cfg=cfg, rsv=rsv,
                        match=match, quota=quota, out=out, ms=ms))
        return out

    sched_mod.reservation_greedy_assign = probe
    try:
        yield
    finally:
        sched_mod.reservation_greedy_assign = real


def scan_rows(pods, quota, assignments) -> list[int]:
    """The rows whose scan steps pass admission, in scan order."""
    from koordinator_tpu_torch.ops.assignment import priority_order

    if quota is not None:
        return admitted_rows(pods, quota, assignments)
    valid = pods.valid.cpu().numpy()
    return [int(i) for i in priority_order(pods).cpu().numpy() if valid[i]]


def rsv_scan_ops(state, pods, cfg, rsv, match, rows, assignments,
                 rsv_choice) -> int:
    """K4r's int32 operations: on each step that passes admission (the pod
    ``rows``, in scan order), pair_ops over every node with the fit the
    pod's reservations extend, and RSV_ROW_OPS over the placed reservation
    rows, against the accounting and the remainders the steps before left
    (replayed from the scan's outputs as greedy_scan_plain keeps them)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows
    from koordinator_tpu_torch.ops.assignment import pod_estimates
    from koordinator_tpu_torch.ops.reservation import (
        allocate_from_reservation,
        score_pods_with_reservations,
    )

    n = state.capacity
    est = pod_estimates(pods, cfg)
    requested = state.node_requested.clone()
    added = torch.zeros_like(state.node_usage)
    placed = rsv.valid & (rsv.node_idx >= 0) & (rsv.node_idx < n)
    n_placed = int(placed.sum())
    a = assignments.cpu().numpy()
    rc = rsv_choice.cpu().numpy()
    o = RSV_ROW_OPS
    cur = rsv
    ops = 0
    for i in rows:
        now = state.replace(node_requested=requested,
                            node_usage=state.node_usage + added,
                            node_agg_usage=state.node_agg_usage + added)
        sub = _pod_rows(pods, i, i + 1)
        m = match[i:i + 1]
        _, feas, _ = score_pods_with_reservations(now, sub, cfg, cur, m)
        ops += pair_ops(cfg, sub.requests, state.node_allocatable, feas)
        matched = int((m[0] & placed).sum())
        n_req = int((pods.requests[i] != 0).sum())
        ops += n_placed * o["match"] + matched * (
            R * o["dim"] + n_req * o["req_dim"] + o["verdict"])
        if a[i] >= 0:
            cur, spill = allocate_from_reservation(cur, int(rc[i]),
                                                   pods.requests[i])
            requested[a[i]] += spill
            added[a[i]] += est[i]
    return ops


def rsv_case(device, state, pods, cfg, rsv, match, quota=None,
             reps: int = 3, with_bound: bool = True) -> dict:
    """K4r against its plain version on one problem: the assignments, the
    reservation choices, the node accounting, the reservations' allocated
    and the quota state equal.  Returns the case's numbers: its time, the
    plain version's, where the launch kept its state, and its bound."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels.greedy_scan import (
        reservation_records,
        reservation_scan_kernel,
    )
    from koordinator_tpu_torch.ops.assignment import greedy_scan_plain

    a, rc, st, nr, q = reservation_scan_kernel(state, pods, cfg, rsv, match,
                                               quota)
    sync(device)
    t0 = time.perf_counter()
    pa, prc, pst, pnr, pq = greedy_scan_plain(state, pods, cfg, quota, rsv,
                                              match)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = dict(assignments=max_abs_err(a, pa),
                rsv_choice=max_abs_err(rc, prc),
                node_requested=max_abs_err(st.node_requested,
                                           pst.node_requested),
                allocated=max_abs_err(nr.allocated, pnr.allocated))
    if quota is not None:
        errs["headroom"] = max_abs_err(q.headroom, pq.headroom)
        errs["min_headroom"] = max_abs_err(q.min_headroom, pq.min_headroom)
    err = max(errs.values())
    check(err == 0, f"K4r equals its plain version ({errs})")
    ms = timed_ms(lambda: reservation_scan_kernel(state, pods, cfg, rsv,
                                                  match, quota),
                  device, reps=reps)
    lib = build.lib()
    n, p, v = state.capacity, pods.capacity, rsv.capacity
    q_rows, depth = ((0, 0) if quota is None
                     else (quota.capacity, quota.chain.shape[1]))
    records, _, vmax = reservation_records(
        rsv, n, lib.koord_reservation_scan_nodes_per_cta(n))
    plan = lib.koord_reservation_scan_plan(n, q_rows, depth, vmax)
    check(plan >= 0, "K4r's plan could be asked")
    rows = scan_rows(pods, quota, a)
    node_rows = np.bincount(records[:, 2 * R].cpu().numpy(), minlength=n)
    out = dict(pods=p, valid_pods=int(pods.valid.sum()), nodes=n,
               reservations=v, placed=records.shape[0], most_on_a_cta=vmax,
               most_on_a_node=int(node_rows.max()) if len(node_rows) else 0,
               nodes_in_smem=bool(plan & 1), records_staged=bool(plan & 2),
               assigned=int((a >= 0).sum()),
               through_reservation=int((rc >= 0).sum()),
               max_abs_err=err, ms=ms, admitted_steps=len(rows),
               us_per_step=ms * 1e3 / len(rows) if rows else None,
               plain_ms=plain_ms)
    if with_bound:
        c = 0 if pods.selector_mask is None else pods.selector_mask.shape[1]
        dense = 0 if pods.feasible is None else len(rows) * n
        vp = records.shape[0]
        # the node tensors read and node_requested written once, the pod
        # rows, the (P, V) match and the records read, allocated and the
        # two per-pod outputs written, the quota state read and written
        nbytes = (n * (4 * R * 4 + 1 + 4) + n * R * 4
                  + p * (2 * R * 4 + 1 + 4 + 4 + 1 + c) + dense + p * v
                  + vp * (2 * R * 4 + 3 * 4) + vp * R * 4 + 2 * p * 4
                  + (0 if quota is None
                     else 2 * quota.headroom.numel() * 4 * 2))
        ops = rsv_scan_ops(state, pods, cfg, rsv, match, rows, a, rc)
        bound_ms, by = bound(nbytes, ops)
        out.update(bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=by)
    return out


def reservation_ledger(sched) -> np.ndarray:
    """(N, R) node accounting the host records imply: each bound pod's
    request less what it drew from a reservation still Available as the
    instance it drew from (else the larger of its request and its draw),
    plus each Available reservation's reserved vector."""
    from koordinator_tpu_torch.scheduler.reservations import ReservationPhase

    snap = sched.snapshot
    out = np.zeros(tuple(snap.state.node_requested.shape), np.int64)
    for bp in sched.bound.values():
        req = bp.requests.astype(np.int64)
        if bp.reservation is not None and bp.rsv_drawn is not None:
            spec = sched.reservations.get(bp.reservation)
            drawn = bp.rsv_drawn.astype(np.int64)
            if (spec is not None and spec.phase is ReservationPhase.AVAILABLE
                    and spec.generation == bp.rsv_generation):
                req = req - drawn
            else:
                req = np.maximum(req, drawn)
        out[snap.node_index[bp.node]] += req
    for spec in sched.reservations.available():
        out[snap.node_index[spec.node]] += spec.requests.astype(np.int64)
    return out


def reservation_checks(sched, result, label: str) -> dict:
    """No node over its allocatable, no reservation's allocated over its
    reserved, every pre-pass bind of ``result`` on its reservation's node,
    and the node accounting equal to what the host records imply."""
    st = sched.snapshot.state
    requested = st.node_requested.cpu().numpy().astype(np.int64)
    alloc = st.node_allocatable.cpu().numpy().astype(np.int64)
    check(bool((requested <= alloc).all()), f"{label}: no node overcommitted")
    for spec in sched.reservations.specs():
        if spec.allocated is not None:
            check(bool((spec.allocated <= spec.requests).all()),
                  f"{label}: {spec.name} allocated within reserved")
    through = 0
    for name in result.assignments:
        bp = sched.bound.get(name)
        if bp is None or bp.reservation is None:
            continue
        through += 1
        spec = sched.reservations.get(bp.reservation)
        check(spec is not None and spec.node == bp.node,
              f"{label}: {name} bound on its reservation's node")
    check(np.array_equal(reservation_ledger(sched), requested),
          f"{label}: node accounting = bound pods + reservations")
    return dict(through_reservation=through)


def phase_reservations(device, n_nodes: int = 10_240, n_pods: int = 50_000,
                       n_rsv: int = N_RESERVATIONS,
                       n_pinned: int = N_PINNED, n_owners: int = 3_000,
                       n_removed: int = 500, n_late: int = 1_000):
    """The Reservation lifecycle through the port's Scheduler on the
    flagship cluster.  Round 1: the 50,000-pod backlog and 1,024
    Reservation CRs (128 pinned, 896 placed by reserve-pods through the
    batch solve).  Round 2: 3,000 owner pods; the pre-pass takes the 2,048
    of highest priority on K4r, the rest go to the batch solve.  Round 3:
    500 bound owner pods removed, 64 reservations expired by TTL, 1,000
    more owner pods.  K4r is held against its plain version at round 2's
    pre-pass.  Returns (K4r's numbers there, its launches over the three
    rounds)."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    nodes, pods = main_path_specs(0, n_nodes, n_pods)
    rng = np.random.default_rng(17)
    snap = ClusterSnapshot(capacity=n_nodes, device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    sched = Scheduler(snap, device=device, clock=lambda: now[0])
    for spec in reservation_specs(rng, nodes, n_rsv, n_pinned):
        sched.add_reservation(spec)
    sched.enqueue_many(pods)
    launches = {kname: 0 for kname in build.LAUNCHES}
    records = []
    k4r = None
    for rnd in (1, 2, 3):
        if rnd == 2:
            now[0] = 10.0
            sched.enqueue_many(owner_pods(rng, 0, n_owners))
        if rnd == 3:
            now[0] = 120.0
            owners = sorted(n for n, b in sched.bound.items()
                            if n.startswith("owner-"))
            for name in rng.choice(owners, n_removed, replace=False):
                sched.delete_pod(str(name))
            sched.enqueue_many(owner_pods(rng, n_owners, n_late))
        before = len(sched.reservations)
        log: list = []
        build.reset_launch_counts()
        with prepass_probe(log, device):
            sync(device)
            t0 = time.perf_counter()
            res = sched.schedule_round()
            sync(device)
            wall = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        for kname, count in counts.items():
            launches[kname] += count
        rec = dict(round=rnd, pods=res.round_pods, wall_s=wall,
                   solver=sched.last_solver, path=sched.last_solve_path,
                   binds=len(res.assignments), failed=len(res.failures),
                   reservations_before=before,
                   available=len(sched.reservations.available()),
                   prepass_pods=[int(s["pods"].valid.sum()) for s in log],
                   prepass_ms=[s["ms"] for s in log], k4r=counts[
                       "reservation_scan"], k1=counts["select_candidates"],
                   k4=counts["greedy_scan"])
        rec.update(reservation_checks(sched, res, f"round {rnd}"))
        records.append(rec)
        emit("reservation_round", **rec)
        if rnd == 1:
            check(rec["available"] == n_rsv,
                  "every reservation opened in round 1")
            check(sum(1 for name in res.assignments
                      if name.startswith("rsv::")) == n_rsv - n_pinned,
                  "the reserve-pods placed through the solve")
            check(sched.last_solver == "batch", "round 1 took the batch solve")
        else:
            check(len(log) == 1 and counts["reservation_scan"] >= 1,
                  f"round {rnd}: the pre-pass ran on K4r")
            check(rec["through_reservation"] > 0,
                  f"round {rnd}: owner pods drew from reservations")
        if rnd == 2:
            check(rec["prepass_pods"] == [sched.rsv_prepass_cap],
                  "the pre-pass took the cap of owner pods")
            check(sched.last_solver == "batch",
                  "the cap's overflow went to the batch solve")
            s = log[0]
            k4r = rsv_case(device, s["state"], s["pods"], s["cfg"], s["rsv"],
                           s["match"], s["quota"])
            k4r["in_round_ms"] = s["ms"]
            emit("reservation_k4r", **k4r)
    ttl = [f"rsv-{i}" for i in range(n_rsv) if i % 16 == 3]
    check(all(sched.reservations.get(name) is None for name in ttl),
          f"the {len(ttl)} reservations with a TTL expired in round 3")
    emit("reservations", nodes=n_nodes, backlog=n_pods, reservations=n_rsv,
         pinned=n_pinned, owners=n_owners,
         removed=n_removed, late_owners=n_late, launches=launches)
    return k4r, launches["reservation_scan"]


def random_reservations(rng, state, n_rows: int, on_nodes=None,
                        exhausted: float = 0.15):
    """A seeded ReservationSet over ``state``'s nodes on its device:
    aligned and Restricted rows, allocate-once rows, exhausted rows,
    partly drawn rows, unplaced rows and zero dims."""
    from koordinator_tpu_torch.ops.reservation import ReservationSet

    n = state.capacity
    reserved = np.zeros((n_rows, R), np.int32)
    reserved[:, CPU] = rng.integers(500, 8_000, n_rows)
    reserved[:, MEM] = rng.integers(256, 16_384, n_rows)
    reserved[rng.random(n_rows) < 0.2, MEM] = 0
    allocated = (reserved * rng.random((n_rows, R)) * 0.6).astype(np.int32)
    drained = rng.random(n_rows) < exhausted
    allocated[drained] = reserved[drained]
    nodes = (rng.integers(0, n, n_rows) if on_nodes is None
             else rng.choice(np.asarray(on_nodes), n_rows))
    nodes[rng.random(n_rows) < 0.05] = -1
    return ReservationSet.build(
        reserved, nodes.astype(np.int32), allocated=allocated,
        allocate_once=rng.random(n_rows) < 0.25,
        restricted=rng.random(n_rows) < 0.3, device=state.device)


#: K4r's edge cases: (label, nodes, pods, rows, mode, options)
RSV_EDGES = (
    ("every reservation on one node", 1_000, 300, 64, "classes",
     dict(on_nodes=[7])),
    ("records in the global array", 10_240, 200, 4_096, "classes",
     dict(on_nodes=[0, 1, 2, 3])),
    ("exhausted rows", 1_000, 300, 128, "dense", dict(exhausted=0.6)),
    ("the quota tree", 10_240, 400, 512, "classes", dict(quota=True)),
    ("node columns in the global scratch", 32_768, 200, 256, "classes", {}),
)


def quota_state(device, head, checked, chain):
    """A QuotaDeviceState of the given (Q, R) headroom, (Q, R) checked
    dims and (Q, D) chains, every row valid, no min headroom."""
    import torch

    from koordinator_tpu_torch.quota.admission import QuotaDeviceState

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    return QuotaDeviceState(
        headroom=t(head), min_headroom=t(np.zeros_like(head)),
        checked=t(checked), chain=t(chain),
        valid=t(np.ones(len(head), bool)))


def step_edge_problem(device, case: str, n_nodes: int = 10_240):
    """(state, pods, quota) of one edge of K4's and K4r's step:
    ``leaf_pairs``: 16 quota leaves of 4,000 mcores, whose pods come back
    to back in priority order, 2,400 + 2,400 + 1,200 mcores: the second
    fits the leaf's headroom until the first is charged, so the
    speculated next pod is turned away and the search resumes at the
    third; ``ties``: identical, empty nodes, so every CTA's best rank ties
    and the lowest node must win each step; ``wraps``: leaves qa (cpu
    checked) and qb (cpu and memory) under a parent whose memory headroom
    is -2**31 + 1,000, pods alternating qa, qb: qb's are rejected until
    qa's first charge wraps that headroom past int32's minimum, a rise
    the kernel must see (one qa pod also requests -500 mcores);
    ``window``: 600 pods, the first 300 of one leaf of 1,000 mcores:
    pod 0 requests -10,000 mcores and the 2,000-mcore pods behind it are
    rejected until its charge, so the next pod admitted while it is scored
    lies past K4's 256-pod window, and the search that runs again from
    pod 1 must stage the window anew behind the old one (pods 1-5 are
    admitted after all)."""
    from koordinator_tpu_torch.state.cluster_state import PodBatch

    state, _ = random_problem(400, n_nodes, 8, device)
    if case == "ties":
        alloc = np.zeros((n_nodes, R), np.int32)
        alloc[:, CPU], alloc[:, MEM] = 32_000, 131_072
        zero = np.zeros((n_nodes, R), np.int32)
        state = state.replace(
            node_allocatable=to_dev(alloc, device),
            node_requested=to_dev(zero, device),
            node_usage=to_dev(zero, device),
            node_agg_usage=to_dev(zero, device))
        n_pods = 300
        req = np.zeros((n_pods, R), np.int32)
        req[:, CPU], req[:, MEM] = 1_000, 2_048
        quota = None
        qid = None
    elif case == "wraps":
        n_pods = 96
        req = np.zeros((n_pods, R), np.int32)
        req[:, CPU], req[:, MEM] = 500, 2_048
        req[4, CPU] = -500
        head = np.full((3, R), 10**6, np.int32)
        head[0, MEM] = -(2**31) + 1_000
        checked = np.zeros((3, R), bool)
        checked[:, CPU] = True
        checked[2, MEM] = True
        quota = quota_state(device, head, checked,
                            np.array([[0, -1], [1, 0], [2, 0]], np.int32))
        qid = np.tile(np.array([1, 2], np.int32), n_pods // 2)
    elif case == "window":
        n_pods, tight = 600, 300
        req = np.zeros((n_pods, R), np.int32)
        req[:, CPU] = np.where(np.arange(n_pods) < tight, 2_000, 500)
        req[0, CPU] = -10_000
        req[:, MEM] = 1_024
        head = np.zeros((1, R), np.int32)
        head[0, CPU] = 1_000
        checked = np.zeros((1, R), bool)
        checked[0, CPU] = True
        quota = quota_state(device, head, checked,
                            np.array([[0, -1]], np.int32))
        qid = np.where(np.arange(n_pods) < tight, 0, -1).astype(np.int32)
    else:
        n_leaves = 16
        n_pods = 3 * n_leaves
        req = np.zeros((n_pods, R), np.int32)
        req[:, CPU] = np.tile([2_400, 2_400, 1_200], n_leaves)
        req[:, MEM] = 1_024
        head = np.zeros((n_leaves, R), np.int32)
        head[:, CPU] = 4_000
        checked = np.zeros((n_leaves, R), bool)
        checked[:, CPU] = True
        chain = np.full((n_leaves, 2), -1, np.int32)
        chain[:, 0] = np.arange(n_leaves)
        quota = quota_state(device, head, checked, chain)
        qid = np.repeat(np.arange(n_leaves, dtype=np.int32), 3)
    pods = PodBatch.build(
        req, priority=(9_000 - np.arange(n_pods)).astype(np.int32),
        quota_id=qid, rot_id=np.arange(n_pods, dtype=np.int32),
        node_capacity=n_nodes, class_capacity=8, device=device)
    return state, pods, quota


def phase_step_edges(device) -> None:
    """K4 against its plain version on the step's edges
    (step_edge_problem): consecutive pods of one quota leaf whose headroom
    covers one of them (speculative admission must resume the search), a
    cluster of identical nodes (the 16 CTAs' best ranks tie), a charge
    that wraps a headroom past int32's minimum, raising it (the search
    must run again from the charged pod), and a negative request's charge
    after the speculated pod moved the pod window past the charged one
    (the window is staged again behind it)."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_kernel
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    cfg = scoring_config("default", device)
    cases = []
    for case in ("leaf_pairs", "ties", "wraps", "window"):
        state, pods, quota = step_edge_problem(device, case)
        a, st, q = greedy_scan_kernel(state, pods, cfg, quota)
        pa, pst, pq = greedy_assign_plain(state, pods, cfg, quota)
        errs = [max_abs_err(a, pa),
                max_abs_err(st.node_requested, pst.node_requested)]
        if quota is not None:
            errs.append(max_abs_err(q.headroom, pq.headroom))
        err = max(errs)
        check(err == 0, f"K4 equals its plain version ({case})")
        got = a.cpu().numpy()[:int(pods.valid.sum())]
        if case == "leaf_pairs":
            check(bool((got[0::3] >= 0).all() and (got[1::3] == -1).all()
                       and (got[2::3] >= 0).all()),
                  "each leaf admitted its first and third pods only")
        elif case == "ties":
            check(bool(np.all(np.diff(got) > 0)) and got[0] == 0,
                  "tied nodes taken lowest first")
        elif case == "window":
            check(bool((got[:6] >= 0).all() and (got[6:300] == -1).all()
                       and (got[300:] >= 0).any()),
                  "pods 1-5 admitted after the negative request's charge, "
                  "behind the moved window")
        else:
            check(bool((got >= 0).all()),
                  "qb's pods admitted once the parent's headroom wrapped")
        cases.append(dict(case=case, pods=len(got), nodes=state.capacity,
                          assigned=int((got >= 0).sum()), max_abs_err=err))
    emit("step_edges", cases=cases)


def phase_reservation_edges(device) -> None:
    """K4r against its plain version at small sizes on the card: every
    reservation on one node (more records than a warp, which the thread
    scoring that node tests one by one), records past the shared-memory
    budget (read in place from the wrapper's array), mostly exhausted
    rows, the quota tree with non-preemptible pods, 32,768 nodes (the node
    columns in the global scratch, the records staged), and the step's
    edges (step_edge_problem): quota leaves whose consecutive pods fit one
    at a time, and tied nodes whose chosen records are allocate-once,
    Restricted and Aligned."""
    import torch

    from koordinator_tpu_torch.kernels.greedy_scan import (
        reservation_scan_kernel,
    )

    cases = []
    for k, (label, n_nodes, n_pods, n_rows, mode, opt) in enumerate(
            RSV_EDGES):
        rng = np.random.default_rng(300 + k)
        state, pods = random_problem(300 + k, n_nodes, n_pods, device, mode)
        # crowd the nodes so the reservations matter
        state = state.replace(
            node_requested=(state.node_allocatable.to(torch.float64)
                            * 0.6).to(torch.int32))
        rsv = random_reservations(rng, state, n_rows, opt.get("on_nodes"),
                                  opt.get("exhausted", 0.15))
        match = torch.from_numpy(
            rng.random((pods.capacity, rsv.capacity)) < 0.3).to(device)
        quota = None
        if opt.get("quota"):
            quota, pods = quota_setup(pods, device, 300 + k)
        out = rsv_case(device, state, pods, scoring_config("default", device),
                       rsv, match, quota, reps=2, with_bound=False)
        check(out["through_reservation"] > 0,
              f"{label}: pods drew from reservations")
        cases.append(dict(case=label, **out))
    # the step's edges with reservations: the quota leaves' pairs, and
    # tied nodes whose records are allocate-once, Restricted or Aligned
    # in turn (rows on four nodes of four CTAs, every pod an owner)
    from koordinator_tpu_torch.ops.reservation import ReservationSet

    for k, case in enumerate(("leaf_pairs", "ties")):
        rng = np.random.default_rng(350 + k)
        state, pods, quota = step_edge_problem(device, case)
        n_rows = 48
        reserved = np.zeros((n_rows, R), np.int32)
        reserved[:, CPU] = rng.integers(1_000, 4_000, n_rows)
        reserved[:, MEM] = rng.integers(2_048, 8_192, n_rows)
        on = np.array([700, 3_000, 9_000, state.capacity - 1])
        rsv = ReservationSet.build(
            reserved, on[np.arange(n_rows) % 4].astype(np.int32),
            allocate_once=np.arange(n_rows) % 3 == 0,
            restricted=np.arange(n_rows) % 3 == 1, device=device)
        match = torch.from_numpy(
            rng.random((pods.capacity, rsv.capacity)) < (
                1.0 if case == "ties" else 0.3)).to(device)
        out = rsv_case(device, state, pods,
                       scoring_config("default", device), rsv, match, quota,
                       reps=2, with_bound=False)
        a, rc, _, _, _ = reservation_scan_kernel(
            state, pods, scoring_config("default", device), rsv, match,
            quota)
        chosen = rc.cpu().numpy()
        chosen = chosen[chosen >= 0]
        once = int(rsv.allocate_once.cpu().numpy()[chosen].sum())
        restricted = int(rsv.restricted.cpu().numpy()[chosen].sum())
        if case == "ties":
            check(once > 0 and restricted > 0,
                  "tied nodes: pods drew from allocate-once and Restricted "
                  "records")
        else:
            got = a.cpu().numpy()[:int(pods.valid.sum())]
            check(bool((got[1::3] == -1).all() and (got[0::3] >= 0).all()),
                  "K4r: each leaf admitted its first pod, not its second")
        cases.append(dict(case=f"step: {case}", **out,
                          through_allocate_once=once,
                          through_restricted=restricted))
    by = {c["case"]: c for c in cases}
    check(by["every reservation on one node"]["most_on_a_node"] >= 40,
          "a node holds more records than a warp")
    check(not by["records in the global array"]["records_staged"],
          "the 4,096 records on one CTA stay in the global array")
    check(by["every reservation on one node"]["records_staged"],
          "64 records are staged in shared memory")
    check(not by["node columns in the global scratch"]["nodes_in_smem"],
          "32,768 nodes take the global scratch")
    emit("reservation_edges", cases=cases)


# -- the wide key regime and many node classes --------------------------------

#: node counts of the wide-regime edges: the packed regime's last capacity,
#: a wide one that 2**32 is not a multiple of (two nodes can share a
#: tie-break there), and the wide regime's power of two
WIDE_EDGE_NODES = (32_768, 40_960, 65_536)
#: selector widths of the class edges: a word and a bit, two words, sixteen
CLASS_EDGE_COUNTS = (65, 128, 1_024)


def to_dev(a, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def short_row_problem(seed: int, n_nodes: int, n_pods: int, device):
    """random_problem's selector classes at ``n_nodes`` (0, 3 and 4 on most
    nodes): class 1 on five nodes and class 2 on twelve, and pods that
    select only class 1 (rows
    of at most five feasible nodes), only class 2, no class, or a random
    mix; half the pods at rot ids whose tie-break wraps."""
    state, pods = random_problem(seed, n_nodes, n_pods, device, "classes")
    rng = np.random.default_rng(seed)
    cls = rng.choice(np.array([0, 3, 4], np.int32), n_nodes)
    cls[rng.choice(n_nodes, 5, replace=False)] = 1
    cls[rng.choice(np.flatnonzero(cls != 1), 12, replace=False)] = 2
    p = pods.capacity
    sel = np.zeros((p, 8), bool)
    which = rng.integers(0, 4, p)
    sel[which == 0, 1] = True
    sel[which == 1, 2] = True
    sel[which == 3] = rng.random((int((which == 3).sum()), 8)) < 0.5
    rot = pods.rot_id.cpu().numpy().copy()
    rot[::2] = danger_rot_ids(rng, (p + 1) // 2, n_nodes)
    return (state.replace(node_class=to_dev(cls, device)),
            pods.replace(selector_mask=to_dev(sel, device),
                         rot_id=to_dev(rot, device)))


def shared_tie_break(n: int):
    """(rot id, a, b): a rot id whose tie-break difference wraps so that
    nodes a < b share one tie-break; None where 2**32 is a multiple of N
    (the tie-break is then a permutation)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _candidate_tb,
    )

    inv = pow(7919, -1, 2**32)
    rot = ((2**31 + n // 2) * inv) % 2**32
    rot = rot - 2**32 if rot >= 2**31 else rot
    tb = _candidate_tb(torch.arange(n, dtype=torch.int32)[None, :],
                       torch.tensor([rot], dtype=torch.int32), n)[0]
    dup = torch.nonzero(torch.bincount(tb.long(), minlength=n) == 2)
    if dup.numel() == 0:
        return None
    a, b = torch.nonzero(tb == int(dup[0])).flatten().tolist()
    return rot, a, b


def with_shared_pair(state, pods, pair, device):
    """(state, pods, pod row, a, b): ``pair`` (shared_tie_break's rot id
    and nodes a < b) given to the last valid pod, which admits only a
    class that a and b alone hold (class 5); a and b made identical,
    empty and as large as the largest node, so they tie on (key, tb) in
    both strata."""
    rot_id, a, b = pair
    i0 = int(pods.valid.nonzero()[-1])
    rot = pods.rot_id.clone()
    rot[i0] = rot_id
    sel = pods.selector_mask.clone()
    sel[i0] = False
    sel[i0, 5] = True
    fields = {f: getattr(state, f).clone() for f in (
        "node_allocatable", "node_requested", "node_usage", "node_agg_usage",
        "node_class")}
    for f in ("node_requested", "node_usage", "node_agg_usage"):
        fields[f][[a, b]] = 0
    fields["node_allocatable"][[a, b]] = fields["node_allocatable"].max(
        dim=0).values
    fields["node_class"][[a, b]] = 5
    return (state.replace(**fields),
            pods.replace(rot_id=rot, selector_mask=sel), i0, a, b)


def refresh_case(device, state, pods, cfg, cand, n_dirty: int, d: int,
                 seed: int, extra_rows=()) -> dict:
    """K2 against its plain version on one dirty list: ``n_dirty`` nodes
    (``extra_rows`` among them) with fresh usage, padded to ``d`` entries
    on row 0, over the cache ``cand`` (K1's (key, node, score))."""
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_kernel,
        refresh_candidates_plain,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba

    n, p = state.capacity, pods.capacity
    rng = np.random.default_rng(seed)
    rows = [int(r) for r in extra_rows]
    rows += [int(r) for r in rng.choice(n, n_dirty, replace=False)
             if int(r) not in rows]
    rows = np.array(rows[:n_dirty], np.int32)
    usage = state.node_usage.cpu().numpy().copy()
    alloc = state.node_allocatable.cpu().numpy()
    usage[rows] = (alloc[rows] * rng.random((n_dirty, R)) * 0.5).astype(
        np.int32)
    st = state.replace(node_usage=to_dev(usage, device))
    drows = np.zeros(d, np.int32)
    drows[:n_dirty] = rows
    dvalid = np.arange(d) < n_dirty
    dirty = np.zeros(n, bool)
    dirty[rows] = True
    aligned, touch = ba.align_candidate_cache(
        ba.CandidateCache(*cand),
        torch.arange(p, dtype=torch.int32, device=device), pods.valid,
        to_dev(dirty, device))
    args = (st, pods, cfg, aligned.cand_node, aligned.cand_score,
            to_dev(drows, device), to_dev(dvalid, device), 32, (5, 15))
    got = refresh_candidates_kernel(*args)
    want = refresh_candidates_plain(*args)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(err == 0, f"K2 equals its plain version ({n} nodes, D = {d})")
    # -1 slots that hold a dirty column (the wide merge ranks -1 entries
    # by tie-break, so fresh infeasible columns can win them)
    node, key = got[1], got[0]
    fresh_minus_one = int(((key < 0) & to_dev(dirty, device)[node.long()])
                          .sum())
    return dict(dirty_nodes=n_dirty, dirty_columns=d, max_abs_err=err,
                touched_pods=int(touch.sum()),
                minus_one_slots=int((key < 0).sum()),
                minus_one_on_dirty_nodes=fresh_minus_one)


def shared_rank_rows(key, node, rot_id, n: int, valid) -> int:
    """Rows of valid pods where two valid slots of one stratum hold one
    (key, tie-break) pair: two nodes that share a wrapped tie-break."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _candidate_tb,
        wide_rank,
    )

    tb = _candidate_tb(node, rot_id, n)
    rank = torch.where(key >= 0, wide_rank(key, tb),
                       -1 - torch.arange(key.shape[1], device=key.device))
    hit = torch.zeros_like(valid)
    for lo, hi in ((0, 16), (16, 32)):
        srt = torch.sort(rank[:, lo:hi], dim=1).values
        hit |= ((srt.diff(dim=1) == 0) & (srt[:, 1:] >= 0)).any(dim=1)
    return int((hit & valid).sum())


def phase_wide_edges(device, n_pods: int = 2_048) -> None:
    """K1, K2 and K3a (with K3b) against their plain versions at 32,768
    nodes (the packed regime's last capacity), 40,960 and 65,536 (the wide
    regime), on short_row_problem: rows with 0 to 5 and 12 feasible nodes
    (so the -1 slots' order shows: lowest infeasible column first when
    packed, tie-break descending when wide) and wrapping rot ids (at
    40,960 two nodes can share a tie-break).  K3a and K3b on every round
    of a solve behind the quota tree; K2 over 5 dirty nodes of D = 8
    (shorter than a stratum's 16) and 100 of D = 128, padded on row 0,
    one of them a node the cache holds."""
    from koordinator_tpu_torch.kernels.select_candidates import (
        _packed_regime,
        select_candidates_kernel,
        select_candidates_plain,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba

    cfg = scoring_config("default", device)
    cases = []
    for i, n in enumerate(WIDE_EDGE_NODES):
        state, pods = short_row_problem(500 + i, n, n_pods, device)
        pair = shared_tie_break(n)
        if pair is not None:
            # one pod whose rotation makes nodes a < b share a tie-break
            # and that only they admit: the kernel must put b first
            state, pods, i0, a_, b_ = with_shared_pair(state, pods, pair,
                                                       device)
        got = select_candidates_kernel(state, pods, cfg, 32)
        want = select_candidates_plain(state, pods, cfg, 32, chunk=512)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        check(err == 0, f"K1 equals its plain version ({n} nodes)")
        key, node = got[0], got[1]
        short = int((((key >= 0).sum(dim=1) < 32) & pods.valid).sum())
        shared = shared_rank_rows(key, node, pods.rot_id, n, pods.valid)
        quota, qpods = quota_setup(pods, device, 500 + i)
        stats = {"k3a_calls": 0, "k3b_calls": 0, "k3b_accepted": 0}
        with checked_rounds(stats):
            a, _, _ = ba.batch_assign(state, qpods, cfg, quota)
        check(stats["k3a_calls"] > 0 and int((a >= 0).sum()) > 0,
              f"the solve ran its rounds ({n} nodes)")
        holder = int(node[int(pods.valid.nonzero()[-1]), 0])
        k2 = [refresh_case(device, state, pods, cfg, got, nd, d, 510 + i,
                           (holder,)) for nd, d in ((5, 8), (100, 128))]
        if pair is not None:
            check([int(x) for x in node[i0, 0:2]] == [b_, a_]
                  and [int(x) for x in node[i0, 16:18]] == [b_, a_],
                  f"a shared (key, tie-break) higher column first "
                  f"({n} nodes)")
        cases.append(dict(
            nodes=n, regime="packed" if _packed_regime(n) else "wide",
            pods=pods.capacity, k1_max_abs_err=err, rows_short_of_k=short,
            rows_with_shared_pairs=shared,
            shared_pair=None if pair is None else [a_, b_],
            k3a_rounds=stats["k3a_calls"],
            k3b_rounds=stats["k3b_calls"], assigned=int((a >= 0).sum()),
            k2=k2))
    for c in cases:
        check(c["rows_short_of_k"] > 0,
              f"rows shorter than k at {c['nodes']} nodes")
    check(cases[1]["shared_pair"] is not None
          and cases[1]["rows_with_shared_pairs"] > 0,
          "rows where two nodes share a (key, tie-break) at 40,960 nodes")
    emit("wide_edges", cases=cases)


def class_problem(seed: int, n_nodes: int, n_pods: int, c: int, device):
    """random_problem's nodes and pods with ``c`` selector classes: node
    classes uniform over c and an eighth more past the mask's width
    (infeasible for every pod), each class admitted with probability 1/2,
    every fourth pod admitting only classes 64 and up (its words past the
    first)."""
    state, pods = random_problem(seed, n_nodes, n_pods, device, "plain")
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c + c // 8, n_nodes).astype(np.int32)
    sel = rng.random((pods.capacity, c)) < 0.5
    sel[::4, :64] = False
    return (state.replace(node_class=to_dev(cls, device)),
            pods.replace(selector_mask=to_dev(sel, device)))


def phase_class_edges(device, n_nodes: int = 4_096, n_pods: int = 2_048,
                      scan_pods: int = 300) -> None:
    """K1, K2, K4 and K4r against their plain versions at 65, 128 and
    1,024 node classes (2, 2 and 16 selector words a pod): K1 and K2 at
    2,048 pods x 4,096 nodes, K4 behind the quota tree and K4r over 128
    reservations at 300 of the pods."""
    import torch

    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_kernel
    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        select_candidates_kernel,
        select_candidates_plain,
    )
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    cfg = scoring_config("default", device)
    cases = []
    for i, c in enumerate(CLASS_EDGE_COUNTS):
        state, pods = class_problem(600 + i, n_nodes, n_pods, c, device)
        got = select_candidates_kernel(state, pods, cfg, 32)
        want = select_candidates_plain(state, pods, cfg, 32)
        k1_err = max(max_abs_err(g, w) for g, w in zip(got, want))
        check(k1_err == 0, f"K1 equals its plain version (C = {c})")
        k2 = refresh_case(device, state, pods, cfg, got, 100, 128, 610 + i)
        small = _pod_rows(pods, 0, scan_pods)
        quota, qsmall = quota_setup(small, device, 620 + i)
        a, st, q = greedy_scan_kernel(state, qsmall, cfg, quota)
        pa, pst, pq = greedy_assign_plain(state, qsmall, cfg, quota)
        k4_err = max(max_abs_err(a, pa),
                     max_abs_err(st.node_requested, pst.node_requested),
                     max_abs_err(q.headroom, pq.headroom),
                     max_abs_err(q.min_headroom, pq.min_headroom))
        check(k4_err == 0, f"K4 equals its plain version (C = {c})")
        check(int((a >= 0).sum()) > 0, f"K4 placed pods (C = {c})")
        rng = np.random.default_rng(630 + i)
        crowded = state.replace(node_requested=(
            state.node_allocatable.to(torch.float64) * 0.6).to(torch.int32))
        rsv = random_reservations(rng, crowded, 128)
        match = to_dev(rng.random((small.capacity, rsv.capacity)) < 0.3,
                       device)
        k4r = rsv_case(device, crowded, small, cfg, rsv, match, reps=1,
                       with_bound=False)
        check(k4r["through_reservation"] > 0,
              f"K4r: pods drew from reservations (C = {c})")
        cases.append(dict(classes=c, words=(c + 63) // 64,
                          k1_max_abs_err=k1_err,
                          k1_valid_slots=int((got[0] >= 0).sum()), k2=k2,
                          k4_max_abs_err=k4_err,
                          k4_assigned=int((a >= 0).sum()),
                          k4r_max_abs_err=k4r["max_abs_err"],
                          k4r_through_reservation=k4r["through_reservation"]))
    emit("class_edges", nodes=n_nodes, pods=n_pods, scan_pods=scan_pods,
         cases=cases)


# -- phase 12: a GKE-scale cluster ---------------------------------------------

#: phase 12's cluster: GKE's documented ceiling of 65,000 nodes (Google
#: Cloud, "GKE 65,000-node clusters", 2024), the snapshot's capacity the
#: next power of two (65,536: the wide key regime)
GKE_NODES = 65_000
GKE_ZONES, GKE_TYPES = 16, 16
ZONE_LABEL = "topology.kubernetes.io/zone"
TYPE_LABEL = "node.kubernetes.io/instance-type"
GKE_TAINT = {"dedicated": "batch"}
GKE_RESERVATIONS, GKE_OWNERS = 256, 1_000
#: phase 12's comparisons of K1 and K2 with their plain versions, and its
#: operation counts, run over every row in chunks of this many pods (the
#: plain Filter + Score holds a few (chunk, N, R) tensors: 2.7 GB each at
#: N = 65,536)
GKE_PLAIN_CHUNK = 1_024
#: phase 12's K4 edge without the quota state: the first rows of a rescue
#: batch, every one scanned over the 65,536 nodes
GKE_K4_ROWS = 1_024
#: the K2 edge past the earlier wide design's 46-bit list value: 2^26 node
#: rows (a 26-bit tie-break) and 2^20 + 32 dirty columns (21 bits)
K2_LONG_NODES = 2**26
K2_LONG_DIRTY = 2**20 + 32


def gke_pod(rng, spec):
    """``spec`` with the phase's selectors: a zone for 25% of the pods, an
    instance type for 10%, the dedicated=batch toleration for 10%."""
    import dataclasses

    sel = {}
    if rng.random() < 0.25:
        sel[ZONE_LABEL] = f"zone-{rng.integers(0, GKE_ZONES)}"
    if rng.random() < 0.10:
        sel[TYPE_LABEL] = f"type-{rng.integers(0, GKE_TYPES)}"
    tol = dict(GKE_TAINT) if rng.random() < 0.10 else {}
    return dataclasses.replace(spec, node_selector=sel, tolerations=tol)


def gke_specs(seed: int = 4, n_nodes: int = GKE_NODES, n_pods: int = 50_000):
    """The flagship's node widths and usage and its 50,000-pod backlog
    behind phase 9's 16-leaf quota tree (steady_specs), the nodes labelled
    with 16 zones x 16 instance types and 1/8 of them tainted
    dedicated=batch (up to 512 classes), the pods with gke_pod's
    selectors."""
    import dataclasses

    nodes, pods, leaf_max = steady_specs(seed, n_nodes, n_pods)
    rng = np.random.default_rng(seed + 200)
    zone = rng.integers(0, GKE_ZONES, n_nodes)
    kind = rng.integers(0, GKE_TYPES, n_nodes)
    tainted = rng.random(n_nodes) < 1 / 8
    nodes = [dataclasses.replace(
        spec, labels={ZONE_LABEL: f"zone-{zone[i]}",
                      TYPE_LABEL: f"type-{kind[i]}"},
        taints=dict(GKE_TAINT) if tainted[i] else {})
        for i, spec in enumerate(nodes)]
    return nodes, [gke_pod(rng, p) for p in pods], leaf_max


@contextlib.contextmanager
def refresh_probe(log: list):
    """Keep the arguments of every K2 call the scheduler makes."""
    from koordinator_tpu_torch.ops import batch_assign as ba

    real = ba.refresh_candidates_kernel

    def probe(*args):
        log.append(args)
        return real(*args)

    ba.refresh_candidates_kernel = probe
    try:
        yield
    finally:
        ba.refresh_candidates_kernel = real


def gke_k1(device, solve: dict, reps: int = 3) -> dict:
    """K1 at phase 12's cold solve: kernel against plain version over every
    row, GKE_PLAIN_CHUNK rows at a time; times, bound (batch_ops), and
    torch.topk over the wide composite key (key << 30 | tb) of each
    GKE_PLAIN_CHUNK-row chunk, summed over the batch (a (P, N) int64 key
    would take 34 GB)."""
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        _rank_parts,
        wide_rank,
    )
    from koordinator_tpu_torch.ops.assignment import score_pods

    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    p, n, k = pods.capacity, state.capacity, 32
    k1 = held_k1(device, state, pods, cfg, "exact", reps=reps,
                 chunk=GKE_PLAIN_CHUNK, where="at phase 12's shape")
    topk_ms = 0.0
    for i in range(0, p, GKE_PLAIN_CHUNK):
        sub = _pod_rows(pods, i, min(i + GKE_PLAIN_CHUNK, p))
        scores, feas = score_pods(state, sub, cfg)
        key, tb = _rank_parts(scores, feas, 5, sub.rot_id, n_total=n)
        rank = wide_rank(key, tb)
        del scores, feas, key, tb
        topk_ms += timed_ms(lambda: torch.topk(rank, k // 2, dim=1), device,
                            reps=reps)
        del rank
    return dict(pods=p, valid_pods=int(pods.valid.sum()), nodes=n,
                classes=pods.selector_mask.shape[1],
                max_abs_err=k1["max_abs_err"], ms=k1["ms"],
                plain_ms=k1["plain_ms"], library_ms=topk_ms,
                **k1_bound(state, pods, cfg, k, chunk=GKE_PLAIN_CHUNK),
                valid_slots=int((k1["out"][0] >= 0).sum()))


def gke_k3a(device, solve: dict, reps: int = 10) -> dict:
    """K3a on the first round of phase 12's cold solve (the wide regime's
    two-stage choice), against its plain version, timed, its bound the
    bytes it reads."""
    import torch

    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
        round_fit_choose_plain,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )

    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    key, node, _ = select_candidates_kernel(state, pods, cfg, 32)
    free = torch.where(state.node_valid[:, None],
                       state.node_allocatable - state.node_requested, 0)
    active = pods.valid & torch.any(key >= 0, dim=1)
    args = (key, node, free, pods.requests, active, pods.rot_id)
    got = round_fit_choose(*args)
    want = round_fit_choose_plain(*args)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(err == 0, "K3a equals its plain version at phase 12's shape")
    p, k = key.shape
    n_active = int(active.sum())
    nbytes = n_active * (k * (4 + 4 + R * 4) + R * 4 + 4) + p * (1 + 4 + 1)
    return dict(pods=p, active=n_active, max_abs_err=err,
                ms=timed_ms(lambda: round_fit_choose(*args), device,
                            reps=reps),
                plain_ms=timed_ms(lambda: round_fit_choose_plain(*args),
                                  device, reps=3),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


def gke_k2(device, args: tuple, reps: int = 10) -> dict:
    """K2 on the arguments of phase 12's first steady refresh: kernel
    against plain version (the plain merge over every row, the (P, D)
    scores in GKE_PLAIN_CHUNK-row chunks), wrapper and bare launch timed,
    the bound over the real dirty columns."""
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        prepare_refresh,
        refresh_candidates_kernel,
        refresh_candidates_plain,
    )
    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows

    state, pods, cfg, cand_node, cand_score, drows, dvalid, k, strata = args
    got = refresh_candidates_kernel(*args)
    p, n = pods.capacity, state.capacity
    err = 0
    sync(device)
    t0 = time.perf_counter()
    for i in range(0, p, GKE_PLAIN_CHUNK):
        j = min(i + GKE_PLAIN_CHUNK, p)
        want = refresh_candidates_plain(
            state, _pod_rows(pods, i, j), cfg, cand_node[i:j],
            cand_score[i:j], drows, dvalid, k, strata)
        err = max([err] + [max_abs_err(g[i:j], w)
                           for g, w in zip(got, want)])
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(err == 0, "K2 equals its plain version at phase 12's shape")
    launch, outs = prepare_refresh(*args)
    launch()
    check(max(max_abs_err(g, w) for g, w in zip(outs, got)) == 0,
          "K2's bare launch equals the wrapper's")
    n_dirty = int(dvalid.sum())
    real = drows[dvalid].long()
    c = pods.selector_mask.shape[1]
    nbytes = (p * k * (2 * 4 + 3 * 4) + p * (2 * R * 4 + 1 + 4)
              + p * ((c + 63) // 64) * 8
              + n_dirty * (4 * R * 4 + 1 + 4 + 4 + 1) + n)
    ops = batch_ops(state, pods, cfg, real, chunk=GKE_PLAIN_CHUNK)
    bound_ms, by = bound(nbytes, ops)
    return dict(pods=p, valid_pods=int(pods.valid.sum()), nodes=n,
                dirty_nodes=n_dirty, dirty_columns=int(drows.shape[0]),
                max_abs_err=err,
                ms=timed_ms(lambda: refresh_candidates_kernel(*args), device,
                            reps=reps),
                device_ms=timed_ms(launch, device, reps=reps),
                plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=bound_ms,
                bound_by=by, library_ms=None)


def gke_k4(device, solve: dict, reps: int = 3) -> dict:
    """K4 on a phase 12 rescue batch against its plain version, with its
    bound: the whole batch with its quota state, as the steady round gave
    it (65,536 nodes, 8 selector words a pod; quota rejects most of these
    pods); and, as an edge, its first GKE_K4_ROWS rows without the quota
    state (``unquoted``: every pod scanned over the 65,536 nodes)."""
    from koordinator_tpu_torch.kernels.greedy_scan import greedy_scan_kernel
    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows
    from koordinator_tpu_torch.ops.assignment import greedy_assign_plain

    state, cfg = solve["state"], solve["cfg"]
    out = {}
    for label, pods, quota in (
            ("rescue", solve["batch"], solve["quota"]),
            ("unquoted", _pod_rows(solve["batch"], 0, GKE_K4_ROWS), None)):
        a, st, q = greedy_scan_kernel(state, pods, cfg, quota)
        sync(device)
        t0 = time.perf_counter()
        pa, pst, pq = greedy_assign_plain(state, pods, cfg, quota)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [max_abs_err(a, pa),
                max_abs_err(st.node_requested, pst.node_requested)]
        if quota is not None:
            errs += [max_abs_err(getattr(q, f), getattr(pq, f))
                     for f in ("headroom", "min_headroom", "checked",
                               "chain", "valid")]
        err = max(errs)
        check(err == 0, f"K4 equals its plain version at phase 12's shape "
              f"({label})")
        n, p = state.capacity, pods.capacity
        rows = scan_rows(pods, quota, a)
        c = pods.selector_mask.shape[1]
        nbytes = (n * (4 * R * 4 + 1 + 4) + n * R * 4
                  + p * (2 * R * 4 + 1 + 4 + 4 + 1 + ((c + 63) // 64) * 8)
                  + (0 if quota is None
                     else 2 * quota.headroom.numel() * 4 * 2))
        ops = scan_ops(state, pods, cfg, rows, a)
        bound_ms, by = bound(nbytes, ops)
        out[label] = dict(
            pods=p, valid_pods=int(pods.valid.sum()), nodes=n,
            admitted_steps=len(rows), assigned=int((a >= 0).sum()),
            max_abs_err=err,
            ms=timed_ms(lambda: greedy_scan_kernel(state, pods, cfg, quota),
                        device, reps=reps),
            plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=bound_ms,
            bound_by=by, library_ms=None)
    check(out["unquoted"]["assigned"] > 0, "K4 placed pods at 65,536 nodes")
    return dict(out["rescue"], unquoted=out["unquoted"])


def phase_k2_long_list(device, n: int = K2_LONG_NODES,
                       d: int = K2_LONG_DIRTY, p: int = 8) -> None:
    """K2 against its plain version on a dirty list that the earlier wide
    design refused: its 64-bit list value held the tie-break (26 bits at
    2^26 node rows) and the dirty column (21 bits at 2^20 + 32 columns)
    in 46 bits.  2^20 distinct dirty nodes, 16 of them listed twice and
    16 padded entries on row 0; a cache of random nodes (a quarter of the
    slots on dirty nodes, a fifth invalid) for ``p`` pods, one of them at
    a rot id whose tie-break difference wraps.  The node table is made
    on the card."""
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_kernel,
        refresh_candidates_plain,
    )
    from koordinator_tpu_torch.state.cluster_state import (
        ClusterState,
        PodBatch,
    )

    g = torch.Generator(device=device)
    g.manual_seed(77)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    def part(f):
        return (alloc * (torch.rand((n, R), generator=g, device=device)
                         * f)).to(torch.int32)

    alloc = torch.zeros((n, R), dtype=torch.int32, device=device)
    alloc[:, CPU] = ints(8_000, 64_000, (n,))
    alloc[:, MEM] = ints(16_384, 262_144, (n,))
    state = ClusterState(
        node_allocatable=alloc, node_requested=part(0.4),
        node_usage=part(0.6), node_agg_usage=part(0.7),
        node_prod_usage=torch.zeros_like(alloc),
        node_valid=torch.rand(n, generator=g, device=device) < 0.98,
        node_class=ints(0, 8, (n,)))
    rng = np.random.default_rng(77)
    req = np.zeros((p, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, p)
    req[:, MEM] = rng.integers(128, 8_192, p)
    rot = rng.integers(0, 2**31 - 1, p).astype(np.int32)
    rot[0] = danger_rot_ids(rng, 1, n)[0]
    pods = PodBatch.build(req, priority=np.full(p, 5_000, np.int32),
                          rot_id=rot, node_capacity=n, capacity=p,
                          device=device,
                          selector_mask=rng.random((p, 8)) < 0.7,
                          class_capacity=8)
    n_dirty = d - 32
    listed = torch.randperm(n, generator=g, device=device)[:n_dirty].to(
        torch.int32)
    zeros = torch.zeros(16, dtype=torch.int32, device=device)
    drows = torch.cat([listed, listed[:16], zeros])
    dvalid = torch.arange(d, device=device) < d - 16
    shape = (pods.capacity, 32)
    cand_node = ints(0, n, shape)
    stale = torch.rand(shape, generator=g, device=device) < 0.25
    cand_node = torch.where(stale, listed[ints(0, n_dirty, shape).long()],
                            cand_node)
    cand_score = torch.where(
        torch.rand(shape, generator=g, device=device) < 0.2, -1,
        ints(0, 300, shape))
    cfg = scoring_config("default", device)
    args = (state, pods, cfg, cand_node, cand_score, drows, dvalid, 32,
            (5, 15))
    got = refresh_candidates_kernel(*args)
    sync(device)
    t0 = time.perf_counter()
    want = refresh_candidates_plain(*args)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    check(err == 0, f"K2 equals its plain version ({n} nodes, D = {d})")
    fresh = int((torch.isin(got[1], listed) & (got[0] >= 0)
                 & pods.valid[:, None]).sum())
    check(fresh > 0, "fresh dirty columns won slots on the long list")
    emit("k2_long_list", nodes=n, dirty_columns=d, pods=p,
         tie_break_bits=(n - 1).bit_length(),
         column_bits=(d - 1).bit_length(), max_abs_err=err,
         fresh_slots=fresh, minus_one_slots=int((got[0] < 0).sum()),
         ms=timed_ms(lambda: refresh_candidates_kernel(*args), device,
                     reps=2),
         plain_ms=plain_ms)


def phase_gke(device, n_nodes: int = GKE_NODES, n_pods: int = 50_000,
              steady_rounds: int = 2, n_arrivals: int = 500,
              n_rsv: int = GKE_RESERVATIONS, n_owners: int = GKE_OWNERS):
    """Phase 12: the port's Scheduler on a GKE-scale cluster (GKE_NODES
    nodes at capacity 65,536, the wide key regime; up to 512 label/taint
    classes, 8 selector words a pod) with the flagship's backlog behind
    phase 9's quota tree.  A cold round, ``steady_rounds`` rounds under
    the forced threshold each after a usage refresh of 1% of the nodes and
    ``n_arrivals`` arrivals (K2, K1, K3a, K3b and the K4 rescue), then
    ``n_rsv`` reservations pinned to named nodes and ``n_owners`` owner
    pods (K4r's pre-pass).  The launch counts are set to 0 before each
    round and read after it.  After every round: phase 11's accounting
    checks (no overcommit, allocated within reserved, pre-pass binds on
    their reservation's node, the node accounting equal to the bound pods
    and reservations) and phase 9's (each leaf's cpu used within its max).
    Every kernel is held against its plain version at the phase's shapes
    (gke_k1, gke_k3a, phase_quota_rounds, gke_k2, gke_k4, rsv_case; K7 on
    the last steady round's failed rows), and every round's Diagnose
    against the plain path (checked_diagnose).  Returns the kernels'
    numbers by name and the launches by round."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot
    from koordinator_tpu_torch.state.cluster_state import _bucket

    t_start = time.perf_counter()
    nodes, pods, leaf_max = gke_specs(4, n_nodes, n_pods)
    snap = ClusterSnapshot(capacity=_bucket(n_nodes), device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    sched = Scheduler(snap, quota_tree=steady_tree(nodes, leaf_max),
                      device=device, clock=lambda: now[0])
    sched.incremental_dirty_threshold = 1.0
    sched.enqueue_many(pods)
    setup_s = time.perf_counter() - t_start
    rng = np.random.default_rng(41)
    numbers, records, solves, refreshes, dlog = {}, [], {}, [], []
    k7_call = None
    for rnd in range(2 + steady_rounds):
        if 0 < rnd <= steady_rounds:
            refreshed, new = steady_delta(rng, nodes, rnd, n_arrivals)
            for spec in refreshed:
                sched.snapshot.upsert_node(spec)
            sched.enqueue_many([gke_pod(rng, p) for p in new])
        if rnd == steady_rounds + 1:
            now[0] = 10.0
            for spec in reservation_specs(rng, nodes, n_rsv, n_rsv):
                sched.add_reservation(spec)
            sched.enqueue_many(owner_pods(rng, 0, n_owners))
        log, rlog, plog = [], [], []
        n_diag = len(dlog)
        build.reset_launch_counts()
        with solve_probe(log, device), refresh_probe(rlog), \
                prepass_probe(plog, device), checked_diagnose(dlog):
            sync(device)
            t0 = time.perf_counter()
            res = sched.schedule_round()
            sync(device)
            wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        diag = diagnose_fields(dlog[n_diag:])
        wall -= diag["diagnose_check_s"]
        check(launches["explain_counts"] == (1 if res.failures else 0),
              f"phase 12 round {rnd}: Diagnose launched K7")
        if rnd == steady_rounds:
            k7_call = dlog[-1]["call"]
        solves[rnd] = log
        refreshes += rlog
        rec = dict(round=rnd, path=sched.last_solve_path,
                   solver=sched.last_solver, pods=res.round_pods,
                   binds=len(res.assignments), failed=len(res.failures),
                   assigned_fraction=len(res.assignments)
                   / max(res.round_pods, 1), wall_s=wall,
                   solve_ms=[s["ms"] for s in log if s["solver"] == "batch"],
                   rescue_ms=[s["ms"] for s in log if s["solver"] == "greedy"],
                   prepass_ms=[s["ms"] for s in plog],
                   launches=launches, **diag)
        rec.update(reservation_checks(sched, res, f"phase 12 round {rnd}"))
        for qname, q in sched.quota_tree.nodes.items():
            if not sched.quota_tree.children[qname]:
                check(bool(q.used[CPU] <= q.max[CPU]),
                      f"phase 12 round {rnd}: {qname} within its max")
        records.append(rec)
        emit("gke_round", **rec)
        check(len(res.assignments) > 0, f"phase 12 round {rnd} bound pods")
        if rnd == 0:
            check(rec["path"] == "full_cold", "phase 12 starts cold")
            for kname in ("select_candidates", "round_fit_choose",
                          "segmented_prefix_accept"):
                check(launches[kname] > 0,
                      f"{kname} launched on phase 12's cold round")
        elif rnd <= steady_rounds:
            check(rec["path"] == "incremental",
                  f"phase 12 round {rnd} took the incremental path")
            for kname in ("refresh_candidates", "select_candidates",
                          "round_fit_choose", "segmented_prefix_accept",
                          "greedy_scan"):
                check(launches[kname] > 0,
                      f"{kname} launched on phase 12 round {rnd}")
        else:
            check(launches["reservation_scan"] > 0 and len(plog) == 1,
                  "the pre-pass ran on K4r in phase 12")
            check(rec["through_reservation"] > 0,
                  "owner pods drew from reservations in phase 12")
    check(snap.capacity == _bucket(n_nodes), "phase 12's capacity")
    check(n_nodes != GKE_NODES or (snap.capacity == 65_536
                                   and snap.class_capacity == 512),
          "phase 12 ran at capacity 65,536 with 512 selector classes")
    cold = next(s for s in solves[0] if s["solver"] == "batch")
    numbers["select_candidates"] = gke_k1(device, cold)
    numbers["round_fit_choose"] = gke_k3a(device, cold)
    numbers["segmented_prefix_accept"] = phase_quota_rounds(
        device, cold, label="gke_quota_rounds")
    check(len(refreshes) > 0, "phase 12 refreshed the cache")
    numbers["refresh_candidates"] = gke_k2(device, refreshes[0])
    rescues = [s for r in range(1, steady_rounds + 1) for s in solves[r]
               if s["solver"] == "greedy"]
    check(len(rescues) > 0, "phase 12's steady rounds rescued")
    numbers["greedy_scan"] = gke_k4(device, rescues[-1])
    s = plog[0]
    k4r = rsv_case(device, s["state"], s["pods"], s["cfg"], s["rsv"],
                   s["match"], s["quota"])
    k4r["in_round_ms"] = s["ms"]
    numbers["reservation_scan"] = k4r
    check(k7_call is not None, "phase 12's last steady round ran K7")
    numbers["explain_counts"] = held_k7(
        device, k7_call, "at phase 12's last steady round")
    for name, out in numbers.items():
        emit("gke_kernel", name=name, **{
            key: val for key, val in out.items()
            if not isinstance(val, list)})
    emit("gke", nodes=n_nodes, capacity=snap.capacity,
         classes=snap.class_count, class_capacity=snap.class_capacity,
         backlog=n_pods, setup_s=setup_s,
         seconds=time.perf_counter() - t_start,
         rounds=[{key: r[key] for key in (
             "round", "path", "pods", "binds", "assigned_fraction", "wall_s",
             "solve_ms", "rescue_ms", "prepass_ms", "diagnose_ms",
             "diagnose_parts_ms", "k7_rows")} for r in records])
    return numbers, [r["launches"] for r in records]


# -- phase 13: gangs ---------------------------------------------------------

#: BASELINE.json's "Gang/Coscheduling all-or-nothing assignment ... 10k
#: pods": 512 PodGroups of 8-32 members holding 10,000 of the backlog's pods
N_GANG_PODS = 10_000
N_GANGS = 512
N_GROUPED = 64           # gangs in gang groups of 2-4
N_INCOMPLETE = 16        # PodGroups whose min_member exceeds their members
N_NEW_GANGS = 32         # PodGroups arriving at t = 300 s
GANG_TIMES = (0.0, 300.0, 601.0)


def gang_sizes(rng, count: int, total: int) -> np.ndarray:
    """``count`` gang sizes in 8..32 summing to ``total``."""
    sizes = rng.integers(8, 33, count)
    while sizes.sum() != total:
        i = int(rng.integers(0, count))
        if sizes.sum() > total and sizes[i] > 8:
            sizes[i] -= 1
        elif sizes.sum() < total and sizes[i] < 32:
            sizes[i] += 1
    return sizes


def gang_specs(seed: int = 6, n_nodes: int = 10_240, n_pods: int = 50_000,
               n_gang_pods: int = N_GANG_PODS, n_gangs: int = N_GANGS):
    """Phase 9's nodes, backlog and quota tree with ``n_gang_pods`` of the
    pods in ``n_gangs`` PodGroups of 8-32 members (a group's members take
    its first member's priority).  min_member is the group's size for 3/4
    of them and size - 2 for 1/4; N_INCOMPLETE declare more than their
    members (a job not yet fully submitted); N_GROUPED complete ones sit
    in gang groups of 2-4.  Returns (nodes, pods, leaf max, gangs as
    (name, min_member, group) tuples, each gang's member names)."""
    import dataclasses

    nodes, pods, leaf_max = steady_specs(3, n_nodes, n_pods)
    rng = np.random.default_rng(seed)
    sizes = gang_sizes(rng, n_gangs, n_gang_pods)
    members = rng.permutation(n_pods)[:n_gang_pods]
    incomplete = set(rng.choice(n_gangs, N_INCOMPLETE, replace=False)
                     .tolist())
    complete = [g for g in range(n_gangs) if g not in incomplete]
    grouped = rng.choice(complete, N_GROUPED, replace=False).tolist()
    group_of, at, gid = {}, 0, 0
    while at < len(grouped):
        size = min(int(rng.integers(2, 5)), len(grouped) - at)
        if len(grouped) - at - size == 1:   # no group of one is left
            size += -1 if size > 2 else 1
        for g in grouped[at:at + size]:
            group_of[g] = f"grp-{gid}"
        at, gid = at + size, gid + 1
    gangs, member_names, start = [], {}, 0
    for g, size in enumerate(sizes):
        name = f"pg-{g}"
        rows = members[start:start + size]
        start += size
        prio = pods[rows[0]].priority
        for j in rows:
            pods[j] = dataclasses.replace(pods[j], gang=name, priority=prio)
        if g in incomplete:
            mm = int(size) + int(rng.integers(1, 5))
        elif rng.random() < 0.25:
            mm = int(size) - 2
        else:
            mm = int(size)
        gangs.append((name, mm, group_of.get(g)))
        member_names[name] = [pods[j].name for j in rows]
    return nodes, pods, leaf_max, gangs, member_names, incomplete


def new_gang_pods(rng, count: int):
    """``count`` PodGroups arriving later, 8-32 members each, min_member
    their size; returns (gangs, pods)."""
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    gangs, out = [], []
    for g in range(count):
        size = int(rng.integers(8, 33))
        name = f"pg-new-{g}"
        prio = int(rng.integers(3000, 9999))
        q = (None if rng.random() < 0.2
             else f"leaf-{rng.integers(0, N_LEAVES)}")
        for j in range(size):
            req = np.zeros(R, np.int32)
            req[CPU] = rng.integers(100, 4_000)
            req[MEM] = rng.integers(128, 8_192)
            out.append(PodSpec(name=f"{name}-{j}", requests=req,
                               priority=prio, quota=q, gang=name,
                               creation=1e6 + len(out)))
        gangs.append((name, size, None))
    return gangs, out


def gang_checks(sched, label: str) -> dict:
    """Every gang and every gang group all-or-nothing over the pods bound
    so far (a gang has no member bound or at least min_member), no node
    over its allocatable, the node accounting equal to the bound pods'
    requests, and each leaf's cpu used within its max."""
    st = sched.snapshot.state
    requested = st.node_requested.cpu().numpy().astype(np.int64)
    alloc = st.node_allocatable.cpu().numpy().astype(np.int64)
    check(bool((requested <= alloc).all()), f"{label}: no overcommit")
    expect = np.zeros_like(requested)
    bound: dict[str, int] = {}
    for bp in sched.bound.values():
        expect[sched.snapshot.node_index[bp.node]] += bp.requests
        if bp.pod.gang is not None:
            bound[bp.pod.gang] = bound.get(bp.pod.gang, 0) + 1
    check(np.array_equal(expect, requested),
          f"{label}: accounting = sum of bound pods")
    groups: dict[str, list[str]] = {}
    for name, rec in sched.gangs.items():
        got = bound.get(name, 0)
        check(got == 0 or got >= rec.min_member,
              f"{label}: gang {name} all-or-nothing ({got} of "
              f"{rec.min_member})")
        if rec.group:
            groups.setdefault(rec.group, []).append(name)
    for group, names in groups.items():
        if any(bound.get(g, 0) for g in names):
            check(all(bound.get(g, 0) >= sched.gangs[g].min_member
                      for g in names),
                  f"{label}: gang group {group} all-or-nothing")
    for qname, q in sched.quota_tree.nodes.items():
        if not sched.quota_tree.children[qname]:
            check(bool(q.used[CPU] <= q.max[CPU]),
                  f"{label}: {qname} within its max")
    return dict(gangs_placed=sum(1 for g in sched.gangs
                                 if bound.get(g, 0) > 0),
                gang_pods_bound=sum(bound.values()),
                groups_placed=sum(1 for names in groups.values()
                                  if bound.get(names[0], 0) > 0))


def phase_gangs(device, n_nodes: int = 10_240, n_pods: int = 50_000,
                n_arrivals: int = 500, n_gang_pods: int = N_GANG_PODS,
                n_gangs: int = N_GANGS):
    """Phase 13: Coscheduling gangs through the Scheduler.  The flagship
    cluster and backlog behind phase 9's quota tree with 10,000 pods in
    512 PodGroups (gang_specs), three rounds on a fake clock: t = 0; t =
    300 s with 500 gangless arrivals and 32 new PodGroups; t = 601 s,
    past the 600 s WaitTime of the 16 incomplete gangs, which are
    rejected then and whose pods PreEnqueue holds out of the next batch.
    Every round takes the full gang path (gang_assign's batch solver, the
    rescue on K4).  After every round gang_checks.  K1, K3a and K3b (every
    propose/accept round of round 1's solve) and K4 (round 1's whole
    rescue, with its quota state) are held against their plain versions
    on the inputs round 1's first passes launch them on: each batch with
    PreEnqueue's mask applied (gang_solve); every round's Diagnose runs K7
    and is checked against the plain path (checked_diagnose).  Returns
    (the round records, the held kernels' numbers by kernel name)."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.scheduler.scheduler import (
        GangRecord,
        Scheduler,
    )
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    t_start = time.perf_counter()
    nodes, pods, leaf_max, gangs, members, incomplete = gang_specs(
        6, n_nodes, n_pods, n_gang_pods, n_gangs)
    snap = ClusterSnapshot(capacity=n_nodes, device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    sched = Scheduler(snap, quota_tree=steady_tree(nodes, leaf_max),
                      device=device, clock=lambda: now[0])
    for name, mm, group in gangs:
        sched.register_gang(GangRecord(name=name, min_member=mm, group=group))
    sched.enqueue_many(pods)
    rng = np.random.default_rng(61)
    records, solves, dlog = [], {}, []
    for rnd, t in enumerate(GANG_TIMES):
        now[0] = t
        if rnd == 1:
            sched.enqueue_many(arrivals(rng, 100_000, n_arrivals))
            new, new_pods = new_gang_pods(rng, N_NEW_GANGS)
            for name, mm, group in new:
                sched.register_gang(GangRecord(name=name, min_member=mm,
                                               group=group))
            sched.enqueue_many(new_pods)
        log: list = []
        n_diag = len(dlog)
        build.reset_launch_counts()
        with solve_probe(log, device), checked_diagnose(dlog):
            sync(device)
            t0 = time.perf_counter()
            res = sched.schedule_round()
            sync(device)
            wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        diag = diagnose_fields(dlog[n_diag:])
        wall -= diag["diagnose_check_s"]
        check(launches["explain_counts"] == (1 if res.failures else 0),
              f"phase 13 round {rnd}: Diagnose launched K7")
        solves[rnd] = log
        rec = dict(round=rnd, t=t, path=sched.last_solve_path,
                   pods=res.round_pods, binds=len(res.assignments),
                   failed=len(res.failures), rescued=res.rescued,
                   wall_s=wall,
                   solve_ms=[s["ms"] for s in log if s["solver"] == "batch"],
                   rescue_ms=[s["ms"] for s in log
                              if s["solver"] == "greedy"],
                   rejected=sum(1 for g in sched.gangs.values()
                                if g.rejected),
                   held_out=len(sched._last_gang_rejected_names),
                   launches=launches, **diag)
        rec.update(gang_checks(sched, f"phase 13 round {rnd}"))
        records.append(rec)
        emit("gang_round", **rec)
        check(rec["path"] == "full_gang", f"phase 13 round {rnd} took the "
              "gang path")
        if rnd < 2:   # the last round brings no arrivals
            check(len(res.assignments) > 0,
                  f"phase 13 round {rnd} bound pods")
        for kname in ("select_candidates", "round_fit_choose",
                      "segmented_prefix_accept", "greedy_scan"):
            check(launches[kname] > 0,
                  f"{kname} launched on phase 13 round {rnd}")
    check(records[0]["gangs_placed"] > 0, "phase 13 placed gangs")
    check(records[0]["groups_placed"] > 0, "phase 13 placed a gang group")
    rejected = {f"pg-{g}" for g in incomplete}
    check(all(sched.gangs[g].rejected for g in rejected),
          "the incomplete gangs were rejected by t = 601 s")
    active = {p.name for p in sched._active_pods()}
    held = {n for g in rejected for n in members[g]}
    check(not (active & held), "the rejected gangs' pods left the batch")
    check(held <= set(sched._last_gang_rejected_names),
          "PreEnqueue held the rejected gangs' pods back")
    # the kernels on round 1's first-pass inputs
    first = next(s for s in solves[0] if s["solver"] == "batch")
    cold = gang_solve(first)
    held_out = int(first["batch"].valid.sum() - cold["batch"].valid.sum())
    check(held_out > 0, "PreEnqueue held gang pods out of round 1's solve")
    k1 = held_k1(device, cold["state"], cold["batch"], cold["cfg"], "exact",
                 chunk=4_096, where="at phase 13's round 1")
    k1 = dict(max_abs_err=k1["max_abs_err"], ms=k1["ms"],
              plain_ms=k1["plain_ms"],
              **k1_bound(cold["state"], cold["batch"], cold["cfg"]))
    k3b = phase_quota_rounds(device, cold, label="gang_quota_rounds")
    rescue = gang_solve(next(s for s in solves[0]
                             if s["solver"] == "greedy"))
    k4 = phase_rescue(device, rescue, label="gang_rescue",
                      what="phase 13's round 1 rescue")
    emit("gangs", nodes=n_nodes, backlog=n_pods, gang_pods=n_gang_pods,
         gangs=len(gangs), grouped=N_GROUPED, incomplete=N_INCOMPLETE,
         pre_enqueue_held_out=held_out, k1=k1, k3b_first_round=k3b, k4=k4,
         seconds=time.perf_counter() - t_start,
         rounds=[{key: r[key] for key in (
             "round", "t", "pods", "binds", "rescued", "wall_s", "solve_ms",
             "rescue_ms", "gangs_placed", "rejected", "held_out",
             "diagnose_ms", "diagnose_parts_ms", "k7_rows")}
             for r in records])
    k3b = {key: k3b[key] for key in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by")}
    return records, {"select_candidates": k1,
                     "segmented_prefix_accept": k3b, "greedy_scan": k4}


# -- phase 14: the approx candidate method (K1a) -----------------------------

APPROX_WIDE_NODES = 65_536
APPROX_WIDE_ROWS = 4_096
APPROX_CHUNK = 1_024
#: rows of phase 14's cold batch given band rot ids, so both K1a
#: instances launch (the band is ~N / 2**32 of the rot ids: 2.4e-6 of the
#: rows at 10,240 nodes)
APPROX_BAND_ROWS = 8


def wrap_case(seed: int, n_nodes: int, n_pods: int, device, ends: int = 4):
    """random_problem at ``n_nodes`` (the node count equals the capacity,
    so column N - 1 is a real node) with the first and last ``ends``
    nodes identical and the most attractive (the largest capacity,
    nothing used), so every row's top run spans the wrap from column
    N - 1 to column 0; half the pods at rot ids whose tie-break wraps, and
    every 97th pod admitting no node (a row with no feasible column)."""
    state, pods = random_problem(seed, n_nodes, n_pods, device)
    rng = np.random.default_rng(seed + 1)
    edge = np.r_[0:ends, n_nodes - ends:n_nodes]
    alloc = state.node_allocatable.cpu().numpy().copy()
    alloc[edge, CPU], alloc[edge, MEM], alloc[edge, 3] = 64_000, 262_144, 8_000
    cls = state.node_class.cpu().numpy().copy()
    cls[edge] = 0                     # the one class every pod admits
    zero = np.ones((n_nodes, 1), np.int32)
    zero[edge] = 0
    rot = pods.rot_id.cpu().numpy().copy()
    rot[::2] = danger_rot_ids(rng, (pods.capacity + 1) // 2, n_nodes)
    sel = pods.selector_mask.cpu().numpy().copy()
    sel[::97] = False
    zero_t = to_dev(zero, device)
    return (state.replace(
        node_allocatable=to_dev(alloc, device),
        node_class=to_dev(cls, device),
        node_requested=state.node_requested * zero_t,
        node_usage=state.node_usage * zero_t,
        node_agg_usage=state.node_agg_usage * zero_t),
            pods.replace(rot_id=to_dev(rot, device),
                         selector_mask=to_dev(sel, device)))


def rows_apart(a, b) -> int:
    """Rows whose candidate nodes differ between two selections."""
    return int((a != b).any(dim=1).sum())


def approx_edge(device, label: str, state, pods, cfg, chunk=None,
                k: int = 32) -> dict:
    """K1a against its plain version on a problem, and the rows where its
    nodes differ from K1's (which must exist: approx is not exact on
    these problems)."""
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )

    got = held_k1(device, state, pods, cfg, "approx", reps=1, chunk=chunk,
                  k=k)
    exact = select_candidates_kernel(state, pods, cfg, k)
    apart = rows_apart(got["out"][1], exact[1])
    out = dict(case=label, nodes=state.capacity, pods=pods.capacity, k=k,
               max_abs_err=got["max_abs_err"], rows_apart_from_k1=apart,
               ms=got["ms"], plain_ms=got["plain_ms"])
    emit("approx_edge", **out)
    return out


def phase_approx(device, n_nodes: int = 10_240, n_pods: int = 50_000,
                 steady_rounds: int = 2, n_arrivals: int = 500, reps: int = 3):
    """Phase 14: phase 9's steady configuration (the forced-threshold
    scheduler behind the 16-leaf quota tree) with cand_method="approx":
    a cold round and ``steady_rounds`` rounds after a usage refresh of 1%
    of the nodes and 500 arrivals, the launch counts set to 0 before each
    round and read after it (K1a on every selection, K1 never; a K1a call
    in the packed regime counts two launches, its int32 instance and its
    64-bit one).  A second
    scheduler's cold round under "chunked" must launch K1a alone and bind
    exactly as the approx one's.  On the card both methods make the same
    K1a launch, so that round confirms the scheduler's routing of
    "chunked" and nothing more; chunked's own plain path (approx over
    CANDIDATE_CHUNK-row chunks) is what held_k1 holds K1a against.  K1a
    is held against it at the cold round's shape (65,536 rows, 50,000
    valid, over 10,240 nodes; K1 timed beside it on the same inputs, and
    torch.topk over the (P, N) float key as the library yardstick), at
    65,536 nodes over the first 4,096
    rows in 1,024-row chunks and on a full-capacity wrap case at 10,240
    nodes (wrap_case, both), there also at k = 2 and 3.  Returns (K1a's
    kernels-line entry, the round records)."""
    import torch

    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        _rank_parts,
        approx_band,
        approx_keys,
        select_candidates_kernel,
    )
    from koordinator_tpu_torch.ops.assignment import score_pods
    from koordinator_tpu_torch.ops.batch_assign import CANDIDATE_CHUNK

    t_start = time.perf_counter()
    nodes, pods, leaf_max = steady_specs(3, n_nodes, n_pods)
    sched = steady_scheduler(device, nodes, pods, leaf_max, threshold=1.0)
    sched.cand_method = "approx"
    rng = np.random.default_rng(5)
    records, solves, totals = [], {}, {}
    for rnd in range(1 + steady_rounds):
        if rnd > 0:
            refreshed, new = steady_delta(rng, nodes, rnd, n_arrivals)
            for spec in refreshed:
                sched.snapshot.upsert_node(spec)
            sched.enqueue_many(new)
        log: list = []
        build.reset_launch_counts()
        with solve_probe(log, device):
            sync(device)
            t0 = time.perf_counter()
            res = sched.schedule_round()
            sync(device)
            wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for kname, count in launches.items():
            totals[kname] = totals.get(kname, 0) + count
        solves[rnd] = (log, res)
        rec = dict(round=rnd, path=sched.last_solve_path,
                   pods=res.round_pods, binds=len(res.assignments),
                   failed=len(res.failures), rescued=res.rescued,
                   wall_s=wall,
                   solve_ms=[s["ms"] for s in log if s["solver"] == "batch"],
                   rescue_ms=[s["ms"] for s in log
                              if s["solver"] == "greedy"],
                   launches=launches)
        records.append(rec)
        emit("approx_round", **rec)
        check(len(res.assignments) > 0, f"phase 14 round {rnd} bound pods")
        check(launches["select_candidates_approx"] > 0
              and launches["select_candidates_approx"] % 2 == 0
              and launches["select_candidates"] == 0,
              f"phase 14 round {rnd} selected on K1a alone, both instances "
              "a call")
        check(launches["round_fit_choose"] > 0
              and launches["segmented_prefix_accept"]
              == launches["round_fit_choose"],
              f"phase 14 round {rnd}: one K3b launch a propose/accept round")
        check(rec["path"] == ("full_cold" if rnd == 0 else "incremental"),
              f"phase 14 round {rnd}'s path")
        if rnd > 0:
            check(launches["refresh_candidates"] > 0,
                  f"phase 14 round {rnd} refreshed on K2")
        st = sched.snapshot.state
        check(bool((st.node_requested <= st.node_allocatable).all()),
              f"phase 14 round {rnd}: no overcommit")
        expect = np.zeros((st.capacity, R), np.int64)
        for bp in sched.bound.values():
            expect[sched.snapshot.node_index[bp.node]] += bp.requests
        check(np.array_equal(expect, st.node_requested.cpu().numpy()),
              f"phase 14 round {rnd}: accounting = sum of bound pods")
    # the scheduler routes the chunked method to K1a (the same launch as
    # approx's on the card), so it binds as approx does
    nodes2, pods2, _ = steady_specs(3, n_nodes, n_pods)
    chunked = steady_scheduler(device, nodes2, pods2, leaf_max, threshold=1.0)
    chunked.cand_method = "chunked"
    build.reset_launch_counts()
    res_c = chunked.schedule_round()
    check(build.LAUNCHES["select_candidates_approx"] > 0
          and build.LAUNCHES["select_candidates"] == 0,
          "the chunked cold round selected on K1a alone")
    res_a = solves[0][1]
    check(res_c.assignments == res_a.assignments
          and failure_docs(res_c) == failure_docs(res_a),
          "the chunked cold round binds as the approx one")
    del chunked
    # K1a at the cold round's shape, K1 beside it on the same inputs
    cold = next(s for s in solves[0][0] if s["solver"] == "batch")
    state, batch, cfg = cold["state"], cold["batch"], cold["cfg"]
    p, n, k = batch.capacity, state.capacity, 32
    k1a = held_k1(device, state, batch, cfg, "approx", reps=reps,
                  chunk=CANDIDATE_CHUNK)
    k1 = held_k1(device, state, batch, cfg, "exact", reps=reps,
                 chunk=CANDIDATE_CHUNK)
    apart = rows_apart(k1a["out"][1], k1["out"][1])
    # both K1a instances in one call: a few valid rows at band rot ids
    # (the rows whose tie-break has two preimages go to the 64-bit one),
    # at k = 32 and at k = 2 and 3 (strata of one candidate)
    rng_b = np.random.default_rng(14)
    valid_rows = np.flatnonzero(batch.valid.cpu().numpy())
    picked = rng_b.choice(valid_rows, APPROX_BAND_ROWS, replace=False)
    rot = batch.rot_id.cpu().numpy().copy()
    rot[picked] = [_rot_in_band(rng_b, n) for _ in picked]
    band_batch = batch.replace(rot_id=to_dev(rot, device))
    # the rows each instance ranked, as K1a's launch counts them: the
    # band's (approx_band, held on the CPU to the rows whose tie-break has
    # two preimages) on the 64-bit instance, the others on the int32 one
    instance_rows = {}
    for name, b in (("cold", batch), ("band", band_batch)):
        ranked = torch.zeros(2, dtype=torch.int32, device=state.device)
        select_candidates_kernel(state, b, cfg, k, method="approx",
                                 ranked=ranked)
        got = ranked.cpu().tolist()
        band = approx_band(b.rot_id, n)
        instance_rows[name] = dict(int32=got[0], bit64=got[1])
        check(got == [int((~band).sum()), int(band.sum())],
              f"K1a ranked the {name} batch's band rows on its 64-bit "
              "instance and the others on its int32 one")
    check(instance_rows["band"]["bit64"] >= APPROX_BAND_ROWS,
          "the band rows reach K1a's 64-bit instance")
    both = {kk: held_k1(device, state, band_batch, cfg, "approx",
                        reps=reps if kk == k else 1, chunk=CANDIDATE_CHUNK,
                        k=kk, where=f"with band rows, k = {kk}")
            for kk in (k, 2, 3)}
    fkey = torch.empty((p, n), dtype=torch.float32, device=state.device)
    for i in range(0, p, CANDIDATE_CHUNK):
        sub = _pod_rows(batch, i, min(i + CANDIDATE_CHUNK, p))
        scores, feas = score_pods(state, sub, cfg)
        key, tb = _rank_parts(scores, feas, 5, sub.rot_id, n_total=n)
        fkey[i:i + CANDIDATE_CHUNK] = approx_keys(key, tb, 5, n).float()
        del scores, feas, key, tb
    topk_ms = timed_ms(lambda: torch.topk(fkey, k // 2, dim=1), device,
                       reps=reps)
    del fkey
    k1a_b = k1_bound(state, batch, cfg, k)
    cfg0 = scoring_config("default", device)
    wide = approx_edge(device, f"wide_{APPROX_WIDE_NODES}", *wrap_case(
        71, APPROX_WIDE_NODES, APPROX_WIDE_ROWS, device), cfg0,
        chunk=APPROX_CHUNK)
    wrap_args = wrap_case(72, n_nodes, 4_096, device)
    wrap = approx_edge(device, f"wrap_{n_nodes}", *wrap_args, cfg0)
    # strata of one candidate (k = 2: one each; k = 3: the second),
    # where approx_max_k takes the row's last maximum
    ones = [approx_edge(device, f"wrap_{n_nodes}_k{k1}", *wrap_args, cfg0,
                        k=k1) for k1 in (2, 3)]
    check(all(e["rows_apart_from_k1"] > 0 for e in [wide, wrap] + ones),
          "approx differs from exact on the wrap cases")
    entry = dict(
        name="select_candidates_approx", route="cuda",
        source=CSRC + "select_candidates.cu",
        replaces="koordinator_tpu/ops/batch_assign.py:469",
        launches=totals["select_candidates_approx"],
        max_abs_err=max([k1a["max_abs_err"]]
                        + [e["max_abs_err"] for e in both.values()]),
        ms=k1a["ms"], plain_ms=k1a["plain_ms"], bound_ms=k1a_b["bound_ms"],
        bound_by=k1a_b["bound_by"], library_ms=topk_ms, k1_ms=k1["ms"],
        rows_by_instance=instance_rows["cold"],
        with_band_rows=dict(ms=both[k]["ms"], **instance_rows["band"]))
    emit("approx", nodes=n_nodes, backlog=n_pods, pods=p,
         valid_pods=int(batch.valid.sum()), k=k, ops=k1a_b["ops"],
         bytes=k1a_b["bytes"],
         k1a_ms=k1a["ms"], k1_ms=k1["ms"], topk_ms=topk_ms,
         k1a_over_k1=k1a["ms"] / k1["ms"], k1a_over_topk=k1a["ms"] / topk_ms,
         bound_ms=k1a_b["bound_ms"], rows_by_instance=instance_rows,
         k1a_both_instances=dict(
             rows=APPROX_BAND_ROWS, ms=both[k]["ms"],
             max_abs_err=max(e["max_abs_err"] for e in both.values()),
             plain_ms={kk: e["plain_ms"] for kk, e in both.items()}),
         k1a_plain_ms=k1a["plain_ms"],
         rows_apart_from_k1=apart, launches_by_round=[
             r["launches"]["select_candidates_approx"] for r in records],
         chunked_binds=len(res_c.assignments), edges=[wide, wrap] + ones,
         seconds=time.perf_counter() - t_start)
    return entry, records


# -- phase 15: preemption and quota overuse revoke (K5, K6) -------------------

K5_OPEN = 2**30


def k5_problem(seed: int, n_nodes: int, n_bound: int, device, *, c: int = 8,
               n_pdbs: int = 4, n_quotas: int = 4, crowd: int = 0,
               edges: bool = False):
    """(state, sched, chain) of a seeded preemption problem on ``device``:
    ``n_bound`` bound pods over ``n_nodes`` (``crowd`` more on node 0, more
    than one of K5a's 32-row chunks), PDB and quota ids, and ``c``
    preemptors with their feasible rows, same-quota flags, activity, the
    PDB budgets and a (Q, R) base headroom.  ``edges`` puts priorities at
    NEG_PRI, -2**31 and past 2**30 (per-node sums wrap) and preemptors at
    2**31 - 1 and -2**31 + 2."""
    import torch

    from koordinator_tpu_torch.ops.preemption import ScheduledPods
    from koordinator_tpu_torch.state.cluster_state import ClusterState

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, R), np.int32)
    alloc[:, CPU] = rng.integers(8_000, 64_000, n_nodes)
    alloc[:, MEM] = rng.integers(16_384, 262_144, n_nodes)
    v = n_bound + crowd
    node = rng.integers(0, n_nodes, v).astype(np.int32)
    node[n_bound:] = 0
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, v)
    req[:, MEM] = rng.integers(128, 8_192, v)
    if crowd:
        req[n_bound:, CPU] = rng.integers(20, 200, crowd)
        alloc[0, CPU] = 60_000 + int(req[n_bound:, CPU].sum())
    node[rng.random(v) < 0.02] = -1
    pri = rng.integers(3_000, 9_000, v).astype(np.int32)
    pri[rng.random(v) < 0.3] = rng.integers(3_000, 3_004)
    if edges:
        pick = rng.random(v)
        pri[pick < 0.1] = -(2**31) + 1
        pri[(pick >= 0.1) & (pick < 0.2)] = -(2**31)
        band = (pick >= 0.2) & (pick < 0.35)
        pri[band] = rng.integers(2**30, 2**30 + 2**29, int(band.sum()))
    quota = rng.integers(-1, n_quotas, v).astype(np.int32)
    nonp = rng.random(v) < 0.1
    pdb = (rng.integers(-1, n_pdbs, v).astype(np.int32) if n_pdbs
           else np.full(v, -1, np.int32))
    requested = np.zeros((n_nodes, R), np.int64)
    np.add.at(requested, node[node >= 0], req[node >= 0])
    requested = np.minimum(requested, alloc).astype(np.int32)
    state = ClusterState.from_arrays(alloc, requested=requested,
                                     capacity=n_nodes, device=device)
    sched = ScheduledPods.build(req, node, priority=pri, quota_id=quota,
                                non_preemptible=nonp, pdb_id=pdb,
                                device=device)
    reqs = np.zeros((c, R), np.int32)
    reqs[:, CPU] = rng.integers(1_000, 12_000, c)
    reqs[:, MEM] = rng.integers(0, 16_384, c)
    pris = rng.integers(9_000, 10_000, c).astype(np.int32)
    if edges:
        pris[:] = rng.choice([2**31 - 1, 2**30 + 2**29, -(2**31) + 2], c)
    qids = rng.integers(-1, n_quotas, c).astype(np.int32)
    base_hr = rng.integers(-3_000, 15_000, (n_quotas, R)).astype(np.int32)
    base_hr[:, 2:] = rng.choice([K5_OPEN, -K5_OPEN, 0], (n_quotas, R - 2))

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    chain = dict(
        reqs=dev(reqs), pris=dev(pris), qids=dev(qids),
        feas=dev(rng.random((c, n_nodes)) < 0.9),
        same_q=dev((qids >= 0) & (rng.random(c) < 0.8)),
        active=dev(rng.random(c) < 0.9),
        pdb=dev(rng.integers(0, 9, max(n_pdbs, 1)).astype(np.int32)),
        base_hr=dev(base_hr))
    return state, sched, chain


CHAIN_ARGS = ("reqs", "pris", "qids", "feas", "same_q", "active", "pdb",
              "base_hr")


def chain_err(got, want) -> int:
    """The largest difference between two ChainOutcomes over every output."""
    return max(max_abs_err(got.node, want.node),
               max_abs_err(got.victims, want.victims),
               max_abs_err(got.state.node_requested,
                           want.state.node_requested),
               max_abs_err(got.sched.valid, want.sched.valid),
               max_abs_err(got.pdb_allowed, want.pdb_allowed),
               max_abs_err(got.assumed, want.assumed))


def held_k5(device, state, sched, ch, label: str, one_rows=(0,),
            grid: int = 0) -> dict:
    """K5 against its plain versions on one problem: the chain, then for
    the rows ``one_rows`` preempt_one on both quota paths (no headroom with
    the job rule and with the elastic-quota rule, the row's base headroom)
    and the dry run alone; ``grid`` CTAs (0: the default)."""
    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as ops

    args = [ch[k] for k in CHAIN_ARGS]
    got = k5.preempt_chain_kernel(state, sched, *args, grid=grid)
    sync(device)
    want = ops.preempt_chain_plain(state, sched, *args)
    err = chain_err(got, want)
    check(err == 0, f"K5 chain equals its plain version ({label})")
    for j in one_rows:
        q = max(int(ch["qids"][j]), 0)
        for hr, sq in ((None, False), (None, True),
                       (ch["base_hr"][q], True), (ch["base_hr"][q], False)):
            one = (state, sched, ch["reqs"][j], ch["pris"][j], ch["qids"][j],
                   ch["feas"][j], ch["pdb"])
            kw = dict(quota_headroom=hr, same_quota_only=sq)
            g, w = (k5.preempt_one_kernel(*one, **kw, grid=grid),
                    ops.preempt_one_plain(*one, **kw))
            e1 = max(max_abs_err(g.node, w.node),
                     max_abs_err(g.victims, w.victims),
                     max_abs_err(g.state.node_requested,
                                 w.state.node_requested),
                     max_abs_err(g.sched.valid, w.sched.valid),
                     max_abs_err(g.pdb_allowed, w.pdb_allowed))
            gs, ws = (k5.select_victims_kernel(*one, **kw, grid=grid),
                      ops.select_victims_plain(*one, **kw))
            e1 = max([e1] + [max_abs_err(getattr(gs, f), getattr(ws, f))
                             for f in ("eligible", "victim", "violating",
                                       "num_victims", "num_violating",
                                       "max_victim_pri", "sum_victim_pri")])
            check(e1 == 0, f"K5 preempt_one and its dry run equal their "
                  f"plain versions ({label}, row {j}, headroom "
                  f"{hr is not None}, same quota {sq})")
            err = max(err, e1)
    return dict(case=label, nodes=state.capacity, bound=sched.capacity,
                preemptors=int(ch["reqs"].shape[0]), grid=grid,
                max_abs_err=err, nominated=int((got.node >= 0).sum()),
                victims=int(got.victims.sum()),
                nodes_out=got.node.tolist()[:8])


def held_k5_carried(device, state, sched, ch, label: str) -> dict:
    """One PostFilter's K5 calls on the carry each leaves: the first half
    of the preemptors as a chain, the second half as another, then rows 0
    and 1 as a gang's preempt_one calls (no headroom, then the row's base
    headroom), each against its plain version on the plain carry; the
    node-ordered rows, built once before the first call, are the ones
    every returned ScheduledPods carries, and equal a fresh build at the
    end."""
    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as ops

    n = state.capacity
    c = int(ch["reqs"].shape[0])
    built = k5.victim_csr(sched, n)
    g_state, g_sched, g_pdb = state, sched, ch["pdb"]
    w_state, w_sched, w_pdb = state, sched, ch["pdb"]
    err = 0
    for lo, hi in ((0, c // 2), (c // 2, c)):
        cut = [ch[k][lo:hi] for k in CHAIN_ARGS[:6]]
        got = k5.preempt_chain_kernel(g_state, g_sched, *cut, g_pdb,
                                      ch["base_hr"])
        want = ops.preempt_chain_plain(w_state, w_sched, *cut, w_pdb,
                                       ch["base_hr"])
        check(k5.victim_csr(got.sched, n) is built,
              f"K5's node-ordered rows are carried ({label})")
        err = max(err, chain_err(got, want))
        g_state, g_sched, g_pdb = got.state, got.sched, got.pdb_allowed
        w_state, w_sched, w_pdb = want.state, want.sched, want.pdb_allowed
    for j, hr in ((0, None), (1, ch["base_hr"][max(int(ch["qids"][1]), 0)])):
        one = [ch[k][j] for k in ("reqs", "pris", "qids", "feas")]
        kw = dict(quota_headroom=hr, same_quota_only=hr is not None)
        got = k5.preempt_one_kernel(g_state, g_sched, *one, g_pdb, **kw)
        want = ops.preempt_one_plain(w_state, w_sched, *one, w_pdb, **kw)
        check(k5.victim_csr(got.sched, n) is built,
              f"K5's node-ordered rows are carried ({label})")
        err = max(err, max_abs_err(got.node, want.node),
                  max_abs_err(got.victims, want.victims),
                  max_abs_err(got.state.node_requested,
                              want.state.node_requested),
                  max_abs_err(got.sched.valid, want.sched.valid),
                  max_abs_err(got.pdb_allowed, want.pdb_allowed))
        g_state, g_sched, g_pdb = got.state, got.sched, got.pdb_allowed
        w_state, w_sched, w_pdb = want.state, want.sched, want.pdb_allowed
    sync(device)
    check(err == 0, f"K5 on carried rows equals its plain versions ({label})")
    fresh = k5.VictimCSR(g_sched, n)
    for f in ("offsets", "rows", "row_count", "pri", "quota", "pdb", "nonp",
              "req"):
        check(bool((getattr(fresh, f) == getattr(built, f)).all()),
              f"the carried rows' {f} equal a fresh build ({label})")
    return dict(case=label, nodes=n, bound=sched.capacity, preemptors=c,
                max_abs_err=err, calls=4)


def k5_tiny(device, alloc_cpu, pods, preemptors, budgets):
    """(state, sched, chain) of a hand-made chain: ``pods`` as (node, cpu,
    priority, pdb, non-preemptible) on nodes of ``alloc_cpu`` mcores (each
    node's accounting their sum), ``preemptors`` as (cpu, priority,
    feasible nodes); no quota anywhere."""
    import torch

    from koordinator_tpu_torch.ops.preemption import ScheduledPods
    from koordinator_tpu_torch.state.cluster_state import ClusterState

    n, v, c = len(alloc_cpu), len(pods), len(preemptors)
    alloc = np.zeros((n, R), np.int32)
    alloc[:, CPU] = alloc_cpu
    alloc[:, MEM] = 65_536
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = [p[1] for p in pods]
    req[:, MEM] = 256
    node = np.array([p[0] for p in pods], np.int32)
    requested = np.zeros((n, R), np.int64)
    np.add.at(requested, node, req)
    state = ClusterState.from_arrays(alloc,
                                     requested=requested.astype(np.int32),
                                     capacity=n, device=device)
    sched = ScheduledPods.build(
        req, node, priority=np.array([p[2] for p in pods], np.int32),
        quota_id=np.full(v, -1, np.int32),
        non_preemptible=np.array([p[4] for p in pods], bool),
        pdb_id=np.array([p[3] for p in pods], np.int32), device=device)
    reqs = np.zeros((c, R), np.int32)
    reqs[:, CPU] = [p[0] for p in preemptors]
    feas = np.zeros((c, n), bool)
    for j, p in enumerate(preemptors):
        feas[j, list(p[2])] = True

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    return state, sched, dict(
        reqs=dev(reqs), pris=dev(np.array([p[1] for p in preemptors],
                                          np.int32)),
        qids=dev(np.full(c, -1, np.int32)), feas=dev(feas),
        same_q=dev(np.zeros(c, bool)), active=dev(np.ones(c, bool)),
        pdb=dev(np.array(budgets, np.int32)),
        base_hr=dev(np.full((1, R), K5_OPEN, np.int32)))


def k6_problem(seed: int, n_pods: int, n_quotas: int, device, *,
               runtime_frac: float = 0.6, n_pdbs: int = 3):
    """(sched, used, runtime, checked, pdb budgets) of a seeded overuse
    problem: ``n_pods`` bound pods over ``n_quotas`` quotas (10% outside
    any), each quota's runtime ``runtime_frac`` of its used on cpu and
    memory (every other quota under), PDB budget 0 for PDB 0."""
    import torch

    from koordinator_tpu_torch.ops.preemption import ScheduledPods

    rng = np.random.default_rng(seed)
    req = np.zeros((n_pods, R), np.int32)
    req[:, CPU] = rng.integers(100, 4_000, n_pods)
    req[:, MEM] = rng.integers(128, 8_192, n_pods)
    req[rng.random(n_pods) < 0.05, CPU] = 0
    quota = rng.integers(0, n_quotas, n_pods).astype(np.int32)
    quota[rng.random(n_pods) < 0.1] = -1
    pri = rng.integers(3_000, 9_000, n_pods).astype(np.int32)
    pri[rng.random(n_pods) < 0.3] = 5_000
    nonp = rng.random(n_pods) < 0.05
    pdb = rng.integers(-1, n_pdbs, n_pods).astype(np.int32)
    pdb[rng.random(n_pods) < 0.9] = -1
    used = np.zeros((n_quotas, R), np.int64)
    np.add.at(used, quota[quota >= 0], req[quota >= 0])
    used = np.minimum(used, 2**30).astype(np.int32)
    runtime = used.copy()
    runtime[::2, :2] = (used[::2, :2] * runtime_frac).astype(np.int32)
    checked = np.zeros((n_quotas, R), bool)
    checked[:, :2] = True
    sched = ScheduledPods.build(req, np.zeros(n_pods, np.int32),
                                priority=pri, quota_id=quota,
                                non_preemptible=nonp, pdb_id=pdb,
                                device=device)
    budgets = np.full(n_pdbs, 5, np.int32)
    budgets[0] = 0

    def dev(a):
        return torch.from_numpy(a).to(device)

    return sched, dev(used), dev(runtime), dev(checked), dev(budgets)


def k6_stop_problem(n_pods: int, removed: int | None, device,
                    blocked: bool = False):
    """(sched, used, runtime, checked, pdb budgets) of one quota of
    ``n_pods`` candidates of 100 mcores, priorities ascending, at runtime
    ``used - 100 * removed``: K6's phase 1 removes exactly ``removed`` pods
    (None: runtime -1, the walk runs past the end and the quota is
    hopeless; ``blocked`` adds a pod an exhausted PDB protects)."""
    import torch

    from koordinator_tpu_torch.ops.preemption import ScheduledPods

    v = n_pods + 1
    req = np.zeros((v, R), np.int32)
    req[:, CPU] = 100
    req[:, MEM] = 128
    pdb = np.full(v, -1, np.int32)
    pdb[-1] = 0 if blocked else -1
    used = np.zeros((1, R), np.int32)
    used[0] = req.sum(0)
    runtime = used.copy()
    runtime[0, CPU] = -1 if removed is None else used[0, CPU] - 100 * removed
    checked = np.zeros((1, R), bool)
    checked[0, CPU] = True
    sched = ScheduledPods.build(
        req, np.zeros(v, np.int32),
        priority=np.arange(1_000, 1_000 + v, dtype=np.int32),
        quota_id=np.zeros(v, np.int32), pdb_id=pdb, device=device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return (sched, dev(used), dev(runtime), dev(checked),
            dev(np.array([0, 5, 5], np.int32)))


def held_k6(device, label: str, sched, used, runtime, checked, pdb,
            reps: int = 0) -> dict:
    """K6 against its plain version: the revoke masks, and each quota's
    phase-1 walk length (the removals); with ``reps``, both timed."""
    from koordinator_tpu_torch.kernels import overuse_revoke as k6
    from koordinator_tpu_torch.quota.overuse_revoke import (
        overuse_keys,
        select_overuse_victims_plain,
    )

    got, walk = k6.overuse_revoke_launch(sched, used, runtime, checked, pdb)
    sync(device)
    want = select_overuse_victims_plain(sched, used, runtime, checked, pdb)
    err = max_abs_err(got, want)
    # the keys launch alone against its plain version
    q = used.shape[0]
    got_keys = k6.overuse_keys_launch(sched, q, pdb)[:3]
    want_keys = overuse_keys(sched, q, pdb)
    err = max([err] + [max_abs_err(g, w) for g, w in zip(got_keys,
                                                          want_keys)])
    check(err == 0, f"K6 equals its plain version ({label})")
    out = dict(case=label, pods=sched.capacity, quotas=used.shape[0],
               max_abs_err=err, revoked=int(got.sum()),
               revoked_in_quota_0=int((got & (sched.quota_id == 0)).sum()),
               longest_walk=int(walk.max()))
    out["walks"] = walk.tolist()[:4]
    if reps:
        out["ms"] = timed_ms(lambda: k6.overuse_revoke_launch(
            sched, used, runtime, checked, pdb), device, reps=reps)
        out["plain_ms"] = timed_ms(lambda: select_overuse_victims_plain(
            sched, used, runtime, checked, pdb), device, reps=1, warmup=0)
        out.update(k6_bound(sched, used, walk))
    return out


def phase_preempt_edges(device, wide_nodes: int = 65_536,
                        wide_bound: int = 196_608,
                        many_pdbs: int = 4_096,
                        long_quota: int = 50_000) -> dict:
    """K5 and K6 against their plain versions on their edges, every output
    exact: a node with 110 candidates (the PDB carry crosses K5's 32-row
    chunks, and rows past the 64 a warp stages are read from the CSR),
    PDBs with budget 0 and rank ties, an all-tie choice (the lowest row
    wins), no eligible node (-1), priorities at NEG_PRI and -2**31 with
    headroom at +-2**30 and wrapping priority sums, inactive chain rows, a
    later preemptor that must see an earlier one's nomination, two
    preemptors in a row on the same node, a PDB budget one preemptor
    spends flipping the next one's choice, grids of 1, 3 and 132 CTAs, one
    PostFilter's calls on the node-ordered rows they carry, 65,536 nodes
    (a CTA looping over hundreds of them), 4,096 PDBs, and 10,000 PDBs and
    1,024 quota rows (each CTA's copies of the budgets and the assumed
    quota in the global scratch, not shared memory); K6 on one quota of
    50,000 pods, on hopeless quotas with a blocked pod (skipped) and
    without (every candidate evicted), and with phase 1 stopping at lane
    0, at lane 31 and past the end of the list.  Returns the 50,000-pod
    quota's K6 record."""
    import torch

    t_start = time.perf_counter()
    cases = []
    # 110 candidates on node 0 over two PDBs with budgets 40 and 70
    state, sched, ch = k5_problem(151, 64, 2_000, device, crowd=110,
                                  n_pdbs=2)
    pdb = sched.pdb_id.clone()
    pdb[2_000:2_110] = torch.arange(110, device=pdb.device) % 2
    sched = sched.replace(pdb_id=pdb)
    ch["pdb"] = torch.tensor([40, 70], dtype=torch.int32, device=pdb.device)
    ch["reqs"][:, CPU] = 50_000
    cases.append(held_k5(device, state, sched, ch, "crowd_110"))
    # budget 0 everywhere, many priority ties
    state, sched, ch = k5_problem(152, 256, 4_000, device, n_pdbs=3)
    sched = sched.replace(priority=torch.where(
        sched.priority > 6_000, 3_000, sched.priority))
    ch["pdb"].zero_()
    cases.append(held_k5(device, state, sched, ch, "pdb_zero_ties"))
    # identical nodes and pods: every key ties
    state, sched, ch = k5_problem(153, 128, 1_024, device, n_pdbs=0)
    n = 128
    state = state.replace(
        node_allocatable=state.node_allocatable[:1].repeat(n, 1),
        node_requested=state.node_requested[:1].repeat(n, 1))
    sched = sched.replace(
        node=(torch.arange(sched.capacity, device=pdb.device) % n).to(
            torch.int32),
        requests=sched.requests[:1].repeat(sched.capacity, 1),
        priority=torch.full_like(sched.priority, 3_000),
        non_preemptible=torch.zeros_like(sched.non_preemptible),
        quota_id=torch.full_like(sched.quota_id, -1),
        pdb_id=torch.full_like(sched.pdb_id, -1),
        valid=torch.ones_like(sched.valid))
    ch["feas"][:] = True
    ch["same_q"][:] = False
    ch["active"][:] = True
    cases.append(held_k5(device, state, sched, ch, "all_ties"))
    check(cases[-1]["nodes_out"][0] == 0,
          "an all-tie choice takes the lowest row")
    # no preemptor above anyone
    state, sched, ch = k5_problem(154, 256, 3_000, device)
    ch["pris"][:] = -(2**31) + 1
    cases.append(held_k5(device, state, sched, ch, "no_eligible"))
    check(cases[-1]["nominated"] == 0, "no eligible node gives -1")
    # int32 edges
    for seed in (155, 156):
        state, sched, ch = k5_problem(seed, 256, 6_000, device, edges=True,
                                      c=12)
        cases.append(held_k5(device, state, sched, ch, f"int32_{seed}",
                             one_rows=(0, 1)))
    # inactive rows
    state, sched, ch = k5_problem(157, 256, 4_000, device, c=16)
    ch["active"][:] = False
    ch["active"][5] = True
    cases.append(held_k5(device, state, sched, ch, "inactive"))
    # a later preemptor repeating an earlier one
    state, sched, ch = k5_problem(158, 64, 1_200, device, c=6)
    for key in ("reqs", "pris", "qids", "feas", "same_q"):
        ch[key][1:] = ch[key][0]
    ch["active"][:] = True
    cases.append(held_k5(device, state, sched, ch, "later_sees_earlier"))
    # 65,536 nodes, and 4,096 PDBs
    state, sched, ch = k5_problem(159, wide_nodes, wide_bound, device, c=4)
    cases.append(held_k5(device, state, sched, ch, f"nodes_{wide_nodes}"))
    cases.append(held_k5(device, state, sched, ch,
                         f"nodes_{wide_nodes}_grid_132", grid=132))
    state, sched, ch = k5_problem(160, 10_240, 100_000, device, c=8,
                                  n_pdbs=many_pdbs)
    cases.append(held_k5(device, state, sched, ch, f"pdbs_{many_pdbs}"))
    # each CTA's budgets and assumed quota past shared memory, in its
    # slice of the global scratch: 10,000 PDBs, then 1,024 quota rows in
    # the chain's quota mode
    for label, seed, nodes, pods, kw in (
            ("pdbs_10000", 165, 10_240, 100_000, dict(n_pdbs=10_000)),
            ("quotas_1024", 166, 2_048, 20_000,
             dict(n_quotas=1_024, c=16))):
        state, sched, ch = k5_problem(seed, nodes, pods, device, **kw)
        cases.append(held_k5(device, state, sched, ch, label))
        if torch.device(device).type == "cuda":
            from koordinator_tpu_torch.kernels import build

            local = int(build.lib().koord_preempt_chain_local_ints(
                int(ch["pdb"].shape[0]), int(ch["base_hr"].numel()), 1))
            cases[-1]["global_local_ints"] = local
            check(local > 0, f"K5 keeps its copies in the global scratch "
                  f"({label})")
    # the partial keys over 1, 3 and 132 CTAs
    state, sched, ch = k5_problem(163, 256, 4_000, device, c=12,
                                  crowd=70, edges=True)
    for grid in (1, 3, 132):
        cases.append(held_k5(device, state, sched, ch, f"grid_{grid}",
                             grid=grid))
    # two preemptors in a row on node 1, the only one with victims
    pods = [(0, 9_000, 9_500, -1, False), (2, 9_000, 1_000, -1, True)]
    pods += [(1, 2_500, 1_000 + k, -1, False) for k in range(4)]
    state, sched, ch = k5_tiny(device, [10_000] * 3, pods,
                               [(4_000, 9_000, (0, 1, 2))] * 2, [1])
    cases.append(held_k5(device, state, sched, ch, "same_node_twice"))
    check(cases[-1]["nodes_out"][:2] == [1, 1],
          "consecutive preemptors take the same node")
    # preemptor 0 spends PDB 0's last budget; preemptor 1 then finds node
    # 1's pod of that PDB violating and takes node 2 (node 1 without it)
    pods = [(0, 9_000, 1_000, 0, False), (1, 9_000, 1_000, 0, False),
            (2, 9_000, 2_000, -1, False)]
    for first_active, want in ((True, [0, 2]), (False, [-1, 1])):
        state, sched, ch = k5_tiny(
            device, [10_000] * 3, pods,
            [(5_000, 9_000, (0,)), (5_000, 9_000, (1, 2))], [1])
        ch["active"][0] = first_active
        cases.append(held_k5(device, state, sched, ch,
                             f"pdb_flip_{first_active}"))
        check(cases[-1]["nodes_out"][:2] == want,
              "a PDB budget spent by one preemptor flips the next choice")
    # one PostFilter's calls on the rows they carry
    state, sched, ch = k5_problem(164, 10_240, 100_000, device, c=16)
    cases.append(held_k5_carried(device, state, sched, ch, "carried"))

    k6_cases = [held_k6(device, f"one_quota_{long_quota}",
                        *k6_problem(161, long_quota, 1, device,
                                    runtime_frac=0.3), reps=3)]
    # hopeless: a non-preemptible pod alone overshoots runtime
    sched, used, runtime, checked, pdb = k6_problem(162, 4_000, 4, device)
    nonp = sched.non_preemptible.clone()
    quota = sched.quota_id
    first = int(torch.nonzero(quota == 0)[0])
    nonp[first] = True
    req = sched.requests.clone()
    req[first, CPU] = 1_000_000
    used[0, CPU] += 1_000_000
    runtime[0, CPU] = 500_000
    for blocked in (True, False):
        pdb_id = torch.where(quota == 0, -1, sched.pdb_id)
        if blocked:
            pdb_id[int(torch.nonzero((quota == 0) & ~nonp)[0])] = 0
        s = sched.replace(non_preemptible=nonp, requests=req, pdb_id=pdb_id)
        k6_cases.append(held_k6(device, f"hopeless_blocked_{blocked}", s,
                                used, runtime, checked, pdb))
    from koordinator_tpu_torch.quota.overuse_revoke import overuse_lists

    _, offsets, _ = overuse_lists(s, used.shape[0], pdb)
    check(k6_cases[-1]["revoked_in_quota_0"] == int(offsets[1] - offsets[0]),
          "a hopeless quota with no blocked pod loses every candidate")
    check(k6_cases[-2]["revoked_in_quota_0"] == 0,
          "a hopeless quota with a blocked pod is skipped")
    # phase 1's stop at lane 0, at lane 31, past the end
    for n_pods, removed, blocked in ((100, 64, False), (100, 63, False),
                                     (96, 95, False), (100, None, False),
                                     (96, None, True)):
        k6_cases.append(held_k6(
            device, f"stop_{n_pods}_{removed}_{blocked}",
            *k6_stop_problem(n_pods, removed, device, blocked=blocked)))
        want = (removed if removed is not None
                else n_pods if blocked else n_pods + 1)
        check(k6_cases[-1]["walks"][0] == want,
              f"K6's walk stops after {want} pods")
    emit("preempt_edges", k5=cases, k6=k6_cases,
         seconds=time.perf_counter() - t_start)
    return k6_cases[0]


N_PREEMPT_ARRIVALS = 1_200
N_PREEMPT_GANGS = 8
N_PREEMPT_NEVER = 16
N_PDBS = 32
PREEMPT_FILL = 0.95
#: round 1 at t = 0, round 2 at 1 s, round 3 past the 5 s revoke delay
PREEMPT_TIMES = (0.0, 1.0, 20.0)
#: leaf 0's weight (its max) as a multiple of its used: it lends its share
#: until its demand rises in round 3
LEND_FACTOR = 2.5


def preempt_specs(seed: int = 15, n_nodes: int = 10_240):
    """Phase 15's cluster: the flagship nodes filled to PREEMPT_FILL of
    their cpu and memory with bound pods of the flagship's pod ranges
    (each node takes 96 drawn pods in turn while they fit, ~18 a node):
    70% koord-batch (5000-5999), 20% koord-mid (7000-7999),
    10% koord-prod (9000-9999, non-preemptible); 80% in the 16 leaf quotas;
    32% labelled app=app-<k> for one of N_PDBS PDBs (~1% each), the rest
    app=svc-<k>.  Returns (nodes, bound pods as (PodSpec, node name), the
    leaves' used cpu, PDB budgets)."""
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    nodes, _ = main_path_specs(seed, n_nodes, 1)
    rng = np.random.default_rng(seed + 1)
    alloc = np.stack([n.allocatable for n in nodes]).astype(np.int64)
    draw = 96
    cpu = rng.integers(100, 4_000, (n_nodes, draw))
    mem = rng.integers(128, 8_192, (n_nodes, draw))
    # each node takes the drawn pods in turn while they fit both dims
    keep = np.zeros((n_nodes, draw), bool)
    room = PREEMPT_FILL * alloc[:, [CPU, MEM]]
    for k in range(draw):
        fits = (cpu[:, k] <= room[:, 0]) & (mem[:, k] <= room[:, 1])
        keep[:, k] = fits
        room[fits, 0] -= cpu[fits, k]
        room[fits, 1] -= mem[fits, k]
    node_of, slot = np.nonzero(keep)
    v = len(node_of)
    band = rng.random(v)
    pri = np.where(band < 0.7, rng.integers(5_000, 6_000, v),
                   np.where(band < 0.9, rng.integers(7_000, 8_000, v),
                            rng.integers(9_000, 10_000, v)))
    leaf = rng.integers(0, N_LEAVES, v)
    in_quota = rng.random(v) < 0.8
    app = rng.integers(0, 100, v)
    bound, used = [], np.zeros(N_LEAVES, np.int64)
    for i in range(v):
        req = np.zeros(R, np.int32)
        req[CPU], req[MEM] = cpu[node_of[i], slot[i]], mem[node_of[i], slot[i]]
        q = f"leaf-{leaf[i]}" if in_quota[i] else None
        if q is not None:
            used[leaf[i]] += int(req[CPU])
        label = (f"app-{app[i]}" if app[i] < N_PDBS else f"svc-{app[i]}")
        bound.append((PodSpec(name=f"bound-{i}", requests=req,
                              priority=int(pri[i]), quota=q,
                              non_preemptible=bool(pri[i] >= 9_000),
                              labels={"app": label}),
                       nodes[node_of[i]].name))
    budgets = rng.integers(0, 9, N_PDBS)
    return nodes, bound, used, budgets


def preempt_tree(nodes, leaf_used):
    """root -> 4 parents -> 16 leaves on cpu: a parent's max the sum of its
    leaves' used, a leaf's min half its used and its max (its weight)
    twice, LEND_FACTOR times for leaf-0, which so lends the share it does
    not use to its siblings."""
    from koordinator_tpu_torch.quota.tree import QuotaTree

    total = np.sum([n.allocatable for n in nodes], axis=0).astype(np.int64)
    tree = QuotaTree(total)
    per = N_LEAVES // N_PARENTS
    for i in range(N_PARENTS):
        mx = np.full(R, -1, np.int64)
        mx[CPU] = int(leaf_used[i * per:(i + 1) * per].sum())
        tree.add(f"parent-{i}", np.zeros(R, np.int64), mx)
        for j in range(i * per, (i + 1) * per):
            mn = np.zeros(R, np.int64)
            mn[CPU] = int(leaf_used[j]) // 2
            leaf_mx = np.full(R, -1, np.int64)
            leaf_mx[CPU] = int(leaf_used[j] * (LEND_FACTOR if j == 0 else 2))
            tree.add(f"leaf-{j}", mn, leaf_mx, parent=f"parent-{i}")
    return tree


def preempt_arrivals(rng, count: int, n_gangs: int, n_never: int):
    """The koord-prod arrivals (9000-9999): 60% in the leaf quotas, cpu
    8,000-16,000 and memory 8,192-16,384 (more than a filled node has free
    on one of them: its slack is 5% of the dim it filled), ``n_gangs``
    gangs of
    8-16 members at the top priorities (they take the job path first),
    ``n_never`` with preemptionPolicy Never.  Returns (pods, gangs as
    (name, size))."""
    from koordinator_tpu_torch.scheduler.snapshot import PodSpec

    out, gangs = [], []
    sizes = rng.integers(8, 17, n_gangs)
    gang_of = np.full(count, -1)
    at = 0
    for g, size in enumerate(sizes):
        gang_of[at:at + size] = g
        gangs.append((f"prod-gang-{g}", int(size)))
        at += size
    never = set(rng.choice(np.arange(at, count), n_never, replace=False)
                .tolist())
    for j in range(count):
        req = np.zeros(R, np.int32)
        req[CPU] = rng.integers(8_000, 16_000)
        req[MEM] = rng.integers(8_192, 16_384)
        g = int(gang_of[j])
        prio = (9_990 + g) if g >= 0 else int(rng.integers(9_000, 9_990))
        q = (f"leaf-{rng.integers(0, N_LEAVES)}" if rng.random() < 0.6
             else None)
        out.append(PodSpec(
            name=f"prod-{j}", requests=req, priority=prio, quota=q,
            gang=gangs[g][0] if g >= 0 else None, creation=float(j),
            preemption_policy="Never" if j in never
            else "PreemptLowerPriority"))
    return out, gangs


def k5_ops(rows: int, cands: int, nodes: int, dims: int,
           victims: int) -> int:
    """K5's int32 operations for one preemptor that requests ``dims`` of
    the R dimensions: the candidate test (6) on each of the ``rows`` live
    rows of the ``nodes`` it can take; each of those rows' ``cands``
    candidates' PDB rank and violating test (6), freed sum (``dims``) and
    reprieve step (4 ``dims`` + 4); each such node's fit, record and choice
    (4 ``dims`` + 13); each victim's commit (2R + 1: node accounting,
    quota, PDB).  A dimension requested 0 of fits whatever is left, and a
    node the preemptor cannot take is never chosen."""
    return (rows * 6 + cands * (5 * dims + 10) + nodes * (4 * dims + 13)
            + victims * (2 * R + 1))


def k5_bound(rec, state, sched) -> dict:
    """K5's bound over a recorded chain, counting what this run's data
    needs, each input byte read once and each output byte written once for
    the whole chain.  Bytes in: every row's validity; each live row's node,
    priority, quota, PDB id and preemptibility, and its request on the
    dimensions some preemptor requests (each victim's others for the
    commit); the nodes' validity and their allocatable and requested rows
    on those dimensions; the preemptors' requests, priorities, quotas,
    feasible rows and flags; the PDB budgets and the (Q, R) base headroom.
    Bytes out: the (C, V) victim mask, the nodes, the node accounting, the
    valid rows, the budgets and the (Q, R) assumed quota.  Operations:
    k5_ops for each active preemptor over the carry it saw, on the nodes it
    can take (feasible and valid) only.  Beside it, the floor of dependent
    steps: for each active preemptor its busiest such node's reprieve walk
    (the most candidates on one node), plus one handoff (arrive, choose,
    commit, wake) a preemptor."""
    import torch

    from koordinator_tpu_torch.ops.preemption import candidates

    args, out = rec
    reqs, pris, qids, feas, same_q, active = args[2:8]
    n, v, r = state.capacity, sched.capacity, R
    c = int(reqs.shape[0])
    q = int(args[9].shape[0]) if args[9] is not None else 1
    b = int(args[8].shape[0])
    bound_row = sched.node >= 0
    safe = torch.clamp(sched.node, min=0).long()
    takeable = feas.bool() & state.node_valid.bool()[None, :]
    requested_dims = (reqs != 0).sum(dim=1).tolist()
    used_dims = int((reqs != 0).any(dim=0).sum())
    valid = sched.valid.clone()
    ops, walks = 0, []
    rows_t, cands_t, nodes_t = [], [], []
    for j in range(c):
        if not bool(active[j]):
            continue
        on = takeable[j][safe] & bound_row
        live = valid & on
        cand = candidates(sched.replace(valid=valid), pris[j], qids[j],
                          same_q[j]) & on
        per_node = torch.zeros(n, dtype=torch.int64, device=cand.device)
        per_node.index_add_(0, safe, cand.to(torch.int64))
        walks.append(int(per_node.max()))
        rows_t.append(int(live.sum()))
        cands_t.append(int(cand.sum()))
        nodes_t.append(int(takeable[j].sum()))
        ops += k5_ops(rows_t[-1], cands_t[-1], nodes_t[-1],
                      requested_dims[j], int(out.victims[j].sum()))
        valid &= ~out.victims[j]
    live_rows = int((sched.valid & bound_row).sum())
    n_victims = int(out.victims.sum())
    bytes_in = (v + live_rows * (4 * 4 + 1 + used_dims * 4)
                + n_victims * (r - used_dims) * 4
                + n * (2 * used_dims * 4 + 1)
                + c * (r * 4 + 4 + 4 + n + 2) + b * 4 + q * r * 4)
    bytes_out = c * v + c * 4 + n * r * 4 + v + b * 4 + q * r * 4
    nbytes = bytes_in + bytes_out
    ms, by = bound(nbytes, ops)
    return dict(bound_ms=ms, bound_by=by, bytes=nbytes, ops=ops,
                rows_mean=float(np.mean(rows_t)) if rows_t else 0.0,
                candidates_mean=float(np.mean(cands_t)) if cands_t else 0.0,
                nodes_mean=float(np.mean(nodes_t)) if nodes_t else 0.0,
                dims_mean=float(np.mean(requested_dims)),
                floor_steps=sum(walks) + c,
                busiest_walk_max=max(walks, default=0))


def k6_bound(sched, used, walk) -> dict:
    """K6's bound: each row's quota, validity, preemptibility, priority
    and PDB read once (the candidate lists), each walked pod's request
    read once a phase, the (Q, R) used, runtime and checked rows, the
    (V,) mask written; a phase-1 step 2R + 2 operations, a phase-2 step
    3R + 2, a row 5."""
    v, q = sched.capacity, used.shape[0]
    steps = int(walk.sum())
    nbytes = v * (4 + 1 + 1 + 4 + 4) + 2 * steps * R * 4 + q * R * 9 + v
    ops = v * 5 + steps * (2 * R + 2 + 3 * R + 2)
    ms, by = bound(nbytes, ops)
    return dict(bound_ms=ms, bound_by=by, bytes=nbytes, ops=ops,
                walk_steps=steps)


def phase_preemption(device, n_nodes: int = 10_240,
                     n_arrivals: int = N_PREEMPT_ARRIVALS,
                     n_gangs: int = N_PREEMPT_GANGS, reps: int = 3,
                     one_quota: dict | None = None):
    """Phase 15: preemption behind ElasticQuota through the Scheduler.  The
    flagship cluster filled to 95% of its cpu through ``add_bound_pods``
    (preempt_specs; the leaves' used set as their ElasticQuota status
    reports it), 32 PDBs, the 16-leaf tree (preempt_tree), the overuse
    revoke on (5 s delay); 1,200 koord-prod arrivals (preempt_arrivals).
    Round 1 (t = 0) runs PostFilter at the 1,024 cap: the gang jobs
    (preempt_one) first, then chains of 256 single preemptors (K5 through
    preempt_chain); round 2 (t = 1) binds the nominations and preempts for
    what is left; round 3 (t = 20) first raises leaf-0's demand (100
    pending pods that never preempt), which shrinks its siblings' runtime
    under their used, and the QuotaRevoke phase runs K6 over every bound
    pod.  After each round no node is over its allocatable, the node
    accounting equals the bound pods' and the nominations' requests, and
    every PDB's budget is its start less the evictions it covered.  Every
    K5 chain and preempt_one call of the rounds and the K6 call are held
    against their plain versions on their recorded inputs; K5 launches once
    a chain and once a preempt_one.  Every round's Diagnose runs K7 and is
    checked against the plain path (checked_diagnose), and K7 is held
    against its plain version on round 1's failed rows.  ``one_quota``,
    the K6 record of phase_preempt_edges' one quota of 50,000 pods, is
    printed beside round 3's.  Returns (K5's and K6's kernel entries, the
    round records, K7's numbers at round 1)."""
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels import overuse_revoke as k6
    from koordinator_tpu_torch.kernels import preemption as k5
    from koordinator_tpu_torch.ops import preemption as ops
    from koordinator_tpu_torch.quota import overuse_revoke as orv
    from koordinator_tpu_torch.scheduler import scheduler as smod
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        PodSpec,
    )

    t_start = time.perf_counter()
    nodes, bound, leaf_used, budgets = preempt_specs(15, n_nodes)
    snap = ClusterSnapshot(capacity=n_nodes, device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    evicted, revoked = [], []
    sched = smod.Scheduler(
        snap, quota_tree=preempt_tree(nodes, leaf_used), device=device,
        clock=lambda: now[0],
        preempt_fn=lambda v, by: evicted.append((v, by)))
    sched.enable_overuse_revoke(lambda p, q: revoked.append((p, q)),
                                delay_evict_sec=5.0)
    for k in range(N_PDBS):
        sched.register_pdb(smod.PdbRecord(
            name=f"pdb-{k}", selector={"app": f"app-{k}"},
            allowed=int(budgets[k])))
    t0 = time.perf_counter()
    sched.add_bound_pods([smod.BoundPod(pod, name,
                                        snap.node_generation[name])
                          for pod, name in bound])
    for name, q in sched.quota_tree.nodes.items():
        q.used = np.zeros(R, np.int64)
        q.non_preemptible_used = np.zeros(R, np.int64)
    for bp in sched.bound.values():
        sched._charge_quota_used(bp, sign=1)
    seed_s = time.perf_counter() - t0
    rng = np.random.default_rng(151)
    arrivals, gangs = preempt_arrivals(rng, n_arrivals, n_gangs,
                                       N_PREEMPT_NEVER)
    for name, size in gangs:
        sched.register_gang(smod.GangRecord(name=name, min_member=size))
    sched.enqueue_many(arrivals)
    start_budgets = {n: r.allowed for n, r in sched.pdbs.items()}
    labels = {pod.name: pod.labels for pod, _ in bound}

    # record the kernels' calls: the chains, the gang members' preempt_one
    # and the revoke walk, with their outputs
    chains, ones, walks = [], [], []
    real_chain, real_one = smod.preempt_chain, smod.preempt_one
    real_sel = orv.select_overuse_victims

    def rec_chain(*a):
        out = real_chain(*a)
        chains.append((a, out))
        return out

    def rec_one(*a, **kw):
        out = real_one(*a, **kw)
        ones.append((a, kw, out))
        return out

    def rec_sel(*a):
        out = real_sel(*a)
        walks.append((a, out))
        return out

    post_ms: list[float] = []
    real_post = sched._run_preemption

    def timed_post(*a):
        sync(device)
        t1 = time.perf_counter()
        real_post(*a)
        sync(device)
        post_ms.append((time.perf_counter() - t1) * 1e3)

    sched._run_preemption = timed_post
    smod.preempt_chain, smod.preempt_one = rec_chain, rec_one
    orv.select_overuse_victims = rec_sel
    records, launches, dlog = [], {}, []
    try:
        for rnd, t in enumerate(PREEMPT_TIMES):
            now[0] = t
            if rnd == 2:
                demand = leaf_used[0] * 3 // 10 // 100
                sched.enqueue_many([PodSpec(
                    name=f"leaf0-demand-{j}",
                    requests=np.array([demand, 1_024] + [0] * (R - 2),
                                      np.int32),
                    priority=3_000, quota="leaf-0", creation=1e6 + j,
                    preemption_policy="Never") for j in range(100)])
            n_evicted, n_revoked = len(evicted), len(revoked)
            n_chains, n_ones = len(chains), len(ones)
            post_ms.clear()
            nominated_before = set(sched.nominations)
            n_diag = len(dlog)
            build.reset_launch_counts()
            with checked_diagnose(dlog):
                sync(device)
                t1 = time.perf_counter()
                res = sched.schedule_round()
                sync(device)
                wall = time.perf_counter() - t1
            launches[rnd] = dict(build.LAUNCHES)
            diag = diagnose_fields(dlog[n_diag:])
            wall -= diag["diagnose_check_s"]
            check(launches[rnd]["explain_counts"]
                  == (1 if res.failures else 0),
                  f"phase 15 round {rnd}: Diagnose launched K7")
            round_chains = [int(a[2].shape[0]) for a, _ in chains[n_chains:]]
            k5_calls = len(round_chains) + len(ones) - n_ones
            rec = dict(
                round=rnd, t=t, wall_s=wall,
                postfilter_ms=sum(post_ms), binds=len(res.assignments),
                nominated_binds=sum(1 for n in res.assignments
                                    if n in nominated_before),
                failed=len(res.failures),
                preemptors_tried=sum(round_chains) + len(ones) - n_ones,
                nominated=len(res.nominations),
                evicted=len(evicted) - n_evicted,
                revoked=len(revoked) - n_revoked, chains=round_chains,
                k5_calls=k5_calls,
                launches={k: launches[rnd][k] for k in (
                    "victim_select", "overuse_revoke", "explain_counts")},
                **diag)
            check(launches[rnd]["victim_select"] == k5_calls,
                  f"round {rnd} launched K5 once a chain and once a "
                  "preempt_one")
            rec.update(preempt_checks(sched, start_budgets, labels, evicted,
                                      revoked, f"phase 15 round {rnd}"))
            records.append(rec)
            emit("preempt_round", **rec)
    finally:
        smod.preempt_chain, smod.preempt_one = real_chain, real_one
        orv.select_overuse_victims = real_sel
        sched._run_preemption = real_post
    check(records[0]["nominated"] > 0 and records[0]["evicted"] > 0,
          "round 1 preempted")
    check(launches[0]["victim_select"] > 0, "round 1 launched K5")
    check(records[1]["nominated_binds"] > 0, "round 2 bound nominations")
    check(launches[2]["overuse_revoke"] > 0 and records[2]["revoked"] > 0,
          "round 3 ran K6 and revoked")
    check(dlog[0]["call"] is not None, "round 1's Diagnose ran K7")
    k7 = held_k7(device, dlog[0]["call"], "at phase 15's round 1")
    k7["launches"] = sum(r["explain_counts"] for r in launches.values())

    # every chain and preempt_one call against the plain versions
    chain_errs, chain_plain_ms = [], []
    for args, out in chains:
        t1 = time.perf_counter()
        want = ops.preempt_chain_plain(*args)
        sync(device)
        chain_plain_ms.append((time.perf_counter() - t1) * 1e3)
        chain_errs.append(chain_err(out, want))
    one_err = 0
    for args, kw, out in ones:
        want = ops.preempt_one_plain(*args, **kw)
        one_err = max(one_err, max_abs_err(out.node, want.node),
                      max_abs_err(out.victims, want.victims),
                      max_abs_err(out.state.node_requested,
                                  want.state.node_requested),
                      max_abs_err(out.sched.valid, want.sched.valid),
                      max_abs_err(out.pdb_allowed, want.pdb_allowed))
    err5 = max(chain_errs + [one_err])
    check(err5 == 0, "every K5 call of phase 15 equals its plain version")
    check(len(chains) > 0 and len(ones) > 0,
          "phase 15 ran chains and gang jobs")
    # K5 timed on round 1's first full chain, on the node-ordered rows the
    # PostFilter carried (its later chains' case); the kernel's device time
    # within the chain from the profiler's trace; the rows' build apart
    full = max(range(len(chains)), key=lambda i: chains[i][0][2].shape[0])
    args, out = chains[full]
    c = int(args[2].shape[0])
    k5_ms = timed_ms(lambda: k5.preempt_chain_kernel(*args), device,
                     reps=reps)
    k5_dev = device_ms_by_kernel(lambda: k5.preempt_chain_kernel(*args),
                                 ("preempt_chain_kernel",), device)
    csr_ms = timed_ms(lambda: k5.VictimCSR(args[1], n_nodes), device,
                      reps=reps)
    b5 = k5_bound((args, out), args[0], args[1])
    k5_entry = dict(
        name="victim_select", route="cuda", source=CSRC + "victim_select.cu",
        replaces="koordinator_tpu/ops/preemption.py:160",
        launches=sum(r["victim_select"] for r in launches.values()),
        max_abs_err=err5, ms=k5_ms, plain_ms=chain_plain_ms[full],
        bound_ms=b5["bound_ms"], bound_by=b5["bound_by"], library_ms=None,
        preemptors=c, ms_per_preemptor=k5_ms / c,
        device_ms=k5_dev["preempt_chain_kernel"], csr_build_ms=csr_ms,
        floor_steps=b5["floor_steps"],
        us_per_floor_step=k5_ms * 1e3 / b5["floor_steps"])
    # K6 on round 3's call
    check(len(walks) >= 1, "phase 15 called the revoke walk")
    (s6, used6, rt6, ck6, pdb6), revoke6 = walks[-1]
    want6 = orv.select_overuse_victims_plain(s6, used6, rt6, ck6, pdb6)
    err6 = max(max_abs_err(revoke6, want6), held_k6(
        device, "phase15_round3", s6, used6, rt6, ck6, pdb6)["max_abs_err"])
    check(err6 == 0, "K6 equals its plain version at phase 15")
    got6, walk6 = k6.overuse_revoke_launch(s6, used6, rt6, ck6, pdb6)
    k6_ms = timed_ms(lambda: k6.overuse_revoke_launch(s6, used6, rt6, ck6,
                                                      pdb6), device,
                     reps=reps)
    plain6 = timed_ms(lambda: orv.select_overuse_victims_plain(
        s6, used6, rt6, ck6, pdb6), device, reps=1, warmup=0)
    b6 = k6_bound(s6, used6, walk6)
    k6_entry = dict(
        name="overuse_revoke", route="cuda",
        source=CSRC + "overuse_revoke.cu",
        replaces="koordinator_tpu/quota/overuse_revoke.py:32",
        launches=sum(r["overuse_revoke"] for r in launches.values()),
        max_abs_err=err6, ms=k6_ms, plain_ms=plain6,
        bound_ms=b6["bound_ms"], bound_by=b6["bound_by"], library_ms=None,
        longest_walk=int(walk6.max()), walk_steps=b6["walk_steps"])
    if one_quota is not None:
        k6_entry["one_quota_50000"] = {k: one_quota.get(k) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "longest_walk",
            "revoked", "max_abs_err")}
    emit("preemption", nodes=n_nodes, bound=len(bound),
         v_rows=int(s6.capacity), pdbs=N_PDBS, arrivals=n_arrivals,
         gangs=n_gangs, seed_s=seed_s, chains=len(chains),
         chain_sizes=[int(a[2].shape[0]) for a, _ in chains],
         gang_preempt_one_calls=len(ones),
         k5=dict(k5_entry, **{k: b5[k] for k in (
             "bytes", "ops", "rows_mean", "candidates_mean", "nodes_mean",
             "dims_mean", "busiest_walk_max")}),
         k6=dict(k6_entry, **{k: b6[k] for k in ("bytes", "ops")}),
         seconds=time.perf_counter() - t_start)
    return [k5_entry, k6_entry], records, k7


def preempt_checks(sched, start_budgets, labels, evicted, revoked,
                   label) -> dict:
    """No node over its allocatable; the node accounting equals the bound
    pods' and the standing nominations' requests; each PDB's budget is its
    start less the evicted and revoked pods it covers."""
    st = sched.snapshot.state
    requested = st.node_requested.cpu().numpy().astype(np.int64)
    alloc = st.node_allocatable.cpu().numpy().astype(np.int64)
    check(bool((requested <= alloc).all()), f"{label}: no overcommit")
    expect = np.zeros_like(requested)
    for bp in sched.bound.values():
        expect[sched.snapshot.node_index[bp.node]] += bp.requests
    for name, node in sched.nominations.items():
        expect[sched.snapshot.node_index[node]] += sched.pending[
            name].requests
    check(np.array_equal(expect, requested),
          f"{label}: accounting = bound pods + nominations")
    gone = [v for v, _ in evicted] + [p for p, _ in revoked]
    for name, rec in sched.pdbs.items():
        hits = sum(1 for v in gone if rec.matches(labels.get(v, {})))
        check(rec.allowed == start_budgets[name] - hits,
              f"{label}: {name} paid for its evictions")
    return dict(standing_nominations=len(sched.nominations),
                bound=len(sched.bound))



# -- K7: the Diagnose phase's reject-reason count ------------------------------

#: int32 operations of K7's attribution of a (pod, node) pair beyond the
#: Filter's: the first failing reason chosen (2) and counted (1)
EXPLAIN_PAIR_OPS = 3


def clone_state(state):
    """A copy of ``state`` that later rounds cannot write."""
    import dataclasses

    return state.replace(**{f.name: getattr(state, f.name).clone()
                            for f in dataclasses.fields(state)})


@contextlib.contextmanager
def checked_diagnose(log: list):
    """Hold every round's Diagnose against the plain path: the round runs
    it as it would (K7 on the card), timed; then K7's counts are held
    against its plain version on the same inputs, exactly, and the plain
    failures derived from the plain counts (``diagnosis_from_counts`` and
    the post-solve quota blame, as ``Scheduler._diagnose`` states them)
    must equal the round's ``result.failures`` field by field
    (``dataclasses.asdict``).  ``log`` gets a record a Diagnose: its host
    ms and those of its parts (``last_diagnose_parts_s``), the seconds the
    check took (to take off the round's wall), K7's calls, the rows of
    the last and its inputs (a copy of the state, made after the timed
    run)."""
    import dataclasses

    from koordinator_tpu_torch.kernels import explain_counts as k7
    from koordinator_tpu_torch.ops import explain as ex
    from koordinator_tpu_torch.quota.admission import quota_admission_mask
    from koordinator_tpu_torch.scheduler.diagnosis import (
        diagnosis_from_counts,
    )
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    real_diagnose, real_counts = Scheduler._diagnose, ex.explain_counts

    def diagnose(self, pods, batch, a, quota, new_quota, placed_gangs, now,
                 result):
        calls = []
        fail_rows = [i for i, pod in enumerate(pods)
                     if int(a[i]) < 0 and pod.name not in result.assignments]

        def kernel(state, small, cfg):
            out = real_counts(state, small, cfg)
            calls.append(((state, small, cfg), out))
            return out

        ex.explain_counts = kernel
        try:
            real_diagnose(self, pods, batch, a, quota, new_quota,
                          placed_gangs, now, result)
        finally:
            ex.explain_counts = real_counts
        t0 = time.perf_counter()
        check(len(calls) == (1 if self.explain and fail_rows else 0),
              "Diagnose counted once a round with a failure")
        err = 0
        if calls:
            (state, small, cfg), (c, f) = calls[0]
            calls[0] = ((clone_state(state), small, cfg), (c, f))
            pc, pf = k7.explain_counts_plain(state, small, cfg)
            err = max(max_abs_err(c, pc), max_abs_err(f, pf))
            check(err == 0, "K7 equals its plain version in the round")
            admitted = None
            if quota is not None:
                admitted = quota_admission_mask(
                    new_quota if new_quota is not None else quota,
                    batch.requests, batch.quota_id,
                    batch.non_preemptible).cpu().numpy()
            pc, pf = pc.cpu().numpy(), pf.cpu().numpy()
            total_nodes = len(self.snapshot.node_index)
            want, got = {}, {}
            for j, i in enumerate(fail_rows):
                d = diagnosis_from_counts(pc[j], int(pf[j]), total_nodes)
                if (admitted is not None and not admitted[i]
                        and d.feasible_nodes > 0):
                    d.reason_counts["quota"] = d.feasible_nodes
                    d = dataclasses.replace(d, quota_rejected=True,
                                            feasible_nodes=0)
                name = pods[i].name
                want[name] = dataclasses.asdict(d)
                got[name] = dataclasses.asdict(result.failures[name])
            check(got == want, "the round's failures equal the plain "
                  "path's, field by field")
        log.append(dict(
            diagnose_ms=self.last_diagnose_s * 1e3,
            parts_ms={k: v * 1e3
                      for k, v in self.last_diagnose_parts_s.items()},
            check_s=time.perf_counter() - t0,
            failed=len(fail_rows), k7_calls=len(calls), max_abs_err=err,
            rows=int(calls[-1][0][1].valid.sum()) if calls else 0,
            call=calls[-1][0] if calls else None))

    Scheduler._diagnose = diagnose
    try:
        yield
    finally:
        Scheduler._diagnose = real_diagnose


def failure_docs(result) -> dict:
    """A round's failures, each diagnosis as a dict of its fields."""
    import dataclasses

    return {n: dataclasses.asdict(d) for n, d in result.failures.items()}


def diagnose_fields(entries: list) -> dict:
    """A round's Diagnose records (checked_diagnose) as round-record
    fields."""
    parts: dict[str, float] = {}
    for e in entries:
        for k, v in e["parts_ms"].items():
            parts[k] = parts.get(k, 0.0) + v
    return dict(diagnose_ms=sum(e["diagnose_ms"] for e in entries),
                diagnose_parts_ms=parts,
                k7_rows=sum(e["rows"] for e in entries),
                diagnose_check_s=sum(e["check_s"] for e in entries))


def k7_bound(state, pods, cfg) -> dict:
    """K7's bound: the Filter over every (valid pod, node row) pair
    (filter_ops over the valid nodes) and each pair's reason chosen and
    counted (EXPLAIN_PAIR_OPS), against the bytes it must move once: the
    node rows' allocatable, requested and threshold usage, validity and
    class; the pods' requests, estimates, validity and selector rows (or
    dense mask); the (P, 16) counts and (P,) feasible out."""
    p_valid = int(pods.valid.sum())
    n, p = state.capacity, pods.capacity
    ops = (filter_ops(cfg, pods.requests[pods.valid],
                      state.node_allocatable[state.node_valid])
           + p_valid * n * EXPLAIN_PAIR_OPS)
    mask = (pods.selector_mask if pods.selector_mask is not None
            else pods.feasible)
    nbytes = (3 * n * R * 4 + n + 4 * n + 2 * p * R * 4 + p + mask.numel()
              + p * 17 * 4)
    bound_ms, by = bound(nbytes, ops)
    return dict(bound_ms=bound_ms, bound_by=by, ops=ops, bytes=nbytes)


def k7_launch_plan(pods, n: int, label: str) -> dict | None:
    """K7's last launch held to its plan: the pod bound the kernel found
    is the last valid pod row + 1, and each CTA's recorded range is
    explain_plan's on the grid launched.  The plan (the CTAs the card
    holds at once, grid, blocks, tiles, pairs); None off the card."""
    import torch

    from koordinator_tpu_torch.kernels import explain_counts as k7

    if pods.requests.device.type != "cuda":
        return None
    launch = k7.LAST_LAUNCH
    rec = launch["record"].cpu().numpy()
    valid = torch.nonzero(pods.valid).flatten()
    p_eff = int(valid[-1]) + 1 if valid.numel() else 0
    check(int(rec[0]) == p_eff, f"K7 found the last valid pod ({label})")
    plan = k7.explain_plan(p_eff, n, launch["grid"])
    check(np.array_equal(rec[1::2], plan["start"])
          and np.array_equal(rec[2::2], plan["stop"]),
          f"K7's CTAs walked explain_plan's ranges ({label})")
    return dict(resident=launch["resident"], grid=launch["grid"],
                blocks=plan["blocks"], tiles=plan["tiles"],
                work=plan["work"])


def held_k7(device, call, label: str, reps: int = 5) -> dict:
    """K7 against its plain version on a recorded call (state, pods, cfg),
    exactly, and its launch held to its plan (k7_launch_plan); its
    wrapper's time, its count kernel's device time and the node-column
    packing's apart, the plain version's time, the bound and the plan."""
    from koordinator_tpu_torch.kernels import explain_counts as k7

    state, pods, cfg = call
    got = k7.explain_counts(state, pods, cfg)
    plan = k7_launch_plan(pods, state.capacity, label)
    sync(device)
    t0 = time.perf_counter()
    want = k7.explain_counts_plain(state, pods, cfg)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    check(err == 0, f"K7 equals its plain version {label}")
    ms = timed_ms(lambda: k7.explain_counts(state, pods, cfg), device,
                  reps=reps)
    dev = device_ms_by_kernel(lambda: k7.explain_counts(state, pods, cfg),
                              ("explain_counts_kernel", "pack_explain_columns",
                               "pack_selector_words"), device)
    out = dict(label=label, rows=int(pods.valid.sum()),
               capacity=pods.capacity, nodes=state.capacity,
               classes=(None if pods.selector_mask is None
                        else pods.selector_mask.shape[1]),
               max_abs_err=err, ms=ms,
               device_ms=dev["explain_counts_kernel"],
               pack_ms=sum(v or 0.0 for k, v in dev.items()
                           if k != "explain_counts_kernel") or None,
               plain_ms=plain_ms, library_ms=None, plan=plan,
               **k7_bound(state, pods, cfg))
    emit("k7", **out)
    return out


def k7_partition(counts, feasible, pods, n: int) -> bool:
    """A valid pod's node rows counted once each (feasible + the node
    reasons == N); invalid pod rows all zero."""
    from koordinator_tpu_torch.ops.explain import REASON_QUOTA

    total = feasible.long() + counts[:, :REASON_QUOTA].long().sum(1)
    valid = pods.valid
    return bool((total[valid] == n).all()) and bool(
        (total[~valid] == 0).all()) and bool(
        (counts[:, REASON_QUOTA:] == 0).all())


def dims_problem(seed: int, n_nodes: int, n_pods: int, device,
                 p_request: float = 0.5):
    """(ClusterState, PodBatch) with every dimension allocatable on most
    nodes and each pod requesting each dimension with probability
    ``p_request`` (so the pods of one warp and one CTA request different
    sets), 8 selector classes."""
    from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

    rng = np.random.default_rng(seed)
    alloc = rng.integers(1_000, 64_000, (n_nodes, R)).astype(np.int32)
    alloc[rng.random((n_nodes, R)) < 0.05] = 0
    usage = (alloc * rng.random((n_nodes, R)) * 0.9).astype(np.int32)
    requested = (alloc * rng.random((n_nodes, R)) * 0.9).astype(np.int32)
    node_class = rng.integers(0, 9, n_nodes).astype(np.int32)
    req = rng.integers(1, 12_000, (n_pods, R)).astype(np.int32)
    req[rng.random((n_pods, R)) >= p_request] = 0
    state = ClusterState.from_arrays(alloc, requested=requested, usage=usage,
                                     agg_usage=usage, capacity=n_nodes,
                                     node_class=node_class, device=device)
    pods = PodBatch.build(
        req, node_capacity=n_nodes, device=device,
        selector_mask=rng.random((n_pods, 8)) < 0.8, class_capacity=8)
    return state, pods


class GridCap:
    """The kernel library with K7's resident CTAs reported as ``grid``, so
    that the wrapper launches that grid (every other call passes
    through)."""

    def __init__(self, lib, grid: int):
        self._lib, self._grid = lib, grid

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def koord_explain_counts_resident(self, c, dense, cfg, cfg_len):
        return self._grid


#: the most selector classes K7 tables a warp at a time
#: (csrc/explain_counts.cu kTableClasses): the edges at it and one past
K7_TABLE_CLASSES = 4_094


def phase_explain_edges(device) -> None:
    """K7 against its plain version on its edges: one pod; 45 pods over
    1,000 nodes (no multiple of a warp's pods, a CTA's or a tile's); 65
    selector classes (two words); a dense mask; the aggregated thresholds
    and every scoring term; requests of 0 against a negative free; every
    node infeasible; padded node rows; invalid pod rows; 4,094 and 4,095
    classes (the largest tabled selector and the first past it); pods of
    one warp and CTA requesting different dimension sets; pods requesting
    all 10; thresholds on all 10; requests of 0 on every dimension; 100
    pods over 5,001 nodes on a grid of 3 CTAs (ranges that cross blocks
    mid-block and end mid-tile); one pod over 65,536 nodes; one pod over
    20,000 nodes that all fail on cpu on a grid of 1 (a lane's 8-bit field
    would reach 625 without its flush every kFlushTiles tiles), and 100
    pods so on the same grid (a flush at each block's change).  Each
    launch is held to its plan (k7_launch_plan)."""
    import torch

    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels import explain_counts as k7
    from koordinator_tpu_torch.kernels.select_candidates import _pod_rows

    def dev(a):
        return to_dev(a, device)

    cases = []
    # rows cut to the pods' own count (a batch pads to 64 rows at least)
    st, pods = random_problem(71, 10_240, 1, device, "classes")
    cases.append(("one_pod", st, _pod_rows(pods, 0, 1), "default"))
    st, pods = random_problem(72, 1_000, 45, device, "classes")
    cases.append(("45_pods_1000_nodes", st, _pod_rows(pods, 0, 45),
                  "default"))
    st, pods = class_problem(73, 4_096, 2_048, 65, device)
    cases.append(("c65", st, pods, "default"))
    st, pods = class_problem(86, 2_048, 512, K7_TABLE_CLASSES, device)
    cases.append(("c4094_tabled", st, pods, "default"))
    st, pods = class_problem(87, 2_048, 512, K7_TABLE_CLASSES + 1, device)
    cases.append(("c4095_past_the_table", st, pods, "default"))
    st, pods = random_problem(74, 3_000, 512, device, "dense")
    cases.append(("dense", st, pods, "default"))
    st, pods = random_problem(75, 4_096, 1_024, device, "classes")
    cases.append(("agg", st, pods, "agg"))
    cases.append(("everything", st, pods, "everything"))
    # a third of the nodes with requested over allocatable on memory, 40%
    # of the pods requesting no memory
    rng = np.random.default_rng(76)
    st, pods = random_problem(76, 4_096, 1_024, device, "classes")
    requested = st.node_requested.cpu().numpy().copy()
    over = rng.random(4_096) < 0.3
    requested[over, MEM] = st.node_allocatable.cpu().numpy()[over, MEM] + 1
    req = pods.requests.cpu().numpy().copy()
    req[rng.random(pods.capacity) < 0.4, MEM] = 0
    cases.append(("zero_request_negative_free",
                  st.replace(node_requested=dev(requested)),
                  pods.replace(requests=dev(req)), "default"))
    big = req.copy()
    big[:, CPU] = 1 << 24
    cases.append(("all_infeasible", st, pods.replace(requests=dev(big)),
                  "default"))
    nv = np.ones(4_096, bool)
    nv[3_000:] = False
    pv = rng.random(pods.capacity) < 0.7
    cases.append(("padded_nodes_invalid_pods",
                  st.replace(node_valid=dev(nv)),
                  pods.replace(valid=dev(pv)), "default"))
    st, pods = dims_problem(77, 3_001, 256, device)
    cases.append(("mixed_dims_in_a_warp", st, pods, "default"))
    cases.append(("thresholds_on_all_ten", st, pods, "all_ten"))
    st, pods = dims_problem(78, 3_001, 256, device, p_request=1.0)
    cases.append(("requests_on_all_ten", st, pods, "all_ten"))
    cases.append(("zero_requests_everywhere", st,
                  pods.replace(requests=torch.zeros_like(pods.requests)),
                  "all_ten"))
    st, pods = random_problem(79, 5_001, 100, device, "classes")
    cases.append(("grid_3_mid_block", st, _pod_rows(pods, 0, 100), "default",
                  3))
    st, pods = random_problem(80, 65_536, 1, device, "classes")
    cases.append(("one_pod_65536_nodes", st, _pod_rows(pods, 0, 1),
                  "default"))
    st, pods = random_problem(85, 20_000, 100, device, "classes")
    big = pods.requests.cpu().numpy().copy()
    big[:, CPU] = 1 << 24
    pods = pods.replace(requests=dev(big))
    cases.append(("flush_one_pod_grid_1", st, _pod_rows(pods, 0, 1),
                  "default", 1))
    cases.append(("flush_100_pods_grid_1", st, _pod_rows(pods, 0, 100),
                  "default", 1))
    out = []
    real_lib = build.lib
    for label, st, pods, variant, *grid in cases:
        cfg = scoring_config(variant, device)
        if grid and torch.device(device).type == "cuda":
            capped = GridCap(real_lib(), grid[0])
            build.lib = lambda: capped
        try:
            got = k7.explain_counts(st, pods, cfg)
        finally:
            build.lib = real_lib
        plan = k7_launch_plan(pods, st.capacity, label)
        want = k7.explain_counts_plain(st, pods, cfg)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(err == 0, f"K7 equals its plain version ({label})")
        check(k7_partition(got[0], got[1], pods, st.capacity),
              f"K7 counts every node row once ({label})")
        if label == "all_infeasible":
            check(int(got[1].sum()) == 0, "no node feasible")
        if label.startswith("flush_"):
            n_valid = int(st.node_valid.sum())
            fit_cpu = got[0][pods.valid, 1 + CPU]
            check(bool((fit_cpu == n_valid).all()),
                  f"every node counted on cpu past a field's limit ({label})")
        if plan is not None and grid:
            check(plan["grid"] == grid[0], f"K7 ran on the grid asked ({label})")
        out.append(dict(case=label, pods=pods.capacity,
                        nodes=st.capacity, max_abs_err=err,
                        feasible=int(got[1].sum()),
                        counted=int(torch.sum(got[0], dtype=torch.int64)),
                        grid=None if plan is None else plan["grid"]))
    emit("explain_edges", cases=out)


def ptxas_summary(path: str) -> list[dict]:
    """Registers, spills and shared memory of every kernel in the
    compiler's -Xptxas -v log (one entry per compiled entry function)."""
    import re

    out, cur = [], None
    for line in open(path):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(entry=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


#: the kernels' entry functions in the ptxas log, by kernel (K1 and K1a
#: come in twenty instances: one or two strata, one selector word or many,
#: and K1's exact rank, K1a's int32 rank (packed) and K1a's 64-bit rank,
#: the exact and the 64-bit in both key regimes; K2
#: in eight: all but the last; K4 and K4r in eight: the node columns in
#: shared or global memory, without or with reservations, one selector
#: word or many; K7 in four: one selector word, many tabled, many past
#: the table, a dense mask, and its node-column pack)
PTXAS_ENTRIES = {"select_candidates": ("select_candidates_kernel", 20),
                 "refresh_candidates": ("refresh_candidates_kernel", 8),
                 "segmented_prefix_accept": ("round_accept_kernel", 1),
                 "greedy_scan": ("greedy_scan_kernel", 8),
                 "victim_select": ("preempt_chain_kernel", 1),
                 "overuse_revoke": ("overuse_revoke_kernel", 1),
                 "overuse_keys": ("overuse_keys_kernel", 1),
                 "explain_counts": ("explain_counts_kernel", 4),
                 "explain_pack": ("pack_explain_columns", 1)}


def phase_ptxas(path: str) -> None:
    """K1's and K1a's, K2's, K3b's, K4's and K4r's registers and spills,
    from the build's ptxas log: none of them may spill.  With them, the
    CTAs an SM that the card reports for K1 and for K1a's two instances
    (packed regime, two strata, one selector word): K1a's int32 instance
    must reach K1's."""
    from koordinator_tpu_torch.kernels import build

    entries = ptxas_summary(path)
    picked = []
    for kernel, (name, count) in PTXAS_ENTRIES.items():
        found = [dict(e, kernel=kernel) for e in entries
                 if name in e["entry"]]
        check(len(found) >= count, f"ptxas reported {kernel}")
        picked += found
    for e in picked:
        check(e.get("spill_stores", 1) == 0 and e.get("spill_loads", 1) == 0,
              f"no spills in {e['entry']}")
    lib = build.lib()
    ctas = {name: lib.koord_select_candidates_ctas_per_sm(i)
            for i, name in enumerate(("k1", "k1a_int32", "k1a_64bit"))}
    check(ctas["k1a_int32"] > 0 and ctas["k1a_int32"] == ctas["k1"],
          f"K1a's int32 instance reaches K1's CTAs an SM ({ctas})")
    # K7's CTAs an SM by instance (a selector of 8 classes, of 512 tabled,
    # of one past the table; a dense mask) at the default config's two
    # thresholded dims, and at ten
    import torch

    from koordinator_tpu_torch.kernels.select_candidates import _config_vector

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dims, variant in ((2, "default"), (10, "all_ten")):
        cfgv = _config_vector(scoring_config(variant, "cuda"))[0]
        for name, c, dense in (("k7_sel1", 8, 0),
                               ("k7_sel_many", K7_TABLE_CLASSES + 1, 0),
                               ("k7_dense", 1, 1),
                               ("k7_sel_table", 512, 0)):
            ctas[f"{name}_thr{dims}"] = lib.koord_explain_counts_resident(
                c, dense, build.ptr(cfgv), cfgv.numel()) // sms
            check(ctas[f"{name}_thr{dims}"] > 0, f"{name} fits an SM")
    emit("ptxas", ctas_per_sm=ctas, kernels=[dict(
        kernel=e["kernel"], entry=e["entry"], registers=e.get("registers"),
        spill_stores=e.get("spill_stores"), spill_loads=e.get("spill_loads"),
        smem=e.get("smem")) for e in picked])


#: earlier times as PERF.md records them (chip runs on an NVIDIA H100 80GB
#: HBM3 at 700 W), ms at this run's shapes, as (name, label, ms).  The
#: labels: ``e9fcd1c`` K1's and K4's earlier design, a launch;
#: ``bf2978c`` K3b's (one launch a level, one thread walking each run) a
#: launch at the flagship's first round, and K2's (one thread a pod,
#: int64 lists), the wrapper and the device; ``30c463b`` the flagship
#: phases' K1, K2 and K4 before the wide key regime and the selector
#: words (K1 and K2, phases 6 and 7, measured at commit 956bf4b; K4,
#: phase 8's 1,000 pods at f9c866f and phase 9's rescue at 956bf4b);
#: ``398251d`` K1a's 64-bit lists at phase 14's cold batch and K4's and
#: K4r's step before their redesign (K4 at phase 8's 1,000 pods, K4r at
#: phase 11's pre-pass), from profile_torch_round.py --kernels in turns;
#: ``6aa9629`` K5's two launches a preemptor and K6's walk a pod a step
#: (chip_smoke.py's phases 15 and preempt_edges, as PERF.md records them);
#: ``51debd0`` K7's second design (a ballot a reason over all 10 dims)
EARLIER_MS = [
    ("victim_select (phase 15 chain of 256)", "6aa9629",
     [7.33, 7.47, 7.297]),
    ("overuse_revoke (phase 15 round 3)", "6aa9629", [0.969, 1.10, 1.248]),
    ("overuse_revoke (one quota of 50,000 pods)", "6aa9629",
     [14.70, 15.01]),
    ("explain_counts (phase 9 last steady round)", "51debd0",
     [3.811, 3.855, 3.979]),
    ("explain_counts (phase 12 last steady round)", "51debd0",
     [17.456, 17.460, 17.543]),
    ("explain_counts (phase 15 round 1)", "51debd0", [0.461, 0.469, 0.736]),
    ("select_candidates", "e9fcd1c", [25.41, 25.56, 25.51]),
    ("select_candidates", "30c463b", [8.84]),
    ("greedy_scan (rescue)", "e9fcd1c", [24.32]),
    ("greedy_scan (rescue)", "30c463b", [1.16]),
    ("greedy_scan (1,000 pods)", "e9fcd1c", [67.78, 68.41, 67.51, 68.80]),
    ("greedy_scan (1,000 pods)", "30c463b", [5.092, 5.221]),
    ("greedy_scan (1,000 pods)", "398251d", [5.130, 5.083, 5.171]),
    ("reservation_scan (phase 11 pre-pass)", "398251d",
     [10.935, 10.901, 11.243]),
    ("select_candidates_approx (phase 14 cold batch)", "398251d",
     [11.480, 11.391, 11.385]),
    ("segmented_prefix_accept (a launch, node level, first round)",
     "bf2978c", [5.65, 5.77]),
    ("refresh_candidates (wrapper)", "bf2978c", [0.863, 1.082]),
    ("refresh_candidates (wrapper)", "30c463b", [0.497]),
    ("refresh_candidates (device)", "bf2978c", [0.31]),
    ("refresh_candidates (device)", "30c463b", [0.268]),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from koordinator_tpu_torch.kernels import build

    t_start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    device = "cuda"
    global INT32_OPS_PER_S
    INT32_OPS_PER_S = int32_ops_per_s()
    smi = smi_name_power()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         int32_ops_per_s=INT32_OPS_PER_S,
         sms=torch.cuda.get_device_properties(0).multi_processor_count)

    t0 = time.perf_counter()
    ptxas = os.path.join(OUT_DIR, "ptxas.txt")
    build.build(force=True, log_path=ptxas)
    build.lib()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[os.path.basename(s) for s in build.sources()])
    phase_ptxas(ptxas)

    phase_kernels(device)
    phase_k1_edges(device)
    phase_k3b_edges(device)
    phase_solve(device)
    launches, log = phase_main(device)
    kernels, table_k3b = phase_table(device, launches, log)
    k2 = phase_refresh(device, log)
    del log
    k4_1000 = phase_greedy(device)
    phase_greedy_edges(device)
    phase_step_edges(device)
    phase_explain_edges(device)
    scheds, totals, steady_records, k4, k3b, k7 = phase_steady(device)
    phase_small(device, scheds)
    del scheds
    k4r, k4r_launches = phase_reservations(device)
    phase_reservation_edges(device)
    phase_wide_edges(device)
    phase_k2_long_list(device)
    phase_class_edges(device)
    gke, gke_launches = phase_gke(device)
    gang_rounds, gang_held = phase_gangs(device)
    k1a, _ = phase_approx(device)
    with watchdog(K5_PHASE_LIMIT_S, "phase_preempt_edges"):
        one_quota = phase_preempt_edges(device)
    with watchdog(K5_PHASE_LIMIT_S, "phase 15 (preemption)"):
        k5_k6, preempt_records, k7_15 = phase_preemption(
            device, one_quota=one_quota)
    kernels[1:1] = [dict(
        name="refresh_candidates", route="cuda",
        source=CSRC + "refresh_candidates.cu",
        replaces="koordinator_tpu/ops/batch_assign.py:731", **k2,
        library_ms=None)]
    # K3b at the cold solve's first round behind the quota tree: every
    # level in one launch
    kernels.append(dict(
        name="segmented_prefix_accept", route="cuda",
        source=CSRC + "segmented_prefix_accept.cu",
        replaces="koordinator_tpu/ops/batch_assign.py:271",
        max_abs_err=k3b["max_abs_err"], ms=k3b["ms"],
        device_ms=k3b["device_ms"], sort_ms=k3b["sort_ms"],
        plain_ms=k3b["plain_ms"], bound_ms=k3b["bound_ms"],
        bound_by=k3b["bound_by"], library_ms=None))
    kernels.append(dict(
        name="greedy_scan", route="cuda", source=CSRC + "greedy_scan.cu",
        replaces="koordinator_tpu/ops/assignment.py:169", **k4,
        library_ms=None))
    # launches: the slice's main path, the forced-threshold scheduler's
    # cold round and five steady rounds
    for entry in kernels:
        entry["launches"] = totals[entry["name"]]
    # K4r at round 2's pre-pass; its launches over the reservations
    # phase's three rounds
    kernels.append(dict(
        name="reservation_scan", route="cuda", source=CSRC + "greedy_scan.cu",
        replaces="koordinator_tpu/ops/reservation.py:252",
        launches=k4r_launches, max_abs_err=k4r["max_abs_err"], ms=k4r["ms"],
        us_per_step=k4r["us_per_step"], plain_ms=k4r["plain_ms"],
        bound_ms=k4r["bound_ms"], bound_by=k4r["bound_by"], library_ms=None))
    this_run = {
        "select_candidates": dict(ms=kernels[0]["ms"]),
        "greedy_scan (rescue)": dict(ms=k4["ms"]),
        "greedy_scan (1,000 pods)": dict(
            ms=k4_1000["ms"], us_per_step=k4_1000["us_per_step"]),
        "segmented_prefix_accept (a launch, node level, first round)": dict(
            ms=table_k3b["device_ms"], wrapper_ms=table_k3b["ms"]),
        "refresh_candidates (wrapper)": dict(ms=k2["ms"]),
        "refresh_candidates (device)": dict(ms=k2["device_ms"]),
        "reservation_scan (phase 11 pre-pass)": dict(
            ms=k4r["ms"], us_per_step=k4r["us_per_step"]),
        "select_candidates_approx (phase 14 cold batch)": dict(
            ms=k1a["ms"], k1_ms=k1a["k1_ms"]),
        "victim_select (phase 15 chain of 256)": dict(
            ms=k5_k6[0]["ms"], device_ms=k5_k6[0]["device_ms"]),
        "overuse_revoke (phase 15 round 3)": dict(ms=k5_k6[1]["ms"]),
        "overuse_revoke (one quota of 50,000 pods)": dict(
            ms=one_quota["ms"]),
        "explain_counts (phase 9 last steady round)": dict(
            ms=k7["ms"], device_ms=k7["device_ms"]),
        "explain_counts (phase 12 last steady round)": dict(
            ms=gke["explain_counts"]["ms"],
            device_ms=gke["explain_counts"]["device_ms"]),
        "explain_counts (phase 15 round 1)": dict(
            ms=k7_15["ms"], device_ms=k7_15["device_ms"])}
    emit("earlier_design", note="earlier times as PERF.md records them, "
         "each labelled with its commit, beside this run's at the same "
         "shapes", kernels=[
             dict(name=name, label=label, earlier_ms=ms, **this_run[name])
             for name, label, ms in EARLIER_MS])
    # phase 12's numbers beside each kernel's: its time, plain time and
    # bound at the GKE-scale shapes, and its launches over phase 12's rounds
    for entry in kernels:
        g = gke[entry["name"]]
        entry["phase12"] = dict(
            launches=sum(r[entry["name"]] for r in gke_launches),
            max_abs_err=g["max_abs_err"], ms=g["ms"],
            plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
            bound_by=g["bound_by"], library_ms=g.get("library_ms"))
        if "device_ms" in g:
            entry["phase12"]["device_ms"] = g["device_ms"]
    # the gang path adds no kernel: its rounds' launches beside the ones
    # that ran there, and the numbers of those held at round 1's inputs
    for entry in kernels:
        n13 = sum(r["launches"][entry["name"]] for r in gang_rounds)
        if n13:
            entry["phase13"] = dict(launches=n13,
                                    **gang_held.get(entry["name"], {}))
    # K1a at phase 14's cold round, its launches over phase 14's rounds
    kernels.append(k1a)
    # K5 on phase 15's first full chain, K6 on its round 3; their launches
    # over phase 15's three rounds
    kernels += k5_k6
    # K7 at phase 9's last steady round, its launches over the forced
    # scheduler's rounds; at phase 12's last steady round and phase 15's
    # round 1 beside it with their phases' launches
    k7_keys = ("max_abs_err", "ms", "device_ms", "pack_ms", "plain_ms",
               "bound_ms", "bound_by", "rows", "nodes", "classes", "plan")
    kernels.append(dict(
        name="explain_counts", route="cuda",
        source=CSRC + "explain_counts.cu",
        replaces="koordinator_tpu/ops/explain.py:83",
        launches=totals["explain_counts"], library_ms=None,
        **{k: k7[k] for k in k7_keys},
        phase12=dict(
            launches=sum(r["explain_counts"] for r in gke_launches),
            library_ms=None,
            **{k: gke["explain_counts"][k] for k in k7_keys}),
        phase13=dict(launches=sum(r["launches"]["explain_counts"]
                                  for r in gang_rounds)),
        phase15=dict(library_ms=None,
                     **{k: k7_15[k] for k in k7_keys + ("launches",)})))
    emit("diagnose", note="the Diagnose phase's host ms a round, its parts "
         "(quota_mask: the post-solve quota mask; compact: the failed rows "
         "and their compacted batch; k7: K7 and the copy back; diagnoses; "
         "gang_wait: the WaitTime machine; explanations), and the rows K7 "
         "counted",
         phase9=[dict(round=r["round"], ms=r["diagnose_ms"],
                      parts_ms=r["diagnose_parts_ms"], rows=r["k7_rows"])
                 for r in steady_records if r["scheduler"] == "forced"],
         phase15=[dict(round=r["round"], ms=r["diagnose_ms"],
                       parts_ms=r["diagnose_parts_ms"], rows=r["k7_rows"])
                  for r in preempt_records])
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
