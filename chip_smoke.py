#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``koordinator_tpu_torch``) on the card, phase by phase,
printing one JSON line per phase and stopping with a non-zero exit at the
first failure:

1. device: the card's name and power limit;
2. build: compiles the kernels from ``koordinator_tpu_torch/kernels/csrc``;
3. kernels: K1 against its plain PyTorch version at 2,048 pods x 1,024 nodes
   under four configurations (instantaneous thresholds, aggregated
   thresholds, selector classes, dense feasibility), and K3a/K3b against
   theirs on the inputs of every round of a real solve of that problem;
4. solve: ``batch_assign`` at 4,096 pods x 1,024 nodes with a quota tree,
   kernel path against the plain path on the card;
5. main path: ``Scheduler.schedule_round`` on 50,000 pending pods over
   10,240 nodes (R = 10), twice from the same seed (warm-up, then the
   reported round), with each kernel's launch count over the reported round;
6. kernel table: each kernel's time at the main path's shapes against its
   plain version, its bound and, for K1, ``torch.topk`` over a (P, N) key.

The line before the last is ``nvidia-smi``'s name and power limit; the last
is ``{"ok": true, "device": {...}}``.  Every comparison is exact equality
(all outputs are int32 or bool).  Nothing here imports JAX or the JAX
package.  Without a CUDA device it exits non-zero and prints no result.
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

#: H100 SXM peaks (NVIDIA data sheet), against which bound_ms is computed
HBM_BYTES_PER_S = 3.35e12
#: 32-bit scalar (non-tensor-core) peak; int32 operations are counted at it
SCALAR_OPS_PER_S = 67e12


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
    if variant == "agg":
        agg = torch.zeros(R, dtype=torch.int32, device=device)
        agg[CPU], agg[MEM] = 55, 80
        cfg = cfg.replace(agg_usage_thresholds=agg)
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
    """Route ``batch_assign`` through the kernels' plain versions on any
    device (the wrappers would launch the kernels on CUDA tensors)."""
    from koordinator_tpu_torch.kernels import prefix_accept, round_fit_choose
    from koordinator_tpu_torch.kernels import select_candidates as k1
    from koordinator_tpu_torch.ops import batch_assign as ba

    saved = (ba.select_candidates_kernel, ba.round_fit_choose,
             ba.segmented_prefix_accept)
    ba.select_candidates_kernel = k1.select_candidates_plain
    ba.round_fit_choose = round_fit_choose.round_fit_choose_plain
    ba.segmented_prefix_accept = prefix_accept.segmented_prefix_accept_plain
    try:
        yield
    finally:
        (ba.select_candidates_kernel, ba.round_fit_choose,
         ba.segmented_prefix_accept) = saved


@contextlib.contextmanager
def checked_rounds(stats: dict):
    """Run K3a and K3b's wrappers AND plain versions on every call the
    rounds make, requiring equal outputs (the wrapper's result goes on)."""
    from koordinator_tpu_torch.kernels import prefix_accept, round_fit_choose
    from koordinator_tpu_torch.ops import batch_assign as ba

    saved = (ba.round_fit_choose, ba.segmented_prefix_accept)

    def fit_choose(*args):
        got = round_fit_choose.round_fit_choose(*args)
        want = round_fit_choose.round_fit_choose_plain(*args)
        for g, w in zip(got, want):
            check(max_abs_err(g, w) == 0, "K3a equals its plain version")
        stats["k3a_calls"] += 1
        return got

    def prefix(*args):
        got = prefix_accept.segmented_prefix_accept(*args)
        want = prefix_accept.segmented_prefix_accept_plain(*args)
        check(max_abs_err(got, want) == 0, "K3b equals its plain version")
        stats["k3b_calls"] += 1
        stats["k3b_accepted"] += int(got.sum())
        return got

    ba.round_fit_choose, ba.segmented_prefix_accept = fit_choose, prefix
    try:
        yield
    finally:
        ba.round_fit_choose, ba.segmented_prefix_accept = saved


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
         equal=True)


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
    keep its inputs, by wrapping the scheduler module's ``gang_assign``."""
    import torch

    from koordinator_tpu_torch.scheduler import scheduler as sched_mod

    real = sched_mod.gang_assign
    on_card = torch.device(device).type == "cuda"

    def probe(state, batch, cfg, gangs, quota=None, **kw):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = real(state, batch, cfg, gangs, quota, **kw)
        if on_card:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        log.append(dict(solver=kw.get("solver"), ms=ms, state=state,
                        batch=batch, cfg=cfg))
        return out

    sched_mod.gang_assign = probe
    try:
        yield
    finally:
        sched_mod.gang_assign = real


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
    emit("main_path", pods=n_pods, nodes=n_nodes, rounds=rounds,
         launches=launches)
    return launches, log


def phase_table(device, launches: dict, log: list, reps: int = 3):
    """Each kernel at the main path's shapes (the reported round's first
    batch solve): time, its plain version's time, its bound, and for K1
    torch.topk over the (P, N) ranking key."""
    import torch

    from koordinator_tpu_torch.kernels.prefix_accept import (
        segmented_prefix_accept,
        segmented_prefix_accept_plain,
    )
    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
        round_fit_choose_plain,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        _pod_rows,
        _rank_parts,
        select_candidates_kernel,
        select_candidates_plain,
    )
    from koordinator_tpu_torch.ops.assignment import priority_order, score_pods
    from koordinator_tpu_torch.ops.batch_assign import CANDIDATE_CHUNK

    solve = next(s for s in log if s["solver"] == "batch")
    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    p, n = pods.capacity, state.capacity
    p_valid = int(pods.valid.sum())
    k = 32

    # K1
    got = select_candidates_kernel(state, pods, cfg, k)
    want = select_candidates_plain(state, pods, cfg, k, chunk=CANDIDATE_CHUNK)
    k1_err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(k1_err == 0, "K1 equals its plain version at the main path's shape")
    k1_ms = timed_ms(lambda: select_candidates_kernel(state, pods, cfg, k),
                     device, reps=reps)
    k1_plain_ms = timed_ms(
        lambda: select_candidates_plain(state, pods, cfg, k,
                                        chunk=CANDIDATE_CHUNK),
        device, reps=1, warmup=0)
    key = torch.empty((p, n), dtype=torch.int32, device=state.device)
    for i in range(0, p, CANDIDATE_CHUNK):
        sub = _pod_rows(pods, i, min(i + CANDIDATE_CHUNK, p))
        scores, feas = score_pods(state, sub, cfg)
        key[i:i + CANDIDATE_CHUNK] = _rank_parts(scores, feas, 5, sub.rot_id,
                                                 n)[0]
        del scores, feas
    topk_ms = timed_ms(lambda: torch.topk(key, k // 2, dim=1), device,
                       reps=reps)
    del key
    # bytes: node tensors (4 x (N, R) int32 + valid + class), pod requests
    # and estimates, valid, rot_id, selector row, three (P, k) outputs
    sel_bytes = (0 if pods.selector_mask is None
                 else pods.selector_mask.numel())
    k1_bytes = (n * (4 * R * 4 + 1 + 4) + p * (2 * R * 4 + 1 + 4)
                + sel_bytes + 3 * p * k * 4)
    # operations: per valid (pod, node) pair, 12 int32 operations per
    # resource dim (fit, threshold, scarce, and the score terms) plus 40
    # per pair (score combination, selector, ranking key, two insertion
    # compares); the top-k insertions themselves are not counted
    k1_ops = p_valid * n * (12 * R + 40)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / SCALAR_OPS_PER_S) * 1e3

    # K3a on the first round's inputs
    cand_key, cand_node = got[0], got[1]
    free = torch.where(state.node_valid[:, None],
                       state.node_allocatable - state.node_requested, 0)
    active = pods.valid & torch.any(cand_key >= 0, dim=1)
    choice, has = round_fit_choose(cand_key, cand_node, free, pods.requests,
                                   active)
    pchoice, phas = round_fit_choose_plain(cand_key, cand_node, free,
                                           pods.requests, active)
    k3a_err = max(max_abs_err(choice, pchoice), max_abs_err(has, phas))
    check(k3a_err == 0, "K3a equals its plain version at the main shape")
    k3a_ms = timed_ms(lambda: round_fit_choose(cand_key, cand_node, free,
                                               pods.requests, active),
                      device, reps=10)
    k3a_plain_ms = timed_ms(lambda: round_fit_choose_plain(
        cand_key, cand_node, free, pods.requests, active), device, reps=3)
    n_active = int(active.sum())
    k3a_bytes = (n_active * (k * (4 + 4 + R * 4) + R * 4)
                 + p * (1 + 4 + 1))
    k3a_bound = k3a_bytes / HBM_BYTES_PER_S * 1e3

    # K3b on the first round's node-level acceptance
    act = active & has
    order = priority_order(pods)
    safe = torch.clamp(choice, 0, n - 1).long()
    choice_free = torch.where(act[:, None], free[safe], 0)
    seg = torch.where(act, choice, n).to(torch.int32)
    args = (seg, pods.requests, choice_free, order, act, n)
    acc = segmented_prefix_accept(*args)
    pacc = segmented_prefix_accept_plain(*args)
    k3b_err = max_abs_err(acc, pacc)
    check(k3b_err == 0, "K3b equals its plain version at the main shape")
    k3b_ms = timed_ms(lambda: segmented_prefix_accept(*args), device, reps=10)
    k3b_plain_ms = timed_ms(lambda: segmented_prefix_accept_plain(*args),
                            device, reps=3)
    k3b_bytes = p * (8 + 8 + 4 + 2 * R * 4 + 1 + 1)
    k3b_bound = k3b_bytes / HBM_BYTES_PER_S * 1e3

    base = "koordinator_tpu_torch/kernels/csrc/"
    kernels = [
        dict(name="select_candidates", route="cuda",
             source=base + "select_candidates.cu",
             replaces="koordinator_tpu/ops/batch_assign.py:404",
             launches=launches["select_candidates"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
             bound_by=("operations" if k1_ops / SCALAR_OPS_PER_S
                       >= k1_bytes / HBM_BYTES_PER_S else "bytes"),
             library_ms=topk_ms),
        dict(name="round_fit_choose", route="cuda",
             source=base + "round_fit_choose.cu",
             replaces="koordinator_tpu/ops/batch_assign.py:606",
             launches=launches["round_fit_choose"], max_abs_err=k3a_err,
             ms=k3a_ms, plain_ms=k3a_plain_ms, bound_ms=k3a_bound,
             bound_by="bytes", library_ms=None),
        dict(name="segmented_prefix_accept", route="cuda",
             source=base + "segmented_prefix_accept.cu",
             replaces="koordinator_tpu/ops/batch_assign.py:271",
             launches=launches["segmented_prefix_accept"],
             max_abs_err=k3b_err, ms=k3b_ms, plain_ms=k3b_plain_ms,
             bound_ms=k3b_bound, bound_by="bytes", library_ms=None),
    ]
    emit("table", pods=p, valid_pods=p_valid, nodes=n, k=k,
         k1_ops=k1_ops, k1_bytes=k1_bytes, k3a_active=n_active,
         k3a_bytes=k3a_bytes, k3b_bytes=k3b_bytes,
         k3b_accepted=int(acc.sum()))
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from koordinator_tpu_torch.kernels import build

    t_start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    device = "cuda"
    smi = smi_name_power()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.build(force=True, log_path=os.path.join(OUT_DIR, "ptxas.txt"))
    build.lib()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[os.path.basename(s) for s in build.sources()])

    phase_kernels(device)
    phase_solve(device)
    launches, log = phase_main(device)
    for kernel, count in launches.items():
        check(count > 0, f"{kernel} launched on the main path")
    kernels = phase_table(device, launches, log)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
