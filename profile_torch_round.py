#!/usr/bin/env python3
"""Where one scheduling round of the PyTorch port spends its time on the GPU.

    python3 profile_torch_round.py [--nodes 10240] [--pods 50000] [--steady]

Runs the port's main path (``Scheduler.schedule_round`` on the flagship
problem that chip_smoke.py drives) once to warm up, then once under
``torch.profiler`` with CPU and CUDA activities.  With ``--steady`` the
profiled round is a steady-state one instead: chip_smoke.py's phase 9 setup
(the flagship cluster behind the 16-leaf quota tree, the dirty threshold at
1.0), a cold round and one steady round to warm up, STEADY_TIMED steady
rounds timed without the profiler (a ``steady_walls`` line: each round's
wall, failures and the Diagnose phase's host ms and its parts), then a
steady round after a usage refresh of 1% of the nodes and 500 arrivals.
``--root DIR`` takes the port and chip_smoke.py from another checkout:
run parent, tree, tree, parent in one call to compare two commits'
rounds.  Prints JSON lines:

- ``round``: the profiled round's wall time, the summed device time of every
  kernel and copy, and the device's idle share (1 - device / wall);
- ``device_ops``: the operators with the most self device time, with
  their call counts;
- ``host_phases``: wall time of the round's host steps, measured by
  timing the scheduler's own methods.

The trace goes to ``chiprun_out/round_trace.json`` (``steady_trace.json``
with ``--steady``).  With ``--shapes`` the profiler also records input
shapes, and an ``index_add`` line splits the ``index_add_`` device time
by them (the shapes tell its call sites apart).
Needs a CUDA device.

    python3 profile_torch_round.py --kernels [--variants] [--root DIR]

times K1 on the cold flagship round's own batch (65,536 rows, 50,000
valid, x 10,240 nodes), K4 at 1,000 pods x 10,240 nodes (chip_smoke.py
phase 8's problem) and K4 on the rescue of a steady round (phase 9's
setup, its first steady round), K1a on phase 9's (and 14's) cold round's
batch, K4r at phase 11's round-2 reservation pre-pass (2,048 owner pods,
10,240 nodes, 1,024 reservations), K3b's whole acceptance of a solve's first
propose/accept round on the cold flagship round and on phase 9's cold
round behind the quota tree (a port without the per-round acceptance
runs its level-by-level calls), and K2 at phase 7's shape (D = 128); for
K3b and K2 also their kernels' device time from torch.profiler
(``device_ms``); and prints one JSON line.  ``--root``
takes the port, its build and chip_smoke.py from another checkout (``git
archive`` of an earlier commit unpacked in a gitignored directory): run
it beside this tree in one call to compare two designs on one card.
``--variants [PREFIX]`` also builds copies of the kernels' sources with
one change each (VARIANTS below whose name starts with PREFIX, under
``probe_results/variants/``) with the package's compiler flags, and times
them in turns with the tree's own kernels, every variant's outputs
required equal but those of INCOMPARABLE.

    python3 profile_torch_round.py --preempt [--grids 132,264] [--root DIR]

times K5 on chip_smoke.py phase 15's first full chain (256 preemptors over
10,240 nodes and ~170,000 bound pods, on the node-ordered rows its
PostFilter built; the rows' build timed apart) and K6 on phase 15's round
3 and on one quota of 50,000 pods, with CUDA events, and their kernels'
device time from torch.profiler; prints one JSON line with a digest of
the inputs and outputs.  With ``--root`` it times another checkout's port
on the same seeded inputs: run parent, tree, tree, parent in one call.

    python3 profile_torch_round.py --steps

builds a copy of K4's source with clock stamps in CTA 0 (STEP_STAMPS) and
prints, for K4 at 1,000 pods and K4r at phase 11's pre-pass, the mean SM
cycles of each stretch of a step: the scan to the last warp's rank, that
rank to the last rank in from the cluster, the next pod's search, the
reduction, the charge, the re-check and publication, and the wait for
the next step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time


#: with --steady: steady rounds timed without the profiler before the
#: profiled one
STEADY_TIMED = 3

#: one-change copies of the kernel sources, each isolating one cause of
#: K1's or K4's time: (name, [(file under csrc/, old text, new text)])
VARIANTS = [
    # K1's tiles loaded by each CTA alone (a cluster of 1): the multicast
    ("k1_no_multicast", [("select_candidates.cu",
                          "constexpr int kCluster = 2;",
                          "constexpr int kCluster = 1;")]),
    # every score division through the compiler's integer divide
    ("fdiv", [
        ("koord_score.cuh",
         "magic_fdiv(wmul(max(wsub(a, used), 0), kMaxScore), n.m(r),\n"
         "                             n.l(r));",
         "fdiv(wmul(max(wsub(a, used), 0), kMaxScore), max(a, 1));"),
        ("koord_score.cuh", "magic_fdiv(num, n.m(r), n.l(r));",
         "fdiv(num, max(a, 1));"),
        ("koord_score.cuh", "magic_fdiv(node_score, c.la_m, c.la_l)",
         "fdiv(node_score, max(c.la_wsum, 1))"),
        ("koord_score.cuh", "magic_fdiv(fp_num, t.s.fp_m, t.s.fp_l)",
         "fdiv(fp_num, max(t.s.fp_den, 1))"),
        ("koord_score.cuh",
         "scarce_div((n_diff - n_inter) * kMaxScore, n_diff)",
         "fdiv((n_diff - n_inter) * kMaxScore, max(n_diff, 1))")]),
    # K1 streaming its tiles with no scoring and no epilogue (outputs not
    # comparable): the staging's own time, with and without the multicast
    ("k1_staging_only", [
        ("select_candidates.cu", "if (pvalid) {\n        const int* tile",
         "if (false) {\n        const int* tile"),
        ("select_candidates.cu", "  if (!in_range) return;",
         "  return;")]),
    ("k1_staging_only_no_multicast", [
        ("select_candidates.cu", "if (pvalid) {\n        const int* tile",
         "if (false) {\n        const int* tile"),
        ("select_candidates.cu", "  if (!in_range) return;",
         "  return;"),
        ("select_candidates.cu", "constexpr int kCluster = 2;",
         "constexpr int kCluster = 1;")]),
    # K1's pod groups taken by the clusters in order (no spreading)
    ("k1_groups_in_order", [("select_candidates.cu",
                             "while (gcd(stride, n_groups) != 1) ++stride;",
                             "stride = 1;")]),
    # K1 with one, two or eight threads a pod instead of four
    ("k1_lanes_1", [("select_candidates.cu", "constexpr int kLanes = 4;",
                     "constexpr int kLanes = 1;")]),
    ("k1_lanes_2", [("select_candidates.cu", "constexpr int kLanes = 4;",
                     "constexpr int kLanes = 2;")]),
    ("k1_lanes_8", [("select_candidates.cu", "constexpr int kLanes = 4;",
                     "constexpr int kLanes = 8;")]),
    # K1's ring of 2 or 4 tiles instead of 3 (4 stages leave room for 4
    # CTAs an SM instead of 6)
    ("k1_stages_2", [("select_candidates.cu", "constexpr int kStages = 3;",
                      "constexpr int kStages = 2;")]),
    ("k1_stages_4", [("select_candidates.cu", "constexpr int kStages = 3;",
                      "constexpr int kStages = 4;")]),
    # K1's tiles shared by 4 or 8 CTAs
    ("k1_cluster_4", [("select_candidates.cu",
                       "constexpr int kCluster = 2;",
                       "constexpr int kCluster = 4;")]),
    ("k1_cluster_8", [("select_candidates.cu",
                       "constexpr int kCluster = 2;",
                       "constexpr int kCluster = 8;")]),
    # K4 on 8 CTAs: its node columns no longer fit shared memory
    ("k4_cluster_8", [("greedy_scan.cu", "constexpr int kCluster = 16;",
                       "constexpr int kCluster = 8;")]),
    # K4 with 8 or 16 scanning warps a CTA instead of 20
    ("k4_scan_warps_8", [("greedy_scan.cu",
                          "constexpr int kScanWarps = 20;",
                          "constexpr int kScanWarps = 8;")]),
    ("k4_scan_warps_16", [("greedy_scan.cu",
                           "constexpr int kScanWarps = 20;",
                           "constexpr int kScanWarps = 16;")]),
    # K5 with no dry run (every node out of the choice): the handoff's
    # own time, a preemptor at a time (outputs not comparable)
    ("k5_no_dry_run", [("victim_select.cu",
                        "  const int start = a.offsets[nd], end = "
                        "a.offsets[nd + 1];\n",
                        "  if (a.C > 0) return no_key();\n"
                        "  const int start = a.offsets[nd], end = "
                        "a.offsets[nd + 1];\n")]),
    # K5 with clock stamps: SM cycles of each node's pass 1, pass 2 and
    # record, and of each CTA's dry runs, wait and choice-and-commit, a
    # preemptor, summed in shared memory and added to K5_STAMPS once a
    # warp at the end (read by preempt_times)
    ("k5_stamps", [
        ("victim_select.cu", "namespace {\n",
         "namespace {\n__device__ unsigned long long g_k5[12];\n"
         "__shared__ unsigned long long s_acc[32][12];\n"),
        ("victim_select.cu",
         "  const int start = a.offsets[nd], end = a.offsets[nd + 1];\n",
         "  const long long st0 = clock64();\n"
         "  const int start = a.offsets[nd], end = a.offsets[nd + 1];\n"),
        ("victim_select.cu",
         "  __syncwarp();  // the staged requests before any lane reads them\n",
         "  __syncwarp();  // the staged requests before any lane reads them\n"
         "  const long long st1 = clock64();\n"),
        ("victim_select.cu",
         "  __syncwarp();  // every lane's reads of the stage before the next "
         "node\n",
         "  __syncwarp();  // every lane's reads of the stage before the next "
         "node\n  const long long st2 = clock64();\n"),
        ("victim_select.cu", "  if (!eligible) return no_key();\n",
         "  if (lane == 0) {\n"
         "    unsigned long long* acc = s_acc[threadIdx.x >> 5];\n"
         "    acc[0] += st1 - st0;\n    acc[1] += st2 - st1;\n"
         "    acc[2] += clock64() - st2;\n    acc[3] += 1;\n"
         "    acc[4] += end - start;\n    acc[5] += nvic;\n"
         "  }\n  if (!eligible) return no_key();\n"),
        ("victim_select.cu",
         "  if (threadIdx.x == 0) s_next[0] = 0;\n  __syncthreads();\n",
         "  if (threadIdx.x == 0) s_next[0] = 0;\n"
         "  for (int i = threadIdx.x; i < 32 * 12; i += kThreads) "
         "s_acc[i / 12][i % 12] = 0;\n  __syncthreads();\n"),
        ("victim_select.cu", "    Key best = no_key();\n",
         "    const long long m0 = clock64();\n    Key best = no_key();\n"),
        ("victim_select.cu",
         "    if (lane == 0) s_key[warp] = best;\n    __syncthreads();\n",
         "    if (lane == 0) s_key[warp] = best;\n    __syncthreads();\n"
         "    const long long m1 = clock64();\n    long long m2 = m1;\n"),
        ("victim_select.cu",
         "    __syncthreads();\n\n    // every CTA: the chosen node",
         "    __syncthreads();\n    m2 = clock64();\n\n"
         "    // every CTA: the chosen node"),
        ("victim_select.cu",
         "node >= n0 && node < n1, lane);\n    }\n    __syncthreads();\n",
         "node >= n0 && node < n1, lane);\n    }\n    __syncthreads();\n"
         "    if (threadIdx.x == 0) {\n"
         "      s_acc[0][6] += m1 - m0;\n      s_acc[0][7] += m2 - m1;\n"
         "      s_acc[0][8] += clock64() - m2;\n      s_acc[0][9] += 1;\n"
         "      if (m1 - m0 > s_acc[0][10]) s_acc[0][10] = m1 - m0;\n"
         "    }\n"),
        ("victim_select.cu", "  if (a.commit && blockIdx.x == 0) {\n",
         "  __syncthreads();\n  if (lane == 0)\n"
         "    for (int i = 0; i < 10; ++i) atomicAdd(&g_k5[i], "
         "s_acc[warp][i]);\n"
         "  if (threadIdx.x == 0) atomicMax(&g_k5[10], s_acc[0][10]);\n"
         "  if (a.commit && blockIdx.x == 0) {\n"),
        ("victim_select.cu", "// Runs K5 over the C preemptors",
         "extern \"C\" int koord_k5_stamps(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_k5, sizeof(g_k5));\n}\n"
         "extern \"C\" int koord_k5_stamps_reset() {\n"
         "  static unsigned long long zero[12];\n"
         "  return (int)cudaMemcpyToSymbol(g_k5, zero, sizeof(zero));\n}\n"
         "// Runs K5 over the C preemptors"),
    ]),
    # K5's meeting alone (no dry run) with clock stamps in thread 0 of
    # each CTA: SM cycles from the dry runs' end to the CTA barrier, to
    # the arrival's issue, to the last arrival seen, to the acquire and
    # barrier, to the partial keys reduced, to the commit and barrier
    # (summed in K5_MEET; read by preempt_times)
    ("k5_meeting_stamps", [
        ("victim_select.cu", "namespace {\n",
         "namespace {\n__device__ unsigned long long g_meet[8];\n"),
        ("victim_select.cu",
         "  const int start = a.offsets[nd], end = a.offsets[nd + 1];\n",
         "  if (a.C > 0) return no_key();\n"
         "  const int start = a.offsets[nd], end = a.offsets[nd + 1];\n"),
        ("victim_select.cu", "    Key best = no_key();\n",
         "    long long t[7];\n    Key best = no_key();\n"),
        ("victim_select.cu",
         "    if (lane == 0) s_key[warp] = best;\n    __syncthreads();\n",
         "    t[0] = clock64();\n"
         "    if (lane == 0) s_key[warp] = best;\n    __syncthreads();\n"
         "    t[1] = clock64();\n"),
        ("victim_select.cu",
         "                   \"r\"(1u)\n                   : \"memory\");\n",
         "                   \"r\"(1u)\n                   : \"memory\");\n"
         "      t[2] = clock64();\n"),
        ("victim_select.cu", "      ld_acquire(a.arrivals);\n    }\n"
         "    __syncthreads();\n",
         "      t[3] = clock64();\n      ld_acquire(a.arrivals);\n    }\n"
         "    __syncthreads();\n    t[4] = clock64();\n"),
        ("victim_select.cu",
         "    k = warp_min(k);\n    if (lane == 0) s_key[warp] = k;\n"
         "    __syncthreads();\n",
         "    k = warp_min(k);\n    if (lane == 0) s_key[warp] = k;\n"
         "    __syncthreads();\n    t[5] = clock64();\n"),
        ("victim_select.cu",
         "node >= n0 && node < n1, lane);\n    }\n    __syncthreads();\n",
         "node >= n0 && node < n1, lane);\n    }\n    __syncthreads();\n"
         "    if (threadIdx.x == 0) {\n      t[6] = clock64();\n"
         "      for (int i = 0; i < 6; ++i)\n"
         "        atomicAdd(&g_meet[i], (unsigned long long)(t[i + 1] - t[i]));\n"
         "      atomicAdd(&g_meet[6], 1ull);\n    }\n"),
        ("victim_select.cu", "// Runs K5 over the C preemptors",
         "extern \"C\" int koord_k5_stamps(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_meet, sizeof(g_meet));\n}\n"
         "extern \"C\" int koord_k5_stamps_reset() {\n"
         "  static unsigned long long zero[8];\n"
         "  return (int)cudaMemcpyToSymbol(g_meet, zero, sizeof(zero));\n}\n"
         "// Runs K5 over the C preemptors"),
    ]),
    # K2 with one or two threads a pod instead of four
    ("k2_lanes_1", [("refresh_candidates.cu", "constexpr int kLanes = 4;",
                     "constexpr int kLanes = 1;")]),
    ("k2_lanes_2", [("refresh_candidates.cu", "constexpr int kLanes = 4;",
                     "constexpr int kLanes = 2;")]),
    # K2 without scoring the dirty columns (the rows still staged), and
    # without decoding the lists (outputs not comparable): where its time
    # goes
    ("k2_no_fresh", [("refresh_candidates.cu",
                      "      if (!(kWide ? in_range : pvalid)) continue;\n"
                      "      for (int i = lane;",
                      "      continue;\n      for (int i = lane;")]),
    ("k2_no_decode", [("refresh_candidates.cu",
                       "  // pass 2: each slot's node and score, and the",
                       "  return;\n  // pass 2: each slot's node and score, "
                       "and the")]),
]

#: variants whose outputs differ from the tree's by design
INCOMPARABLE = ("k1_staging_only", "k1_staging_only_no_multicast",
                "k2_no_fresh", "k2_no_decode", "k5_no_dry_run",
                "k5_meeting_stamps")
#: k5_meeting_stamps' stretches of a CTA's meeting, SM cycles
K5_MEET = ("to_barrier", "to_arrival", "to_last_seen", "to_acquired",
           "to_reduced", "to_committed")
#: K5_STAMPS' sums, in the order k5_stamps adds them
K5_STAMPS = ("pass1_cycles", "pass2_cycles", "record_cycles", "nodes",
             "rows", "victims", "cta_dry_run_cycles", "cta_wait_cycles",
             "cta_choose_commit_cycles", "cta_preemptors",
             "cta_dry_run_cycles_max")


def patched_sources(name: str, patches, csrc: str) -> str:
    """A copy of ``csrc`` with ``patches`` applied under
    ``probe_results/variants/<name>`` (gitignored); returns its path."""
    root = os.path.join("probe_results", "variants", name, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root)
    for fname, old, new in patches:
        path = os.path.join(root, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def build_copy(build, csrc: str) -> ctypes.CDLL:
    """Compile and link one copy of the sources as the package builds its
    own (one nvcc per source, then one link); the typed library."""
    nvcc = build._nvcc()
    out = os.path.dirname(csrc)
    procs = []
    for src in sorted(os.listdir(csrc)):
        if src.endswith(".cu"):
            obj = os.path.join(out, src[:-3] + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", csrc, "-c",
                 os.path.join(csrc, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {obj}:\n{log}")
    path = os.path.join(out, "libkoord_kernels.so")
    link = subprocess.run(
        [nvcc, *build.NVCC_FLAGS, "-shared", *(o for o, _ in procs), "-o",
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    return build._bind(ctypes.CDLL(os.path.abspath(path)))


def build_variants(build, prefix: str = "") -> dict:
    """The typed library of every variant whose name starts with
    ``prefix`` (three built at a time): name -> CDLL.  The patches are
    exact text of the sources they were written for: a later edit of
    those lines stops this with the variant's name before anything is
    built."""
    from concurrent.futures import ThreadPoolExecutor

    copies = [(name, patched_sources(name, patches, build.CSRC))
              for name, patches in VARIANTS if name.startswith(prefix)]
    with ThreadPoolExecutor(max_workers=3) as pool:
        return dict(zip((n for n, _ in copies),
                        pool.map(lambda c: build_copy(build, c[1]), copies)))


def prepass_inputs(dev: str) -> dict:
    """The inputs of chip_smoke.py phase 11's round-2 reservation pre-pass
    (K4r): the flagship cluster with its 1,024 Reservations after round 1,
    and the 2,048 owner pods of highest priority of round 2's 3,000, as
    the scheduler hands them to reservation_greedy_assign."""
    import numpy as np

    import chip_smoke as cs
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    nodes, pods = cs.main_path_specs(0, 10_240, 50_000)
    rng = np.random.default_rng(17)
    snap = ClusterSnapshot(capacity=10_240, device=dev)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    sched = Scheduler(snap, device=dev, clock=lambda: now[0])
    for spec in cs.reservation_specs(rng, nodes, cs.N_RESERVATIONS,
                                     cs.N_PINNED):
        sched.add_reservation(spec)
    sched.enqueue_many(pods)
    sched.schedule_round()
    now[0] = 10.0
    sched.enqueue_many(cs.owner_pods(rng, 0, 3_000))
    log: list = []
    with cs.prepass_probe(log, dev):
        sched.schedule_round()
    return log[0]


def kernel_cases(dev: str):
    """({name: closure}, shapes): K1 on the cold flagship round's own
    batch, K4 at 1,000 pods x 10,240 nodes (chip_smoke.py phase 8's
    problem) and K4 on the rescue of a steady round (phase 9's setup, a
    cold round and one steady round on the forced-threshold scheduler),
    K1a on that cold round's batch (phase 14's cold round selects on the
    same batch under cand_method="approx") and K4r at phase 11's round-2
    pre-pass."""
    import numpy as np

    import chip_smoke as cs
    from koordinator_tpu_torch.kernels.greedy_scan import (
        greedy_scan_kernel,
        reservation_scan_kernel,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )

    _res, _sched, _wall, log, _pods, _nodes = cs.run_round(dev, 10_240,
                                                           50_000)
    solve = next(s for s in log if s["solver"] == "batch")
    state, pods, cfg = solve["state"], solve["batch"], solve["cfg"]
    gstate, gpods = cs.random_problem(21, 10_240, 1_000, dev, "classes")
    quota, gpods = cs.quota_setup(gpods, dev, 21)
    nodes, specs, leaf_max = cs.steady_specs(3, 10_240, 50_000)
    sched = cs.steady_scheduler(dev, nodes, specs, leaf_max, threshold=1.0)
    slog: list = []
    with cs.solve_probe(slog, dev):
        sched.schedule_round()
        refreshed, new = cs.steady_delta(np.random.default_rng(5), nodes, 1)
        for spec in refreshed:
            sched.snapshot.upsert_node(spec)
        sched.enqueue_many(new)
        sched.schedule_round()
    rescue = [s for s in slog if s["solver"] == "greedy"][-1]
    cold = [s for s in slog if s["solver"] == "batch"][0]
    cases = {
        "k1_ms": lambda: select_candidates_kernel(state, pods, cfg, 32),
        "k4_ms": lambda: greedy_scan_kernel(gstate, gpods, cfg, quota)[:1],
        "k4_rescue_ms": lambda: greedy_scan_kernel(
            rescue["state"], rescue["batch"], rescue["cfg"],
            rescue["quota"])[:1],
        "k3b_round_ms": first_round_accept(state, pods, cfg, None),
        "k3b_quota_round_ms": first_round_accept(
            cold["state"], cold["batch"], cold["cfg"], cold["quota"]),
        "k2_ms": refresh_case(state, pods, cfg),
        "k1a_ms": lambda: select_candidates_kernel(
            cold["state"], cold["batch"], cold["cfg"], 32, method="approx"),
    }
    pre = prepass_inputs(dev)
    cases["k4r_ms"] = lambda: reservation_scan_kernel(
        pre["state"], pre["pods"], pre["cfg"], pre["rsv"], pre["match"],
        pre["quota"])[:2]
    shapes = {
        "k1_shape": [pods.capacity, int(pods.valid.sum()), state.capacity],
        "k4_shape": [gpods.capacity, gstate.capacity],
        "k4_rescue_shape": [rescue["batch"].capacity,
                            int(rescue["batch"].valid.sum()),
                            rescue["state"].capacity],
        "k3b_quota_round_shape": [cold["batch"].capacity,
                                  int(cold["batch"].valid.sum()),
                                  cold["state"].capacity,
                                  cold["quota"].capacity],
        "k2_shape": [pods.capacity, int(pods.valid.sum()), state.capacity,
                     128],
        "k1a_shape": [cold["batch"].capacity,
                      int(cold["batch"].valid.sum()),
                      cold["state"].capacity],
        "k4r_shape": [pre["pods"].capacity, int(pre["pods"].valid.sum()),
                      pre["state"].capacity, pre["rsv"].capacity],
    }
    return cases, shapes


def first_round_accept(state, pods, cfg, quota):
    """A closure of one propose/accept round's whole acceptance on the
    first round of a solve (the node level, and with ``quota`` its chain
    columns and the non-preemptible level): in a port that has the
    per-round acceptance one call (its plan, built once a solve, made
    here), else the earlier port's level-by-level calls."""
    import torch

    from koordinator_tpu_torch.kernels.round_fit_choose import (
        round_fit_choose,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba
    from koordinator_tpu_torch.ops.assignment import priority_order
    from koordinator_tpu_torch.quota.admission import quota_admission_mask

    key, node, _ = select_candidates_kernel(state, pods, cfg, 32)
    free = torch.where(state.node_valid[:, None],
                       state.node_allocatable - state.node_requested, 0)
    active = pods.valid & torch.any(key >= 0, dim=1)
    choice, has = round_fit_choose(key, node, free, pods.requests, active,
                                   pods.rot_id)
    act = active & has
    if quota is not None:
        act = act & quota_admission_mask(quota, pods.requests,
                                         pods.quota_id, pods.non_preemptible)
    order = priority_order(pods)
    if not hasattr(ba, "round_prefix_accept"):
        def levels():
            acc = ba._prefix_accept(choice, pods.requests, free, order, act)
            if quota is not None:
                acc = acc & ba._quota_prefix_accept(quota, pods.requests,
                                                    pods, order, act)
            return (acc,)
        return levels
    if quota is None:
        plan = ba.accept_plan(order, pods.requests)
        return lambda: (ba.round_prefix_accept(plan, choice, act, free),)
    plan = ba.accept_plan(order, pods.requests, pods.quota_id,
                          pods.non_preemptible, quota.chain, quota.checked)
    return lambda: (ba.round_prefix_accept(plan, choice, act, free,
                                           quota.headroom,
                                           quota.min_headroom),)


def refresh_case(state, pods, cfg, n_dirty: int = 102):
    """A closure of K2 at chip_smoke.py phase 7's shape: the batch's cache
    from K1, then a usage refresh of ``n_dirty`` nodes (seed 11), D = 128
    padded dirty columns."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.kernels.refresh_candidates import (
        refresh_candidates_kernel,
    )
    from koordinator_tpu_torch.kernels.select_candidates import (
        select_candidates_kernel,
    )
    from koordinator_tpu_torch.ops import batch_assign as ba

    dev = state.node_usage.device
    p, n = pods.capacity, state.capacity
    cache = ba.CandidateCache(*select_candidates_kernel(state, pods, cfg, 32))
    rng = np.random.default_rng(11)
    rows = np.sort(rng.choice(n, n_dirty, replace=False))
    usage = state.node_usage.clone()
    alloc = state.node_allocatable[rows].cpu().numpy()
    usage[torch.from_numpy(rows).to(dev)] = torch.from_numpy(
        (alloc * rng.random(alloc.shape) * 0.5).astype(np.int32)).to(dev)
    state2 = state.replace(node_usage=usage)
    drows = np.zeros(128, np.int32)
    drows[:n_dirty] = rows
    dvalid = np.zeros(128, bool)
    dvalid[:n_dirty] = True
    dirty = np.zeros(n, bool)
    dirty[rows] = True
    aligned, _ = ba.align_candidate_cache(
        cache, torch.arange(p, dtype=torch.int32, device=dev), pods.valid,
        torch.from_numpy(dirty).to(dev))
    args = (state2, pods, cfg, aligned.cand_node, aligned.cand_score,
            torch.from_numpy(drows).to(dev), torch.from_numpy(dvalid).to(dev),
            32, (5, 15))
    return lambda: refresh_candidates_kernel(*args)


#: kernels whose device time --kernels reads from the profiler, by case
#: (names as the compiler emits them; both designs' names; a launch's
#: packing kernels count with it)
DEVICE_KERNELS = {
    "k1_ms": ("select_candidates_kernel", "pack_node_rows",
              "pack_selector_words"),
    "k4_ms": ("greedy_scan_kernel", "pack_selector_words"),
    "k4_rescue_ms": ("greedy_scan_kernel", "pack_selector_words"),
    "k3b_round_ms": ("prefix_accept_kernel", "round_accept_kernel"),
    "k3b_quota_round_ms": ("prefix_accept_kernel", "round_accept_kernel"),
    "k2_ms": ("refresh_candidates_kernel", "pack_node_rows",
              "pack_selector_words"),
    "k1a_ms": ("select_candidates_kernel", "pack_node_rows",
               "pack_selector_words"),
    "k4r_ms": ("greedy_scan_kernel", "pack_selector_words"),
}


def device_ms(fn, names, reps: int = 3) -> float | None:
    """Mean device time a call of ``fn`` spends in the kernels whose names
    contain one of ``names``, from torch.profiler; None when the profiler
    reports no device time."""
    return device_ms_parts(fn, {"": names}, reps)[""]


def device_ms_parts(fn, parts: dict, reps: int = 3) -> dict:
    """:func:`device_ms` for each part of ``parts`` (a name to the kernel
    names it sums) from one profile of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(parts, 0.0)
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        for part, names in parts.items():
            if any(n in e.key for n in names):
                total[part] += us
    return {part: t / 1e3 / reps if t > 0 else None
            for part, t in total.items()}


def digest(cases: dict) -> list[int]:
    """Sums of every output of every case: equal outputs, equal digests."""
    import torch

    return [int(t.to(torch.int64).sum()) for fn in cases.values()
            for t in fn() if torch.is_tensor(t)]


def kernel_times(args) -> int:
    """K1, K2, K3b and K4 at the main shapes, three readings each; with --variants
    also every one-change copy of the sources, in turns with the tree's
    kernels, its outputs required equal to the tree's.  One JSON line."""
    import torch

    import chip_smoke as cs
    from koordinator_tpu_torch.kernels import build

    dev = "cuda"
    t0 = time.perf_counter()
    libs = {"tree": build.lib()}
    if args.variants is not None:
        libs.update(build_variants(build, args.variants))
    build_s = time.perf_counter() - t0
    cases, shapes = kernel_cases(dev)
    times = {name: {case: [] for case in cases} for name in libs}
    ref = None
    try:
        for _rep in range(3):
            for name, handle in libs.items():
                # the wrappers launch through build.lib(): point it here
                build._lib = handle
                d = digest(cases)
                ref = d if ref is None else ref
                if d != ref and name not in INCOMPARABLE:
                    raise RuntimeError(f"{name}: outputs differ from the "
                                       "tree's")
                for case, fn in cases.items():
                    times[name][case].append(cs.timed_ms(fn, dev, reps=3))
        device = {}
        for name, handle in libs.items():
            build._lib = handle
            device[name] = {case: [device_ms(cases[case], names)
                                   for _ in range(3)]
                            for case, names in DEVICE_KERNELS.items()}
    finally:
        build._lib = libs["tree"]
    print(json.dumps({
        "kernels": args.root or ".", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.smi_name_power(), "build_s": build_s, **shapes,
        "times": times, "device_ms": device, "digest": ref}), flush=True)
    return 0


def preempt_inputs(dev: str) -> dict:
    """chip_smoke.py's phase 15 without its checks: the flagship cluster
    filled with ~170,000 bound pods behind the 16-leaf tree, 1,200
    arrivals, the three rounds; returns round 1's first full K5 chain
    (its arguments, the sched carrying what the PostFilter built) and
    round 3's K6 call, and K6's one quota of 50,000 pods
    (chip_smoke.k6_problem, as phase_preempt_edges makes it)."""
    import numpy as np

    import chip_smoke as cs
    from koordinator_tpu_torch.quota import overuse_revoke as orv
    from koordinator_tpu_torch.scheduler import scheduler as smod
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        PodSpec,
    )

    nodes, bound, leaf_used, budgets = cs.preempt_specs(15, 10_240)
    snap = ClusterSnapshot(capacity=len(nodes), device=dev)
    for spec in nodes:
        snap.upsert_node(spec)
    now = [0.0]
    sched = smod.Scheduler(snap, quota_tree=cs.preempt_tree(nodes, leaf_used),
                           device=dev, clock=lambda: now[0],
                           preempt_fn=lambda v, by: None)
    sched.enable_overuse_revoke(lambda p, q: None, delay_evict_sec=5.0)
    for k in range(cs.N_PDBS):
        sched.register_pdb(smod.PdbRecord(
            name=f"pdb-{k}", selector={"app": f"app-{k}"},
            allowed=int(budgets[k])))
    sched.add_bound_pods([smod.BoundPod(pod, name, snap.node_generation[name])
                          for pod, name in bound])
    for q in sched.quota_tree.nodes.values():
        q.used = np.zeros(cs.R, np.int64)
        q.non_preemptible_used = np.zeros(cs.R, np.int64)
    for bp in sched.bound.values():
        sched._charge_quota_used(bp, sign=1)
    arrivals, gangs = cs.preempt_arrivals(np.random.default_rng(151),
                                          cs.N_PREEMPT_ARRIVALS,
                                          cs.N_PREEMPT_GANGS,
                                          cs.N_PREEMPT_NEVER)
    for name, size in gangs:
        sched.register_gang(smod.GangRecord(name=name, min_member=size))
    sched.enqueue_many(arrivals)
    chains, walks = [], []
    real_chain, real_sel = smod.preempt_chain, orv.select_overuse_victims

    def rec_chain(*a):
        chains.append(a)
        return real_chain(*a)

    def rec_sel(*a):
        walks.append(a)
        return real_sel(*a)

    smod.preempt_chain, orv.select_overuse_victims = rec_chain, rec_sel
    try:
        for rnd, t in enumerate(cs.PREEMPT_TIMES):
            now[0] = t
            if rnd == 2:
                demand = leaf_used[0] * 3 // 10 // 100
                sched.enqueue_many([PodSpec(
                    name=f"leaf0-demand-{j}",
                    requests=np.array([demand, 1_024] + [0] * (cs.R - 2),
                                      np.int32),
                    priority=3_000, quota="leaf-0", creation=1e6 + j,
                    preemption_policy="Never") for j in range(100)])
            sched.schedule_round()
    finally:
        smod.preempt_chain, orv.select_overuse_victims = real_chain, real_sel
    full = max(chains, key=lambda a: a[2].shape[0])
    return dict(chain=full, revoke=walks[-1],
                one_quota=cs.k6_problem(161, 50_000, 1, dev,
                                        runtime_frac=0.3))


#: the kernels' names in the profiler's trace, this tree's and the
#: parent's (K5a and K5b, two launches a preemptor)
K5_NAMES = ("preempt_chain_kernel", "victim_select_kernel",
            "victim_commit_kernel")
#: K6's device time by part: the walks' launch, the keys launch (the
#: parent builds the keys with PyTorch calls: none), the sort (cub's radix
#: sort kernels), and every kernel of the call
K6_PARTS = {"walk": ("overuse_revoke_kernel",),
            "keys": ("overuse_keys_kernel",),
            "sort": ("RadixSort", "SortKV", "sort"),
            "all": ("",)}


def preempt_times(args) -> int:
    """K5 on phase 15's first full chain of 256 and K6 on phase 15's round
    3 and on one quota of 50,000 pods, three readings of three calls each
    with CUDA events, and their kernels' device time from torch.profiler
    (K6's by K6_PARTS: the walks, the keys launch, the sort, the whole);
    with ``--grids``, K5 also at those grid sizes (a tree whose wrapper
    takes one).  One JSON line, with a digest of the inputs and the
    outputs: run it for two checkouts in turns to compare them."""
    import inspect

    import torch

    import chip_smoke as cs
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels import overuse_revoke as k6
    from koordinator_tpu_torch.kernels import preemption as k5

    dev = "cuda"
    t0 = time.perf_counter()
    build.lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inp = preempt_inputs(dev)
    setup_s = time.perf_counter() - t0
    chain, revoke, one = inp["chain"], inp["revoke"], inp["one_quota"]
    cases = {
        "k5_chain": lambda: k5.preempt_chain_kernel(*chain),
        "k6_round3": lambda: k6.overuse_revoke_launch(*revoke),
        "k6_one_quota_50000": lambda: k6.overuse_revoke_launch(*one),
    }
    if args.grids and "grid" in inspect.signature(
            k5.preempt_chain_kernel).parameters:
        for g in (int(x) for x in args.grids.split(",")):
            cases[f"k5_chain_grid_{g}"] = (
                lambda g=g: k5.preempt_chain_kernel(*chain, grid=g))
    if hasattr(k5, "VictimCSR"):
        cases["k5_csr_build"] = lambda: k5.VictimCSR(chain[1],
                                                     chain[0].capacity)

        def dry_runs():
            # every preemptor's dry run on the chain's first carry, with
            # no choice, commit or handoff between them
            base_hr = chain[9]
            run = k5.ChainLaunch(*chain[:9], k5.CHAIN, headroom=base_hr,
                                 commit=False)
            run.launch()
            return run.nodes, run.node_rec

        cases["k5_dry_runs_only"] = dry_runs
    out = k5.preempt_chain_kernel(*chain)
    got6 = k6.overuse_revoke_launch(*revoke)[0]
    got1 = k6.overuse_revoke_launch(*one)[0]
    digest_in = [int(t.to(torch.int64).sum()) for t in (
        chain[2], chain[5], chain[1].requests, chain[1].valid,
        revoke[1], revoke[2], one[0].requests)]
    digest_out = [int(t.to(torch.int64).sum()) for t in (
        out.node, out.victims, out.state.node_requested, out.sched.valid,
        out.pdb_allowed, got6, got1)]
    times = {case: [cs.timed_ms(fn, dev, reps=3) for _ in range(3)]
             for case, fn in cases.items()}
    if args.variants is not None:
        libs = build_variants(build, args.variants)
        tree_lib = build.lib()
        ref = digest_out
        try:
            for name, handle in libs.items():
                build._lib = handle
                out = k5.preempt_chain_kernel(*chain)
                d = [int(t.to(torch.int64).sum()) for t in (
                    out.node, out.victims, out.state.node_requested,
                    out.sched.valid, out.pdb_allowed)]
                if d != ref[:5] and name not in INCOMPARABLE:
                    raise RuntimeError(f"{name}: outputs differ from the "
                                       "tree's")
                for case in [c for c in cases if c.startswith("k5_chain")]:
                    times[f"{name}:{case}"] = [
                        cs.timed_ms(cases[case], dev, reps=3)
                        for _ in range(3)]
                if name == "k5_meeting_stamps":
                    stamps = (ctypes.c_ulonglong * 12)()
                    handle.koord_k5_stamps_reset()
                    k5.preempt_chain_kernel(*chain)
                    torch.cuda.synchronize()
                    handle.koord_k5_stamps.argtypes = [ctypes.c_void_p]
                    handle.koord_k5_stamps(ctypes.addressof(stamps))
                    n = max(stamps[6], 1)
                    times["k5_meeting_stamps"] = {
                        k: stamps[i] / n for i, k in enumerate(K5_MEET)}
                if name == "k5_stamps":
                    stamps = (ctypes.c_ulonglong * 12)()
                    handle.koord_k5_stamps_reset()
                    k5.preempt_chain_kernel(*chain)
                    torch.cuda.synchronize()
                    handle.koord_k5_stamps.argtypes = [ctypes.c_void_p]
                    handle.koord_k5_stamps(ctypes.addressof(stamps))
                    sums = dict(zip(K5_STAMPS, stamps))
                    per_node = {k: sums[k] / max(sums["nodes"], 1)
                                for k in K5_STAMPS[:6] if k != "nodes"}
                    per_cta = {k: sums[k] / max(sums["cta_preemptors"], 1)
                               for k in K5_STAMPS[6:9]}
                    times["k5_stamps"] = dict(
                        sums=sums, per_node=per_node,
                        per_cta_preemptor=per_cta)
        finally:
            build._lib = tree_lib
    device = {"k5_chain": [device_ms(cases["k5_chain"], K5_NAMES)
                           for _ in range(3)]}
    for case in ("k6_round3", "k6_one_quota_50000"):
        reads = [device_ms_parts(cases[case], K6_PARTS) for _ in range(3)]
        device[case] = {part: [r[part] for r in reads] for part in K6_PARTS}
    launches = dict(build.LAUNCHES)
    print(json.dumps({
        "preempt": args.root or ".", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.smi_name_power(), "build_s": build_s,
        "setup_s": setup_s, "preemptors": int(chain[2].shape[0]),
        "bound_rows": int(chain[1].valid.sum()), "times": times,
        "device_ms": device, "digest_in": digest_in,
        "digest_out": digest_out, "launches": launches}), flush=True)
    return 0


#: a copy of K4's and K4r's source with clock stamps in CTA 0, a step at a
#: time: 0 the scan starts, 1 the last scanning warp has sent its rank, 2
#: the control warp has found and loaded the next pod, 3 every rank is in,
#: 4 reduced, 5 charged, 6 the next pod published
_STAMP = "if (rank == 0 && step < 4096) "
STEP_STAMPS = [
    ("greedy_scan.cu", "namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_stamps[7][4096];\n"
     "extern \"C\" int koord_step_stamps(unsigned long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n"
     "}\n"
     "extern \"C\" int koord_step_stamps_reset() {\n"
     "  static unsigned long long zero[7][4096];\n"
     "  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n"
     "}\n"),
    ("greedy_scan.cu", "    if (idx < 0) break;\n",
     "    if (idx < 0) break;\n"
     "    if (tid == 0) { " + _STAMP + "g_stamps[0][step] = clock64(); }\n"),
    ("greedy_scan.cu", "                 peer_addr(&s_bar[b], lane));\n",
     "                 peer_addr(&s_bar[b], lane));\n"
     "      if (lane == 0) { " + _STAMP + "atomicMax(&g_stamps[1][step], "
     "(unsigned long long)clock64()); }\n"),
    ("greedy_scan.cu",
     "      mbar_wait(&s_bar[b], static_cast<uint32_t>((step >> 1) & 1));\n",
     "      if (lane == 0) { " + _STAMP
     + "g_stamps[2][step] = clock64(); }\n"
     "      mbar_wait(&s_bar[b], static_cast<uint32_t>((step >> 1) & 1));\n"
     "      if (lane == 0) { " + _STAMP
     + "g_stamps[3][step] = clock64(); }\n"),
    ("greedy_scan.cu",
     "      const bool placed = static_cast<int>(best >> 32) >= 0;\n",
     "      const bool placed = static_cast<int>(best >> 32) >= 0;\n"
     "      if (lane == 0) { " + _STAMP
     + "g_stamps[4][step] = clock64(); }\n"),
    ("greedy_scan.cu", "      rose = __any_sync(kFull, rose);\n",
     "      rose = __any_sync(kFull, rose);\n"
     "      if (lane == 0) { " + _STAMP
     + "g_stamps[5][step] = clock64(); }\n"),
    ("greedy_scan.cu", "      if (lane == 0) s_pod[b ^ 1] = nidx;\n",
     "      if (lane == 0) s_pod[b ^ 1] = nidx;\n"
     "      if (lane == 0) { " + _STAMP
     + "g_stamps[6][step] = clock64(); }\n"),
]


def step_times(args) -> int:
    """Where a step of K4 (1,000 pods x 10,240 nodes) and of K4r (phase
    11's pre-pass) goes: STEP_STAMPS' copy of the sources, one launch
    each, the mean SM cycles of every stretch of a step over its steps
    (CTA 0's clock).  One JSON line a kernel."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.kernels.greedy_scan import (
        greedy_scan_kernel,
        reservation_scan_kernel,
    )

    dev = "cuda"
    lib = build_copy(build, patched_sources("step_stamps", STEP_STAMPS,
                                            build.CSRC))
    lib.koord_step_stamps.argtypes = [ctypes.c_void_p]
    lib.koord_step_stamps_reset.argtypes = []
    for fn in (lib.koord_step_stamps, lib.koord_step_stamps_reset):
        fn.restype = ctypes.c_int
    build._lib = lib
    state, pods = cs.random_problem(21, 10_240, 1_000, dev, "classes")
    quota, pods = cs.quota_setup(pods, dev, 21)
    cfg = cs.scoring_config("default", dev)
    pre = prepass_inputs(dev)
    cases = {
        "k4_1000_pods": lambda: greedy_scan_kernel(state, pods, cfg, quota),
        "k4r_prepass": lambda: reservation_scan_kernel(
            pre["state"], pre["pods"], pre["cfg"], pre["rsv"], pre["match"],
            pre["quota"]),
    }
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        lib.koord_step_stamps_reset()
        fn()
        torch.cuda.synchronize()
        t = np.zeros((7, 4096), np.uint64)
        lib.koord_step_stamps(t.ctypes.data)
        t = t.astype(np.int64)
        steps = int((t[0] > 0).sum())
        n = min(steps, 4096) - 1   # step 0 (setup) and the last left out

        def mean(a, b):
            return float(np.mean(t[b, 1:n] - t[a, 1:n]))

        print(json.dumps(dict(
            kernel=name, nvidia_smi=cs.smi_name_power(), steps=steps,
            cycles=dict(
                step=float(np.mean(t[0, 2:n + 1] - t[0, 1:n])),
                scan=mean(0, 1), last_rank_in=mean(1, 3),
                next_pod_found=mean(0, 2), reduce=mean(3, 4),
                charge=mean(4, 5), recheck_publish=mean(5, 6),
                publish_to_next=float(np.mean(t[0, 2:n + 1] - t[6, 1:n]))))),
              flush=True)
    return 0


def index_add_split(prof, dev_us) -> list:
    """index_add_'s device time (ms) and calls by the shapes of its inputs
    (the table it adds into, the index, the rows added), which tell its
    call sites apart: an (N, R) table is the node accounting, a (Q, R) one
    the quota state of charge_quota_batch (P x chain-depth rows into the
    headroom, P rows into the min headroom)."""
    out = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::index_add_" and dev_us(e) > 0:
            out.append(dict(shapes=e.input_shapes, calls=e.count,
                            device_ms=dev_us(e) / 1e3))
    return sorted(out, key=lambda d: -d["device_ms"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=10_240)
    ap.add_argument("--pods", type=int, default=50_000)
    ap.add_argument("--steady", action="store_true",
                    help="profile a steady-state round of the candidate "
                    "cache instead of a cold round")
    ap.add_argument("--kernels", action="store_true",
                    help="time K1, K2, K3b and K4 at the main shapes "
                    "instead")
    ap.add_argument("--variants", nargs="?", const="", default=None,
                    metavar="PREFIX",
                    help="with --kernels: time the one-change variants too "
                    "(those whose name starts with PREFIX)")
    ap.add_argument("--root", help="the checkout whose port (and "
                    "chip_smoke.py) to time")
    ap.add_argument("--shapes", action="store_true",
                    help="record input shapes; split index_add_'s device "
                    "time by them")
    ap.add_argument("--steps", action="store_true",
                    help="split a step of K4 and K4r into its stretches "
                    "(SM cycles) instead")
    ap.add_argument("--preempt", action="store_true",
                    help="time K5 and K6 at phase 15's shapes instead")
    ap.add_argument("--grids", help="with --preempt: K5 also at these "
                    "grid sizes (comma-separated CTA counts)")
    args = ap.parse_args()
    if args.steps:
        return step_times(args)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        os.chdir(args.root)
    if args.kernels or args.preempt:
        return preempt_times(args) if args.preempt else kernel_times(args)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.scheduler import scheduler as sched_mod

    os.makedirs("chiprun_out", exist_ok=True)
    build.lib()
    if args.steady:
        import numpy as np

        nodes, pods, leaf_max = chip_smoke.steady_specs(3, args.nodes,
                                                        args.pods)
        sched = chip_smoke.steady_scheduler("cuda", nodes, pods, leaf_max,
                                            threshold=1.0)
        rng = np.random.default_rng(5)
        rnd = 0

        def run():
            nonlocal rnd
            if rnd > 0:
                refreshed, new = chip_smoke.steady_delta(rng, nodes, rnd)
                for spec in refreshed:
                    sched.snapshot.upsert_node(spec)
                sched.enqueue_many(new)
            rnd += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = sched.schedule_round()
            torch.cuda.synchronize()
            return result, time.perf_counter() - t0, []

        run()                                   # cold round
        run()                                   # warm-up steady round
        # unprofiled steady rounds: their walls, and Diagnose's host ms
        # where the port has the phase
        walls = []
        for _ in range(STEADY_TIMED):
            result, wall, _ = run()
            walls.append(dict(
                wall_s=wall, failed=len(result.failures),
                diagnose_ms=(sched.last_diagnose_s * 1e3
                             if hasattr(sched, "last_diagnose_s") else None),
                diagnose_parts_ms={
                    k: v * 1e3 for k, v in getattr(
                        sched, "last_diagnose_parts_s", {}).items()}))
        print(json.dumps({"steady_walls": walls,
                          "nvidia_smi": chip_smoke.smi_name_power()}),
              flush=True)
    else:
        def run():
            result, _sched, wall, log, _pods, _nodes = chip_smoke.run_round(
                "cuda", args.nodes, args.pods)
            return result, wall, log

        run()                                   # warm-up

    # host steps of the round, timed around the scheduler's own methods
    phases: dict[str, float] = {}
    wrapped = {}
    for name in ("_active_pods", "_build_quota", "_build_batch",
                 "_dispatch_batch_incremental", "_finish_batch_incremental",
                 "_commit_binds", "_diagnose"):
        real = getattr(sched_mod.Scheduler, name, None)
        if real is None:
            continue                    # a port without the phase
        wrapped[name] = real

        def timed(self, *a, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(self, *a, **kw)
            phases[_name] = phases.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(sched_mod.Scheduler, name, timed)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=args.shapes) as prof:
            result, wall, log = run()
    finally:
        for name, real in wrapped.items():
            setattr(sched_mod.Scheduler, name, real)

    def dev_us(e) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    device_s = sum(dev_us(e) for e in events) / 1e6
    print(json.dumps({
        "round": "steady" if args.steady else "cold",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.smi_name_power(), "pods": args.pods,
        "nodes": args.nodes, "assigned": len(result.assignments),
        "wall_s": wall, "solve_ms": [s["ms"] for s in log],
        "device_busy_s": device_s,
        "device_idle_share": (1.0 - device_s / wall) if wall > 0 else None,
    }), flush=True)
    top = sorted(events, key=dev_us, reverse=True)[:15]
    print(json.dumps({"device_ops": [
        {"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3}
        for e in top]}), flush=True)
    print(json.dumps({"host_phases": phases}), flush=True)
    if args.shapes:
        print(json.dumps({"index_add": index_add_split(prof, dev_us)}),
              flush=True)
    prof.export_chrome_trace(os.path.join(
        "chiprun_out", "steady_trace.json" if args.steady
        else "round_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
