"""The observability hooks' cost with ``trace_pods`` off, between two
checkouts of the port on one card: phase 18's rounds (phase 9's setup, a
cold, two steady and a degraded round).  Each root runs in a process of
its own from its own root (its port, its ``chip_smoke.py`` helpers and its
kernels' build), in turns A, B, B, A; each process times a warm-up pass,
then ``--reps`` passes with the timeline recorder and the journey ledger
switched off (``off``) and, where the checkout has them, ``--reps``
passes with both on, their defaults (``defaults``), a fresh scheduler
each pass.  Prints one JSON line a process and writes them all to
``chiprun_out/obs_turns.json``.  Needs a CUDA device:

    git archive <commit> | tar -x -C probe_results/parent
    python3 probes/obs_turns.py probe_results/parent . [--reps 3]
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROUNDS = (("cold", 1.0), ("steady_1", 2.0), ("steady_2", 3.0),
          ("degraded", 9.0))
THRESHOLD_S = 5.0


def one_pass(cs, specs, device: str) -> dict:
    """One fresh scheduler through the rounds; the setup's and each
    round's seconds (host clock, synchronised), and each round's phase
    timings."""
    import numpy as np
    import torch

    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        PodSpec,
    )

    stamps = "arrival_ts" in {f.name for f in dataclasses.fields(PodSpec)}
    nodes0, pods, leaf_max = specs
    nodes = list(nodes0)
    clock = [0.0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = ClusterSnapshot(capacity=len(nodes), device=device)
    for spec in nodes:
        snap.upsert_node(spec)
    sched = Scheduler(snap, quota_tree=cs.steady_tree(nodes, leaf_max),
                      device=device, staleness_threshold_sec=THRESHOLD_S,
                      clock=lambda: clock[0])
    sched.incremental_dirty_threshold = 1.0
    sched.note_sync_event()
    sched.enqueue_many(pods)
    torch.cuda.synchronize()
    out = {"setup": time.perf_counter() - t0}
    rng = np.random.default_rng(18)
    start = 0
    for label, at in ROUNDS:
        new = []
        if label != "cold":
            if label != "degraded":
                for spec in cs.usage_refresh(rng, nodes, len(nodes) // 100):
                    snap.upsert_node(spec)
            new = cs.arrivals(rng, start, 500)
            if stamps:
                new = [dataclasses.replace(p, arrival_ts=time.time())
                       for p in new]
            if label != "degraded":
                clock[0] = at
                sched.note_sync_event()
        clock[0] = at
        start += len(new)
        sched.enqueue_many(new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched.schedule_round()
        torch.cuda.synchronize()
        out[label] = time.perf_counter() - t1
        out[label + "_path"] = sched.last_solve_path
        out[label + "_phases"] = dict(sched.monitor.round_timings)
    return out


def child(reps: int) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from koordinator_tpu_torch.kernels import build

    try:
        from koordinator_tpu_torch import journey, timeline
    except ImportError:
        journey = timeline = None

    def switched(on: bool) -> None:
        if timeline is not None:
            timeline.RECORDER.set_enabled(on)
            journey.LEDGER.set_enabled(on)

    t0 = time.perf_counter()
    build.build()
    build.lib()
    build_s = time.perf_counter() - t0
    specs = cs.steady_specs(3, 10_240, 50_000)
    switched(False)
    warm = one_pass(cs, specs, "cuda")
    out = {"root": os.getcwd(), "kill_switches": timeline is not None,
           "build_s": build_s, "warm_up": warm,
           "off": [one_pass(cs, specs, "cuda") for _ in range(reps)]}
    if timeline is not None:
        switched(True)
        out["defaults"] = [one_pass(cs, specs, "cuda") for _ in range(reps)]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
    a, b = (os.path.abspath(r) for r in args.roots)
    me = os.path.abspath(__file__)
    lines = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, me, "--child", "--reps", str(args.reps)],
            cwd=root, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "obs_turns.json"), "w") as f:
        json.dump(lines, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
