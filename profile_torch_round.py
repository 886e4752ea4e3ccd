#!/usr/bin/env python3
"""Where one scheduling round of the PyTorch port spends its time on the GPU.

    python3 profile_torch_round.py [--nodes 10240] [--pods 50000] [--steady]

Runs the port's main path (``Scheduler.schedule_round`` on the flagship
problem that chip_smoke.py drives) once to warm up, then once under
``torch.profiler`` with CPU and CUDA activities.  With ``--steady`` the
profiled round is a steady-state one instead: chip_smoke.py's phase 9 setup
(the flagship cluster behind the 16-leaf quota tree, the dirty threshold at
1.0), a cold round and one steady round to warm up, then a steady round
after a usage refresh of 1% of the nodes and 500 arrivals.  Prints JSON
lines:

- ``round``: the profiled round's wall time, the summed device time of every
  kernel and copy, and the device's idle share (1 - device / wall);
- ``device_ops``: the operators with the most self device time, with
  their call counts;
- ``host_phases``: wall time of the round's host steps, measured by
  timing the scheduler's own methods.

The trace goes to ``chiprun_out/round_trace.json`` (``steady_trace.json``
with ``--steady``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device is available",
              file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.scheduler import scheduler as sched_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=10_240)
    ap.add_argument("--pods", type=int, default=50_000)
    ap.add_argument("--steady", action="store_true",
                    help="profile a steady-state round of the candidate "
                    "cache instead of a cold round")
    args = ap.parse_args()
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
                 "_commit_binds"):
        real = getattr(sched_mod.Scheduler, name)
        wrapped[name] = real

        def timed(self, *a, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(self, *a, **kw)
            phases[_name] = phases.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(sched_mod.Scheduler, name, timed)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    prof.export_chrome_trace(os.path.join(
        "chiprun_out", "steady_trace.json" if args.steady
        else "round_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
