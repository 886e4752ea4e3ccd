"""K8's step in turns on one card: two checkouts' designs, each in its own
process run from its own root (A, B, B, A), each driving phase 16
(that checkout's ``chip_smoke.phase_topology``: topology gangs through the
Scheduler at the flagship width) with its scheduler's
``gang_offer_slots_many`` calls recorded, then timing the step on each
round's recorded inputs and on round 1's first 16 gangs:

- ``device_ms``: every device activity of one ``gang_offer_slots_many``
  call (K8's kernels and, in a design that builds the node validity with
  torch launches, those launches and their copies), from a torch.profiler
  trace, summed, and by name;
- ``host_ms``: the call on the host clock, synchronised before and after;
- ``k8_part_ms``: the ``k8`` part of ``Scheduler.last_topology_parts_s``
  in the phase's own rounds, and ``unprobed_k8_part_ms`` in a round 1 on
  a fresh scheduler with no probe around it (a probe's work sits in it).

Writes chiprun_out/k8_turns.json.  Needs a CUDA device; run from the
repository's root, with the other checkout unpacked in a directory that
.gitignore lists (``git archive <commit> | tar -x -C probe_results/parent``):

    python3 probes/k8_turns.py probe_results/parent .
"""
import json
import os
import subprocess
import sys
import time

HELD_GANGS = 16


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from koordinator_tpu_torch.kernels import build
    from koordinator_tpu_torch.ops import network_topology as nt
    from koordinator_tpu_torch.scheduler import scheduler as smod

    cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
    t0 = time.perf_counter()
    build.build()
    build.lib()
    build_s = time.perf_counter() - t0
    calls, masks = [], []
    real = smod.gang_offer_slots_many

    def recorded(state, pods, *a, **kw):
        out = real(state, pods, *a, **kw)
        # the inputs as the call saw them: the round pins its members' rows
        # of the mask afterwards, so those rows are kept and put back once
        # the phase is over (the mask by position or by name)
        feas = kw.get("feasible", a[2] if len(a) > 2 else None)
        rows = np.flatnonzero(np.logical_or.reduce(np.asarray(a[0])))
        idx = torch.from_numpy(np.unique(rows)).to(feas.device)
        masks.append((feas, idx, feas[idx]))
        calls.append((cs.clone_state(state), pods, a, kw))
        return out

    smod.gang_offer_slots_many = recorded
    t0 = time.perf_counter()
    records = cs.phase_topology("cuda")[0]
    phase_s = time.perf_counter() - t0
    smod.gang_offer_slots_many = real
    for feas, idx, rows in masks:
        feas[idx] = rows
    # the k8 part of round 1 on a fresh scheduler with no probe around it
    nodes, pods, paths, gpu_rows, gangs, sizes = cs.topology_specs(
        16, 10_240, 50_000)
    sched = cs.topology_scheduler(nodes, paths, gpu_rows, "cuda", 10_240)
    cs.register_topo_gangs(sched, gangs, sizes)
    sched.enqueue_many(pods)
    torch.cuda.synchronize()
    sched.schedule_round()
    unprobed_k8_ms = sched.last_topology_parts_s.get("k8", 0.0) * 1e3
    del sched

    def held(call):
        state, pods, a, kw = call
        return state, pods, (a[0][:HELD_GANGS],) + a[1:], kw

    def measure(call, label: str, reps: int = 10) -> dict:
        state, pods, a, kw = call

        def run():
            return nt.gang_offer_slots_many(state, pods, *a, **kw)

        out = run()
        torch.cuda.synchronize()
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            if us > 0:
                by_name[e.key[:80]] = dict(ms=us / 1e3 / reps,
                                           count=int(e.count) / reps)
        host = np.asarray(host)
        return dict(label=label, gangs=int(out.shape[0]),
                    device_ms=sum(v["ms"] for v in by_name.values()),
                    device_by_name=by_name,
                    host_ms=dict(min=float(host.min()),
                                 median=float(np.median(host)),
                                 max=float(host.max())),
                    slots_sum=int(out.to(torch.int64).sum()))

    out = [measure(call, f"round {k + 1}") for k, call in enumerate(calls)]
    out.append(measure(held(calls[0]), f"round 1's first {HELD_GANGS} "
                                       "gangs"))
    print(json.dumps(dict(
        root=os.getcwd(), build_s=build_s, phase_s=phase_s,
        unprobed_k8_part_ms=unprobed_k8_ms,
        k8_part_ms=[r["topology_parts_ms"].get("k8") for r in records],
        round_wall_s=[r["wall_s"] for r in records], steps=out)),
        flush=True)


def main() -> None:
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    order = roots + roots[::-1]
    me = os.path.abspath(__file__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    results = []
    for k, root in enumerate(order):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, me, "--worker"], cwd=root,
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"turn {k} ({root}) failed")
        got = json.loads(lines[-1])
        got.update(turn=k, seconds=time.perf_counter() - t0)
        results.append(got)
        print(json.dumps({key: got[key] for key in (
            "turn", "root", "seconds", "unprobed_k8_part_ms",
            "k8_part_ms")} | {"steps": [
                dict(label=s["label"], gangs=s["gangs"],
                     device_ms=s["device_ms"], host_ms=s["host_ms"],
                     slots_sum=s["slots_sum"]) for s in got["steps"]]}),
            flush=True)
    # every turn counted the same slots on the same recorded rounds
    sums = {(s["label"], r["turn"]): s["slots_sum"] for r in results
            for s in r["steps"]}
    same = all(len({v for (label, _), v in sums.items() if label == want})
               == 1 for want, _ in sums)
    print(json.dumps(dict(same_slots=same)), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k8_turns.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi.strip(), same_slots=same,
                       turns=results), f, indent=1)


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
    else:
        main()
