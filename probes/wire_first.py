"""Phase 19's check on the card alone: the build, then
chip_smoke.phase_wire (the main path's cluster in a StateSyncService on a
unix socket, a Scheduler bootstrapped from it through StateSyncClient and
SchedulerBinding, a cold round through solve_remote, a burst of live
pushes, a fresh Scheduler bootstrapped after it binding as the live one,
and a round solved while pushes arrive).  Needs a CUDA device; run from
the repository's root:

    python3 probes/wire_first.py
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build

t0 = time.time()
print(cs.smi_name_power(), flush=True)
os.makedirs(cs.OUT_DIR, exist_ok=True)
build.build(force=True, log_path=os.path.join(cs.OUT_DIR, "ptxas.txt"))
build.lib()
print("build", time.time() - t0, flush=True)
t1 = time.time()
with cs.watchdog(cs.WIRE_LIMIT_S, "phase 19 (wire)"):
    cs.phase_wire("cuda")
print("phase 19", time.time() - t1, flush=True)
print("seconds", time.time() - t0)
