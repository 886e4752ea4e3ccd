"""Phase 18's check on the card alone: the build, then
chip_smoke.phase_observability (phase 9's setup through the Scheduler at
the flagship width, every observability hook off, on and off again, the
runs' binds and launches compared round by round, and the synchronising
calls of one steady round's Solve).  Needs a CUDA device; run from the
repository's root:

    python3 probes/obs_first.py
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
cs.phase_observability("cuda")
print("phase 18", time.time() - t1, flush=True)
print("seconds", time.time() - t0)
