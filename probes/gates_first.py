"""Phase 17's first check on the card: the build with ptxas's register
report (chip_smoke.phase_ptxas), K4r's edges with the negative-request and
INT32_MAX-sentinel cases (chip_smoke.phase_reservation_edges), then phase
17 (chip_smoke.phase_gates: the round's gates through the Scheduler at the
flagship width, on the kernels and again on their plain versions).  Needs
a CUDA device; run from the repository's root:

    python3 probes/gates_first.py
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build

t0 = time.time()
cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
print(cs.smi_name_power(), flush=True)
os.makedirs(cs.OUT_DIR, exist_ok=True)
log = os.path.join(cs.OUT_DIR, "ptxas.txt")
build.build(force=True, log_path=log)
build.lib()
print("build", time.time() - t0, flush=True)
cs.phase_ptxas(log)
t1 = time.time()
cs.phase_reservation_edges("cuda")
print("reservation edges", time.time() - t1, flush=True)
t1 = time.time()
cs.phase_gates("cuda")
print("phase 17", time.time() - t1, flush=True)
print("seconds", time.time() - t0)
