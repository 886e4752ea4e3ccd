"""Phase 20's check on the card alone: the build, then
chip_smoke.phase_binary (the port's koord-scheduler binary assembled as a
sidecar on the card beside an in-process twin, the main path's cluster
fed to both, a cold round over the TCP socket, 1,000 pushed pods and a
round on the HTTP gateway under a profile capture, the introspection
surface, the C conformance client against a small assembly, and the
teardown).  Needs a CUDA device and gcc; run from the repository's root:

    python3 probes/binary_first.py
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
with cs.watchdog(cs.BIN_LIMIT_S, "phase 20 (binary)"):
    cs.phase_binary("cuda")
print("phase 20", time.time() - t1, flush=True)
print("seconds", time.time() - t0)
