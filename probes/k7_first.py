"""K7's first check on the card: the build with ptxas's register report,
the edges (chip_smoke.phase_explain_edges), and K7 against its plain
version and timed at the main path's sizes on seeded random problems
(16,000 x 10,240, 1,200 of 2,048 x 10,240, 16,384 x 65,536 with 512
classes).  Needs a CUDA device; run from the repository's root:

    python3 probes/k7_first.py
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np
import torch

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels.select_candidates import _pod_rows

t0 = time.time()
cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
print(cs.smi_name_power(), flush=True)
os.makedirs(cs.OUT_DIR, exist_ok=True)
log = os.path.join(cs.OUT_DIR, "ptxas.txt")
build.build(force=True, log_path=log)
build.lib()
print("build", time.time() - t0, flush=True)
cs.phase_ptxas(log)
cs.phase_explain_edges("cuda")
dev = "cuda"
cfg = cs.scoring_config("default", dev)
st, pods = cs.random_problem(81, 10_240, 16_384, dev, "classes")
pv = np.zeros(pods.capacity, bool)
pv[:16_000] = True
pods = pods.replace(valid=cs.to_dev(pv, dev))
cs.held_k7(dev, (st, pods, cfg), "16,000 x 10,240 (classes)")
st2, pods2 = cs.random_problem(82, 10_240, 2_048, dev, "classes")
pv = np.zeros(2_048, bool)
pv[:1_200] = True
cs.held_k7(dev, (st2, pods2.replace(valid=cs.to_dev(pv, dev)), cfg),
           "1,200 of 2,048 x 10,240")
st3, pods3 = cs.class_problem(83, 65_536, 16_384, 512, dev)
cs.held_k7(dev, (st3, pods3, cfg), "16,384 x 65,536, C = 512", reps=3)
print("seconds", time.time() - t0)
