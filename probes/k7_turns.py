"""K7's designs in turns on one card: each source compiled alone into its
own library, then A, B, B, A at each shape on the same seeded inputs,
every output held to the plain version.  Writes chiprun_out/k7_turns.json.

    python3 probes/k7_turns.py probes/k7_v1_explain_counts.cu \
        koordinator_tpu_torch/kernels/csrc/explain_counts.cu

``k7_v1_explain_counts.cu`` is K7's first design (13 counters a pod in
registers, one CTA an SM), kept to compare designs on one card.  Needs a
CUDA device; run from the repository's root.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np
import torch

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels import explain_counts as k7

cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
smi = cs.smi_name_power()
print(smi, flush=True)
out_dir = cs.OUT_DIR
os.makedirs(out_dir, exist_ok=True)
srcs = sys.argv[1:]
libs, logs = [], []
procs = []
for k, src in enumerate(srcs):
    so = os.path.abspath(os.path.join(out_dir, f"k7_variant_{k}.so"))
    procs.append((so, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-I", build.CSRC, src, "-o", so], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)))
for (so, proc), src in zip(procs, srcs):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        print(log)
        sys.exit(1)
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line]
    print(src, regs, flush=True)
    logs.append(dict(src=src, ptxas=regs))
    handle = ctypes.CDLL(so)
    for name in ("koord_explain_counts",):
        fn = getattr(handle, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    fn = handle.koord_explain_counts_scratch_bytes
    fn.argtypes = build._SCRATCH["koord_explain_counts_scratch_bytes"]
    fn.restype = ctypes.c_longlong
    libs.append(handle)

dev = "cuda"
cfg = cs.scoring_config("default", dev)
shapes = []
st, pods = cs.random_problem(81, 10_240, 16_384, dev, "classes")
pv = np.zeros(pods.capacity, bool)
pv[:16_000] = True
shapes.append(("16,000 x 10,240", st, pods.replace(valid=cs.to_dev(pv, dev))))
st2, pods2 = cs.random_problem(82, 10_240, 2_048, dev, "classes")
pv = np.zeros(2_048, bool)
pv[:1_200] = True
shapes.append(("1,200 of 2,048 x 10,240", st2,
               pods2.replace(valid=cs.to_dev(pv, dev))))
st3, pods3 = cs.class_problem(83, 65_536, 16_384, 512, dev)
shapes.append(("16,384 x 65,536, C = 512", st3, pods3))
st4, pods4 = cs.random_problem(84, 10_240, 4_096, dev, "dense")
shapes.append(("dense 4,096 x 10,240", st4, pods4))

real_lib = build.lib
records = []
for label, st, pods in shapes:
    want = k7.explain_counts_plain(st, pods, cfg)
    row = dict(shape=label, **cs.k7_bound(st, pods, cfg), turns=[])
    for k in (0, 1, 1, 0) if len(libs) == 2 else range(len(libs)):
        build.lib = lambda h=libs[k]: h
        got = k7.explain_counts(st, pods, cfg)
        err = max(cs.max_abs_err(got[0], want[0]),
                  cs.max_abs_err(got[1], want[1]))
        ms = cs.timed_ms(lambda: k7.explain_counts(st, pods, cfg), dev,
                         reps=10)
        dms = cs.device_ms_by_kernel(
            lambda: k7.explain_counts(st, pods, cfg),
            ("explain_counts_kernel",), dev)["explain_counts_kernel"]
        row["turns"].append(dict(variant=k, max_abs_err=err, ms=ms,
                                 device_ms=dms))
        cs.check(err == 0, f"variant {k} exact at {label}")
    build.lib = real_lib
    print(json.dumps(row), flush=True)
    records.append(row)
with open(os.path.join(out_dir, "k7_turns.json"), "w") as f:
    json.dump(dict(card=smi, variants=logs, shapes=records), f, indent=1)
