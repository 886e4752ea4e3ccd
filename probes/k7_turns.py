"""K7's designs in turns on one card: each source compiled alone into its
own library, then A, B, B, A at each shape on the same seeded inputs (A,
B, C, C, B, A with three), every output held to the plain version.
Writes chiprun_out/k7_turns.json and each library's SASS
(chiprun_out/k7_sass_<k>.txt, with the loop sizes probes/k7_sass.py reads
from it).

    python3 probes/k7_turns.py probes/k7_v2_explain_counts.cu \
        probes/k7_ballot_explain_counts.cu \
        koordinator_tpu_torch/kernels/csrc/explain_counts.cu

``k7_v1_explain_counts.cu`` is K7's first design (13 counters a pod in
registers, one CTA an SM) and ``k7_v2_explain_counts.cu`` its second
(lane c keeping reason c's count, a ballot a reason over all 10 dims),
kept to compare designs on one card; ``k7_ballot_explain_counts.cu`` is
the third design with a ballot a live reason in place of its 8-bit
counters.  v1 and v2 take the C entry's first signature, which has no
launch plan: a source that exports no ``koord_explain_counts_resident``
is called through ``FirstAbi``, which drops the grid and the record;
every other argument is built by the wrapper itself.  Needs a CUDA
device; run from the repository's root.
"""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import numpy as np

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels import explain_counts as k7
from probes import k7_sass

ENTRY = "koord_explain_counts"


class FirstAbi:
    """A library with the first C entry (no plan) behind the wrapper's
    calls: ``koord_explain_counts`` without the grid and the record, and
    a resident count the wrapper only passes back."""

    def __init__(self, handle):
        self.handle = handle
        sig = build._SIGNATURES[ENTRY]
        fn = getattr(handle, ENTRY)
        fn.argtypes = sig[:-3] + sig[-1:]
        fn.restype = ctypes.c_int
        self.koord_explain_counts_scratch_bytes = (
            handle.koord_explain_counts_scratch_bytes)

    def koord_explain_counts_resident(self, c, dense, cfg, cfg_len):
        return 1

    def koord_explain_counts(self, *args):
        *head, _grid, _record, stream = args
        return getattr(self.handle, ENTRY)(*head, stream)


def load(so: str):
    handle = ctypes.CDLL(so)
    fn = handle.koord_explain_counts_scratch_bytes
    fn.argtypes = build._SCRATCH["koord_explain_counts_scratch_bytes"]
    fn.restype = ctypes.c_longlong
    if not hasattr(handle, "koord_explain_counts_resident"):
        return FirstAbi(handle), "first"
    for name in (ENTRY, "koord_explain_counts_resident"):
        fn = getattr(handle, name)
        fn.argtypes = (build._SIGNATURES.get(name)
                       or build._SCRATCH[name])
        fn.restype = (ctypes.c_int if name == ENTRY else ctypes.c_longlong)
    return handle, "plan"


def main() -> None:
    cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
    smi = cs.smi_name_power()
    print(smi, flush=True)
    out_dir = cs.OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    srcs = sys.argv[1:]
    libs, logs, procs = [], [], []
    for k, src in enumerate(srcs):
        so = os.path.abspath(os.path.join(out_dir, f"k7_variant_{k}.so"))
        procs.append((so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-I", build.CSRC, src, "-o", so], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for k, ((so, proc), src) in enumerate(zip(procs, srcs)):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            sys.exit(1)
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        handle, abi = load(so)
        sass_path = os.path.join(out_dir, f"k7_sass_{k}.txt")
        loops = k7_sass.dump_and_read(so, sass_path)
        print(src, abi, regs, json.dumps(loops), flush=True)
        logs.append(dict(src=src, abi=abi, ptxas=regs, sass_loops=loops))
        libs.append((handle, abi))

    dev = "cuda"
    cfg = cs.scoring_config("default", dev)
    shapes = []
    st, pods = cs.random_problem(81, 10_240, 16_384, dev, "classes")
    pv = np.zeros(pods.capacity, bool)
    pv[:16_000] = True
    shapes.append(("16,000 x 10,240", st,
                   pods.replace(valid=cs.to_dev(pv, dev))))
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
        order = [*range(len(libs)), *reversed(range(len(libs)))]
        for k in order:
            handle, abi = libs[k]
            build.lib = lambda h=handle: h
            got = k7.explain_counts(st, pods, cfg)
            err = max(cs.max_abs_err(got[0], want[0]),
                      cs.max_abs_err(got[1], want[1]))
            ms = cs.timed_ms(lambda: k7.explain_counts(st, pods, cfg), dev,
                             reps=10)
            # the count kernel alone, and the packs of its node columns
            # (pack_node_rows in v1 and v2) and selector words
            dms = cs.device_ms_by_kernel(
                lambda: k7.explain_counts(st, pods, cfg),
                ("explain_counts_kernel", "pack_explain_columns",
                 "pack_node_rows", "pack_selector_words"), dev)
            count_ms = dms.pop("explain_counts_kernel")
            row["turns"].append(dict(variant=k, max_abs_err=err, ms=ms,
                                     device_ms=count_ms,
                                     pack_ms=sum(v or 0.0
                                                 for v in dms.values()),
                                     plan=(dict(
                                         resident=k7.LAST_LAUNCH["resident"],
                                         grid=k7.LAST_LAUNCH["grid"])
                                         if abi == "plan" else None)))
            cs.check(err == 0, f"variant {k} exact at {label}")
        build.lib = real_lib
        print(json.dumps(row), flush=True)
        records.append(row)
    with open(os.path.join(out_dir, "k7_turns.json"), "w") as f:
        json.dump(dict(card=smi, variants=logs, shapes=records), f, indent=1)


if __name__ == "__main__":
    main()
