"""K8's kernels in variants on one card: copies of csrc/offer_slots.cu,
each with text patches (VARIANTS), compiled alone into its own library
and put behind the wrapper in turns (the variants, then again in reverse)
on one seeded problem at phase 16's round 1 shapes (128 gangs of 8-32
members among 65,536 pods at the flagship's shapes, 10,240 flagship nodes,
the default config, every member feasible everywhere) and on its first 16
gangs.  Every output is held to the first variant's.  A NAME ending in
.cu is a whole source (an earlier design) taken as it is.  ``stamps`` adds
clock64 stamps to the walk and reports, per consumer warp, the SM cycles
of its prologue, of the gangs' validity phase, of its waits for a stage,
its member walks and its zero rows.  Writes chiprun_out/k8_variants.json
and each library's ptxas report (chiprun_out/k8_variants_ptxas.txt).
Needs a CUDA device; run from the repository's root:

    python3 probes/k8_variants.py [NAME ...]
"""
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np

import chip_smoke as cs
from koordinator_tpu_torch.kernels import build
from koordinator_tpu_torch.kernels import offer_slots as k8

SRC = os.path.join(build.CSRC, "offer_slots.cu")
OUT = os.path.join(cs.OUT_DIR, "k8_variants")

STAMPS = [
    ("  const int g_hi = min(G, g_lo + gps);\n",
     "  const int g_hi = min(G, g_lo + gps);\n"
     "  const long long k8s_t0 = clock64();\n"
     "  long long k8s_a = 0, k8s_wait = 0, k8s_walk = 0, k8s_tail = 0;\n"),
    ("  if (warp == kConsumerWarps) {\n    // the producer",
     "  const long long k8s_t1 = clock64();\n"
     "  if (warp == kConsumerWarps) {\n    // the producer"),
    ("    const int cnt = min(kGangChunk, g_hi - ga);\n",
     "    const int cnt = min(kGangChunk, g_hi - ga);\n"
     "    const long long k8s_ta = clock64();\n"),
    ("    for (int i = 0; i < cnt; ++i) {\n      const int m = s_off",
     "    k8s_a += clock64() - k8s_ta;\n"
     "    for (int i = 0; i < cnt; ++i) {\n      const int m = s_off"),
    ("        koord::mbar_wait(&s_full[slot],\n"
     "                         static_cast<uint32_t>((j / kStages) & 1));\n",
     "        long long k8s_c = clock64();\n"
     "        koord::mbar_wait(&s_full[slot],\n"
     "                         static_cast<uint32_t>((j / kStages) & 1));\n"
     "        k8s_wait += clock64() - k8s_c;\n"
     "        k8s_c = clock64();\n"),
    ("        __syncwarp();\n        if (lane == 0) koord::mbar_arrive",
     "        __syncwarp();\n        k8s_walk += clock64() - k8s_c;\n"
     "        if (lane == 0) koord::mbar_arrive"),
    ("      // the zero rows past the members: rows m..P-1, the k-th of them\n",
     "      const long long k8s_z = clock64();\n"
     "      // the zero rows past the members: rows m..P-1, the k-th of them\n"),
    ("      if (in) slots[static_cast<long long>(ga + i) * N + n] = result;\n",
     "      __syncwarp();\n      k8s_tail += clock64() - k8s_z;\n"
     "      if (in) slots[static_cast<long long>(ga + i) * N + n] = result;\n"),
    ("}\n\n}  // namespace\n",
     "  const long long k8s_row = static_cast<long long>(blockIdx.x) *\n"
     "      kConsumerWarps + warp;\n"
     "  if (lane == 0 && k8s_row < (1 << 16)) {\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    long long* o = k8_stamps + k8s_row * 8;\n"
     "    o[0] = k8s_t1 - k8s_t0; o[1] = k8s_a; o[2] = k8s_wait;\n"
     "    o[3] = k8s_walk; o[4] = k8s_tail; o[5] = clock64() - k8s_t0;\n"
     "    o[6] = g_hi - g_lo; o[7] = smid;\n"
     "  }\n}\n\n}  // namespace\n"
     "extern \"C\" int koord_offer_slots_stamps(long long* out, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      out, k8_stamps, static_cast<size_t>(n) * 8 * sizeof(long long)));\n"
     "}\n"),
    ("namespace {\n\nusing koord::kDims;",
     "__device__ long long k8_stamps[(1 << 16) * 8];\n\n"
     "namespace {\n\nusing koord::kDims;"),
]

BOUNDS5 = [("__launch_bounds__(kThreads, 4) offer_slots_walk",
            "__launch_bounds__(kThreads, 5) offer_slots_walk")]

VARIANTS = {
    "tree": [],
    "stamps": STAMPS,
    # 16 and 12 members' words a warp in flight in the validity phase
    "feas16": [("constexpr int kFeasBatch = 8;",
                "constexpr int kFeasBatch = 16;")],
    "feas12": [("constexpr int kFeasBatch = 8;",
                "constexpr int kFeasBatch = 12;")],
    "bounds3": [("__launch_bounds__(kThreads, 4) offer_slots_walk",
                 "__launch_bounds__(kThreads, 3) offer_slots_walk")],
    "bounds5": BOUNDS5,
    # every gang walked on all ten dimensions, as if more than cpu and
    # memory were live
    "generic": [("      const bool two = (live & 0xfffcu) == 0 &&\n"
                 "                       ((live >> kLiveEst) & cfg.thr_mask"
                 " & ~3u) == 0;\n",
                 "      const bool two = false;\n")],
}


def patched(name: str) -> str:
    """The tree's source with VARIANTS[name]'s patches, or the source at
    the path ``name`` (another design kept to compare with)."""
    if name.endswith(".cu"):
        return open(name).read()
    text = open(SRC).read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: its patch no longer applies "
                             f"({old[:60]!r})")
        text = text.replace(old, new, 1)
    return text


def compile_variant(name: str, log) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    tag = os.path.basename(name).replace(".cu", "")
    src = os.path.join(OUT, f"{tag}.cu")
    so = os.path.join(OUT, f"lib{tag}.so")
    with open(src, "w") as f:
        f.write(patched(name))
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
         build.CSRC, src, "-o", so], capture_output=True, text=True)
    log.write(f"== {name}\n{proc.stdout}{proc.stderr}\n")
    if proc.returncode != 0:
        raise SystemExit(f"variant {name} failed to build:\n{proc.stderr}")
    handle = ctypes.CDLL(so)
    for fn, sig in (("koord_offer_slots", build._SIGNATURES),
                    ("koord_offer_slots_resident", build._SCRATCH)):
        getattr(handle, fn).argtypes = sig[fn]
        getattr(handle, fn).restype = (ctypes.c_int if sig is
                                       build._SIGNATURES else
                                       ctypes.c_longlong)
    return handle


def problem(device, n_nodes=10_240, p_rows=65_536, gangs=128, seed=15):
    import torch

    rng = np.random.default_rng(seed)
    state = cs.k8_edge_state(device, n_nodes, seed)
    req = np.zeros((p_rows, cs.R), np.int32)
    req[:, cs.CPU] = rng.integers(100, 4_000, p_rows)
    req[:, cs.MEM] = rng.integers(128, 8_192, p_rows)
    sizes = rng.integers(8, 33, gangs)
    rows = np.concatenate([np.sort(rng.choice(p_rows, m, replace=False))
                           for m in sizes])
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return ((state, torch.from_numpy(req).to(device), offsets, p_rows),
            dict(cfg=cs.scoring_config("default", device), rows=rows,
                 feasible=torch.ones((p_rows, n_nodes), dtype=torch.bool,
                                     device=device)))


def stamp_summary(handle, n_rows: int) -> dict:
    out = (ctypes.c_longlong * (n_rows * 8))()
    err = handle.koord_offer_slots_stamps(out, n_rows)
    if err:
        raise SystemExit(f"stamps: CUDA error {err}")
    a = np.frombuffer(out, dtype=np.int64).reshape(n_rows, 8)
    names = ("prologue", "validity", "wait", "walk", "zero_rows", "total")
    return dict(warps=n_rows, gangs_a_warp=float(a[:, 6].mean()),
                sms=int(len(np.unique(a[:, 7]))),
                mean_cycles={k: float(a[:, i].mean())
                             for i, k in enumerate(names)},
                max_cycles={k: float(a[:, i].max())
                            for i, k in enumerate(names)})


def main() -> None:
    import torch

    names = sys.argv[1:] or list(VARIANTS)
    cs.INT32_OPS_PER_S = cs.int32_ops_per_s()
    smi = cs.smi_name_power()
    print(smi, flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "k8_variants_ptxas.txt"), "w") as log:
        libs = {name: compile_variant(name, log) for name in names}
    device = "cuda"
    whole = problem(device)
    calls = {"whole": whole, "held16": cs.k8_gangs(whole, 0, 16)}
    want = {}
    results = []
    for name in names + names[::-1]:
        build._lib = libs[name]
        for label, call in calls.items():
            got = cs.k8_run(call)
            torch.cuda.synchronize()
            if label not in want:
                want[label] = got
            cs.check(bool(torch.equal(got, want[label])),
                     f"variant {name} equals {names[0]} on {label}")
            rec = dict(variant=name, call=label,
                       ms=cs.timed_ms(lambda c=call: cs.k8_run(c), device,
                                      reps=20),
                       **cs.k8_device_ms(call, device))
            if name == "stamps":
                cs.k8_run(call)
                torch.cuda.synchronize()
                tiles, gps = k8.offer_grid(
                    len(call[0][2]) - 1, call[0][0].capacity,
                    int(libs[name].koord_offer_slots_resident(1)))
                ctas = tiles * -(-(len(call[0][2]) - 1) // gps)
                rec["stamps"] = stamp_summary(libs[name], ctas * 4)
            print(json.dumps(rec), flush=True)
            results.append(rec)
    bound = {label: cs.k8_bound(call, want[label])
             for label, call in calls.items()}
    print(json.dumps(dict(bound=bound)), flush=True)
    with open(os.path.join(cs.OUT_DIR, "k8_variants.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, bound=bound, runs=results), f,
                  indent=1)


if __name__ == "__main__":
    t0 = time.time()
    main()
    print("seconds", time.time() - t0, flush=True)
