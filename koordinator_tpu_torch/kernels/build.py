"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface,
``_build/libkoord_kernels.so`` beside this file, and loaded with ``ctypes``.
Each source compiles in its own ``nvcc`` process (all started together), and
the objects link once.  The library is rebuilt when a source's hash changes:
the hash of every source is kept in ``_build/sources.sha256``.

Nothing here runs at import time: the package imports on machines with no
``nvcc`` and no GPU, where the kernels' wrappers take their plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkoord_kernels.so")
_STAMP = os.path.join(BUILD_DIR, "sources.sha256")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(force: bool = False, log_path: str | None = None) -> str:
    """Compile the sources if they changed since the last build; returns
    the library path.  Raises with the compiler's output on failure.
    ``log_path`` adds ``-Xptxas -v`` and writes every compiler message
    there (registers, shared memory and spills per kernel)."""
    digest = _digest()
    if (not force and os.path.exists(LIB_PATH) and os.path.exists(_STAMP)
            and open(_STAMP).read().strip() == digest):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if log_path else ()
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(
            BUILD_DIR, os.path.splitext(os.path.basename(src))[0] + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
    if log_path:
        with open(log_path, "w") as f:
            f.write("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = LIB_PATH + ".tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, LIB_PATH)
    with open(_STAMP, "w") as f:
        f.write(digest + "\n")
    return LIB_PATH


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: exported C functions and their argument types (every one returns the
#: launch's cudaGetLastError() as an int)
_SIGNATURES = {
    "koord_select_candidates": [
        _P, _P, _P, _P, _P, _P,          # node alloc/requested/usage/base/valid/class
        _P, _P, _P, _P,                  # pod requests/estimates/valid/rot_id
        _P, _I, _P, _P,                  # selector mask (P, C) + C, its words' scratch (P, W), dense mask (N, P)
        _P, _I,                          # config int vector + its length
        _I, _I, _I,                      # P, N, strata count
        _I, _I, _I, _I,                  # strata shifts, per-stratum k
        _I, _I, _I, _I, _I,              # approx (K1a)?, its (shift, d) per stratum
        _P,                              # packed node rows scratch
        _P,                              # K1a's rows ranked per instance (2,), or null
        _P, _P, _P,                      # out cand_key, cand_node, cand_score
        _P,                              # out (host int): kernels launched
        _P,                              # stream
    ],
    "koord_round_fit_choose": [
        _P, _P, _P, _P, _P,              # cand_key, cand_node, free, requests, active
        _P,                              # rot_id (wide regime), else null
        _I, _I, _I,                      # P, k, N
        _P, _P,                          # out choice, has
        _P,                              # stream
    ],
    "koord_segmented_prefix_accept": [
        _P, _P, _P, _P, _P,              # node entries' groups, positions, order, requests, headroom
        _I, _I, _I, _I,                  # headroom by pod?, node entries, overflow id, S
        _P, _P, _P, _P, _P, _P,          # quota entries' pods, groups, rows, requests, headroom, min headroom
        _I, _I,                          # quota entries, Q
        _P, _I,                          # (P,) activity, requested-dims bit mask
        _P, _L,                          # look-back scratch + its ints
        _P,                              # out accept (holds the activity on entry)
        _P,                              # stream
    ],
    "koord_refresh_candidates": [
        _P, _P, _P, _P, _P, _P,          # node alloc/requested/usage/base/valid/class
        _P, _P, _P, _P,                  # pod requests/estimates/valid/rot_id
        _P, _I, _P,                      # selector mask (P, C) + C, its words' scratch (P, W)
        _P, _I,                          # config int vector + its length
        _P, _P,                          # cached cand_node, cand_score (P, k)
        _P, _P, _I,                      # dirty rows, valid flags, D
        _I, _I, _I,                      # P, N, strata count
        _I, _I, _I, _I,                  # strata shifts, per-stratum k
        _P, _P,                          # packed dirty rows scratch, (N,) column of each dirty node
        _P, _P, _P,                      # out cand_key, cand_node, cand_score
        _P,                              # stream
    ],
    "koord_greedy_scan": [
        _P, _P, _P, _P, _P, _P,          # node alloc/requested (in/out)/usage/base/valid/class
        _P,                              # node-column scratch
        _P, _P, _P, _P,                  # pod requests/estimates/valid, order
        _P, _I, _P, _P,                  # selector mask (P, C) + C, its words' scratch (P, W), dense mask (P, N)
        _P, _I,                          # config int vector + its length
        _P, _P,                          # quota headroom, min_headroom (in/out)
        _P, _P, _P, _I, _I,              # quota checked, chain, valid, Q, depth
        _P, _P,                          # pod quota_id, non_preemptible
        _I, _I,                          # P, N
        _P,                              # out assignments
        _P,                              # stream
    ],
    "koord_reservation_scan": [
        _P, _P, _P, _P, _P, _P,          # node alloc/requested (in/out)/usage/base/valid/class
        _P,                              # node-column scratch
        _P, _P, _P, _P,                  # pod requests/estimates/valid, order
        _P, _I, _P, _P,                  # selector mask (P, C) + C, its words' scratch (P, W), dense mask (P, N)
        _P, _I,                          # config int vector + its length
        _P, _P,                          # quota headroom, min_headroom (in/out)
        _P, _P, _P, _I, _I,              # quota checked, chain, valid, Q, depth
        _P, _P,                          # pod quota_id, non_preemptible
        _I, _I,                          # P, N
        _P, _I, _I,                      # reservation records (in/out), V, most on a CTA
        _P, _I,                          # (P, V) match in record order, boost
        _P, _P,                          # out assignments, reservation choice
        _P,                              # stream
    ],
    "koord_preempt_chain": [
        _P, _P, _P, _I,                  # node alloc, requested (in/out), valid, N
        _P, _P, _P, _P, _P, _P, _P, _P,  # CSR offsets, rows, priority, quota, PDB, non-preemptible, requests (R, M), rows a node
        _I,                              # M (rows, the CSR's length)
        _P, _P, _P, _P,                  # valid by row (in/out); scratch: flag bytes, dry-run flags (2, M), PDB keys
        _P, _P, _P, _P, _P, _P, _I,      # preemptor requests/priority/quota, feasible, same quota, active, C
        _P, _P, _I,                      # PDB budgets in, out, B
        _I, _P, _P, _P, _I,              # quota mode, headroom, base headroom, assumed (out), Q
        _I, _I,                          # nominate, commit
        _P, _P, _P,                      # out per-node record (dry run alone), nodes, victim list by row
        _P, _P, _P, _P, _I,              # scratch: the CTAs' own budgets and quota (or null), partial keys, node order, arrivals; grid
        _P,                              # stream
    ],
    "koord_explain_counts": [
        _P, _P, _P, _P, _P, _P,          # node alloc/requested/usage/base/valid/class
        _P, _P, _P,                      # pod requests/estimates/valid
        _P, _I, _P, _P,                  # selector mask (P, C) + C, its words' scratch (P, W), dense mask (P, N)
        _P, _I,                          # config int vector + its length
        _I, _I, _I,                      # P, N, reason columns
        _P,                              # scratch: node columns
        _P, _P,                          # out counts (P, 16), feasible (P,)
        _I, _P,                          # grid (explain_grid), out record: pod bound, CTA ranges
        _P,                              # stream
    ],
    "koord_offer_slots": [
        _P, _P, _P, _I,                  # node alloc/requested/base, N
        _P, _P, _P, _I, _I, _I,          # request rows, member rows (or null), offsets (G + 1), G, P, gangs a CTA
        _P, _P,                          # validity: the state's (N,) with member rows, else (G, N); feasible (P, N) or null
        _P, _P,                          # estimator factors, defaults (R,)
        _P, _I,                          # config int vector (or null) + its length
        _P, _P,                          # scratch: cumulative rows (S, 24), totals (G + 1, 24)
        _P,                              # out slots (G, N)
        _P,                              # stream
    ],
    "koord_overuse_keys": [
        _P, _P, _P, _P, _P, _P,          # bound quota, priority, valid, non-preemptible, PDB, budgets (or null)
        _I, _I, _I,                      # B, V, Q
        _P, _P, _P, _P,                  # out keys, counts (Q + 1), blocked (Q + 1), revoke (cleared)
        _P,                              # stream
    ],
    "koord_overuse_revoke": [
        _P, _P, _P, _P, _I,              # bound requests, rows sorted by key, counts, blocked, Q
        _P, _P, _P,                      # used, runtime, checked
        _P, _P,                          # out revoke, walk lengths
        _P,                              # stream
    ],
}


#: exported C functions that size a kernel's global scratch, in bytes (K3b's
#: in int32 words), K1's and K1a's CTAs an SM, K4r's nodes per CTA and
#: launch plan, K5's grid and the CTAs of K7 and K8's walk the card holds
#: at once
_SCRATCH = {
    "koord_select_candidates_scratch_bytes": [_I],      # N
    "koord_select_candidates_ctas_per_sm": [_I],        # 0 K1, 1 K1a int32, 2 K1a 64-bit
    "koord_refresh_candidates_scratch_bytes": [_I],     # D
    "koord_explain_counts_scratch_bytes": [_I],         # N
    "koord_explain_counts_resident": [_I, _I, _P, _I],  # C, dense, config vector + its length
    "koord_greedy_scan_scratch_bytes": [_I, _I, _I],    # N, Q, chain depth
    "koord_reservation_scan_scratch_bytes": [_I, _I, _I],  # N, Q, chain depth
    "koord_reservation_scan_nodes_per_cta": [_I],       # N
    "koord_reservation_scan_plan": [_I, _I, _I, _I],    # N, Q, chain depth, most records a CTA
    "koord_segmented_prefix_accept_scratch_ints": [_L],  # entries
    "koord_preempt_chain_grid": [_I, _I, _I, _I],       # N, B, Q x R, CTAs asked (0: as many as resident)
    "koord_preempt_chain_local_ints": [_I, _I, _I],     # B, Q x R, grid
    "koord_offer_slots_resident": [_I],                 # thresholds on
}


def _bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """``handle`` with its C functions typed."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SCRATCH.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


#: launches per kernel since the last reset_launch_counts(): each wrapper
#: adds one where it launches its kernel, and nowhere else (a plain-version
#: call on CPU tensors launches nothing)
LAUNCHES = {"select_candidates": 0, "select_candidates_approx": 0,
            "refresh_candidates": 0,
            "round_fit_choose": 0, "segmented_prefix_accept": 0,
            "greedy_scan": 0, "reservation_scan": 0,
            "victim_select": 0, "overuse_revoke": 0, "explain_counts": 0,
            "offer_slots": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version's case),
    False when every tensor lies on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def expect(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    (None in ``shape`` accepts any extent)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
