// K6: the quota overuse revoke walks.
//
// Replaces the JAX package's device program
//   koordinator_tpu/quota/overuse_revoke.py:32 select_overuse_victims
// (its two lax.scans over every bound pod, :63-106).  Its plain PyTorch
// version is select_overuse_victims_plain in quota/overuse_revoke.py;
// kernels/overuse_revoke.py holds the wrapper and a Python mirror.
//
// Each scan step reads and writes only its own quota's used vector, so the
// scans split into independent per-quota walks.  The wrapper lists each
// quota's candidates (valid, preemptible, not protected by an exhausted PDB)
// in ascending importance (priority, then row) once; a warp takes a quota,
// lane d holding dimension d of its used, runtime and checked vectors.
//   phase 1: down the list while the quota is over on a checked dim (one
//            __any_sync a step), each pod tentatively removed; the removals
//            are a prefix, and the walk stops at the first step not over;
//   hopeless = still over after the walk; skipped when the quota also holds
//            a PDB-blocked pod (then no pod goes);
//   phase 2: back up the removed prefix: a hopeless quota that is not
//            skipped loses every removed pod; otherwise a pod comes back when
//            used + request <= runtime on every checked dim (or its request
//            is 0 there), one __all_sync a step.
// int32 arithmetic wraps as the reference's does (koord_common.cuh).
//
// What bounds it on the H100: the dependency chain.  It reads each removed
// pod's request once a phase and each quota's three vectors once (bytes),
// but every step of a quota's walk depends on the one before: the longest
// walk (one request load and one vote a step) sets its floor.

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wsub;

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) overuse_revoke_kernel(
    const int* __restrict__ requests, const int* __restrict__ offsets,
    const int* __restrict__ rows, int Q, const int* __restrict__ used,
    const int* __restrict__ runtime, const uint8_t* __restrict__ checked,
    const uint8_t* __restrict__ has_blocked, uint8_t* __restrict__ revoke,
    int* __restrict__ walk) {
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  const bool dim = lane < kDims;
  const int start = offsets[q], end = offsets[q + 1];
  int u = dim ? used[q * kDims + lane] : 0;
  const int rt = dim ? runtime[q * kDims + lane] : 0;
  const bool ck = dim && checked[q * kDims + lane];

  // phase 1: remove while over
  int pos = start;
  int row = pos < end ? rows[pos] : 0;
  while (pos < end && __any_sync(kFull, ck && u > rt)) {
    const int rd = dim ? requests[row * kDims + lane] : 0;
    ++pos;
    const int next = pos < end ? rows[pos] : 0;  // issued before the vote
    u = wsub(u, rd);
    row = next;
  }
  const int k = pos - start;
  if (lane == 0) walk[q] = k;
  const bool hopeless = __any_sync(kFull, ck && u > rt);
  if (hopeless && has_blocked[q]) return;  // skipped: every pod comes back

  // phase 2: the reprieve, most important first
  for (int p = start + k - 1; p >= start; --p) {
    const int r = rows[p];
    bool back = false;
    if (!hopeless) {
      const int rd = dim ? requests[r * kDims + lane] : 0;
      const bool fit = !dim || rd == 0 || !ck || wadd(u, rd) <= rt;
      back = __all_sync(kFull, fit);
      if (back) u = wadd(u, rd);
    }
    if (!back && lane == 0) revoke[r] = 1;
  }
}

}  // namespace

extern "C" int koord_overuse_revoke(const int* requests, const int* offsets,
                                    const int* rows, int Q, const int* used,
                                    const int* runtime, const uint8_t* checked,
                                    const uint8_t* has_blocked,
                                    uint8_t* revoke, int* walk,
                                    void* stream) {
  if (Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kWarps - 1) / kWarps);
  overuse_revoke_kernel<<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      requests, offsets, rows, Q, used, runtime, checked, has_blocked, revoke,
      walk);
  return static_cast<int>(cudaGetLastError());
}
