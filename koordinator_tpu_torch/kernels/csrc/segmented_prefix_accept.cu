// K3b: segmented priority-order prefix acceptance of a contended round.
//
// Replaces the sorted (contended) path of the JAX round's conflict
// resolution,
//   koordinator_tpu/ops/batch_assign.py:271-296 _prefix_accept_sorted_choice
// which serves the node level (_prefix_accept) and every quota-ancestor
// level (_quota_prefix_accept, :299-330).  Its plain PyTorch version is
// segmented_prefix_accept_plain in kernels/prefix_accept.py.
//
// Input: the pods in priority order (``order``) and then grouped by segment
// with a stable sort (``pos``), so every segment is one run of consecutive
// positions in priority order.  Within a run each pod is accepted when the
// running sum of the run's requests so far, itself included, fits its
// segment headroom on every requested dimension.  That is the JAX scan's
// cum - base prefix: both are the within-segment inclusive sum (the JAX form
// recovers it from one global cumsum, which agrees while the global int32
// sum of non-negative requests does not overflow — 65,536 pods of up to
// 2^15 units stay far below it).  Pods in the overflow segment (inactive
// proposers) are never accepted; the output is zeroed by the wrapper and
// their run is skipped.
//
// What bounds it on the H100: bytes, (2 index + 2R + 2) reads per pod.
// Design: one thread per position; the thread at a run start walks its run
// with R running sums in registers and writes each verdict back through
// order[pos].  Runs are short at the node level (a handful of proposers per
// node); a quota level whose run is the whole batch is walked by one thread,
// which a later kernel should split into a parallel segmented scan.

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) segmented_prefix_accept_kernel(
    const long long* __restrict__ pos, const long long* __restrict__ order,
    const int* __restrict__ seg, const int* __restrict__ req,
    const int* __restrict__ choice_free, const uint8_t* __restrict__ active,
    int P, int overflow, uint8_t* __restrict__ fits_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const long long pod_i = order[pos[i]];
  const int s = seg[pod_i];
  if (s == overflow) return;
  if (i > 0 && seg[order[pos[i - 1]]] == s) return;  // not a run start
  int sums[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r) sums[r] = 0;
  for (int j = i; j < P; ++j) {
    const long long pod = order[pos[j]];
    if (seg[pod] != s) break;
    const bool act = active[pod];
    bool fits = true;
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      const int q = act ? req[pod * kDims + r] : 0;
      sums[r] = wadd(sums[r], q);
      fits = fits && ((sums[r] <= choice_free[pod * kDims + r]) || (q == 0));
    }
    fits_out[pod] = fits && act;
  }
}

}  // namespace

extern "C" int koord_segmented_prefix_accept(
    const long long* pos, const long long* order, const int* seg,
    const int* req, const int* choice_free, const uint8_t* active, int P,
    int overflow, uint8_t* fits_out, void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads);
  segmented_prefix_accept_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      pos, order, seg, req, choice_free, active, P, overflow, fits_out);
  return static_cast<int>(cudaGetLastError());
}
