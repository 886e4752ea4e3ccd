// K3a: one propose/accept round's proposal step — candidate fit and choice.
//
// Replaces the fit-and-choose part of the JAX round body,
//   koordinator_tpu/ops/batch_assign.py:606-620 _assign_rounds.round_body
//   koordinator_tpu/ops/batch_assign.py:576-588 _choose_candidate
// in both key regimes.  Its plain PyTorch version is round_fit_choose_plain
// in kernels/round_fit_choose.py.
//
// For every active pod it gathers free[cand_node] (k rows of R values),
// tests req <= free | req == 0 on every dimension, and takes the fitting
// candidate with the largest key (the first slot wins a tie, slot 0 when
// none fits).  In the wide regime (rot_id given, N > 2^15) it ranks by
// (key, tb) instead: the JAX package's two-stage argmax (max key, then
// max tb among the fitting slots at that key) is the argmax of the 64-bit
// rank key * 2^32 + tb, tb recomputed from the slot's node and the pod's
// rotation id rather than read from a (P, k) tensor.  Inactive pods report
// has = false and slot 0's node.
//
// What bounds it on the H100: bytes.  Per active pod it reads k keys, k
// node ids, k*R free values and R requests, and does about k*R compares, so
// it is a gather of (k*R + 2k + R)*4 bytes per pod with almost no
// arithmetic.  Design: one warp per pod, lane j owns candidate j (k <= 32),
// so the key and node reads are coalesced and each lane's free row is one
// 40-byte read; the argmax is a five-step shuffle reduction over
// (key, slot).  Inactive pods exit after one load, which is most pods after
// the first round.

#include <climits>

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::tie_break;
using koord::wmul;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) round_fit_choose_kernel(
    const int* __restrict__ cand_key, const int* __restrict__ cand_node,
    const int* __restrict__ free_cap, const int* __restrict__ req,
    const uint8_t* __restrict__ active, const int* __restrict__ rot_id,
    int P, int K, int N, int* __restrict__ choice,
    uint8_t* __restrict__ has) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;
  const long long row = static_cast<long long>(p) * K;
  if (!active[p]) {
    if (lane == 0) {
      choice[p] = cand_node[row];
      has[p] = 0;
    }
    return;
  }
  long long masked = LLONG_MIN;  // lanes past k never win
  if (lane < K) {
    const int key = cand_key[row + lane];
    const int node = cand_node[row + lane];
    bool fits = key >= 0;
    if (fits) {
      const long long n = node;
#pragma unroll
      for (int r = 0; r < kDims; ++r) {
        const int q = req[static_cast<long long>(p) * kDims + r];
        fits = fits && ((q <= free_cap[n * kDims + r]) || (q == 0));
      }
    }
    // packed: the key alone; wide: key * 2^32 + tb
    masked = !fits ? -1
             : rot_id == nullptr
                 ? key
                 : (static_cast<long long>(key) << 32) |
                       tie_break(node, wmul(rot_id[p], 7919), N);
  }
  // argmax with the lowest slot winning ties (jnp.argmax's order)
  long long best = masked;
  int slot = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ob = __shfl_down_sync(0xffffffffu, best, off);
    const int os = __shfl_down_sync(0xffffffffu, slot, off);
    if (ob > best || (ob == best && os < slot)) {
      best = ob;
      slot = os;
    }
  }
  if (lane == 0) {
    // a fitting slot has key >= 0, so masked >= 0 <=> it fits
    has[p] = best >= 0;
    choice[p] = cand_node[row + slot];
  }
}

}  // namespace

extern "C" int koord_round_fit_choose(const int* cand_key,
                                      const int* cand_node, const int* free_cap,
                                      const int* req, const uint8_t* active,
                                      const int* rot_id, int P, int K, int N,
                                      int* choice, uint8_t* has,
                                      void* stream) {
  if (K < 1 || K > 32 || N < 1 ||
      (rot_id != nullptr) != (N > koord::kPackedNodeCapacity))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  round_fit_choose_kernel<<<grid, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cand_key, cand_node, free_cap, req, active, rot_id, P, K, N, choice,
      has);
  return static_cast<int>(cudaGetLastError());
}
