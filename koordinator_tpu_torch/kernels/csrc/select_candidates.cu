// K1: fused Filter + Score + stratified top-k candidate selection.
//
// Replaces, for method="exact" (and "chunked_exact", whose rows are the
// same), the XLA candidate stage of the JAX package:
//   koordinator_tpu/ops/assignment.py:139-166   score_pods (Filter + Score)
//   koordinator_tpu/ops/batch_assign.py:126-154 _rank_parts (ranking key)
//   koordinator_tpu/ops/batch_assign.py:451-525 _reduce_candidates
//   koordinator_tpu/ops/batch_assign.py:182-197 _topk_by_rank (packed regime)
// Its plain PyTorch version is select_candidates_plain in
// kernels/select_candidates.py.
//
// What bounds it on the H100: the work is P*N pairs, each an R=10 loop of
// int32 compares, multiplies and a few integer divisions (operations), and
// the only bytes that must move are the (P, R) / (N, R) inputs and the
// (P, k) outputs.  The XLA version writes three (P, N) int32 tensors to
// device memory (2.6 GB each at 65,536 x 10,240); this kernel writes none:
// each pod's row of N keys lives in registers and is folded, node by node,
// into a running top-k per stratum.
//
// Design: one thread per pod, 128 pods per block.  The block walks the node
// axis in tiles of 64 nodes staged in shared memory; every thread reads the
// same node at the same time, so each shared-memory read is a broadcast.  A
// thread keeps, per stratum, its pod's best 16 (key, node) pairs as a
// sorted list of int64 values in registers (fully unrolled insertion, so
// the list never leaves registers); the list is the pod's final top-k, so
// no merge across threads is needed.  The order is (key descending, node
// ascending), which is lax.top_k's order including the -1 slots of rows
// with fewer feasible nodes than k.  An epilogue re-scores the k chosen
// nodes to emit the stratum-0 key and the clipped score of every slot.
// The pair score and the ranking helpers live in koord_score.cuh, shared
// with K2 and K4.  What it does not yet do: every block re-reads the whole
// node table from L2 (P/128 times in all), which is the first thing to fix
// when it is made fast (larger pod tiles, thread-block clusters sharing one
// tile load).

#include "koord_score.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 128;   // pods per block
constexpr int kTile = 64;       // nodes per shared-memory tile

template <int NS>
__global__ void __launch_bounds__(kThreads) select_candidates_kernel(
    const int* __restrict__ alloc, const int* __restrict__ reqd,
    const int* __restrict__ usage, const int* __restrict__ base,
    const uint8_t* __restrict__ nvalid, const int* __restrict__ nclass,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ rot_g,
    const uint8_t* __restrict__ sel, int C, const uint8_t* __restrict__ feas_t,
    const int* __restrict__ cfg_g, int P, int N, int sb0, int sb1, int k0,
    int k1, int* __restrict__ out_key, int* __restrict__ out_node,
    int* __restrict__ out_score) {
  __shared__ int s_cfg[kCfgLen];
  __shared__ int s_alloc[kTile * kDims];
  __shared__ int s_reqd[kTile * kDims];
  __shared__ int s_use[kTile * kDims];
  __shared__ int s_base[kTile * kDims];
  __shared__ uint8_t s_valid[kTile];
  __shared__ int s_class[kTile];

  const int p = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < kCfgLen; i += kThreads) s_cfg[i] = cfg_g[i];

  const bool in_range = p < P;
  const bool pvalid = in_range && pvalid_g[p];
  int preq[kDims], pest[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    preq[r] = in_range ? preq_g[p * kDims + r] : 0;
    pest[r] = in_range ? pest_g[p * kDims + r] : 0;
  }
  const int rot7919 = in_range ? wmul(rot_g[p], 7919) : 0;
  const unsigned long long mask =
      (pvalid && sel != nullptr) ? selector_bits(sel, p, C) : 0ull;
  const int shifts[2] = {sb0, sb1};
  const int ks[2] = {k0, k1};

  __syncthreads();
  const int la_wsum = loadaware_weight_sum(s_cfg);

  long long lists[NS][kMaxPerStratum];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) lists[s][j] = LLONG_MIN;

  // a block whose pods are all invalid skips the node sweep: every key is
  // -1 and the epilogue's default (the first k columns) is the answer
  const bool any_valid = __syncthreads_or(pvalid);
  if (any_valid) {
    for (int n0 = 0; n0 < N; n0 += kTile) {
      const int tn = min(kTile, N - n0);
      __syncthreads();
      const long long off = static_cast<long long>(n0) * kDims;
      for (int i = threadIdx.x; i < tn * kDims; i += kThreads) {
        s_alloc[i] = alloc[off + i];
        s_reqd[i] = reqd[off + i];
        s_use[i] = usage[off + i];
        s_base[i] = base[off + i];
      }
      for (int i = threadIdx.x; i < tn; i += kThreads) {
        s_valid[i] = nvalid[n0 + i];
        s_class[i] = nclass[n0 + i];
      }
      __syncthreads();
      if (!pvalid) continue;
      for (int t = 0; t < tn; ++t) {
        const int n = n0 + t;
        const bool nv = s_valid[t];
        bool ok;
        const int score = pair_score(preq, pest, s_alloc + t * kDims,
                                     s_reqd + t * kDims, s_use + t * kDims,
                                     s_base + t * kDims, nv, s_cfg, la_wsum,
                                     ok);
        bool feas = ok && nv;
        if (sel != nullptr) {
          feas = feas && selector_ok(mask, s_class[t], C);
        } else {
          feas = feas && feas_t[static_cast<long long>(n) * P + p];
        }
        const int tb = tie_break(n, rot7919, N);
        const int clipped = clip_score(score);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int key = feas ? (((clipped >> shifts[s]) << kTbBits) | tb)
                               : -1;
          insert_sorted(lists[s], rank_of(key, n));
        }
      }
    }
  }
  if (!in_range) return;

  // epilogue: decode each stratum's winners, re-score them for the
  // stratum-0 key and the clipped score of every slot
  const int k_total = k0 + (NS > 1 ? k1 : 0);
  int slot = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) {
      if (j >= ks[s]) break;
      int n, key = -1, cscore = -1;
      if (!pvalid) {
        n = j;  // all keys -1: top_k takes the lowest columns
      } else {
        n = 0x7FFFFFFF - static_cast<int>(lists[s][j] & 0xFFFFFFFFll);
        const long long row = static_cast<long long>(n) * kDims;
        const bool nv = nvalid[n];
        bool ok;
        const int score =
            pair_score(preq, pest, alloc + row, reqd + row, usage + row,
                       base + row, nv, s_cfg, la_wsum, ok);
        bool feas = ok && nv;
        if (sel != nullptr) {
          feas = feas && selector_ok(mask, nclass[n], C);
        } else {
          feas = feas && feas_t[static_cast<long long>(n) * P + p];
        }
        if (feas) {
          cscore = clip_score(score);
          key = ((cscore >> sb0) << kTbBits) | tie_break(n, rot7919, N);
        }
      }
      const long long o = static_cast<long long>(p) * k_total + slot;
      out_key[o] = key;
      out_node[o] = n;
      out_score[o] = cscore;
      ++slot;
    }
  }
}

}  // namespace

extern "C" int koord_select_candidates(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const int* rot_id,
    const uint8_t* sel, int C, const uint8_t* feas_t, const int* cfg,
    int cfg_len, int P, int N, int n_strata, int sb0, int sb1, int k0,
    int k1, int* out_key, int* out_node, int* out_score, void* stream) {
  if (cfg_len != kCfgLen || n_strata < 1 || n_strata > 2 ||
      k0 > kMaxPerStratum || k1 > kMaxPerStratum || C > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + kThreads - 1) / kThreads);
  if (n_strata == 1) {
    select_candidates_kernel<1><<<grid, kThreads, 0, st>>>(
        alloc, reqd, usage, base, nvalid, nclass, preq, pest, pvalid, rot_id,
        sel, C, feas_t, cfg, P, N, sb0, sb1, k0, 0, out_key, out_node,
        out_score);
  } else {
    select_candidates_kernel<2><<<grid, kThreads, 0, st>>>(
        alloc, reqd, usage, base, nvalid, nclass, preq, pest, pvalid, rot_id,
        sel, C, feas_t, cfg, P, N, sb0, sb1, k0, k1, out_key, out_node,
        out_score);
  }
  return static_cast<int>(cudaGetLastError());
}
