// K4: the exact sequential greedy scan, one persistent kernel per call.
//
// Replaces the XLA scan of the JAX package's
//   koordinator_tpu/ops/assignment.py:169-280 _greedy_scan (no reservations)
// reached through greedy_assign (:283).  Its plain PyTorch version is
// greedy_assign_plain in ops/assignment.py, a Python loop over pods.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// P dependent steps.  Each pod is filtered and scored against the
// accounting its predecessors left, so step s cannot start before step s-1
// has charged its node and quota.  Per step the work is N pairs of K1's
// Filter + Score (operations) and one pass over the node tensors (~2 MB at
// 10,240 nodes, held in L2).
//
// Design: ONE block of 1,024 threads walks the pods in priority order
// (the order comes from the wrapper, as priority_order computes it).  For
// each valid pod:
//   1. thread 0 answers quota admission, a per-pod scalar over the pod's
//      ancestor chain (quota_admission_mask: headroom at every level on the
//      pod's own checked dims, min headroom at its own quota when it is
//      non-preemptible, the quota row valid); threads 0..R-1 stage the
//      pod's request and estimate in shared memory;
//   2. if admitted, every thread scores its nodes (n = tid, tid + 1024,
//      ...) with pair_score (koord_score.cuh) against node usage plus the
//      in-flight estimates (est_added, wrapping int32 sums), and keeps the
//      best (score, -node) rank; a warp shuffle and a shared-memory pass
//      take the block's maximum, which is jnp.argmax's lowest index on
//      ties;
//   3. thread 0 commits: the node's requested and est_added rows, the
//      assignment, and the quota charge (charge_quota: every ancestor's
//      headroom, and the own quota's min headroom when non-preemptible).
// A barrier closes every step, so the next pod sees the charges.  State
// stays in global memory (node tensors, ~0.8 MB of mutable accounting,
// resident in L2).  An invalid pod is skipped: the JAX scan assigns it -1
// and adds zero.

#include "koord_score.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

__device__ bool quota_admits(const int* preq, int qid_raw, bool np,
                             const int* head, const int* min_head,
                             const uint8_t* checked, const int* chain,
                             const uint8_t* qvalid, int QD) {
  if (head == nullptr || qid_raw < 0) return true;
  const int qid = qid_raw;
  bool ok = true;
  for (int d = 0; d < QD; ++d) {
    const int anc = chain[qid * QD + d];
    if (anc < 0) continue;
    for (int r = 0; r < kDims; ++r) {
      const int q = preq[r];
      if (!(q <= head[anc * kDims + r] || !checked[qid * kDims + r] ||
            q == 0))
        ok = false;
    }
  }
  if (np) {
    for (int r = 0; r < kDims; ++r) {
      const int q = preq[r];
      if (!(q <= min_head[qid * kDims + r] || !checked[qid * kDims + r] ||
            q == 0))
        ok = false;
    }
  }
  return ok && qvalid[qid];
}

__global__ void __launch_bounds__(kThreads, 1) greedy_scan_kernel(
    const int* __restrict__ alloc, int* reqd, const int* __restrict__ usage,
    const int* __restrict__ base, const uint8_t* __restrict__ nvalid,
    const int* __restrict__ nclass, int* est_added,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ order,
    const uint8_t* __restrict__ sel, int C,
    const uint8_t* __restrict__ feas, const int* __restrict__ cfg_g,
    int* q_head, int* q_min, const uint8_t* __restrict__ q_checked,
    const int* __restrict__ q_chain, const uint8_t* __restrict__ q_valid,
    int QD, const int* __restrict__ pquota, const uint8_t* __restrict__ pnp,
    int P, int N, int* __restrict__ out_assign) {
  __shared__ int s_cfg[kCfgLen];
  __shared__ int s_req[kDims];
  __shared__ int s_est[kDims];
  __shared__ long long s_warp[kWarps];
  __shared__ int s_admit;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  for (int i = tid; i < kCfgLen; i += kThreads) s_cfg[i] = cfg_g[i];
  __syncthreads();
  const int la_wsum = loadaware_weight_sum(s_cfg);

  for (int step = 0; step < P; ++step) {
    const int idx = order[step];
    if (!pvalid_g[idx]) continue;  // uniform: every thread reads the flag
    const long long prow = static_cast<long long>(idx) * kDims;
    if (tid < kDims) {
      s_req[tid] = preq_g[prow + tid];
      s_est[tid] = pest_g[prow + tid];
    }
    if (tid == 0) {
      s_admit = quota_admits(preq_g + prow, pquota ? pquota[idx] : -1,
                             pnp ? pnp[idx] != 0 : false, q_head, q_min,
                             q_checked, q_chain, q_valid, QD);
    }
    __syncthreads();
    if (s_admit) {
      const unsigned long long mask =
          sel != nullptr ? selector_bits(sel, idx, C) : 0ull;
      long long best = LLONG_MIN;
      for (int n = tid; n < N; n += kThreads) {
        const long long row = static_cast<long long>(n) * kDims;
        int use[kDims], bs[kDims];
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          const int ea = est_added[row + r];
          use[r] = wadd(usage[row + r], ea);
          bs[r] = wadd(base[row + r], ea);
        }
        const bool nv = nvalid[n];
        bool ok;
        const int score = pair_score(s_req, s_est, alloc + row, reqd + row,
                                     use, bs, nv, s_cfg, la_wsum, ok);
        bool fe = ok && nv;
        if (sel != nullptr) {
          fe = fe && selector_ok(mask, nclass[n], C);
        } else {
          fe = fe && feas[static_cast<long long>(idx) * N + n];
        }
        best = max(best, rank_of(fe ? score : -1, n));
      }
      best = warp_max(best);
      if (lane == 0) s_warp[wid] = best;
      __syncthreads();
      if (wid == 0) {
        best = warp_max(s_warp[lane]);
        const int value = static_cast<int>(best >> 32);
        if (lane == 0 && value >= 0) {
          const int node = 0x7FFFFFFF -
                           static_cast<int>(best & 0xFFFFFFFFll);
          const long long row = static_cast<long long>(node) * kDims;
          out_assign[idx] = node;
          for (int r = 0; r < kDims; ++r) {
            reqd[row + r] = wadd(reqd[row + r], s_req[r]);
            est_added[row + r] = wadd(est_added[row + r], s_est[r]);
          }
          const int qid = pquota ? pquota[idx] : -1;
          if (q_head != nullptr && qid >= 0 && q_valid[qid]) {
            for (int d = 0; d < QD; ++d) {
              const int anc = q_chain[qid * QD + d];
              if (anc < 0) continue;
              for (int r = 0; r < kDims; ++r)
                q_head[anc * kDims + r] =
                    wsub(q_head[anc * kDims + r], s_req[r]);
            }
            if (pnp[idx]) {
              for (int r = 0; r < kDims; ++r)
                q_min[qid * kDims + r] = wsub(q_min[qid * kDims + r],
                                              s_req[r]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int koord_greedy_scan(
    const int* alloc, int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, int* est_added,
    const int* preq, const int* pest, const uint8_t* pvalid,
    const int* order, const uint8_t* sel, int C, const uint8_t* feas,
    const int* cfg, int cfg_len, int* q_head, int* q_min,
    const uint8_t* q_checked, const int* q_chain, const uint8_t* q_valid,
    int QD, const int* pquota, const uint8_t* pnp, int P, int N,
    int* out_assign, void* stream) {
  if (cfg_len != kCfgLen || C > 64 || (sel == nullptr) == (feas == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  greedy_scan_kernel<<<1, kThreads, 0, st>>>(
      alloc, reqd, usage, base, nvalid, nclass, est_added, preq, pest, pvalid,
      order, sel, C, feas, cfg, q_head, q_min, q_checked, q_chain, q_valid,
      QD, pquota, pnp, P, N, out_assign);
  return static_cast<int>(cudaGetLastError());
}
