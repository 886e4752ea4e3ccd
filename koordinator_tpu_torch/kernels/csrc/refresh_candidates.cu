// K2: incremental candidate refresh over the dirty node columns.
//
// Replaces the XLA program of the JAX package's
//   koordinator_tpu/ops/batch_assign.py:731-806 refresh_candidates
// (score_pods over the gathered dirty rows, then per stratum a top-k of the
// dirty columns merged by a second top-k with the cached slots).  Its plain
// PyTorch version is refresh_candidates_plain in
// kernels/refresh_candidates.py.
//
// What bounds it on the H100: P x D pairs of the same Filter + Score as K1
// (operations), plus reading and writing the (P, k) cache (bytes).  At the
// steady state's D = 128 dirty columns the work is ~1% of K1's.
//
// Design: one thread per pod, 128 pods per block, as in K1.  A thread first
// loads its k cached slots; a slot on a dirty node is invalidated (score
// -1), and each stratum's ranking key is recomputed from the cached raw
// score and node (_candidate_keys).  The block then stages the gathered
// dirty rows 64 at a time in shared memory as pair_score's node terms,
// and streams them through pair_score (koord_score.cuh,
// the one definition K1 and K4 compile too), with the tie-break taken on
// the GLOBAL node id.  Every entry goes into a per-stratum sorted list of
// int64 ranks in registers:
//   high word: the ranking key;
//   low word:  (0xFFFF - position) << 15 | clipped score,
// where position is the slot (cached entries, 0..k_i-1) or k_i + the dirty
// column (fresh entries).  int64 order is then (key descending, position
// ascending), the order lax.top_k gives the JAX merge over [cached, fresh],
// and the score rides along without a parallel array.
//
// Exactness notes.  Valid keys are unique per stratum (the tie-break is a
// permutation of node ids), so only the -1 entries depend on position.  The
// merge keeps k_i entries and the cached segment alone holds k_i, so every
// -1 entry it keeps is a cached one: fresh infeasible columns (the padded
// dirty entries among them) are never kept and are not inserted.  That is
// also why the JAX version's two branches (k_i < D: top-k of the dirty
// columns first; k_i >= D: all of them) give the same result here: the
// fresh entries that can be kept are the valid ones, in key order.

#include "koord_score.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 128;   // pods per block
constexpr int kTile = 64;       // dirty columns per shared-memory tile
constexpr int kMaxPosition = 0xFFFF;

__device__ __forceinline__ bool in_nodes(int row, int N) {
  return static_cast<unsigned int>(row) < static_cast<unsigned int>(N);
}

__device__ __forceinline__ long long pack_entry(int key, int position,
                                                int score) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<long long>(key)) << 32;
  const unsigned int lo =
      (static_cast<unsigned int>(kMaxPosition - position) << 15) |
      static_cast<unsigned int>(score & kScoreClip);
  return static_cast<long long>(hi | lo);
}

template <int NS>
__global__ void __launch_bounds__(kThreads) refresh_candidates_kernel(
    const int* __restrict__ alloc, const int* __restrict__ reqd,
    const int* __restrict__ usage, const int* __restrict__ base,
    const uint8_t* __restrict__ nvalid, const int* __restrict__ nclass,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ rot_g,
    const uint8_t* __restrict__ sel, int C,
    const __grid_constant__ ScoreCfg cfg,
    const int* __restrict__ cache_node, const int* __restrict__ cache_score,
    const int* __restrict__ drows, const uint8_t* __restrict__ dvalid, int D,
    const uint8_t* __restrict__ dmask, int P, int N, int sb0, int sb1,
    int k0, int k1, int* __restrict__ out_key, int* __restrict__ out_node,
    int* __restrict__ out_score) {
  __shared__ int s_alloc[kTile * kDims];
  __shared__ int s_free[kTile * kDims];
  __shared__ int s_use[kTile * kDims];
  __shared__ int s_thx[kTile * kDims];
  __shared__ int s_thy[kTile * kDims];
  __shared__ uint32_t s_mag[kTile * kDims];
  __shared__ uint8_t s_shf[kTile * kDims];
  __shared__ uint32_t s_flags[kTile];
  __shared__ int s_class[kTile];
  __shared__ int s_row[kTile];
  __shared__ int s_pq[kDims * kThreads];   // each pod's request and
  __shared__ int s_pe[kDims * kThreads];   // estimate, a column per thread

  const int p = blockIdx.x * kThreads + threadIdx.x;

  const bool in_range = p < P;
  const bool pvalid = in_range && pvalid_g[p];
  const int K = k0 + (NS > 1 ? k1 : 0);
  const int shifts[2] = {sb0, sb1};
  const int ks[2] = {k0, k1};
  const int rot7919 = in_range ? wmul(rot_g[p], 7919) : 0;

  long long lists[NS][kMaxPerStratum];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) lists[s][j] = LLONG_MIN;

  // the cached slots, invalidated on dirty nodes, keys recomputed per
  // stratum from the cached raw score
  if (in_range) {
    const long long row = static_cast<long long>(p) * K;
    int off = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      for (int j = 0; j < ks[s]; ++j) {
        const int node = cache_node[row + off + j];
        int score = cache_score[row + off + j];
        if (in_nodes(node, N) && dmask[node]) {
          score = -1;
        }
        const int key =
            score >= 0
                ? (((score >> shifts[s]) << kTbBits) |
                   tie_break(node, rot7919, N))
                : -1;
        insert_sorted(lists[s], pack_entry(key, j, score));
      }
      off += ks[s];
    }
  }

  const unsigned long long mask = pvalid ? selector_bits(sel, p, C) : 0ull;

  __syncthreads();
  PodRef pt;
  {
    const int tid = threadIdx.x;
    int q[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      q[r] = pvalid ? preq_g[p * kDims + r] : 0;
      s_pq[r * kThreads + tid] = q[r];
      s_pe[r * kThreads + tid] = pvalid ? pest_g[p * kDims + r] : 0;
    }
    pt = PodRef{s_pq + tid, s_pe + tid, kThreads, pod_scalars(q, cfg)};
  }

  // the fresh dirty columns (an invalid pod's are all infeasible)
  const bool any_valid = __syncthreads_or(pvalid);
  if (any_valid) {
    for (int d0 = 0; d0 < D; d0 += kTile) {
      const int tn = min(kTile, D - d0);
      __syncthreads();
      // a row outside [0, N) is read as row 0 and scored as invalid; each
      // staged row gets its node terms (koord_score.cuh: node_dim_terms)
      for (int i = threadIdx.x; i < tn * kDims; i += kThreads) {
        const int row = drows[d0 + i / kDims];
        const bool in = in_nodes(row, N);
        const int r = i % kDims;
        const long long src = static_cast<long long>(in ? row : 0) * kDims + r;
        const bool nv = in && nvalid[in ? row : 0] && dvalid[d0 + i / kDims];
        const int a = alloc[src];
        const DimTerms t = node_dim_terms(a, reqd[src], base[src], nv,
                                          cfg.thr[r]);
        s_alloc[i] = a;
        s_free[i] = t.fr;
        s_use[i] = usage[src];
        s_thx[i] = t.thx;
        s_thy[i] = t.thy;
        s_mag[i] = t.mg.m;
        s_shf[i] = static_cast<uint8_t>(t.mg.l);
      }
      for (int i = threadIdx.x; i < tn; i += kThreads) {
        const int row = drows[d0 + i];
        const bool in = in_nodes(row, N);
        const long long src = static_cast<long long>(in ? row : 0) * kDims;
        uint32_t flags =
            (in && nvalid[in ? row : 0] && dvalid[d0 + i]) ? kValidFlag : 0u;
        for (int r = 0; r < kDims; ++r)
          if (alloc[src + r] > 0) flags |= 1u << r;
        s_row[i] = row;
        s_flags[i] = flags;
        s_class[i] = nclass[in ? row : 0];
      }
      __syncthreads();
      if (!pvalid) continue;
      for (int t = 0; t < tn; ++t) {
        const int o = t * kDims;
        const StridedRow nr{s_alloc + o, s_free + o, s_use + o, s_thx + o,
                            s_thy + o,   s_mag + o,  s_shf + o, 1,
                            s_flags[t]};
        const bool nv = (nr.flags & kValidFlag) != 0;
        bool ok;
        const int score = pair_score(nr, pt, cfg, ok);
        if (!(ok && nv && selector_ok(mask, s_class[t], C))) continue;
        const int tb = tie_break(s_row[t], rot7919, N);
        const int clipped = clip_score(score);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int key = ((clipped >> shifts[s]) << kTbBits) | tb;
          insert_sorted(lists[s], pack_entry(key, ks[s] + d0 + t, clipped));
        }
      }
    }
  }
  if (!in_range) return;

  // decode each stratum's k_i winners; the stratum-0 key of every slot
  // (_candidate_keys over the merged scores)
  const long long row = static_cast<long long>(p) * K;
  int off = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) {
      if (j >= ks[s]) break;
      const long long v = lists[s][j];
      const int key = static_cast<int>(v >> 32);
      const unsigned int lo = static_cast<unsigned int>(v & 0xFFFFFFFFll);
      const int position = kMaxPosition - static_cast<int>(lo >> 15);
      const int node = position < ks[s] ? cache_node[row + off + position]
                                        : drows[position - ks[s]];
      const int score = key >= 0 ? static_cast<int>(lo & kScoreClip) : -1;
      out_node[row + off + j] = node;
      out_score[row + off + j] = score;
      out_key[row + off + j] =
          score >= 0 ? (((score >> sb0) << kTbBits) |
                        tie_break(node, rot7919, N))
                     : -1;
    }
    off += ks[s];
  }
}

}  // namespace

extern "C" int koord_refresh_candidates(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const int* rot_id,
    const uint8_t* sel, int C, const int* cfg, int cfg_len,
    const int* cache_node, const int* cache_score, const int* drows,
    const uint8_t* dvalid, int D, const uint8_t* dmask, int P, int N,
    int n_strata, int sb0, int sb1, int k0, int k1, int* out_key,
    int* out_node, int* out_score, void* stream) {
  if (cfg_len != kCfgLen || cfg == nullptr || n_strata < 1 ||
      n_strata > 2 ||
      k0 > kMaxPerStratum || k1 > kMaxPerStratum || C > 64 || C < 1 ||
      D + kMaxPerStratum > kMaxPosition) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  const dim3 grid((P + kThreads - 1) / kThreads);
  if (n_strata == 1) {
    refresh_candidates_kernel<1><<<grid, kThreads, 0, st>>>(
        alloc, reqd, usage, base, nvalid, nclass, preq, pest, pvalid, rot_id,
        sel, C, sc, cache_node, cache_score, drows, dvalid, D, dmask, P, N,
        sb0, sb1, k0, 0, out_key, out_node, out_score);
  } else {
    refresh_candidates_kernel<2><<<grid, kThreads, 0, st>>>(
        alloc, reqd, usage, base, nvalid, nclass, preq, pest, pvalid, rot_id,
        sel, C, sc, cache_node, cache_score, drows, dvalid, D, dmask, P, N,
        sb0, sb1, k0, k1, out_key, out_node, out_score);
  }
  return static_cast<int>(cudaGetLastError());
}
