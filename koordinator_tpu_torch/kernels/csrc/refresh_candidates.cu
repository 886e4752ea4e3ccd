// K2: incremental candidate refresh over the dirty node columns.
//
// Replaces the XLA program of the JAX package's
//   koordinator_tpu/ops/batch_assign.py:731-806 refresh_candidates
// (score_pods over the gathered dirty rows, then per stratum a top-k of the
// dirty columns merged by a second top-k with the cached slots).  Its plain
// PyTorch version is refresh_candidates_plain in
// kernels/refresh_candidates.py; refresh_from_int32_lists there mirrors
// this kernel's int32 lists and their decoding.
//
// What bounds it on the H100: P x D pairs of the same Filter + Score as K1
// (operations), plus reading and writing the (P, k) cache (bytes).  At the
// steady state's D = 128 dirty columns the work is ~1% of K1's.
//
// Design (K1's, over a dirty-column list):
// - pack_node_rows (koord_score.cuh) packs the D dirty rows into 352-byte
//   rows of pair_score's node terms, magic divisors included, and writes
//   col_of[node] = its column for every listed node: a node is dirty when
//   col_of names a listed column that holds it, so the (N,) dirty mask is
//   never built (the buffer is not cleared between calls: a stale entry
//   fails that check).
// - Four threads a pod, 32 pods a CTA; the CTA stages 32 dirty rows at a
//   time in shared memory, and lane h of a pod scores columns h, h + 4, ...
//   of each tile.  The four lanes merge their lists by shuffles at the end.
// - The per-stratum lists hold int32 values, (key << 1) | cached: int32
//   order is then (key descending, cached before fresh), the order of
//   lax.top_k over the JAX merge's [cached, fresh] among equal keys.
//   Cached slots on dirty nodes are invalidated (score -1) before they are
//   ranked; only valid entries are inserted.
// - Decoding (lane s of the pod for stratum s): a cached value's slot is
//   found among the pod's cached keys (kept in shared memory), the t-th
//   copy of one value taking the t-th slot that holds it; a fresh value's
//   node is the preimage of its global tie-break (the wrap rule:
//   tie_break_preimages in kernels/select_candidates.py) that is dirty,
//   re-scored for its clipped score, and when both preimages are dirty
//   with that key, the t-th copy takes the t-th of their columns in the
//   dirty list.  The merge keeps k_i entries and the cached segment alone
//   holds k_i, so every -1 slot it keeps is a cached one: the -1 slots take
//   the stratum's invalid cached slots in slot order, node and all.

#include "koord_score.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 128;
constexpr int kLanes = 4;                  // threads per pod
constexpr int kPods = kThreads / kLanes;   // pods per CTA
constexpr int kTile = 32;                  // dirty columns per staged tile
constexpr int kTileInts = kTile * kRowInts;
constexpr int kMaxK = 2 * kMaxPerStratum;

// The dirty column holding node n (-1 when n is not dirty).
__device__ __forceinline__ int dirty_col(int n, int N, const int* col_of,
                                         const int* drows,
                                         const uint8_t* dvalid, int D) {
  if (static_cast<unsigned int>(n) >= static_cast<unsigned int>(N)) return -1;
  const int c = col_of[n];
  return (static_cast<unsigned int>(c) < static_cast<unsigned int>(D) &&
          drows[c] == n && dvalid[c])
             ? c
             : -1;
}

template <int NS>
__global__ void __launch_bounds__(kThreads) refresh_candidates_kernel(
    const int* __restrict__ rows, int n_tiles, const int* __restrict__ col_of,
    const int* __restrict__ drows, const uint8_t* __restrict__ dvalid, int D,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ rot_g,
    const uint8_t* __restrict__ sel, int C,
    const __grid_constant__ ScoreCfg cfg,
    const int* __restrict__ cache_node, const int* __restrict__ cache_score,
    int P, int N, int sb0, int sb1, int k0, int k1, int* __restrict__ out_key,
    int* __restrict__ out_node, int* __restrict__ out_score) {
  __shared__ __align__(16) int s_tile[kTileInts];
  __shared__ int s_pq[kDims * kPods];   // each pod's request and estimate,
  __shared__ int s_pe[kDims * kPods];   // a column per pod
  __shared__ int s_ckey[kPods][kMaxK];  // cached slots' keys, -1 invalid

  const int tid = threadIdx.x;
  const int slot = tid / kLanes;
  const int lane = tid % kLanes;
  const int p = blockIdx.x * kPods + slot;
  const bool in_range = p < P;
  const bool pvalid = in_range && pvalid_g[p];
  const int K = k0 + (NS > 1 ? k1 : 0);
  const int rot7919 = in_range ? wmul(rot_g[p], 7919) : 0;
  const long long row0 = static_cast<long long>(p) * K;

  int lists[NS][kMaxPerStratum];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) lists[s][j] = INT_MIN;

  // the cached slots, lane h taking slots h, h + 4, ...: invalidated on
  // dirty nodes, each stratum's key recomputed from the cached raw score
  if (in_range) {
    for (int j = lane; j < K; j += kLanes) {
      const int node = cache_node[row0 + j];
      const int score = cache_score[row0 + j];
      const bool stale = dirty_col(node, N, col_of, drows, dvalid, D) >= 0;
      const int sb = j < k0 ? sb0 : sb1;
      const int key = (score >= 0 && !stale)
                          ? (((score >> sb) << kTbBits) |
                             tie_break(node, rot7919, N))
                          : -1;
      s_ckey[slot][j] = key;
      if (key < 0) continue;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if ((j < k0) == (s == 0)) insert_sorted(lists[s], (key << 1) | 1);
    }
  }

  // the pod's request and estimate (pair_score reads them at dimension
  // indices known at run time)
  PodRef pt;
  {
    int q[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      q[r] = pvalid ? preq_g[p * kDims + r] : 0;
      if (lane == 0) {
        s_pq[r * kPods + slot] = q[r];
        s_pe[r * kPods + slot] = pvalid ? pest_g[p * kDims + r] : 0;
      }
    }
    pt = PodRef{s_pq + slot, s_pe + slot, kPods, pod_scalars(q, cfg)};
  }
  const unsigned long long mask = pvalid ? selector_bits(sel, p, C) : 0ull;

  // the fresh dirty columns (an invalid pod's are all infeasible)
  if (__syncthreads_or(pvalid)) {
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();
      const int4* src = reinterpret_cast<const int4*>(
          rows + static_cast<long long>(t) * kTileInts);
      for (int i = tid; i < kTileInts / 4; i += kThreads)
        reinterpret_cast<int4*>(s_tile)[i] = src[i];
      __syncthreads();
      if (!pvalid) continue;
      for (int i = lane; i < kTile; i += kLanes) {
        // a padding row past D is invalid, hence never feasible
        const PackedRow nr(s_tile + i * kRowInts);
        bool ok;
        const int score = pair_score(nr, pt, cfg, ok);
        if (!(ok && nr.valid() && selector_ok(mask, nr.cls(), C))) continue;
        const int tb = tie_break(nr.node(), rot7919, N);
        const int clipped = clip_score(score);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int key = ((clipped >> (s == 0 ? sb0 : sb1)) << kTbBits) | tb;
          insert_sorted(lists[s], key << 1);
        }
      }
    }
  }
  // merge the pod's kLanes partial lists (a butterfly on values only)
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      int other[kMaxPerStratum];
#pragma unroll
      for (int j = 0; j < kMaxPerStratum; ++j)
        other[j] = __shfl_xor_sync(0xFFFFFFFFu, lists[s][j], off);
#pragma unroll
      for (int j = 0; j < kMaxPerStratum; ++j)
        insert_sorted(lists[s], other[j]);
    }
  }
  __syncwarp();
  if (!in_range) return;

  // epilogue, lane s of the pod for stratum s.  Pass 1: the list's values
  // into the key output (register arrays: the loop is unrolled)
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s % kLanes != lane) continue;
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j)
      if (j < (s == 0 ? k0 : k1))
        out_key[row0 + (s == 0 ? 0 : k0) + j] = lists[s][j];
  }

  // pass 2: each slot's node and score, and the stratum-0 key
  const long long wrap_from = static_cast<long long>(rot7919) + (1ll << 31);
  const bool wraps = wrap_from < N;
  const int rot_mod = fmod_floor(rot7919, N);
  const int two32_mod = static_cast<int>((1ull << 32) % N);
  for (int s = 0; s < NS; ++s) {
    if (s % kLanes != lane) continue;
    const int ks_s = s == 0 ? k0 : k1;
    const int sb = s == 0 ? sb0 : sb1;
    const int off = s == 0 ? 0 : k0;
    int prev = INT_MIN, copy = 0;
    int fill = 0;  // next cached slot to test for the -1 slots
    for (int j = 0; j < ks_s; ++j) {
      const long long o = row0 + off + j;
      const int w = out_key[o];
      int node, score = -1;
      copy = w == prev ? copy + 1 : 0;
      prev = w;
      if (w >= 0 && (w & 1)) {
        // cached: the copy-th slot holding this key
        const int v = w >> 1;
        int i = 0, seen = 0;
        for (; i < ks_s - 1; ++i)
          if (s_ckey[slot][off + i] == v && seen++ == copy) break;
        node = cache_node[row0 + off + i];
        score = cache_score[row0 + off + i];
      } else if (w >= 0) {
        // fresh: the dirty preimage of the tie-break carrying this key
        const int v = w >> 1;
        int n1 = (N - 1) - (v & kScoreClip) + rot_mod;
        if (n1 >= N) n1 -= N;
        int n2 = n1 + two32_mod;
        if (n2 >= N) n2 -= N;
        const bool ok1 = !wraps || n1 < wrap_from;
        const bool ok2 = wraps && n2 >= wrap_from;
        int c1 = ok1 ? dirty_col(n1, N, col_of, drows, dvalid, D) : -1;
        int c2 = ok2 ? dirty_col(n2, N, col_of, drows, dvalid, D) : -1;
        int sc1 = -1, sc2 = -1;
        auto rescore = [&](int c) {
          const PackedRow nr(rows + static_cast<long long>(c) * kRowInts);
          bool ok;
          const int sc = clip_score(pair_score(nr, pt, cfg, ok));
          const bool feas =
              ok && nr.valid() && selector_ok(mask, nr.cls(), C);
          return (feas && (((sc >> sb) << kTbBits) |
                           (v & kScoreClip)) == v)
                     ? sc
                     : -1;
        };
        if (c1 >= 0) sc1 = rescore(c1);
        if (c2 >= 0) sc2 = rescore(c2);
        if (sc1 >= 0 && sc2 >= 0) {
          // both carry the key: the copy-th of their columns, in order
          int seen = 0;
          for (int c = 0; c < D; ++c) {
            if (!dvalid[c] || (drows[c] != n1 && drows[c] != n2)) continue;
            if (seen++ == copy) {
              sc2 = drows[c] == n2 ? sc2 : -1;
              break;
            }
          }
        }
        node = sc2 >= 0 ? n2 : n1;
        score = sc2 >= 0 ? sc2 : sc1;
      } else {
        // a -1 slot: the stratum's next invalid cached slot
        while (fill < ks_s - 1 && s_ckey[slot][off + fill] >= 0) ++fill;
        node = cache_node[row0 + off + fill];
        ++fill;
      }
      out_node[o] = node;
      out_score[o] = score;
      out_key[o] = score >= 0 ? (((score >> sb0) << kTbBits) |
                                 tie_break(node, rot7919, N))
                              : -1;
    }
  }
}

template <int NS>
cudaError_t launch(const int* rows, int n_tiles, const int* col_of,
                   const int* drows, const uint8_t* dvalid, int D,
                   const int* preq, const int* pest, const uint8_t* pvalid,
                   const int* rot_id, const uint8_t* sel, int C,
                   const ScoreCfg& sc, const int* cache_node,
                   const int* cache_score, int P, int N, int sb0, int sb1,
                   int k0, int k1, int* out_key, int* out_node,
                   int* out_score, cudaStream_t st) {
  const dim3 grid((P + kPods - 1) / kPods);
  refresh_candidates_kernel<NS><<<grid, kThreads, 0, st>>>(
      rows, n_tiles, col_of, drows, dvalid, D, preq, pest, pvalid, rot_id,
      sel, C, sc, cache_node, cache_score, P, N, sb0, sb1, k0, k1, out_key,
      out_node, out_score);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the packed dirty rows koord_refresh_candidates needs as scratch
// (D rows padded to whole tiles).
extern "C" long long koord_refresh_candidates_scratch_bytes(int D) {
  const long long tiles = (D + kTile - 1) / kTile;
  return tiles * kTileInts * 4;
}

extern "C" int koord_refresh_candidates(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const int* rot_id,
    const uint8_t* sel, int C, const int* cfg, int cfg_len,
    const int* cache_node, const int* cache_score, const int* drows,
    const uint8_t* dvalid, int D, int P, int N, int n_strata, int sb0,
    int sb1, int k0, int k1, int* rows, int* col_of, int* out_key,
    int* out_node, int* out_score, void* stream) {
  if (cfg_len != kCfgLen || cfg == nullptr || n_strata < 1 ||
      n_strata > 2 || k0 > kMaxPerStratum || k1 > kMaxPerStratum || C > 64 ||
      C < 1 || N < 1 || D < 0 || (reinterpret_cast<uintptr_t>(rows) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  const int n_tiles = (D + kTile - 1) / kTile;
  if (n_tiles > 0) {
    const int n_pad = n_tiles * kTile;
    pack_node_rows<<<(n_pad + 255) / 256, 256, 0, st>>>(
        alloc, reqd, usage, base, nvalid, nclass, sc, N, drows, dvalid, D,
        n_pad, rows, col_of);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      n_strata == 1
          ? launch<1>(rows, n_tiles, col_of, drows, dvalid, D, preq, pest,
                      pvalid, rot_id, sel, C, sc, cache_node, cache_score, P,
                      N, sb0, sb1, k0, 0, out_key, out_node, out_score, st)
          : launch<2>(rows, n_tiles, col_of, drows, dvalid, D, preq, pest,
                      pvalid, rot_id, sel, C, sc, cache_node, cache_score, P,
                      N, sb0, sb1, k0, k1, out_key, out_node, out_score, st);
  return static_cast<int>(err);
}
