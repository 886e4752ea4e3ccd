// K2: incremental candidate refresh over the dirty node columns.
//
// Replaces the XLA program of the JAX package's
//   koordinator_tpu/ops/batch_assign.py:731-806 refresh_candidates
// (score_pods over the gathered dirty rows, then per stratum a top-k of the
// dirty columns merged by a second top-k with the cached slots).  Its plain
// PyTorch version is refresh_candidates_plain in
// kernels/refresh_candidates.py; refresh_from_int32_lists (packed regime)
// and refresh_from_wide_lists (wide regime) there mirror this kernel's
// lists and their decoding.
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
// - Wide regime (N > 2^15, the kWide instances): the JAX merge ranks by
//   (key, tb), and among equal pairs keeps the higher position of its
//   [cached, fresh] concatenation first.  -1 entries rank by tb too, so
//   infeasible dirty columns (padded ones included) can reach the output.
//   Every entry is therefore a pair (wide_rank(key, tb), word), ordered
//   lexicographically, whose order is the whole order and whose 32-bit
//   word names the entry: stage 1, the fresh top-k_i over every dirty
//   column (the word the column: (key, tb, column) descending, the JAX
//   dirty top-k); stage 2, the k_i cached slots (the word the slot)
//   merged with the fresh entries (a fresh bit over the column, inverted
//   when the list is longer than k_i: the JAX positions k_i + rank
//   reverse stage 1 among equal pairs, k_i + column keep the higher
//   column first).  Decoding reads the word; no preimage search.  The
//   word sits beside the rank, not inside it, so any N up to 2^30 and
//   any D up to 2^31 - 1 fit.
// - Selector classes: the launch packs each pod's row into words, as K1's
//   does (pack_selector_words, SelRow; koord_score.cuh).

#include <type_traits>

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

// The wide regime's list entries: (rank, word) pairs in descending
// lexicographic order.  The empty entry (LLONG_MIN, 0) is below every
// rank (wide_rank(-1, 0) = -2^30 at the least).
constexpr unsigned int kFresh = 0x80000000u;  // a fresh entry's word bit
constexpr unsigned int kColMax = 0x7FFFFFFFu;

__device__ __forceinline__ bool pair_gt(long long a, unsigned int aw,
                                        long long b, unsigned int bw) {
  return a > b || (a == b && aw > bw);
}

// insert_sorted for the pair lists (v, w): drop the smallest pair.
__device__ __forceinline__ void insert_pair(long long (&v)[kMaxPerStratum],
                                            unsigned int (&w)[kMaxPerStratum],
                                            long long x, unsigned int xw) {
  if (!pair_gt(x, xw, v[kMaxPerStratum - 1], w[kMaxPerStratum - 1])) return;
#pragma unroll
  for (int j = kMaxPerStratum - 1; j > 0; --j) {
    const bool above = pair_gt(x, xw, v[j - 1], w[j - 1]);
    const bool here = pair_gt(x, xw, v[j], w[j]);
    v[j] = above ? v[j - 1] : (here ? x : v[j]);
    w[j] = above ? w[j - 1] : (here ? xw : w[j]);
  }
  if (pair_gt(x, xw, v[0], w[0])) {
    v[0] = x;
    w[0] = xw;
  }
}

// Merge the pair list (v, w) with the same list of the lane ``off`` away
// (a butterfly step), keeping the top kMaxPerStratum in order: c[i] =
// max(a[i], b[K-1-i]) of two descending lists is bitonic and holds the
// top K of the union, which a bitonic merger then sorts.  Slots i and
// K-1-i are exchanged together, so each shuffle reads the partner's list
// before either lane changes those slots; six registers of scratch,
// where a copy of the partner's list would take 48.
__device__ __forceinline__ void merge_pairs(long long (&v)[kMaxPerStratum],
                                            unsigned int (&w)[kMaxPerStratum],
                                            int off) {
  constexpr int K = kMaxPerStratum;
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    const long long hi = __shfl_xor_sync(0xFFFFFFFFu, v[K - 1 - i], off);
    const long long lo = __shfl_xor_sync(0xFFFFFFFFu, v[i], off);
    const unsigned int hi_w = __shfl_xor_sync(0xFFFFFFFFu, w[K - 1 - i], off);
    const unsigned int lo_w = __shfl_xor_sync(0xFFFFFFFFu, w[i], off);
    if (pair_gt(hi, hi_w, v[i], w[i])) {
      v[i] = hi;
      w[i] = hi_w;
    }
    if (pair_gt(lo, lo_w, v[K - 1 - i], w[K - 1 - i])) {
      v[K - 1 - i] = lo;
      w[K - 1 - i] = lo_w;
    }
  }
#pragma unroll
  for (int half = K / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i & half) continue;
      if (pair_gt(v[i + half], w[i + half], v[i], w[i])) {
        const long long tv = v[i];
        const unsigned int tw = w[i];
        v[i] = v[i + half];
        w[i] = w[i + half];
        v[i + half] = tv;
        w[i + half] = tw;
      }
    }
  }
}

template <int NS, bool kWide, bool kMulti>
__global__ void __launch_bounds__(kThreads) refresh_candidates_kernel(
    const int* __restrict__ rows, int n_tiles, const int* __restrict__ col_of,
    const int* __restrict__ drows, const uint8_t* __restrict__ dvalid, int D,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ rot_g,
    const unsigned long long* __restrict__ sel, int C, int W,
    const __grid_constant__ ScoreCfg cfg,
    const int* __restrict__ cache_node, const int* __restrict__ cache_score,
    int P, int N, int sb0, int sb1, int k0, int k1,
    int* __restrict__ out_key, int* __restrict__ out_node,
    int* __restrict__ out_score) {
  using Key = std::conditional_t<kWide, long long, int>;
  constexpr Key kEmpty = kWide ? LLONG_MIN : INT_MIN;
  __shared__ __align__(16) int s_tile[kTileInts];
  __shared__ int s_pq[kDims * kPods];   // each pod's request and estimate,
  __shared__ int s_pe[kDims * kPods];   // a column per pod
  __shared__ int s_ckey[kWide ? 1 : kPods][kMaxK];  // cached slots' keys
  // the wide merge's pairs for the decoding (a runtime index)
  __shared__ long long s_vals[kWide ? kPods : 1][kWide ? NS : 1]
                             [kMaxPerStratum];
  __shared__ unsigned int s_words[kWide ? kPods : 1][kWide ? NS : 1]
                                 [kMaxPerStratum];

  const int tid = threadIdx.x;
  const int slot = tid / kLanes;
  const int lane = tid % kLanes;
  const int p = blockIdx.x * kPods + slot;
  const bool in_range = p < P;
  const bool pvalid = in_range && pvalid_g[p];
  const int K = k0 + (NS > 1 ? k1 : 0);
  const int rot7919 = in_range ? wmul(rot_g[p], 7919) : 0;
  const long long row0 = static_cast<long long>(p) * K;

  // the lists' values, and (wide) each value's word: its dirty column
  Key lists[NS][kMaxPerStratum];
  unsigned int words[kWide ? NS : 1][kMaxPerStratum];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) {
      lists[s][j] = kEmpty;
      if constexpr (kWide) words[s][j] = 0;
    }

  // the cached slots, lane h taking slots h, h + 4, ...: invalidated on
  // dirty nodes, each stratum's key recomputed from the cached raw score
  // (wide: in the epilogue, after the fresh top-k)
  if (!kWide && in_range) {
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
        if ((j < k0) == (s == 0))
          insert_sorted(lists[s], static_cast<Key>((key << 1) | 1));
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
  const SelRow sr = SelRow::of(sel, p, W, pvalid);

  // the fresh dirty columns (an invalid pod's are all infeasible: packed,
  // it skips them; wide, they enter with key -1)
  if (__syncthreads_or(kWide ? in_range : pvalid)) {
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();
      const int4* src = reinterpret_cast<const int4*>(
          rows + static_cast<long long>(t) * kTileInts);
      for (int i = tid; i < kTileInts / 4; i += kThreads)
        reinterpret_cast<int4*>(s_tile)[i] = src[i];
      __syncthreads();
      if (!(kWide ? in_range : pvalid)) continue;
      for (int i = lane; i < kTile; i += kLanes) {
        // a padding row past D is invalid, hence never feasible
        const int c = t * kTile + i;
        if (kWide && c >= D) break;
        const PackedRow nr(s_tile + i * kRowInts);
        bool ok = false;
        const int score = pvalid ? pair_score(nr, pt, cfg, ok) : 0;
        const bool feas =
            ok && nr.valid() && sr.template ok<kMulti>(nr.cls(), C);
        if (!kWide && !feas) continue;
        const int tb = tie_break(nr.node(), rot7919, N);
        const int clipped = clip_score(score);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int q = clipped >> (s == 0 ? sb0 : sb1);
          if constexpr (kWide)
            insert_pair(lists[s], words[s], wide_rank(feas ? q : -1, tb), c);
          else
            insert_sorted(lists[s], ((q << kTbBits) | tb) << 1);
        }
      }
    }
  }
  // merge the pod's kLanes partial lists (a butterfly on values only;
  // wide, on the pairs)
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if constexpr (kWide) {
        merge_pairs(lists[s], words[s], off);
      } else {
        Key other[kMaxPerStratum];
#pragma unroll
        for (int j = 0; j < kMaxPerStratum; ++j)
          other[j] = __shfl_xor_sync(0xFFFFFFFFu, lists[s][j], off);
#pragma unroll
        for (int j = 0; j < kMaxPerStratum; ++j)
          insert_sorted(lists[s], other[j]);
      }
    }
  }
  __syncwarp();
  if (!in_range) return;

  if constexpr (kWide) {
    // epilogue, lane s of the pod for stratum s.  Stage 2, in place: the
    // fresh top-k_s (its words made fresh words, the rest of the list
    // emptied) takes the k_s cached slots (register arrays: the loop over
    // strata is unrolled); the merged pairs go to shared memory
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s % kLanes != lane) continue;
      const int ks_s = s == 0 ? k0 : k1;
      const int sb = s == 0 ? sb0 : sb1;
      const long long o = row0 + (s == 0 ? 0 : k0);
#pragma unroll
      for (int r = 0; r < kMaxPerStratum; ++r) {
        if (r >= ks_s || lists[s][r] == LLONG_MIN) {
          lists[s][r] = LLONG_MIN;
          words[s][r] = 0;
        } else {
          const unsigned int col = words[s][r];
          words[s][r] = kFresh | (D > ks_s ? kColMax - col : col);
        }
      }
      for (int j = 0; j < ks_s; ++j) {
        const int node = cache_node[o + j];
        const int score = cache_score[o + j];
        const bool stale = dirty_col(node, N, col_of, drows, dvalid, D) >= 0;
        insert_pair(lists[s], words[s],
                    wide_rank((score >= 0 && !stale) ? score >> sb : -1,
                              tie_break(node, rot7919, N)),
                    static_cast<unsigned int>(j));
      }
#pragma unroll
      for (int j = 0; j < kMaxPerStratum; ++j)
        if (j < ks_s) {
          s_vals[slot][s][j] = lists[s][j];
          s_words[slot][s][j] = words[s][j];
        }
    }
    // decoding: the word names a cached slot or a dirty column
    for (int s = 0; s < NS; ++s) {
      if (s % kLanes != lane) continue;
      const int ks_s = s == 0 ? k0 : k1;
      const long long o = row0 + (s == 0 ? 0 : k0);
      for (int j = 0; j < ks_s; ++j) {
        const bool valid = s_vals[slot][s][j] >= 0;
        const unsigned int w = s_words[slot][s][j];
        int node, score = -1;
        if (w & kFresh) {
          unsigned int col = w & kColMax;
          if (D > ks_s) col = kColMax - col;
          node = drows[col];
          if (valid) {
            const PackedRow nr(rows + static_cast<long long>(col) * kRowInts);
            bool ok;
            score = clip_score(pair_score(nr, pt, cfg, ok));
          }
        } else {
          node = cache_node[o + w];
          if (valid) score = cache_score[o + w];
        }
        out_node[o + j] = node;
        out_score[o + j] = score;
        out_key[o + j] = score >= 0 ? score >> sb0 : -1;
      }
    }
    return;
  }

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
            ok && nr.valid() && sr.template ok<kMulti>(nr.cls(), C);
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

template <int NS, bool kWide, bool kMulti>
cudaError_t launch(const int* rows, int n_tiles, const int* col_of,
                   const int* drows, const uint8_t* dvalid, int D,
                   const int* preq, const int* pest, const uint8_t* pvalid,
                   const int* rot_id, const unsigned long long* sel, int C,
                   int W, const ScoreCfg& sc, const int* cache_node,
                   const int* cache_score, int P, int N, int sb0, int sb1,
                   int k0, int k1, int* out_key, int* out_node,
                   int* out_score, cudaStream_t st) {
  const dim3 grid((P + kPods - 1) / kPods);
  refresh_candidates_kernel<NS, kWide, kMulti><<<grid, kThreads, 0, st>>>(
      rows, n_tiles, col_of, drows, dvalid, D, preq, pest, pvalid, rot_id,
      sel, C, W, sc, cache_node, cache_score, P, N, sb0, sb1, k0, k1,
      out_key, out_node, out_score);
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
    const uint8_t* sel, int C, unsigned long long* words, const int* cfg,
    int cfg_len, const int* cache_node, const int* cache_score,
    const int* drows, const uint8_t* dvalid, int D, int P, int N,
    int n_strata, int sb0, int sb1, int k0, int k1, int* rows, int* col_of,
    int* out_key, int* out_node, int* out_score, void* stream) {
  const bool wide = N > kPackedNodeCapacity;
  if (cfg_len != kCfgLen || cfg == nullptr || n_strata < 1 ||
      n_strata > 2 || k0 > kMaxPerStratum || k1 > kMaxPerStratum ||
      sel == nullptr || C < 1 || words == nullptr || N < 1 ||
      N > (1 << kWideTbBits) ||
      D < 0 ||
      (reinterpret_cast<uintptr_t>(rows) & 15)) {
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
  {
    const cudaError_t err = pack_selector(sel, P, C, words, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int W = (C + 63) / 64;
  // the instance: strata, key regime, selector words
  auto go = [&](auto ns, auto kw, auto km) {
    return launch<decltype(ns)::value, decltype(kw)::value,
                  decltype(km)::value>(
        rows, n_tiles, col_of, drows, dvalid, D, preq, pest, pvalid, rot_id,
        words, C, W, sc, cache_node, cache_score, P, N, sb0, sb1, k0,
        decltype(ns)::value > 1 ? k1 : 0, out_key, out_node, out_score, st);
  };
  auto by_words = [&](auto ns, auto kw) {
    return W > 1 ? go(ns, kw, std::true_type{})
                 : go(ns, kw, std::false_type{});
  };
  auto by_regime = [&](auto ns) {
    return wide ? by_words(ns, std::true_type{})
                : by_words(ns, std::false_type{});
  };
  const cudaError_t err =
      n_strata == 1 ? by_regime(std::integral_constant<int, 1>{})
                    : by_regime(std::integral_constant<int, 2>{});
  return static_cast<int>(err);
}
