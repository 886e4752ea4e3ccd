// K1: fused Filter + Score + stratified top-k candidate selection.
//
// Replaces, for method="exact" (and "chunked_exact", whose rows are the
// same), the XLA candidate stage of the JAX package:
//   koordinator_tpu/ops/assignment.py:139-166   score_pods (Filter + Score)
//   koordinator_tpu/ops/batch_assign.py:126-154 _rank_parts (ranking key)
//   koordinator_tpu/ops/batch_assign.py:451-525 _reduce_candidates
//   koordinator_tpu/ops/batch_assign.py:182-197 _topk_by_rank (both regimes)
// K1a, the approx instances (kRank != kExact), replaces the approx branch
// of the same reduction for method="approx" (and "chunked", whose rows are
// the same):
//   koordinator_tpu/ops/batch_assign.py:469-504 approx_max_k over a 24-bit
//                                               float key
//   koordinator_tpu/ops/batch_assign.py:528     _chunked_candidates
// Their plain PyTorch version is select_candidates_plain in
// kernels/select_candidates.py.
//
// What bounds it on the H100: the work is P*N pairs, each an R=10 loop of
// int32 compares, multiplies and a few floor divisions (operations); the
// only bytes that must move are the (P, R) / (N, R) inputs and the (P, k)
// outputs.  No (P, N) tensor is written: each pod's row of N keys is folded,
// node by node, into a running top-k per stratum held in registers.
//
// Design (four threads per pod, 32 pods per CTA, clusters of 2 CTAs; the
// choices measured on the H100 with profile_torch_round.py --kernels
// --variants, PERF.md):
// - A first small kernel (koord_score.cuh: pack_node_rows) packs the node
//   table into 352-byte rows of pair_score's node terms (allocatable, free
//   capacity, usage, the usage threshold's two sides, the allocatable's
//   magic divisors, flags, class), padded with invalid rows to whole tiles,
//   so a tile of 32 nodes is one contiguous 11 KB block.
// - The CTAs of a cluster share each tile: CTA r copies slice r of the
//   tile with one cp.async.bulk ... .multicast::cluster, which lands in
//   every CTA of the cluster from one L2 read.  Completion goes to each
//   CTA's mbarrier for that stage; a ring of 3 stages keeps the next tiles
//   in flight while one is scored.  One cluster barrier per tile (split
//   arrive/wait, a tile behind) frees a stage before it is refilled.
//   Larger clusters cut L2 reads further but couple more CTAs to the
//   slowest of them.
// - A pod's four threads take every fourth node of each tile and merge
//   their partial lists by shuffles at the end.  A thread's pair score is
//   a chain of dependent steps; four threads a pod give each scheduler the
//   warps to hide that latency at the flagship's 50,000 pods.
// - Each term of the score walks only the dimensions it weighs (bit masks
//   of the config, a kernel parameter, and of the pod), and every floor
//   division goes through a magic multiplier: per node from the packed
//   rows, per call for the LoadAware weight sum, per pod for the FitPlus
//   weight sum.
// - Packed regime (N <= 2^15): the per-stratum lists hold int32 keys
//   ((clipped >> sb) << 15 | tb), not int64 (key, node) ranks: 32
//   registers instead of 64.  The node of a key is recovered from its
//   tie-break (its preimages, re-scored when the rotation's difference
//   wraps and two nodes share a tie-break), and the -1 slots of rows with
//   fewer feasible nodes than a stratum's k are filled with the row's
//   lowest infeasible columns, lax.top_k's order.
// - Wide regime (N > 2^15, the kWide instances): the lists hold the 64-bit
//   composite wide_rank(clipped >> sb, tb) = key * 2^30 + tb, whose order
//   is the lexicographic (key, tb) of the JAX package's wide top-k, and
//   the node comes back from the tie-break the same way.  Among equal
//   (key, tb) the wide order puts the HIGHER column first, so of two
//   preimages carrying one rank the first copy takes the higher; the -1
//   slots take the row's infeasible columns in tie-break order,
//   descending, the higher column first between two that share one (a
//   walk over the tie-break values from N-1 down).  The 64 registers of
//   two int64 lists take a lower occupancy (4 CTAs an SM, not 6); the
//   decoding reads the lists from shared memory.
//   kernels/select_candidates.py mirrors the rules of both regimes
//   (tie_break_preimages, topk_from_int32_keys, topk_from_wide_keys),
//   tested against the JAX package on the CPU.
// - Selector classes: the launch packs each pod's row of C classes into
//   W = ceil(C/64) words (pack_selector_words, koord_score.cuh); word 0
//   stays in a register, and the many-word instances (C > 64) read the
//   word of a node's class through L1.  The one-word instances compile the
//   register's bit test alone.
// - An epilogue, stratum s on the pod's thread s, re-scores each chosen
//   node to emit the stratum-0 key and the clipped score of every slot.
// - K1a (the approx ranks): everything above but the rank.  The JAX
//   package picks the top k_i of a float32 key a = (q << shift) | (tb >> d)
//   (the quantized score over the tie-break's high bits, an integer below
//   2^24), and approx_max_k's CPU lowering breaks its ties lowest column
//   first.  In the packed regime shift + d = 15, so a is K1's exact key
//   q << 15 | tb with its low d bits dropped: a run of 2^d tie-break values
//   shares one a.  On a row whose tie-break is a rotation of the columns
//   (one preimage a value) the tie-break falls as the column rises, so
//   lowest column first is exact's highest tie-break first in every run but
//   the one holding column 0, whose columns wrap from N - 1 to 0.  There
//   the order is a rotation of the run's low bits: with z the low bits of
//   tb(column 0), low' = (low - z - 1) mod 2^d.  So the packed K1a
//   instance (kRank = kApprox32) keeps int32 lists at K1's occupancy, 6
//   CTAs an SM: K1's key with that one run's low bits rotated, the
//   constant computed once a pod (approx_tb).  A stratum of one candidate
//   ranks the row's last maximum (approx_max_k's CPU lowering at k = 1), the
//   highest column first: the low bits complemented, and in the wrap run
//   rotated by z + 1.  The node comes back by inverting the rotation and
//   reading the tie-break's one preimage.  A row whose rotated difference
//   wraps int32 so that two nodes share a tie-break (tb_band: the "band",
//   int32(rot * 7919) within N above -2^31 and N not a divisor of 2^32,
//   about N / 2^32 of the rot ids) is skipped there and ranked by the
//   64-bit instance (kRank = kApprox64), launched beside it over the same
//   batch: a << 31 | (2^31 - 1 - column), the node read back from the low
//   bits, a stratum of one candidate storing the column itself.  Each of
//   its clusters returns at once when none of its pods is a band row, so
//   the split costs no copy to the host.  The wide regime (N > 2^15) ranks
//   every row on the 64-bit instance: a and a column do not fit 32 bits
//   there.  The 64-bit lists take K1's wide occupancy, 4 CTAs an SM.  A
//   stratum whose share is every column (k_i >= N, packed only) ranks
//   exactly, as in the JAX package: (shift, d) = (15, 0) makes a the exact
//   key.  The -1 slots take the lowest infeasible columns (at k = 1 the
//   last column).  kernels/select_candidates.py mirrors both ranks
//   (approx_rank_int32, topk_from_approx_int32, approx_band; approx_rank,
//   topk_from_approx_ranks).

#include <cooperative_groups.h>

#include <type_traits>

#include "koord_mbarrier.cuh"
#include "koord_score.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace koord;

constexpr int kThreads = 128;
constexpr int kLanes = 4;                      // threads per pod
constexpr int kPods = kThreads / kLanes;       // pods per CTA
constexpr int kCluster = 2;                    // CTAs sharing each tile
constexpr int kTile = 32;                      // nodes per tile
constexpr int kStages = 3;                     // tiles in flight
constexpr int kTileBytes = kTile * kRowInts * 4;
constexpr int kSliceBytes = kTileBytes / kCluster;
static_assert(kSliceBytes % 16 == 0, "bulk copies move 16-byte multiples");
// dynamic shared memory a CTA takes: the ring of tiles, the pods' requests
// and estimates
constexpr int kSmemBytes = kStages * kTileBytes + 2 * kDims * kPods * 4;

// Filter + Score of the pod against one packed node row; sets feas to the
// full feasibility verdict.
template <bool kMulti>
__device__ __forceinline__ int score_row(
    const int* row, int n, int p, int P, const PodRef& pt,
    const ScoreCfg& c, const uint8_t* feas_t, const SelRow& sr, bool has_sel,
    int C, bool& feas) {
  const PackedRow nr(row);
  bool ok;
  const int score = pair_score(nr, pt, c, ok);
  feas = ok && nr.valid() &&
         (has_sel ? sr.template ok<kMulti>(nr.cls(), C)
                  : feas_t[static_cast<long long>(n) * P + p] != 0);
  // (a padding row past N is invalid, so feas_t is read only below N)
  return score;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copy ``bytes`` from global memory into the same shared-memory offset of
// every CTA in ``mask``, completing on each one's mbarrier at ``bar``'s
// offset.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               int bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// K1a's list entry: the approx key a = (q << shift) | (tb >> d) (the
// JAX package's float32 key, an integer below 2^30) over the column's
// complement, so the int64 order is (a descending, column ascending):
// approx_max_k's order, ties to the lowest column.
constexpr int kApproxColBits = 31;
constexpr long long kApproxColMask = (1ll << kApproxColBits) - 1;

// A stratum of one candidate (last) ranks the higher column first:
// approx_max_k's CPU lowering at k = 1 reduces to the row's last maximum.
__device__ __forceinline__ long long approx_rank(int q, int tb, int shift,
                                                 int d, int n, bool last) {
  const long long a = (static_cast<long long>(q) << shift) | (tb >> d);
  return (a << kApproxColBits) | (last ? n : kApproxColMask - n);
}

__device__ __forceinline__ int approx_col(long long v, bool last) {
  const long long low = v & kApproxColMask;
  return static_cast<int>(last ? low : kApproxColMask - low);
}

// The list entries of an instance: K1's keys (kExact), K1a's int32 keys
// (kApprox32, packed regime, rows off the band) or K1a's 64-bit ranks
// (kApprox64).
enum Rank { kExact = 0, kApprox32 = 1, kApprox64 = 2 };

// The band: rows whose rotated difference wraps int32 for the nodes at or
// above 2^31 + rot7919 (0 < that < N) while 2^32 is not a multiple of N,
// so that two nodes share a tie-break (tie_break_preimages in
// kernels/select_candidates.py).
__device__ __forceinline__ bool tb_band(int rot7919, int N) {
  const long long wrap_from = static_cast<long long>(rot7919) + (1ll << 31);
  return wrap_from > 0 && wrap_from < N && (1ull << 32) % N != 0;
}

// K1a's int32 rank of tie-break tb in a stratum dropping d low bits: the
// low bits complemented by ``x`` (a stratum of one candidate) and, in the
// run of column 0's tie-break tb0, rotated by ``t``; the other bits as in
// K1's key.  approx_tb_inverse undoes it.
__device__ __forceinline__ int approx_tb(int tb, int tb0, int d, int x,
                                         int t) {
  const int mask = (1 << d) - 1;
  const int add = ((tb ^ tb0) >> d) == 0 ? t : 0;
  return (tb & ~mask) | (((tb ^ x) + add) & mask);
}

__device__ __forceinline__ int approx_tb_inverse(int v, int tb0, int d,
                                                 int x, int t) {
  const int mask = (1 << d) - 1;
  const int add = ((v ^ tb0) >> d) == 0 ? t : 0;
  return (v & ~mask) | ((((v & mask) - add) & mask) ^ x);
}

template <int NS, bool kWide, bool kMulti, int kRank>
__global__ void __launch_bounds__(kThreads,
                                  kWide || kRank == kApprox64 ? 4 : 6)
    select_candidates_kernel(
    const int* __restrict__ rows, int n_tiles,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ rot_g,
    const unsigned long long* __restrict__ sel, int C, int W,
    const uint8_t* __restrict__ feas_t,
    const __grid_constant__ ScoreCfg cfg, int P, int N, int sb0, int sb1,
    int k0,
    int k1, int ash0, int ad0, int ash1, int ad1, int group_stride,
    int* __restrict__ ranked, int* __restrict__ out_key,
    int* __restrict__ out_node, int* __restrict__ out_score) {
  // the list entries: int32 keys (K1 packed, K1a's packed instance), or
  // 64-bit ranks (wide, K1a's 64-bit instance)
  constexpr bool k64 = kWide || kRank == kApprox64;
  using Key = std::conditional_t<k64, long long, int>;
  constexpr Key kEmpty = k64 ? LLONG_MIN : INT_MIN;
  extern __shared__ __align__(128) int4 s_tiles[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ int s_any;
  // the 64-bit lists' values for the decoding (a runtime index)
  __shared__ long long s_vals[k64 ? kPods : 1][k64 ? NS : 1]
                             [kMaxPerStratum];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const int tid = threadIdx.x;
  // cluster c takes pod group (c * group_stride) mod G: clusters launched
  // side by side take groups far apart, so the valid rows a batch holds at
  // its front spread over the card instead of filling its first SMs
  const int n_groups = gridDim.x / kCluster;
  const int group = static_cast<int>(
      static_cast<long long>(blockIdx.x / kCluster) * group_stride %
      n_groups);
  // the kLanes threads of a pod are neighbours in a warp; lane h scores
  // the nodes h, h + kLanes, ... of every tile
  const int slot = tid / kLanes;
  const int lane = tid % kLanes;
  // the rows this instance ranks: K1a's int32 instance those off the band,
  // its 64-bit one in the packed regime the band's, the others every row
  constexpr bool kOffBandOnly = kRank == kApprox32;
  constexpr bool kBandOnly = kRank == kApprox64 && !kWide;
  if constexpr (kBandOnly) {
    // a cluster none of whose pods is a band row returns at once
    bool band = false;
    for (int r = 0; r < kCluster; ++r) {
      const int q = (group * kCluster + r) * kPods + slot;
      band = band || (q < P && tb_band(wmul(rot_g[q], 7919), N));
    }
    if (!__syncthreads_or(band)) return;
  }
  const int p = (group * kCluster + static_cast<int>(rank)) * kPods + slot;
  const int rot7919 = p < P ? wmul(rot_g[p], 7919) : 0;
  const bool in_range =
      p < P && (kOffBandOnly ? !tb_band(rot7919, N)
                : kBandOnly  ? tb_band(rot7919, N)
                             : true);
  const bool pvalid = in_range && pvalid_g[p];
  if (kRank != kExact && ranked != nullptr) {  // uniform over the CTA
    // K1a's report of the rows each instance ranked: [0] int32, [1] 64-bit
    const int n_rows = __syncthreads_count(in_range && lane == 0);
    if (tid == 0 && n_rows > 0)
      atomicAdd(ranked + (kRank == kApprox32 ? 0 : 1), n_rows);
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int any_local = __syncthreads_or(pvalid);
  if (tid == 0) s_any = any_local;
  cluster.sync();
  // the cluster sweeps the node tiles if any of its CTAs holds a valid pod
  bool any = false;
  for (int r = 0; r < kCluster; ++r)
    any = any || *cluster.map_shared_rank(&s_any, r) != 0;
  cluster.sync();  // every peer has read s_any

  // the pod's request and estimate, one column per pod of shared memory
  // (pair_score reads them at dimension indices known at run time)
  int* s_pq = reinterpret_cast<int*>(s_tiles) + kStages * kTile * kRowInts;
  int* s_pe = s_pq + kDims * kPods;
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
  __syncthreads();
  const bool has_sel = sel != nullptr;
  const SelRow sr = has_sel ? SelRow::of(sel, p, W, pvalid)
                            : SelRow{nullptr, 0ull};

  Key lists[NS][kMaxPerStratum];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) lists[s][j] = kEmpty;
  int n_feas = 0;
  // K1a's int32 instance: per stratum, the low bits' complement (a stratum
  // of one candidate) and the rotation of column 0's run
  const int tb0 = tie_break(0, rot7919, N);
  int ax[2] = {0, 0}, at[2] = {0, 0};
  if constexpr (kRank == kApprox32) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int d = s == 0 ? ad0 : ad1;
      const int mask = (1 << d) - 1;
      const int z1 = (tb0 & mask) + 1;
      const bool last = (s == 0 ? k0 : k1) == 1;
      ax[s] = last ? mask : 0;
      at[s] = last ? z1 : -z1;
    }
  }

  if (any) {
    const uint16_t all = static_cast<uint16_t>((1u << kCluster) - 1u);
    const char* src = reinterpret_cast<const char*>(rows);
    char* ring = reinterpret_cast<char*>(s_tiles);
    if (tid == 0) {
      for (int t = 0; t < kStages && t < n_tiles; ++t) {
        mbar_expect_tx(&s_full[t], kTileBytes);
        bulk_multicast(ring + t * kTileBytes + rank * kSliceBytes,
                       src + static_cast<long long>(t) * kTileBytes +
                           rank * kSliceBytes,
                       kSliceBytes, &s_full[t], all);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      mbar_wait(&s_full[stage], static_cast<uint32_t>((t / kStages) & 1));
      if (pvalid) {
        const int* tile = reinterpret_cast<const int*>(s_tiles) +
                          stage * (kTile * kRowInts);
        const int n0 = t * kTile;
        // this lane's share of the tile; the padding rows past N are
        // invalid, hence never feasible
        for (int i = lane; i < kTile; i += kLanes) {
          const int n = n0 + i;
          bool feas;
          const int score =
              score_row<kMulti>(tile + i * kRowInts, n, p, P, pt, cfg,
                                feas_t, sr, has_sel, C, feas);
          if (!(feas && n < N)) continue;
          ++n_feas;
          const int tb = tie_break(n, rot7919, N);
          const int clipped = clip_score(score);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int key = clipped >> (s == 0 ? sb0 : sb1);
            if constexpr (kRank == kApprox64)
              insert_sorted(lists[s],
                            approx_rank(key, tb, s == 0 ? ash0 : ash1,
                                        s == 0 ? ad0 : ad1, n,
                                        (s == 0 ? k0 : k1) == 1));
            else if constexpr (kRank == kApprox32)
              // (a stratum that drops no tie-break bit, d = 0, ranks by
              // K1's key: a uniform branch)
              insert_sorted(lists[s],
                            (key << kTbBits) |
                                ((s == 0 ? ad0 : ad1) == 0
                                     ? tb
                                     : approx_tb(tb, tb0, s == 0 ? ad0 : ad1,
                                                 ax[s], at[s])));
            else if constexpr (kWide)
              insert_sorted(lists[s], wide_rank(key, tb));
            else
              insert_sorted(lists[s], (key << kTbBits) | tb);
          }
        }
      }
      if (t >= 1) {
        cluster_wait();  // every CTA is done with tile t-1
        const int refill = t - 1 + kStages;
        if (tid == 0 && refill < n_tiles) {
          const int st = (t - 1) % kStages;
          mbar_expect_tx(&s_full[st], kTileBytes);
          bulk_multicast(ring + st * kTileBytes + rank * kSliceBytes,
                         src + static_cast<long long>(refill) * kTileBytes +
                             rank * kSliceBytes,
                         kSliceBytes, &s_full[st], all);
        }
      }
      cluster_arrive();
    }
    cluster_wait();
  }
  // merge the pod's kLanes partial lists (a butterfly: after log2(kLanes)
  // exchanges every lane holds the top of the union); the lists hold key
  // values only, so the order of merging does not matter
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      Key other[kMaxPerStratum];
#pragma unroll
      for (int j = 0; j < kMaxPerStratum; ++j)
        other[j] = __shfl_xor_sync(0xFFFFFFFFu, lists[s][j], off);
#pragma unroll
      for (int j = 0; j < kMaxPerStratum; ++j)
        insert_sorted(lists[s], other[j]);
    }
    n_feas += __shfl_xor_sync(0xFFFFFFFFu, n_feas, off);
  }
  if (!in_range) return;

  // epilogue, lane s of the pod for stratum s.  Pass 1: the lists' keys
  // into the key output (packed) or shared memory (wide): the lists are
  // register arrays, so this loop is unrolled and indexes them statically
  const int k_total = k0 + (NS > 1 ? k1 : 0);
  const long long row0 = static_cast<long long>(p) * k_total;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s % kLanes != lane) continue;
#pragma unroll
    for (int j = 0; j < kMaxPerStratum; ++j) {
      if (j >= (s == 0 ? k0 : k1)) continue;
      if constexpr (k64)
        s_vals[slot][s][j] = lists[s][j];
      else
        out_key[row0 + (s == 0 ? 0 : k0) + j] = lists[s][j];
    }
  }

  // pass 2: each slot's node, re-scored from the packed rows in global
  // memory for the stratum-0 key and the clipped score.  The preimages of a
  // tie-break: n1 below the first node whose difference wraps
  // (2^31 + rot7919), n2 at or above it (tie_break_preimages).

  const long long wrap_from = static_cast<long long>(rot7919) + (1ll << 31);
  const bool wraps = wrap_from < N;
  const int rot_mod = fmod_floor(rot7919, N);
  const int two32_mod = static_cast<int>((1ull << 32) % N);
  for (int s = 0; s < NS; ++s) {
    if (s % kLanes != lane) continue;
    const int ks_s = s == 0 ? k0 : k1;
    const int sb = s == 0 ? sb0 : sb1;
    const long long base_o = row0 + (s == 0 ? 0 : k0);
    const int f = min(n_feas, ks_s);
    if constexpr (kRank == kApprox32) {
      // the key's rank inverted to the tie-break, whose one preimage is
      // the node (n1, or past the wrap boundary its image); the -1 slots
      // as in the 64-bit instance
      const bool last = ks_s == 1;
      const int d = s == 0 ? ad0 : ad1;
      int fill = 0;
      for (int j = 0; j < ks_s; ++j) {
        const long long o = base_o + j;
        int n, key = -1, cscore = -1;
        if (j < f) {
          const int tb = approx_tb_inverse(out_key[o] & kScoreClip, tb0, d,
                                           s == 0 ? ax[0] : ax[1],
                                           s == 0 ? at[0] : at[1]);
          n = (N - 1) - tb + rot_mod;
          if (n >= N) n -= N;
          if (n >= wrap_from) {
            n += two32_mod;
            if (n >= N) n -= N;
          }
          bool feas;
          cscore = clip_score(score_row<kMulti>(
              rows + static_cast<long long>(n) * kRowInts, n, p, P, pt, cfg,
              feas_t, sr, has_sel, C, feas));
          key = ((cscore >> sb0) << kTbBits) | tie_break(n, rot7919, N);
        } else if (last) {
          n = N - 1;   // f = 0: every column is infeasible
        } else {
          for (;; ++fill) {
            bool feas = false;
            if (pvalid) {
              score_row<kMulti>(
                  rows + static_cast<long long>(fill) * kRowInts, fill, p, P,
                  pt, cfg, feas_t, sr, has_sel, C, feas);
            }
            if (!feas) break;
          }
          n = fill++;
        }
        out_key[o] = key;
        out_node[o] = n;
        out_score[o] = cscore;
      }
      continue;
    }
    if constexpr (kRank == kApprox64) {
      // the entry's node is in its low bits; the -1 slots take the row's
      // infeasible columns, ascending (approx_max_k's order of its -1.0
      // keys), or at k = 1 its last column
      const bool last = ks_s == 1;
      int fill = 0;
      for (int j = 0; j < ks_s; ++j) {
        const long long o = base_o + j;
        int n, key = -1, cscore = -1;
        if (j < f) {
          n = approx_col(s_vals[slot][s][j], last);
          bool feas;
          cscore = clip_score(score_row<kMulti>(
              rows + static_cast<long long>(n) * kRowInts, n, p, P, pt, cfg,
              feas_t, sr, has_sel, C, feas));
          key = kWide ? cscore >> sb0
                      : ((cscore >> sb0) << kTbBits) |
                            tie_break(n, rot7919, N);
        } else if (last) {
          n = N - 1;   // f = 0: every column is infeasible
        } else {
          for (;; ++fill) {
            bool feas = false;
            if (pvalid) {
              score_row<kMulti>(
                  rows + static_cast<long long>(fill) * kRowInts, fill, p, P,
                  pt, cfg, feas_t, sr, has_sel, C, feas);
            }
            if (!feas) break;
          }
          n = fill++;
        }
        out_key[o] = key;
        out_node[o] = n;
        out_score[o] = cscore;
      }
      continue;
    }
    if constexpr (kWide) {
      // the rank's node: the preimage of its tie-break that carries it, the
      // higher one (n2, at or above the wrap boundary) for the first copy
      long long prev = LLONG_MIN;
      int t = 0, half = 0;  // the -1 slots' walk: tie-break N-1-t
      for (int j = 0; j < ks_s; ++j) {
        const long long o = base_o + j;
        int n, cscore = -1;
        if (j < f) {
          const long long v = s_vals[slot][s][j];
          int n1 = (N - 1) -
                   static_cast<int>(v & ((1ll << kWideTbBits) - 1)) + rot_mod;
          if (n1 >= N) n1 -= N;
          n = n1;
          if (wraps && prev != v) {
            int n2 = n1 + two32_mod;
            if (n2 >= N) n2 -= N;
            if (n2 >= wrap_from) {
              bool feas;
              const int sc = score_row<kMulti>(
                  rows + static_cast<long long>(n2) * kRowInts, n2, p, P, pt,
                  cfg, feas_t, sr, has_sel, C, feas);
              if (feas && wide_rank(clip_score(sc) >> sb,
                                    tie_break(n2, rot7919, N)) == v)
                n = n2;
            }
          }
          prev = v;
          bool feas;
          cscore = clip_score(score_row<kMulti>(
              rows + static_cast<long long>(n) * kRowInts, n, p, P, pt, cfg,
              feas_t, sr, has_sel, C, feas));
        } else {
          // the row's infeasible columns by tie-break, descending: for
          // each value the node at or above the wrap boundary first
          for (;;) {
            int n1 = t + rot_mod;
            if (n1 >= N) n1 -= N;
            int cand = n1;
            bool exists;
            if (half == 0) {
              cand = n1 + two32_mod;
              if (cand >= N) cand -= N;
              exists = cand >= wrap_from;
              half = 1;
            } else {
              exists = n1 < wrap_from;
              half = 0;
              ++t;
            }
            if (!exists) continue;
            bool feas = false;
            if (pvalid) {
              score_row<kMulti>(
                  rows + static_cast<long long>(cand) * kRowInts, cand, p, P,
                  pt, cfg, feas_t, sr, has_sel, C, feas);
            }
            if (!feas) {
              n = cand;
              break;
            }
          }
        }
        out_key[o] = cscore >= 0 ? cscore >> sb0 : -1;
        out_node[o] = n;
        out_score[o] = cscore;
      }
      continue;
    }
    int prev = INT_MIN;
    int fill = 0;  // next column to test for the -1 slots
    for (int j = 0; j < ks_s; ++j) {
      const long long o = base_o + j;
      int n, key = -1, cscore = -1;
      if (j < f) {
        const int v = out_key[o];
        int n1 = (N - 1) - (v & kScoreClip) + rot_mod;
        if (n1 >= N) n1 -= N;
        n = n1;
        bool feas;
        int score = score_row<kMulti>(
            rows + static_cast<long long>(n1) * kRowInts, n1, p, P, pt, cfg,
            feas_t, sr, has_sel, C, feas);
        if (wraps) {
          // the first copy of v takes the lower matching preimage, a
          // second copy the higher one (lax.top_k's column order)
          const bool ok1 =
              n1 < wrap_from && feas &&
              (((clip_score(score) >> sb) << kTbBits) |
               tie_break(n1, rot7919, N)) == v;
          if (!ok1 || prev == v) {
            n = n1 + two32_mod;
            if (n >= N) n -= N;
            score = score_row<kMulti>(
                rows + static_cast<long long>(n) * kRowInts, n, p, P, pt,
                cfg, feas_t, sr, has_sel, C, feas);
          }
        }
        prev = v;
        cscore = clip_score(score);
        key = ((cscore >> sb0) << kTbBits) | tie_break(n, rot7919, N);
      } else {
        // lax.top_k's -1 slots: the row's infeasible columns, ascending
        for (;; ++fill) {
          bool feas = false;
          if (pvalid) {
            score_row<kMulti>(rows + static_cast<long long>(fill) * kRowInts,
                              fill, p, P, pt, cfg, feas_t, sr, has_sel, C,
                              feas);
          }
          if (!feas) break;
        }
        n = fill++;
      }
      out_key[o] = key;
      out_node[o] = n;
      out_score[o] = cscore;
    }
  }
}

template <int NS, bool kWide, bool kMulti, int kRank>
cudaError_t launch(const int* rows, int n_tiles, const int* preq,
                   const int* pest, const uint8_t* pvalid, const int* rot_id,
                   const unsigned long long* sel, int C, int W,
                   const uint8_t* feas_t,
                   const ScoreCfg& cfg, int P, int N, int sb0, int sb1,
                   int k0, int k1, const int (&ash)[4], int* ranked,
                   int* out_key, int* out_node, int* out_score,
                   cudaStream_t st) {
  auto kernel = select_candidates_kernel<NS, kWide, kMulti, kRank>;
  const int smem = kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (P + kPods - 1) / kPods;
  const int n_groups = (blocks + kCluster - 1) / kCluster;
  // a stride near 0.618 n_groups, coprime with it: a permutation of the
  // groups that scatters neighbours (Fibonacci hashing)
  int stride = max(1, static_cast<int>(n_groups * 0.618));
  auto gcd = [](int a, int b) {
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    return a;
  };
  while (gcd(stride, n_groups) != 1) ++stride;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(n_groups * kCluster);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = smem;
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return cudaLaunchKernelEx(&lc, kernel, rows, n_tiles, preq, pest, pvalid,
                            rot_id, sel, C, W, feas_t, cfg, P, N, sb0, sb1,
                            k0, k1, ash[0], ash[1], ash[2], ash[3], stride,
                            ranked, out_key, out_node, out_score);
}

// CTAs of an instance one SM holds at once, as the card reports it for
// the kernel's registers and shared memory; -1 when it cannot be asked.
template <int NS, bool kWide, bool kMulti, int kRank>
long long ctas_per_sm() {
  auto kernel = select_candidates_kernel<NS, kWide, kMulti, kRank>;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    kSmemBytes) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// CTAs an SM of the packed regime's instances with two strata and one
// selector word: ``rank`` 0 K1, 1 K1a's int32 lists, 2 K1a's 64-bit ones.
extern "C" long long koord_select_candidates_ctas_per_sm(int rank) {
  switch (rank) {
    case kExact: return ctas_per_sm<2, false, false, kExact>();
    case kApprox32: return ctas_per_sm<2, false, false, kApprox32>();
    case kApprox64: return ctas_per_sm<2, false, false, kApprox64>();
    default: return -1;
  }
}

// Bytes of the packed node rows koord_select_candidates needs as scratch.
extern "C" long long koord_select_candidates_scratch_bytes(int N) {
  const long long tiles = (N + kTile - 1) / kTile;
  return tiles * kTileBytes;
}

extern "C" int koord_select_candidates(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const int* rot_id,
    const uint8_t* sel, int C, unsigned long long* words,
    const uint8_t* feas_t, const int* cfg, int cfg_len, int P, int N,
    int n_strata, int sb0, int sb1, int k0, int k1, int approx, int ash0,
    int ad0, int ash1, int ad1, int* rows, int* ranked, int* out_key,
    int* out_node, int* out_score, int* launched, void* stream) {
  const int ash[4] = {ash0, ad0, ash1, ad1};
  bool ash_ok = approx == 0 || approx == 1;
  for (int v : ash) ash_ok = ash_ok && v >= 0 && v <= 30;
  if (cfg_len != kCfgLen || cfg == nullptr || n_strata < 1 ||
      n_strata > 2 || !ash_ok ||
      k0 > kMaxPerStratum || k1 > kMaxPerStratum || N < 1 ||
      N > (1 << kWideTbBits) ||
      (sel != nullptr && (C < 1 || words == nullptr)) ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = sel != nullptr ? (C + 63) / 64 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  const int n_tiles = (N + kTile - 1) / kTile;
  const int n_pad = n_tiles * kTile;
  pack_node_rows<<<(n_pad + 255) / 256, 256, 0, st>>>(
      alloc, reqd, usage, base, nvalid, nclass, sc, N, nullptr, nullptr, N,
      n_pad, rows, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && sel != nullptr)
    err = pack_selector(sel, P, C, words, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the instance: strata, key regime, selector words, rank (K1, K1a);
  // each launch counted in *launched
  int n_launched = 0;
  auto go = [&](auto ns, auto kw, auto km, auto kr) {
    ++n_launched;
    return launch<decltype(ns)::value, decltype(kw)::value,
                  decltype(km)::value, decltype(kr)::value>(
        rows, n_tiles, preq, pest, pvalid, rot_id,
        sel != nullptr ? words : nullptr, C, W, feas_t, sc, P,
        N, sb0, sb1, k0, decltype(ns)::value > 1 ? k1 : 0, ash, ranked,
        out_key, out_node, out_score, st);
  };
  using Exact = std::integral_constant<int, kExact>;
  using Approx32 = std::integral_constant<int, kApprox32>;
  using Approx64 = std::integral_constant<int, kApprox64>;
  auto by_approx = [&](auto ns, auto kw, auto km) {
    if (!approx) return go(ns, kw, km, Exact{});
    if constexpr (decltype(kw)::value) {
      return go(ns, kw, km, Approx64{});
    } else {
      // K1a packed: the int32 instance off the band, the 64-bit one on it
      const cudaError_t e = go(ns, kw, km, Approx32{});
      return e != cudaSuccess ? e : go(ns, kw, km, Approx64{});
    }
  };
  auto by_words = [&](auto ns, auto kw) {
    return W > 1 ? by_approx(ns, kw, std::true_type{})
                 : by_approx(ns, kw, std::false_type{});
  };
  auto by_regime = [&](auto ns) {
    return N > kPackedNodeCapacity ? by_words(ns, std::true_type{})
                                   : by_words(ns, std::false_type{});
  };
  err = n_strata == 1 ? by_regime(std::integral_constant<int, 1>{})
                      : by_regime(std::integral_constant<int, 2>{});
  if (launched != nullptr) *launched = n_launched;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
