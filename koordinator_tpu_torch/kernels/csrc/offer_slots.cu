// K8: the gang offer-slot count of network-topology gang placement.
//
// Replaces koordinator_tpu/ops/network_topology.py:125 gang_offer_slots,
// the (N, P, R) prefix-sum feasibility test that the topology planner runs
// for every gang with JobTopologyRequirements, together with the gang's
// node validity that gang_candidate_prep (:366-370) folds in first, for
// all of a round's such gangs in one call.  Its plain PyTorch version is
// offer_slots_plain in kernels/offer_slots.py, the kernel's walk in
// PyTorch offer_slots_mirror.
//
// For gang g, its front-packed (P, R) request matrix is its M_g member
// rows in order followed by P - M_g zero rows.  The member rows are
// req[rows[s]] for s in offsets[g]..offsets[g+1] (the member mode), or
// req[s] itself (the explicit mode).  slots[g, n] is the number of leading
// rows of that matrix for which both tests hold on node n, stopping at the
// first that fails (JAX's cumprod):
//   fit:        cum[p, r] <= alloc[n, r] - requested[n, r]  for every r
//               (no exemption for a zero request);
//   threshold:  _threshold_mask with the cumulative band estimate cum_est,
//               the same wrapping test as K1's (koord_score.cuh
//               node_dim_terms: thx + 100 * cum_est < thy on every
//               thresholded dim with allocatable > 0), when a config is
//               given;
// and slots[g, n] = 0 where the gang's node validity is false: in the
// member mode the state's valid[n] and every member's feasible[row, n]
// (gang_candidate_prep's AND), in the explicit mode valid[g, n].  Every sum
// wraps in int32, as JAX's int32 cumsum does.
//
// The zero rows past the members are not read: their cumulative request is
// the members' total, and their cumulative estimate the members' plus k
// times the estimate of a zero request (the estimator defaults), k rows
// in.  So they are tested from the totals alone: the request once, and
// the first row whose estimate crosses a threshold in closed form
// (zero_rows_fail), row by row only where the wrapping sums could jump the
// threshold.
//
// What bounds it on the H100: operations.  Each valid (gang, node) pair
// tests rows until its first failure (R compares and, on the thresholded
// dims, a multiply-add and a compare a row), and each (member, node) pair
// ANDs one byte of the feasible mask.  The bytes are the node table, the
// member rows, the members' feasible rows and the (G, N) counts.
//
// Design, two launches a call:
//   offer_slots_scan: a warp a gang scans its member rows once, 32 rows a
//     step: each lane gathers a row (and computes its band estimate), a
//     shuffle scan of the 2R sequences, the carry in registers.  It writes
//     the (S, kRowInts) cumulative rows, each gang's totals (the carry the
//     rows past the members are tested from, and the gang's live
//     dimensions: those some member requests or estimates) and, as row G
//     of the totals, the estimate of a zero request.
//   offer_slots_walk: a CTA owns a tile of kNodesPerCta nodes and walks a
//     slice of the gangs (the wrapper sizes the slices so that the grid
//     fills the card at 16 gangs as at 128; gangs are no grid dimension,
//     so their count has no limit).  It loads the tile's node table once,
//     coalesced, and keeps each node's free capacity and threshold terms
//     in registers for the whole launch.  A producer warp copies each
//     gang's cumulative rows, kRowsPerStage at a time, by cp.async.bulk
//     into a ring of kStages stages; each consumer warp waits on a stage's
//     full barrier, walks it with its rows read from shared memory as
//     broadcasts, and arrives on its empty barrier: no barrier of the whole
//     CTA inside the walks, and the next gangs' rows arrive while this
//     one's walk runs.  The gangs go kGangChunk at a time: first the
//     chunk's offsets, totals and node validity into shared memory, the
//     validity as words of 4 nodes, each member's feasible word loaded by
//     a lane (a warp's load covers the tile's 128 bytes of the row; the
//     members' row indices staged in shared memory first, so kFeasBatch
//     members' loads are in flight a warp at once) and ANDed in; then the
//     chunk's walks.  (A warp loading only its own 32 nodes' bytes, or a
//     barrier a gang to load the next gang's words during this one's
//     walk, ran slower on the H100.)  A gang whose live dimensions are cpu
//     and memory alone (the common case) walks its rows on those two, four
//     rows at a time, the others' constant tests done once a node.

#include "koord_mbarrier.cuh"
#include "koord_score.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wmul;

constexpr int kNodesPerCta = 128;           // consumer threads, one a node
constexpr int kConsumerWarps = kNodesPerCta / 32;
constexpr int kThreads = kNodesPerCta + 32;  // and the producer warp
constexpr int kRowsPerStage = 64;
constexpr int kStages = 4;
// a cumulative row: the request's sums at 0..R-1, the estimate's at
// kEstAt..kEstAt+R-1, padded to 16-byte vectors
constexpr int kRowInts = 24;
constexpr int kEstAt = 12;
constexpr int kStageInts = kRowsPerStage * kRowInts;
// a totals row's int holding the gang's live dimensions: bit r when a
// member requests dim r, bit kLiveEst + r when one's estimate of it is not 0
constexpr int kLive = 10;
constexpr int kLiveEst = 16;
constexpr int kScanWarps = 4;
constexpr int kGangChunk = 32;  // gangs whose validity a CTA holds at once
constexpr int kIdxWindow = 1024;  // member row indices staged at once
constexpr int kFeasBatch = 8;  // members' feasible words a warp loads at once
static_assert(3 * kDims * kNodesPerCta <= kStages * kStageInts,
              "the tile's node table is staged in the ring's memory");
static_assert(kEstAt >= kDims && kEstAt % 4 == 0 &&
                  kEstAt + kDims <= kRowInts && kRowInts % 4 == 0,
              "a row is whole 16-byte vectors");

// api/resources.py ResourceDim
constexpr int kCpu = 0, kMem = 1, kBatchCpu = 6, kBatchMem = 7, kMidCpu = 8,
              kMidMem = 9;

// The band-translated usage estimate of one request row
// (ops/scoring.py estimate_pod_usage_by_band): the batch and mid bands
// summed into cpu and memory and zeroed, then (q * factor + 50) // 100,
// or the default where q is 0 and the default positive; every sum and
// product wraps in int32.
__device__ __forceinline__ void band_estimate(const int (&q)[kDims],
                                              const int* __restrict__ f,
                                              const int* __restrict__ d,
                                              int (&e)[kDims]) {
  int t[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r) t[r] = q[r];
  t[kCpu] = wadd(wadd(q[kCpu], q[kBatchCpu]), q[kMidCpu]);
  t[kMem] = wadd(wadd(q[kMem], q[kBatchMem]), q[kMidMem]);
  t[kBatchCpu] = t[kBatchMem] = t[kMidCpu] = t[kMidMem] = 0;
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    const int dr = __ldg(d + r);
    e[r] = (t[r] == 0 && dr > 0)
               ? dr
               : koord::fdiv(wadd(wmul(t[r], __ldg(f + r)), 50), 100);
  }
}

__device__ __forceinline__ void store_row(int* dst, const int (&q)[kDims],
                                          const int (&e)[kDims],
                                          int live = 0) {
  int4* v = reinterpret_cast<int4*>(dst);
  v[0] = make_int4(q[0], q[1], q[2], q[3]);
  v[1] = make_int4(q[4], q[5], q[6], q[7]);
  v[2] = make_int4(q[8], q[9], live, 0);
  v[3] = make_int4(e[0], e[1], e[2], e[3]);
  v[4] = make_int4(e[4], e[5], e[6], e[7]);
  v[5] = make_int4(e[8], e[9], 0, 0);
}

// Inclusive warp scan of each element of x, wrapping.
__device__ __forceinline__ void warp_scan(int (&x)[kDims], int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      const int u = __shfl_up_sync(0xffffffffu, x[r], o);
      if (lane >= o) x[r] = wadd(x[r], u);
    }
  }
}

template <bool kThr>
__global__ void __launch_bounds__(kScanWarps * 32) offer_slots_scan(
    const int* __restrict__ req, const int* __restrict__ rows,
    const int* __restrict__ offsets, int G, const int* __restrict__ factors,
    const int* __restrict__ defaults, int* __restrict__ cum,
    int* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (kThr && blockIdx.x == 0 && threadIdx.x == 0) {
    const int zero[kDims] = {};
    int e[kDims];
    band_estimate(zero, factors, defaults, e);
    store_row(totals + static_cast<long long>(G) * kRowInts, zero, e);
  }
  if (g >= G) return;
  const int lo = __ldg(offsets + g), hi = __ldg(offsets + g + 1);
  int cq[kDims] = {}, ce[kDims] = {};  // the sums of the rows so far
  uint32_t live = 0;
  for (int c = lo; c < hi; c += 32) {
    const int s = c + lane;
    const bool in = s < hi;
    const long long src =
        in ? static_cast<long long>(rows ? __ldg(rows + s) : s) * kDims : 0;
    int q[kDims], e[kDims] = {};
#pragma unroll
    for (int r = 0; r < kDims; ++r) q[r] = in ? __ldg(req + src + r) : 0;
    if (kThr && in) band_estimate(q, factors, defaults, e);
#pragma unroll
    for (int r = 0; r < kDims; ++r)
      live |= (q[r] != 0 ? 1u << r : 0u) | (e[r] != 0 ? 1u << (kLiveEst + r)
                                                      : 0u);
    warp_scan(q, lane);
    if (kThr) warp_scan(e, lane);
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      q[r] = wadd(q[r], cq[r]);
      e[r] = wadd(e[r], ce[r]);
      cq[r] = __shfl_sync(0xffffffffu, q[r], 31);
      ce[r] = __shfl_sync(0xffffffffu, e[r], 31);
    }
    if (in) store_row(cum + static_cast<long long>(s) * kRowInts, q, e);
  }
  live = __reduce_or_sync(0xffffffffu, live);
  if (lane == 0)
    store_row(totals + g * kRowInts, cq, ce, static_cast<int>(live));
}

// Copy ``bytes`` from global memory into this CTA's shared memory,
// completing on the mbarrier ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(koord::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(koord::smem_u32(bar))
      : "memory");
}

// The first of a stage's ``count`` member rows that fails on the node,
// or -1.  kTwo: the gang's live dimensions are cpu and memory alone, so
// only those two are tested (the rest were tested once, hi_bad), four
// rows at a time: their loads and tests do not wait on each other.
template <bool kThr, bool kTwo>
__device__ __forceinline__ int first_fail(const int* S, int count,
                                          const int (&fr)[kDims],
                                          const int (&thx)[kDims],
                                          const int (&thy)[kDims],
                                          uint32_t thr_m,
                                          const koord::ScoreCfg& cfg) {
  int i0 = 0;
  if (kTwo) {
    for (; i0 + 4 <= count; i0 += 4) {
      uint32_t bad = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int* row = S + (i0 + u) * kRowInts;
        const int2 a = *reinterpret_cast<const int2*>(row);
        bool ok = (a.x <= fr[0]) & (a.y <= fr[1]);
        if (kThr) {
          const int2 e = *reinterpret_cast<const int2*>(row + kEstAt);
          ok = ok & (!(thr_m & 1u) ||
                     wadd(thx[0], wmul(koord::kMaxScore, e.x)) < thy[0]);
          ok = ok & (!(thr_m & 2u) ||
                     wadd(thx[1], wmul(koord::kMaxScore, e.y)) < thy[1]);
        }
        bad |= (ok ? 0u : 1u) << u;
      }
      if (bad) return i0 + __ffs(bad) - 1;
    }
  }
  for (int i = i0; i < count; ++i) {
    const int* row = S + i * kRowInts;
    bool ok;
    if (kTwo) {
      const int2 a = *reinterpret_cast<const int2*>(row);
      ok = (a.x <= fr[0]) & (a.y <= fr[1]);
      if (kThr) {
        const int2 e = *reinterpret_cast<const int2*>(row + kEstAt);
        ok = ok & (!(thr_m & 1u) ||
                   wadd(thx[0], wmul(koord::kMaxScore, e.x)) < thy[0]);
        ok = ok & (!(thr_m & 2u) ||
                   wadd(thx[1], wmul(koord::kMaxScore, e.y)) < thy[1]);
      }
    } else {
      const int4 a = *reinterpret_cast<const int4*>(row);
      const int4 b = *reinterpret_cast<const int4*>(row + 4);
      const int2 c = *reinterpret_cast<const int2*>(row + 8);
      ok = (a.x <= fr[0]) & (a.y <= fr[1]) & (a.z <= fr[2]) &
           (a.w <= fr[3]) & (b.x <= fr[4]) & (b.y <= fr[5]) &
           (b.z <= fr[6]) & (b.w <= fr[7]) & (c.x <= fr[8]) & (c.y <= fr[9]);
      if (kThr) {
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((cfg.thr_mask >> r) & 1u)
            ok = ok & (((thr_m >> r) & 1u) == 0 ||
                       wadd(thx[r], wmul(koord::kMaxScore,
                                         row[kEstAt + r])) < thy[r]);
        }
      }
    }
    if (!ok) return i;
  }
  return -1;
}

// The bytes p[n..n+3] (those below N) as a little-endian word: 4 nodes'
// flags, node n + b in byte b.
__device__ __forceinline__ uint32_t byte_word(const uint8_t* __restrict__ p,
                                              int N, long long n,
                                              bool aligned) {
  if (aligned && n + 4 <= N)
    return __ldg(reinterpret_cast<const unsigned int*>(p + n));
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (n + b < N) w |= static_cast<uint32_t>(__ldg(p + n + b)) << (8 * b);
  return w;
}

// The zero rows past a gang's m members, on a node their request fits:
// how many pass before the first that fails (P - m when none does).  The
// k-th of them (from 1) fails on thresholded dim r when
//   x_r(k) = thx + 100 * (ce + k * z)  (int32, wrapping) >= thy,
// ce the members' cumulative estimate, z a zero request's.  x_r(k + 1) is
// x_r(k) + b with b = 100 * z, wrapping; for 0 < b <= 2^31 - thy the
// values climb from x_r(1) < thy without wrapping past [thy, 2^31), so the
// first k is 1 + ceil((thy - x_r(1)) / b); b = 0 fails at once or never.
// Any other b (a default past 2^31 / 100, or a threshold near 2^31), or a
// distance thy - x_r(1) past 2^31 - 1, is walked row by row, as far as the
// first failure found on the others.
__device__ __forceinline__ int zero_rows_fail(const int (&thx)[kDims],
                                              const int (&thy)[kDims],
                                              uint32_t thr_m, const int* tot,
                                              const int* z,
                                              const koord::Magic* step,
                                              int span) {
  long long first = static_cast<long long>(span) + 1;  // none fails
  uint32_t walk = 0;
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    if (!((thr_m >> r) & 1u)) continue;
    const int ce = tot[kEstAt + r];
    const int x1 = wadd(thx[r], wmul(koord::kMaxScore, wadd(ce, z[r])));
    const int b = wmul(koord::kMaxScore, z[r]);
    if (x1 >= thy[r]) {
      first = 1;
    } else if (b == 0) {
      // x_r stays below thy: never fails
    } else if (b < 0 ||
               static_cast<long long>(b) >
                   (1LL << 31) - static_cast<long long>(thy[r]) ||
               static_cast<long long>(thy[r]) - x1 > 0x7fffffffLL) {
      walk |= 1u << r;
    } else {
      // 1 + ceil((thy - x1) / b), by b's magic multiplier (the call's)
      first = min(first, 2LL + koord::magic_fdiv(thy[r] - x1 - 1, step[r].m,
                                                 step[r].l));
    }
  }
  for (long long k = 2; walk != 0 && k < first; ++k) {
    bool bad = false;
#pragma unroll
    for (int r = 0; r < kDims; ++r) {  // static indices: thx, thy stay in
      if ((walk >> r) & 1u)              // registers
        bad = bad || wadd(thx[r], wmul(koord::kMaxScore,
                                       wadd(tot[kEstAt + r],
                                            wmul(static_cast<int>(k),
                                                 z[r])))) >= thy[r];
    }
    if (bad) first = k;
  }
  return static_cast<int>(first - 1);
}

// The consumer warps' own barrier (the producer warp runs on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kNodesPerCta) : "memory");
}

template <bool kThr>
__global__ void __launch_bounds__(kThreads, 4) offer_slots_walk(
    const int* __restrict__ alloc, const int* __restrict__ requested,
    const int* __restrict__ base, int N, const int* __restrict__ rows,
    const int* __restrict__ offsets, int G, int P, int gps, int tiles,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ feasible,
    const int* cum, const int* __restrict__ totals,
    const __grid_constant__ koord::ScoreCfg cfg, int* __restrict__ slots) {
  __shared__ __align__(128) int s_ring[kStages * kStageInts];
  __shared__ uint32_t s_valid[2][kGangChunk][kNodesPerCta / 4];
  __shared__ __align__(16) int s_tot[2][kGangChunk * kRowInts];
  __shared__ int s_off[2][kGangChunk + 1];
  __shared__ int s_rowidx[kIdxWindow];
  __shared__ int s_z[kDims];
  __shared__ koord::Magic s_step[kDims];
  __shared__ uint64_t s_full[kStages], s_empty[kStages];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long n0 =
      static_cast<long long>(blockIdx.x % tiles) * kNodesPerCta;
  const int tile_n = static_cast<int>(
      min(static_cast<long long>(kNodesPerCta), N - n0));
  const int g_lo = static_cast<int>(blockIdx.x / tiles) * gps;
  const int g_hi = min(G, g_lo + gps);

  // the tile's node table, coalesced, into the ring's memory
  int* s_a = s_ring;
  int* s_q = s_ring + kNodesPerCta * kDims;
  int* s_b = s_q + kNodesPerCta * kDims;
  for (int i = t; i < tile_n * kDims; i += kThreads) {
    s_a[i] = __ldg(alloc + n0 * kDims + i);
    s_q[i] = __ldg(requested + n0 * kDims + i);
    s_b[i] = __ldg(base + n0 * kDims + i);
  }
  if (kThr && t < kDims) {
    // a zero request's estimate, and the magic of the zero rows' step
    const int z = __ldg(totals + static_cast<long long>(G) * kRowInts +
                        kEstAt + t);
    s_z[t] = z;
    s_step[t] = koord::magic_for(max(wmul(koord::kMaxScore, z), 1));
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      koord::mbar_init(&s_full[s], 1);
      koord::mbar_init(&s_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the node's terms, in registers for the whole launch; hi_bad: a test
  // past cpu and memory that fails with nothing requested or estimated
  // there
  const bool in = warp < kConsumerWarps && t < tile_n;
  const long long n = n0 + t;
  int fr[kDims] = {}, thx[kDims] = {}, thy[kDims] = {};
  uint32_t thr_m = 0;
  bool hi_bad = false;
  if (in) {
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      const int a = s_a[t * kDims + r];
      const koord::DimTerms d = koord::node_dim_terms(
          a, s_q[t * kDims + r], s_b[t * kDims + r], true, cfg.thr[r]);
      fr[r] = d.fr;
      thx[r] = d.thx;
      thy[r] = d.thy;
      if (kThr && ((cfg.thr_mask >> r) & 1u) && a > 0) thr_m |= 1u << r;
      if (r >= 2)
        hi_bad = hi_bad || fr[r] < 0 ||
                 (((thr_m >> r) & 1u) && !(thx[r] < thy[r]));
    }
  }
  // the ring's memory is free for the stages: the generic proxy's reads
  // and writes ordered before the bulk copies'
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: every gang's member rows, a stage at a time, in the
    // order the consumers walk them
    if (lane == 0) {
      int j = 0;
      int lo = __ldg(offsets + g_lo);
      for (int g = g_lo; g < g_hi; ++g) {
        const int hi = __ldg(offsets + g + 1);
        for (int c = 0; c < hi - lo; c += kRowsPerStage, ++j) {
          const int slot = j % kStages;
          if (j >= kStages)
            koord::mbar_wait(&s_empty[slot],
                             static_cast<uint32_t>((j / kStages - 1) & 1));
          const int bytes = min(kRowsPerStage, hi - lo - c) * kRowInts * 4;
          koord::mbar_expect_tx(&s_full[slot], bytes);
          bulk_copy(s_ring + slot * kStageInts,
                    cum + static_cast<long long>(lo + c) * kRowInts, bytes,
                    &s_full[slot]);
        }
        lo = hi;
      }
    }
    return;
  }

  const bool aligned = (N & 3) == 0;
  const long long n4 = n0 + 4 * lane;  // this lane's word of 4 nodes
  // the state's validity word (the member mode)
  const uint32_t state_word =
      rows != nullptr ? byte_word(valid, N, n4, aligned) : 0u;
  int j = 0;  // the stage this warp reads next
  for (int ga = g_lo, ch = 0; ga < g_hi; ga += kGangChunk, ++ch) {
    const int b = ch & 1;
    const int cnt = min(kGangChunk, g_hi - ga);
    // the chunk's offsets, totals and node validity
    for (int k = t; k <= cnt; k += kNodesPerCta)
      s_off[b][k] = __ldg(offsets + ga + k);
    for (int k = t; k < cnt * kRowInts; k += kNodesPerCta)
      s_tot[b][k] = __ldg(totals + static_cast<long long>(ga) * kRowInts + k);
    for (int i = warp; i < cnt; i += kConsumerWarps)
      s_valid[b][i][lane] =
          rows != nullptr
              ? state_word
              : byte_word(valid + static_cast<long long>(ga + i) * N, N, n4,
                          aligned);
    consumer_sync();
    if (rows != nullptr) {
      // every member's feasible word ANDed into its gang's, the members'
      // row indices staged kIdxWindow at a time
      const int s_end = s_off[b][cnt];
      int i = 0;
      for (int w0 = s_off[b][0]; w0 < s_end; w0 += kIdxWindow) {
        const int wn = min(kIdxWindow, s_end - w0);
        for (int k = t; k < wn; k += kNodesPerCta)
          s_rowidx[k] = __ldg(rows + w0 + k);
        consumer_sync();
        for (int k0 = warp * kFeasBatch; k0 < wn;
             k0 += kConsumerWarps * kFeasBatch) {
          uint32_t word[kFeasBatch];
#pragma unroll
          for (int u = 0; u < kFeasBatch; ++u)
            word[u] = k0 + u < wn
                          ? byte_word(feasible + static_cast<long long>(
                                                     s_rowidx[k0 + u]) * N,
                                      N, n4, aligned)
                          : ~0u;
#pragma unroll
          for (int u = 0; u < kFeasBatch; ++u) {
            if (k0 + u < wn) {
              while (s_off[b][i + 1] <= w0 + k0 + u) ++i;
              atomicAnd(&s_valid[b][i][lane], word[u]);
            }
          }
        }
        consumer_sync();  // the window is read before the next is staged
      }
    }

    for (int i = 0; i < cnt; ++i) {
      const int m = s_off[b][i + 1] - s_off[b][i];
      const int* tot = s_tot[b] + i * kRowInts;
      const uint32_t live = static_cast<uint32_t>(tot[kLive]);
      // only cpu and memory vary over the member rows
      const bool two = (live & 0xfffcu) == 0 &&
                       ((live >> kLiveEst) & cfg.thr_mask & ~3u) == 0;
      bool alive =
          in && ((s_valid[b][i][t >> 2] >> ((t & 3) * 8)) & 0xffu) != 0 &&
          !(two && m > 0 && hi_bad);
      int result = 0;

      // the member rows, a stage at a time
      for (int c = 0; c < m; c += kRowsPerStage, ++j) {
        const int slot = j % kStages;
        koord::mbar_wait(&s_full[slot],
                         static_cast<uint32_t>((j / kStages) & 1));
        if (alive) {
          const int* S = s_ring + slot * kStageInts;
          const int count = min(kRowsPerStage, m - c);
          const int hit =
              two ? first_fail<kThr, true>(S, count, fr, thx, thy, thr_m, cfg)
                  : first_fail<kThr, false>(S, count, fr, thx, thy, thr_m,
                                            cfg);
          if (hit >= 0) {
            result = c + hit;
            alive = false;
          }
        }
        __syncwarp();
        if (lane == 0) koord::mbar_arrive(&s_empty[slot]);
      }

      // the zero rows past the members: rows m..P-1, the k-th of them
      // (from 1) at the members' cumulative request and their estimate
      // plus k zero estimates
      if (alive) {
        bool fit = true;
#pragma unroll
        for (int r = 0; r < kDims; ++r) fit = fit & (tot[r] <= fr[r]);
        if (m >= P) {
          result = P;
        } else if (!fit) {
          result = m;
        } else if (!kThr) {
          result = P;  // every zero row passes as the first did
        } else {
          result = m + zero_rows_fail(thx, thy, thr_m, tot, s_z, s_step,
                                      P - m);
        }
      }
      if (in) slots[static_cast<long long>(ga + i) * N + n] = result;
    }
  }
}

}  // namespace

// The C entry: K8 over G gangs, the scan then the walk on ``stream``.
// ``req`` holds the request rows and ``offsets`` the (G + 1) offsets of
// each gang's members: with ``rows`` (the member mode), gang g's members
// are req[rows[s]] for s in offsets[g]..offsets[g+1], ``valid`` is the
// state's (N,) node validity and ``feasible`` the (rows of req, N) mask;
// without (the explicit mode), its members are req[s] and ``valid`` is
// (G, N).  ``gps`` is the gangs a CTA walks (kernels/offer_slots.py
// offer_grid), ``cfg`` the packed config vector on the host (null: no
// threshold test) with the estimator's (R,) factors and defaults on the
// card, ``base`` the usage the thresholds read, ``cum`` (S, kRowInts) and
// ``totals`` (G + 1, kRowInts) the scan's scratch.  Returns the first
// failing launch's cudaGetLastError().
extern "C" int koord_offer_slots(const int* alloc, const int* requested,
                                 const int* base, int N, const int* req,
                                 const int* rows, const int* offsets, int G,
                                 int P, int gps, const uint8_t* valid,
                                 const uint8_t* feasible, const int* factors,
                                 const int* defaults, const int* cfg,
                                 int cfg_len, int* cum, int* totals,
                                 int* slots, void* stream) {
  if (G < 0 || N < 0 || P < 0 || gps < 1 ||
      (rows == nullptr) != (feasible == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || N == 0) return 0;
  koord::ScoreCfg c{};
  const bool use_thr = cfg != nullptr;
  if (use_thr) {
    if (cfg_len != koord::kCfgLen || factors == nullptr ||
        defaults == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    koord::load_score_cfg(c, cfg);
  }
  const long long tiles = (N + kNodesPerCta - 1) / kNodesPerCta;
  const long long slices = (G + static_cast<long long>(gps) - 1) / gps;
  if (tiles * slices > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned scan_grid = (G + kScanWarps - 1) / kScanWarps;
  if (use_thr)
    offer_slots_scan<true><<<scan_grid, kScanWarps * 32, 0, s>>>(
        req, rows, offsets, G, factors, defaults, cum, totals);
  else
    offer_slots_scan<false><<<scan_grid, kScanWarps * 32, 0, s>>>(
        req, rows, offsets, G, factors, defaults, cum, totals);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(tiles * slices);
  if (use_thr)
    offer_slots_walk<true><<<grid, kThreads, 0, s>>>(
        alloc, requested, base, N, rows, offsets, G, P, gps,
        static_cast<int>(tiles), valid, feasible, cum, totals, c, slots);
  else
    offer_slots_walk<false><<<grid, kThreads, 0, s>>>(
        alloc, requested, base, N, rows, offsets, G, P, gps,
        static_cast<int>(tiles), valid, feasible, cum, totals, c, slots);
  return static_cast<int>(cudaGetLastError());
}

// The walk's CTAs the card holds at once (SMs x CTAs an SM), with or
// without the threshold test, for the current device: the wrapper sizes the
// gang slices from it.  Kept after the first query; -1 on an error.
extern "C" long long koord_offer_slots_resident(int thr) {
  constexpr int kMaxDevices = 64;
  static long long known[kMaxDevices][2] = {};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  long long& slot = known[dev][thr ? 1 : 0];
  if (slot > 0) return slot;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  const cudaError_t err =
      thr ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, offer_slots_walk<true>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, offer_slots_walk<false>, kThreads, 0);
  if (err != cudaSuccess) return -1;
  slot = static_cast<long long>(sms) * per_sm;
  return slot;
}
