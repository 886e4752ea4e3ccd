// K7's third design with counting option (b): a ballot a live reason.
//
// probes/k7_turns.py times it against koordinator_tpu_torch/kernels/csrc/
// explain_counts.cu, which it copies but for the count: where that keeps
// a pod's 8-bit counters a slot packed four to a register and flushes
// them every kFlushTiles tiles, this one ballots each live slot (the k-th
// requested dim of the block, the threshold, affinity) for each of a
// lane's 16 (step, pod) pairs of a tile, lane k adding the popc of slot
// k's ballot to a 32-bit count a pod; the warp reduces the counts only at
// a block's change and at the range's end.  Everything else (the live
// dims, the codes, the grid, the ring) is the tree's.  Build it as the
// tree is built (it includes the same headers from the kernels' csrc).

#include <algorithm>
#include <climits>
#include <type_traits>

#include "koord_mbarrier.cuh"
#include "koord_score.cuh"

namespace koord {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPodsPerWarp = 4;
constexpr int kPodsPerCta = kWarps * kPodsPerWarp;
static_assert(kPodsPerWarp == 4, "a dimension's 4 pod values are an int4");
constexpr int kTile = 128;
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;
// a lane's node rows of a tile (a step each), and the tiles between two
// flushes: a lane's steps between flushes stay within an 8-bit field, and
// the warp's sum of a field (32 lanes, as 16-bit fields) under 2^16
constexpr int kSteps = kTile / 32;
constexpr int kFieldLimit = 255;
constexpr int kFlushTiles = kFieldLimit / kSteps;
static_assert(kFlushTiles * kSteps <= kFieldLimit &&
                  32 * kFieldLimit < (1 << 16),
              "a flush comes before an 8-bit field or its warp sum overflows");

// the columns of a counts row (ops/explain.py's taxonomy)
constexpr int kReasons = kDims + 6;
constexpr int kColInvalid = 0;
constexpr int kColFit = 1;
constexpr int kColThr = 1 + kDims;
constexpr int kColAff = 2 + kDims;

// the packed columns of a tile: flags, class, free capacity (kDims), then
// thx and thy of each thresholded dimension in order
constexpr int kColFlags = 0;
constexpr int kColClass = 1;
constexpr int kColFree = 2;
constexpr int kColThx = 2 + kDims;
constexpr int kMaxCols = kColThx + 2 * kDims;

// the code of a pair no test fails
constexpr int kNone = 255;
// a selector table's entries: C classes, then none (C) and an invalid row
// (C + 1); the one-word selector's (C <= 64) hold 4 codes, the tabled
// many-word selector's (C <= kTableClasses) a byte of 4 pods' bits
constexpr int kSel1Entries = 66;
constexpr int kTableEntries = 4096;
constexpr int kTableClasses = kTableEntries - 2;

// The mode of the affinity test: a selector of one word, of many words
// (tabled up to kTableClasses classes, else read a pair at a time), or a
// dense (P, N) mask.
enum Affinity { kSel1 = 0, kSelMany = 1, kDense = 2, kSelTable = 3 };

// The instance for a dense mask or a selector of C classes.
Affinity instance_of(bool dense, int C) {
  return dense ? kDense
         : C <= 64 ? kSel1
         : C <= kTableClasses ? kSelTable
                              : kSelMany;
}

// Copy ``bytes`` from global memory into this CTA's shared memory,
// completing on the mbarrier ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Pack the node columns of every tile, and the last valid pod's row + 1
// into *p_eff (zeroed before).  A row that is invalid or past N reads as
// one no test fails on: free INT_MAX, no thresholded dim (flags 0).  With
// ``table_classes`` = C > 0 (a tabled selector) the class column holds
// the row's table entry: SelRow's class (negative ones from the end), C
// (none: every pod fails) past the selector or before its start, C + 1
// for an invalid row.
__global__ void pack_explain_columns(
    const int* __restrict__ alloc, const int* __restrict__ reqd,
    const int* __restrict__ base, const uint8_t* __restrict__ nvalid,
    const int* __restrict__ nclass, const __grid_constant__ ScoreCfg cfg,
    int N, long long n_pad, int ncols, int table_classes,
    int* __restrict__ cols, const uint8_t* __restrict__ pvalid, int P,
    unsigned long long* __restrict__ p_eff) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // (a warp's largest valid row first: one atomic a warp)
  const unsigned last = __reduce_max_sync(
      kFull, i < P && pvalid[i] ? static_cast<unsigned>(i) + 1u : 0u);
  if (threadIdx.x % 32 == 0 && last > 0)
    atomicMax(p_eff, static_cast<unsigned long long>(last));
  if (i >= n_pad) return;
  const bool in = i < N;
  const bool nv = in && nvalid[i];
  int* col = cols + (i / kTile) * ncols * kTile + (i % kTile);
  const long long src = (in ? i : 0) * kDims;
  uint32_t flags = nv ? kValidFlag : 0u;
  int c = kColThx;
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    const int a = in ? alloc[src + r] : 0;
    const DimTerms t = node_dim_terms(a, in ? reqd[src + r] : 0,
                                      in ? base[src + r] : 0, nv, cfg.thr[r]);
    col[(kColFree + r) * kTile] = nv ? t.fr : INT_MAX;
    if ((cfg.thr_mask >> r) & 1u) {
      col[c * kTile] = t.thx;
      col[(c + 1) * kTile] = t.thy;
      c += 2;
    }
    if (nv && a > 0) flags |= 1u << r;
  }
  col[kColFlags * kTile] = static_cast<int>(flags);
  int cls = in ? nclass[i] : 0;
  if (table_classes > 0) {
    const int C = table_classes;
    const int cc = cls < 0 ? cls + C : cls;
    cls = !nv ? C + 1 : cls < C && cc >= 0 ? cc : C;
  }
  col[kColClass * kTile] = cls;
}

// (the untabled many-word selector keeps its 4 pods' first words in
// registers: two CTAs an SM, where the others fit three)
template <int kAff>
__global__ void __launch_bounds__(kThreads, kAff == kSelMany ? 2 : 3)
    explain_counts_kernel(
    const int* __restrict__ cols, int ncols, int N, int tiles,
    long long* __restrict__ record, const int* __restrict__ req,
    const int* __restrict__ est, const uint8_t* __restrict__ pvalid,
    const unsigned long long* __restrict__ words, int C,
    const uint8_t* __restrict__ dense, uint32_t thr_mask, int P,
    int* __restrict__ counts, int* __restrict__ feasible) {
  // kStages x ncols x kTile, then the tabled selector's kWarps x
  // kTableEntries bytes
  extern __shared__ __align__(128) int s_ring[];
  // a dimension's value for the block's 32 pods: q (INT_MIN for a request
  // of 0, which never exceeds a free) and 100 x the estimate, wrapping
  __shared__ __align__(16) int s_q[kDims][kPodsPerCta];
  __shared__ __align__(16) int s_e[kDims][kPodsPerCta];
  // the one-word selector's table: a warp's 4 pods' first codes by the
  // node's class entry (kNone where the pod admits it, else affinity's)
  __shared__ int4 s_tab[kAff == kSel1 ? kWarps : 1][kSel1Entries];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ uint32_t s_U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this CTA's even share of the (block, tile) pairs, block-major, over
  // the blocks up to the last valid pod (record[0], the pack's), recorded
  // as [start, stop) after it (explain_plan's ranges)
  const long long blocks = (record[0] + kPodsPerCta - 1) / kPodsPerCta;
  const long long work = blocks * tiles;
  const long long per = work / gridDim.x, rem = work % gridDim.x;
  const long long b = blockIdx.x;
  const long long w_lo = b * per + min(b, rem);
  const long long n_work = per + (b < rem ? 1 : 0);
  if (threadIdx.x == 0) {
    record[1 + 2 * b] = w_lo;
    record[2 + 2 * b] = w_lo + n_work;
  }
  if (n_work == 0) return;  // uniform over the CTA

  const int stage_ints = ncols * kTile;
  uint8_t* tab8 = reinterpret_cast<uint8_t*>(s_ring + kStages * stage_ints) +
                  warp * kTableEntries;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long t) {  // the CTA's t-th tile into its stage
    const int stage = static_cast<int>(t % kStages);
    const long long tile = (w_lo + t) % tiles;
    mbar_expect_tx(&s_full[stage], stage_ints * 4);
    bulk_copy(s_ring + stage * stage_ints, cols + tile * stage_ints,
              stage_ints * 4, &s_full[stage]);
  };
  if (tid == 0) {
    for (long long t = 0; t < kStages && t < n_work; ++t) issue(t);
  }

  const int W = (C + 63) / 64;
  long long blk = -1;  // the block in the registers
  uint32_t U = 0;
  int nf = 0, my_col = -1;
  bool pv[kPodsPerWarp];
  unsigned long long w0[kPodsPerWarp];
  int cnt[kPodsPerWarp];  // lane k: slot k's pairs a pod since the flush
  bool warp_any = false;
  int vcnt = 0;      // this lane's valid node rows since the flush
  int rows = 0;      // node rows of [0, N) since the flush
#pragma unroll
  for (int i = 0; i < kPodsPerWarp; ++i) {
    pv[i] = false;
    w0[i] = 0;
    cnt[i] = 0;
  }

  // the warp's counts since the last flush into counts and feasible
  auto flush = [&]() {
    const int V = static_cast<int>(__reduce_add_sync(kFull, vcnt));
#pragma unroll
    for (int i = 0; i < kPodsPerWarp; ++i) {
      if (pv[i]) {  // uniform over the warp
        const int total = static_cast<int>(
            __reduce_add_sync(kFull, static_cast<unsigned>(cnt[i])));
        const int mine = cnt[i];
        const long long p = blk * kPodsPerCta + warp * kPodsPerWarp + i;
        int* row = counts + p * kReasons;
        if (my_col >= 0 && mine != 0) atomicAdd(row + my_col, mine);
        if (lane == 30 && rows != V) atomicAdd(row + kColInvalid, rows - V);
        if (lane == 31 && V != total) atomicAdd(feasible + p, V - total);
      }
      cnt[i] = 0;
    }
    vcnt = 0;
    rows = 0;
  };

  // One staged tile for the warp's 4 pods, the dimensions outermost: a
  // lane's kSteps node rows (lane, lane + 32, ...) and 4 pods hold 16
  // codes, each 8 x the slot of the pair's reason so far (kNone: none).
  // The tests run from the last reason to the first, each overwriting the
  // code where it fails (affinity, then the threshold, then the fit dims
  // from the last), so the code left is the first failing reason's; a
  // ballot a live slot and pair counts it (kNone in none).
  auto count_tile = [&](const int* S, long long tile) {
    int code[kSteps][kPodsPerWarp];
    uint32_t flags[kSteps];
    const int t8 = 8 * nf;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int j = lane + 32 * s;
      flags[s] = static_cast<uint32_t>(S[kColFlags * kTile + j]);
      vcnt += (flags[s] >> kDims) & 1u;  // kValidFlag
      if constexpr (kAff == kSel1) {
        const int4 c4 = s_tab[warp][S[kColClass * kTile + j]];
        code[s][0] = c4.x;
        code[s][1] = c4.y;
        code[s][2] = c4.z;
        code[s][3] = c4.w;
      } else if constexpr (kAff == kSelTable) {
        const uint32_t m = tab8[S[kColClass * kTile + j]];
        const int a8 = 8 * (nf + 1);
#pragma unroll
        for (int i = 0; i < kPodsPerWarp; ++i)
          code[s][i] = (m >> i) & 1u ? kNone : a8;
      } else {
        const bool nv = flags[s] & kValidFlag;
        const int a8 = 8 * (nf + 1);
#pragma unroll
        for (int i = 0; i < kPodsPerWarp; ++i) {
          bool ok = true;
          if (pv[i] && nv) {  // (an invalid pod's row is not read)
            const long long p = blk * kPodsPerCta + warp * kPodsPerWarp + i;
            if constexpr (kAff == kSelMany) {
              ok = SelRow{words + p * W, w0[i]}.ok<true>(
                  S[kColClass * kTile + j], C);
            } else {
              ok = dense[p * N + tile * kTile + j] != 0;
            }
          }
          code[s][i] = ok ? kNone : a8;
        }
      }
    }
    // the usage threshold: a thresholded dim with a > 0 (pair_score's
    // apos) whose 100 x (usage + estimate) + a/2 reaches (thr + 1) x a
    int c = kColThx;
    for (uint32_t m = thr_mask; m != 0; m &= m - 1, c += 2) {
      const int d = __ffs(m) - 1;
      const int4 e = *reinterpret_cast<const int4*>(
          &s_e[d][warp * kPodsPerWarp]);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int j = lane + 32 * s;
        const bool apos = (flags[s] >> d) & 1u;
        const int x = S[c * kTile + j], y = S[(c + 1) * kTile + j];
        code[s][0] = apos && wadd(x, e.x) >= y ? t8 : code[s][0];
        code[s][1] = apos && wadd(x, e.y) >= y ? t8 : code[s][1];
        code[s][2] = apos && wadd(x, e.z) >= y ? t8 : code[s][2];
        code[s][3] = apos && wadd(x, e.w) >= y ? t8 : code[s][3];
      }
    }
    // fit: the k-th dimension of U is slot k, walked from the last
    int k8 = 8 * nf;
    for (uint32_t m = U; m != 0;) {
      const int d = 31 - __clz(m);
      m ^= 1u << d;
      k8 -= 8;
      const int4 q = *reinterpret_cast<const int4*>(
          &s_q[d][warp * kPodsPerWarp]);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int f = S[(kColFree + d) * kTile + lane + 32 * s];
        code[s][0] = q.x > f ? k8 : code[s][0];
        code[s][1] = q.y > f ? k8 : code[s][1];
        code[s][2] = q.z > f ? k8 : code[s][2];
        code[s][3] = q.w > f ? k8 : code[s][3];
      }
    }
    for (int k = 0; k < nf + 2; ++k) {
      const int k8 = 8 * k;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int i = 0; i < kPodsPerWarp; ++i) {
          const int n = __popc(__ballot_sync(kFull, code[s][i] == k8));
          cnt[i] += lane == k ? n : 0;
        }
      }
    }
  };

  for (long long t = 0; t < n_work; ++t) {
    const long long w = w_lo + t;
    const long long wb = w / tiles;
    const long long tile = w - wb * tiles;
    if (wb != blk) {  // a new block of pods (uniform over the CTA)
      if (blk >= 0) flush();
      if (tid == 0) s_U = 0;
      __syncthreads();  // the last block's pods are no longer read
      for (int k = tid; k < kPodsPerCta * kDims; k += kThreads) {
        const int j = k / kDims, r = k % kDims;
        const long long p = wb * kPodsPerCta + j;
        const bool ok = p < P && pvalid[p] != 0;
        const int q = ok ? req[p * kDims + r] : 0;
        s_q[r][j] = q != 0 ? q : INT_MIN;
        s_e[r][j] = ok ? wmul(kMaxScore, est[p * kDims + r]) : 0;
        if (q != 0) atomicOr(&s_U, 1u << r);
      }
      blk = wb;
      warp_any = false;
#pragma unroll
      for (int i = 0; i < kPodsPerWarp; ++i) {
        const long long p = blk * kPodsPerCta + warp * kPodsPerWarp + i;
        pv[i] = p < P && pvalid[p] != 0;
        warp_any = warp_any || pv[i];
        w0[i] = 0;
        if constexpr (kAff == kSel1 || kAff == kSelMany) {
          if (pv[i]) w0[i] = words[p * W];
        }
      }
      __syncthreads();
      U = s_U;
      nf = __popc(U);
      my_col = -1;
      if (lane < nf) {
        uint32_t m = U;
        for (int k = 0; k < lane; ++k) m &= m - 1;
        my_col = kColFit + __ffs(m) - 1;
      } else if (lane == nf) {
        my_col = kColThr;
      } else if (lane == nf + 1) {
        my_col = kColAff;
      }
      if constexpr (kAff == kSel1) {
        const int a8 = 8 * (nf + 1);
        for (int e = lane; e < C + 2; e += 32) {
          int v[kPodsPerWarp];
#pragma unroll
          for (int i = 0; i < kPodsPerWarp; ++i) {
            const bool ok = e == C + 1 || (e < C && ((w0[i] >> e) & 1ull));
            v[i] = ok ? kNone : a8;
          }
          s_tab[warp][e] = make_int4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
      } else if constexpr (kAff == kSelTable) {
        // bit i of entry e: pod i admits class e (every pod an invalid row)
        for (int e = lane; e < C + 2; e += 32) {
          uint32_t m = e == C + 1 ? 0xfu : 0u;
#pragma unroll
          for (int i = 0; i < kPodsPerWarp; ++i) {
            const long long p = blk * kPodsPerCta + warp * kPodsPerWarp + i;
            if (e < C && pv[i] && ((__ldg(words + p * W + (e >> 6)) >>
                                    (e & 63)) & 1ull))
              m |= 1u << i;
          }
          tab8[e] = static_cast<uint8_t>(m);
        }
        __syncwarp();
      }
    }
    const int stage = static_cast<int>(t % kStages);
    rows += static_cast<int>(
        min(static_cast<long long>(kTile), N - tile * kTile));
    mbar_wait(&s_full[stage], static_cast<uint32_t>((t / kStages) & 1));

    if (warp_any) {
      const int* S = s_ring + stage * stage_ints;
      count_tile(S, tile);
    }
    __syncthreads();  // the stage is read
    if (tid == 0 && t + kStages < n_work) issue(t + kStages);
  }
  flush();
}

// The dynamic shared memory of an instance: the ring, the table.
template <int kAff>
int dyn_smem(int ncols) {
  return kStages * ncols * kTile * static_cast<int>(sizeof(int)) +
         (kAff == kSelTable ? kWarps * kTableEntries : 0);
}

// Allow the largest ring of an instance on the current device (a
// function attribute is a device's own: set before every launch).
template <int kAff>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(explain_counts_kernel<kAff>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dyn_smem<kAff>(kMaxCols));
}

template <int kAff>
cudaError_t launch(int grid, int ncols, const int* cols, int N, int tiles,
                   long long* record, const int* req, const int* est,
                   const uint8_t* pvalid, const unsigned long long* words,
                   int C, const uint8_t* dense, uint32_t thr_mask, int P,
                   int* counts, int* feasible, cudaStream_t st) {
  cudaError_t err = allow_smem<kAff>();
  if (err != cudaSuccess) return err;
  explain_counts_kernel<kAff><<<grid, kThreads, dyn_smem<kAff>(ncols),
                                st>>>(
      cols, ncols, N, tiles, record, req, est, pvalid, words, C, dense,
      thr_mask, P, counts, feasible);
  return cudaGetLastError();
}

// The CTAs of an instance an SM holds with a ring of ``ncols`` columns.
template <int kAff>
int ctas_per_sm(int ncols) {
  if (allow_smem<kAff>() != cudaSuccess) return 0;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, explain_counts_kernel<kAff>, kThreads, dyn_smem<kAff>(ncols));
  return per_sm;
}

int ncols_of(int thr_dims) { return kColThx + 2 * thr_dims; }

long long padded_rows(int N) {
  return (static_cast<long long>(std::max(N, 1)) + kTile - 1) / kTile * kTile;
}

}  // namespace
}  // namespace koord

using namespace koord;

// Bytes of the node columns (every thresholded dim's) koord_explain_counts
// needs as scratch.
extern "C" long long koord_explain_counts_scratch_bytes(int N) {
  return padded_rows(N) * kMaxCols * static_cast<long long>(sizeof(int));
}

// The CTAs the card holds at once of the instance koord_explain_counts
// takes for a selector of ``C`` classes or a ``dense`` mask under the
// config ``cfg`` (its thresholded dims size the ring): the grid
// explain_plan takes.  0 for an invalid config.
// (asked once a device of the first 16, instance and dim count)
extern "C" long long koord_explain_counts_resident(int C, int dense,
                                                   const int* cfg,
                                                   int cfg_len) {
  if (cfg_len != kCfgLen || cfg == nullptr || (dense == 0 && C < 1))
    return 0;
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  const int thr_dims = __builtin_popcount(sc.thr_mask);
  const Affinity aff = instance_of(dense != 0, C);
  static long long known[16][kSelTable + 1][kDims + 1] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  long long* slot = dev < 16 ? &known[dev][aff][thr_dims] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  const int ncols = ncols_of(thr_dims);
  const int per_sm = aff == kDense      ? ctas_per_sm<kDense>(ncols)
                     : aff == kSelMany  ? ctas_per_sm<kSelMany>(ncols)
                     : aff == kSelTable ? ctas_per_sm<kSelTable>(ncols)
                                        : ctas_per_sm<kSel1>(ncols);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (slot != nullptr) *slot = resident;
  return resident;
}

// ``record`` (1 + 2 x grid int64) gets the last valid pod's row + 1, then
// each CTA's [start, stop) of (block, tile) pairs.
extern "C" int koord_explain_counts(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const uint8_t* sel, int C,
    unsigned long long* words, const uint8_t* dense, const int* cfg,
    int cfg_len, int P, int N, int n_reasons, int* scratch, int* counts,
    int* feasible, int grid, long long* record, void* stream) {
  (void)usage;  // the threshold reads ``base`` (the aggregated or not)
  if (cfg_len != kCfgLen || cfg == nullptr || n_reasons != kReasons ||
      P < 0 || N < 1 || (sel == nullptr) == (dense == nullptr) ||
      (sel != nullptr && (C < 1 || words == nullptr)) || grid < 1 ||
      record == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 0) return static_cast<int>(cudaSuccess);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  const int ncols = ncols_of(__builtin_popcount(sc.thr_mask));
  const long long n_pad = padded_rows(N);
  const int tiles = static_cast<int>(n_pad / kTile);
  const Affinity aff = instance_of(dense != nullptr, C);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(P) * kReasons * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(feasible, 0, static_cast<size_t>(P) * sizeof(int),
                          st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(record, 0, sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = std::max(n_pad, static_cast<long long>(P));
  pack_explain_columns<<<static_cast<unsigned int>((threads + 255) / 256),
                         256, 0, st>>>(
      alloc, reqd, base, nvalid, nclass, sc, N, n_pad, ncols,
      aff == kSel1 || aff == kSelTable ? C : 0, scratch, pvalid, P,
      reinterpret_cast<unsigned long long*>(record));
  err = cudaGetLastError();
  if (err == cudaSuccess && sel != nullptr)
    err = pack_selector(sel, P, C, words, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned long long* w = sel != nullptr ? words : nullptr;
  const uint32_t tm = sc.thr_mask;
  switch (aff) {
    case kDense:
      err = launch<kDense>(grid, ncols, scratch, N, tiles, record, preq, pest,
                           pvalid, w, C, dense, tm, P, counts, feasible, st);
      break;
    case kSelMany:
      err = launch<kSelMany>(grid, ncols, scratch, N, tiles, record, preq,
                             pest, pvalid, w, C, dense, tm, P, counts,
                             feasible, st);
      break;
    case kSelTable:
      err = launch<kSelTable>(grid, ncols, scratch, N, tiles, record, preq,
                              pest, pvalid, w, C, dense, tm, P, counts,
                              feasible, st);
      break;
    default:
      err = launch<kSel1>(grid, ncols, scratch, N, tiles, record, preq, pest,
                          pvalid, w, C, dense, tm, P, counts, feasible, st);
  }
  return static_cast<int>(err);
}
