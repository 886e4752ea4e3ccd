// K7: the Diagnose phase's reject-reason count.
//
// Replaces koordinator_tpu/ops/explain.py:83 explain_counts, the one
// device reduction of the JAX scheduler's Diagnose phase over the
// compacted failed rows of a round.  Its plain PyTorch version is
// explain_counts_plain in kernels/explain_counts.py.
//
// For each valid pod row p and each node row n < N with both rows valid,
// the pair counts against exactly one reason, first-fail in filter order:
//   - fit: the first dimension d (global order) with q[d] != 0 and
//     q[d] > free[n][d] (a request of 0 fits even a negative free);
//   - else the usage threshold (the aggregated thresholds replace the
//     instantaneous ones when any is > 0, as _threshold_mask);
//   - else affinity: the factored selector row (SelRow) or a dense (P, N)
//     mask;
//   - else the node is feasible.
// counts[p] = [node_invalid, fit per dim (R), usage_threshold, affinity,
// three pod-level gate columns left 0], feasible[p] the feasible nodes;
// node_invalid counts the invalid node rows of [0, N) for a valid pod.
// Invalid pod rows stay all zero.
//
// Fit, threshold and selector are judged exactly as K1 judges them
// (koord_score.cuh): the node terms come from pack_node_rows (the free
// capacity, and the threshold's two sides thx, thy, cross-multiplied and
// wrapping as in pair_score), the selector from pack_selector_words.
//
// What bounds it on the H100: operations.  F x N pairs, each a few int32
// compares over the pod's nonzero requests and the thresholded dims plus
// the selector test; the bytes are the node rows, the pods and an
// (F, 16) output, a few MB.  At F = 16,384, N = 10,240 that is ~2-4 G
// int32 operations against 16.73 T/s.  Design: the pairs never reach
// memory.  A CTA of 8 warps owns 32 pods, 4 a warp, their requests and
// 100 x estimates in shared memory; it stages tiles of 128 node rows (free
// capacity, thx and thy of the thresholded dims, flags, class) in shared
// memory, structure of arrays, so the 32 lanes of a warp (32 nodes) read
// 32 consecutive words.  Each lane finds its pair's reason, branch-free
// over the dims (warp-uniform predicates), so the 4 pods' tests
// interleave; the warp counts the reasons with one ballot a reason (only
// the pod's requested dimensions can fail fit), and lane c keeps reason
// c's count, one register a pod (counts a reason a lane would hold 13 a
// pod and cost the occupancy: 159 registers, one CTA an SM).  When the
// pods fill few CTAs (1,200 failed rows are 38 CTAs), the nodes split
// across CTAs along y and the CTAs' sums meet in integer atomicAdds,
// whose totals do not depend on their order.

#include <algorithm>

#include "koord_score.cuh"

namespace koord {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPodsPerWarp = 4;
constexpr int kPodsPerCta = kWarps * kPodsPerWarp;
constexpr int kTile = 128;
constexpr unsigned kFull = 0xffffffffu;

// the columns of a counts row (ops/explain.py's taxonomy)
constexpr int kReasons = kDims + 6;
constexpr int kColInvalid = 0;
constexpr int kColFit = 1;
constexpr int kColThr = 1 + kDims;
constexpr int kColAff = 2 + kDims;

// a pair's reason: 0..kDims-1 the first failing dimension, then these;
// kNone for a node row that is out of range or invalid
constexpr int kCodeThr = kDims;
constexpr int kCodeAff = kDims + 1;
constexpr int kCodeOk = kDims + 2;
constexpr int kCodeNone = -1;
constexpr int kCounters = kDims + 3;

constexpr uint32_t kInRange = 1u << 31;

// the tile's node rows, one array a term
struct Tile {
  int fr[kDims][kTile];
  int thx[kDims][kTile];
  int thy[kDims][kTile];
  uint32_t flags[kTile];  // packed-row flags, kInRange for a row < hi
  int cls[kTile];
};

// The mode of the affinity test: a selector of one word, of many words,
// or a dense (P, N) mask.
enum Affinity { kSel1 = 0, kSelMany = 1, kDense = 2 };

template <int kAff>
__global__ void __launch_bounds__(kThreads, 2) explain_counts_kernel(
    const int* __restrict__ rows, int N, int span,
    const int* __restrict__ req, const int* __restrict__ est,
    const uint8_t* __restrict__ pvalid,
    const unsigned long long* __restrict__ words, int C,
    const uint8_t* __restrict__ dense, const __grid_constant__ ScoreCfg cfg,
    int P, int* __restrict__ counts, int* __restrict__ feasible) {
  __shared__ Tile t;
  __shared__ int s_q[kPodsPerCta][kDims];
  __shared__ int s_e[kPodsPerCta][kDims];  // 100 x the estimate, wrapping
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pod0 = blockIdx.x * kPodsPerCta;
  for (int i = threadIdx.x; i < kPodsPerCta * kDims; i += kThreads) {
    const int j = i / kDims, r = i % kDims;
    const long long p = pod0 + j;
    const bool in = p < P;
    s_q[j][r] = in ? req[p * kDims + r] : 0;
    s_e[j][r] = in ? wmul(kMaxScore, est[p * kDims + r]) : 0;
  }
  const int W = (C + 63) / 64;
  uint32_t qnz[kPodsPerWarp];
  bool pv[kPodsPerWarp];
  unsigned long long w0[kPodsPerWarp];  // selector word 0 (SelRow)
  bool any = false;
#pragma unroll
  for (int i = 0; i < kPodsPerWarp; ++i) {
    const long long p = pod0 + warp * kPodsPerWarp + i;
    pv[i] = p < P && pvalid[p] != 0;
    any = any || pv[i];
    w0[i] = 0;
    if constexpr (kAff != kDense) {
      if (pv[i]) w0[i] = words[p * W];
    }
  }
  // (the barrier also publishes the staged pods)
  if (!__syncthreads_or(any)) return;
#pragma unroll
  for (int i = 0; i < kPodsPerWarp; ++i) {
    const int j = warp * kPodsPerWarp + i;
    qnz[i] = 0;
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      qnz[i] |= (s_q[j][r] != 0 ? 1u : 0u) << r;
    }
  }

  // lane c < kCounters holds pod i's count of reason code c (one register
  // a pod, not one a reason); lane kCounters the invalid node rows
  int mine[kPodsPerWarp];
#pragma unroll
  for (int i = 0; i < kPodsPerWarp; ++i) mine[i] = 0;
  int invalid_rows = 0;

  const int lo = blockIdx.y * span;
  const int hi = min(N, lo + span);
  for (int n0 = lo; n0 < hi; n0 += kTile) {
    __syncthreads();  // the last tile is read
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int n = n0 + j;
      const bool in = n < hi;
      const int* row = rows + static_cast<long long>(in ? n : 0) * kRowInts;
      t.flags[j] = in ? (static_cast<uint32_t>(row[kRowFlags]) | kInRange)
                      : 0u;
      t.cls[j] = in ? row[kRowClass] : 0;
    }
    for (int i = threadIdx.x; i < kTile * kDims; i += kThreads) {
      const int j = i / kDims, r = i % kDims;
      const int n = n0 + j;
      const long long at = static_cast<long long>(n < hi ? n : 0) * kRowInts;
      t.fr[r][j] = n < hi ? rows[at + kRowF + r] : 0;
    }
    for (uint32_t m = cfg.thr_mask; m != 0; m &= m - 1) {
      const int r = __ffs(m) - 1;
      for (int j = threadIdx.x; j < kTile; j += kThreads) {
        const int n = n0 + j;
        const long long at = static_cast<long long>(n < hi ? n : 0) * kRowInts;
        t.thx[r][j] = rows[at + kRowX + r];
        t.thy[r][j] = rows[at + kRowY + r];
      }
    }
    __syncthreads();

    for (int j = lane; j < kTile; j += 32) {
      const uint32_t flags = t.flags[j];
      const bool in = (flags & kInRange) != 0;
      const bool nv = in && (flags & kValidFlag);
      invalid_rows += __popc(__ballot_sync(kFull, in && !nv));
      const int cls = t.cls[j];
#pragma unroll
      for (int i = 0; i < kPodsPerWarp; ++i) {
        if (!pv[i]) continue;  // uniform across the warp
        const int slot = warp * kPodsPerWarp + i;
        // every test over fixed dimensions, predicated by warp-uniform
        // masks, so the pods' tests interleave
        uint32_t fail = 0;
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((qnz[i] >> r) & 1u) {
            fail |= (s_q[slot][r] > t.fr[r][j] ? 1u : 0u) << r;
          }
        }
        bool thr_bad = false;
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((cfg.thr_mask >> r) & 1u) {
            // a thresholded dim of this node: a > 0 (pair_score's apos)
            thr_bad = thr_bad ||
                      (((flags >> r) & 1u) &&
                       wadd(t.thx[r][j], s_e[slot][r]) >= t.thy[r][j]);
          }
        }
        bool aff;
        if constexpr (kAff == kDense) {
          // (a row past the range reads nothing: the mask ends at N)
          const long long p = pod0 + slot;
          aff = nv && dense[p * N + n0 + j] != 0;
        } else {
          const long long p = pod0 + slot;
          const SelRow sr{words + p * W, w0[i]};
          aff = sr.ok<kAff == kSelMany>(cls, C);
        }
        const int code = !nv         ? kCodeNone
                         : fail != 0 ? __ffs(fail) - 1
                         : thr_bad   ? kCodeThr
                         : !aff      ? kCodeAff
                                     : kCodeOk;
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((qnz[i] >> r) & 1u) {
            const int c = __popc(__ballot_sync(kFull, code == r));
            mine[i] += lane == r ? c : 0;
          }
        }
#pragma unroll
        for (int r = kCodeThr; r <= kCodeOk; ++r) {
          const int c = __popc(__ballot_sync(kFull, code == r));
          mine[i] += lane == r ? c : 0;
        }
      }
    }
  }

  // lane c adds its reason's count to its column; lane kCounters the
  // invalid rows
  if (lane > kCounters) return;
  const int col = lane < kDims       ? kColFit + lane
                  : lane == kCodeThr ? kColThr
                  : lane == kCodeAff ? kColAff
                  : lane == kCodeOk  ? -1
                                     : kColInvalid;
#pragma unroll
  for (int i = 0; i < kPodsPerWarp; ++i) {
    if (!pv[i]) continue;
    const long long p = pod0 + warp * kPodsPerWarp + i;
    const int v = lane == kCounters ? invalid_rows : mine[i];
    if (v == 0) continue;
    atomicAdd(col < 0 ? feasible + p : counts + p * kReasons + col, v);
  }
}

template <int kAff>
cudaError_t launch(dim3 grid, int span, const int* rows, int N,
                   const int* req, const int* est, const uint8_t* pvalid,
                   const unsigned long long* words, int C,
                   const uint8_t* dense, const ScoreCfg& cfg, int P,
                   int* counts, int* feasible, cudaStream_t st) {
  explain_counts_kernel<kAff><<<grid, kThreads, 0, st>>>(
      rows, N, span, req, est, pvalid, words, C, dense, cfg, P, counts,
      feasible);
  return cudaGetLastError();
}

// The CTAs of an instance the card holds at once (asked once a process).
template <int kAff>
int resident_ctas() {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, explain_counts_kernel<kAff>, kThreads, 0);
    return std::max(1, sms * std::max(per_sm, 1));
  }();
  return resident;
}

}  // namespace
}  // namespace koord

using namespace koord;

// Bytes of the packed node rows koord_explain_counts needs as scratch.
extern "C" long long koord_explain_counts_scratch_bytes(int N) {
  return static_cast<long long>(std::max(N, 1)) * kRowInts * sizeof(int);
}

extern "C" int koord_explain_counts(
    const int* alloc, const int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, const int* preq,
    const int* pest, const uint8_t* pvalid, const uint8_t* sel, int C,
    unsigned long long* words, const uint8_t* dense, const int* cfg,
    int cfg_len, int P, int N, int n_reasons, int* rows, int* counts,
    int* feasible, void* stream) {
  if (cfg_len != kCfgLen || cfg == nullptr || n_reasons != kReasons ||
      P < 0 || N < 1 || (sel == nullptr) == (dense == nullptr) ||
      (sel != nullptr && (C < 1 || words == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(P) * kReasons * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(feasible, 0, static_cast<size_t>(P) * sizeof(int),
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  pack_node_rows<<<(N + 255) / 256, 256, 0, st>>>(
      alloc, reqd, usage, base, nvalid, nclass, sc, N, nullptr, nullptr, N,
      N, rows, nullptr);
  err = cudaGetLastError();
  if (err == cudaSuccess && sel != nullptr)
    err = pack_selector(sel, P, C, words, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int aff = dense != nullptr ? kDense : (C > 64 ? kSelMany : kSel1);
  const int gx = (P + kPodsPerCta - 1) / kPodsPerCta;
  const int tiles = (N + kTile - 1) / kTile;
  // split the nodes across CTAs until the grid holds two waves
  const int resident = aff == kDense      ? resident_ctas<kDense>()
                       : aff == kSelMany ? resident_ctas<kSelMany>()
                                         : resident_ctas<kSel1>();
  int splits = std::min(tiles, std::max(1, (2 * resident + gx - 1) / gx));
  const int span = ((tiles + splits - 1) / splits) * kTile;
  splits = (N + span - 1) / span;
  const dim3 grid(gx, splits);
  const unsigned long long* w = sel != nullptr ? words : nullptr;
  switch (aff) {
    case kDense:
      err = launch<kDense>(grid, span, rows, N, preq, pest, pvalid, w, C,
                           dense, sc, P, counts, feasible, st);
      break;
    case kSelMany:
      err = launch<kSelMany>(grid, span, rows, N, preq, pest, pvalid, w, C,
                             dense, sc, P, counts, feasible, st);
      break;
    default:
      err = launch<kSel1>(grid, span, rows, N, preq, pest, pvalid, w, C,
                          dense, sc, P, counts, feasible, st);
  }
  return static_cast<int>(err);
}
