// K8: the gang offer-slot count of network-topology gang placement.
//
// Replaces koordinator_tpu/ops/network_topology.py:125 gang_offer_slots,
// the (N, P, R) prefix-sum feasibility test that the topology planner runs
// for every gang with JobTopologyRequirements, for all of a round's such
// gangs in one launch.  Its plain PyTorch version is offer_slots_plain in
// kernels/offer_slots.py.
//
// For gang g, its front-packed (P, R) request matrix is its M_g member
// rows (requests[offsets[g]:offsets[g+1]], in order) followed by P - M_g
// zero rows.  slots[g, n] is the number of leading rows of that matrix for
// which both tests hold on node n, stopping at the first that fails
// (JAX's cumprod):
//   fit:        cum[p, r] <= alloc[n, r] - requested[n, r]  for every r
//               (no exemption for a zero request; the free capacity is
//               taken whatever the state's node_valid says);
//   threshold:  _threshold_mask with the cumulative band estimate cum_est,
//               the same wrapping test as K1's (koord_score.cuh
//               node_dim_terms: thx + 100 * cum_est < thy on every
//               thresholded dim with allocatable > 0), when a config is
//               given;
// and slots[g, n] = 0 where node_valid[g, n] is false.  Every sum wraps
// in int32, as JAX's int32 cumsum does.
//
// The zero rows past the members are not read: their cumulative request is
// the members' total, and their cumulative estimate the members' plus k
// times the estimate of a zero request (the estimator defaults), k rows
// in.  So the rows past the members are tested from registers alone, and
// a gang whose zero rows change no thresholded term (no config, or
// defaults of 0) ends after one test of them.
//
// What bounds it on the H100: operations.  Each (gang, node) pair tests
// rows until its first failure: R compares and, on the thresholded dims,
// a multiply-add and a compare a row.  The bytes are the node table once
// a gang and the members' rows once a CTA.  Design: one thread a node,
// 128 nodes a CTA, one CTA row a gang (grid.y); the CTA stages 128 member
// rows at a time in shared memory, each of the 2R prefix sequences
// scanned by a warp (four rows a lane, then a shuffle scan, the running
// total carried between stages), and every thread reads the stage's rows
// as broadcasts.  A CTA stops staging once none of its nodes is still
// counting.

#include "koord_score.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wmul;

constexpr int kNodesPerCta = 128;
constexpr int kRowsPerStage = 128;
constexpr int kWarps = kNodesPerCta / 32;
constexpr int kSeqs = 2 * kDims;  // the request dims, then the estimate's
static_assert(kRowsPerStage == 4 * 32, "a warp scans 4 rows a lane");

__global__ void __launch_bounds__(kNodesPerCta) offer_slots_kernel(
    const int* __restrict__ alloc, const int* __restrict__ requested,
    const int* __restrict__ base, int N, const int* __restrict__ req,
    const int* __restrict__ est, const int* __restrict__ offsets, int P,
    const uint8_t* __restrict__ node_valid, const int* __restrict__ zero_est,
    const __grid_constant__ koord::ScoreCfg cfg, int use_thr,
    int* __restrict__ slots) {
  __shared__ __align__(16) int s_cum[kSeqs][kRowsPerStage];
  __shared__ int s_carry[kSeqs];
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n = blockIdx.x * kNodesPerCta + t;
  const long long row0 = offsets[g];
  const int m = offsets[g + 1] - offsets[g];
  const int seqs = use_thr ? kSeqs : kDims;

  // the node's terms: free capacity and the threshold's two sides
  int fr[kDims], thx[kDims], thy[kDims];
  uint32_t thr_m = 0;
  bool alive = false;
  if (n < N) {
    alive = node_valid[static_cast<long long>(g) * N + n] != 0;
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      const long long i = static_cast<long long>(n) * kDims + r;
      const int a = alloc[i];
      const koord::DimTerms d =
          koord::node_dim_terms(a, requested[i], base[i], true, cfg.thr[r]);
      fr[r] = d.fr;
      thx[r] = d.thx;
      thy[r] = d.thy;
      if (use_thr && ((cfg.thr_mask >> r) & 1u) && a > 0) thr_m |= 1u << r;
    }
  }
  if (t < kSeqs) s_carry[t] = 0;
  int result = 0;

  // the member rows, a stage at a time
  for (int s = 0; s < m; s += kRowsPerStage) {
    if (!__syncthreads_or(alive)) break;
    const int rows = min(kRowsPerStage, m - s);
    {
      const bool in = t < rows;
      const long long src = (row0 + s + t) * kDims;
#pragma unroll
      for (int r = 0; r < kDims; ++r) {
        s_cum[r][t] = in ? req[src + r] : 0;
        if (use_thr) s_cum[kDims + r][t] = in ? est[src + r] : 0;
      }
    }
    __syncthreads();
    // inclusive scan of each sequence, plus the carry of earlier stages
    for (int k = warp; k < seqs; k += kWarps) {
      int4* q = reinterpret_cast<int4*>(s_cum[k]) + lane;
      int4 v = *q;
      v.y = wadd(v.y, v.x);
      v.z = wadd(v.z, v.y);
      v.w = wadd(v.w, v.z);
      int incl = v.w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = wadd(incl, u);
      }
      const int carry = s_carry[k];
      const int add = wadd(carry, koord::wsub(incl, v.w));
      v.x = wadd(v.x, add);
      v.y = wadd(v.y, add);
      v.z = wadd(v.z, add);
      v.w = wadd(v.w, add);
      *q = v;
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      if (lane == 0) s_carry[k] = wadd(carry, total);
    }
    __syncthreads();
    if (alive) {
      for (int j = 0; j < rows; ++j) {
        bool ok = true;
#pragma unroll
        for (int r = 0; r < kDims; ++r) ok = ok & (s_cum[r][j] <= fr[r]);
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((thr_m >> r) & 1u)
            ok = ok & (wadd(thx[r], wmul(koord::kMaxScore,
                                         s_cum[kDims + r][j])) < thy[r]);
        }
        if (!ok) {
          result = s + j;
          alive = false;
          break;
        }
      }
    }
  }
  __syncthreads();

  // the zero rows past the members: rows m..P-1, the k-th of them (from
  // 1) at the members' cumulative request and their estimate plus k zero
  // estimates
  if (alive) {
    bool fit = true;
#pragma unroll
    for (int r = 0; r < kDims; ++r) fit = fit & (s_carry[r] <= fr[r]);
    if (m >= P) {
      result = P;
    } else if (!fit) {
      result = m;
    } else {
      int ce[kDims], z[kDims];
      uint32_t vary = 0;
#pragma unroll
      for (int r = 0; r < kDims; ++r) {
        ce[r] = use_thr ? s_carry[kDims + r] : 0;
        z[r] = use_thr ? zero_est[r] : 0;
        if (((thr_m >> r) & 1u) && z[r] != 0) vary |= 1u << r;
      }
      result = P;
      int k = 1;
      for (int p = m; p < P; ++p, ++k) {
        bool ok = true;
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if ((thr_m >> r) & 1u)
            ok = ok & (wadd(thx[r], wmul(koord::kMaxScore,
                                         wadd(ce[r], wmul(k, z[r])))) <
                       thy[r]);
        }
        if (!ok) {
          result = p;
          break;
        }
        // no thresholded term changes from row to row: every later row
        // passes as this one did
        if (vary == 0) break;
      }
    }
  }
  if (n < N) slots[static_cast<long long>(g) * N + n] = result;
}

}  // namespace

// The C entry: one launch over G gangs.  ``req`` / ``est`` are the (S, R)
// member rows and their band estimates (``est`` and ``zero_est`` unused
// without a config), ``offsets`` the (G + 1,) row offsets, ``node_valid``
// (G, N), ``cfg`` the packed config vector on the host (null: no
// threshold test), ``base`` the usage the thresholds read.  Returns the
// launch's cudaGetLastError().
extern "C" int koord_offer_slots(const int* alloc, const int* requested,
                                 const int* base, int N, const int* req,
                                 const int* est, const int* offsets, int G,
                                 int P, const uint8_t* node_valid,
                                 const int* zero_est, const int* cfg,
                                 int cfg_len, int* slots, void* stream) {
  if (G < 0 || G > 65535 || N < 0 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || N == 0) return 0;
  koord::ScoreCfg c{};
  const bool use_thr = cfg != nullptr;
  if (use_thr) {
    if (cfg_len != koord::kCfgLen || est == nullptr || zero_est == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    koord::load_score_cfg(c, cfg);
  }
  const dim3 grid((N + kNodesPerCta - 1) / kNodesPerCta, G);
  offer_slots_kernel<<<grid, kNodesPerCta, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      alloc, requested, base, N, req, est, offsets, P, node_valid, zero_est,
      c, use_thr ? 1 : 0, slots);
  return static_cast<int>(cudaGetLastError());
}
