// One definition of the Filter + Score of a (pod, node) pair and of the
// candidate ranking, shared by K1 (select_candidates.cu), K2
// (refresh_candidates.cu) and K4 (greedy_scan.cu), so the three kernels
// compile the same arithmetic and rank on one scale.
//
// The JAX reference of each helper:
//   pair_score    koordinator_tpu/ops/assignment.py score_pods
//                 (_composite_score + _threshold_mask + fit)
//   tie_break     koordinator_tpu/ops/batch_assign.py _rank_parts /
//                 _candidate_tb
//   rank_of       the (key desc, column asc) order of lax.top_k
#pragma once

#include <climits>

#include "koord_common.cuh"

namespace koord {

constexpr int kMaxPerStratum = 16;
constexpr int kTbBits = 15;
constexpr int kScoreClip = (1 << kTbBits) - 1;
constexpr int kMaxScore = 100;

// Offsets into the packed int32 config vector (kernels/select_candidates.py
// _config_vector builds it in this order).
constexpr int kLaW = 0;
constexpr int kLaDw = kDims;
constexpr int kLaPw = kDims + 1;
constexpr int kThr = kDims + 2;
constexpr int kFpW = 2 * kDims + 2;
constexpr int kFpMost = 3 * kDims + 2;
constexpr int kScarce = 4 * kDims + 2;
constexpr int kFpPw = 5 * kDims + 2;
constexpr int kScPw = 5 * kDims + 3;
constexpr int kCfgLen = 5 * kDims + 4;

// least_used_score / least_requested_score (ops/scoring.py)
__device__ __forceinline__ int least_used(int used, int cap) {
  if (!(cap > 0 && used <= cap)) return 0;
  return fdiv(wmul(max(wsub(cap, used), 0), kMaxScore), max(cap, 1));
}

// The LoadAware weight sum of the config (dominant weight included).
__device__ __forceinline__ int loadaware_weight_sum(const int* cfg) {
  int s = cfg[kLaDw];
  for (int r = 0; r < kDims; ++r) s = wadd(s, cfg[kLaW + r]);
  return s;
}

// Filter + Score of one (pod, node) pair: returns the composite score and
// sets ok to the fit & usage-threshold verdict.  Node rows are read through
// pointers to their R values (shared memory, global memory or registers).
// use is the usage LoadAware scores against, base the usage the threshold
// checks (the aggregated usage when that policy is configured).
__device__ __forceinline__ int pair_score(
    const int* preq, const int* pest, const int* alloc, const int* reqd,
    const int* use, const int* base, bool node_valid, const int* cfg,
    int la_wsum, bool& ok) {
  bool fit = true, thr_ok = true;
  int la_sum = 0, dominant = kMaxScore;
  int fp_num = 0, fp_den = 0;
  int n_diff = 0, n_inter = 0;
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    const int a = alloc[r];
    const int q = preq[r];
    // NodeResourcesFit against the request-free capacity (0 when invalid)
    const int free_r = node_valid ? wsub(a, reqd[r]) : 0;
    fit = fit && ((q <= free_r) || (q == 0));
    // usage threshold, cross-multiplied round-half-up (filtering.py:62-72)
    const int thr = cfg[kThr + r];
    const int est = wadd(base[r], pest[r]);
    const int lhs = wadd(wmul(kMaxScore, est), a >> 1);
    if (thr > 0 && a > 0 && lhs >= wmul(wadd(thr, 1), a)) thr_ok = false;
    // LoadAware: weighted least-used plus the dominant (min) term
    const int lw = cfg[kLaW + r];
    if (lw != 0) {
      const int per = least_used(wadd(use[r], pest[r]), a);
      la_sum = wadd(la_sum, wmul(per, lw));
      if (lw > 0) dominant = min(dominant, per);
    }
    // NodeResourcesFitPlus over the requested dims
    const int fw = q > 0 ? cfg[kFpW + r] : 0;
    if (fw != 0) {
      const int combined = wadd(reqd[r], q);
      int per;
      if (cfg[kFpMost + r]) {
        per = a > 0 ? fdiv(wmul(min(combined, a), kMaxScore), max(a, 1)) : 0;
      } else {
        per = least_used(combined, a);
      }
      fp_num = wadd(fp_num, wmul(per, fw));
      fp_den = wadd(fp_den, fw);
    }
    // ScarceResourceAvoidance
    const bool diff = (a > 0) && !(q > 0);
    n_diff += diff;
    n_inter += diff && cfg[kScarce + r];
  }
  ok = fit && thr_ok;
  const int node_score = wadd(la_sum, wmul(dominant, cfg[kLaDw]));
  const int la = la_wsum > 0 ? fdiv(node_score, max(la_wsum, 1)) : 0;
  const int fp = fp_den > 0 ? fdiv(fp_num, max(fp_den, 1)) : kMaxScore;
  const int sc = (n_diff == 0 || n_inter == 0)
                     ? kMaxScore
                     : fdiv((n_diff - n_inter) * kMaxScore, max(n_diff, 1));
  return wadd(wadd(wmul(la, cfg[kLaPw]), wmul(fp, cfg[kFpPw])),
              wmul(sc, cfg[kScPw]));
}

// Rotated tie-break of _rank_parts: (N-1) - ((n - rot*7919) mod N), with the
// product and difference wrapping in int32 and the mod floored.
__device__ __forceinline__ int tie_break(int n, int rot7919, int N) {
  return (N - 1) - fmod_floor(wsub(n, rot7919), N);
}

__device__ __forceinline__ int clip_score(int s) {
  return min(max(s, 0), kScoreClip);
}

// Sortable rank of one column: key in the high word, (2^31-1 - n) in the
// low word, so int64 order is (key descending, column ascending) — top_k's
// and jnp.argmax's.
__device__ __forceinline__ long long rank_of(int key, int n) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<long long>(key)) << 32;
  return static_cast<long long>(
      hi | static_cast<unsigned int>(0x7FFFFFFF - n));
}

// Insert v into the descending list a[0..K-1] (drop the smallest).
__device__ __forceinline__ void insert_sorted(long long (&a)[kMaxPerStratum],
                                              long long v) {
  if (v <= a[kMaxPerStratum - 1]) return;
#pragma unroll
  for (int j = kMaxPerStratum - 1; j > 0; --j) {
    a[j] = v > a[j - 1] ? a[j - 1] : max(a[j], v);
  }
  a[0] = max(a[0], v);
}

// A pod's (P, C) selector row packed into a bit mask (C <= 64).
__device__ __forceinline__ unsigned long long selector_bits(
    const uint8_t* sel, long long p, int C) {
  unsigned long long mask = 0;
  for (int c = 0; c < C; ++c)
    if (sel[p * C + c]) mask |= 1ull << c;
  return mask;
}

__device__ __forceinline__ bool selector_ok(unsigned long long mask, int cls,
                                            int C) {
  // selector_mask[:, min(class, C-1)] & (class < C)  (PodBatch.feasible_rows)
  if (cls >= C) return false;
  int c = cls < 0 ? cls + C : cls;
  return (mask >> c) & 1ull;
}

}  // namespace koord
