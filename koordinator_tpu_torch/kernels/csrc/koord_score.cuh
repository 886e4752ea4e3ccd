// One definition of the Filter + Score of a (pod, node) pair and of the
// candidate ranking, shared by K1 (select_candidates.cu), K2
// (refresh_candidates.cu) and K4/K4r (greedy_scan.cu), so the kernels
// compile the same arithmetic and rank on one scale.
//
// The JAX reference of each helper:
//   pair_score    koordinator_tpu/ops/assignment.py score_pods
//                 (_composite_score + _threshold_mask + fit)
//   tie_break     koordinator_tpu/ops/batch_assign.py _rank_parts /
//                 _candidate_tb
//   wide_rank     the (key, tb) order of _topk_by_rank's wide regime
//   rank_of       the (key desc, column asc) order of lax.top_k
//   SelRow        PodBatch.feasible_rows' selector gather
//
// Every floor division of a score divides by a value that does not change
// along one axis: a node's allocatable (per node), the LoadAware weight sum
// (per call), the FitPlus weight sum (per pod) and the scarce-dimension
// count (1..R).  Each is divided through a magic multiplier and shift
// (magic_fdiv) computed once for its axis, instead of the integer divide
// the compiler emulates in a few dozen instructions.  The PyTorch mirror
// of this arithmetic, tested on the CPU against floor division, is
// magic_divisor / magic_floordiv / scarce_floordiv in
// kernels/select_candidates.py.
#pragma once

#include <climits>

#include "koord_common.cuh"

namespace koord {

constexpr int kMaxPerStratum = 16;
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

// ---- floor division by an invariant divisor ------------------------------

// For 1 <= d < 2^31: l = ceil(log2 d), m = ceil(2^(31+l) / d) < 2^32.
// Then 0 <= m*d - 2^(31+l) < d <= 2^l, so for every 0 <= u < 2^31,
// floor(u*m / 2^(31+l)) == floor(u / d) (Granlund & Montgomery 1994,
// Thm 4.2, with N = 31).
struct Magic {
  uint32_t m;
  uint32_t l;
};

__host__ __device__ __forceinline__ Magic magic_for(int d) {
  const uint32_t ud = static_cast<uint32_t>(d);
#ifdef __CUDA_ARCH__
  const uint32_t l = 32u - __clz(ud - 1u);
#else
  const uint32_t l = ud > 1u ? 32u - __builtin_clz(ud - 1u) : 0u;
#endif
  const unsigned long long m = ((1ull << (31u + l)) + ud - 1u) / ud;
  return {static_cast<uint32_t>(m), l};
}

// floor(x / d) for any int32 x, from d's magic.  A negative x folds to
// ~x = -x-1 >= 0: floor(x / d) == ~floor(~x / d) for d > 0.
__device__ __forceinline__ int magic_fdiv(int x, uint32_t m, uint32_t l) {
  const int s = x >> 31;
  const uint32_t u = static_cast<uint32_t>(x ^ s);
  const unsigned long long p = static_cast<unsigned long long>(u) * m;
  // p < 2^63, so p >> 31 fits 32 bits
  const uint32_t q = __funnelshift_r(static_cast<uint32_t>(p),
                                     static_cast<uint32_t>(p >> 32), 31) >>
                     l;
  return static_cast<int>(q) ^ s;
}

// (n_diff - n_inter) * 100 // n_diff with n_diff in 1..R: the numerator is
// at most 100 * R, where (x * ceil(2^20 / n)) >> 20 is exact.
static __constant__ uint32_t kScarceRecip[kDims + 1] = {
    0,           1u << 20,           (1u << 20) / 2,
    349526u,     (1u << 20) / 4,     209716u,
    174763u,     149797u,            (1u << 20) / 8,
    116509u,     104858u};

__device__ __forceinline__ int scarce_div(int x, int n) {
  return static_cast<int>((static_cast<uint32_t>(x) * kScarceRecip[n]) >>
                          20);
}

// ---- the score -------------------------------------------------------------
//
// The pair score is computed from per-node terms, precomputed once per node
// (node_dim_terms), and the pod's request and estimate.  With a the node's
// allocatable, rq its requested, base the usage the threshold checks and
// thr the dimension's usage threshold:
//   fr  = valid ? a - rq : 0         (NodeResourcesFit's free capacity)
//   thx = 100 * base + (a >> 1)      (the threshold's left side without
//                                     the pod: 100 * (base + e) + a/2 is
//                                     thx + 100 * e, all wrapping int32)
//   thy = (thr + 1) * a              (its right side)
// and the magic divisor of max(a, 1).  The requested amount a FitPlus
// score needs is a - fr, exact for a valid node; an invalid node is never
// feasible, so its score is never used.  Which dimensions take which terms
// is a bit mask per call (ScoreCfg) and per pod (bit r of qpos: q[r] > 0),
// so each term walks only the dimensions it weighs, and the
// scarce-dimension counts are two population counts.  The kernels take
// the ScoreCfg as a __grid_constant__ parameter, so the config's masks and
// weights are uniform values in the constant bank.

struct __align__(16) ScoreCfg {
  int thr[kDims];   // usage threshold (aggregated when configured)
  int lw[kDims];    // LoadAware weight
  int fpw[kDims];   // FitPlus weight
  uint32_t thr_mask, la_mask, fp_mask, most_mask, scarce_mask;
  int la_dw, la_pw, fp_pw, sc_pw;
  int la_wsum;      // LoadAware weight sum (dominant weight included)
  uint32_t la_m, la_l;
};

// Fill ``s`` from the packed config vector (on the host, before a launch).
__host__ __device__ __forceinline__ void load_score_cfg(ScoreCfg& s,
                                                        const int* cfg) {
  int wsum = cfg[kLaDw];
  uint32_t thr_m = 0, la_m = 0, fp_m = 0, most_m = 0, sc_m = 0;
  for (int r = 0; r < kDims; ++r) {
    s.thr[r] = cfg[kThr + r];
    s.lw[r] = cfg[kLaW + r];
    s.fpw[r] = cfg[kFpW + r];
    thr_m |= (cfg[kThr + r] > 0 ? 1u : 0u) << r;
    la_m |= (cfg[kLaW + r] != 0 ? 1u : 0u) << r;
    fp_m |= (cfg[kFpW + r] != 0 ? 1u : 0u) << r;
    most_m |= (cfg[kFpMost + r] ? 1u : 0u) << r;
    sc_m |= (cfg[kScarce + r] ? 1u : 0u) << r;
    wsum = wadd(wsum, cfg[kLaW + r]);
  }
  s.thr_mask = thr_m;
  s.la_mask = la_m;
  s.fp_mask = fp_m;
  s.most_mask = most_m;
  s.scarce_mask = sc_m;
  s.la_dw = cfg[kLaDw];
  s.la_pw = cfg[kLaPw];
  s.fp_pw = cfg[kFpPw];
  s.sc_pw = cfg[kScPw];
  s.la_wsum = wsum;
  const Magic mg = magic_for(max(wsum, 1));
  s.la_m = mg.m;
  s.la_l = mg.l;
}

// The per-node terms of one dimension (see above).
struct DimTerms {
  int fr, thx, thy;
  Magic mg;
};

__device__ __forceinline__ DimTerms node_dim_terms(int a, int rq, int base,
                                                   bool nv, int thr) {
  return {nv ? wsub(a, rq) : 0, wadd(wmul(kMaxScore, base), a >> 1),
          wmul(wadd(thr, 1), a), magic_for(max(a, 1))};
}

// The per-pod terms: the mask of the dims it requests (q > 0) and of the
// dims whose request is not 0, and NodeResourcesFitPlus's weight sum over
// the requested dims (a divisor).  The request and estimate themselves are
// read through the pod accessor (q(r), e(r)), so that a dimension index
// known only at run time reads memory and not a register array.
struct PodScalars {
  uint32_t qpos, qnz;
  int fp_den;
  uint32_t fp_m, fp_l;
};

__device__ __forceinline__ PodScalars pod_scalars(const int* q,
                                                  const ScoreCfg& c) {
  int den = 0;
  uint32_t qpos = 0, qnz = 0;
#pragma unroll
  for (int r = 0; r < kDims; ++r) {
    if (q[r] > 0) {
      den = wadd(den, c.fpw[r]);
      qpos |= 1u << r;
    }
    if (q[r] != 0) qnz |= 1u << r;
  }
  const Magic mg = magic_for(max(den, 1));
  return {qpos, qnz, den, mg.m, mg.l};
}

// A pod whose request and estimate lie ``stride`` ints apart per dimension
// (K1 and K2: one column per pod of a block's shared memory; K4: the
// scan's current pod, stride 1).
struct PodRef {
  const int* q_;
  const int* e_;
  int stride;
  PodScalars s;
  __device__ __forceinline__ int q(int r) const { return q_[r * stride]; }
  __device__ __forceinline__ int e(int r) const { return e_[r * stride]; }
};

// Filter + Score of one (pod, node) pair: returns the composite score and
// sets ok to the fit & usage-threshold verdict (when ok is false the score
// is 0 and meaningless: every caller masks infeasible pairs).  ``Row``
// reads the node's terms: a(r), fr(r), use(r) (the usage LoadAware scores
// against), thx(r), thy(r), m(r), l(r) (the magic of max(a, 1)) and
// apos() (bit r: a > 0).  Each term walks only its own dimensions, as bit
// masks: the pod's nonzero requests (fit), the configured thresholds on
// allocatable dims, the LoadAware weights, the FitPlus weights on
// requested dims.  ``via`` (K4r: the node holds a reservation the pod fits
// through) passes the fit whatever the free capacity; the usage threshold
// still applies.
template <class Row>
__device__ __forceinline__ int pair_score(const Row& n, const PodRef& t,
                                          const ScoreCfg& c, bool& ok,
                                          bool via = false) {
  const uint32_t apos = n.apos();
  // NodeResourcesFit against the request-free capacity (0 when invalid)
  bool fit = via;
  if (!via) {
    fit = true;
    for (uint32_t m = t.s.qnz; m != 0; m &= m - 1) {
      const int r = __ffs(m) - 1;
      fit = fit & (t.q(r) <= n.fr(r));
    }
  }
  // usage threshold, cross-multiplied round-half-up (filtering.py:62-72)
  bool thr_ok = true;
  for (uint32_t m = c.thr_mask & apos; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    thr_ok = thr_ok & (wadd(n.thx(r), wmul(kMaxScore, t.e(r))) < n.thy(r));
  }
  // the score of an infeasible pair is never used: skip it
  ok = fit & thr_ok;
  if (!ok) return 0;
  // LoadAware: weighted least-used plus the dominant (min) term
  int la_sum = 0, dominant = kMaxScore;
  for (uint32_t m = c.la_mask; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int a = n.a(r);
    const int used = wadd(n.use(r), t.e(r));
    const int v = magic_fdiv(wmul(max(wsub(a, used), 0), kMaxScore), n.m(r),
                             n.l(r));
    const int per = (((apos >> r) & 1u) && used <= a) ? v : 0;
    const int lw = c.lw[r];
    la_sum = wadd(la_sum, wmul(per, lw));
    if (lw > 0) dominant = min(dominant, per);
  }
  // NodeResourcesFitPlus over the requested dims
  int fp_num = 0;
  for (uint32_t m = c.fp_mask & t.s.qpos; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int a = n.a(r);
    const int combined = wadd(wsub(a, n.fr(r)), t.q(r));
    const bool pos = (apos >> r) & 1u;
    const bool most = (c.most_mask >> r) & 1u;
    const int num = most ? wmul(min(combined, a), kMaxScore)
                         : wmul(max(wsub(a, combined), 0), kMaxScore);
    const int v = magic_fdiv(num, n.m(r), n.l(r));
    const int per = (pos && (most || combined <= a)) ? v : 0;
    fp_num = wadd(fp_num, wmul(per, c.fpw[r]));
  }
  // ScarceResourceAvoidance: allocatable but not requested dims
  const uint32_t diff = apos & ~t.s.qpos;
  const int n_diff = __popc(diff);
  const int n_inter = __popc(diff & c.scarce_mask);
  const int node_score = wadd(la_sum, wmul(dominant, c.la_dw));
  const int la = c.la_wsum > 0 ? magic_fdiv(node_score, c.la_m, c.la_l) : 0;
  const int fp_v = magic_fdiv(fp_num, t.s.fp_m, t.s.fp_l);
  const int fp = t.s.fp_den > 0 ? fp_v : kMaxScore;
  const int sc_v = scarce_div((n_diff - n_inter) * kMaxScore, n_diff);
  const int sc = (n_diff == 0 || n_inter == 0) ? kMaxScore : sc_v;
  return wadd(wadd(wmul(la, c.la_pw), wmul(fp, c.fp_pw)), wmul(sc, c.sc_pw));
}

// A node whose terms lie in the columns of K4's node range: term c (0
// allocatable, 1 free capacity, 2 usage, 3 and 4 the threshold's two sides,
// 5 the magic multipliers) of dimension r at base[(c * R + r) * S], the
// magic shifts at shf[r * S], base and shf pointing at the node's column.
// One base pointer, not one a term, keeps the scan's registers few.
struct ColumnRow {
  const int* base;
  const uint8_t* shf;
  int S;
  uint32_t flags;  // bits 0..R-1: a > 0, bit R: valid
  __device__ __forceinline__ int t(int c, int r) const {
    return base[(c * kDims + r) * S];
  }
  __device__ __forceinline__ int a(int r) const { return t(0, r); }
  __device__ __forceinline__ int fr(int r) const { return t(1, r); }
  __device__ __forceinline__ int use(int r) const { return t(2, r); }
  __device__ __forceinline__ int thx(int r) const { return t(3, r); }
  __device__ __forceinline__ int thy(int r) const { return t(4, r); }
  __device__ __forceinline__ uint32_t m(int r) const {
    return static_cast<uint32_t>(t(5, r));
  }
  __device__ __forceinline__ uint32_t l(int r) const { return shf[r * S]; }
  __device__ __forceinline__ uint32_t apos() const {
    return flags & ((1u << kDims) - 1u);
  }
};

constexpr uint32_t kValidFlag = 1u << kDims;

// ---- ranking ---------------------------------------------------------------

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

// The wide regime's 64-bit composite rank key * 2^30 + tb: for key >= -1
// and 0 <= tb < 2^30 its order is the lexicographic (key, tb) order.
__device__ __forceinline__ long long wide_rank(int key, int tb) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<long long>(key))
       << kWideTbBits) |
      static_cast<unsigned int>(tb));
}

// Insert v into the descending list a[0..K-1] (drop the smallest).  A value
// equal to the last one is not inserted, so among equal values the one
// inserted first stays.
template <typename T>
__device__ __forceinline__ void insert_sorted(T (&a)[kMaxPerStratum], T v) {
  if (v <= a[kMaxPerStratum - 1]) return;
#pragma unroll
  for (int j = kMaxPerStratum - 1; j > 0; --j) {
    a[j] = v > a[j - 1] ? a[j - 1] : max(a[j], v);
  }
  a[0] = max(a[0], v);
}

// A pod's (P, C) selector row as W = ceil(C / 64) words, packed before
// each kernel by pack_selector_words (below; selector_words in
// kernels/select_candidates.py is its PyTorch mirror): bit c & 63 of word
// c >> 6 is class c.  Word 0 sits in a register.  The kernels come in
// a one-word instance (C <= 64: the register's bit test alone) and a
// many-word one (kMulti), which reads the word of a class past 63 through
// L1, where the rows of the pods in flight stay.
struct SelRow {
  const unsigned long long* w;  // the pod's W words
  unsigned long long w0;        // word 0 (0 for an invalid pod)

  __device__ __forceinline__ static SelRow of(const unsigned long long* words,
                                              long long p, int W, bool valid) {
    const unsigned long long* row = words + p * W;
    return {row, valid ? row[0] : 0ull};
  }
  // selector_mask[:, min(class, C-1)] & (class < C)  (PodBatch.feasible_rows;
  // a negative class indexes from the end)
  template <bool kMulti>
  __device__ __forceinline__ bool ok(int cls, int C) const {
    if (cls >= C) return false;
    const int c = cls < 0 ? cls + C : cls;
    if constexpr (!kMulti) {
      return (w0 >> c) & 1ull;
    } else {
      // (the kernels test valid pods only: an invalid pod's row may lie
      // past the words' end)
      const unsigned long long word = c < 64 ? w0 : __ldg(w + (c >> 6));
      return (word >> (c & 63)) & 1ull;
    }
  }
};

// Pack the (P, C) bool selector mask into the (P, W) words SelRow reads,
// one thread a word.  Static, like pack_node_rows.
static __global__ void pack_selector_words(const uint8_t* __restrict__ sel,
                                           int P, int C, int W,
                                           unsigned long long* __restrict__
                                               words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(P) * W) return;
  const long long p = i / W;
  const int lo = static_cast<int>(i - p * W) * 64;
  const uint8_t* row = sel + p * C;
  unsigned long long word = 0;
  for (int c = lo; c < min(C, lo + 64); ++c)
    word |= static_cast<unsigned long long>(row[c] != 0) << (c - lo);
  words[i] = word;
}

// Launch pack_selector_words on ``st``: the words of a (P, C) mask into
// ``words`` ((P, ceil(C / 64)), the wrapper's scratch).
static inline cudaError_t pack_selector(const uint8_t* sel, int P, int C,
                                        unsigned long long* words,
                                        cudaStream_t st) {
  const long long n = static_cast<long long>(P) * ((C + 63) / 64);
  if (n == 0) return cudaSuccess;
  pack_selector_words<<<static_cast<unsigned int>((n + 255) / 256), 256, 0,
                        st>>>(sel, P, C, (C + 63) / 64, words);
  return cudaGetLastError();
}

// ---- packed node rows (K1 and K2) ------------------------------------------
//
// One node's pair_score terms as a 352-byte row (ints, each group padded to
// 12 for 16-byte loads): [0,12) allocatable, [12,24) free capacity, [24,36)
// usage, [36,48) and [48,60) the threshold's two sides, [60,72) magic
// multipliers, [72,84) magic shifts; 84 flags (bit r: a > 0, bit R: valid),
// 85 class, 86 the node's row in the node table.
constexpr int kRowInts = 88;
constexpr int kRowA = 0, kRowF = 12, kRowU = 24, kRowX = 36, kRowY = 48;
constexpr int kRowM = 60, kRowL = 72, kRowFlags = 84, kRowClass = 85;
constexpr int kRowNode = 86;

// Pack n_pad rows: row i from node ``ids[i]`` (node i when ``ids`` is
// null), valid when that node is in [0, N), valid in the table and
// ``id_valid[i]`` (when given).  Rows past ``n_ids`` are invalid padding.
// ``col_of``, when given, gets col_of[node] = i for every valid-listed
// node in [0, N) (any one of its rows when it is listed twice).  Static:
// each source that includes this header compiles its own copy.
static __global__ void pack_node_rows(const int* __restrict__ alloc,
                               const int* __restrict__ reqd,
                               const int* __restrict__ usage,
                               const int* __restrict__ base,
                               const uint8_t* __restrict__ nvalid,
                               const int* __restrict__ nclass,
                               const __grid_constant__ ScoreCfg cfg, int N,
                               const int* __restrict__ ids,
                               const uint8_t* __restrict__ id_valid,
                               int n_ids, int n_pad, int* __restrict__ rows,
                               int* __restrict__ col_of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  int* row = rows + static_cast<long long>(i) * kRowInts;
  const int n = i < n_ids ? (ids ? ids[i] : i) : -1;
  const bool in = static_cast<unsigned int>(n) < static_cast<unsigned int>(N);
  const bool listed = in && (id_valid == nullptr || id_valid[i]);
  const bool nv = listed && nvalid[n];
  if (col_of != nullptr && listed) col_of[n] = i;
  const long long src = static_cast<long long>(in ? n : 0) * kDims;
  unsigned int flags = nv ? kValidFlag : 0u;
  for (int r = 0; r < 12; ++r) {
    const bool d = in && r < kDims;
    const int a = d ? alloc[src + r] : 0;
    const DimTerms t = node_dim_terms(a, d ? reqd[src + r] : 0,
                                      d ? base[src + r] : 0, nv,
                                      r < kDims ? cfg.thr[r] : 0);
    row[kRowA + r] = a;
    row[kRowF + r] = t.fr;
    row[kRowU + r] = d ? usage[src + r] : 0;
    row[kRowX + r] = t.thx;
    row[kRowY + r] = t.thy;
    row[kRowM + r] = static_cast<int>(t.mg.m);
    row[kRowL + r] = static_cast<int>(t.mg.l);
    if (r < kDims && a > 0) flags |= 1u << r;
  }
  row[kRowFlags] = static_cast<int>(flags);
  row[kRowClass] = in ? nclass[n] : 0;
  row[kRowNode] = n;
  row[kRowNode + 1] = 0;
}

// One packed node row (shared or global memory) as pair_score reads it;
// its flags, class and node id come in one 16-byte load.
struct PackedRow {
  const int* p;
  int4 meta;
  __device__ __forceinline__ explicit PackedRow(const int* row) : p(row) {
    meta = reinterpret_cast<const int4*>(row)[kRowFlags / 4];
  }
  __device__ __forceinline__ int a(int r) const { return p[kRowA + r]; }
  __device__ __forceinline__ int fr(int r) const { return p[kRowF + r]; }
  __device__ __forceinline__ int use(int r) const { return p[kRowU + r]; }
  __device__ __forceinline__ int thx(int r) const { return p[kRowX + r]; }
  __device__ __forceinline__ int thy(int r) const { return p[kRowY + r]; }
  __device__ __forceinline__ uint32_t m(int r) const {
    return static_cast<uint32_t>(p[kRowM + r]);
  }
  __device__ __forceinline__ uint32_t l(int r) const {
    return static_cast<uint32_t>(p[kRowL + r]);
  }
  __device__ __forceinline__ uint32_t apos() const {
    return static_cast<uint32_t>(meta.x) & ((1u << kDims) - 1u);
  }
  __device__ __forceinline__ bool valid() const {
    return (static_cast<uint32_t>(meta.x) & kValidFlag) != 0;
  }
  __device__ __forceinline__ int cls() const { return meta.y; }
  __device__ __forceinline__ int node() const { return meta.z; }
};

}  // namespace koord
