// K3b: a propose/accept round's acceptance over every level, one launch.
//
// Replaces the contended path of the JAX round's conflict resolution,
//   koordinator_tpu/ops/batch_assign.py:271-296 _prefix_accept_sorted_choice
// as round_body (:606) applies it: the node level (_prefix_accept, :200),
// then every ancestor column of the quota chain and the min headroom of
// non-preemptible pods (_quota_prefix_accept, :299-330).  Its plain PyTorch
// versions are round_prefix_accept_plain (the levels one by one) and
// segmented_prefix_accept_plain (one level) in kernels/prefix_accept.py;
// round_prefix_accept_mirror there is this kernel's arithmetic in PyTorch.
//
// Input: one list of entries, each a (pod, group) pair, grouped: the node
// level's entries (the round's choices, grouped by a stable sort, so each
// group is in priority order), then the quota levels' entries (grouped once
// a solve: every pod that may be active at a level, inactive ones adding 0
// and getting no verdict).  A run is one group: it starts where the group
// changes and at the quota part's first entry.  An active entry is accepted
// when the run's sum of active requests up to and including it fits its
// row's headroom on every dim it requests (q == 0 passes the dim); a pod is
// accepted when it is active and every entry of it is.  Sums are int32 and
// wrap, which equals the JAX cum - cummax(excl) form while the global sum
// of non-negative requests does not overflow.  The overflow segment (a node
// entry whose group is the overflow id) is never accepted.
//
// What bounds it on the H100: bytes, per entry its index words, its pod's
// activity, request row and headroom row (the requested dims only), and
// the (P,) verdict.  Design: a single-pass parallel segmented inclusive
// scan, so a run of 50,000 entries costs what a run of 5 does:
// - each CTA takes one tile of kTile entries, numbered by an atomic ticket
//   (a tile's predecessors have started, so its wait always ends);
// - a thread scans its kItems consecutive entries, a warp its threads by
//   shuffles, the CTA its warps through shared memory;
// - the carry into a tile comes by decoupled look-back: a tile publishes
//   its aggregate, or its inclusive prefix when it holds a run start (the
//   sum since that start) or when it has its carry; warp 0 of the next
//   tile reads 32 predecessors at a time and stops at the first inclusive;
// - only the requested dims are summed (a bit mask, taken once a solve);
// - a rejected entry clears its pod's byte of the output, which starts as
//   the round's activity, so entries write only zeros and never race;
// - the look-back's scratch (the ticket, a status word and two value slots
//   a tile) arrives zeroed.

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kFull = 0xFFFFFFFFu;

// A tile's published state: nothing yet, its aggregate (no run starts in
// it), or its inclusive prefix.
constexpr int kNothing = 0;
constexpr int kAggregate = 1;
constexpr int kInclusive = 2;

struct Args {
  // node level: entries [0, n_node)
  const int* node_group;       // grouped segment ids
  const long long* node_pos;   // each entry's position in order
  const long long* order;      // (P,) priority order
  const int* node_req;         // (P, R)
  const int* node_free;        // (S, R) by segment, or (P, R) by pod
  int node_by_pod;
  int n_node;
  int overflow;                // the overflow segment id
  int n_segments;              // S: a segment row is clamped into [0, S)
  // quota levels: entries [n_node, n_node + n_quota)
  const int* q_pod;
  const int* q_group;
  const int* q_row;            // < Q: headroom row, else min headroom
  const int* q_req;            // (P, R) masked by the quota's checked dims
  const int* q_head;           // (Q, R)
  const int* q_min_head;       // (Q, R)
  int n_quota;
  int n_q_rows;                // Q
  const uint8_t* act;          // (P,)
  unsigned int dims;           // bit r: some pod requests dim r
  // look-back scratch: the ticket, a status word a tile, then two value
  // slots a tile (its aggregate, its inclusive prefix: a slot is written
  // once, before its status, and never again in the launch)
  unsigned int* ticket;
  int* status;
  int* values;
  uint8_t* out;                // (P,), holds act on entry
};

struct Item {
  const int* req;   // the pod's request row
  const int* head;  // its headroom row; nullptr in the overflow
  int pod;
  bool act, start;
};

__device__ __forceinline__ int group_of(const Args& a, int i) {
  return i < a.n_node ? a.node_group[i] : a.q_group[i - a.n_node];
}

__device__ __forceinline__ Item load_item(const Args& a, int i, int group,
                                          int prev_group) {
  Item it;
  it.start = i == 0 || i == a.n_node || group != prev_group;
  if (i < a.n_node) {
    const long long pod = a.order[a.node_pos[i]];
    it.pod = static_cast<int>(pod);
    it.req = a.node_req + pod * kDims;
    const int row = min(max(group, 0), a.n_segments - 1);
    it.head = group == a.overflow ? nullptr
              : a.node_by_pod     ? a.node_free + pod * kDims
                                  : a.node_free +
                                    static_cast<long long>(row) * kDims;
  } else {
    const int j = i - a.n_node;
    const long long pod = a.q_pod[j];
    const int row = a.q_row[j];
    it.pod = static_cast<int>(pod);
    it.req = a.q_req + pod * kDims;
    it.head = row < a.n_q_rows
                  ? a.q_head + static_cast<long long>(row) * kDims
                  : a.q_min_head +
                        static_cast<long long>(row - a.n_q_rows) * kDims;
  }
  it.act = a.act[it.pod] != 0;
  return it;
}

// x_left (+) x_right of the segmented sum: a start in the right operand
// cuts the left one off.
__device__ __forceinline__ void combine(bool& flag, int (&s)[kDims],
                                        bool left_flag,
                                        const int (&left)[kDims], int nd) {
#pragma unroll
  for (int r = 0; r < kDims; ++r)
    if (r < nd && !flag) s[r] = wadd(left[r], s[r]);
  flag = flag || left_flag;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(kThreads) round_accept_kernel(
    const __grid_constant__ Args a) {
  __shared__ int s_tile;
  __shared__ int s_wsum[kWarps][kDims];
  __shared__ int s_wflag[kWarps];
  __shared__ int s_carry[kDims];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(a.ticket, 1u));
  // the requested dims, in order
  int dl[kDims];
  const int nd = __popc(a.dims);
  {
    unsigned int m = a.dims;
#pragma unroll
    for (int r = 0; r < kDims; ++r) {
      dl[r] = m ? __ffs(m) - 1 : 0;
      m &= m - 1u;
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const int n_entries = a.n_node + a.n_quota;
  const int base = tile * kTile + tid * kItems;

  // this thread's entries, and its sums since its last start
  Item items[kItems];
  bool tflag = false;
  int tsum[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r) tsum[r] = 0;
  int prev = base > 0 && base < n_entries ? group_of(a, base - 1) : 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n_entries) {
      const int g = group_of(a, i);
      items[k] = load_item(a, i, g, prev);
      prev = g;
    } else {
      items[k] = Item{nullptr, nullptr, 0, false, true};
    }
    if (items[k].start) {
      tflag = true;
#pragma unroll
      for (int r = 0; r < kDims; ++r) tsum[r] = 0;
    }
    if (items[k].act) {
#pragma unroll
      for (int r = 0; r < kDims; ++r)
        if (r < nd) tsum[r] = wadd(tsum[r], items[k].req[dl[r]]);
    }
  }

  // the warp's inclusive scan of the threads' sums
  bool wflag = tflag;
  int wsum[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r) wsum[r] = tsum[r];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool lf = __shfl_up_sync(kFull, wflag, off);
    int left[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r)
      left[r] = r < nd ? __shfl_up_sync(kFull, wsum[r], off) : 0;
    if (lane >= off) combine(wflag, wsum, lf, left, nd);
  }
  // this thread's exclusive prefix within the warp
  bool eflag = __shfl_up_sync(kFull, wflag, 1);
  int esum[kDims];
#pragma unroll
  for (int r = 0; r < kDims; ++r)
    esum[r] = r < nd ? __shfl_up_sync(kFull, wsum[r], 1) : 0;
  if (lane == 0) {
    eflag = false;
#pragma unroll
    for (int r = 0; r < kDims; ++r) esum[r] = 0;
  }
  if (lane == 31) {
    s_wflag[warp] = wflag;
#pragma unroll
    for (int r = 0; r < kDims; ++r) s_wsum[warp][r] = wsum[r];
  }
  __syncthreads();

  // warp 0: the warps' exclusive prefixes, the tile's aggregate, its
  // publication and the look-back
  if (warp == 0) {
    bool f = lane < kWarps ? s_wflag[lane] != 0 : false;
    int s[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) s[r] = lane < kWarps ? s_wsum[lane][r] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const bool lf = __shfl_up_sync(kFull, f, off);
      int left[kDims];
#pragma unroll
      for (int r = 0; r < kDims; ++r)
        left[r] = r < nd ? __shfl_up_sync(kFull, s[r], off) : 0;
      if (lane >= off) combine(f, s, lf, left, nd);
    }
    // the tile's aggregate: lane kWarps - 1's inclusive value
    const bool agg_flag = __shfl_sync(kFull, f, kWarps - 1);
    int agg[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r)
      agg[r] = r < nd ? __shfl_sync(kFull, s[r], kWarps - 1) : 0;
    // exclusive warp prefixes back to shared memory
    bool xf = __shfl_up_sync(kFull, f, 1);
    int xs[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r)
      xs[r] = r < nd ? __shfl_up_sync(kFull, s[r], 1) : 0;
    __syncwarp();
    if (lane < kWarps) {
      s_wflag[lane] = lane > 0 && xf;
#pragma unroll
      for (int r = 0; r < kDims; ++r) s_wsum[lane][r] = lane > 0 ? xs[r] : 0;
    }
    // publish: a tile holding a start (tile 0 always does) publishes its
    // inclusive prefix at once
    int* my_values = a.values + static_cast<long long>(tile) * 2 * kDims;
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kDims; ++r)
        my_values[(agg_flag ? kDims : 0) + r] = agg[r];
      st_release(a.status + tile, agg_flag ? kInclusive : kAggregate);
    }
    // the carry: the run sum before this tile, from predecessors' values,
    // 32 at a time, up to the nearest inclusive one
    int carry[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) carry[r] = 0;
    if (tile > 0) {
      for (int j0 = tile - 1;; j0 -= 32) {
        const int j = j0 - lane;
        int st = kInclusive;  // before tile 0: nothing to add
        int v[kDims];
#pragma unroll
        for (int r = 0; r < kDims; ++r) v[r] = 0;
        if (j >= 0) {
          // a predecessor publishes within microseconds; a wait of ~2^22
          // polls means a broken launch: fault instead of hanging the card
          int polls = 0;
          do {
            st = ld_acquire(a.status + j);
            if (++polls > (1 << 22)) __trap();
          } while (st == kNothing);
          const volatile int* pv =
              a.values + static_cast<long long>(j) * 2 * kDims +
              (st == kInclusive ? kDims : 0);
#pragma unroll
          for (int r = 0; r < kDims; ++r)
            if (r < nd) v[r] = pv[r];
        }
        const unsigned int stop = __ballot_sync(kFull, st == kInclusive);
        const int last = stop ? __ffs(stop) - 1 : 31;
        // lanes up to the stop hold no start, so their sum is a plain sum
#pragma unroll
        for (int r = 0; r < kDims; ++r) {
          if (r < nd) {
            const unsigned int x =
                lane <= last ? static_cast<unsigned int>(v[r]) : 0u;
            carry[r] = wadd(carry[r],
                            static_cast<int>(__reduce_add_sync(kFull, x)));
          }
        }
        if (stop) break;
      }
      if (!agg_flag && lane == 0) {
        // now the inclusive prefix is known: carry + aggregate
#pragma unroll
        for (int r = 0; r < kDims; ++r)
          my_values[kDims + r] = wadd(carry[r], agg[r]);
        st_release(a.status + tile, kInclusive);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kDims; ++r) s_carry[r] = carry[r];
    }
  }
  __syncthreads();

  // each entry's run sum: carry (+) warp prefix (+) thread prefix (+) its
  // own entries; verdicts
  {
    bool f = eflag;
    int s[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) s[r] = esum[r];
    int wp[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) wp[r] = s_wsum[warp][r];
    combine(f, s, s_wflag[warp] != 0, wp, nd);
    int cr[kDims];
#pragma unroll
    for (int r = 0; r < kDims; ++r) cr[r] = s_carry[r];
    combine(f, s, false, cr, nd);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const Item& it = items[k];
      if (it.start) {
#pragma unroll
        for (int r = 0; r < kDims; ++r) s[r] = 0;
      }
      if (!it.act) continue;
      bool fits = it.head != nullptr;
#pragma unroll
      for (int r = 0; r < kDims; ++r) {
        if (r < nd) {
          const int q = it.req[dl[r]];
          s[r] = wadd(s[r], q);
          fits = fits && (q == 0 || s[r] <= it.head[dl[r]]);
        }
      }
      if (!fits) a.out[it.pod] = 0;
    }
  }
}

int n_tiles_for(long long entries) {
  return static_cast<int>((entries + kTile - 1) / kTile);
}

}  // namespace

// Ints of zeroed look-back scratch a launch over ``entries`` entries
// needs: the ticket, then for every tile a status word and two value
// slots.
extern "C" long long koord_segmented_prefix_accept_scratch_ints(
    long long entries) {
  return 1 + static_cast<long long>(n_tiles_for(entries)) * (1 + 2 * kDims);
}

extern "C" int koord_segmented_prefix_accept(
    const int* node_group, const long long* node_pos, const long long* order,
    const int* node_req, const int* node_free, int node_by_pod, int n_node,
    int overflow, int n_segments, const int* q_pod, const int* q_group,
    const int* q_row, const int* q_req, const int* q_head,
    const int* q_min_head, int n_quota, int n_q_rows, const uint8_t* act,
    int dims, int* scratch, long long scratch_ints, uint8_t* out,
    void* stream) {
  const long long entries = static_cast<long long>(n_node) + n_quota;
  if (n_node < 0 || n_quota < 0 || entries > INT32_MAX - kTile ||
      (n_node > 0 && (node_group == nullptr || node_pos == nullptr ||
                      node_free == nullptr || n_segments < 1)) ||
      (n_quota > 0 && (q_pod == nullptr || q_head == nullptr ||
                       q_min_head == nullptr || n_q_rows < 1)) ||
      koord_segmented_prefix_accept_scratch_ints(entries) > scratch_ints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (entries == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.node_group = node_group;
  a.node_pos = node_pos;
  a.order = order;
  a.node_req = node_req;
  a.node_free = node_free;
  a.node_by_pod = node_by_pod;
  a.n_node = n_node;
  a.overflow = overflow;
  a.n_segments = n_segments;
  a.q_pod = q_pod;
  a.q_group = q_group;
  a.q_row = q_row;
  a.q_req = q_req;
  a.q_head = q_head;
  a.q_min_head = q_min_head;
  a.n_quota = n_quota;
  a.n_q_rows = n_q_rows;
  a.act = act;
  a.dims = static_cast<unsigned int>(dims) & ((1u << kDims) - 1u);
  const int n_tiles = n_tiles_for(entries);
  a.ticket = reinterpret_cast<unsigned int*>(scratch);
  a.status = scratch + 1;
  a.values = scratch + 1 + n_tiles;
  a.out = out;
  round_accept_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
