// K4: the exact sequential greedy scan, one cluster of CTAs per call.
//
// Replaces the XLA scan of the JAX package's
//   koordinator_tpu/ops/assignment.py:169-280 _greedy_scan (no reservations)
// reached through greedy_assign (:283).  Its plain PyTorch version is
// greedy_assign_plain in ops/assignment.py, a Python loop over pods.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// dependent steps.  Each admitted pod is filtered and scored against the
// accounting its predecessors left, so step s cannot start before step s-1
// has charged its node and quota.  Per admitted step the work is N pairs of
// K1's Filter + Score (operations).
//
// Design: one cluster of 16 CTAs (a non-portable cluster size) walks the
// pods in priority order (the order comes from the wrapper, as
// priority_order computes it).  A step is one admitted pod; its critical
// path is the node scan, one exchange of ranks across the cluster, the
// charge and one CTA barrier.
// - Each CTA owns a contiguous range of ~N/16 nodes and keeps that range's
//   node state in shared memory, in columns (one row of the range per
//   resource dimension, so neighbouring threads read neighbouring words):
//   pair_score's node terms (koord_score.cuh) with the in-flight estimates
//   folded in: allocatable, free capacity, usage, the threshold's two
//   sides, the allocatable's magic divisors, flags and class.  A charge
//   updates three of them in place.
//   When the range does not fit shared memory (large N) the same columns
//   live in a global scratch buffer instead: still this kernel.
// - Every CTA keeps a replica of the quota state (headroom, min headroom,
//   checked, chain, valid) in shared memory and charges it identically, so
//   the replicas stay equal and admission needs no communication.
// - 20 warps score; a 21st, the control warp, admits and charges.  It
//   tests the next 32 valid pods in priority order against the current
//   headroom, one pod per lane (quota_admission_mask's predicate), and
//   jumps with __ballot_sync / __ffs to the first one admitted.  A pod
//   rejected there, like a pod no node takes, leaves every carried tensor
//   unchanged in the reference (assignment.py:254-265 add nothing unless
//   assigned), so it is skipped with no barrier.  The pods are staged in a
//   shared-memory window of 256 as the scan reaches them, a pod a lane: the
//   order, quota id, request, flags and the checked dims it requests (so
//   the test walks those dims alone, up its quota's chain, whose levels
//   the replica keeps compacted).  An admitted pod's estimate and word 0
//   of its selector row are loaded then, one value a lane (the launch
//   packs each row into W = ceil(C/64) words, pack_selector_words in
//   koord_score.cuh; the many-word instances read a wider row's other
//   words through L1 in the node scan).
// - Speculative admission: the control warp finds and loads the next pod
//   while the scanning warps score the current one (the pod's data is
//   double-buffered by step parity).  With non-negative requests a charge
//   only lowers the headroom, so a pod rejected before it stays rejected:
//   after the charge only the speculated pod is re-checked (a dimension a
//   lane), and the search resumes past it if the charge took its headroom.
//   A charge that raises a headroom (a negative request, or a headroom
//   wrapping past int32's minimum) is seen as it is made, and the search
//   then runs again from the charged pod on.
// - An admitted pod is scored by every CTA over its own nodes.  Each
//   scanning warp reduces its best (score, -node) rank and stores it into
//   every CTA of the cluster with asynchronous remote stores (st.async)
//   that complete on the receiver's mbarrier, a slot per (CTA, warp) and a
//   barrier per step parity; the control warp waits for the 320 ranks'
//   bytes and takes their maximum (jnp.argmax's lowest index on ties), the
//   same in every CTA.  No cluster barrier and no CTA barrier stand between
//   the scan and the charge.  A slot is written again two steps later,
//   after its reader has passed the CTA barrier of the step between.  The
//   CTA owning the node charges its columns; every CTA charges its quota
//   replica.  Node accounting and quota state are written back at the end.
//
// K4r, the same scan with reservations (kRsv), replaces the reservation
// branch of that scan,
//   koordinator_tpu/ops/reservation.py:252 reservation_greedy_assign
//   (reservation_fit :116, reservation_node_mask :150,
//   nominate_reservation :163, allocate_from_reservation :182),
// whose plain PyTorch version is greedy_scan_plain (ops/assignment.py).
// The wrapper hands it the placed reservation rows sorted by node (stable,
// so the rows of one node stay in ascending row order) as 23-int records
// (reserved, allocated, node, row, flags), and the (P, V) owner match with
// its columns in that order.  Each CTA owns the rows on its own nodes and
// keeps each node's first record (rfirst):
// - the thread that scores node i tests node i's records itself (match,
//   an unexhausted remainder, kept as a flag on the record, and on the
//   pod's nonzero dims the Aligned or Restricted fit against the remainder
//   and the node's free capacity); a record that fits passes the node's
//   fit and adds the boost to its score;
// - the control warp copies each next pod's match with the CTA's records
//   beside them when they are staged (into L1 when they stay in the
//   wrapper's array);
// - on the chosen node, the owning CTA's control warp re-tests the node's
//   records (the same records in the same order, so the same verdicts),
//   nominates the fitting one with the smallest total remainder (lowest
//   row on ties), draws the request from it (an allocate-once row is
//   consumed whole) and charges the node only the spill; the estimate and
//   the quota are charged the whole pod as in K4.
// A pod that quota rejects, or that no node takes, changes no reservation
// either, so K4's admission skip holds.  The rows live in shared memory
// beside the node columns when they fit there, else they stay in the
// wrapper's global array (the same records, updated in place).  The
// wrapper checks that every remainder is non-negative and sums below
// 2^31 - 1 and that no request is negative: the remainders then only
// shrink, and the nomination never meets the reference's INT32_MAX
// sentinel.

#include <cooperative_groups.h>

#include <type_traits>

#include "koord_score.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace koord;

constexpr int kCluster = 16;
constexpr int kScanWarps = 20;                   // warps scoring the nodes
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kThreads = kScanThreads + 32;      // and the control warp
constexpr int kRanks = kCluster * kScanWarps;    // ranks a CTA takes a step
constexpr int kWin = 256;           // pods staged per window
constexpr int kWinInts = 3 + kDims;  // ints per staged pod
constexpr unsigned kFull = 0xFFFFFFFFu;

// K4r's reservation row record: reserved (R), allocated (R), node, row in
// the reservation set, flags.  23 ints: an odd stride, so neighbouring
// threads' records fall in different shared-memory banks.
constexpr int kRsvInts = 2 * kDims + 3;
constexpr int kRsvNode = 2 * kDims;
constexpr int kRsvRow = 2 * kDims + 1;
constexpr int kRsvFlags = 2 * kDims + 2;
constexpr int kRsvOnce = 1;        // flags: allocate-once
constexpr int kRsvRestricted = 2;  // flags: Restricted policy
constexpr int kRsvLive = 4;        // flags: a remainder is left (the
                                   // kernel keeps it)

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of ``p``'s offset in CTA ``rank``.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// An asynchronous store of ``v`` into a peer's shared memory that
// completes 8 bytes of the transaction on the peer's mbarrier ``bar``.
__device__ __forceinline__ void st_async(uint32_t addr, long long v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of ``bar`` with parity ``parity`` to complete, the
// peers' stores into this CTA visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__host__ __device__ __forceinline__ int nodes_per_cta(int N) {
  return ((N + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// Where each piece of a CTA's state lies: ints first, then bytes.
struct Layout {
  int S;                 // nodes per CTA (a multiple of 4)
  long long quota_ints;  // headroom, min headroom (Q x R), chain (Q x QD,
                         // each row's levels first), levels (Q)
  long long win_ints;    // window: pod row, flags, quota id, request (R)
  long long node_ints;   // 6 x (R x S) columns, class and flags (S)
  long long row_ints;    // K4r: the CTA's reservation records, when staged
  long long range_ints;  // K4r: each node's first record (S + 1)
  long long quota_bytes; // checked (Q x R), valid (Q), padded to 4
  long long node_bytes;  // magic shifts (R x S)
  long long match_bytes; // K4r with staged records: the match of the pod
                         // of each step parity with them (2 x rows)

  // ``rsv``: K4r's layout; ``rows``: reservation records staged per CTA
  __host__ __device__ Layout(int N, int Q, int QD, bool rsv = false,
                             int rows = 0) {
    S = nodes_per_cta(N);
    quota_ints = 2ll * Q * kDims + static_cast<long long>(Q) * (QD + 1);
    win_ints = static_cast<long long>(kWin) * kWinInts;
    node_ints = (6ll * kDims + 2) * S;
    row_ints = static_cast<long long>(rows) * kRsvInts;
    range_ints = rsv ? S + 1 : 0;
    quota_bytes = (static_cast<long long>(Q) * (kDims + 1) + 3) / 4 * 4;
    node_bytes = static_cast<long long>(kDims) * S;
    match_bytes = rsv ? 2ll * rows : 0;
  }
  __host__ __device__ long long smem_bytes(bool nodes) const {
    return 4 * (quota_ints + win_ints + row_ints + range_ints +
                (nodes ? node_ints : 0)) +
           quota_bytes + (nodes ? node_bytes : 0) + match_bytes;
  }
  __host__ __device__ long long scratch_bytes() const {
    return 4 * node_ints + (node_bytes + 3) / 4 * 4;
  }
};

// quota_admission_mask for one pod: headroom at every level of its chain
// on ``need``, its checked dims with a request (bit r), the min headroom at
// its own quota when it is non-preemptible, and its quota row valid.  The
// chain's levels are the row's first ``levels`` entries (the replica keeps
// them compacted).  A pod without a quota (or a call without quota state)
// is admitted.
__device__ __forceinline__ bool quota_admits(
    const int* req, uint32_t need, int qid, bool np, bool has_quota,
    const int* head, const int* min_head, const int* chain,
    const int* levels, const uint8_t* qvalid, int QD) {
  if (!has_quota || qid < 0) return true;
  if (!qvalid[qid]) return false;
  for (uint32_t m = need; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int q = req[r];
    for (int d = 0; d < levels[qid]; ++d)
      if (q > head[chain[qid * QD + d] * kDims + r]) return false;
    if (np && q > min_head[qid * kDims + r]) return false;
  }
  return true;
}

// reservation_fit of one record against the pod's request: matched (the
// caller's test), an unexhausted remainder (the record's live flag), and
// on the pod's nonzero dims (``qnz``) the Aligned (request within
// remainder + free) or Restricted (reserved dims within the remainder, the
// others within free) fit on the record's node, whose free capacity is
// column i of ``n_free``.
__device__ __forceinline__ bool rsv_fits(const int* rec, const int* req,
                                         uint32_t qnz, const int* n_free,
                                         int S, int i) {
  const int flags = rec[kRsvFlags];
  if (!(flags & kRsvLive)) return false;
  const bool restricted = (flags & kRsvRestricted) != 0;
  for (uint32_t m = qnz; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int q = req[r];
    const int rem = wsub(rec[r], rec[kDims + r]);
    const int fr = n_free[r * S + i];
    if (restricted ? (rec[r] > 0 ? q > rem : q > fr) : q > wadd(rem, fr))
      return false;
  }
  return true;
}

// A record's live flag: some remainder above zero.
__device__ __forceinline__ int rsv_live(const int* rec) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < kDims; ++r) any = any || wsub(rec[r], rec[kDims + r]) > 0;
  return any ? kRsvLive : 0;
}

// K4r's arguments (all null / 0 for K4): the placed reservation rows
// sorted by node (V records, allocated updated in place), the records a
// CTA stages in shared memory (0: every CTA reads its records in place),
// the (P, V) match in record order, the score boost and the out
// reservation choice per pod.
struct RsvArgs {
  int* rows;
  int V;
  int staged;
  const uint8_t* match;
  int boost;
  int* out_rsv;
};

template <bool kNodesInSmem, bool kRsv, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1) greedy_scan_kernel(
    const int* __restrict__ alloc, int* reqd_g, const int* __restrict__ usage,
    const int* __restrict__ base, const uint8_t* __restrict__ nvalid,
    const int* __restrict__ nclass, unsigned char* scratch,
    const int* __restrict__ preq_g, const int* __restrict__ pest_g,
    const uint8_t* __restrict__ pvalid_g, const int* __restrict__ order,
    const unsigned long long* __restrict__ sel, int C, int W,
    const uint8_t* __restrict__ feas, const __grid_constant__ ScoreCfg cfg,
    int* q_head_g, int* q_min_g, const uint8_t* __restrict__ q_checked_g,
    const int* __restrict__ q_chain_g, const uint8_t* __restrict__ q_valid_g,
    int Q, int QD, const int* __restrict__ pquota,
    const uint8_t* __restrict__ pnp, int P, int N,
    int* __restrict__ out_assign, const __grid_constant__ RsvArgs ra) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a step's ranks from every scanning warp of the cluster, and the
  // barriers their stores complete on, one of each per step parity
  __shared__ long long s_rank[2][kRanks];
  __shared__ __align__(8) uint64_t s_bar[2];
  // the pod of each step parity: its request, estimate, scalars, selector
  // row, index (-1: the scan is over), quota id and non-preemptible flag
  __shared__ int s_req[2][kDims];
  __shared__ int s_est[2][kDims];
  __shared__ PodScalars s_ps[2];
  __shared__ SelRow s_sel[2];
  __shared__ int s_pod[2], s_qid[2], s_np[2];
  __shared__ int s_tmp[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const Layout L(N, Q, QD, kRsv, kRsv ? ra.staged : 0);
  const int S = L.S;
  const int lo = rank * S;
  const int cnt = max(0, min(N, lo + S) - lo);
  const bool has_quota = q_head_g != nullptr;

  int* head = reinterpret_cast<int*>(smem);
  int* min_head = head + Q * kDims;
  int* chain = min_head + Q * kDims;
  int* levels = chain + Q * QD;
  // the window: a staged pod's index, flags (bit 0 valid, bit 1
  // non-preemptible, bits 2.. its checked dims with a request), quota id
  // and request
  int* w_idx = levels + Q;
  int* w_flags = w_idx + kWin;
  int* w_qid = w_flags + kWin;
  int* w_req = w_qid + kWin;
  int* row_s = w_req + kWin * kDims;  // K4r's staged records
  int* rfirst = row_s + L.row_ints;    // K4r: each node's first record
  unsigned char* qbytes =
      smem + 4 * (L.quota_ints + L.win_ints + L.row_ints + L.range_ints +
                  (kNodesInSmem ? L.node_ints : 0));
  uint8_t* checked = qbytes;
  uint8_t* qvalid = qbytes + Q * kDims;
  // K4r with staged records: each step parity's pod's match with them
  uint8_t* s_match =
      qbytes + L.quota_bytes + (kNodesInSmem ? L.node_bytes : 0);
  int* node_i;
  unsigned char* node_b;
  if (kNodesInSmem) {
    node_i = rfirst + L.range_ints;
    node_b = qbytes + L.quota_bytes;
  } else {
    node_i = reinterpret_cast<int*>(scratch + rank * L.scratch_bytes());
    node_b = reinterpret_cast<unsigned char*>(node_i + L.node_ints);
  }
  int* n_alloc = node_i;
  int* n_free = n_alloc + kDims * S;
  int* n_use = n_free + kDims * S;
  int* n_thx = n_use + kDims * S;
  int* n_thy = n_thx + kDims * S;
  uint32_t* n_mag = reinterpret_cast<uint32_t*>(n_thy + kDims * S);
  int* n_cls = reinterpret_cast<int*>(n_mag + kDims * S);
  uint32_t* n_flags = reinterpret_cast<uint32_t*>(n_cls + S);
  uint8_t* n_shf = node_b;

  // stage this CTA's node columns as pair_score's node terms (in-flight
  // estimates start at zero) and the quota replica
  for (int i = tid; i < S; i += kThreads) {
    const bool in = i < cnt;
    const bool nv = in && nvalid[lo + i];
    const long long row = static_cast<long long>(in ? lo + i : 0) * kDims;
    uint32_t flags = nv ? kValidFlag : 0u;
    for (int r = 0; r < kDims; ++r) {
      const int a = in ? alloc[row + r] : 0;
      const DimTerms t = node_dim_terms(a, in ? reqd_g[row + r] : 0,
                                        in ? base[row + r] : 0, nv,
                                        cfg.thr[r]);
      n_alloc[r * S + i] = a;
      n_free[r * S + i] = t.fr;
      n_use[r * S + i] = in ? usage[row + r] : 0;
      n_thx[r * S + i] = t.thx;
      n_thy[r * S + i] = t.thy;
      n_mag[r * S + i] = t.mg.m;
      n_shf[r * S + i] = static_cast<uint8_t>(t.mg.l);
      if (a > 0) flags |= 1u << r;
    }
    n_flags[i] = flags;
    n_cls[i] = in ? nclass[lo + i] : 0;
  }
  if (has_quota) {
    for (int i = tid; i < Q * kDims; i += kThreads) {
      head[i] = q_head_g[i];
      min_head[i] = q_min_g[i];
      checked[i] = q_checked_g[i];
    }
    // each row's levels (the chain's entries >= 0), compacted to the front
    for (int q = tid; q < Q; q += kThreads) {
      int n = 0;
      for (int d = 0; d < QD; ++d) {
        const int anc = q_chain_g[q * QD + d];
        if (anc >= 0) chain[q * QD + n++] = anc;
      }
      levels[q] = n;
      qvalid[q] = q_valid_g[q];
    }
  }
  // K4r: this CTA's records, [r_lo, r_lo + vc) of the sorted rows (the
  // rows on nodes [lo, lo + S)), staged in shared memory or read in place,
  // each one's live flag, and each node's first record (rfirst[i],
  // rfirst[S] = vc)
  int r_lo = 0, vc = 0;
  int* rw = nullptr;
  if constexpr (kRsv) {
    if (tid < 2) {
      const int key = lo + tid * S;
      int a = 0, b = ra.V;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (ra.rows[static_cast<long long>(m) * kRsvInts + kRsvNode] < key)
          a = m + 1;
        else
          b = m;
      }
      s_tmp[tid] = a;
    }
    __syncthreads();
    r_lo = s_tmp[0];
    vc = s_tmp[1] - r_lo;
    int* src = ra.rows + static_cast<long long>(r_lo) * kRsvInts;
    if (ra.staged > 0) {
      for (int i = tid; i < vc * kRsvInts; i += kThreads) row_s[i] = src[i];
      rw = row_s;
      __syncthreads();
    } else {
      rw = src;
    }
    for (int j = tid; j < vc; j += kThreads) {
      int* rec = rw + j * kRsvInts;
      rec[kRsvFlags] = (rec[kRsvFlags] & ~kRsvLive) | rsv_live(rec);
    }
    for (int i = tid; i <= S; i += kThreads) {
      int a = 0, b = vc;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (rw[m * kRsvInts + kRsvNode] < lo + i)
          a = m + 1;
        else
          b = m;
      }
      rfirst[i] = a;
    }
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&s_bar[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every CTA's barriers are set before a peer stores

  // The control warp (the last) admits pods and charges; the others score.
  // Its window of staged pods [win_lo, win_hi) and the position the next
  // search starts from.
  const bool ctl = wid == kScanWarps;
  int cursor = 0, win_lo = 0, win_hi = 0, next = 0;
  // the next pod's request (lane r: dimension r), checked dims with a
  // request, quota id and flag, for the re-check
  int c_req = 0, c_need = 0, c_qid = -1, c_np = 0;

  // the first position at or after ``from`` whose pod the current headroom
  // admits (valid, quota_admits), a warp of pods at a time; -1 when none.
  // Each window is staged as the search reaches it, a pod a lane; a search
  // that starts behind the window (again from the charged pod, after the
  // speculated one moved the window past it) stages it anew there.
  auto find = [&](int from) -> int {
    cursor = from;
    while (cursor < P) {
      if (cursor < win_lo || cursor >= win_hi) {
        win_lo = cursor;
        win_hi = min(P, cursor + kWin);
        for (int i = lane; i < win_hi - win_lo; i += 32) {
          const int id = order[win_lo + i];
          const int qid = pquota != nullptr ? pquota[id] : -1;
          const long long row = static_cast<long long>(id) * kDims;
          uint32_t need = 0;
#pragma unroll
          for (int r = 0; r < kDims; ++r) {
            const int q = preq_g[row + r];
            w_req[i * kDims + r] = q;
            if (has_quota && qid >= 0 && q != 0 && checked[qid * kDims + r])
              need |= 1u << r;
          }
          w_idx[i] = id;
          w_qid[i] = qid;
          w_flags[i] = (pvalid_g[id] ? 1 : 0) |
                       ((pnp != nullptr && pnp[id]) ? 2 : 0) |
                       static_cast<int>(need << 2);
        }
        __syncwarp();
      }
      const int pos = cursor + lane;
      bool admit = false;
      if (pos < win_hi) {
        const int i = pos - win_lo;
        const int flags = w_flags[i];
        admit = (flags & 1) &&
                quota_admits(w_req + i * kDims, flags >> 2, w_qid[i],
                             flags & 2, has_quota, head, min_head, chain,
                             levels, qvalid, QD);
      }
      const unsigned ballot = __ballot_sync(kFull, admit);
      if (ballot != 0) return cursor + __ffs(ballot) - 1;
      cursor = min(cursor + 32, win_hi);
    }
    return -1;
  };
  // the pod at window position ``pos`` into buffer ``b``: its request,
  // estimate and selector word 0 (one load a lane), quota id, flag and
  // scalars; returns its index.
  auto load = [&](int pos, int b) -> int {
    const int i = pos - win_lo;
    const int idx = w_idx[i];
    const int flags = w_flags[i];
    c_req = lane < kDims ? w_req[i * kDims + lane] : 0;
    c_need = flags >> 2;
    c_qid = w_qid[i];
    c_np = (flags >> 1) & 1;
    if (lane < kDims) {
      s_req[b][lane] = c_req;
      s_est[b][lane] = pest_g[static_cast<long long>(idx) * kDims + lane];
    }
    if (lane == kDims && sel != nullptr)
      s_sel[b] = SelRow::of(sel, idx, W, true);
    if constexpr (kRsv) {
      // its match with this CTA's records: copied beside them when they
      // are staged, else brought into L1
      const uint8_t* m = ra.match + static_cast<long long>(idx) * ra.V + r_lo;
      if (ra.staged > 0) {
        for (int j = lane; j < vc; j += 32) s_match[b * ra.staged + j] = m[j];
      } else {
        const uintptr_t a0 =
            reinterpret_cast<uintptr_t>(m) & ~uintptr_t{127};
        const uintptr_t a1 = reinterpret_cast<uintptr_t>(m + vc);
        for (uintptr_t a = a0 + 128u * lane; a < a1; a += 32u * 128u)
          asm volatile("prefetch.L1 [%0];\n" ::"l"(a));
      }
    }
    __syncwarp();
    if (lane == 0) {
      s_qid[b] = c_qid;
      s_np[b] = c_np;
      s_ps[b] = pod_scalars(s_req[b], cfg);
    }
    return idx;
  };
  // the next pod's quota_admits against the current headroom, a dimension
  // a lane
  auto admits = [&]() -> bool {
    bool ok = true;
    if (has_quota && c_qid >= 0) {
      ok = qvalid[c_qid] != 0;
      if ((c_need >> lane) & 1) {
        for (int d = 0; d < levels[c_qid]; ++d)
          if (c_req > head[chain[c_qid * QD + d] * kDims + lane]) ok = false;
        if (c_np && c_req > min_head[c_qid * kDims + lane]) ok = false;
      }
    }
    return __all_sync(kFull, ok);
  };

  if (ctl) {
    const int pos = find(0);
    const int idx = pos >= 0 ? load(pos, 0) : -1;
    next = pos + 1;
    if (lane == 0) s_pod[0] = idx;
  }
  __syncthreads();

  for (int step = 0;; ++step) {
    const int b = step & 1;
    const int idx = s_pod[b];
    if (idx < 0) break;
    if (!ctl) {
      // this warp's best (score, -node) rank over its nodes, stored into
      // every CTA of the cluster
      const SelRow sr = s_sel[b];
      const PodRef pod{s_req[b], s_est[b], 1, s_ps[b]};
      const uint8_t* mrow =
          !kRsv ? nullptr
          : ra.staged > 0
              ? s_match + b * ra.staged
              : ra.match + static_cast<long long>(idx) * ra.V + r_lo;
      long long best = LLONG_MIN;
      for (int i = tid; i < cnt; i += kScanThreads) {
        bool via = false;
        if constexpr (kRsv) {
          // reservation_node_mask: a matched record on this node fits
          for (int j = rfirst[i]; j < rfirst[i + 1] && !via; ++j)
            via = mrow[j] != 0 && rsv_fits(rw + j * kRsvInts, s_req[b],
                                           pod.s.qnz, n_free, S, i);
        }
        const int n = lo + i;
        const ColumnRow nr{n_alloc + i, n_shf + i, S, n_flags[i]};
        const bool nv = (nr.flags & kValidFlag) != 0;
        bool ok;
        int score;
        if constexpr (kRsv) {
          score = pair_score(nr, pod, cfg, ok, via);
          if (via) score = wadd(score, ra.boost);
        } else {
          score = pair_score(nr, pod, cfg, ok);
        }
        bool fe = ok && nv;
        if (sel != nullptr) {
          fe = fe && sr.template ok<kMulti>(n_cls[i], C);
        } else {
          fe = fe && feas[static_cast<long long>(idx) * N + n];
        }
        best = max(best, rank_of(fe ? score : -1, n));
      }
      best = warp_max(best);
      if (lane < kCluster)
        st_async(peer_addr(&s_rank[b][rank * kScanWarps + wid], lane), best,
                 peer_addr(&s_bar[b], lane));
    } else {
      if (lane == 0) mbar_expect_tx(&s_bar[b], kRanks * 8);
      // speculative admission: while the step's pod is scored, the next
      // pod the current headroom admits (a charge that only lowers the
      // headroom leaves a pod rejected now rejected after it)
      int pos = find(next);
      int nidx = pos >= 0 ? load(pos, b ^ 1) : -1;
      mbar_wait(&s_bar[b], static_cast<uint32_t>((step >> 1) & 1));
      long long best = LLONG_MIN;
      for (int j = lane; j < kRanks; j += 32) best = max(best, s_rank[b][j]);
      best = warp_max(best);
      const bool placed = static_cast<int>(best >> 32) >= 0;
      const int qid = s_qid[b];
      bool rose = false;  // the charge raised a headroom
      if (placed) {
        const int node = 0x7FFFFFFF - static_cast<int>(best & 0xFFFFFFFFll);
        const int i = node - lo;
        if (i >= 0 && i < cnt) {
          int charge = lane < kDims ? s_req[b][lane] : 0;
          if constexpr (kRsv) {
            // nominate_reservation: the fitting record on the node with
            // the smallest total remainder, the lowest row on ties (the
            // node's records are in row order), re-tested as the scan did
            const uint8_t* mrow =
                ra.staged > 0
                    ? s_match + b * ra.staged
                    : ra.match + static_cast<long long>(idx) * ra.V + r_lo;
            long long key = LLONG_MAX;
            for (int j = rfirst[i] + lane; j < rfirst[i + 1]; j += 32) {
              const int* rec = rw + j * kRsvInts;
              if (mrow[j] &&
                  rsv_fits(rec, s_req[b], s_ps[b].qnz, n_free, S, i)) {
                int total = 0;
#pragma unroll
                for (int r = 0; r < kDims; ++r)
                  total = wadd(total, wsub(rec[r], rec[kDims + r]));
                key = min(key, (static_cast<long long>(total) << 32) |
                                   static_cast<unsigned int>(j));
              }
            }
            key = warp_min(key);
            // allocate_from_reservation: draw min(request, remainder) per
            // dim, charge the node the spill
            if (key != LLONG_MAX) {
              int* rec = rw + static_cast<int>(key & 0xFFFFFFFFll) * kRsvInts;
              const int flags = rec[kRsvFlags];
              bool live = false;
              if (lane < kDims) {
                const int rem = wsub(rec[lane], rec[kDims + lane]);
                const int take = min(charge, rem);
                const int alloc_r = (flags & kRsvOnce)
                                        ? rec[lane]
                                        : wadd(rec[kDims + lane], take);
                rec[kDims + lane] = alloc_r;
                live = wsub(rec[lane], alloc_r) > 0;
                charge = wsub(charge, take);
              }
              live = __any_sync(kFull, live);
              if (lane == 0) {
                rec[kRsvFlags] =
                    live ? (flags | kRsvLive) : (flags & ~kRsvLive);
                ra.out_rsv[idx] = rec[kRsvRow];
              }
            }
          }
          if (lane < kDims) {
            // requested += the charge, the in-flight estimate += est: the
            // free capacity falls by the charge, the usage and the
            // threshold's left side rise by est and 100 * est
            const int o = lane * S + i;
            n_free[o] = wsub(n_free[o], charge);
            n_use[o] = wadd(n_use[o], s_est[b][lane]);
            n_thx[o] = wadd(n_thx[o], wmul(kMaxScore, s_est[b][lane]));
          }
          if (lane == 0) out_assign[idx] = node;
        }
        if (has_quota && qid >= 0 && qvalid[qid] && lane < kDims) {
          // (a negative request, or a headroom wrapping past int32's
          // minimum, raises it)
          const int q = s_req[b][lane];
          for (int d = 0; d < levels[qid]; ++d) {
            int* h = head + chain[qid * QD + d] * kDims + lane;
            const int was = *h;
            *h = wsub(was, q);
            rose = rose || *h > was;
          }
          if (s_np[b]) {
            int* h = min_head + qid * kDims + lane;
            const int was = *h;
            *h = wsub(was, q);
            rose = rose || *h > was;
          }
        }
      }
      rose = __any_sync(kFull, rose);
      const bool charged = placed && has_quota && qid >= 0 && qvalid[qid];
      if (rose) {
        // a pod rejected before the charge may be admitted now: search
        // again from the step's pod on
        pos = find(next);
        nidx = pos >= 0 ? load(pos, b ^ 1) : -1;
      } else if (charged && pos >= 0 && !admits()) {
        // the charge took the headroom the speculated pod needed: resume
        // the scan past it
        pos = find(pos + 1);
        nidx = pos >= 0 ? load(pos, b ^ 1) : -1;
      }
      if (pos >= 0) next = pos + 1;
      if (lane == 0) s_pod[b ^ 1] = nidx;
    }
    __syncthreads();
  }

  // write back this CTA's node accounting (requested = a - free on the
  // valid nodes, the only ones charged), and (once) the quota state
  for (int i = tid; i < cnt; i += kThreads) {
    if (!(n_flags[i] & kValidFlag)) continue;
    const long long row = static_cast<long long>(lo + i) * kDims;
    for (int r = 0; r < kDims; ++r)
      reqd_g[row + r] = wsub(n_alloc[r * S + i], n_free[r * S + i]);
  }
  if (has_quota && rank == 0) {
    for (int i = tid; i < Q * kDims; i += kThreads) {
      q_head_g[i] = head[i];
      q_min_g[i] = min_head[i];
    }
  }
  if constexpr (kRsv) {
    if (ra.staged > 0) {
      int* dst = ra.rows + static_cast<long long>(r_lo) * kRsvInts;
      for (int j = tid; j < vc; j += kThreads)
        for (int r = 0; r < kDims; ++r)
          dst[j * kRsvInts + kDims + r] = row_s[j * kRsvInts + kDims + r];
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still store into it
}

template <bool kNodesInSmem, bool kRsv, bool kMulti>
cudaError_t launch(long long smem, cudaStream_t st, const int* alloc,
                   int* reqd, const int* usage, const int* base,
                   const uint8_t* nvalid, const int* nclass,
                   unsigned char* scratch, const int* preq, const int* pest,
                   const uint8_t* pvalid, const int* order,
                   const unsigned long long* sel, int C, int W,
                   const uint8_t* feas,
                   const ScoreCfg& cfg, int* q_head, int* q_min,
                   const uint8_t* q_checked, const int* q_chain,
                   const uint8_t* q_valid, int Q, int QD, const int* pquota,
                   const uint8_t* pnp, int P, int N,
                   int* out_assign, const RsvArgs& ra) {
  auto kernel = greedy_scan_kernel<kNodesInSmem, kRsv, kMulti>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(kCluster);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(smem);
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return cudaLaunchKernelEx(&lc, kernel, alloc, reqd, usage, base, nvalid,
                            nclass, scratch, preq, pest, pvalid, order, sel,
                            C, W, feas, cfg, q_head, q_min, q_checked, q_chain,
                            q_valid, Q, QD, pquota, pnp, P, N,
                            out_assign, ra);
}

// The dynamic shared memory a CTA may take: the card's opt-in limit less
// the kernel's static shared memory.
template <bool kRsv>
cudaError_t smem_room(long long* room) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, greedy_scan_kernel<true, kRsv, false>);
  if (err == cudaSuccess)
    *room = optin - static_cast<long long>(fa.sharedSizeBytes);
  return err;
}

// Where a scan's state lies: the node columns in shared memory or in the
// global scratch; K4r's records staged in shared memory (``staged`` slots
// a CTA) or read in place.
struct Plan {
  bool nodes_in_smem;
  int staged;
  long long smem;
};

template <bool kRsv>
cudaError_t plan_for(int N, int Q, int QD, int vmax, Plan* plan) {
  long long room = 0;
  cudaError_t err = smem_room<kRsv>(&room);
  if (err != cudaSuccess) return err;
  plan->nodes_in_smem = Layout(N, Q, QD, kRsv).smem_bytes(true) <= room;
  plan->staged = 0;
  if (kRsv && vmax > 0 &&
      Layout(N, Q, QD, true, vmax).smem_bytes(plan->nodes_in_smem) <= room)
    plan->staged = vmax;
  plan->smem =
      Layout(N, Q, QD, kRsv, plan->staged).smem_bytes(plan->nodes_in_smem);
  return cudaSuccess;
}

template <bool kRsv>
int scan(const int* alloc, int* reqd, const int* usage, const int* base,
         const uint8_t* nvalid, const int* nclass, unsigned char* scratch,
         const int* preq, const int* pest, const uint8_t* pvalid,
         const int* order, const uint8_t* sel_mask, int C,
         unsigned long long* sel, const uint8_t* feas, const int* cfg,
         int cfg_len, int* q_head, int* q_min,
         const uint8_t* q_checked, const int* q_chain, const uint8_t* q_valid,
         int Q, int QD, const int* pquota, const uint8_t* pnp,
         int P, int N, int* out_assign, const RsvArgs& ra,
         int vmax, void* stream) {
  if (cfg_len != kCfgLen || cfg == nullptr || N < 1 ||
      (sel_mask == nullptr) == (feas == nullptr) ||
      (sel_mask != nullptr && (C < 1 || sel == nullptr)) ||
      (q_head != nullptr && (Q < 1 || QD < 1)) ||
      (kRsv && (ra.V < 0 || vmax < 0 || vmax > ra.V || ra.out_rsv == nullptr ||
                (ra.V > 0 && (ra.rows == nullptr || ra.match == nullptr))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q_head == nullptr) Q = QD = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScoreCfg sc;
  load_score_cfg(sc, cfg);
  Plan plan;
  cudaError_t err = plan_for<kRsv>(N, Q, QD, vmax, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  RsvArgs args = ra;
  args.staged = plan.staged;
  const int W = sel_mask != nullptr ? (C + 63) / 64 : 1;
  if (sel_mask != nullptr) {
    err = pack_selector(sel_mask, P, C, sel, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    sel = nullptr;
  }
  // the instance: node columns in shared memory or not, selector words
  auto go = [&](auto in_smem, auto km) {
    return launch<decltype(in_smem)::value, kRsv, decltype(km)::value>(
        plan.smem, st, alloc, reqd, usage, base, nvalid, nclass, scratch,
        preq, pest, pvalid, order, sel, C, W, feas, sc, q_head, q_min,
        q_checked, q_chain, q_valid, Q, QD, pquota, pnp, P, N,
        out_assign, args);
  };
  auto by_words = [&](auto in_smem) {
    return W > 1 ? go(in_smem, std::true_type{})
                 : go(in_smem, std::false_type{});
  };
  if (plan.nodes_in_smem) {
    err = by_words(std::true_type{});
  } else if (scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // the quota replica and the window must fit; the node columns stream
    // from the global scratch
    err = by_words(std::false_type{});
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRsv>
long long scratch_bytes(int N, int Q, int QD) {
  Plan plan;
  if (plan_for<kRsv>(N, Q, QD, 0, &plan) != cudaSuccess) return -1;
  return plan.nodes_in_smem
             ? 0
             : kCluster * Layout(N, Q, QD, kRsv).scratch_bytes();
}

}  // namespace

// Bytes of the global scratch koord_greedy_scan needs: the node columns of
// every CTA when they do not fit its shared memory beside the quota
// replica, else 0 (the scratch may then be null).  -1 when the card cannot
// be asked.
extern "C" long long koord_greedy_scan_scratch_bytes(int N, int Q, int QD) {
  return scratch_bytes<false>(N, Q, QD);
}

extern "C" int koord_greedy_scan(
    const int* alloc, int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, unsigned char* scratch,
    const int* preq, const int* pest, const uint8_t* pvalid,
    const int* order, const uint8_t* sel, int C, unsigned long long* words,
    const uint8_t* feas,
    const int* cfg, int cfg_len, int* q_head, int* q_min,
    const uint8_t* q_checked, const int* q_chain, const uint8_t* q_valid,
    int Q, int QD, const int* pquota, const uint8_t* pnp, int P, int N,
    int* out_assign, void* stream) {
  const RsvArgs none = {nullptr, 0, 0, nullptr, 0, nullptr};
  return scan<false>(alloc, reqd, usage, base, nvalid, nclass, scratch, preq,
                     pest, pvalid, order, sel, C, words, feas, cfg, cfg_len,
                     q_head, q_min, q_checked, q_chain, q_valid, Q, QD,
                     pquota, pnp, P, N, out_assign, none, 0, stream);
}

// K4r's nodes per CTA (its records are grouped by the CTA owning their
// node: node // this) and its global scratch, as for K4.
extern "C" long long koord_reservation_scan_nodes_per_cta(int N) {
  return nodes_per_cta(N);
}

extern "C" long long koord_reservation_scan_scratch_bytes(int N, int Q,
                                                          int QD) {
  return scratch_bytes<true>(N, Q, QD);
}

// Where a K4r launch keeps its state: bit 0 set when the node columns are
// in shared memory, bit 1 when the records are staged there (``vmax``
// records a CTA); -1 when the card cannot be asked.
extern "C" long long koord_reservation_scan_plan(int N, int Q, int QD,
                                                 int vmax) {
  Plan plan;
  if (plan_for<true>(N, Q, QD, vmax, &plan) != cudaSuccess) return -1;
  return (plan.nodes_in_smem ? 1 : 0) | (plan.staged > 0 ? 2 : 0);
}

// K4r: the scan of koord_greedy_scan with reservations.  ``rows`` holds the
// V placed reservation records sorted by node (kRsvInts ints each; the
// allocated columns are updated in place), ``vmax`` the most records on
// one CTA's nodes, ``match`` the (P, V) owner match in record order;
// ``out_rsv`` (P,) gets each placed pod's reservation row (it holds -1 on
// entry).
extern "C" int koord_reservation_scan(
    const int* alloc, int* reqd, const int* usage, const int* base,
    const uint8_t* nvalid, const int* nclass, unsigned char* scratch,
    const int* preq, const int* pest, const uint8_t* pvalid,
    const int* order, const uint8_t* sel, int C, unsigned long long* words,
    const uint8_t* feas,
    const int* cfg, int cfg_len, int* q_head, int* q_min,
    const uint8_t* q_checked, const int* q_chain, const uint8_t* q_valid,
    int Q, int QD, const int* pquota, const uint8_t* pnp, int P, int N,
    int* rows, int V, int vmax, const uint8_t* match, int boost,
    int* out_assign, int* out_rsv, void* stream) {
  const RsvArgs ra = {rows, V, 0, match, boost, out_rsv};
  return scan<true>(alloc, reqd, usage, base, nvalid, nclass, scratch, preq,
                    pest, pvalid, order, sel, C, words, feas, cfg, cfg_len,
                    q_head, q_min, q_checked, q_chain, q_valid, Q, QD, pquota,
                    pnp, P, N, out_assign, ra, vmax, stream);
}
