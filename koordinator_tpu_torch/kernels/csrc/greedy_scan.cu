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
// priority_order computes it).
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
// - Admission a warp at a time: warp 0 tests the next 32 valid pods in
//   priority order against the current headroom, one pod per lane
//   (quota_admission_mask's predicate), and jumps with __ballot_sync /
//   __ffs to the first one admitted.  A pod rejected there, like a pod no
//   node takes, leaves every carried tensor unchanged in the reference
//   (assignment.py:254-265 add nothing unless assigned), so it is skipped
//   with no barrier.  The pod order, quota ids, flags and requests are
//   staged in a shared-memory window of 256 pods as the scan reaches them;
//   an admitted pod's estimate and word 0 of its selector row are loaded
//   then, one value a lane (the launch packs each row into W = ceil(C/64)
//   words, pack_selector_words in koord_score.cuh; the many-word instances
//   read a wider row's other words through L1 in the node scan).
// - An admitted pod is scored by every CTA over its own nodes; each CTA
//   reduces its best (score, -node) rank, the 16 ranks meet through
//   distributed shared memory after one cluster barrier, and every CTA
//   takes the same maximum (jnp.argmax's lowest index on ties).  The CTA
//   owning the node charges its columns; every CTA charges its quota
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
// its columns in that order.  Each CTA owns the rows on its own nodes:
// - per admitted pod, its threads test its rows (match, an unexhausted
//   remainder, the Aligned or Restricted fit against the remainder and
//   the node's free capacity) and set a shared-memory flag on each node a
//   fitting row sits on; the node scan ORs the flag into the fit and adds
//   the boost to the score; the flags are cleared before the next pod;
// - on the chosen node, the owning CTA's warp 0 nominates the fitting row
//   with the smallest total remainder (lowest row on ties), draws the
//   request from it (an allocate-once row is consumed whole) and charges
//   the node only the spill; the estimate and the quota are charged the
//   whole pod as in K4.
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
constexpr int kThreads = 640;
constexpr int kWarps = kThreads / 32;
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
constexpr int kRsvFit = 4;         // flags: fits the current pod

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int nodes_per_cta(int N) {
  return ((N + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// Where each piece of a CTA's state lies: ints first, then bytes.
struct Layout {
  int S;                 // nodes per CTA (a multiple of 4)
  long long quota_ints;  // headroom, min headroom (Q x R), chain (Q x QD)
  long long win_ints;    // window: pod row, flags, quota id, request (R)
  long long node_ints;   // 6 x (R x S) columns, class and flags (S)
  long long row_ints;    // K4r: the CTA's reservation records, when staged
  long long quota_bytes; // checked (Q x R), valid (Q), padded to 4
  long long node_bytes;  // magic shifts (R x S)
  long long boost_bytes; // K4r: a reservation flag per node (S)

  // ``rsv``: K4r's layout; ``rows``: reservation records staged per CTA
  __host__ __device__ Layout(int N, int Q, int QD, bool rsv = false,
                             int rows = 0) {
    S = nodes_per_cta(N);
    quota_ints = 2ll * Q * kDims + static_cast<long long>(Q) * QD;
    win_ints = static_cast<long long>(kWin) * kWinInts;
    node_ints = (6ll * kDims + 2) * S;
    row_ints = static_cast<long long>(rows) * kRsvInts;
    quota_bytes = (static_cast<long long>(Q) * (kDims + 1) + 3) / 4 * 4;
    node_bytes = static_cast<long long>(kDims) * S;
    boost_bytes = rsv ? S : 0;
  }
  __host__ __device__ long long smem_bytes(bool nodes) const {
    return 4 * (quota_ints + win_ints + row_ints + (nodes ? node_ints : 0)) +
           quota_bytes + (nodes ? node_bytes : 0) + boost_bytes;
  }
  __host__ __device__ long long scratch_bytes() const {
    return 4 * node_ints + (node_bytes + 3) / 4 * 4;
  }
};

// quota_admission_mask for one pod: headroom at every level of its chain
// on its checked, requested dims, the min headroom at its own quota when
// it is non-preemptible, and its quota row valid.  A pod without a quota
// (or a call without quota state) is admitted.
__device__ __forceinline__ bool quota_admits(
    const int* req, int qid, bool np, bool has_quota, const int* head,
    const int* min_head, const uint8_t* checked, const int* chain,
    const uint8_t* qvalid, int QD) {
  if (!has_quota || qid < 0) return true;
  bool ok = qvalid[qid] != 0;
  for (int r = 0; r < kDims; ++r) {
    const int q = req[r];
    if (q == 0 || !checked[qid * kDims + r]) continue;
    for (int d = 0; d < QD; ++d) {
      const int anc = chain[qid * QD + d];
      if (anc >= 0 && q > head[anc * kDims + r]) ok = false;
    }
    if (np && q > min_head[qid * kDims + r]) ok = false;
  }
  return ok;
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
  __shared__ long long s_best[2];
  __shared__ long long s_warp[kWarps];
  __shared__ int s_req[kDims];
  __shared__ int s_est[kDims];
  __shared__ PodScalars s_ps;
  __shared__ SelRow s_sel;
  __shared__ int s_pod, s_qid, s_np;

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
  int* w_idx = chain + Q * QD;
  int* w_flags = w_idx + kWin;
  int* w_qid = w_flags + kWin;
  int* w_req = w_qid + kWin;
  int* row_s = w_req + kWin * kDims;  // K4r's staged records
  unsigned char* qbytes =
      smem + 4 * (L.quota_ints + L.win_ints + L.row_ints +
                  (kNodesInSmem ? L.node_ints : 0));
  uint8_t* checked = qbytes;
  uint8_t* qvalid = qbytes + Q * kDims;
  uint8_t* boost_at = qbytes + L.quota_bytes +
                      (kNodesInSmem ? L.node_bytes : 0);
  int* node_i;
  unsigned char* node_b;
  if (kNodesInSmem) {
    node_i = row_s + L.row_ints;
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
    for (int i = tid; i < Q * QD; i += kThreads) chain[i] = q_chain_g[i];
    for (int i = tid; i < Q; i += kThreads) qvalid[i] = q_valid_g[i];
  }
  // K4r: this CTA's records, [r_lo, r_hi) of the sorted rows (the rows on
  // nodes [lo, lo + S)), staged in shared memory or read in place
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
      s_warp[tid] = a;  // free until the first pod's reduction
    }
    for (int i = tid; i < S; i += kThreads) boost_at[i] = 0;
    __syncthreads();
    r_lo = static_cast<int>(s_warp[0]);
    vc = static_cast<int>(s_warp[1]) - r_lo;
    int* src = ra.rows + static_cast<long long>(r_lo) * kRsvInts;
    if (ra.staged > 0) {
      for (int i = tid; i < vc * kRsvInts; i += kThreads) row_s[i] = src[i];
      rw = row_s;
    } else {
      rw = src;
    }
  }
  __syncthreads();
  cluster.sync();  // every CTA runs before any reads a peer's s_best

  // warp 0's scan position and staged window [win_lo, win_hi)
  int cursor = 0, win_lo = 0, win_hi = 0;
  int parity = 0;
  for (;;) {
    if (wid == 0) {
      int found = -1;
      while (cursor < P) {
        if (cursor >= win_hi) {
          win_lo = cursor;
          win_hi = min(P, cursor + kWin);
          for (int i = lane; i < win_hi - win_lo; i += 32) {
            const int id = order[win_lo + i];
            w_idx[i] = id;
            w_flags[i] = (pvalid_g[id] ? 1 : 0) |
                         ((pnp != nullptr && pnp[id]) ? 2 : 0);
            w_qid[i] = pquota != nullptr ? pquota[id] : -1;
            const long long row = static_cast<long long>(id) * kDims;
#pragma unroll
            for (int r = 0; r < kDims; ++r)
              w_req[i * kDims + r] = preq_g[row + r];
          }
          __syncwarp();
        }
        const int pos = cursor + lane;
        bool admit = false;
        if (pos < win_hi) {
          const int i = pos - win_lo;
          const int flags = w_flags[i];
          admit = (flags & 1) &&
                  quota_admits(w_req + i * kDims, w_qid[i], flags & 2,
                               has_quota, head, min_head, checked, chain,
                               qvalid, QD);
        }
        const unsigned ballot = __ballot_sync(kFull, admit);
        if (ballot != 0) {
          found = cursor + __ffs(ballot) - 1;
          break;
        }
        cursor = min(cursor + 32, win_hi);
      }
      if (found >= 0) {
        const int i = found - win_lo;
        const int idx = w_idx[i];
        // the admitted pod's estimate and selector word 0, one load a lane
        if (lane < kDims) {
          s_req[lane] = w_req[i * kDims + lane];
          s_est[lane] = pest_g[static_cast<long long>(idx) * kDims + lane];
        }
        if (lane == kDims && sel != nullptr)
          s_sel = SelRow::of(sel, idx, W, true);
        __syncwarp();
        if (lane == 0) {
          s_pod = idx;
          s_qid = w_qid[i];
          s_np = (w_flags[i] >> 1) & 1;
          s_ps = pod_scalars(s_req, cfg);
        }
        cursor = found + 1;
      } else if (lane == 0) {
        s_pod = -1;
      }
    }
    __syncthreads();
    const int idx = s_pod;
    if (idx < 0) break;

    if constexpr (kRsv) {
      // reservation_fit over this CTA's rows, and the node flags
      // (reservation_node_mask) of the rows that fit
      const uint8_t* mrow =
          ra.match + static_cast<long long>(idx) * ra.V + r_lo;
      for (int j = tid; j < vc; j += kThreads) {
        int* rec = rw + j * kRsvInts;
        const int flags = rec[kRsvFlags];
        bool ok = mrow[j] != 0;
        const int i = rec[kRsvNode] - lo;
        if (ok) {
          bool any_rem = false, aligned = true, restricted = true;
#pragma unroll
          for (int r = 0; r < kDims; ++r) {
            const int rem = wsub(rec[r], rec[kDims + r]);
            any_rem = any_rem || rem > 0;
            const int q = s_req[r];
            if (q != 0) {
              const int fr = n_free[r * S + i];
              aligned = aligned && q <= wadd(rem, fr);
              restricted = restricted && (rec[r] > 0 ? q <= rem : q <= fr);
            }
          }
          ok = any_rem && ((flags & kRsvRestricted) ? restricted : aligned);
        }
        rec[kRsvFlags] = ok ? (flags | kRsvFit) : (flags & ~kRsvFit);
        if (ok) boost_at[i] = 1;
      }
      __syncthreads();
    }

    // this CTA's best (score, -node) rank over its nodes
    const SelRow sr = s_sel;
    const PodRef pod{s_req, s_est, 1, s_ps};
    long long best = LLONG_MIN;
    for (int i = tid; i < cnt; i += kThreads) {
      const int n = lo + i;
      const StridedRow nr{n_alloc + i, n_free + i, n_use + i, n_thx + i,
                          n_thy + i,   n_mag + i,  n_shf + i, S,
                          n_flags[i]};
      const bool nv = (nr.flags & kValidFlag) != 0;
      bool ok;
      int score;
      if constexpr (kRsv) {
        const bool via = boost_at[i] != 0;
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
    if (lane == 0) s_warp[wid] = best;
    __syncthreads();
    if (wid == 0) {
      best = warp_max(lane < kWarps ? s_warp[lane] : LLONG_MIN);
      if (lane == 0) s_best[parity] = best;
    }
    if constexpr (kRsv) {
      // every thread is past the node scan: clear the flags for the next
      // pod (the fit bits stay for the nomination)
      for (int j = tid; j < vc; j += kThreads)
        boost_at[rw[j * kRsvInts + kRsvNode] - lo] = 0;
    }
    // the cluster's maximum: every CTA reads the 16 ranks
    cluster_arrive();
    cluster_wait();
    if (wid == 0) {
      best = warp_max(lane < kCluster
                          ? *cluster.map_shared_rank(&s_best[parity], lane)
                          : LLONG_MIN);
      const int value = static_cast<int>(best >> 32);
      if (value >= 0) {
        const int node =
            0x7FFFFFFF - static_cast<int>(best & 0xFFFFFFFFll);
        const int i = node - lo;
        if (i >= 0 && i < cnt) {
          int charge = lane < kDims ? s_req[lane] : 0;
          if constexpr (kRsv) {
            // nominate_reservation: the fitting row on the node with the
            // smallest total remainder, the lowest row on ties (the
            // records of one node are in row order)
            long long key = LLONG_MAX;
            for (int j = lane; j < vc; j += 32) {
              const int* rec = rw + j * kRsvInts;
              if ((rec[kRsvFlags] & kRsvFit) && rec[kRsvNode] == node) {
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
              if (lane < kDims) {
                const int rem = wsub(rec[lane], rec[kDims + lane]);
                const int take = min(charge, rem);
                rec[kDims + lane] = (rec[kRsvFlags] & kRsvOnce)
                                        ? rec[lane]
                                        : wadd(rec[kDims + lane], take);
                charge = wsub(charge, take);
              }
              if (lane == 0) ra.out_rsv[idx] = rec[kRsvRow];
            }
          }
          if (lane < kDims) {
            // requested += the charge, the in-flight estimate += est: the
            // free capacity falls by the charge, the usage and the
            // threshold's left side rise by est and 100 * est
            const int o = lane * S + i;
            n_free[o] = wsub(n_free[o], charge);
            n_use[o] = wadd(n_use[o], s_est[lane]);
            n_thx[o] = wadd(n_thx[o], wmul(kMaxScore, s_est[lane]));
          }
          if (lane == 0) out_assign[idx] = node;
        }
        const int qid = s_qid;
        if (has_quota && qid >= 0 && qvalid[qid] && lane < kDims) {
          const int q = s_req[lane];
          for (int d = 0; d < QD; ++d) {
            const int anc = chain[qid * QD + d];
            if (anc >= 0)
              head[anc * kDims + lane] = wsub(head[anc * kDims + lane], q);
          }
          if (s_np)
            min_head[qid * kDims + lane] =
                wsub(min_head[qid * kDims + lane], q);
        }
      }
    }
    parity ^= 1;
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
  cluster.sync();  // no CTA leaves while a peer may still read its s_best
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
                   const uint8_t* pnp, int P, int N, int* out_assign,
                   const RsvArgs& ra) {
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
                            q_valid, Q, QD, pquota, pnp, P, N, out_assign,
                            ra);
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
         int Q, int QD, const int* pquota, const uint8_t* pnp, int P, int N,
         int* out_assign, const RsvArgs& ra, int vmax, void* stream) {
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
        q_checked, q_chain, q_valid, Q, QD, pquota, pnp, P, N, out_assign,
        args);
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
  return plan.nodes_in_smem ? 0
                            : kCluster * Layout(N, Q, QD).scratch_bytes();
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
