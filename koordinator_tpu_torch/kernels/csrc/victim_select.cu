// K5: preemption's dry run (K5a), node choice and commit (K5b), chained over
// the preemptors of a chunk.
//
// Replaces the JAX package's device programs
//   koordinator_tpu/ops/preemption.py:160 select_victims (the reprieve scan)
//   koordinator_tpu/ops/preemption.py:289 pick_node
//   koordinator_tpu/ops/preemption.py:321 preempt_one (its commit)
//   koordinator_tpu/ops/preemption.py:384 preempt_chain (the scan over C)
// Their plain PyTorch versions are select_victims_plain, preempt_one_plain
// and preempt_chain_plain in ops/preemption.py; kernels/preemption.py holds
// the wrapper and a Python mirror of this decomposition.
//
// The reference scans every bound pod in one global order, but a step only
// reads and writes its own node's free vector (and that node's quota dry
// run), so the scan is a set of independent per-node walks, each in the
// node's own order.  The wrapper builds a CSR of the live bound rows by node,
// each node's rows in importance order (-priority as int32 ascending, row
// ascending), once a call.
//
// K5a, one warp per node.  Pass 1 takes the node's rows 32 at a time, a lane
// a row: the candidate mask (valid, lower priority, preemptible, same quota
// when asked), each candidate's rank among the earlier candidates of its PDB
// (__match_any_sync over the chunk's PDB ids and the popcount of the lower
// matching lanes, plus the carry: the count of the earlier chunks'
// candidates of that PDB, read back from the pkey scratch), whether it is
// PDB-violating, and the freed vector (__reduce_add_sync a dimension).
// Pass 2 is the reprieve: violating candidates first, then the others, each
// group in CSR order, one candidate a step with lane d holding dimension d
// of the node's free vector and of its quota dry run; the fit test is one
// __all_sync.  It writes the node's record (eligible, num_violating,
// max_victim_pri, sum_victim_pri, num_victims) and a flag byte a CSR
// position (bit 0 victim, bit 1 violating, bit 2 candidate).
//
// K5b, one CTA: the lexicographic minimum of (num_violating, max_victim_pri,
// sum_victim_pri, num_victims, row) over the eligible nodes, then, when the
// preemptor is active and found a node, warp 0 commits over that node's CSR
// range: the victims leave node_requested and the valid rows, their PDBs
// pay, the preemptor's request is nominated, and in the chain's quota mode
// the victims release their quota rows of `assumed` and the preemptor
// charges its own.  A failed or inactive preemptor leaves everything as it
// was.
//
// int32 arithmetic wraps as the reference's does (koord_common.cuh).
//
// What bounds it on the H100: the dependency chain.  A preemptor reads each
// candidate row's request and flags and the (N, R) free and feasible rows
// once (bytes), but the reprieve is a chain of dependent steps on each
// node; the busiest node's walk (one global load and one vote a step) and
// the two launches a preemptor set its floor.  A persistent kernel or a
// CUDA graph over the chunk is later work.

#include <climits>

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wsub;

constexpr int kWarps = 8;
constexpr int kCommitThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpen = 1 << 30;          // HEADROOM_OPEN
constexpr int kNegPri = INT_MIN + 1;    // NEG_PRI
// the per-node record's rows (kernels/preemption.py NODE_FIELDS)
constexpr int kEligible = 0, kNumViolating = 1, kMaxPri = 2, kSumPri = 3,
              kNumVictims = 4;
constexpr int kNoQuota = 0, kHeadroom = 1, kChain = 2;
constexpr uint8_t kVictim = 1, kViolating = 2, kCandidate = 4;

struct Args {
  const int* alloc;
  int* requested;
  const uint8_t* node_valid;
  int N;
  const int* requests;
  const int* priority;
  const int* quota_id;
  const uint8_t* nonp;
  const int* pdb_id;
  uint8_t* valid;
  int V;
  const int* offsets;
  const int* rows;
  const int* row_count;
  const int* reqs;
  const int* pris;
  const int* qids;
  const uint8_t* feasible;
  const uint8_t* same_quota;
  const uint8_t* active;
  int C;
  int* pdb;
  int B;
  int quota_mode;
  const int* headroom;   // (R,) in kHeadroom
  const int* base_hr;    // (Q, R) in kChain
  int* assumed;          // (Q, R) in kChain
  int Q;
  int nominate;
  uint8_t* flags;
  int* pkey;
  int* node_rec;         // (5, N)
  int* nodes_out;        // (C,)
  uint8_t* victims_out;  // (C, V)
};

__device__ __forceinline__ bool fits(int p, int room) {
  return p == 0 || p <= room;
}

// The preemptor's headroom on dimension d (lane d), or 0 without a quota.
__device__ __forceinline__ int quota_room(const Args& a, int c, int d) {
  if (a.quota_mode == kHeadroom) return a.headroom[d];
  if (a.quota_mode != kChain) return 0;
  if (!a.same_quota[c]) return kOpen;
  const int q = min(max(a.qids[c], 0), a.Q - 1);  // a gather clamps
  const int hr = wsub(a.base_hr[q * kDims + d], a.assumed[q * kDims + d]);
  return min(max(hr, -kOpen), kOpen);
}

__global__ void __launch_bounds__(kWarps * 32)
    victim_select_kernel(const Args a, int c) {
  const int nd = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (nd >= a.N) return;
  const int start = a.offsets[nd], end = a.offsets[nd + 1];
  const int ppri = a.pris[c], pq = a.qids[c];
  const bool sq = a.same_quota[c];
  const bool dim = lane < kDims;
  const int preq = dim ? a.reqs[c * kDims + lane] : 0;
  const unsigned lower = (1u << lane) - 1u;

  // pass 1: candidates, PDB ranks, violating, freed
  unsigned freed = 0;  // dimension `lane`
  bool has_cand = false;
  for (int base = start; base < end; base += 32) {
    const int pos = base + lane;
    const bool in = pos < end;
    const int row = in ? a.rows[pos] : 0;
    const bool cand = in && a.valid[row] && a.priority[row] < ppri &&
                      !a.nonp[row] && (!sq || a.quota_id[row] == pq);
    const int pdb = cand ? a.pdb_id[row] : -1;
    const int key = pdb >= 0 ? pdb : -1;
    int rank = __popc(__match_any_sync(kFull, key) & lower);
    for (int prev = start; prev < base; prev += 32) {
      const int pk = a.pkey[prev + lane];
#pragma unroll 8
      for (int i = 0; i < 32; ++i) rank += __shfl_sync(kFull, pk, i) == key;
    }
    if (in) a.pkey[pos] = key;
    const bool viol = key >= 0 && rank >= a.pdb[min(key, a.B - 1)];
    if (in) a.flags[pos] = (cand ? kCandidate : 0) | (viol ? kViolating : 0);
    has_cand |= __ballot_sync(kFull, cand) != 0;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      const unsigned r =
          cand ? static_cast<unsigned>(a.requests[row * kDims + d]) : 0u;
      const unsigned s = __reduce_add_sync(kFull, r);
      if (lane == d) freed += s;
    }
    __syncwarp();  // the chunk's pkey stores before the next chunk reads
  }

  const bool node_ok = a.node_valid[nd];
  int free_d = 0, qfree_d = 0;
  if (dim) {
    const int f = node_ok ? wsub(a.alloc[nd * kDims + lane],
                                 a.requested[nd * kDims + lane])
                          : 0;
    free_d = wadd(f, static_cast<int>(freed));
    qfree_d = wadd(quota_room(a, c, lane), static_cast<int>(freed));
  }
  const bool quota = a.quota_mode != kNoQuota;

  // pass 2: the reprieve, violating candidates first
  int nvic = 0, nviol = 0, maxp = INT_MIN, sump = 0;
  for (int group = 1; group >= 0; --group) {
    const uint8_t want = kCandidate | (group ? kViolating : 0);
    for (int base = start; base < end; base += 32) {
      const int pos = base + lane;
      const bool in = pos < end;
      const uint8_t f = in ? a.flags[pos] : 0;
      const bool take = in && (f & (kCandidate | kViolating)) == want;
      const int row = take ? a.rows[pos] : 0;
      const int pri = take ? a.priority[row] : 0;
      unsigned todo = __ballot_sync(kFull, take);
      unsigned vm = 0;
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int r = __shfl_sync(kFull, row, i);
        const int rd = dim ? a.requests[r * kDims + lane] : 0;
        bool ok = !dim || fits(preq, wsub(free_d, rd));
        if (quota) ok = ok && (!dim || fits(preq, wsub(qfree_d, rd)));
        if (__all_sync(kFull, ok)) {
          free_d = wsub(free_d, rd);
          qfree_d = wsub(qfree_d, rd);
        } else {
          const int p = __shfl_sync(kFull, pri, i);
          vm |= 1u << i;
          ++nvic;
          nviol += group;
          maxp = max(maxp, p);
          sump = wadd(sump, p);
        }
      }
      if ((vm >> lane) & 1u) a.flags[pos] = f | kVictim;
    }
  }

  bool fit = !dim || fits(preq, free_d);
  if (quota) fit = fit && (!dim || fits(preq, qfree_d));
  const bool eligible = __all_sync(kFull, fit) && has_cand && node_ok &&
                        a.feasible[static_cast<long long>(c) * a.N + nd];
  if (lane == 0) {
    // the reference's per-node maximum also reduces the node's other rows,
    // each at NEG_PRI: it shows only below NEG_PRI (a victim at INT_MIN)
    if (nvic == 0 || (maxp < kNegPri && a.row_count[nd] > nvic))
      maxp = kNegPri;
    a.node_rec[kEligible * a.N + nd] = eligible;
    a.node_rec[kNumViolating * a.N + nd] = nviol;
    a.node_rec[kMaxPri * a.N + nd] = maxp;
    a.node_rec[kSumPri * a.N + nd] = sump;
    a.node_rec[kNumVictims * a.N + nd] = nvic;
  }
}

struct Key {
  int v[4];
  int row;
};

__device__ __forceinline__ bool less(const Key& x, const Key& y) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (x.v[i] != y.v[i]) return x.v[i] < y.v[i];
  return x.row < y.row;
}

__device__ __forceinline__ Key shfl_key(const Key& k, int src) {
  Key o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.v[i] = __shfl_sync(kFull, k.v[i], src);
  o.row = __shfl_sync(kFull, k.row, src);
  return o;
}

__device__ __forceinline__ Key shfl_key_down(const Key& k, int delta) {
  Key o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.v[i] = __shfl_down_sync(kFull, k.v[i], delta);
  o.row = __shfl_down_sync(kFull, k.row, delta);
  return o;
}

__global__ void __launch_bounds__(kCommitThreads)
    victim_commit_kernel(const Args a, int c) {
  __shared__ Key s_best[kCommitThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Key best = {{INT_MAX, INT_MAX, INT_MAX, INT_MAX}, INT_MAX};
  for (int n = tid; n < a.N; n += kCommitThreads) {
    if (!a.node_rec[kEligible * a.N + n]) continue;
    const Key k = {{a.node_rec[kNumViolating * a.N + n],
                    a.node_rec[kMaxPri * a.N + n],
                    a.node_rec[kSumPri * a.N + n],
                    a.node_rec[kNumVictims * a.N + n]},
                   n};
    if (less(k, best)) best = k;
  }
  for (int delta = 16; delta; delta >>= 1) {
    const Key o = shfl_key_down(best, delta);
    if (less(o, best)) best = o;
  }
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  best = lane < kCommitThreads / 32 ? s_best[lane] : s_best[0];
  for (int delta = 16; delta; delta >>= 1) {
    const Key o = shfl_key_down(best, delta);
    if (less(o, best)) best = o;
  }
  best = shfl_key(best, 0);
  const int node = best.row == INT_MAX ? -1 : best.row;
  const bool ok = a.active[c] && node >= 0;
  if (lane == 0) a.nodes_out[c] = ok ? node : -1;
  if (!ok) return;

  // the commit, lane d on dimension d
  const bool dim = lane < kDims;
  const bool chain = a.quota_mode == kChain;
  const int start = a.offsets[node], end = a.offsets[node + 1];
  unsigned removed = 0;
  for (int base = start; base < end; base += 32) {
    const int pos = base + lane;
    const bool vic = pos < end && (a.flags[pos] & kVictim);
    const int row = vic ? a.rows[pos] : 0;
    const int q = vic ? a.quota_id[row] : -1;
    if (vic) {
      a.valid[row] = 0;
      a.victims_out[static_cast<long long>(c) * a.V + row] = 1;
      const int pdb = a.pdb_id[row];
      if (pdb >= 0 && pdb < a.B) atomicSub(&a.pdb[pdb], 1);
    }
    unsigned todo = __ballot_sync(kFull, vic);
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r = __shfl_sync(kFull, row, i);
      const int rq = __shfl_sync(kFull, q, i);
      if (dim) {
        const int rd = a.requests[r * kDims + lane];
        removed += static_cast<unsigned>(rd);
        if (chain && rq >= 0 && rq < a.Q)
          a.assumed[rq * kDims + lane] = wsub(a.assumed[rq * kDims + lane], rd);
      }
    }
  }
  if (dim) {
    const int preq = a.reqs[c * kDims + lane];
    int* cell = &a.requested[node * kDims + lane];
    *cell = wadd(wsub(*cell, static_cast<int>(removed)),
                 a.nominate ? preq : 0);
    const int qid = a.qids[c];
    if (chain && qid >= 0 && qid < a.Q)
      a.assumed[qid * kDims + lane] = wadd(a.assumed[qid * kDims + lane], preq);
  }
}

}  // namespace

// Runs K5a, then with `commit` K5b, for each of the preemptors
// [first, first + count), in order, on `stream` (`commit` 0 is the dry run
// alone, select_victims'); returns the first launch error.
extern "C" int koord_preempt_chain(
    const int* alloc, int* requested, const uint8_t* node_valid, int N,
    const int* requests, const int* priority, const int* quota_id,
    const uint8_t* nonp, const int* pdb_id, uint8_t* valid, int V,
    const int* offsets, const int* rows, const int* row_count,
    const int* reqs, const int* pris, const int* qids,
    const uint8_t* feasible, const uint8_t* same_quota, const uint8_t* active,
    int C, int* pdb, int B, int quota_mode, const int* headroom,
    const int* base_hr, int* assumed, int Q, int nominate, uint8_t* flags,
    int* pkey, int* node_rec, int* nodes_out, uint8_t* victims_out,
    int first, int count, int commit, void* stream) {
  if (N < 1 || B < 1 || first < 0 || first + count > C || commit < 0 ||
      commit > 1 || quota_mode < kNoQuota || quota_mode > kChain ||
      (quota_mode == kHeadroom && headroom == nullptr) ||
      (quota_mode == kChain && (base_hr == nullptr || assumed == nullptr ||
                                Q < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{alloc,    requested, node_valid, N,          requests,
               priority, quota_id,  nonp,       pdb_id,     valid,
               V,        offsets,   rows,       row_count,  reqs,
               pris,     qids,      feasible,   same_quota, active,
               C,        pdb,       B,          quota_mode, headroom,
               base_hr,  assumed,   Q,          nominate,   flags,
               pkey,     node_rec,  nodes_out,  victims_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kWarps - 1) / kWarps);
  for (int c = first; c < first + count; ++c) {
    victim_select_kernel<<<grid, kWarps * 32, 0, s>>>(a, c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!commit) continue;
    victim_commit_kernel<<<1, kCommitThreads, 0, s>>>(a, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
