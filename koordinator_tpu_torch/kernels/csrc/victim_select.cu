// K5: preemption's dry run, node choice and commit, chained over the
// preemptors of a chunk in one persistent launch.
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
// node's own order.  The wrapper keeps, once a PostFilter, the bound rows in
// node order (a CSR: each node's rows in importance order, -priority as
// int32 ascending, row ascending; rows bound to no node past the last node)
// with their priority, quota, PDB id, non-preemptible flag and the R request
// dimensions gathered into separate arrays in that order, so a node's reads
// are contiguous and the ~9 MB the chain reads stays in L2.
//
// One launch a chain, every CTA resident (a cooperative launch).  Each CTA
// owns a fixed block of nodes (an equal share of the bound rows), takes them
// most rows first, and keeps its own copy of the PDB budgets and
// of the chain's assumed quota (in shared memory when they fit, else in its
// own slice of a global scratch): every candidate of every node reads them,
// and one shared copy would send every such read to the same L2 lines.  The
// prologue copies each of its rows' validity and preemptibility into a
// flag byte in CSR order.  The quota mode is a template parameter.  Then,
// for each preemptor in order:
//   - each warp dry-runs its nodes as it takes them; in a chain, a node the
//     preemptor cannot take (infeasible, or not a valid row) is skipped, as
//     its flags are never read.  Pass 1 takes a node's rows 32 at a
//     time, a lane a row: the candidate mask (valid, lower priority,
//     preemptible, same quota when asked), each candidate's rank among the
//     earlier candidates of its PDB (__match_any_sync over the chunk's PDB
//     ids and the popcount of the lower matching lanes, plus the carry from
//     the earlier chunks' keys), whether it is PDB-violating, the freed
//     vector (__reduce_add_sync a dimension), and the requests staged in
//     shared memory (kStage rows a warp; rows past that are read from the
//     CSR arrays), both only for the dimensions the preemptor requests: a
//     request of 0 fits whatever is left.  Pass 2 is the reprieve: violating candidates first,
//     then the others, each group in CSR order, one candidate a step with
//     lane d holding dimension d of the node's free vector and of its quota
//     dry run, the fit test one __all_sync; it reads shared memory only.
//     The node's key is (num_violating, max_victim_pri, sum_victim_pri,
//     num_victims, node) when the preemptor fits there after, else none;
//     the flag byte of each row of the node (bit 0 victim, 1 violating, 2
//     candidate) goes to global memory (two buffers, by preemptor parity:
//     a CTA may still read one preemptor's while another writes the
//     next's; the partial keys alternate the same way);
//   - the CTA reduces its warps' keys to one partial key, stores it, and
//     arrives on a counter (a release reduction), then waits, polling with
//     relaxed loads and acquiring once, until every CTA has arrived;
//   - every CTA reduces the partial keys (the key ends in the node row, a
//     total order: every CTA finds the same node) and, when the preemptor
//     is active and found a node, applies the commit from that node's flag
//     bytes: the victims' PDBs pay and their quota rows of its assumed
//     copy are released (the preemptor charges its own) in every CTA; the
//     owner of the node also takes the victims out of node_requested,
//     their flag bytes and the (V,) valid rows, lists each with its
//     preemptor (victim_of), and nominates the preemptor there.
// So a preemptor costs one meeting of the CTAs, and every later read of
// what a commit wrote is the reading CTA's own.  CTA 0 writes the budgets
// and the assumed quota out at the end.  With `commit` 0 (the dry run
// alone, select_victims) the CTAs do not meet: each node's record is
// written to node_rec instead.
//
// int32 arithmetic wraps as the reference's does (koord_common.cuh).
//
// What bounds it on the H100: the dependency chain.  A chain reads each
// CSR row once (bytes), but each preemptor's dry run is a chain of
// dependent reprieve steps on each node, then the meeting before the next
// preemptor: the busiest node's walk times C, plus C meetings (arrive,
// wait, choose, apply), set its floor.  The one launch, the rows in node
// order, the staged requests and the CTAs' own copies of what a commit
// changes are what the design does about it.  On the H100 a meeting with
// no dry run costs ~6.8 us and a node's dry run ~7,000 SM cycles with 32
// warps an SM (profile_torch_round.py --preempt).

#include <climits>

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wsub;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 2;  // what the registers are bounded for
// rows of a node whose requests a warp stages in shared memory
constexpr int kStage = 64;
constexpr int kStride = kStage + 1;  // lane d reads row i at d * kStride + i
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpen = 1 << 30;          // HEADROOM_OPEN
constexpr int kNegPri = INT_MIN + 1;    // NEG_PRI
// the per-node record's rows (kernels/preemption.py NODE_FIELDS)
constexpr int kEligible = 0, kNumViolating = 1, kMaxPri = 2, kSumPri = 3,
              kNumVictims = 4;
constexpr int kNoQuota = 0, kHeadroom = 1, kChain = 2;
// the CSR's flag bytes: a row's state, and its last dry run's outcome
constexpr uint8_t kValid = 1, kNonPreemptible = 2;
constexpr uint8_t kVictim = 1, kViolating = 2, kCandidate = 4;
// a CTA waiting this long for the others traps
constexpr unsigned long long kWaitLimitNs = 20ull * 1000 * 1000 * 1000;
// the most bytes of budgets and assumed quota a CTA keeps in shared memory
constexpr int kLocalShared = 32 * 1024;
// the most nodes a CTA orders by their rows (more: taken in node order)
constexpr int kOrderMost = 1024;

struct Args {
  const int* alloc;
  int* requested;
  const uint8_t* node_valid;
  int N;
  // the CSR, every array in node order (stride M)
  const int* offsets;    // (N + 1,)
  const int* rows;       // (M,) the row of each CSR position
  const int* cpri;
  const int* cquota;
  const int* cpdb;
  const uint8_t* cnonp;
  const int* creq;       // (R, M)
  const int* row_count;  // (N,)
  int M;
  uint8_t* valid;        // (M,) by row, in/out
  uint8_t* cflag;        // (M,) scratch: kValid | kNonPreemptible
  uint8_t* cout;         // (2, M) the dry runs, by preemptor parity:
                         // kVictim | kViolating | kCandidate
  int* pkey;             // (M,) scratch: PDB keys for the chunk carry
  const int* reqs;
  const int* pris;
  const int* qids;
  const uint8_t* feasible;
  const uint8_t* same_quota;
  const uint8_t* active;
  int C;
  const int* pdb_in;     // (B,)
  int* pdb_out;          // (B,) written by CTA 0 at the end (commit)
  int B;
  int quota_mode;
  const int* headroom;   // (R,) in kHeadroom
  const int* base_hr;    // (Q, R) in kChain
  int* assumed;          // (Q, R) out in kChain, written by CTA 0
  int Q;
  int nominate;
  int commit;
  int* node_rec;         // (5, N), written when !commit
  int* nodes_out;        // (C,)
  int* victim_of;        // (M,) by row: the preemptor that evicted it
  int* local;            // (grid, B + Q R) scratch, or null: in shared
  int* partial;          // (2, kKeyInts, grid) scratch, by preemptor parity
  int* order;            // (N,) scratch: each CTA's nodes, most rows first
  unsigned* arrivals;    // zeroed at launch
};

struct Key {
  int v[4];
  int row;
};
constexpr int kKeyInts = 5;

__device__ __forceinline__ Key no_key() {
  return {{INT_MAX, INT_MAX, INT_MAX, INT_MAX}, INT_MAX};
}

__device__ __forceinline__ bool less(const Key& x, const Key& y) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (x.v[i] != y.v[i]) return x.v[i] < y.v[i];
  return x.row < y.row;
}

__device__ __forceinline__ Key shfl_key_down(const Key& k, int delta) {
  Key o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.v[i] = __shfl_down_sync(kFull, k.v[i], delta);
  o.row = __shfl_down_sync(kFull, k.row, delta);
  return o;
}

// The key's ints, in the partial keys' order.
__device__ __forceinline__ void key_store(const Key& k, int* p, int stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i * stride] = k.v[i];
  p[4 * stride] = k.row;
}

__device__ __forceinline__ Key key_load(const int* p, int stride) {
  return {{__ldcg(p), __ldcg(p + stride), __ldcg(p + 2 * stride),
           __ldcg(p + 3 * stride)},
          __ldcg(p + 4 * stride)};
}

__device__ __forceinline__ Key warp_min(Key k) {
  for (int delta = 16; delta; delta >>= 1) {
    const Key o = shfl_key_down(k, delta);
    if (less(o, k)) k = o;
  }
  return k;  // lane 0 holds the minimum
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool fits(int p, int room) {
  return p == 0 || p <= room;
}

// The CTA's own copies of what a commit changes for every node.
struct Local {
  int* pdb;      // (B,)
  int* assumed;  // (Q, R) in kChain
};

// The preemptor's headroom on dimension d (lane d), or 0 without a quota.
template <int kMode>
__device__ __forceinline__ int quota_room(const Args& a, const Local& l,
                                          int c, int d) {
  if (kMode == kHeadroom) return a.headroom[d];
  if (kMode != kChain) return 0;
  if (!a.same_quota[c]) return kOpen;
  const int q = min(max(a.qids[c], 0), a.Q - 1);  // a gather clamps
  const int hr = wsub(a.base_hr[q * kDims + d], l.assumed[q * kDims + d]);
  return min(max(hr, -kOpen), kOpen);
}

// One warp's dry run of preemptor c on node nd: writes the node's CSR flag
// bytes (and with !commit its record) and returns its key (no_key() when
// the preemptor does not fit there).  With `commit`, a node the preemptor
// cannot take (infeasible, or not a valid row) is not walked: its flags are
// never read.  `stage` is the warp's (kDims, kStride) shared buffer.  Lanes
// past kDims, and lanes of a dimension the preemptor requests 0 of, hold a
// request of 0, which fits whatever they read.
template <int kMode>
__device__ Key dry_run(const Args& a, const Local& l, int c, int nd,
                       int* stage, int lane) {
  const bool feasible = a.feasible[static_cast<long long>(c) * a.N + nd] &&
                        a.node_valid[nd];
  if (a.commit && !feasible) return no_key();
  uint8_t* cout = a.cout + static_cast<long long>(c & 1) * a.M;
  const int start = a.offsets[nd], end = a.offsets[nd + 1];
  const int ppri = a.pris[c], pq = a.qids[c];
  const bool sq = a.same_quota[c];
  const bool dim = lane < kDims;
  const int dl = dim ? lane : kDims - 1;  // the dimension lane dl reads
  const int preq = dim ? a.reqs[c * kDims + lane] : 0;
  const unsigned lower = (1u << lane) - 1u;
  const bool chunks = end - start > 32;
  // a dimension the preemptor requests 0 of fits whatever is left there:
  // pass 1 stages and sums only the others
  const unsigned need = __ballot_sync(kFull, preq != 0);

  // pass 1: candidates, PDB ranks, violating, freed; requests staged
  unsigned freed = 0;  // dimension `lane`
  bool has_cand = false;
  uint8_t first = 0;   // the first chunk's flags (the only chunk, mostly)
  int first_pri = 0;   // and its priorities
  // what pass 2 and the record read of the node, loaded before pass 1 so
  // the loads overlap it
  const bool node_ok = a.node_valid[nd];
  const int alloc_d = a.alloc[nd * kDims + dl];
  const int requested_d = a.requested[nd * kDims + dl];
  const int room_d = quota_room<kMode>(a, l, c, dl);
  const int row_count = a.row_count[nd];
  for (int base = start; base < end; base += 32) {
    const int pos = base + lane;
    const bool in = pos < end;
    const uint8_t fl = in ? a.cflag[pos] : 0;
    const int pri = in ? a.cpri[pos] : 0;
    const bool cand = in && (fl & (kValid | kNonPreemptible)) == kValid &&
                      pri < ppri && (!sq || a.cquota[pos] == pq);
    const int pdb = cand ? a.cpdb[pos] : -1;
    const int key = pdb >= 0 ? pdb : -1;
    int rank = __popc(__match_any_sync(kFull, key) & lower);
    if (chunks) {
      // the carry: the earlier chunks' candidates of this PDB (each key was
      // stored by this lane)
      for (int prev = start; prev < base; prev += 32) {
        const int pk = a.pkey[prev + lane];
#pragma unroll 8
        for (int i = 0; i < 32; ++i) rank += __shfl_sync(kFull, pk, i) == key;
      }
      if (in) a.pkey[pos] = key;
    }
    const bool viol = key >= 0 && rank >= l.pdb[min(key, a.B - 1)];
    const uint8_t o = (cand ? kCandidate : 0) | (viol ? kViolating : 0);
    if (in) cout[pos] = o;
    if (base == start) {
      first = o;
      first_pri = pri;
    }
    has_cand |= __ballot_sync(kFull, cand) != 0;
    const int local = pos - start;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      if (!((need >> d) & 1u)) continue;
      const int r = in ? a.creq[static_cast<long long>(d) * a.M + pos] : 0;
      if (in && local < kStage) stage[d * kStride + local] = r;
      const unsigned s = __reduce_add_sync(kFull, cand ? static_cast<unsigned>(r) : 0u);
      if (lane == d) freed += s;
    }
  }
  __syncwarp();  // the staged requests before any lane reads them

  const int f = node_ok ? wsub(alloc_d, requested_d) : 0;
  int free_d = wadd(f, static_cast<int>(freed));
  int qfree_d = wadd(room_d, static_cast<int>(freed));
  constexpr bool quota = kMode != kNoQuota;

  // pass 2: the reprieve, violating candidates first
  int nvic = 0, nviol = 0, maxp = INT_MIN, sump = 0;
  for (int group = 1; group >= 0; --group) {
    const uint8_t want = kCandidate | (group ? kViolating : 0);
    for (int base = start; base < end; base += 32) {
      const int pos = base + lane;
      const bool in = pos < end;
      // each lane reads back the byte it wrote in pass 1
      const uint8_t o = base == start ? first : (in ? cout[pos] : 0);
      const bool take = in && (o & (kCandidate | kViolating)) == want;
      const int pri = !take ? 0 : base == start ? first_pri : a.cpri[pos];
      unsigned todo = __ballot_sync(kFull, take);
      unsigned vm = 0;
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int li = base - start + i;
        const int rd =
            li < kStage ? stage[dl * kStride + li]
                        : a.creq[static_cast<long long>(dl) * a.M + base + i];
        bool ok = fits(preq, wsub(free_d, rd));
        if (quota) ok = ok && fits(preq, wsub(qfree_d, rd));
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
      if ((vm >> lane) & 1u) cout[pos] = o | kVictim;
    }
  }
  __syncwarp();  // every lane's reads of the stage before the next node

  bool fit = fits(preq, free_d);
  if (quota) fit = fit && fits(preq, qfree_d);
  const bool eligible = __all_sync(kFull, fit) && has_cand && feasible;
  // the reference's per-node maximum also reduces the node's other rows,
  // each at NEG_PRI: it shows only below NEG_PRI (a victim at INT_MIN)
  if (nvic == 0 || (maxp < kNegPri && row_count > nvic)) maxp = kNegPri;
  if (!a.commit && lane == 0) {
    a.node_rec[kEligible * a.N + nd] = eligible;
    a.node_rec[kNumViolating * a.N + nd] = nviol;
    a.node_rec[kMaxPri * a.N + nd] = maxp;
    a.node_rec[kSumPri * a.N + nd] = sump;
    a.node_rec[kNumVictims * a.N + nd] = nvic;
  }
  if (!eligible) return no_key();
  return {{nviol, maxp, sump, nvic}, nd};
}

// Warp 0 of every CTA: preemptor c's commit on `node` (the same in every
// CTA) from the node's flag bytes; `owner` when this CTA owns the node.
__device__ void apply_commit(const Args& a, const Local& l, int c, int node,
                             bool owner, int lane) {
  const bool dim = lane < kDims;
  const bool chain = a.quota_mode == kChain;
  const uint8_t* cout = a.cout + static_cast<long long>(c & 1) * a.M;
  const int start = a.offsets[node], end = a.offsets[node + 1];
  unsigned removed = 0;  // dimension `lane`
  for (int base = start; base < end; base += 32) {
    const int pos = base + lane;
    // the owner wrote the flags before it arrived: read them through L2
    const bool vic = pos < end && (__ldcg(cout + pos) & kVictim);
    int r[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      r[d] = vic ? a.creq[static_cast<long long>(d) * a.M + pos] : 0;
    if (vic) {
      const int pdb = a.cpdb[pos];
      if (pdb >= 0 && pdb < a.B) atomicSub(l.pdb + pdb, 1);
      const int q = a.cquota[pos];
      if (chain && q >= 0 && q < a.Q) {
#pragma unroll
        for (int d = 0; d < kDims; ++d)
          atomicSub(l.assumed + q * kDims + d, r[d]);
      }
      if (owner) {
        const int row = a.rows[pos];
        a.cflag[pos] &= ~kValid;
        a.valid[row] = 0;
        a.victim_of[row] = c;
      }
    }
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      const unsigned s = __reduce_add_sync(kFull, static_cast<unsigned>(r[d]));
      if (lane == d) removed += s;
    }
  }
  __syncwarp();
  if (dim) {
    const int preq = a.reqs[c * kDims + lane];
    if (owner) {
      int* cell = a.requested + node * kDims + lane;
      *cell = wadd(wsub(*cell, static_cast<int>(removed)),
                   a.nominate ? preq : 0);
    }
    const int qid = a.qids[c];
    if (chain && qid >= 0 && qid < a.Q) {
      int* qcell = l.assumed + qid * kDims + lane;
      *qcell = wadd(*qcell, preq);
    }
  }
}

// The first node of CTA b's block: the first whose rows start at or past
// b's share of the bound rows (G's block ends at N).
__device__ __forceinline__ int first_node(const Args& a, int b, int G) {
  if (b >= G) return a.N;
  const long long share = static_cast<long long>(a.offsets[a.N]) * b / G;
  int lo = 0, hi = a.N;  // the first n with offsets[n] >= share
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.offsets[mid] < share)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    preempt_chain_kernel(const Args a) {
  extern __shared__ int s_dyn[];
  __shared__ int s_stage[kWarps][kDims * kStride];
  __shared__ Key s_key[kWarps];
  __shared__ int s_next[2];  // the CTA's next node, by preemptor parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x;
  // the CTA's nodes: those whose rows start in its share of the bound
  // rows, so the CTAs walk about as many rows each
  const int n0 = first_node(a, blockIdx.x, G);
  const int n1 = first_node(a, blockIdx.x + 1, G);
  const int qr = a.quota_mode == kChain ? a.Q * kDims : 0;
  int* mine = a.local ? a.local + static_cast<long long>(blockIdx.x) *
                                      (a.B + qr)
                      : s_dyn;
  const Local l{mine, mine + a.B};

  // prologue: the CTA's nodes, most rows first (a warp taking the longest
  // walks first leaves the short ones to fill in behind them); its rows'
  // state in CSR order, its own budgets and assumed quota
  const int count = n1 - n0;
  int* order = a.order + n0;
  if (count <= kOrderMost) {
    int* rows_of = &s_stage[0][0];  // free until the first dry run
    for (int i = threadIdx.x; i < count; i += kThreads)
      rows_of[i] = a.offsets[n0 + i + 1] - a.offsets[n0 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int ri = rows_of[i];
      int rank = 0;
      for (int j = 0; j < count; ++j)
        rank += rows_of[j] > ri || (rows_of[j] == ri && j < i);
      order[rank] = n0 + i;
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) order[i] = n0 + i;
  }
  for (int p = a.offsets[n0] + threadIdx.x; p < a.offsets[n1]; p += kThreads)
    a.cflag[p] = (a.valid[a.rows[p]] ? kValid : 0) |
                 (a.cnonp[p] ? kNonPreemptible : 0);
  for (int i = threadIdx.x; i < a.B; i += kThreads) l.pdb[i] = a.pdb_in[i];
  for (int i = threadIdx.x; i < qr; i += kThreads) l.assumed[i] = 0;
  if (threadIdx.x == 0) s_next[0] = 0;
  __syncthreads();

  for (int c = 0; c < a.C; ++c) {
    // the warps take the CTA's nodes as they come free; the other parity's
    // counter was last used by c - 1, which every warp has left
    if (threadIdx.x == 0) s_next[(c + 1) & 1] = 0;
    Key best = no_key();
    for (;;) {
      int idx = 0;
      if (lane == 0) idx = atomicAdd(&s_next[c & 1], 1);
      idx = __shfl_sync(kFull, idx, 0);
      if (idx >= count) break;
      const int nd = order[idx];
      const Key k = dry_run<kMode>(a, l, c, nd, s_stage[warp], lane);
      if (less(k, best)) best = k;
    }
    if (!a.commit) {
      __syncthreads();
      continue;
    }

    // the CTA's partial key, the arrival, the wait for every CTA's
    if (lane == 0) s_key[warp] = best;
    __syncthreads();
    // a CTA may still read preemptor c - 1's flag bytes and partial keys
    // while another writes c's: they alternate between two buffers, and
    // c + 1's meeting waits for every reader of c - 1's
    int* partial = a.partial + (c & 1) * kKeyInts * G;
    if (threadIdx.x == 0) {
      Key b = s_key[0];
      for (int w = 1; w < kWarps; ++w)
        if (less(s_key[w], b)) b = s_key[w];
      key_store(b, partial + blockIdx.x, G);
      // the arrival releases the CTA's partial key and flag bytes
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(
                       a.arrivals),
                   "r"(1u)
                   : "memory");
      // relaxed polls, then one acquire
      const unsigned all = static_cast<unsigned>(c + 1) * G;
      const unsigned long long t0 = global_ns();
      while (ld_relaxed(a.arrivals) < all) {
        __nanosleep(32);
        if (global_ns() - t0 > kWaitLimitNs) __trap();
      }
      ld_acquire(a.arrivals);
    }
    __syncthreads();

    // every CTA: the chosen node from the partial keys, then the commit
    Key k = no_key();
    for (int g = threadIdx.x; g < G; g += kThreads) {
      const Key o = key_load(partial + g, G);
      if (less(o, k)) k = o;
    }
    k = warp_min(k);
    if (lane == 0) s_key[warp] = k;
    __syncthreads();
    if (warp == 0) {
      k = lane < kWarps ? s_key[lane] : no_key();
      k = warp_min(k);
      const int node = __shfl_sync(kFull, k.row, 0);
      const bool ok = a.active[c] && node != INT_MAX;
      if (lane == 0 && blockIdx.x == 0) a.nodes_out[c] = ok ? node : -1;
      if (ok) apply_commit(a, l, c, node, node >= n0 && node < n1, lane);
    }
    __syncthreads();
  }

  if (a.commit && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < a.B; i += kThreads) a.pdb_out[i] = l.pdb[i];
    for (int i = threadIdx.x; i < qr; i += kThreads)
      a.assumed[i] = l.assumed[i];
  }
}

// Bytes of a CTA's own budgets and assumed quota when they live in shared
// memory (at most kLocalShared), else 0: in the global scratch.
int local_bytes(int B, int QR) {
  const long long bytes = (static_cast<long long>(B) + QR) * 4;
  return bytes <= kLocalShared ? static_cast<int>(bytes) : 0;
}

// The kernel's instance for a quota mode.
const void* instance(int quota_mode) {
  switch (quota_mode) {
    case kHeadroom:
      return reinterpret_cast<const void*>(preempt_chain_kernel<kHeadroom>);
    case kChain:
      return reinterpret_cast<const void*>(preempt_chain_kernel<kChain>);
    default:
      return reinterpret_cast<const void*>(preempt_chain_kernel<kNoQuota>);
  }
}

int max_grid(int quota_mode, int dyn) {
  int dev = 0, sms = 0, blocks = 0;
  const void* fn = instance(quota_mode);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    dyn) != cudaSuccess)
    return 0;
  return sms * blocks;
}

}  // namespace

// The grid K5 launches with over N node rows, B PDBs and QR assumed-quota
// cells (0 outside the chain's quota mode): `request` CTAs (0: as many as
// can be resident, at most one a kWarps nodes), or -1 when that many cannot
// all be resident at once.
extern "C" long long koord_preempt_chain_grid(int N, int B, int QR,
                                              int request) {
  const int most = max_grid(QR ? kChain : kNoQuota, local_bytes(B, QR));
  if (request > 0) return request <= most ? request : -1;
  const int want = (N + kWarps - 1) / kWarps;
  return most < 1 ? -1 : (want < most ? want : most);
}

// Ints of the global scratch a grid of `grid` CTAs needs for their own
// budgets and assumed quota (0 when they fit shared memory).
extern "C" long long koord_preempt_chain_local_ints(int B, int QR, int grid) {
  return local_bytes(B, QR) ? 0
                            : static_cast<long long>(grid) * (B + QR);
}

// Runs K5 over the C preemptors in one cooperative launch of `grid` CTAs on
// `stream` (`commit` 0 is the dry run alone, select_victims'); returns the
// launch's error, cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident.
extern "C" int koord_preempt_chain(
    const int* alloc, int* requested, const uint8_t* node_valid, int N,
    const int* offsets, const int* rows, const int* cpri, const int* cquota,
    const int* cpdb, const uint8_t* cnonp, const int* creq,
    const int* row_count, int M, uint8_t* valid, uint8_t* cflag,
    uint8_t* cout, int* pkey, const int* reqs, const int* pris,
    const int* qids, const uint8_t* feasible, const uint8_t* same_quota,
    const uint8_t* active, int C, const int* pdb_in, int* pdb_out, int B,
    int quota_mode, const int* headroom, const int* base_hr, int* assumed,
    int Q, int nominate, int commit, int* node_rec, int* nodes_out,
    int* victim_of, int* local, int* partial, int* order, unsigned* arrivals,
    int grid, void* stream) {
  const int qr = quota_mode == kChain ? Q * kDims : 0;
  const int dyn = local_bytes(B, qr);
  if (N < 1 || B < 1 || C < 1 || grid < 1 || commit < 0 || commit > 1 ||
      quota_mode < kNoQuota || quota_mode > kChain ||
      (quota_mode == kHeadroom && headroom == nullptr) ||
      (quota_mode == kChain && (base_hr == nullptr || assumed == nullptr ||
                                Q < 1)) ||
      (!commit && node_rec == nullptr) || (commit && pdb_out == nullptr) ||
      (dyn == 0 && local == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > max_grid(quota_mode, dyn))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const Args a{alloc,    requested,  node_valid, N,         offsets,
               rows,     cpri,       cquota,     cpdb,      cnonp,
               creq,     row_count,  M,          valid,     cflag,
               cout,     pkey,       reqs,       pris,      qids,
               feasible, same_quota, active,     C,         pdb_in,
               pdb_out,  B,          quota_mode, headroom,  base_hr,
               assumed,  Q,          nominate,   commit,    node_rec,
               nodes_out, victim_of, dyn ? nullptr : local, partial,
               order,    arrivals};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(arrivals, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(instance(quota_mode), dim3(grid),
                                    dim3(kThreads), params, dyn, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
