// K6: the quota overuse revoke walks.
//
// Replaces the JAX package's device program
//   koordinator_tpu/quota/overuse_revoke.py:32 select_overuse_victims
// (its two lax.scans over every bound pod, :63-106).  Its plain PyTorch
// version is select_overuse_victims_plain in quota/overuse_revoke.py;
// kernels/overuse_revoke.py holds the wrapper and a Python mirror.
//
// Each scan step reads and writes only its own quota's used vector, so the
// scans split into independent per-quota walks.  Two launches and a sort:
// overuse_keys_kernel keys each row (quota << 32 | priority + 2^31 for a
// candidate: valid, preemptible, not protected by an exhausted PDB; quota
// Q past the last for the others), counts the rows of each quota and its
// PDB-blocked pods (warp-aggregated atomics), and clears the revoke mask;
// the wrapper's one stable sort of the keys lists each quota's candidates
// in ascending importance (priority, then row); then
// overuse_revoke_kernel, a warp a quota (its list's start from the counts
// before it):
//   phase 1: down the list while the quota is over on a checked dim, each
//            pod tentatively removed.  The removals are a prefix, so the
//            walk goes 32 rows a step: the lanes take rows, a warp prefix
//            sum a dimension gives the used before each row's removal (int32
//            sums wrap, exact as modular addition), and a ballot finds the
//            first row where no checked dim is over: the walk stops there;
//   hopeless = still over after the whole list; skipped when the quota also
//            holds a PDB-blocked pod (then no pod goes), else every removed
//            pod goes;
//   phase 2: back up the removed prefix, a pod a step with lane d on
//            dimension d: a pod comes back when used + request <= runtime on
//            every checked dim (or its request is 0 there), one __all_sync.
//            The requests come from shared memory, 32 rows a tile, the next
//            tile's loads issued before the current tile's walk, so no step
//            waits on a global load.
// int32 arithmetic wraps as the reference's does (koord_common.cuh).
//
// What bounds it on the H100: the dependency chain.  It reads each row's
// quota, priority, validity, preemptibility and PDB once and each removed
// pod's request once a phase (bytes), but every step of a quota's reprieve
// depends on the one before: the longest walk (a shared load, the fit and
// one vote a step) sets its floor.  Between the launches, the sort and
// the host's few calls are most of a small call's time.

#include "koord_common.cuh"

namespace {

using koord::kDims;
using koord::wadd;
using koord::wsub;

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowStride = kDims + 1;  // a staged row in shared memory

__device__ __forceinline__ int pick(const int (&v)[kDims], int d) {
  int out = 0;
#pragma unroll
  for (int i = 0; i < kDims; ++i)
    if (i == d) out = v[i];
  return out;
}

constexpr int kKeyThreads = 256;

__global__ void __launch_bounds__(kKeyThreads) overuse_keys_kernel(
    const int* __restrict__ quota, const int* __restrict__ priority,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ nonp,
    const int* __restrict__ pdb_id, const int* __restrict__ pdb_allowed,
    int B, int V, int Q, long long* __restrict__ key,
    int* __restrict__ counts, int* __restrict__ blocked,
    uint8_t* __restrict__ revoke) {
  const int v = blockIdx.x * kKeyThreads + threadIdx.x;
  if (v >= V) return;
  const int q = quota[v];
  bool cand = valid[v] && !nonp[v] && q >= 0;
  // exhausted budgets exclude pods inside the selection (the reference's
  // gather clamps the PDB row)
  const bool blk = pdb_allowed != nullptr && cand && pdb_id[v] >= 0 &&
                   pdb_allowed[min(pdb_id[v], B - 1)] <= 0;
  cand = cand && !blk;
  const int seg = cand && q < Q ? q : Q;
  key[v] = (static_cast<long long>(seg) << 32) |
           (static_cast<long long>(priority[v]) + 2147483648LL);
  const unsigned peers = __match_any_sync(__activemask(), seg);
  if ((__ffs(peers) - 1) == (threadIdx.x & 31))
    atomicAdd(counts + seg, __popc(peers));
  if (blk && q < Q) blocked[q] = 1;
  revoke[v] = 0;
}

__global__ void __launch_bounds__(kWarps * 32) overuse_revoke_kernel(
    const int* __restrict__ requests, const long long* __restrict__ rows,
    const int* __restrict__ counts, const int* __restrict__ blocked, int Q,
    const int* __restrict__ used, const int* __restrict__ runtime,
    const uint8_t* __restrict__ checked, uint8_t* __restrict__ revoke,
    int* __restrict__ walk) {
  __shared__ int s_tile[kWarps][2][32 * kRowStride];
  const int warp = threadIdx.x / 32;
  const int q = blockIdx.x * kWarps + warp;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  int before = 0;
  for (int i = lane; i < q; i += 32) before += counts[i];
  const int start = __reduce_add_sync(kFull, before);
  const int end = start + counts[q];
  // phase 1 keeps every dimension in every lane
  int u[kDims], rt[kDims];
  unsigned ck = 0;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    u[d] = used[q * kDims + d];
    rt[d] = runtime[q * kDims + d];
    ck |= checked[q * kDims + d] ? 1u << d : 0u;
  }

  // phase 1: 32 rows a step
  int k = end - start;  // past the end unless the walk stops
  for (int base = start; base < end; base += 32) {
    const int pos = base + lane;
    const bool in = pos < end;
    const long long row = in ? rows[pos] : 0;
    int r[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      r[d] = in ? requests[row * kDims + d] : 0;
    // inclusive prefix sums, then the used before this row's removal
    int ex[kDims];
    bool over = false;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      unsigned s = static_cast<unsigned>(r[d]);
#pragma unroll
      for (int delta = 1; delta < 32; delta <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, s, delta);
        if (lane >= delta) s += o;
      }
      ex[d] = wsub(static_cast<int>(s), r[d]);
      over |= ((ck >> d) & 1u) && wsub(u[d], ex[d]) > rt[d];
    }
    const unsigned stop = __ballot_sync(kFull, in && !over);
    if (stop) {
      const int s = __ffs(stop) - 1;
      k = base - start + s;
#pragma unroll
      for (int d = 0; d < kDims; ++d)
        u[d] = wsub(u[d], __shfl_sync(kFull, ex[d], s));
      break;
    }
#pragma unroll
    for (int d = 0; d < kDims; ++d)  // the whole chunk removed
      u[d] = wsub(u[d], __shfl_sync(kFull, wadd(ex[d], r[d]), 31));
  }
  if (lane == 0) walk[q] = k;
  bool hopeless = false;
#pragma unroll
  for (int d = 0; d < kDims; ++d)
    hopeless |= ((ck >> d) & 1u) && u[d] > rt[d];
  if (hopeless) {
    // skipped with a blocked pod (every pod comes back), else all go
    if (!blocked[q])
      for (int p = start + lane; p < start + k; p += 32) revoke[rows[p]] = 1;
    return;
  }

  // phase 2: the reprieve, most important first, lane d on dimension d
  const bool dim = lane < kDims;
  int ud = pick(u, lane);
  const int rtd = pick(rt, lane);
  const bool ckd = dim && ((ck >> lane) & 1u);
  int* tile[2] = {s_tile[warp][0], s_tile[warp][1]};
  // tile t holds positions [start + 32 t, start + 32 t + 32) of the prefix
  int t = (k - 1) >> 5;
  long long row = 0;
  int r[kDims];
  auto load = [&](int tt) {
    const int pos = start + tt * 32 + lane;
    const bool in = tt >= 0 && pos < start + k;
    row = in ? rows[pos] : 0;
#pragma unroll
    for (int d = 0; d < kDims; ++d) r[d] = in ? requests[row * kDims + d] : 0;
  };
  auto store = [&](int* s) {
#pragma unroll
    for (int d = 0; d < kDims; ++d) s[lane * kRowStride + d] = r[d];
  };
  if (t >= 0) {
    load(t);
    store(tile[t & 1]);
  }
  long long cur_row = row;
  for (; t >= 0; --t) {
    load(t - 1);  // the next tile's loads, issued before this tile's walk
    __syncwarp();
    const int* s = tile[t & 1];
    const int last = min(31, k - 1 - t * 32);
    unsigned vm = 0;
    for (int i = last; i >= 0; --i) {
      const int rd = dim ? s[i * kRowStride + lane] : 0;
      const bool fit = !dim || rd == 0 || !ckd || wadd(ud, rd) <= rtd;
      if (__all_sync(kFull, fit))
        ud = wadd(ud, rd);
      else
        vm |= 1u << i;
    }
    if ((vm >> lane) & 1u) revoke[cur_row] = 1;
    cur_row = row;
    __syncwarp();
    if (t > 0) store(tile[(t - 1) & 1]);
  }
}

}  // namespace

// K6's first launch: each row's key, the counts of the rows keyed to each
// quota, the PDB-blocked pods of each quota, and the revoke mask cleared.
extern "C" int koord_overuse_keys(const int* quota, const int* priority,
                                  const uint8_t* valid, const uint8_t* nonp,
                                  const int* pdb_id, const int* pdb_allowed,
                                  int B, int V, int Q, long long* key,
                                  int* counts, int* blocked, uint8_t* revoke,
                                  void* stream) {
  if (V < 1 || Q < 1 || (pdb_allowed != nullptr && B < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, (Q + 1) * sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(blocked, 0, (Q + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  overuse_keys_kernel<<<(V + kKeyThreads - 1) / kKeyThreads, kKeyThreads, 0,
                        s>>>(quota, priority, valid, nonp, pdb_id,
                             pdb_allowed, B, V, Q, key, counts, blocked,
                             revoke);
  return static_cast<int>(cudaGetLastError());
}

// K6's second launch, over the rows sorted by their keys.
extern "C" int koord_overuse_revoke(const int* requests,
                                    const long long* rows, const int* counts,
                                    const int* blocked, int Q,
                                    const int* used, const int* runtime,
                                    const uint8_t* checked, uint8_t* revoke,
                                    int* walk, void* stream) {
  if (Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kWarps - 1) / kWarps);
  overuse_revoke_kernel<<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      requests, rows, counts, blocked, Q, used, runtime, checked, revoke,
      walk);
  return static_cast<int>(cudaGetLastError());
}
