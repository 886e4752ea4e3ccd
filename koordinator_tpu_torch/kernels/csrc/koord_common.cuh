// Shared helpers of the port's kernels: int32 arithmetic that wraps the way
// the JAX reference's int32 arrays wrap.  Signed overflow is undefined in
// C++, so every product and sum that could leave int32 goes through uint32
// and back (two's complement, as XLA and PyTorch both compute it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace koord {

// Resource dimensions of every (.., R) tensor (api/resources.py).
constexpr int kDims = 10;

__host__ __device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__host__ __device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__host__ __device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// Floor division (Python's and torch's //) for b > 0.
__device__ __forceinline__ int fdiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// Floor modulo (Python's and torch's %) for n > 0.  C's % truncates, so a
// negative a needs the correction.
__device__ __forceinline__ int fmod_floor(int a, int n) {
  int m = a % n;
  return m < 0 ? m + n : m;
}

// The ranking key's regimes (kernels/select_candidates.py): up to 2^15 node
// rows one packed int32 key (quantized score << 15 | tie-break); past it,
// the wide regime, (quantized score, tie-break), up to 2^30 node rows.
constexpr int kTbBits = 15;
constexpr int kPackedNodeCapacity = 1 << kTbBits;
constexpr int kWideTbBits = 30;

// Rotated tie-break of _rank_parts: (N-1) - ((n - rot*7919) mod N), with the
// product and difference wrapping in int32 and the mod floored.
__device__ __forceinline__ int tie_break(int n, int rot7919, int N) {
  return (N - 1) - fmod_floor(wsub(n, rot7919), N);
}

}  // namespace koord
