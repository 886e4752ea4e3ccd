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

}  // namespace koord
