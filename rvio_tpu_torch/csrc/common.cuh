// Helpers shared by the kernels of csrc/.  Each .cu builds into its own
// shared library, so the one extern "C" definition below is compiled once
// per library.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* rvio_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace rvio {

// Sums of K values over a block of NT threads (NT a multiple of 32); every
// thread gets the same totals.  `red` holds K * NT / 32 floats of shared
// memory.
template <int K, int NT>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  constexpr int NW = NT / 32;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();                      // red may still be read by a prior call
  if (l == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * NW + w] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) s += red[k * NW + i];
    v[k] = s;
  }
}

// Bilinear sample of tap (a, b) of a window of radius r centred at (ly, lx)
// in a TH x TW tile, the tap's support clipped to [0, TH-2] x [0, TW-2]:
// one tap of the oracle's _sample_patches (rvio_tpu/frontend/klt.py:96-147).
__device__ __forceinline__ float sample_tap(const float* T, int TH, int TW,
                                            float ly, float lx, int a, int b,
                                            int r) {
  const float fy0 = floorf(ly), fx0 = floorf(lx);
  const float wy = ly - fy0, wx = lx - fx0;
  const int i = min(max((int)fy0 - r + a, 0), TH - 2);
  const int j = min(max((int)fx0 - r + b, 0), TW - 2);
  const float* p = T + i * TW + j;
  const float r0 = p[0] * (1.f - wy) + p[TW] * wy;
  const float r1 = p[1] * (1.f - wy) + p[TW + 1] * wy;
  return r0 * (1.f - wx) + r1 * wx;
}

}  // namespace rvio
