// Batched SPD quadratic form D[f] = r[f]^T S[f]^-1 r[f] (the MSCKF chi2 gate).
//
// Replaces rvio_tpu/ops/spd_solve.py (batched_quadform_pallas /
// _quadform_kernel).  One thread block per feature: S (m x m, m = 2L = 30,
// 3.6 KB) and r sit in shared memory; a right-looking Cholesky interleaved
// with the forward substitution gives y = L^-1 r and D = y^T y.  Each step j
// updates the trailing (m-j-1)^2 block in parallel, one barrier per step.
//
// A negative pivot makes sqrtf return NaN and a zero pivot divides by zero;
// either way D is NaN (never clamped), so the caller's D < threshold gate
// rejects that feature while the other blocks are untouched.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void quadform_kernel(const float* __restrict__ S,
                                const float* __restrict__ r,
                                float* __restrict__ D, int m) {
  extern __shared__ float sh[];
  float* T = sh;            // m * m, the trailing matrix
  float* rv = sh + m * m;   // m, the forward-substitution right-hand side
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int mm = m * m;
  for (int idx = tid; idx < mm; idx += blockDim.x) T[idx] = S[(size_t)f * mm + idx];
  for (int i = tid; i < m; i += blockDim.x) rv[i] = r[(size_t)f * m + i];
  __syncthreads();

  float acc = 0.f;          // running sum of y_j^2 (thread 0)
  for (int j = 0; j < m; ++j) {
    // column j and rv[j] are not written during step j: no hazard
    const float dj = sqrtf(T[j * m + j]);            // L[j, j]
    const float yj = rv[j] / dj;                     // y_j
    for (int idx = tid; idx < mm; idx += blockDim.x) {
      const int i = idx / m, k = idx - i * m;
      if (i > j && k > j)
        T[idx] -= (T[i * m + j] / dj) * (T[k * m + j] / dj);
    }
    for (int i = tid; i < m; i += blockDim.x)
      if (i > j) rv[i] -= (T[i * m + j] / dj) * yj;
    if (tid == 0) acc += yj * yj;
    __syncthreads();
  }
  if (tid == 0) D[f] = acc;
}

}  // namespace

extern "C" {

int rvio_spd_quadform(const float* S, const float* r, float* D, int F, int m,
                      cudaStream_t stream) {
  if (F == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(m * m + m);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(quadform_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  quadform_kernel<<<F, 256, smem, stream>>>(S, r, D, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
