// Helpers shared by the kernels of csrc/.  Each .cu builds into its own
// shared library, so the one extern "C" definition below is compiled once
// per library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr unsigned FULL_MASK = 0xffffffffu;

// Product, sum and difference, each rounded to nearest on its own (no FMA
// contraction), as the plain versions' element-wise tensor operations
// round them.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The sum of v over a warp, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 1-D bulk copy of `bytes` (16-byte aligned, a multiple of 16) from
// device memory into this CTA's shared memory, reporting to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Initialise the one-arrival mbarrier `bar` and arrive on it, expecting
// `bytes` of bulk copies (one thread).
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for phase 0 of `bar` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile("{\n\t.reg .pred p;\n\tWAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n\t"
               "@!p bra WAIT;\n\t}" ::"r"(smem_addr(bar)) : "memory");
}

}  // namespace rvio
