// Batched SPD quadratic form D[f] = r[f]^T S[f]^-1 r[f] (the MSCKF chi2
// gate, K4).
//
// Replaces rvio_tpu/ops/spd_solve.py (batched_quadform_pallas /
// _quadform_kernel).  A Cholesky factorization S = L L^T interleaved with
// the forward substitution y = L^-1 r gives D = y^T y.
//
// Bound on the H100 at the operating point (F = 100, m = 2L = 30, f32): the
// call reads the lower triangle of S and r and writes D, 198 KB (0.059 us
// at 3.35 TB/s), and needs about 1 MFLOP: far below a launch, so the time
// is the latency of m dependent steps.  The first design gave each feature
// a block of 256 threads over S in shared memory: every step walked all
// m^2 entries with an integer division, two f32 divisions per entry and a
// block barrier, about 1.8 thousand cycles a step, 45.57 us a launch
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).  This design gives each
// feature one warp and keeps S in registers: lane i holds row i of the
// lower triangle and r_i (and row i + 32, for m up to 64), loaded once,
// fully unrolled on the padded order NP (8, 16, 32 or 64; rows beyond m
// are the identity, so they change nothing).  Step j costs one rsqrtf of
// the pivot, broadcast by a shuffle; column j scaled once in each lane;
// each lane's rank-1 update of its own row and the forward-substitution
// update of its r_i; no division and no block barrier.  The next column's
// update, pivot (taken from the diagonal's own lane), rsqrtf and y_{j+1}
// come first, so that dependent chain overlaps the trailing update.
// The trailing update reads column j from a per-warp buffer in shared
// memory, four entries a broadcast load, where a shuffle a row was slower
// (scripts/filter_kernel_phases.py).  Every lane accumulates the same sum
// of y_j^2; lane 0 writes D.  Four features a block, so F = 100 spreads
// over 25 SMs.
//
// A negative pivot (an indefinite S) makes rsqrtf NaN, and the NaN reaches
// D for that feature alone, as the plain version's NaN on a failed
// factorization does.  A pivot of exactly zero gives +inf or NaN (rsqrtf(0)
// is +inf); the caller's D < threshold gate (filter/update.py) rejects
// either.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;                  // features a block
constexpr unsigned FULL = 0xffffffffu;

// D for features blockIdx.x * WARPS + warp; NP >= m, a power of two.
template <int NP>
__global__ void __launch_bounds__(32 * WARPS) quadform_kernel(
    const float* __restrict__ S, const float* __restrict__ r,
    float* __restrict__ D, int F, int m) {
  constexpr int R = NP > 32 ? 2 : 1;      // rows a lane: i = lane + 32 q
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (f >= F) return;

  // phase: load
  // a[q][k] = S[i][k] for k <= i (a row i < 32 ends before k = 32); the
  // entries right of the diagonal start at 0 and are never read
  const float* Sf = S + (size_t)f * m * m;
  float a[R][NP], b[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    const bool in = i < m;
    b[q] = in ? __ldg(r + (size_t)f * m + i) : 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (q == 0 && k >= 32) break;
      a[q][k] = (in && k <= i) ? __ldg(Sf + (size_t)i * m + k)
                               : (k == i ? 1.f : 0.f);
    }
  }

  // phase: factor and substitute
  __shared__ __align__(16) float cols[WARPS][64];   // column j, per warp
  float* col = cols[threadIdx.x >> 5];
  // Step j starts with column j of L in l (rows > j; row j's lane holds
  // L[j][j]), its reciprocal pivot rs and y_j.  It first finishes column
  // j + 1 (its update by column j, the pivot from the diagonal's own lane,
  // rsqrtf, y_{j+1}), so that chain runs ahead of the trailing update
  // of columns j + 2 .. by column j, which then hides its latency.
  float acc = 0.f;                    // sum of y_j^2, the same in every lane
  float rs = rsqrtf(__shfl_sync(FULL, a[0][0], 0));
  float yj = __shfl_sync(FULL, b[0], 0) * rs;
  float l[R];
#pragma unroll
  for (int q = 0; q < R; ++q) l[q] = a[q][0] * rs;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j >= m) break;
    acc = fmaf(yj, yj, acc);
#pragma unroll
    for (int q = 0; q < R; ++q) b[q] = fmaf(-l[q], yj, b[q]);
    float l1[R] = {}, rs1 = 0.f, y1 = 0.f;
    if (j + 1 < NP) {
      const int k = j + 1, qk = k >> 5;
      // row k's updated diagonal, in its own lane (its broadcast entry of
      // column j is its own l)
      const float dk = fmaf(-l[qk], l[qk], a[qk][k]);
      const float lk = __shfl_sync(FULL, l[qk], k & 31);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (!(q == 0 && k >= 32)) a[q][k] = fmaf(-l[q], lk, a[q][k]);
      rs1 = rsqrtf(__shfl_sync(FULL, dk, k & 31));
      y1 = __shfl_sync(FULL, b[qk], k & 31) * rs1;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        l1[q] = 0.f;
        if (!(q == 0 && k >= 32)) l1[q] = a[q][k] * rs1;
      }
    }
    // the trailing update by column j, read from the warp's buffer (no
    // early exit at m: a break here would put each load in its own basic
    // block and serialize their latencies; rows past m have l = 0)
#pragma unroll
    for (int q = 0; q < R; ++q) col[32 * q + lane] = l[q];
    __syncwarp();
#pragma unroll
    for (int c4 = (j + 2) / 4; c4 < NP / 4; ++c4) {
      const float4 v = reinterpret_cast<const float4*>(col)[c4];
      const float lv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * c4 + t;
        if (k < j + 2) continue;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (!(q == 0 && k >= 32)) a[q][k] = fmaf(-l[q], lv[t], a[q][k]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < R; ++q) l[q] = l1[q];
    rs = rs1;
    yj = y1;
  }

  // phase: store
  if (lane == 0) D[f] = acc;
}

}  // namespace

extern "C" {

int rvio_spd_quadform(const float* S, const float* r, float* D, int F, int m,
                      cudaStream_t stream) {
  if (F == 0) return 0;
  if (m < 1 || m > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (F + WARPS - 1) / WARPS;
  if (m <= 8)
    quadform_kernel<8><<<blocks, 32 * WARPS, 0, stream>>>(S, r, D, F, m);
  else if (m <= 16)
    quadform_kernel<16><<<blocks, 32 * WARPS, 0, stream>>>(S, r, D, F, m);
  else if (m <= 32)
    quadform_kernel<32><<<blocks, 32 * WARPS, 0, stream>>>(S, r, D, F, m);
  else
    quadform_kernel<64><<<blocks, 32 * WARPS, 0, stream>>>(S, r, D, F, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
