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
//
// Orders past 64 (windows of 33 or more measurements) take the wide
// instance, quadform_wide_kernel: a block of 512 threads a feature, the
// lower triangle of S packed row by row (m (m + 1) / 2 floats, 34 KB at
// m = 130) and r in dynamic shared memory.  It runs the same interleaved
// Cholesky and forward substitution: step j takes the pivot of row j,
// y_j and its square, then each warp updates rows i > j (a row a warp in
// turn, its entries over the lanes): r_i and the row's entries
// j < k <= i by l_i l_k, l = column j over the pivot; one barrier a step:
// 43 us a launch at m = 66 and 158 at m = 130 over 100 features, the
// m steps' barriers and row loops (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).  Where the triangle does not fit a block's shared memory
// (m above about 330 on the H100), it lives in a workspace of device
// memory the wrapper allocates on the caller's stream
// (rvio_spd_quadform_workspace says how much), which a CUDA graph captures
// from its pool.  The NaN semantics are the narrow instances'.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;                  // features a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int WIDE_NT = 512;              // threads of a wide block

__host__ __device__ __forceinline__ size_t tri_floats(int m) {
  return static_cast<size_t>(m) * (m + 1) / 2;
}

// D for feature blockIdx.x at any order m: y (r, then the forward
// substitution) in shared memory, the packed lower triangle of S in shared
// memory after it, or at ws + f tri_floats(m) where ws is not null.
__global__ void __launch_bounds__(WIDE_NT) quadform_wide_kernel(
    const float* __restrict__ S, const float* __restrict__ r,
    float* __restrict__ D, float* ws, int m) {
  extern __shared__ __align__(16) float wsh[];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* y = wsh;
  float* a = ws ? ws + static_cast<size_t>(f) * tri_floats(m)
                : wsh + ((m + 3) & ~3);
  const float* Sf = S + static_cast<size_t>(f) * m * m;
  for (int i = tid; i < m; i += WIDE_NT)
    y[i] = __ldg(r + static_cast<size_t>(f) * m + i);
  for (int i = warp; i < m; i += WIDE_NT / 32) {
    float* ai = a + tri_floats(i);
    for (int k = lane; k <= i; k += 32)
      ai[k] = __ldg(Sf + static_cast<size_t>(i) * m + k);
  }
  __syncthreads();
  float acc = 0.f;                // sum of y_j^2, the same in every thread
  for (int j = 0; j < m; ++j) {
    // step j reads row j's pivot, y_j and column j, and writes only the
    // entries right of column j of the rows below it, and their y: a row a
    // warp, its entries over the lanes
    const float rs = rsqrtf(a[tri_floats(j) + j]);
    const float yj = y[j] * rs;
    acc = fmaf(yj, yj, acc);
    for (int i = j + 1 + warp; i < m; i += WIDE_NT / 32) {
      float* ai = a + tri_floats(i);
      const float li = ai[j] * rs;
      if (lane == 0) y[i] = fmaf(-li, yj, y[i]);
      for (int k = j + 1 + lane; k <= i; k += 32)
        ai[k] = fmaf(-li, a[tri_floats(k) + j] * rs, ai[k]);
    }
    __syncthreads();
  }
  if (tid == 0) D[f] = acc;
}

// Raises the wide instance's dynamic shared memory limit to `smem` bytes
// on the current device where it is lower, once per device and size (the
// first launch of a window runs eagerly, outside any graph capture).  A
// refusal is taken off the runtime's last-error state.
int configure_wide(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static size_t configured[MAX_DEVICES] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(quadform_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    configured[dev] = smem;
  }
  return 0;
}

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

// Floats of device workspace the wide instance needs a feature at order m
// on the current device: 0 where the triangle fits a block's shared memory
// (and for m <= 64, which the narrow instances take).
int rvio_spd_quadform_workspace(long long* out, int m, cudaStream_t) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  *out = 0;
  if (m <= 64) return 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = sizeof(float) * (((m + 3) & ~3) + tri_floats(m));
  if (smem > static_cast<size_t>(optin))
    *out = static_cast<long long>(tri_floats(m));
  return 0;
}

// D for F features of order m; ws: rvio_spd_quadform_workspace(m) floats a
// feature, or null where that is 0.
int rvio_spd_quadform_ws(const float* S, const float* r, float* D, float* ws,
                         int F, int m, cudaStream_t stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  if (m > 64) {
    long long need = 0;
    int e = rvio_spd_quadform_workspace(&need, m, stream);
    if (e) return e;
    if (need && !ws) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        sizeof(float) * (((m + 3) & ~3) + (need ? 0 : tri_floats(m)));
    e = configure_wide(smem);
    if (e) return e;
    quadform_wide_kernel<<<F, WIDE_NT, smem, stream>>>(S, r, D,
                                                      need ? ws : nullptr, m);
    return static_cast<int>(cudaGetLastError());
  }
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
