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
// Orders from 64 on (windows of 32 or more measurements) take the wide
// instance, quadform_wide_kernel: one block of 512 threads a feature, a
// blocked right-looking Cholesky of S in panels of PB = 32 columns, with r
// carried as one more row below S, so the panels' forward substitution
// gives y = L^-1 r as the factorization goes and D = sum y_j^2.
//   - Warp 0 factors each 32 x 32 diagonal block in registers with the
//     narrow instances' step (rsqrtf of the pivot, shuffles, no block
//     barrier), two columns of look-ahead deep, r's 32 entries beside it,
//     and leaves the block's columns of L (lt) and reciprocal pivots
//     (rinv) in shared memory.  It loads its first block itself and
//     factors it while the other warps load the rest of S.
//   - Twelve "panel warps" (those that do not share warp 0's scheduler)
//     solve the rows below the block against it, a row a thread, eight
//     columns at a time as warp 0 publishes them (named barriers:
//     bar.arrive in warp 0, bar.sync in the panel warps), into a
//     transposed panel (lp).
//   - Each panel then takes a barrier; every warp updates the next
//     diagonal block (2 x 2 tiles, the panel's 32 products read from lp)
//     and r's next 32 entries; a barrier; warp 0 factors that block while
//     the panel warps update the rest of the trailing lower triangle (4 x 4
//     tiles by float4 reads, no triangular index) and r, meet at a named
//     barrier, and solve the next panel as its columns come.  Two block
//     barriers a panel: 9 at m = 130 (130 before).
// S lives in shared memory as a square with an odd stride (m | 1: a column
// read over the lanes meets every bank once) while it fits (m <= 224 on
// the H100), then as the packed lower triangle (m <= 308), and past that,
// with the panel and r, in a workspace of device memory the wrapper
// allocates on the caller's stream (rvio_spd_quadform_workspace says how
// much), which a CUDA graph captures from its pool.  The NaN semantics
// are the narrow instances': a negative pivot makes rsqrtf NaN and the NaN
// reaches D.  13.0 us a launch at m = 66 and 24.2 at m = 130 over 100
// features, against 43.4 and 158.5 for the one-barrier-a-pivot design
// before it; the diagonal blocks' 32-step register factor is most of it
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;                  // features a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int WIDE_NT = 512;              // threads of a wide block
constexpr int PB = 32;                    // panel width of the wide instance
constexpr int FIXED_SHARED = PB * PB + PB;   // lt and rinv, floats

__host__ __device__ __forceinline__ size_t tri_floats(int m) {
  return static_cast<size_t>(m) * (m + 1) / 2;
}

__host__ __device__ __forceinline__ size_t round4(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);
}

// the rows of the transposed panel lp: the rows below the first panel,
// rounded up to whole float4
__host__ __device__ __forceinline__ int panel_rows(int m) {
  return static_cast<int>(round4(m > PB ? m - PB : 1));
}

// lp and r, then S: the floats a feature needs beside lt and rinv
__host__ __device__ __forceinline__ size_t wide_floats(int m, bool square) {
  return static_cast<size_t>(PB) * panel_rows(m) + round4(m) +
         round4(square ? static_cast<size_t>(m) * (m | 1) : tri_floats(m));
}

template <bool SQ>
__device__ __forceinline__ size_t at(int i, int k, int ld) {
  return SQ ? static_cast<size_t>(i) * ld + k : tri_floats(i) + k;
}

// The wide instance's roles.  Warp 0 factors the diagonal blocks; the
// warps that share its SM sub-partition (warp % 4 == 0 on the H100's four
// schedulers) stay idle while it does, so its steps get every issue slot;
// the other twelve ("panel warps") update the trailing matrix and solve
// the panels.  Named barriers: CHUNK_BAR + c (c = 0..3) publishes columns
// 8c .. 8c + 7 of a diagonal block from warp 0 (bar.arrive) to the panel
// warps (bar.sync); PANEL_BAR joins the panel warps; LOAD_BAR every warp
// but warp 0.
constexpr int PANEL_WARPS = 12;
constexpr int CHUNK_BAR = 1, PANEL_BAR = 5, LOAD_BAR = 6;
constexpr int CHUNK_COUNT = 32 * (PANEL_WARPS + 1);

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Warp 0: the diagonal block of columns c0 .. c0 + 31 (rows past m are the
// identity) with r's entries beside it, by quadform_kernel<32>'s step with
// a look-ahead two columns deep: step j updates columns j + 1 and j + 2 by
// column j through shuffles and the rest through the column in shared
// memory, so the next pivot waits on no shared-memory round trip.  Leaves
// L[c0 + k][c0 + j] in lt[32 j + k] (k > j), 1 / L[c0 + j][c0 + j] in
// rinv[j] and y_{c0 + j} in yv, adds y_j^2 to acc, and, where `publish`
// (rows lie below the block), hands each 8 columns to the panel warps.
template <bool SQ>
__device__ __forceinline__ void factor_block(const float* a, int ld,
                                             float* yv, float* lt,
                                             float* rinv, int c0, int m,
                                             int lane, bool publish,
                                             float& acc) {
  const int i = c0 + lane, n = min(PB, m - c0);
  const bool in = i < m;
  float b = in ? yv[i] : 0.f;
  float x[PB];
#pragma unroll
  for (int k = 0; k < PB; ++k)
    x[k] = (in && k <= lane) ? a[at<SQ>(i, c0 + k, ld)]
                             : (k == lane ? 1.f : 0.f);
  float rs = rsqrtf(__shfl_sync(FULL, x[0], 0));
  float yj = __shfl_sync(FULL, b, 0) * rs;
  float l = x[0] * rs;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    if (j >= n) break;
    acc = fmaf(yj, yj, acc);
    b = fmaf(-l, yj, b);
    if (lane == 0) {
      rinv[j] = rs;
      yv[c0 + j] = yj;
    }
    float* col = lt + PB * j;
    col[lane] = l;
    if (j + 2 < PB) x[j + 2] = fmaf(-l, __shfl_sync(FULL, l, j + 2), x[j + 2]);
    float l1 = 0.f, rs1 = 0.f, y1 = 0.f;
    if (j + 1 < PB) {
      const int k = j + 1;
      const float dk = fmaf(-l, l, x[k]);
      const float lk = __shfl_sync(FULL, l, k);
      x[k] = fmaf(-l, lk, x[k]);
      rs1 = rsqrtf(__shfl_sync(FULL, dk, k));
      y1 = __shfl_sync(FULL, b, k) * rs1;
      l1 = x[k] * rs1;
    }
    __syncwarp();
    if ((j & 7) == 7 && publish) bar_arrive(CHUNK_BAR + j / 8, CHUNK_COUNT);
#pragma unroll
    for (int c4 = (j + 3) / 4; c4 < PB / 4; ++c4) {
      const float4 v = reinterpret_cast<const float4*>(col)[c4];
      const float lv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * c4 + t;
        if (k >= j + 3) x[k] = fmaf(-l, lv[t], x[k]);
      }
    }
    l = l1;
    rs = rs1;
    yj = y1;
  }
}

// The panel warps (rank pw of PANEL_WARPS * 32): the rows below the
// diagonal block of columns c0 .. c0 + 31, each solved against the block's
// L eight columns at a time as warp 0 publishes them, and stored into the
// transposed panel lp[j * nrp + t] (row c0 + 32 + t); a row's entries
// right of the chunk go back to a between chunks.
template <bool SQ>
__device__ __forceinline__ void solve_panel(float* a, int ld,
                                            const float* lt,
                                            const float* rinv, float* lp,
                                            int nrp, int c0, int m, int pw) {
  const int nr = m - c0 - PB;
#pragma unroll
  for (int c = 0; c < PB / 8; ++c) {
    bar_sync(CHUNK_BAR + c, CHUNK_COUNT);
    for (int t = pw; t < nr; t += 32 * PANEL_WARPS) {
      const int i = c0 + PB + t;
      float x[PB];
#pragma unroll
      for (int k = 8 * c; k < PB; ++k) x[k] = a[at<SQ>(i, c0 + k, ld)];
#pragma unroll
      for (int j = 8 * c; j < 8 * c + 8; ++j) {
        x[j] *= rinv[j];
        const float4* col = reinterpret_cast<const float4*>(lt + PB * j);
#pragma unroll
        for (int c4 = (j + 1) / 4; c4 < PB / 4; ++c4) {
          const float4 v = col[c4];
          const float lv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = 4 * c4 + u;
            if (k > j) x[k] = fmaf(-x[j], lv[u], x[k]);
          }
        }
        lp[j * nrp + t] = x[j];
      }
#pragma unroll
      for (int k = 8 * c + 8; k < PB; ++k) a[at<SQ>(i, c0 + k, ld)] = x[k];
    }
  }
}

// The tiles of the lower triangle below a panel (rows and columns from b0)
// numbered row by row, (ti, tk) with tk <= ti, for tile t.
__device__ __forceinline__ void tile_index(int t, int& ti, int& tk) {
  ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tk = t - ti * (ti + 1) / 2;
}

// Tile t of T x T entries: the entries less the panel's 32 products, read
// from lp by float4 (T = 4) or float2 (T = 2).
template <bool SQ, int T>
__device__ __forceinline__ void tile_update(float* a, int ld, const float* lp,
                                            int nrp, int b0, int m, int t) {
  using V = typename std::conditional<T == 4, float4, float2>::type;
  int ti, tk;
  tile_index(t, ti, tk);
  float s[T][T] = {};
#pragma unroll 8
  for (int j = 0; j < PB; ++j) {
    const V* row = reinterpret_cast<const V*>(lp + j * nrp);
    const V vi = row[ti], vk = row[tk];
    const float* li = reinterpret_cast<const float*>(&vi);
    const float* lk = reinterpret_cast<const float*>(&vk);
#pragma unroll
    for (int p = 0; p < T; ++p)
#pragma unroll
      for (int q = 0; q < T; ++q) s[p][q] = fmaf(li[p], lk[q], s[p][q]);
  }
#pragma unroll
  for (int p = 0; p < T; ++p) {
    const int i = b0 + T * ti + p;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int k = b0 + T * tk + q;
      if (i < m && k <= i) a[at<SQ>(i, k, ld)] -= s[p][q];
    }
  }
}

// r's entry k (k >= b0) less the panel's products with y_c0 .. y_c0+31.
__device__ __forceinline__ void r_update(float* yv, const float* lp, int nrp,
                                         int c0, int b0, int k) {
  float s = 0.f;
#pragma unroll 8
  for (int j = 0; j < PB; ++j) s = fmaf(yv[c0 + j], lp[j * nrp + k - b0], s);
  yv[k] -= s;
}

// D for feature blockIdx.x at any order m: lt and rinv in shared memory,
// then lp, r (carried into y) and S, in shared memory after them or at
// ws + f wide_floats(m, SQ) where ws is not null.
template <bool SQ>
__global__ void __launch_bounds__(WIDE_NT) quadform_wide_kernel(
    const float* __restrict__ S, const float* __restrict__ r,
    float* __restrict__ D, float* ws, int m) {
  extern __shared__ __align__(16) float wsh[];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool panel_warp = (warp & 3) != 0;
  const int pw = (warp - (warp >> 2) - 1) * 32 + lane;   // panel warp rank
  const int ld = m | 1, nrp = panel_rows(m);
  float* lt = wsh;
  float* rinv = lt + PB * PB;
  float* lp = ws ? ws + static_cast<size_t>(f) * wide_floats(m, SQ)
                 : rinv + PB;
  float* yv = lp + static_cast<size_t>(PB) * nrp;
  float* a = yv + round4(m);
  const float* Sf = S + static_cast<size_t>(f) * m * m;
  const float* rf = r + static_cast<size_t>(f) * m;
  float acc = 0.f;                // sum of y_j^2, in warp 0
  // step: load; warp 0 its first diagonal block, then factors it while the
  // others load the rest and the panel warps solve the first panel
  if (warp == 0) {
    for (int i = 0; i < min(PB, m); ++i)
      if (lane <= i) a[at<SQ>(i, lane, ld)] = __ldg(Sf + i * m + lane);
    if (lane < m) yv[lane] = __ldg(rf + lane);
    __syncwarp();
    factor_block<SQ>(a, ld, yv, lt, rinv, 0, m, lane, PB < m, acc);
  } else {
    for (int i = PB + tid - 32; i < m; i += WIDE_NT - 32) yv[i] = __ldg(rf + i);
    for (int i = PB + warp - 1; i < m; i += WIDE_NT / 32 - 1)
      for (int k = lane; k <= i; k += 32)
        a[at<SQ>(i, k, ld)] = __ldg(Sf + static_cast<size_t>(i) * m + k);
    bar_sync(LOAD_BAR, WIDE_NT - 32);
    if (panel_warp && PB < m)
      solve_panel<SQ>(a, ld, lt, rinv, lp, nrp, 0, m, pw);
  }
  __syncthreads();
  for (int c0 = 0; c0 + PB < m; c0 += PB) {
    const int b0 = c0 + PB, nr = m - b0;
    // step: the next diagonal block (2 x 2 tiles) and r's next 32 entries,
    // every warp
    const int nb2 = (min(PB, nr) + 1) / 2;
    for (int t = tid; t < nb2 * (nb2 + 1) / 2; t += WIDE_NT)
      tile_update<SQ, 2>(a, ld, lp, nrp, b0, m, t);
    if (warp == WIDE_NT / 32 - 1 && lane < nr)
      r_update(yv, lp, nrp, c0, b0, b0 + lane);
    __syncthreads();
    // step: warp 0 factors the block; the panel warps update the rest of
    // the trailing matrix (4 x 4 tiles past the block) and r, then solve
    // the next panel as its columns come
    const bool below = b0 + PB < m;
    if (warp == 0) {
      factor_block<SQ>(a, ld, yv, lt, rinv, b0, m, lane, below, acc);
    } else if (panel_warp) {
      const int nt = (nr + 3) / 4, nd4 = min(nt, PB / 4);
      for (int t = nd4 * (nd4 + 1) / 2 + pw; t < nt * (nt + 1) / 2;
           t += 32 * PANEL_WARPS)
        tile_update<SQ, 4>(a, ld, lp, nrp, b0, m, t);
      for (int k = b0 + PB + pw; k < m; k += 32 * PANEL_WARPS)
        r_update(yv, lp, nrp, c0, b0, k);
      bar_sync(PANEL_BAR, 32 * PANEL_WARPS);
      if (below) solve_panel<SQ>(a, ld, lt, rinv, lp, nrp, b0, m, pw);
    }
    __syncthreads();
  }
  if (tid == 0) D[f] = acc;
}

// The wide instance's storage at order m on the current device: S as the
// square (true) or the packed triangle, the dynamic shared memory in bytes
// and the workspace floats a feature (0: all in shared memory).
struct WidePlan {
  bool square;
  size_t smem;
  size_t ws;
};

int wide_plan(int m, WidePlan& p) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t cap = static_cast<size_t>(optin) / sizeof(float);
  if (FIXED_SHARED + wide_floats(m, true) <= cap)
    p = {true, sizeof(float) * (FIXED_SHARED + wide_floats(m, true)), 0};
  else if (FIXED_SHARED + wide_floats(m, false) <= cap)
    p = {false, sizeof(float) * (FIXED_SHARED + wide_floats(m, false)), 0};
  else
    p = {false, sizeof(float) * FIXED_SHARED, wide_floats(m, false)};
  return 0;
}

// Raises an instance's dynamic shared memory limit to `smem` bytes on the
// current device where it is lower, once per device and size (the first
// launch of a window runs eagerly, outside any graph capture).  A refusal
// is taken off the runtime's last-error state.
template <bool SQ>
int configure_wide(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static size_t configured[MAX_DEVICES] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(quadform_wide_kernel<SQ>,
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
// on the current device: 0 where it keeps everything in shared memory.
int rvio_spd_quadform_workspace(long long* out, int m, cudaStream_t) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  WidePlan p;
  const int e = wide_plan(m, p);
  if (e) return e;
  *out = static_cast<long long>(p.ws);
  return 0;
}

// D for F features of order m by `route` (the wrapper's dispatch,
// ops/spd_solve.py `instance`): 0 a warp instance (m <= 64), 1 the wide
// instance (any m).  ws: rvio_spd_quadform_workspace(m) floats a feature,
// or null where that is 0.
int rvio_spd_quadform_route(const float* S, const float* r, float* D,
                            float* ws, int F, int m, int route,
                            cudaStream_t stream) {
  if (m < 1 || route < 0 || route > 1 || (route == 0 && m > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  if (route == 1) {
    WidePlan p;
    int e = wide_plan(m, p);
    if (e) return e;
    if (p.ws && !ws) return static_cast<int>(cudaErrorInvalidValue);
    if (p.square) {
      e = configure_wide<true>(p.smem);
      if (e) return e;
      quadform_wide_kernel<true><<<F, WIDE_NT, p.smem, stream>>>(S, r, D,
                                                                 nullptr, m);
    } else {
      e = configure_wide<false>(p.smem);
      if (e) return e;
      quadform_wide_kernel<false><<<F, WIDE_NT, p.smem, stream>>>(
          S, r, D, p.ws ? ws : nullptr, m);
    }
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
