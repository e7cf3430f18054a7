// K5's wide route: the MSCKF update's dense tail for windows whose n
// (6 x the clones) is past what csrc/ekf_tail.cu keeps in one CTA's shared
// memory (n > 92: windows of 16 or more clones).
//
// Replaces rvio_tpu/ops/ekf_tail.py (ekf_tail_pallas / _ekf_tail_kernel),
// which takes any n.  It computes what csrc/ekf_tail.cu computes, the
// port's unfused chain (ops/ekf_tail.py cholesky_tail), in the chain's own
// order of operations:
//
//   1. C + 1e-8 max(tr C, 1) I, lower Cholesky Lc; where a pivot is <= 0 or
//      not finite, C + n eps_f32 max(tr C, 1) I instead and `fallback` set;
//      if that fails too, dx and P_new are NaN;
//   2. rn = Lc^-1 b, Hn = [0 | Lc^T];
//   3. P Hn^T = P[:, 24:] Lc;
//   4. S = Lc^T (P Hn^T)[24:, :] + sig2 I, (S + S^T) / 2 and its Cholesky
//      Ls, NaN results where it fails;
//   5. K = P Hn^T Ls^-T Ls^-1, dx = K rn;
//   6. E = I - K Hn (its live columns I - K Lc^T), X = (E P) E^T +
//      sig2 K K^T, P_new = (X + X^T) / 2.
//
// csrc/ekf_tail.cu takes step 6 as A P = P - G P[24:, :] and
// X = A P - (A P)[:, 24:] G^T (G = K Lc^T) and skips the symmetrization
// of S: the same function, but where the update observes the state it
// subtracts nearly equal products, which in f32 costs the small,
// well-observed entries of P_new digits that grow with n; the chain's
// order forms the small E first (tests/test_torch_wide_windows.py
// measures both orders against f64).
//
// Bound on the H100: at n = 96 (D = 120) about 11 MFLOP and 0.17 us at
// 67 TFLOP/s, at n = 384 (D = 408) 573 MFLOP and 8.6 us
// (ops/checks.ekf_tail_flops); the bytes are smaller still.  What holds a
// system back is the chain of dependent steps of two factorizations and two
// triangular solves, and, at large n, the products on the 8 SMs of one
// cluster.
//
// Design, written from the math (the narrow kernel's layout in one CTA's
// shared memory does not scale: C and P alone are 1.26 MB at n = 384).
// 199 us a launch at n = 96, 575 at 192, 2527 at 384, against the unfused
// chain's 264, 367 and 783 us on the device (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py): the products run on one cluster's 8 SMs, and each of
// its 250-odd phases at n = 384 waits on a cluster barrier and a round
// trip to L2.
// - One cluster of CL = 8 CTAs of 256 threads a system (B systems, one
//   launch), as the narrow kernel; the CTAs meet at cluster barriers
//   (barrier.cluster, release and acquire at cluster scope) between
//   phases, and every intermediate lives in a device workspace the wrapper
//   allocates a call (`Layout`: about 3.8 MB a system at n = 384), read
//   and written through L2 (ld.global.cg / st.global.cg), which every SM
//   of the cluster sees alike.
// - The rn solve and the first triangular solve of the gain ride on the
//   factorizations: b^T is one more row below C, and P Hn^T's D rows are
//   more rows below S, so the factor's rows below the square are
//   b^T Lc^-T = rn^T and P Hn^T Ls^-T.  A factorization runs in panels of
//   8 columns: every thread of the cluster factors the 8 x 8 diagonal block
//   from L2 in its registers (the same instructions on the same data, so
//   every thread knows alike whether a pivot failed), each row below solves
//   against it (a row a thread), a cluster barrier, then the trailing
//   rank-8 update (a row and 8 columns a thread, the panel's rows staged
//   through each CTA's shared memory), a cluster barrier: two a panel.
// - K = W Ls^-1 (W = P Hn^T Ls^-T) by the backward solve in blocks of 8
//   columns, one cluster barrier a block: the thread of row d and column
//   block g subtracts block q + 1's contribution (Ls's block row staged in
//   shared memory) and, for g = q, solves block q in its registers.
// - The products (P Hn^T, S, E, E P, X) are tiles of 64 x 64 outputs, one
//   CTA a tile, 16-deep slices of both operands staged in shared memory,
//   4 x 4 outputs a thread.  All sums are f32 on the FP32 pipes (the port
//   keeps TF32 off).
// Every phase is a loop over the cluster's 2048 threads or the CTAs, so any
// n runs; shared memory stays under 48 KB.  A simple design that is right:
// spreading the intermediates over distributed shared memory is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;              // CTAs of a cluster, one cluster a system
constexpr int NT = 256;            // threads per CTA
constexpr int GT = CL * NT;        // threads of a cluster
constexpr int NB = 8;              // panel / block width
constexpr int PCH = 1024;          // panel rows staged in shared memory at once
constexpr int TM = 64, TK = 16;    // product tile: TM x TM outputs, TK deep
constexpr int TLD = TM + 4;        // row stride of a staged slice
constexpr float INFO_RIDGE = 1e-8f;
constexpr int NX = 24;             // error-state rows before the clone block
constexpr int NMAX = 92;           // the narrow kernel's largest n

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

// The workspace of one system, in floats; every matrix row-major.
struct Layout {
  int D, m;         // m = round8(n), the padded order of both factors
  size_t ca;        // (m + 1) x m: C + ridge (identity padding), then b^T
  size_t sa;        // (m + D) x m: S + sig2 I (identity padding), then P Hn^T
  size_t e;         // D x D: I - K Hn
  size_t y;         // D x D: (I - K Hn) P
  size_t x;         // D x D: X
  size_t total;
  __host__ __device__ explicit Layout(int n)
      : D(NX + n), m(round8(n)) {
    const size_t DD = static_cast<size_t>(D) * D;
    ca = 0;
    sa = ca + static_cast<size_t>(m + 1) * m;
    e = sa + static_cast<size_t>(m + D) * m;
    y = e + DD;
    x = y + DD;
    total = (x + DD + 7) & ~static_cast<size_t>(7);
  }
};

// The workspace is read and written at L2 (the point where the cluster's
// SMs meet), never through an SM's L1.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void stcg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void stcg4(float* p, float4 v) {
  __stcg(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ int cluster_thread() {
  return static_cast<int>(cg::this_cluster().block_rank()) * NT +
         threadIdx.x;
}

// The lower 8 x 8 block of A at (p, p) (row stride ld) factored in
// registers: a[r][c] for c <= r, rs[j] = 1 / L[j][j] by rsqrtf; false where
// a pivot is <= 0 or not finite.
__device__ __forceinline__ bool factor_block(const float* A, int lda, int p,
                                             float (&a)[NB][NB],
                                             float (&rs)[NB]) {
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) a[r][c] = ldcg(&A[(size_t)(p + r) * lda + p + c]);
  bool good = true;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = a[j][j];
    good = good && d > 0.f && d < INFINITY;
    rs[j] = rsqrtf(d);
    a[j][j] = d * rs[j];
#pragma unroll
    for (int r = j + 1; r < NB; ++r) a[r][j] *= rs[j];
#pragma unroll
    for (int r = j + 1; r < NB; ++r)
#pragma unroll
      for (int c = j + 1; c <= r; ++c) a[r][c] -= a[r][j] * a[c][j];
  }
  return good;
}

// In place: the lower Cholesky factor of A's leading mc x mc block (row
// stride mc, a multiple of NB; the callers pad with an identity block) and
// the forward solve of its rows mc .. rows - 1, which become A[i, :mc]
// L^-T.  The upper triangle of the square ends zero.  Returns false, in
// every thread alike, where a pivot is <= 0 or not finite, after a cluster
// barrier (so the caller may overwrite A).  `pan`: PCH x NB floats of
// shared memory.
__device__ bool factor_rows(float* A, int mc, int rows, float* pan) {
  cg::cluster_group cluster = cg::this_cluster();
  const int gt = cluster_thread(), tid = threadIdx.x;
  for (int p = 0; p < mc; p += NB) {
    float a[NB][NB], rs[NB];
    if (!factor_block(A, mc, p, a, rs)) {
      cluster.sync();
      return false;
    }
    // the panel's rows below the block, a row a thread
    for (int i = p + NB + gt; i < rows; i += GT) {
      float* row = A + (size_t)i * mc + p;
      const float4 x0 = ldcg4(row), x1 = ldcg4(row + 4);
      float x[NB] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int c = 0; c < NB; ++c) {
#pragma unroll
        for (int q = 0; q < c; ++q) x[c] -= x[q] * a[c][q];
        x[c] *= rs[c];
      }
      stcg4(row, make_float4(x[0], x[1], x[2], x[3]));
      stcg4(row + 4, make_float4(x[4], x[5], x[6], x[7]));
    }
    // the block's rows right of it: the upper triangle, no longer read
    const int right = mc - p - NB;
    for (int idx = gt; idx < NB * right; idx += GT)
      stcg(&A[(size_t)(p + idx / right) * mc + p + NB + idx % right], 0.f);
    cluster.sync();
    // the factored block, from the registers of the first NB threads
    if (gt < NB) {
#pragma unroll
      for (int r = 0; r < NB; ++r)
        if (r == gt)
#pragma unroll
          for (int c = 0; c < NB; ++c)
            stcg(&A[(size_t)(p + r) * mc + p + c], c <= r ? a[r][c] : 0.f);
    }
    // trailing update: rows i >= s, columns s .. min(i + 1, mc), by groups
    // of NB columns; the panel's rows of each chunk of column groups are
    // staged in shared memory
    const int s = p + NB;
    for (int k0 = s; k0 < mc; k0 += PCH) {
      const int k1 = min(k0 + PCH, mc);
      __syncthreads();                           // pan is free
      for (int idx = tid; idx < (k1 - k0) * 2; idx += NT)
        *reinterpret_cast<float4*>(&pan[idx * 4]) =
            ldcg4(&A[(size_t)(k0 + idx / 2) * mc + p + 4 * (idx % 2)]);
      __syncthreads();
      const int groups = (k1 - k0) / NB, r0 = k0, nr = rows - r0;
      for (int idx = gt; idx < groups * nr; idx += GT) {
        const int gq = idx / nr, i = r0 + idx % nr, kg = k0 + NB * gq;
        if (i < mc && kg > i) continue;          // the upper triangle
        float* row = A + (size_t)i * mc;
        const float4 l0 = ldcg4(row + p), l1 = ldcg4(row + p + 4);
        float4 v0 = ldcg4(row + kg), v1 = ldcg4(row + kg + 4);
        float u[NB];
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const float* q = pan + (kg - k0 + c) * NB;
          const float4 q0 = *reinterpret_cast<const float4*>(q);
          const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
          u[c] = l0.x * q0.x + l0.y * q0.y + l0.z * q0.z + l0.w * q0.w +
                 l1.x * q1.x + l1.y * q1.y + l1.z * q1.z + l1.w * q1.w;
        }
        v0.x -= u[0]; v0.y -= u[1]; v0.z -= u[2]; v0.w -= u[3];
        v1.x -= u[4]; v1.y -= u[5]; v1.z -= u[6]; v1.w -= u[7];
        stcg4(row + kg, v0);
        stcg4(row + kg + 4, v1);
      }
    }
    cluster.sync();
  }
  return true;
}

// K = W Ls^-1 in place, for W the D x mc rows below Ls (row stride mc) and
// Ls the mc x mc factor above them: K Ls = W, solved by blocks of NB
// columns from the last.  Step q: the thread of row d and column block
// g <= q subtracts block q + 1's part, K[d, blk q+1] Ls[blk q+1, blk g]
// (Ls's block row q + 1 staged in shared memory), and for g = q then
// solves block q against Ls's diagonal block; one cluster barrier a step.
__device__ void back_solve(const float* Ls, float* W, int mc, int D,
                           float* pan) {
  cg::cluster_group cluster = cg::this_cluster();
  const int gt = cluster_thread(), tid = threadIdx.x;
  const int nb = mc / NB;
  for (int q = nb - 1; q >= 0; --q) {
    const bool upd = q + 1 < nb;
    const int g_lo = upd ? 0 : q;
    const float* Lq1 = Ls + (size_t)NB * (q + 1) * mc;   // block row q + 1
    for (int g0 = g_lo; g0 <= q; g0 += PCH / NB) {
      const int g1 = min(g0 + PCH / NB, q + 1);
      const int w = NB * (g1 - g0);                     // columns staged
      if (upd) {
        __syncthreads();                                 // pan is free
        for (int idx = tid; idx < NB * w / 4; idx += NT) {
          const int c = idx / (w / 4), k = 4 * (idx % (w / 4));
          *reinterpret_cast<float4*>(&pan[c * w + k]) =
              ldcg4(&Lq1[(size_t)c * mc + NB * g0 + k]);
        }
        __syncthreads();
      }
      for (int idx = gt; idx < D * (g1 - g0); idx += GT) {
        const int g = g0 + idx / D, d = idx % D;
        float* row = W + (size_t)(mc + d) * mc;
        const float4 v0 = ldcg4(row + NB * g), v1 = ldcg4(row + NB * g + 4);
        float v[NB] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        if (upd) {
          const float4 k0 = ldcg4(row + NB * (q + 1));
          const float4 k1 = ldcg4(row + NB * (q + 1) + 4);
          const float kq[NB] = {k0.x, k0.y, k0.z, k0.w,
                                k1.x, k1.y, k1.z, k1.w};
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            const float* lr = pan + c * w + NB * (g - g0);
#pragma unroll
            for (int a = 0; a < NB; ++a) v[a] -= kq[c] * lr[a];
          }
        }
        if (g == q) {
          // K[d, j] = (v_j - sum_{i > j} K[d, i] Ls[i][j]) / Ls[j][j]
          const float* Lb = Ls + (size_t)NB * q * mc + NB * q;
          float lb[NB][NB];
#pragma unroll
          for (int r = 0; r < NB; ++r)
#pragma unroll
            for (int c = 0; c <= r; ++c) lb[r][c] = ldcg(&Lb[(size_t)r * mc + c]);
#pragma unroll
          for (int j = NB - 1; j >= 0; --j) {
#pragma unroll
            for (int i = j + 1; i < NB; ++i) v[j] -= v[i] * lb[i][j];
            v[j] /= lb[j][j];
          }
        }
        stcg4(row + NB * g, make_float4(v[0], v[1], v[2], v[3]));
        stcg4(row + NB * g + 4, make_float4(v[4], v[5], v[6], v[7]));
      }
    }
    cluster.sync();
  }
}

// An operand of a product: element (i, l) at p[i stride + l], or at
// p[l stride + i] where `t` (transposed); A(i, l) and B(l, j) alike.
struct Opnd {
  const float* p;
  int stride;
  bool t;
  __device__ __forceinline__ float at(int i, int l) const {
    return ldcg(t ? &p[(size_t)l * stride + i] : &p[(size_t)i * stride + l]);
  }
};

// One term sc A B of a product, of depth k.
struct Term {
  Opnd A, B;
  float sc;
  int k;
};

// One CTA's tile (i0, j0) of out = diag [i == j + doff] + sum of the terms,
// over rows x cols outputs (out row-major with stride ldo).  `sm`: 2 TK
// TLD floats.
__device__ void product_tile(int i0, int j0, int rows, int cols,
                             const Term* terms, int nterms, float diag,
                             int doff, float* out, int ldo, float* sm) {
  float* Ta = sm;              // Ta[kk][ii] = sc A(i0 + ii, l0 + kk)
  float* Tb = sm + TK * TLD;   // Tb[kk][jj] = B(l0 + kk, j0 + jj)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int t = 0; t < nterms; ++t) {
    const Term& T = terms[t];
    for (int l0 = 0; l0 < T.k; l0 += TK) {
      __syncthreads();                            // the slices are free
      for (int q = tid; q < TK * TM; q += NT) {
        // consecutive threads on consecutive addresses of each operand
        const int ia = T.A.t ? q % TM : q / TK, ka = T.A.t ? q / TM : q % TK;
        const int i = i0 + ia, l = l0 + ka;
        Ta[ka * TLD + ia] = i < rows && l < T.k ? T.sc * T.A.at(i, l) : 0.f;
        const int jb = T.B.t ? q / TK : q % TM, kb = T.B.t ? q % TK : q / TM;
        const int j = j0 + jb, lb = l0 + kb;
        Tb[kb * TLD + jb] = j < cols && lb < T.k ? T.B.at(lb, j) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&Ta[kk * TLD + 4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&Tb[kk * TLD + 4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = i0 + 4 * ty + x, j = j0 + 4 * tx + y;
      if (i < rows && j < cols)
        stcg(&out[(size_t)i * ldo + j], (i == j + doff ? diag : 0.f) + acc[x][y]);
    }
}

// Every tile of a product over the cluster's CTAs, a tile a CTA in turn.
__device__ void product(int rows, int cols, const Term* terms, int nterms,
                        float diag, int doff, float* out, int ldo,
                        float* sm) {
  const int r = static_cast<int>(cg::this_cluster().block_rank());
  const int tr = (rows + TM - 1) / TM, tc = (cols + TM - 1) / TM;
  for (int tile = r; tile < tr * tc; tile += CL)
    product_tile(TM * (tile / tc), TM * (tile % tc), rows, cols, terms,
                 nterms, diag, doff, out, ldo, sm);
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
ekf_tail_wide_kernel(const float* __restrict__ C, const float* __restrict__ b,
                     const float* __restrict__ P,
                     const float* __restrict__ sig2, float* __restrict__ dx,
                     float* __restrict__ Pn, bool* __restrict__ fallback,
                     float* ws, int n) {
  __shared__ __align__(16) float sh[PCH * NB];      // 32 KB
  __shared__ float red[NT / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int e = blockIdx.x / CL, tid = threadIdx.x, gt = cluster_thread();
  const Layout lay(n);
  const int D = lay.D, m = lay.m;
  const float* Ce = C + (size_t)e * n * n;
  const float* be = b + (size_t)e * n;
  const float* Pe = P + (size_t)e * D * D;
  float* dxe = dx + (size_t)e * D;
  float* Pne = Pn + (size_t)e * D * D;
  float* W = ws + (size_t)e * lay.total;
  float* Ca = W + lay.ca;            // -> Lc, rn^T in row m
  float* Sa = W + lay.sa;            // -> Ls, then K in rows m ..
  float* E = W + lay.e;
  float* Y = W + lay.y;
  float* X = W + lay.x;
  const float s2 = sig2[e];
  const float nan = __int_as_float(0x7fc00000);

  // every CTA takes the trace alike
  float tr[1] = {0.f};
  for (int i = tid; i < n; i += NT) tr[0] += Ce[(size_t)i * n + i];
  rvio::block_sums<1, NT>(tr, red);
  const float scale = fmaxf(tr[0], 1.f);

  // C + ridge, padded to m with an identity block, and b^T as row m
  auto load_c = [&](float ridge) {
    for (int idx = gt; idx < (m + 1) * m; idx += GT) {
      const int i = idx / m, k = idx % m;
      float v;
      if (i < n)
        v = k < n ? Ce[(size_t)i * n + k] + (i == k ? ridge : 0.f) : 0.f;
      else if (i < m)
        v = i == k ? 1.f : 0.f;
      else
        v = k < n ? be[k] : 0.f;
      stcg(&Ca[idx], v);
    }
  };
  auto nan_out = [&]() {
    for (int idx = gt; idx < D * D; idx += GT) Pne[idx] = nan;
    for (int idx = gt; idx < D; idx += GT) dxe[idx] = nan;
  };

  load_c(INFO_RIDGE * scale);
  cluster.sync();
  bool ok = factor_rows(Ca, m, m + 1, sh);
  const bool fb = !ok;
  if (!ok) {
    load_c(static_cast<float>(n) * FLT_EPSILON * scale);
    cluster.sync();
    ok = factor_rows(Ca, m, m + 1, sh);
  }
  if (gt == 0) fallback[e] = fb;
  if (!ok) {
    nan_out();
    return;
  }
  const float* rn = Ca + (size_t)m * m;   // rn^T, the factor's row m

  // P Hn^T = P[:, 24:] Lc into the D rows below S (columns n .. m zero),
  // and S's identity padding
  float* PHt = Sa + (size_t)m * m;
  {
    const Term t[1] = {{{Pe + NX, D, false}, {Ca, m, false}, 1.f, n}};
    product(D, n, t, 1, 0.f, 0, PHt, m, sh);
    for (int idx = gt; idx < D * (m - n); idx += GT)
      stcg(&PHt[(size_t)(idx / (m - n)) * m + n + idx % (m - n)], 0.f);
    for (int idx = gt; idx < (m - n) * m; idx += GT) {
      const int i = n + idx / m, k = idx % m;
      stcg(&Sa[(size_t)i * m + k], i == k ? 1.f : 0.f);
    }
  }
  cluster.sync();
  // S = Lc^T (P Hn^T)[24:, :] + sig2 I, then (S + S^T) / 2 on the lower
  // triangle (the factorization reads nothing else), as the plain version
  {
    const Term t[1] = {{{Ca, m, true}, {PHt + (size_t)NX * m, m, false}, 1.f,
                        n}};
    product(n, n, t, 1, s2, 0, Sa, m, sh);
  }
  cluster.sync();
  for (int idx = gt; idx < n * n; idx += GT) {
    const int i = idx / n, k = idx % n;
    if (k < i)
      stcg(&Sa[(size_t)i * m + k],
           0.5f * (ldcg(&Sa[(size_t)i * m + k]) + ldcg(&Sa[(size_t)k * m + i])));
  }
  cluster.sync();
  // Ls, and P Hn^T Ls^-T below it
  if (!factor_rows(Sa, m, m + D, sh)) {
    nan_out();
    return;
  }
  float* K = PHt;                    // D x m, row stride m
  back_solve(Sa, Sa, m, D, sh);

  // dx = K rn; E = I - K Hn = I - [0 | K Lc^T], formed before it multiplies
  // P, as the plain version forms it: its clone columns are small where
  // the update observes the state, and (I - K Hn) P (I - K Hn)^T then sums
  // small terms (subtracting K Hn P from P after the product would cancel
  // large ones)
  for (int d = gt; d < D; d += GT) {
    float s = 0.f;
    for (int l = 0; l < n; ++l)
      s = fmaf(ldcg(&K[(size_t)d * m + l]), ldcg(&rn[l]), s);
    dxe[d] = s;
  }
  {
    const Term t[1] = {{{K, m, false}, {Ca, m, true}, -1.f, n}};
    product(D, n, t, 1, 1.f, NX, E + NX, D, sh);
    for (int idx = gt; idx < D * NX; idx += GT) {
      const int i = idx / NX, k = idx % NX;
      stcg(&E[(size_t)i * D + k], i == k ? 1.f : 0.f);
    }
  }
  cluster.sync();
  // Y = E P
  {
    const Term t[1] = {{{E, D, false}, {Pe, D, false}, 1.f, D}};
    product(D, D, t, 1, 0.f, 0, Y, D, sh);
  }
  cluster.sync();
  // X = Y E^T + sig2 K K^T
  {
    const Term t[2] = {{{Y, D, false}, {E, D, true}, 1.f, D},
                       {{K, m, false}, {K, m, true}, s2, n}};
    product(D, D, t, 2, 0.f, 0, X, D, sh);
  }
  cluster.sync();
  // P_new = (X + X^T) / 2
  for (int idx = gt; idx < D * D; idx += GT) {
    const int i = idx / D, k = idx % D;
    Pne[idx] = 0.5f * (ldcg(&X[(size_t)i * D + k]) + ldcg(&X[(size_t)k * D + i]));
  }
}

}  // namespace

extern "C" {

// Floats of workspace a system needs at size n (the wrapper allocates B of
// them a call).
int rvio_ekf_tail_wide_workspace(long long* out, int n, cudaStream_t) {
  if (n <= NMAX) return static_cast<int>(cudaErrorInvalidValue);
  *out = static_cast<long long>(Layout(n).total);
  return 0;
}

int rvio_ekf_tail_wide(const float* C, const float* b, const float* P,
                       const float* sig2, float* dx, float* Pn,
                       bool* fallback, float* ws, int B, int n,
                       cudaStream_t stream) {
  if (n <= NMAX || !ws) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  ekf_tail_wide_kernel<<<B * CL, NT, 0, stream>>>(C, b, P, sig2, dx, Pn,
                                                  fallback, ws, n);
  return static_cast<int>(cudaGetLastError());
}

// How many of the wide kernel's clusters can be resident on the current
// device at once (cudaOccupancyMaxActiveClusters).  Launches nothing.
int rvio_ekf_tail_wide_max_clusters(int* out, int B, int n, cudaStream_t) {
  if (n <= NMAX || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * CL);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(out, ekf_tail_wide_kernel, &config);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
