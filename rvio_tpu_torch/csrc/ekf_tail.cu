// The MSCKF update's dense tail in one kernel (K5): Cholesky compression of
// the information matrix C = Hw^T Hw, S = Hn P Hn^T + sig2 I, the gain
// K = P Hn^T S^-1, dx = K rn and the Joseph-form covariance.
//
// Replaces rvio_tpu/ops/ekf_tail.py (ekf_tail_pallas / _ekf_tail_kernel).
// It computes the port's unfused chain (ops/ekf_tail.py cholesky_tail):
//
//   1. C + 1e-8 max(tr C, 1) I, lower Cholesky Lc; where a pivot is <= 0 or
//      not finite, C + n eps_f32 max(tr C, 1) I instead and `fallback` set;
//      if that fails too, dx and P_new are NaN;
//   2. rn = Lc^-1 b, Hn = [0 | Lc^T];
//   3. (P Hn^T)^T = Lc^T P[24:, :] (P symmetric: no transpose of P);
//   4. S = Lc^T P22 Lc, symmetrized, + sig2 I; its Cholesky Ls (NaN results
//      where it fails);
//   5. K^T = Ls^-T Ls^-1 (P Hn^T)^T, dx = K rn;
//   6. with G = K Lc^T (the live columns of K Hn):
//      A P = P - G P[24:, :],  X = A P - (A P)[:, 24:] G^T + sig2 K K^T,
//      P_new = (X + X^T) / 2.
//
// Bound on the H100 at the operating point (n = 84, D = 108, one entry): the
// call moves about 85 KB (C's lower triangle, b, P's upper triangle, dx and
// P_new; 0.03 us at 3.35 TB/s) and needs about 8 MFLOP (0.12 us at
// 67 TFLOP/s; ops/checks.py ekf_tail_flops), so it is bound by latency: two
// 84-step factorizations and three 84-step triangular solves, each step
// waiting on the one before.  The design answers that with one block per
// batch entry that keeps every intermediate in shared memory (C/Lc,
// S/Ls/G^T, K^T, P, A P: about 190 KB; nothing goes back to device memory
// until dx and P_new), and one barrier per step of a factorization or of
// the two solves for K: the matrix being factored or solved lives in the
// block's registers, a step publishes one column or row through shared
// memory, every thread updates its own elements from it, and no IEEE
// divide or square root sits on a step's critical path (rsqrt for the
// pivots, reciprocals taken ahead for the solves).  The one-column solve
// for rn runs on one warp with shuffles beside a product.  The products
// read 4-float vectors (rows padded to a multiple of 4) and the two
// D x D x n ones keep a 4 x 4 tile of outputs in each thread's registers.
// What is left is a step's fixed cost: its barrier and the predicated
// bookkeeping of every register slot, 84 times per factorization (a
// blocked, several-columns-a-step factorization is the next design).  The
// TPU kernel's 8-wide panels, ones-matmul broadcasts, selection matmuls and
// identity padding are Mosaic workarounds and are not carried over.  All
// sums are f32 (the TPU kernel's preferred_element_type).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int NT = 512;            // threads per block
constexpr int TX = 32;             // the register layout: a warp a row
constexpr int TY = NT / TX;
constexpr float INFO_RIDGE = 1e-8f;
constexpr int NX = 24;             // error-state rows before the clone block
// The largest n: its intermediates fill 227 KB of shared memory, the most a
// block may opt into on the H100, and it keeps n <= RMAX * TY and
// NX + n <= XBUF for the register layout below (ops/ekf_tail.py NMAX).
constexpr int NMAX = 92;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int a) {
  return a == 0 ? v.x : a == 1 ? v.y : a == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& s, float a, const float4& v) {
  s.x += a * v.x; s.y += a * v.y; s.z += a * v.z; s.w += a * v.w;
}

// The factorizations and the solves keep their matrix in registers: thread
// (ty, tx) of the TY x TX block holds rows ty, ty + TY, ... (at most RMAX)
// and columns tx, tx + TX, ... (at most CMAX).  A step publishes one row or
// column through a shared buffer (two, used in turns, so one barrier a
// step is enough), and every thread updates its own elements from it.
constexpr int RMAX = 6;            // rows a thread holds (n <= 96)
constexpr int CMAX = 4;            // columns a thread holds (width <= 128)
constexpr int XBUF = CMAX * TX;    // one published row or column
static_assert(NMAX <= RMAX * TY && ((NX + NMAX + 3) & ~3) <= XBUF,
              "NMAX must fit the register layout");

// In-place lower Cholesky of the symmetric n x n matrix A (row stride ld,
// n <= 96): on return the lower triangle holds the factor and the rest of
// the ld-wide rows zeros (the triangular products read whole vectors).
// Step j publishes column j of the trailing matrix (its owners, one lane of
// each warp); then every thread reads the pivot d, writes the factor's
// column j where it owns it, and subtracts (a_ij a_jk) / d from its
// elements, the same product for (i, k) and (k, i), so the trailing matrix
// stays symmetric bitwise and column j stands in for row j.  The step's
// one special function is rsqrt(d), as in the TPU kernel.  Returns
// false where a pivot is <= 0 or not finite; the pivot is read after the
// barrier, so every thread returns the same value at the same step.
__device__ bool cholesky_inplace(float* A, int n, int ld, float* xbuf) {
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float v[RMAX][CMAX - 1];
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
#pragma unroll
    for (int q = 0; q < CMAX - 1; ++q) {
      const int i = ty + a * TY, k = tx + q * TX;
      v[a][q] = (i < n && k < n) ? A[i * ld + k] : 0.f;
    }
  for (int j = 0; j < n; ++j) {
    float* col = xbuf + (j & 1) * XBUF;
    const int qj = j / TX;
    if (tx == j % TX)
#pragma unroll
      for (int a = 0; a < RMAX; ++a) {
        const int i = ty + a * TY;
#pragma unroll
        for (int q = 0; q < CMAX - 1; ++q)
          if (q == qj && i >= j && i < n) col[i] = v[a][q];
      }
    __syncthreads();
    const float d = col[j];
    if (!(d > 0.f && d < INFINITY)) {
      __syncthreads();            // nobody reuses a buffer before all have read
      return false;
    }
    const float rs = rsqrtf(d), inv = rs * rs;
    float ci[RMAX], ck[CMAX - 1];
#pragma unroll
    for (int a = 0; a < RMAX; ++a) {
      const int i = ty + a * TY;
      ci[a] = (i > j && i < n) ? col[i] : 0.f;
      if (tx == j % TX && i >= j && i < n)
        A[i * ld + j] = i == j ? d * rs : ci[a] * rs;
    }
#pragma unroll
    for (int q = 0; q < CMAX - 1; ++q) {
      const int k = tx + q * TX;
      ck[q] = (k > j && k < n) ? col[k] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
#pragma unroll
      for (int q = 0; q < CMAX - 1; ++q) v[a][q] -= ci[a] * ck[q] * inv;
  }
  for (int i = ty; i < n; i += TY)
    for (int k = i + 1 + tx; k < ld; k += TX) A[i * ld + k] = 0.f;
  __syncthreads();
  return true;
}

// Y = L^-1 Y (forward) or L^-T Y (backward, ``transpose``) in place, for the
// lower n x n factor L (row stride ld, zeros above the diagonal) and the
// n x w right-hand sides Y (row stride ldy, n <= 96, w <= 128), a column of
// L a step: the warp that holds row j scales it by the pivot's reciprocal
// (all n of them divided out first, in parallel, into rd) and publishes
// it, then every thread updates its rows after j (before j, backward).
__device__ void solve_inplace(const float* L, int n, int ld, float* Y, int w,
                              int ldy, float* xbuf, float* rd, bool transpose) {
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  for (int i = tid; i < n; i += NT) rd[i] = 1.f / L[i * ld + i];
  float v[RMAX][CMAX];
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
#pragma unroll
    for (int q = 0; q < CMAX; ++q) {
      const int i = ty + a * TY, c = tx + q * TX;
      v[a][q] = (i < n && c < w) ? Y[i * ldy + c] : 0.f;
    }
  for (int s = 0; s < n; ++s) {
    const int j = transpose ? n - 1 - s : s;
    float* row = xbuf + (s & 1) * XBUF;
    if (s == 0) __syncthreads();                    // rd written
    if (ty == j % TY) {
      const int aj = j / TY;
      const float r = rd[j];
#pragma unroll
      for (int a = 0; a < RMAX; ++a)
        if (a == aj)
#pragma unroll
          for (int q = 0; q < CMAX; ++q) {
            v[a][q] *= r;
            row[tx + q * TX] = v[a][q];
          }
    }
    __syncthreads();
    float yj[CMAX];
#pragma unroll
    for (int q = 0; q < CMAX; ++q) yj[q] = row[tx + q * TX];
#pragma unroll
    for (int a = 0; a < RMAX; ++a) {
      const int i = ty + a * TY;
      const bool live = transpose ? i < j : (i > j && i < n);
      const float l = live ? (transpose ? L[j * ld + i] : L[i * ld + j]) : 0.f;
#pragma unroll
      for (int q = 0; q < CMAX; ++q) v[a][q] -= l * yj[q];
    }
  }
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
#pragma unroll
    for (int q = 0; q < CMAX; ++q) {
      const int i = ty + a * TY, c = tx + q * TX;
      if (i < n && c < w) Y[i * ldy + c] = v[a][q];
    }
  __syncthreads();
}

// Load C + ridge I into A (n x n, row stride ld).
__device__ void load_ridged(float* A, int ld, const float* C, int n,
                            float ridge) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int i = idx / n, k = idx - i * n;
    A[i * ld + k] = C[idx] + (i == k ? ridge : 0.f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
ekf_tail_kernel(const float* __restrict__ C, const float* __restrict__ b,
                const float* __restrict__ P, const float* __restrict__ sig2,
                float* __restrict__ dx, float* __restrict__ Pn,
                bool* __restrict__ fallback, int n) {
  extern __shared__ __align__(16) float sh[];
  // rows are held a multiple of 4 wide (n-wide ones nP, D-wide ones DP),
  // the padding zero, so the products run on whole 4-float vectors
  const int D = NX + n, nP = (n + 3) & ~3, DP = (D + 3) & ~3;
  const int nn = n * n, DD = D * D, TD = DP / 4, TN = nP / 4;
  float* Lc = sh;                    // n x nP: C + ridge, then Lc
  float* R1 = Lc + n * nP;           // S, then Ls (n x nP); then G^T (n x DP)
  float* Q = R1 + n * DP;            // n x DP: (P Hn^T)^T, then Y, then K^T
  float* Pm = Q + n * DP;            // DP x DP: P, then X
  float* W = Pm + DP * DP;           // DP x DP: A P
  float* rn = W + DP * DP;           // n: Lc^-1 b
  float* rd = rn + nP;               // n: a solve's reciprocal pivots
  float* xbuf = rd + nP;             // 2 x XBUF: the published rows
  float* red = xbuf + 2 * XBUF;      // NT / 32 reduction slots

  const int e = blockIdx.x, tid = threadIdx.x;
  const float* Ce = C + (size_t)e * nn;
  const float* be = b + (size_t)e * n;
  const float* Pe = P + (size_t)e * DD;
  float* dxe = dx + (size_t)e * D;
  float* Pne = Pn + (size_t)e * DD;
  const float s2 = sig2[e];

  float tr[1] = {0.f};
  for (int i = tid; i < n; i += NT) tr[0] += Ce[i * n + i];
  rvio::block_sums<1, NT>(tr, red);
  const float scale = fmaxf(tr[0], 1.f);
  for (int idx = tid; idx < DP * DP; idx += NT) {
    const int i = idx / DP, k = idx - i * DP;
    Pm[idx] = (i < D && k < D) ? Pe[i * D + k] : 0.f;
  }
  for (int i = tid; i < n; i += NT) rn[i] = be[i];
  load_ridged(Lc, nP, Ce, n, INFO_RIDGE * scale);

  bool ok = cholesky_inplace(Lc, n, nP, xbuf);
  const bool fb = !ok;
  if (!ok) {
    load_ridged(Lc, nP, Ce, n, (float)n * FLT_EPSILON * scale);
    ok = cholesky_inplace(Lc, n, nP, xbuf);
  }
  if (tid == 0) fallback[e] = fb;
  if (ok) {
    // Q = Lc^T P[24:, :], a row by four columns a thread
    for (int t = tid; t < n * TD; t += NT) {
      const int i = t / TD, c = (t - i * TD) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = i; j < n; ++j) fma4(s, Lc[j * nP + i], ld4(&Pm[(NX + j) * DP + c]));
      st4(&Q[i * DP + c], s);
    }
    __syncthreads();

    // rn = Lc^-1 b on warp 0 (lane l holds rows l, l + 32, l + 64; step j
    // divides row j by the pivot and broadcasts it), while the other warps
    // form S = Q[:, 24:] Lc, a row by four columns a thread
    if (tid < 32) {
      float r[CMAX - 1], rp[CMAX - 1];
#pragma unroll
      for (int m = 0; m < CMAX - 1; ++m) {
        const int i = tid + m * 32;
        r[m] = i < n ? rn[i] : 0.f;
        rp[m] = i < n ? 1.f / Lc[i * nP + i] : 0.f;
      }
      for (int j = 0; j < n; ++j) {
        float y = 0.f;
#pragma unroll
        for (int m = 0; m < CMAX - 1; ++m)
          if (m == j / 32 && tid == j % 32) y = r[m] = r[m] * rp[m];
        y = __shfl_sync(0xffffffffu, y, j % 32);
#pragma unroll
        for (int m = 0; m < CMAX - 1; ++m) {
          const int i = tid + m * 32;
          if (i > j && i < n) r[m] -= Lc[i * nP + j] * y;
        }
      }
#pragma unroll
      for (int m = 0; m < CMAX - 1; ++m) {
        const int i = tid + m * 32;
        if (i < n) rn[i] = r[m];
      }
    } else {
      for (int t = tid - 32; t < n * TN; t += NT - 32) {
        const int i = t / TN, k = (t - i * TN) * 4;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = k; j < n; ++j) fma4(s, Q[i * DP + NX + j], ld4(&Lc[j * nP + k]));
        st4(&R1[i * nP + k], s);
      }
    }
    __syncthreads();
    // (S + S^T) / 2 + sig2 I
    for (int idx = tid; idx < nn; idx += NT) {
      const int i = idx / n, k = idx - i * n;
      if (i > k) {
        const float v = 0.5f * (R1[i * nP + k] + R1[k * nP + i]);
        R1[i * nP + k] = v;
        R1[k * nP + i] = v;
      } else if (i == k) {
        R1[i * nP + k] += s2;
      }
    }
    __syncthreads();
    ok = cholesky_inplace(R1, n, nP, xbuf);
  }
  if (!ok) {
    const float nan = __int_as_float(0x7fc00000);
    for (int i = tid; i < D; i += NT) dxe[i] = nan;
    for (int idx = tid; idx < DD; idx += NT) Pne[idx] = nan;
    return;
  }

  // K^T = Ls^-T Ls^-1 Q in place
  solve_inplace(R1, n, nP, Q, DP, DP, xbuf, rd, false);
  solve_inplace(R1, n, nP, Q, DP, DP, xbuf, rd, true);

  // dx = K rn; G^T = Lc K^T over Ls (no longer needed), a row by four
  // columns a thread
  for (int c = tid; c < D; c += NT) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += Q[i * DP + c] * rn[i];
    dxe[c] = s;
  }
  float* Gt = R1;
  for (int t = tid; t < n * TD; t += NT) {
    const int i = t / TD, c = (t - i * TD) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j <= i; ++j) fma4(s, Lc[i * nP + j], ld4(&Q[j * DP + c]));
    st4(&Gt[i * DP + c], s);
  }
  __syncthreads();

  // A P = P - G P[24:, :], four rows by four columns a thread
  for (int t = tid; t < TD * TD; t += NT) {
    const int i0 = (t / TD) * 4, k0 = (t % TD) * 4;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 v = ld4(&Pm[(i0 + a) * DP + k0]);
      acc[a][0] = v.x; acc[a][1] = v.y; acc[a][2] = v.z; acc[a][3] = v.w;
    }
    for (int l = 0; l < n; ++l) {
      const float4 g = ld4(&Gt[l * DP + i0]);
      const float4 p = ld4(&Pm[(NX + l) * DP + k0]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ga = at(g, a);
        acc[a][0] -= ga * p.x; acc[a][1] -= ga * p.y;
        acc[a][2] -= ga * p.z; acc[a][3] -= ga * p.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(&W[(i0 + a) * DP + k0],
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
  }
  __syncthreads();

  // X = A P - (A P)[:, 24:] G^T + sig2 K K^T over P, four by four a thread
  for (int t = tid; t < TD * TD; t += NT) {
    const int i0 = (t / TD) * 4, k0 = (t % TD) * 4;
    float acc[4][4], kk[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 v = ld4(&W[(i0 + a) * DP + k0]);
      acc[a][0] = v.x; acc[a][1] = v.y; acc[a][2] = v.z; acc[a][3] = v.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[a][c] = 0.f;
    }
    for (int l = 0; l < n; ++l) {
      const float4 g = ld4(&Gt[l * DP + k0]);
      const float4 qi = ld4(&Q[l * DP + i0]);
      const float4 qk = ld4(&Q[l * DP + k0]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wa = W[(i0 + a) * DP + NX + l], qa = at(qi, a);
        acc[a][0] -= wa * g.x; acc[a][1] -= wa * g.y;
        acc[a][2] -= wa * g.z; acc[a][3] -= wa * g.w;
        kk[a][0] += qa * qk.x; kk[a][1] += qa * qk.y;
        kk[a][2] += qa * qk.z; kk[a][3] += qa * qk.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(&Pm[(i0 + a) * DP + k0],
          make_float4(acc[a][0] + s2 * kk[a][0], acc[a][1] + s2 * kk[a][1],
                      acc[a][2] + s2 * kk[a][2], acc[a][3] + s2 * kk[a][3]));
  }
  __syncthreads();
  for (int idx = tid; idx < DD; idx += NT) {
    const int i = idx / D, k = idx - i * D;
    Pne[idx] = 0.5f * (Pm[i * DP + k] + Pm[k * DP + i]);
  }
}

size_t smem_bytes(int n) {
  const size_t nP = (n + 3) & ~3, DP = (NX + n + 3) & ~3;
  return sizeof(float) *
         (n * nP + 2 * n * DP + 2 * DP * DP + 2 * nP + 2 * XBUF + NT / 32);
}

}  // namespace

extern "C" {

int rvio_ekf_tail(const float* C, const float* b, const float* P,
                  const float* sig2, float* dx, float* Pn, bool* fallback,
                  int B, int n, cudaStream_t stream) {
  if (n < 1 || n > NMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // The shared-memory attribute is set once per device and size, outside
  // any graph capture (the first launch of a size runs eagerly).  Where
  // setting it fails the wrapper raises; the error is taken off the
  // runtime's last-error state, or the next launch's check would report it
  // again.
  static size_t configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = smem_bytes(n);
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(ekf_tail_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    configured[dev] = smem;
  }
  ekf_tail_kernel<<<B, NT, smem, stream>>>(C, b, P, sig2, dx, Pn, fallback, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
