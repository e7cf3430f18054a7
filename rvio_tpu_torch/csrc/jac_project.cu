// Per-feature MSCKF Jacobians + Householder nullspace projection (K3).
//
// Replaces rvio_tpu/ops/jac_project.py (jac_project_pallas /
// _jac_project_kernel); the arithmetic follows filter/update.
// _build_jacobians + _householder_project of the JAX package (reference:
// Updater.cc:278-402).
//
// Bound on the H100 at the operating point (F = 100, L = 15, M = 14, f32):
// 1.15 MB of chains in and r, Hx out, about 0.35 us at 3.35 TB/s
// (ops/checks.py counts it).  What holds a feature back is latency: the
// three reflections depend on each other, over a 2L x (6(L-1) + 4) system.
//
// The design rests on one fact: the three reflectors depend on Hf alone
// (the first three columns, 2L x 3), and Q^T acts on every other column of
// [Hx | r] on its own.  One block of 128 threads a feature:
//
//   - warp 0 builds Hf with a measurement a lane (two rows; two
//     measurements a lane for L > 32), takes the rank-check norm
//     ||Hf[:, rho]|| and forms the three reflectors v_k, beta_k from
//     registers, one round of warp sums a reflector (||x||^2 and x . A_c
//     together; ||v||^2 and v . A_c follow from them and row k);
//   - at the same time warp 1 builds the residual rows and warp 2 the
//     left factors Hp_l R_cb Rrel_l, a measurement a lane, into shared
//     memory, and every lane of warps 1-3 the column of subH_jj = [skew(pb
//     + rho R_j^T t_j) R_j^T | -rho R_{j-1}^T] its output column needs
//     (its loads issued with the lane's others: one round trip);
//     a named barrier of warps 1-3 only, then each of their lanes builds
//     its output column (2L rows) in registers: the absolute clone column
//     oc of Hx in [0, 6M), chain column jj = oc / 6 - c0, from the left
//     factors (broadcast reads), or r (oc = 6M), while warp 0 still forms
//     the reflectors;
//   - the block's barrier (the reflectors are in), then each column lane
//     applies Q^T (v_k, beta_k broadcast), the rank check and the residual
//     mask (rows >= Ncols, < 2 t_eff), and stores its column: each output
//     row is written by neighbouring lanes to neighbouring addresses.
//     Columns outside the chain, or past the last measured one, are stored
//     as zeros without work.
//
// The row count is a compile-time bound (LMAX = 16 measurements, 32 rows,
// for L <= 16; LMAX = 64 for 16 < L <= 64), so the row loops unroll and a
// column lives in registers (the L <= 64 instance keeps its 128-row column
// in local memory: kept correct, not fast; RVIOConfig() has L = 15); rows
// past 2L are zero and change no sum.  Past L = 64,
// jac_project_wide_kernel does the same work with its rows in loops.  The
// reflections sum in another order than the plain version: rounding only.
//
// The depth guard `eps` is the caller's: 1e-6 for this f32 kernel (the
// TPU kernel's guard; reflector norms square the perspective rows, so
// 1e-12 would overflow f32).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

// phase sync: __syncwarp()

namespace {

constexpr int NT = 128;          // threads of a block, one block a feature
constexpr int NCT = NT - 32;     // column lanes (warps 1-3)

__device__ __forceinline__ float safe_z(float z, float eps) {
  return fabsf(z) < eps ? (z < 0.f ? -eps : eps) : z;
}

// R p + rho t for a row-major 3 x 3 R
__device__ __forceinline__ void chain_point(const float (&R)[9],
                                            const float (&p)[3], float rho,
                                            const float (&t)[3], float (&h)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] +
           rho * t[i];
}

template <int N>
__device__ __forceinline__ void load(const float* __restrict__ src,
                                     float (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i];
}

// subH_jj's column b: rows d of [dpx_j R_j^T | -rho R_{j-1}^T], with
// dpx_j = skew(pb + rho R_j^T t_j), pb = R_bc epf + rho t_bc.  Only chain
// columns jj <= t_eff - 2 meet a measured row (jj < i < t_eff); the others
// are zero (-1).  Column 6M is r (6M + 1).  The loads come first (at a
// clamped chain column), so they are in flight with the lane's other loads.
struct SubIn {
  float Rj[9], tj[3], Rp[3];
};

__device__ __forceinline__ void sub_loads(const float* __restrict__ Rrl,
                                          const float* __restrict__ trl,
                                          int f, int L, int c0, int oc,
                                          SubIn& in) {
  const int jj = min(max(oc / 6 - c0, 0), L - 2), b3 = max(oc % 6 - 3, 0);
  const size_t fj = (size_t)f * L + jj;
  load(Rrl + (fj + 1) * 9, in.Rj);
  load(trl + (fj + 1) * 3, in.tj);
  load(Rrl + fj * 9 + 3 * b3, in.Rp);
}

// The chain column of output column oc (XC + 1 for r, -1 for a zero
// column) and, for a live Hx column, subH's column in s3.
__device__ __forceinline__ int sub_column(int oc, int XC, int c0, int teff,
                                          const float (&Rb)[9],
                                          const float (&epf)[3], float rho,
                                          const float* __restrict__ tbc,
                                          const SubIn& in, float (&s3)[3]) {
  if (oc == XC) return XC + 1;
  const int jj = oc / 6 - c0, b = oc % 6;
  if (oc > XC || jj < 0 || jj > teff - 2) return -1;
  if (b < 3) {
    float w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pb = Rb[3 * c] * epf[0] + Rb[3 * c + 1] * epf[1] +
                       Rb[3 * c + 2] * epf[2] + rho * tbc[c];
      w[c] = pb + rho * (in.Rj[c] * in.tj[0] + in.Rj[3 + c] * in.tj[1] +
                         in.Rj[6 + c] * in.tj[2]);
    }
    const float dpx[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]},
                             {-w[1], w[0], 0.f}};
#pragma unroll
    for (int d = 0; d < 3; ++d)
      s3[d] = dpx[d][0] * in.Rj[3 * b] + dpx[d][1] * in.Rj[3 * b + 1] +
              dpx[d][2] * in.Rj[3 * b + 2];
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) s3[d] = -rho * in.Rp[d];
  }
  return jj;
}

// Measurement l's rows of Hf (2 x 3; zero past t_eff, the rho column zero
// for l = 0) from its linearization chain.
__device__ __forceinline__ void hf_rows(const float* __restrict__ Rcl,
                                        const float* __restrict__ tcl,
                                        size_t fl, bool mv, bool first,
                                        const float (&epf)[3], float rho,
                                        const float (&Ja)[3][2], float eps,
                                        float (&A)[2][3]) {
  float Rl[9], tl[3], h[3];
  load(Rcl + fl * 9, Rl);
  load(tcl + fl * 3, tl);
  chain_point(Rl, epf, rho, tl, h);
  const float zi = 1.f / safe_z(h[2], eps);
  const float Hp[2][3] = {{zi, 0.f, -h[0] * zi * zi},
                          {0.f, zi, -h[1] * zi * zi}};
  float RJ[3][2];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      RJ[b][g] = Rl[3 * b] * Ja[0][g] + Rl[3 * b + 1] * Ja[1][g] +
                 Rl[3 * b + 2] * Ja[2][g];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
      A[a][g] = mv ? Hp[a][0] * RJ[0][g] + Hp[a][1] * RJ[1][g] +
                     Hp[a][2] * RJ[2][g]
                   : 0.f;
    A[a][2] = (mv && !first)
                  ? Hp[a][0] * tl[0] + Hp[a][1] * tl[1] + Hp[a][2] * tl[2]
                  : 0.f;
  }
}

// Measurement l's residual rows (warp 1's part) ...
__device__ __forceinline__ void res_rows(const float* __restrict__ z,
                                         const float* __restrict__ Rcr,
                                         const float* __restrict__ tcr,
                                         size_t fl, bool mv,
                                         const float (&epf)[3], float rho,
                                         float eps, float (&out)[2]) {
  float Rr[9], tr[3], zz[2], hr[3];
  load(Rcr + fl * 9, Rr);
  load(tcr + fl * 3, tr);
  load(z + fl * 2, zz);
  chain_point(Rr, epf, rho, tr, hr);
  const float zr = safe_z(hr[2], eps);
#pragma unroll
  for (int a = 0; a < 2; ++a) out[a] = mv ? zz[a] - hr[a] / zr : 0.f;
}

// ... and its left factors Hp_l R_cb Rrel_l (warp 2's part), a row a float4.
__device__ __forceinline__ void left_rows(const float* __restrict__ Rcl,
                                          const float* __restrict__ tcl,
                                          const float* __restrict__ Rrl,
                                          size_t fl, const float (&Rb)[9],
                                          const float (&epf)[3], float rho,
                                          float eps, float4* out) {
  float Rl[9], tl[3], Rq[9], h[3];
  load(Rcl + fl * 9, Rl);
  load(tcl + fl * 3, tl);
  load(Rrl + fl * 9, Rq);
  chain_point(Rl, epf, rho, tl, h);
  const float zi = 1.f / safe_z(h[2], eps);
  const float Hp[2][3] = {{zi, 0.f, -h[0] * zi * zi},
                          {0.f, zi, -h[1] * zi * zi}};
  // (Hp R_cb Rrel)[a, d], R_cb = R_bc^T
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float HpRcb[3], lf[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      HpRcb[k] = Hp[a][0] * Rb[3 * k] + Hp[a][1] * Rb[3 * k + 1] +
                 Hp[a][2] * Rb[3 * k + 2];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      lf[d] = HpRcb[0] * Rq[d] + HpRcb[1] * Rq[3 + d] + HpRcb[2] * Rq[6 + d];
    out[a] = make_float4(lf[0], lf[1], lf[2], 0.f);
  }
}

// Any L (the instance for L > 64): the same work as jac_project_kernel,
// with the rows in loops rather than unrolled.  Dynamic shared memory holds
// the left factors (2L float4), the residual rows (2L), the reflectors
// (3 x 2L) and Hf (2L x 3), which warp 0 builds a measurement a lane and
// reflects in place, one round of warp sums a reflector.  Each column lane
// then builds its output column straight into its place in Hx (or r) in
// device memory, the column it stores anyway, and applies Q^T there: for
// each reflector a dot product over the 2L rows and an axpy, then the rank
// check and the residual mask.  The lane's own loads and stores of its
// column need no barrier; neighbouring lanes touch neighbouring addresses.
// 62 us a launch at L = 65 over 100 features, the column passes through
// L1 (NVIDIA H100 80GB HBM3, 700 W; scripts/profile_torch_step.py).
__global__ void __launch_bounds__(NT)
jac_project_wide_kernel(
    const float* __restrict__ z, const float* __restrict__ Rcl,
    const float* __restrict__ tcl, const float* __restrict__ Rrl,
    const float* __restrict__ trl, const float* __restrict__ Rcr,
    const float* __restrict__ tcr, const float* __restrict__ phi_,
    const float* __restrict__ psi_, const float* __restrict__ rho_,
    const long long* __restrict__ teff_, const long long* __restrict__ c0_,
    const float* __restrict__ Rbc, const float* __restrict__ tbc,
    float* __restrict__ r_out, float* __restrict__ hx_out,
    float* __restrict__ hfn_out, int L, int M, float eps) {
  extern __shared__ __align__(16) float dsh[];
  __shared__ float scal[4];               // beta_0..2, ||Hf[:, rho]||
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R2 = 2 * L, XC = 6 * M;
  float4* left = reinterpret_cast<float4*>(dsh);   // 2L
  float* res = dsh + 4 * R2;                        // 2L
  float* vsh = res + R2;                            // 3 x 2L
  float* hf = vsh + 3 * R2;                         // 2L x 3
  const float phi = phi_[f], psi = psi_[f], rho = rho_[f];
  const int teff = static_cast<int>(min(teff_[f], (long long)L));
  const int c0 = static_cast<int>(c0_[f]);
  float Rb[9];
  load(Rbc, Rb);
  float sp, cp, ss, cs;
  sincosf(phi, &sp, &cp);
  sincosf(psi, &ss, &cs);
  const float epf[3] = {cp * ss, sp, cp * cs};
  float s3[3] = {0.f, 0.f, 0.f};

  int jj = -1;
  if (warp == 0) {
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f},
                            {-sp * cs, -cp * ss}};
    for (int l = lane; l < L; l += 32) {
      float A[2][3];
      hf_rows(Rcl, tcl, (size_t)f * L + l, l < teff, l == 0, epf, rho, Ja,
              eps, A);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) hf[(2 * l + a) * 3 + c] = A[a][c];
    }
    __syncwarp();
    // the reflections of jac_project_kernel, a row of Hf at a time
    float hfn = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float sm[4] = {0.f, 0.f, 0.f, 0.f};   // x.x, x.A_1, x.A_2, rank
      for (int row = lane; row < R2; row += 32) {
        const float* h = hf + row * 3;
        const float x = row >= k ? h[k] : 0.f;
        sm[0] = fmaf(x, x, sm[0]);
#pragma unroll
        for (int c = k + 1; c < 3; ++c) sm[c] = fmaf(x, h[c], sm[c]);
        if (k == 0) sm[3] = fmaf(h[2], h[2], sm[3]);
      }
      const float xk = hf[k * 3 + k];
      float akc[3];
#pragma unroll
      for (int c = k + 1; c < 3; ++c) akc[c] = hf[k * 3 + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == 0 || (i > k && i < 3) || (i == 3 && k == 0))
            sm[i] += __shfl_xor_sync(0xffffffffu, sm[i], o);
      __syncwarp();                 // row k is read before it changes
      if (k == 0) hfn = sqrtf(sm[3]);
      const float normx = sqrtf(sm[0]);
      const float alpha = xk >= 0.f ? -normx : normx;
      const float vnorm2 = 2.f * (sm[0] - alpha * xk);
      const float beta = vnorm2 > 1e-30f ? 2.f / vnorm2 : 0.f;
      if (lane == 0) scal[k] = beta;
      float w[3];
#pragma unroll
      for (int c = k + 1; c < 3; ++c) w[c] = sm[c] - alpha * akc[c];
      for (int row = lane; row < R2; row += 32) {
        float* h = hf + row * 3;
        float x = row >= k ? h[k] : 0.f;
        if (row == k) x -= alpha;
        vsh[k * R2 + row] = x;
#pragma unroll
        for (int c = k + 1; c < 3; ++c) h[c] = fmaf(-beta, x * w[c], h[c]);
      }
      __syncwarp();
    }
    if (lane == 0) {
      scal[3] = hfn;
      hfn_out[f] = hfn;
    }
  } else {
    SubIn sub;
    sub_loads(Rrl, trl, f, L, c0, tid - 32, sub);
    if (warp < 3) {
      for (int l = lane; l < L; l += 32) {
        const size_t fl = (size_t)f * L + l;
        if (warp == 1) {
          float rr[2];
          res_rows(z, Rcr, tcr, fl, l < teff, epf, rho, eps, rr);
          res[2 * l] = rr[0];
          res[2 * l + 1] = rr[1];
        } else {
          left_rows(Rcl, tcl, Rrl, fl, Rb, epf, rho, eps, &left[l * 2]);
        }
      }
    }
    jj = sub_column(tid - 32, XC, c0, teff, Rb, epf, rho, tbc, sub, s3);
    asm volatile("bar.sync 1, %0;" ::"n"(NCT) : "memory");
  }
  if (warp == 0) {
    __syncthreads();                // the reflectors are in
    return;
  }

  for (int base = 0; base <= XC; base += NCT) {
    const int oc = base + tid - 32;
    if (base > 0) {
      SubIn sub;
      sub_loads(Rrl, trl, f, L, c0, oc, sub);
      jj = sub_column(oc, XC, c0, teff, Rb, epf, rho, tbc, sub, s3);
    }
    const bool live = jj >= 0;
    float* out = jj > XC ? r_out + (size_t)f * R2
                         : hx_out + (size_t)f * R2 * XC + oc;
    const size_t stride = jj > XC ? 1 : XC;
    // the column, built in place before the reflectors are in
    if (live) {
      if (jj > XC) {
        for (int row = 0; row < R2; ++row) out[row] = res[row];
      } else {
        for (int i = 0; i < L; ++i)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 lf = left[i * 2 + a];
            const float v = lf.x * s3[0] + lf.y * s3[1] + lf.z * s3[2];
            out[(2 * i + a) * stride] = jj < i && i < teff ? v : 0.f;
          }
      }
    }
    if (base == 0) __syncthreads();  // the reflectors are in
    if (oc > XC) continue;
    const int ncols = scal[3] < 1e-4f ? 2 : 3;
    if (live) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* v = vsh + k * R2;
        float w = 0.f;
        for (int row = 0; row < R2; ++row)
          w = fmaf(v[row], out[row * stride], w);
        const float bw = scal[k] * w;
        for (int row = 0; row < R2; ++row)
          out[row * stride] = fmaf(-bw, v[row], out[row * stride]);
      }
      for (int row = 0; row < min(ncols, R2); ++row) out[row * stride] = 0.f;
      for (int row = 2 * teff; row < R2; ++row) out[row * stride] = 0.f;
    } else {
      for (int row = 0; row < R2; ++row) out[row * stride] = 0.f;
    }
  }
}

template <int LMAX>
__global__ void __launch_bounds__(NT)
jac_project_kernel(
    const float* __restrict__ z, const float* __restrict__ Rcl,
    const float* __restrict__ tcl, const float* __restrict__ Rrl,
    const float* __restrict__ trl, const float* __restrict__ Rcr,
    const float* __restrict__ tcr, const float* __restrict__ phi_,
    const float* __restrict__ psi_, const float* __restrict__ rho_,
    const long long* __restrict__ teff_, const long long* __restrict__ c0_,
    const float* __restrict__ Rbc, const float* __restrict__ tbc,
    float* __restrict__ r_out, float* __restrict__ hx_out,
    float* __restrict__ hfn_out, int L, int M, float eps) {
  constexpr int R = 2 * LMAX;             // rows, padded
  constexpr int MPL = (LMAX + 31) / 32;   // measurements a lane
  __shared__ float4 left[LMAX * 2];       // Hp_l R_cb Rrel_l, a row a float4
  __shared__ float res[R];                // the residual rows
  __shared__ __align__(16) float vsh[3][R];   // the reflectors
  __shared__ float scal[4];               // beta_0..2, ||Hf[:, rho]||

  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R2 = 2 * L, XC = 6 * M;
  const float phi = phi_[f], psi = psi_[f], rho = rho_[f];
  const int teff = static_cast<int>(min(teff_[f], (long long)L));
  const int c0 = static_cast<int>(c0_[f]);
  float Rb[9];
  load(Rbc, Rb);
  float sp, cp, ss, cs;
  sincosf(phi, &sp, &cp);
  sincosf(psi, &ss, &cs);
  const float epf[3] = {cp * ss, sp, cp * cs};

  float s3[3] = {0.f, 0.f, 0.f};   // subH's column of this lane's output
  // phase: warp 0 Hf and the reflectors; warps 1-3 r, left factors, subH
  int jj = -1;
  if (warp == 0) {
    // ---- Hf, measurement l = lane + 32 m, rows 2l and 2l + 1 ----
    float A[MPL][2][3];
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f},
                            {-sp * cs, -cp * ss}};
#pragma unroll
    for (int m = 0; m < MPL; ++m) {
      const int l = lane + 32 * m;
      const bool mv = l < teff;
      const size_t fl = (size_t)f * L + (l < L ? l : 0);
      hf_rows(Rcl, tcl, fl, mv, l == 0, epf, rho, Ja, eps, A[m]);
    }
    // three reflections, one round of warp sums each: reflector k from
    // x = column k (rows >= k), with v = x - alpha e_k, so ||v||^2 =
    // 2 (||x||^2 - alpha x_k) and v . A_c = x . A_c - alpha A_kc for the
    // columns c after k; the first round also sums the rank check
    // ||Hf[:, rho]||^2, taken before the projection
    float hfn = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float x[MPL][2];
      float sm[4] = {0.f, 0.f, 0.f, 0.f};   // x.x, x.A_1, x.A_2, rank
#pragma unroll
      for (int m = 0; m < MPL; ++m)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = 2 * (lane + 32 * m) + a;
          x[m][a] = row >= k ? A[m][a][k] : 0.f;
          sm[0] = fmaf(x[m][a], x[m][a], sm[0]);
#pragma unroll
          for (int c = k + 1; c < 3; ++c)
            sm[c] = fmaf(x[m][a], A[m][a][c], sm[c]);
          if (k == 0) sm[3] = fmaf(A[m][a][2], A[m][a][2], sm[3]);
        }
      // row k's entries, from lane k / 2
      const float xk = __shfl_sync(0xffffffffu, A[0][k & 1][k], k >> 1);
      float akc[3];
#pragma unroll
      for (int c = k + 1; c < 3; ++c)
        akc[c] = __shfl_sync(0xffffffffu, A[0][k & 1][c], k >> 1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == 0 || (i > k && i < 3) || (i == 3 && k == 0))
            sm[i] += __shfl_xor_sync(0xffffffffu, sm[i], o);
      if (k == 0) hfn = sqrtf(sm[3]);
      const float normx = sqrtf(sm[0]);
      const float alpha = xk >= 0.f ? -normx : normx;
      const float vnorm2 = 2.f * (sm[0] - alpha * xk);
      const float beta = vnorm2 > 1e-30f ? 2.f / vnorm2 : 0.f;
      if (lane == 0) scal[k] = beta;
#pragma unroll
      for (int m = 0; m < MPL; ++m)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = 2 * (lane + 32 * m) + a;
          if (row == k) x[m][a] -= alpha;
          if (row < R) vsh[k][row] = x[m][a];
        }
#pragma unroll
      for (int c = k + 1; c < 3; ++c) {
        const float w = sm[c] - alpha * akc[c];
#pragma unroll
        for (int m = 0; m < MPL; ++m)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            A[m][a][c] = fmaf(-beta, x[m][a] * w, A[m][a][c]);
      }
    }
    if (lane == 0) {
      scal[3] = hfn;
      hfn_out[f] = hfn;
    }
  } else {
    SubIn sub;
    sub_loads(Rrl, trl, f, L, c0, tid - 32, sub);
    if (warp < 3) {
      // ---- warp 1: the residual rows; warp 2: the left factors ----
#pragma unroll
      for (int m = 0; m < MPL; ++m) {
        const int l = lane + 32 * m;
        const bool in = l < L, mv = l < teff;
        const size_t fl = (size_t)f * L + (in ? l : 0);
        if (warp == 1) {
          float rr[2];
          res_rows(z, Rcr, tcr, fl, mv, epf, rho, eps, rr);
#pragma unroll
          for (int a = 0; a < 2; ++a)
            if (2 * l + a < R) res[2 * l + a] = rr[a];
        } else if (in) {
          left_rows(Rcl, tcl, Rrl, fl, Rb, epf, rho, eps, &left[l * 2]);
        }
      }
    }
    jj = sub_column(tid - 32, XC, c0, teff, Rb, epf, rho, tbc, sub, s3);
    // the residual and the left factors are in: warps 1-3 only, so the
    // first columns are built while warp 0 forms the reflectors
    asm volatile("bar.sync 1, %0;" ::"n"(NCT) : "memory");
  }
  if (warp == 0) {
    __syncthreads();                // the reflectors are in
    return;
  }

  // the trips are the same in every lane, so a warp stays converged
  for (int base = 0; base <= XC; base += NCT) {
    const int oc = base + tid - 32;
    if (base > 0) {
      SubIn sub;
      sub_loads(Rrl, trl, f, L, c0, oc, sub);
      jj = sub_column(oc, XC, c0, teff, Rb, epf, rho, tbc, sub, s3);
    }
    const bool live = jj >= 0;
    // phase: column build
    float col[R];
    if (jj > XC) {
#pragma unroll
      for (int row = 0; row < R; ++row) col[row] = res[row];
    } else {
#pragma unroll
      for (int i = 0; i < LMAX; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float4 lf = left[i * 2 + a];
          const float v = lf.x * s3[0] + lf.y * s3[1] + lf.z * s3[2];
          col[2 * i + a] = live && jj < i && i < teff ? v : 0.f;
        }
    }
    if (base == 0) __syncthreads();  // the reflectors are in
    const float beta[3] = {scal[0], scal[1], scal[2]};
    const int ncols = scal[3] < 1e-4f ? 2 : 3;
    // phase: three reflections of the column
    if (live) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* v = vsh[k];
        float w0 = 0.f, w1 = 0.f;
#pragma unroll
        for (int row = 0; row < R; row += 2) {
          w0 = fmaf(v[row], col[row], w0);
          w1 = fmaf(v[row + 1], col[row + 1], w1);
        }
        const float w = w0 + w1;
#pragma unroll
        for (int row = 0; row < R; ++row)
          col[row] = fmaf(-beta[k], v[row] * w, col[row]);
      }
    }
    // phase: masked store
    if (oc <= XC) {
      float* out = jj > XC ? r_out + (size_t)f * R2
                           : hx_out + (size_t)f * R2 * XC + oc;
      const int stride = jj > XC ? 1 : XC;
#pragma unroll
      for (int row = 0; row < R; ++row)
        if (row < R2)
          out[(size_t)row * stride] =
              row >= ncols && row < 2 * teff ? col[row] : 0.f;
    }
  }
}

template <int LMAX>
int launch(const float* z, const float* Rcl, const float* tcl,
           const float* Rrl, const float* trl, const float* Rcr,
           const float* tcr, const float* phi, const float* psi,
           const float* rho, const long long* teff, const long long* c0,
           const float* Rbc, const float* tbc, float* r_out, float* hx_out,
           float* hfn_out, int F, int L, int M, float eps,
           cudaStream_t stream) {
  jac_project_kernel<LMAX><<<F, NT, 0, stream>>>(
      z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, teff, c0, Rbc, tbc,
      r_out, hx_out, hfn_out, L, M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rvio_jac_project(const float* z, const float* Rcl, const float* tcl,
                     const float* Rrl, const float* trl, const float* Rcr,
                     const float* tcr, const float* phi, const float* psi,
                     const float* rho, const long long* teff,
                     const long long* c0, const float* Rbc, const float* tbc,
                     float* r_out, float* hx_out, float* hfn_out, int F,
                     int L, int M, float eps, cudaStream_t stream) {
  if (F == 0) return 0;
  if (L < 2 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 64)
    return (L <= 16 ? launch<16> : launch<64>)(
        z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, teff, c0, Rbc, tbc,
        r_out, hx_out, hfn_out, F, L, M, eps, stream);
  // 2L (float4 + 1 + 3 + 3) floats: 11 KB at L = 65
  const int smem = 2 * L * 11 * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jac_project_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  jac_project_wide_kernel<<<F, NT, smem, stream>>>(
      z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, teff, c0, Rbc, tbc,
      r_out, hx_out, hfn_out, L, M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
