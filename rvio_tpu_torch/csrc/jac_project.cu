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
// column lives in registers; rows past 2L are zero and change no sum.  The
// LMAX = 64 instance keeps its 128-row column in local memory (kept
// correct, not fast), and the wrapper's dispatch (ops/jac_project.py
// `kernel_route`) sends every L past 16 to jac_project_wide_kernel below (compact-WY reflection over a grid of
// column tiles), which chip_smoke.py times against it at L = 17, 20 and
// 33; RVIOConfig() has L = 15.  Both sum the reflections in another order
// than the plain version: rounding only.
//
// The depth guard `eps` is the caller's: 1e-6 for this f32 kernel (the
// TPU kernel's guard; reflector norms square the perspective rows, so
// 1e-12 would overflow f32).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

// phase sync: __syncwarp()

namespace {

constexpr int NT = 128;          // threads of a block
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

// Q^T c = c - V (T^T (V^T c)): u = T^T w for w = V^T c, T upper triangular
// by rows in t[0..5] = (t00, t01, t02, t11, t12, t22).
__device__ __forceinline__ void wy_coefficients(const float* t,
                                                const float (&w)[3],
                                                float (&u)[3]) {
  u[0] = t[0] * w[0];
  u[1] = fmaf(t[1], w[0], t[3] * w[1]);
  u[2] = fmaf(t[2], w[0], fmaf(t[4], w[1], t[5] * w[2]));
}

// Any L past the L <= 16 instance (the wrapper's dispatch): compact-WY
// reflection, each output entry formed in registers and stored once.  A
// grid of F x column tiles, WY_PAIRS pairs of output columns a tile and
// WY_GROUP lanes of warps 1-3 a pair (each a quarter of the rows), so
// F = 100 features at L = 65 (M = 64) run 800 blocks.  In every block all
// threads first build Hf (2L x 3), the left factors Hp_l R_cb Rrel_l and
// (tile 0) the residual rows into shared memory, a measurement a thread;
// a barrier; then warp 0 forms the three reflectors v_k, beta_k as
// jac_project_kernel does (one round of warp sums a reflector) and the
// triangular T of Q = H_0 H_1 H_2 = I - V T V^T from beta_k and V^T V,
// while warps 1-3 store the zeros that need no reflector (the columns
// outside the chain, the masked rows past 2 t_eff); a barrier; each lane
// then forms its pair's entries on the fly (from the left factors by
// broadcast reads and its subH columns s3) in two passes over its rows:
// the first sums w = V^T c (the pair's lanes add their parts by
// shuffles), the second stores c - V T^T w with the rank check applied, a
// float2 a row, the pair's neighbours on neighbouring addresses.  Tile 0's
// warp 0 projects r the same way, its rows over the lanes.  A feature with
// fewer than two measurements stores zeros and nothing else.  11.2 us a
// launch at L = 65 over 100 features (the design before it, a column lane
// reflecting its column in place in Hx, took 73.3), 5.7-6.7 at L = 17-33
// against the L <= 64 instance's 10.8-13.0 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).
constexpr int WY_GROUP = 4;                 // lanes a column pair
constexpr int WY_PAIRS = NCT / WY_GROUP;    // column pairs a block

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
  // beta_0..2, ||Hf[:, rho]||, then T by rows (t00, t01, t02, t11, t12, t22)
  __shared__ float scal[10];
  const int f = blockIdx.x, tile = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R2 = 2 * L, XC = 6 * M;
  const int stride = XC / 2;        // float2 a row of Hx
  const int teff = static_cast<int>(min(teff_[f], (long long)L));
  const int rend = 2 * teff;        // rows past it are masked
  const bool rtile = tile == 0;
  if (teff < 2) {
    // step: fewer than two measurements: r, Hx and hfn are 0, stored by
    // every thread of the block (the tile's pairs a row, float2 each)
    const int np = min(WY_PAIRS, stride - tile * WY_PAIRS);
    float2* hx = reinterpret_cast<float2*>(hx_out + (size_t)f * R2 * XC) +
                 tile * WY_PAIRS;
    for (int idx = tid; idx < R2 * np; idx += NT)
      hx[(size_t)(idx / np) * stride + idx % np] = make_float2(0.f, 0.f);
    if (rtile) {
      for (int row = tid; row < R2; row += NT)
        r_out[(size_t)f * R2 + row] = 0.f;
      if (tid == 0) hfn_out[f] = 0.f;
    }
    return;
  }
  float4* left = reinterpret_cast<float4*>(dsh);   // 2L
  float* res = dsh + 4 * R2;                        // 2L
  float* vsh = res + R2;                            // 3 x 2L
  float* hf = vsh + 3 * R2;                         // 2L x 3
  const float phi = phi_[f], psi = psi_[f], rho = rho_[f];
  const int c0 = static_cast<int>(c0_[f]);
  float Rb[9];
  load(Rbc, Rb);
  float sp, cp, ss, cs;
  sincosf(phi, &sp, &cp);
  sincosf(psi, &ss, &cs);
  const float epf[3] = {cp * ss, sp, cp * cs};
  // this lane's pair (column lanes: warps 1-3) and its quarter of the rows
  const int g = (tid - 32) & (WY_GROUP - 1);
  const int oc = 2 * (tile * WY_PAIRS + (tid - 32) / WY_GROUP);
  // the pair's subH columns (oc even: both in chain column jj, -1 where
  // they are zero)
  float s3[2][3] = {};
  int jj = -1;
  if (warp > 0 && oc < XC) {
    SubIn in[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) sub_loads(Rrl, trl, f, L, c0, oc + q, in[q]);
    jj = sub_column(oc, XC, c0, teff, Rb, epf, rho, tbc, in[0], s3[0]);
    sub_column(oc + 1, XC, c0, teff, Rb, epf, rho, tbc, in[1], s3[1]);
  }

  // step: Hf, the left factors and the residual rows, a measurement a thread
  {
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f},
                            {-sp * cs, -cp * ss}};
    for (int l = tid; l < L; l += NT) {
      const size_t fl = (size_t)f * L + l;
      float A[2][3];
      hf_rows(Rcl, tcl, fl, l < teff, l == 0, epf, rho, Ja, eps, A);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) hf[(2 * l + a) * 3 + c] = A[a][c];
      left_rows(Rcl, tcl, Rrl, fl, Rb, epf, rho, eps, &left[l * 2]);
      if (rtile) {
        float rr[2];
        res_rows(z, Rcr, tcr, fl, l < teff, epf, rho, eps, rr);
        res[2 * l] = rr[0];
        res[2 * l + 1] = rr[1];
      }
    }
  }
  __syncthreads();

  float2* out = reinterpret_cast<float2*>(hx_out + (size_t)f * R2 * XC + oc);
  if (warp == 0) {
    // step: warp 0, the reflections of jac_project_kernel, a row of Hf at a
    // time, then T
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
    // T from beta_k and g = (v0.v1, v0.v2, v1.v2) (LAPACK's larft order)
    float gv[3] = {0.f, 0.f, 0.f};
    for (int row = lane; row < R2; row += 32) {
      const float v0 = vsh[row], v1 = vsh[R2 + row], v2 = vsh[2 * R2 + row];
      gv[0] = fmaf(v0, v1, gv[0]);
      gv[1] = fmaf(v0, v2, gv[1]);
      gv[2] = fmaf(v1, v2, gv[2]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) gv[i] = rvio::warp_sum(gv[i]);
    if (lane == 0) {
      const float b0 = scal[0], b1 = scal[1], b2 = scal[2];
      const float t01 = -b0 * b1 * gv[0];
      scal[3] = hfn;
      scal[4] = b0;
      scal[5] = t01;
      scal[6] = -b2 * fmaf(b0, gv[1], t01 * gv[2]);
      scal[7] = b1;
      scal[8] = -b2 * b1 * gv[2];
      scal[9] = b2;
      if (rtile) hfn_out[f] = hfn;
    }
  } else if (oc < XC) {
    // step: warps 1-3, the zeros that need no reflector: a column outside
    // the chain, and the masked rows past 2 t_eff of the others
    for (int row = g; row < R2; row += WY_GROUP)
      if (jj < 0 || row >= rend)
        out[(size_t)row * stride] = make_float2(0.f, 0.f);
  }
  __syncthreads();                  // the reflectors are in
  const int ncols = scal[3] < 1e-4f ? 2 : 3;

  if (warp == 0) {
    // step: r (tile 0): w = V^T r over the lanes, then r - V T^T w
    if (!rtile) return;
    float w[3] = {0.f, 0.f, 0.f}, u[3];
    for (int row = lane; row < R2; row += 32)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = fmaf(vsh[k * R2 + row], res[row], w[k]);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = rvio::warp_sum(w[k]);
    wy_coefficients(scal + 4, w, u);
    for (int row = lane; row < R2; row += 32) {
      float v = res[row];
#pragma unroll
      for (int k = 0; k < 3; ++k) v = fmaf(-u[k], vsh[k * R2 + row], v);
      r_out[(size_t)f * R2 + row] = row >= ncols && row < rend ? v : 0.f;
    }
    return;
  }

  const bool live = jj >= 0;
  if (!__any_sync(0xffffffffu, live)) return;
  // step: pass 1, the lane's part of w = V^T c for both columns over its
  // rows of c's entries (measurements jj < i < t_eff), summed over the pair
  float w[2][3] = {}, u[2][3];
  const int r0 = __reduce_min_sync(0xffffffffu, live ? 2 * (jj + 1) : R2) &
                 ~(WY_GROUP - 1);
#pragma unroll 2
  for (int row = r0 + g; row < rend; row += WY_GROUP) {
    const bool on = live && row >= 2 * (jj + 1);
    const float4 lf = left[row];
    float c[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      c[q] = on ? lf.x * s3[q][0] + lf.y * s3[q][1] + lf.z * s3[q][2] : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = vsh[k * R2 + row];
#pragma unroll
      for (int q = 0; q < 2; ++q) w[q][k] = fmaf(v, c[q], w[q][k]);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 1; o < WY_GROUP; o <<= 1)
        w[q][k] += __shfl_xor_sync(0xffffffffu, w[q][k], o);
#pragma unroll
  for (int q = 0; q < 2; ++q) wy_coefficients(scal + 4, w[q], u[q]);
  // step: pass 2, c - V T^T w on the lane's rows before 2 t_eff, masked
  // below Ncols, each row stored once
  if (!live) return;
#pragma unroll 2
  for (int row = g; row < rend; row += WY_GROUP) {
    float val[2] = {0.f, 0.f};
    if (row >= ncols) {
      const bool on = row >= 2 * (jj + 1);
      const float4 lf = left[row];
      const float v[3] = {vsh[row], vsh[R2 + row], vsh[2 * R2 + row]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float x = on ? lf.x * s3[q][0] + lf.y * s3[q][1] + lf.z * s3[q][2]
                     : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) x = fmaf(-u[q][k], v[k], x);
        val[q] = x;
      }
    }
    out[(size_t)row * stride] = make_float2(val[0], val[1]);
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

// r, Hx and hfn of F features by `route` (the wrapper's dispatch,
// ops/jac_project.py `kernel_route`): 0 the compiled row bounds (L <= 64),
// 1 the wide kernel (any L >= 2).
int rvio_jac_project_route(const float* z, const float* Rcl, const float* tcl,
                           const float* Rrl, const float* trl,
                           const float* Rcr, const float* tcr,
                           const float* phi, const float* psi,
                           const float* rho, const long long* teff,
                           const long long* c0, const float* Rbc,
                           const float* tbc, float* r_out, float* hx_out,
                           float* hfn_out, int F, int L, int M, float eps,
                           int route, cudaStream_t stream) {
  if (L < 2 || M < 1 || route < 0 || route > 1 || (route == 0 && L > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  if (route == 0)
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
  const dim3 grid(F, (3 * M + WY_PAIRS - 1) / WY_PAIRS);   // tiles of pairs
  jac_project_wide_kernel<<<grid, NT, smem, stream>>>(
      z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, teff, c0, Rbc, tbc,
      r_out, hx_out, hfn_out, L, M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
