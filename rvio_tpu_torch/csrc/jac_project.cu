// Per-feature MSCKF Jacobians + Householder nullspace projection.
//
// Replaces rvio_tpu/ops/jac_project.py (jac_project_pallas /
// _jac_project_kernel); the arithmetic follows filter/update.
// _build_jacobians + _householder_project of the JAX package (reference:
// Updater.cc:278-402).  One thread block per feature:
//
//   1. one thread per measurement l builds the residual row pair, the Hf
//      row pair and the left factor Hp_l R_cb Rrel_l; one thread per chain
//      column jj builds subH_jj = [skew(pb + rho R_j^T t_j) R_j^T | -rho R_{j-1}^T];
//   2. the block fills A = [Hf | Hx | r] (2L x (3 + 6(L-1) + 1), 30 x 88 at
//      L=15) in shared memory, rows in the oracle's (2l + a) order;
//   3. three Householder reflections, each a warp reduction for the
//      reflector and one thread per column for its application;
//   4. the rank check, the residual mask (rows >= Ncols, < 2 t_eff) and the
//      shift of chain column jj to clone column c0 + jj are applied while
//      writing r (F, 2L), Hx (F, 2L, 6M) and ||Hf[:, rho]|| (F,).
//
// The depth guard `eps` is the caller's: 1e-6 for this f32 kernel (the
// TPU kernel's guard; reflector norms square the perspective rows, so
// 1e-12 would overflow f32).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

__device__ inline float safe_z(float z, float eps) {
  return fabsf(z) < eps ? (z < 0.f ? -eps : eps) : z;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void jac_project_kernel(
    const float* __restrict__ z, const float* __restrict__ Rcl,
    const float* __restrict__ tcl, const float* __restrict__ Rrl,
    const float* __restrict__ trl, const float* __restrict__ Rcr,
    const float* __restrict__ tcr, const float* __restrict__ phi_,
    const float* __restrict__ psi_, const float* __restrict__ rho_,
    const int* __restrict__ teff_, const int* __restrict__ c0_,
    const float* __restrict__ Rbc, const float* __restrict__ tbc,
    float* __restrict__ r_out, float* __restrict__ hx_out,
    float* __restrict__ hfn_out, int L, int M, float eps) {
  const int J = L - 1;
  const int R2 = 2 * L;            // rows
  const int NC = 3 + 6 * J + 1;    // columns [Hf | Hx_rel | r]
  extern __shared__ float sh[];
  float* A = sh;                   // R2 * NC
  float* left = A + R2 * NC;       // L * 6   (Hp_l R_cb Rrel_l, l >= 1)
  float* subH = left + L * 6;      // J * 18
  float* vv = subH + J * 18;       // R2, the current reflector
  float* scal = vv + R2;           // [beta, hfn]

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float phi = phi_[f], psi = psi_[f], rho = rho_[f];
  const int teff = teff_[f];
  const float sp = sinf(phi), cp = cosf(phi), ss = sinf(psi), cs = cosf(psi);
  const float epf[3] = {cp * ss, sp, cp * cs};

  if (tid < L) {                   // ---- measurement l ----
    const int l = tid;
    const size_t fl = (size_t)f * L + l;
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f}, {-sp * cs, -cp * ss}};
    const bool mv = l < teff;
    // residual on the current-estimate chain
    const float* Rr = Rcr + fl * 9;
    const float* tr = tcr + fl * 3;
    float hr[3];
    for (int i = 0; i < 3; ++i)
      hr[i] = Rr[3 * i] * epf[0] + Rr[3 * i + 1] * epf[1] + Rr[3 * i + 2] * epf[2] + rho * tr[i];
    const float zr = safe_z(hr[2], eps);
    // linearization chain
    const float* Rl = Rcl + fl * 9;
    const float* tl = tcl + fl * 3;
    float h[3];
    for (int i = 0; i < 3; ++i)
      h[i] = Rl[3 * i] * epf[0] + Rl[3 * i + 1] * epf[1] + Rl[3 * i + 2] * epf[2] + rho * tl[i];
    const float zi = 1.f / safe_z(h[2], eps);
    const float Hp[2][3] = {{zi, 0.f, -h[0] * zi * zi}, {0.f, zi, -h[1] * zi * zi}};
    float RJ[3][2];
    for (int b = 0; b < 3; ++b)
      for (int g = 0; g < 2; ++g)
        RJ[b][g] = Rl[3 * b] * Ja[0][g] + Rl[3 * b + 1] * Ja[1][g] + Rl[3 * b + 2] * Ja[2][g];
    const float* Rrel = Rrl + fl * 9;
    for (int a = 0; a < 2; ++a) {
      float* row = A + (2 * l + a) * NC;
      for (int g = 0; g < 2; ++g)
        row[g] = mv ? Hp[a][0] * RJ[0][g] + Hp[a][1] * RJ[1][g] + Hp[a][2] * RJ[2][g] : 0.f;
      row[2] = (mv && l > 0) ? Hp[a][0] * tl[0] + Hp[a][1] * tl[1] + Hp[a][2] * tl[2] : 0.f;
      row[NC - 1] = mv ? z[fl * 2 + a] - hr[a] / zr : 0.f;
      // left factor: (Hp R_cb Rrel)[a, d] with R_cb = R_bc^T
      float HpRcb[3];
      for (int k = 0; k < 3; ++k)
        HpRcb[k] = Hp[a][0] * Rbc[3 * k] + Hp[a][1] * Rbc[3 * k + 1] + Hp[a][2] * Rbc[3 * k + 2];
      for (int d = 0; d < 3; ++d)
        left[l * 6 + a * 3 + d] = HpRcb[0] * Rrel[d] + HpRcb[1] * Rrel[3 + d] + HpRcb[2] * Rrel[6 + d];
    }
  } else if (tid < L + J) {        // ---- chain column jj ----
    const int jj = tid - L;
    const float* Rj = Rrl + ((size_t)f * L + jj + 1) * 9;
    const float* tj = trl + ((size_t)f * L + jj + 1) * 3;
    const float* Rp = Rrl + ((size_t)f * L + jj) * 9;
    float w[3];
    for (int c = 0; c < 3; ++c) {
      const float pb = Rbc[3 * c] * epf[0] + Rbc[3 * c + 1] * epf[1] + Rbc[3 * c + 2] * epf[2]
                       + rho * tbc[c];
      w[c] = pb + rho * (Rj[c] * tj[0] + Rj[3 + c] * tj[1] + Rj[6 + c] * tj[2]);
    }
    const float dpx[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
    float* s = subH + jj * 18;
    for (int d = 0; d < 3; ++d)
      for (int b = 0; b < 3; ++b) {
        s[d * 6 + b] = dpx[d][0] * Rj[3 * b] + dpx[d][1] * Rj[3 * b + 1] + dpx[d][2] * Rj[3 * b + 2];
        s[d * 6 + 3 + b] = -rho * Rp[3 * b + d];
      }
  }
  __syncthreads();

  // ---- Hx blocks (measurement i >= 1, chain column jj < i, i < t_eff) ----
  const int HC = 6 * J;
  for (int idx = tid; idx < R2 * HC; idx += blockDim.x) {
    const int row = idx / HC, col = idx - row * HC;
    const int i = row >> 1, a = row & 1, jj = col / 6, b = col - jj * 6;
    float v = 0.f;
    if (jj < i && i < teff) {
      const float* lf = left + i * 6 + a * 3;
      const float* s = subH + jj * 18 + b;
      v = lf[0] * s[0] + lf[1] * s[6] + lf[2] * s[12];
    }
    A[row * NC + 3 + col] = v;
  }
  __syncthreads();

  // ---- rank check on the rho column before projection ----
  if (tid < 32) {
    float acc = 0.f;
    for (int r = tid; r < R2; r += 32) acc += A[r * NC + 2] * A[r * NC + 2];
    acc = warp_sum(acc);
    if (tid == 0) scal[1] = sqrtf(acc);
  }

  // ---- three Householder reflections on the rows ----
  for (int k = 0; k < 3; ++k) {
    if (tid < 32) {
      float acc = 0.f;
      for (int r = tid; r < R2; r += 32) {
        const float x = r >= k ? A[r * NC + k] : 0.f;
        acc += x * x;
      }
      const float normx = sqrtf(warp_sum(acc));
      const float xk = A[k * NC + k];
      const float alpha = xk >= 0.f ? -normx : normx;
      float acc2 = 0.f;
      for (int r = tid; r < R2; r += 32) {
        float x = r >= k ? A[r * NC + k] : 0.f;
        if (r == k) x -= alpha;
        vv[r] = x;
        acc2 += x * x;
      }
      const float vnorm2 = warp_sum(acc2);
      if (tid == 0) scal[0] = vnorm2 > 1e-30f ? 2.f / vnorm2 : 0.f;
    }
    __syncthreads();
    const float beta = scal[0];
    for (int c = tid; c < NC; c += blockDim.x) {
      float wc = 0.f;
      for (int r = 0; r < R2; ++r) wc += vv[r] * A[r * NC + c];
      for (int r = 0; r < R2; ++r) A[r * NC + c] -= beta * (vv[r] * wc);
    }
    __syncthreads();
  }

  // ---- masks, absolute clone columns, outputs ----
  const float hfn = scal[1];
  const int ncols = hfn < 1e-4f ? 2 : 3;
  const int c0 = c0_[f];
  if (tid == 0) hfn_out[f] = hfn;
  for (int r = tid; r < R2; r += blockDim.x) {
    const bool keep = r >= ncols && r < 2 * teff;
    r_out[(size_t)f * R2 + r] = keep ? A[r * NC + NC - 1] : 0.f;
  }
  const int XC = 6 * M;
  for (int idx = tid; idx < R2 * XC; idx += blockDim.x) {
    const int r = idx / XC, col = idx - r * XC;
    const int jj = col / 6 - c0, b = col % 6;
    const bool keep = r >= ncols && r < 2 * teff && jj >= 0 && jj < J;
    hx_out[(size_t)f * R2 * XC + idx] = keep ? A[r * NC + 3 + 6 * jj + b] : 0.f;
  }
}

}  // namespace

extern "C" {

int rvio_jac_project(const float* z, const float* Rcl, const float* tcl,
                     const float* Rrl, const float* trl, const float* Rcr,
                     const float* tcr, const float* phi, const float* psi,
                     const float* rho, const int* teff, const int* c0,
                     const float* Rbc, const float* tbc, float* r_out,
                     float* hx_out, float* hfn_out, int F, int L, int M,
                     float eps, cudaStream_t stream) {
  if (F == 0) return 0;
  if (L < 2 || 2 * L - 1 > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int J = L - 1;
  const size_t smem = sizeof(float) *
      (size_t)(2 * L * (3 + 6 * J + 1) + 6 * L + 18 * J + 2 * L + 2);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(jac_project_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  jac_project_kernel<<<F, 128, smem, stream>>>(
      z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, teff, c0, Rbc, tbc,
      r_out, hx_out, hfn_out, L, M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
