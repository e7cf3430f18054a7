// Batched inverse-depth Levenberg-Marquardt triangulation of MSCKF features.
//
// Replaces rvio_tpu/ops/lm_triangulate.py (lm_triangulate_pallas /
// _lm_kernel); the arithmetic follows filter/update._lm_triangulate of the
// JAX package (reference: Updater.cc:144-263).  One thread per feature:
// [phi, psi, rho], lambda and the 3x3 normal equations live in registers;
// the L measurements are read from device memory (L1-resident after the
// first of the fixed `iters` iterations).  The angles are seeded in-kernel
// with atan2f.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEpsDepth = 1e-12f;
constexpr float kAngleBound = 0.5f * 3.14f;   // Updater.cc:154

__device__ inline float safe_z(float z) {
  return fabsf(z) < kEpsDepth ? (z < 0.f ? -kEpsDepth : kEpsDepth) : z;
}

__global__ void lm_kernel(const float* __restrict__ z,
                          const float* __restrict__ Rc,
                          const float* __restrict__ tc,
                          const int* __restrict__ tlen,
                          float* __restrict__ phi_out,
                          float* __restrict__ psi_out,
                          float* __restrict__ rho_out,
                          bool* __restrict__ ok_out,
                          int F, int L, int iters, float rinv) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float* zf = z + (size_t)f * L * 2;
  const float* Rf = Rc + (size_t)f * L * 9;
  const float* tf = tc + (size_t)f * L * 3;
  const int tl = tlen[f];

  const float z0x = zf[0], z0y = zf[1];
  float phi = atan2f(z0y, sqrtf(z0x * z0x + 1.f));
  float psi = atan2f(z0x, 1.f);
  const bool ok0 = fabsf(phi) <= kAngleBound && fabsf(psi) <= kAngleBound;
  float rho = 0.f, lam = 0.01f, last = INFINITY;
  bool done = false;

  for (int it = 0; it < iters; ++it) {
    const float sp = sinf(phi), cp = cosf(phi), ss = sinf(psi), cs = cosf(psi);
    const float e[3] = {cp * ss, sp, cp * cs};
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f}, {-sp * cs, -cp * ss}};
    float cost = 0.f, HTH[3][3] = {}, HTe[3] = {};
    for (int l = 0; l < L && l < tl; ++l) {
      const float* R = Rf + l * 9;
      const float* t = tf + l * 3;
      float h[3];
      for (int i = 0; i < 3; ++i)
        h[i] = R[3 * i] * e[0] + R[3 * i + 1] * e[1] + R[3 * i + 2] * e[2] + rho * t[i];
      const float hz = safe_z(h[2]);
      const float zi = 1.f / hz;
      const float ex = zf[2 * l] - h[0] / hz;
      const float ey = zf[2 * l + 1] - h[1] / hz;
      const float Hp[2][3] = {{zi, 0.f, -h[0] * zi * zi}, {0.f, zi, -h[1] * zi * zi}};
      float RJ[3][2];
      for (int c = 0; c < 3; ++c)
        for (int b = 0; b < 2; ++b)
          RJ[c][b] = R[3 * c] * Ja[0][b] + R[3 * c + 1] * Ja[1][b] + R[3 * c + 2] * Ja[2][b];
      float H[2][3];
      for (int a = 0; a < 2; ++a) {
        for (int b = 0; b < 2; ++b)
          H[a][b] = Hp[a][0] * RJ[0][b] + Hp[a][1] * RJ[1][b] + Hp[a][2] * RJ[2][b];
        // first measurement: d/d rho is exactly zero (Updater.cc:195)
        H[a][2] = l == 0 ? 0.f : Hp[a][0] * t[0] + Hp[a][1] * t[1] + Hp[a][2] * t[2];
      }
      cost += ex * ex + ey * ey;
      for (int b = 0; b < 3; ++b) {
        for (int c = 0; c < 3; ++c) HTH[b][c] += H[0][b] * H[0][c] + H[1][b] * H[1][c];
        HTe[b] += H[0][b] * ex + H[1][b] * ey;
      }
    }
    cost *= rinv;
    for (int b = 0; b < 3; ++b) {
      for (int c = 0; c < 3; ++c) HTH[b][c] *= rinv;
      HTe[b] *= rinv;
    }

    const bool down = cost <= last;
    float A[3][3];
    for (int b = 0; b < 3; ++b)
      for (int c = 0; c < 3; ++c) A[b][c] = b == c ? HTH[b][c] + lam * HTH[b][c] : HTH[b][c];
    // closed-form adjugate 3x3 solve, as in the JAX package
    const float c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
    const float c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
    const float c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
    const float det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02;
    const float dets = fabsf(det) < 1e-30f ? 1e-30f : det;
    float d0 = (c00 * HTe[0] + (A[0][2] * A[2][1] - A[0][1] * A[2][2]) * HTe[1]
                + (A[0][1] * A[1][2] - A[0][2] * A[1][1]) * HTe[2]) / dets;
    float d1 = (c01 * HTe[0] + (A[0][0] * A[2][2] - A[0][2] * A[2][0]) * HTe[1]
                + (A[0][2] * A[1][0] - A[0][0] * A[1][2]) * HTe[2]) / dets;
    float d2 = (c02 * HTe[0] + (A[0][1] * A[2][0] - A[0][0] * A[2][1]) * HTe[1]
                + (A[0][0] * A[1][1] - A[0][1] * A[1][0]) * HTe[2]) / dets;
    d0 = isfinite(d0) ? d0 : 0.f;
    d1 = isfinite(d1) ? d1 : 0.f;
    d2 = isfinite(d2) ? d2 : 0.f;
    const bool take = down && !done;
    if (take) {
      phi += d0;
      psi += d1;
      rho += d2;
    }
    const bool conv = fabsf(last - cost) < 1e-6f && d2 < 1e-6f;
    if (!done) {
      lam = down ? lam * 0.1f : lam * 10.f;
      last = cost;
    }
    done = done || (take && conv);
  }

  phi_out[f] = phi;
  psi_out[f] = psi;
  rho_out[f] = rho;
  ok_out[f] = ok0 && fabsf(phi) <= kAngleBound && fabsf(psi) <= kAngleBound &&
              isfinite(rho) && rho >= 0.f && isfinite(phi) && isfinite(psi);
}

}  // namespace

extern "C" {

int rvio_lm_triangulate(const float* z, const float* Rc, const float* tc,
                        const int* tlen, float* phi, float* psi, float* rho,
                        bool* ok, int F, int L, int iters, float rinv,
                        cudaStream_t stream) {
  if (F == 0) return 0;
  const int threads = 128;
  lm_kernel<<<(F + threads - 1) / threads, threads, 0, stream>>>(
      z, Rc, tc, tlen, phi, psi, rho, ok, F, L, iters, rinv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
