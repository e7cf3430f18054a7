// Batched inverse-depth Levenberg-Marquardt triangulation of MSCKF features
// (K2).
//
// Replaces rvio_tpu/ops/lm_triangulate.py (lm_triangulate_pallas /
// _lm_kernel); the arithmetic follows filter/update._lm_triangulate of the
// JAX package (reference: Updater.cc:144-263): 10 fixed iterations over the
// feature's measurements, the masked lambda schedule, the closed-form
// adjugate 3x3 solve and the validity flags.
//
// Bound on the H100 at the operating point (F = 100, L = 15, f32): the call
// reads about 84 KB and needs about 2 MFLOP (ops/checks.py), 0.0155 us at
// the card's peaks, so it is bound by latency: 10 dependent iterations,
// each a sum over the measurements.  The first design ran one thread per
// feature (100 features in one block on one SM, each thread walking 10 x 15
// dependent steps with sinf/cosf, divides and L1 loads): 47.25 us a launch,
// and this one 8.47 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).  It
// gives each feature a warp: lane l holds measurement l (and l + 32) in
// registers, loaded once; beyond 64 the lanes read the rest from device
// memory in strides of 32.  An
// iteration costs one sincosf pair, each lane's residual and 2x3 Jacobian,
// and a __shfl_xor_sync butterfly over the ten sums (cost, the six entries
// of H^T H, the three of H^T e).  Addition is commutative, so every lane
// ends the butterfly with bitwise the same sums, solves the same 3x3
// system and takes the same branch of the lambda bookkeeping: no
// broadcast, no shared memory, no barrier.  Four warps a block, so F = 100
// spreads over 25 SMs.  The sums run in a tree, not in measurement order:
// that is the only change in the arithmetic.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEpsDepth = 1e-12f;
constexpr float kAngleBound = 0.5f * 3.14f;   // Updater.cc:154
constexpr int WARPS = 4;                      // features a block
constexpr int NSUM = 10;                      // cost, H^T H (6), H^T e (3)
constexpr int MSLOTS = 2;                     // measurements a lane keeps

__device__ inline float safe_z(float z) {
  return fabsf(z) < kEpsDepth ? (z < 0.f ? -kEpsDepth : kEpsDepth) : z;
}

// One measurement's contribution to the ten sums at the point (e, rho):
// its residual and its rows of H = d(residual)/d[phi, psi, rho] (the rho
// column exactly zero for the feature's first measurement, Updater.cc:195).
__device__ __forceinline__ void add_measurement(
    float zx, float zy, const float (&R)[9], const float (&t)[3], bool first,
    const float (&e)[3], const float (&Ja)[3][2], float rho,
    float (&s)[NSUM]) {
  float h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = R[3 * i] * e[0] + R[3 * i + 1] * e[1] + R[3 * i + 2] * e[2] + rho * t[i];
  const float hz = safe_z(h[2]);
  const float zi = 1.f / hz;
  const float ex = zx - h[0] / hz;
  const float ey = zy - h[1] / hz;
  const float Hp[2][3] = {{zi, 0.f, -h[0] * zi * zi}, {0.f, zi, -h[1] * zi * zi}};
  float RJ[3][2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      RJ[c][b] = R[3 * c] * Ja[0][b] + R[3 * c + 1] * Ja[1][b] + R[3 * c + 2] * Ja[2][b];
  float H[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      H[a][b] = Hp[a][0] * RJ[0][b] + Hp[a][1] * RJ[1][b] + Hp[a][2] * RJ[2][b];
    H[a][2] = first ? 0.f : Hp[a][0] * t[0] + Hp[a][1] * t[1] + Hp[a][2] * t[2];
  }
  s[0] += ex * ex + ey * ey;
  int k = 1;
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int c = b; c < 3; ++c) s[k++] += H[0][b] * H[0][c] + H[1][b] * H[1][c];
#pragma unroll
  for (int b = 0; b < 3; ++b) s[7 + b] += H[0][b] * ex + H[1][b] * ey;
}

__device__ __forceinline__ void load_measurement(const float* zf,
                                                 const float* Rf,
                                                 const float* tf, int m,
                                                 float& zx, float& zy,
                                                 float (&R)[9], float (&t)[3]) {
  zx = zf[2 * m];
  zy = zf[2 * m + 1];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = Rf[9 * m + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tf[3 * m + i];
}

// A lane keeps measurements lane + 32 s, s < MSLOTS, in registers and
// reads any beyond 32 MSLOTS from device memory each iteration.
__global__ void __launch_bounds__(32 * WARPS)
lm_kernel(const float* __restrict__ z, const float* __restrict__ Rc,
          const float* __restrict__ tc, const int* __restrict__ tlen,
          float* __restrict__ phi_out, float* __restrict__ psi_out,
          float* __restrict__ rho_out, bool* __restrict__ ok_out, int F,
          int L, int iters, float rinv) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (f >= F) return;                       // the whole warp
  const float* zf = z + (size_t)f * L * 2;
  const float* Rf = Rc + (size_t)f * L * 9;
  const float* tf = tc + (size_t)f * L * 3;
  const int mlen = min(L, tlen[f]);

  float mz[MSLOTS][2], mR[MSLOTS][9], mt[MSLOTS][3];
#pragma unroll
  for (int s = 0; s < MSLOTS; ++s) {
    const int m = lane + 32 * s;
    if (m < mlen) {
      load_measurement(zf, Rf, tf, m, mz[s][0], mz[s][1], mR[s], mt[s]);
    } else {
      mz[s][0] = mz[s][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) mR[s][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) mt[s][i] = 0.f;
    }
  }

  const float z0x = zf[0], z0y = zf[1];
  float phi = atan2f(z0y, sqrtf(z0x * z0x + 1.f));
  float psi = atan2f(z0x, 1.f);
  const bool ok0 = fabsf(phi) <= kAngleBound && fabsf(psi) <= kAngleBound;
  float rho = 0.f, lam = 0.01f, last = INFINITY;
  bool done = false;

  for (int it = 0; it < iters; ++it) {
    float sp, cp, ss, cs;
    sincosf(phi, &sp, &cp);
    sincosf(psi, &ss, &cs);
    const float e[3] = {cp * ss, sp, cp * cs};
    const float Ja[3][2] = {{-sp * ss, cp * cs}, {cp, 0.f}, {-sp * cs, -cp * ss}};
    float s[NSUM] = {};
#pragma unroll
    for (int q = 0; q < MSLOTS; ++q)
      if (lane + 32 * q < mlen)
        add_measurement(mz[q][0], mz[q][1], mR[q], mt[q], lane + 32 * q == 0,
                        e, Ja, rho, s);
    for (int m = lane + 32 * MSLOTS; m < mlen; m += 32) {
      float zx, zy, R[9], t[3];
      load_measurement(zf, Rf, tf, m, zx, zy, R, t);
      add_measurement(zx, zy, R, t, false, e, Ja, rho, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < NSUM; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);

    const float cost = s[0] * rinv;
    const float h00 = s[1] * rinv, h01 = s[2] * rinv, h02 = s[3] * rinv;
    const float h11 = s[4] * rinv, h12 = s[5] * rinv, h22 = s[6] * rinv;
    const float HTe[3] = {s[7] * rinv, s[8] * rinv, s[9] * rinv};
    const bool down = cost <= last;
    const float A[3][3] = {{h00 + lam * h00, h01, h02},
                           {h01, h11 + lam * h11, h12},
                           {h02, h12, h22 + lam * h22}};
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

  if (lane == 0) {
    phi_out[f] = phi;
    psi_out[f] = psi;
    rho_out[f] = rho;
    ok_out[f] = ok0 && fabsf(phi) <= kAngleBound && fabsf(psi) <= kAngleBound &&
                isfinite(rho) && rho >= 0.f && isfinite(phi) && isfinite(psi);
  }
}

}  // namespace

extern "C" {

int rvio_lm_triangulate(const float* z, const float* Rc, const float* tc,
                        const int* tlen, float* phi, float* psi, float* rho,
                        bool* ok, int F, int L, int iters, float rinv,
                        cudaStream_t stream) {
  if (F == 0) return 0;
  lm_kernel<<<(F + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(
      z, Rc, tc, tlen, phi, psi, rho, ok, F, L, iters, rinv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
