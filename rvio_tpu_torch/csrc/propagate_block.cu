// Whole-frame IMU propagation: K sequential samples in one launch.
//
// Replaces rvio_tpu/ops/propagate_block.py (propagate_block_pallas /
// _propagate_kernel); the arithmetic follows the sequential recursion of
// filter/propagation._propagate_sequential in the JAX package (reference:
// PreIntegrator.cc:97-191).  One thread block per stream b (B streams in
// one launch), 576 threads = one per entry of the 24x24 P, Phi and Psi,
// all four 24x24 matrices in shared memory.  Per sample:
//
//   a. every thread resets its entry of Phi to I (and of G to 0);
//   b. thread 0 writes the sparse 3x3 blocks of Phi = I + dt F and of the
//      noise map G, then advances the state (dR, Rk, dp, dv, pk, vk, gk) in
//      its registers;
//   c. every thread computes its entry of Q = (dt G Sigma) G^T, Phi Psi and
//      Phi P;  d. P <- (Phi P) Phi^T + Q.
//
// Padded samples carry dt = 0, an exact identity step.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int N = 24;

__device__ inline void skew3(const float v[3], float s[3][3]) {
  s[0][0] = 0.f;   s[0][1] = -v[2]; s[0][2] = v[1];
  s[1][0] = v[2];  s[1][1] = 0.f;   s[1][2] = -v[0];
  s[2][0] = -v[1]; s[2][1] = v[0];  s[2][2] = 0.f;
}

__device__ inline void mm3(const float a[3][3], const float b[3][3], float c[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

// c = a^T b
__device__ inline void mm3_tn(const float a[3][3], const float b[3][3], float c[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[0][i] * b[0][j] + a[1][i] * b[1][j] + a[2][i] * b[2][j];
}

__device__ inline void mv3(const float a[3][3], const float v[3], float o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
}

__global__ void __launch_bounds__(N * N) propagate_block_kernel(
    const float* __restrict__ w, const float* __restrict__ a,
    const float* __restrict__ dte, const float* __restrict__ R0,
    const float* __restrict__ vR_, const float* __restrict__ gR_,
    const float* __restrict__ bg_, const float* __restrict__ ba_,
    const float* __restrict__ P0, float* __restrict__ Rk_out,
    float* __restrict__ pk_out, float* __restrict__ vk_out,
    float* __restrict__ P_out, float* __restrict__ Psi_out, int K,
    float gravity, float small_angle, float s_g, float s_wg, float s_a,
    float s_wa) {
  __shared__ float P[N][N], Psi[N][N], Phi[N][N], T[N][N], G[N][12];
  __shared__ float s_dt;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / N, j = tid % N;
  const float sig[12] = {s_g, s_g, s_g, s_wg, s_wg, s_wg,
                         s_a, s_a, s_a, s_wa, s_wa, s_wa};

  P[i][j] = P0[(size_t)b * N * N + tid];
  Psi[i][j] = i == j ? 1.f : 0.f;

  // running state, thread 0 only
  float Rk[3][3], dp[3] = {0.f, 0.f, 0.f}, dv[3] = {0.f, 0.f, 0.f};
  float pk[3] = {0.f, 0.f, 0.f}, vk[3], gk[3], vR[3], gR[3], bg[3], ba[3];
  float Dt = 0.f;
  if (tid == 0) {
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Rk[r][c] = R0[(size_t)b * 9 + 3 * r + c];
      vR[r] = vR_[b * 3 + r];
      gR[r] = gR_[b * 3 + r];
      bg[r] = bg_[b * 3 + r];
      ba[r] = ba_[b * 3 + r];
      vk[r] = vR[r];
      gk[r] = gR[r];
    }
  }

  for (int k = 0; k < K; ++k) {
    Phi[i][j] = i == j ? 1.f : 0.f;
    if (tid < N * 12) G[tid / 12][tid % 12] = 0.f;
    __syncthreads();

    if (tid == 0) {
      const size_t s = (size_t)b * K + k;
      const float dt = dte[s];
      s_dt = dt;
      float wv[3], av[3];
      for (int c = 0; c < 3; ++c) {
        wv[c] = w[s * 3 + c] - bg[c];
        av[c] = a[s * 3 + c] - ba[c];
      }
      Dt = Dt + dt;
      float wx[3][3], wx2[3][3], vx[3][3], gx[3][3], RtVx[3][3];
      skew3(wv, wx);
      mm3(wx, wx, wx2);
      skew3(vk, vx);
      skew3(gk, gx);
      mm3_tn(Rk, vx, RtVx);

      // --- Phi = I + dt F, G (PreIntegrator.cc:122-142) ---
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) {
          const float e = r == c ? 1.f : 0.f;
          Phi[9 + r][9 + c] = e + dt * (-wx[r][c]);
          Phi[12 + r][9 + c] = dt * (-RtVx[r][c]);
          Phi[12 + r][15 + c] = dt * Rk[c][r];
          Phi[15 + r][6 + c] = dt * (-gravity * Rk[r][c]);
          Phi[15 + r][9 + c] = dt * (-gravity * gx[r][c]);
          Phi[15 + r][15 + c] = e + dt * (-wx[r][c]);
          Phi[15 + r][18 + c] = dt * (-vx[r][c]);
          G[15 + r][c] = -vx[r][c];
        }
        Phi[9 + r][18 + r] = dt * -1.f;
        Phi[15 + r][21 + r] = dt * -1.f;
        G[9 + r][r] = -1.f;
        G[15 + r][6 + r] = -1.f;
        G[18 + r][3 + r] = 1.f;
        G[21 + r][9 + r] = 1.f;
      }

      // --- state (PreIntegrator.cc:144-178) ---
      const float w1 = sqrtf(wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2]);
      const bool small = w1 < small_angle;
      const float w1s = small ? 1.f : w1;
      const float wdt = w1s * dt;
      float dR[3][3];
      const float csin = small ? dt : sinf(w1s * dt) / w1s;
      const float hs = sinf(0.5f * w1s * dt);
      const float ccos = small ? 0.5f * dt * dt : 2.f * hs * hs / (w1s * w1s);
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          dR[r][c] = (r == c ? 1.f : 0.f) - csin * wx[r][c] + ccos * wx2[r][c];
      float Rn[3][3];
      mm3(dR, Rk, Rn);
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) Rk[r][c] = Rn[r][c];

      const float coswdt = cosf(wdt), sinwdt = sinf(wdt);
      const float hw = sinf(0.5f * wdt);
      const float one_m_cos = 2.f * hw * hw;
      const float w3 = w1s * w1s * w1s, w4 = w3 * w1s;
      const float f1 = small ? -dt * dt * dt / 3.f : (wdt * coswdt - sinwdt) / w3;
      const float f2 = small ? dt * dt * dt * dt / 8.f
                             : 0.5f * (wdt * wdt + 2.f * one_m_cos - 2.f * wdt * sinwdt) / w4;
      const float f3 = small ? -dt * dt / 2.f : -one_m_cos / (w1s * w1s);
      const float f4 = small ? dt * dt * dt / 6.f : (wdt - sinwdt) / w3;
      float Mp[3][3], Mv[3][3];
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
          const float e = r == c ? 1.f : 0.f;
          Mp[r][c] = (0.5f * dt * dt) * e + f1 * wx[r][c] + f2 * wx2[r][c];
          Mv[r][c] = dt * e + f3 * wx[r][c] + f4 * wx2[r][c];
        }
      float RtM[3][3], ip[3], iv[3];
      mm3_tn(Rk, Mp, RtM);
      mv3(RtM, av, ip);
      mm3_tn(Rk, Mv, RtM);
      mv3(RtM, av, iv);
      for (int c = 0; c < 3; ++c) {
        dp[c] = dp[c] + dv[c] * dt + ip[c];
        dv[c] = dv[c] + iv[c];
      }
      float vin[3];
      for (int c = 0; c < 3; ++c) {
        pk[c] = vR[c] * Dt - (0.5f * gravity) * gR[c] * (Dt * Dt) + dp[c];
        vin[c] = vR[c] - gravity * gR[c] * Dt + dv[c];
      }
      mv3(Rk, vin, vk);
      mv3(Rk, gR, gk);
      const float gn = sqrtf(gk[0] * gk[0] + gk[1] * gk[1] + gk[2] * gk[2]);
      for (int c = 0; c < 3; ++c) gk[c] = gk[c] / gn;
    }
    __syncthreads();

    const float dt = s_dt;
    float q = 0.f;
    for (int c = 0; c < 12; ++c) q += (dt * (G[i][c] * sig[c])) * G[j][c];
    float psi = 0.f, t = 0.f;
    for (int m = 0; m < N; ++m) {
      psi += Phi[i][m] * Psi[m][j];
      t += Phi[i][m] * P[m][j];
    }
    __syncthreads();
    Psi[i][j] = psi;
    T[i][j] = t;
    __syncthreads();
    float p = 0.f;
    for (int m = 0; m < N; ++m) p += T[i][m] * Phi[j][m];
    P[i][j] = p + q;
    __syncthreads();
  }

  P_out[(size_t)b * N * N + tid] = P[i][j];
  Psi_out[(size_t)b * N * N + tid] = Psi[i][j];
  if (tid == 0) {
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Rk_out[(size_t)b * 9 + 3 * r + c] = Rk[r][c];
      pk_out[b * 3 + r] = pk[r];
      vk_out[b * 3 + r] = vk[r];
    }
  }
}

}  // namespace

extern "C" {

int rvio_propagate_block(const float* w, const float* a, const float* dte,
                         const float* R0, const float* vR, const float* gR,
                         const float* bg, const float* ba, const float* P0,
                         float* Rk, float* pk, float* vk, float* P, float* Psi,
                         int B, int K, float gravity, float small_angle,
                         float s_g, float s_wg, float s_a, float s_wa,
                         cudaStream_t stream) {
  if (B == 0) return 0;
  propagate_block_kernel<<<B, N * N, 0, stream>>>(
      w, a, dte, R0, vR, gR, bg, ba, P0, Rk, pk, vk, P, Psi, K, gravity,
      small_angle, s_g, s_wg, s_a, s_wa);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
