// Whole-frame IMU propagation: K sequential samples in one launch (K1).
//
// Replaces rvio_tpu/ops/propagate_block.py (propagate_block_pallas /
// _propagate_kernel); the arithmetic follows the sequential recursion of
// filter/propagation._propagate_sequential in the JAX package (reference:
// PreIntegrator.cc:97-191).
//
// Bound on the H100 at the operating point (B = 1, K = 16, 10-11 samples
// with dt > 0, f32): the call reads 2.8 KB and writes 4.7 KB (2.2 ns at
// 3.35 TB/s) and needs about 12.4 kFLOP a sample (ops/checks.
// propagate_flops), so it is bound by the latency of the samples'
// dependent steps.  The first design ran one block of 576 threads, one per
// entry of the 24 x 24 matrices: a sample cost four block barriers, dense
// 24-term sums for Phi P, Phi Psi and (Phi P) Phi^T, and the whole state
// step (Rodrigues, sinf/cosf, the 3 x 3 products) in thread 0 while 575
// threads waited, about 2700 of its 6000 cycles; all 16 samples ran,
// padding included: 44.14 us a launch (NVIDIA H100 80GB HBM3, 700 W;
// scripts/filter_kernel_phases.py).  This design:
//
//  * runs n = (the last sample with dt != 0) + 1 samples, at least one,
//    read from dte in the kernel.  A trailing dt = 0 sample is a bitwise
//    identity on every output, but the first step of a frame is not (it
//    replaces vk = vR by Rk vR and gk = gR by normalize(Rk gR)), and
//    neither is a dt = 0 sample before a valid one, so only trailing
//    samples are dropped (tests/test_torch_propagation.py pins this);
//  * takes the state recursion off the covariance's path: it does not
//    depend on P, so one warp runs it for all n samples first, while the
//    others load P: the per-sample terms (Rodrigues with accurate
//    sinf/cosf, f1..f4, the integration matrices) one lane a sample, the
//    rotation chain on nine lanes (an entry each, shuffles for the
//    column), the dp/dv sums on three (a component each);
//  * then forms Phi's active rows and Q's block for every sample at once,
//    all threads, one (sample, 3 x 3 entry) each, so no sample waits for
//    its Phi;
//  * uses Phi's structure: Phi = I + dt F differs from the identity only
//    in rows 9..17, and those are zero left of column 6.  So P' =
//    Phi P Phi^T + Q changes only in rows and columns 9..17: T =
//    Phi[9:18] P (18-term sums), P'[9:18, j] = T[:, j] for j outside
//    9..17 (and its mirror), P'[9:18, 9:18] = T Phi[9:18]^T + Q, and Psi'
//    = Phi Psi changes only in rows 9..17.  Outside rows and columns
//    9..17 only Q's diagonal on rows 18..23 changes, so that block is
//    written to both buffers once and never copied.  Three warps take T
//    and P' for three rows each (a P entry loaded once serves the three,
//    Phi's rows read as float4s), their T rows stay with the warp, so the
//    two products need a __syncwarp; three more take Psi'; P and Psi are
//    double-buffered: one block barrier a sample.
//
// Each sum runs in the first design's order over the same nonzero terms.
// One block per stream (B streams in one launch), 224 threads; K <= KMAX
// (Phi, Q and the state of every sample live in dynamic shared memory,
// 20.7 KB at K = 16; from K = 30 it and the static 9.9 KB pass 48 KB,
// which needs the size allowed per device, as the launcher does).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int N = 24;          // the error state
constexpr int A0 = 9;          // rows A0 .. A0 + NA - 1 of Phi are not I's
constexpr int NA = 9;
constexpr int C0 = 6;          // and are zero left of column C0
constexpr int NC = N - C0;
constexpr int PS = 20;         // row stride of Phi's rows and of T (float4s)
constexpr int G = 3;           // row groups of three rows (warps 0..2: T and
                               // P'; warps 3..5: Psi'); warp 6: the state
constexpr int SW = 2 * G;      // the state warp
constexpr int THREADS = 32 * (SW + 1);
constexpr int KMAX = 128;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ inline void ld3(const float* p, float v[3]) {
  for (int c = 0; c < 3; ++c) v[c] = p[c];
}
__device__ inline void st3(float* p, const float v[3]) {
  for (int c = 0; c < 3; ++c) p[c] = v[c];
}
__device__ inline void ld33(const float* p, float m[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) m[r][c] = p[3 * r + c];
}
__device__ inline void st33(float* p, const float m[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) p[3 * r + c] = m[r][c];
}

// Row-major float4 loads of W floats (W a multiple of 4) from shared memory.
template <int W>
__device__ __forceinline__ void ld_row(const float* p, float (&v)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}

// Dynamic shared memory, for every sample k: rows 9..17 of Phi_k (columns
// 6..23, stride PS) and Q_k's block on rows and columns 9..17; then the
// state: dt, the bias-corrected rates, dR, the two integration matrices,
// the increments ip, iv and the running Dt, dp, dv after sample k, and Rk,
// vk, gk before it (entry n holds the values after the last sample).
struct Samples {
  float *phi, *Q;
  float *dt, *wv, *av, *dR, *Mp, *Mv, *ip, *iv, *Dt, *dp, *dv, *R, *v, *g;
};

__host__ __device__ constexpr int sample_floats(int K) {
  return (NA * PS + NA * NA + 62) * K + 15;
}

__device__ inline Samples carve(float* p, int K) {
  Samples s;
  s.phi = p; p += NA * PS * K;
  s.Q = p; p += NA * NA * K;
  s.dt = p; p += K;
  s.wv = p; p += 3 * K;
  s.av = p; p += 3 * K;
  s.dR = p; p += 9 * K;
  s.Mp = p; p += 9 * K;
  s.Mv = p; p += 9 * K;
  s.ip = p; p += 3 * K;
  s.iv = p; p += 3 * K;
  s.Dt = p; p += K;
  s.dp = p; p += 3 * K;
  s.dv = p; p += 3 * K;
  s.R = p; p += 9 * (K + 1);
  s.v = p; p += 3 * (K + 1);
  s.g = p;
  return s;
}

// Entry (r, c) of skew(v) for v in shared memory.
__device__ inline float skew_at(const float* v, int r, int c) {
  if (r == c) return 0.f;
  const float x = v[3 - r - c];
  return (c - r + 3) % 3 == 1 ? -x : x;
}

// Part e of sample k's rows 9..17 of Phi and Q block (PreIntegrator.cc:
// 122-142): e < 9 writes entry (e / 3, e % 3) of Phi's ten nonzero 3 x 3
// blocks, 9 <= e < 18 that of Q's four.  The other entries were zeroed.
// The state is read from shared memory where it lies (a lane-dependent
// index into a register array would go to local memory).
__device__ inline void form(const Samples& s, int k, int e, float gravity,
                            float s_g, float s_a) {
  const int r = (e % 9) / 3, c = e % 3;
  const float dt = s.dt[k];
  const float* v = s.v + 3 * k;
  if (e < 9) {
    const float* Rk = s.R + 9 * k;
    const float* wv = s.wv + 3 * k;
    const float RtVx = Rk[r] * skew_at(v, 0, c) + Rk[3 + r] * skew_at(v, 1, c) +
                       Rk[6 + r] * skew_at(v, 2, c);
    const float id = r == c ? 1.f : 0.f;
    const float mdt = r == c ? dt * -1.f : 0.f;
    float* Ph = s.phi + NA * PS * k;
    auto phi = [&](int row, int col) -> float& {
      return Ph[(row - A0) * PS + col - C0];
    };
    phi(9 + r, 9 + c) = id + dt * (-skew_at(wv, r, c));
    phi(9 + r, 18 + c) = mdt;
    phi(12 + r, 9 + c) = dt * (-RtVx);
    phi(12 + r, 12 + c) = id;
    phi(12 + r, 15 + c) = dt * Rk[3 * c + r];
    phi(15 + r, 6 + c) = dt * (-gravity * Rk[3 * r + c]);
    phi(15 + r, 9 + c) = dt * (-gravity * skew_at(s.g + 3 * k, r, c));
    phi(15 + r, 15 + c) = id + dt * (-skew_at(wv, r, c));
    phi(15 + r, 18 + c) = dt * (-skew_at(v, r, c));
    phi(15 + r, 21 + c) = mdt;
  } else {
    // Q = (dt G Sigma) G^T, its terms in the first design's order; G's
    // rows 9..11 are -I in columns 0..2, rows 15..17 -vx there and -I in
    // columns 6..8 (rows 12..14 are zero)
    float* Q = s.Q + NA * NA * k;
    float q = 0.f;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      q = fmaf(dt * (-skew_at(v, r, m) * s_g), -skew_at(v, c, m), q);
    if (r == c) q = fmaf(dt * (-1.f * s_a), -1.f, q);
    Q[r * NA + c] = r == c ? dt * (-1.f * s_g) * -1.f : 0.f;
    Q[r * NA + 6 + c] = (dt * (-1.f * s_g)) * (-skew_at(v, c, r));
    Q[(6 + r) * NA + c] = (dt * (-skew_at(v, r, c) * s_g)) * -1.f;
    Q[(6 + r) * NA + 6 + c] = q;
  }
}

// The state warp: the trip count, then the state recursion for all n
// samples (PreIntegrator.cc:144-178).  Writes Rk, pk and vk after the last
// sample.  Returns n.
__device__ int state(const Samples& s, int lane, int b, int K,
                     const float* __restrict__ w, const float* __restrict__ a,
                     const float* __restrict__ dte,
                     const float* __restrict__ R0,
                     const float* __restrict__ vR_,
                     const float* __restrict__ gR_,
                     const float* __restrict__ bg_,
                     const float* __restrict__ ba_, float* __restrict__ Rk_out,
                     float* __restrict__ pk_out, float* __restrict__ vk_out,
                     float gravity, float small_angle) {
  const size_t bK = (size_t)b * K;
  float vR[3], gR[3], bg[3], ba[3];
  ld3(vR_ + 3 * b, vR);
  ld3(gR_ + 3 * b, gR);
  ld3(bg_ + 3 * b, bg);
  ld3(ba_ + 3 * b, ba);
  const float R0e = lane < 9 ? R0[(size_t)b * 9 + lane] : 0.f;
  if (lane < 9) s.R[lane] = R0e;
  if (lane == 0) {
    st3(s.v, vR);
    st3(s.g, gR);
  }
  // one lane a sample: its inputs (loaded together with the trip count's
  // dt) and its terms, for every sample (the padding costs nothing here)
  int last = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < K;
    float dt = 0.f, wv[3], av[3];
    for (int c = 0; c < 3; ++c) {
      wv[c] = in ? w[(bK + k) * 3 + c] - bg[c] : 0.f;
      av[c] = in ? a[(bK + k) * 3 + c] - ba[c] : 0.f;
    }
    if (in) dt = dte[bK + k];
    const unsigned nz = __ballot_sync(FULL, dt != 0.f);
    if (nz) last = k0 + 31 - __clz(nz);
    if (!in) continue;
    float wx[3][3], wx2[3][3];
    skew3(wv, wx);
    mm3(wx, wx, wx2);
    const float w1 = sqrtf(wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2]);
    const bool small = w1 < small_angle;
    const float w1s = small ? 1.f : w1;
    const float wdt = w1s * dt;
    const float sinwdt = sinf(wdt), coswdt = cosf(wdt);
    // sin(w dt / 2): 0.5 w1s dt rounds alike in either order (a halving is
    // exact), so the plain version's two such sines are this one
    const float hw = sinf(0.5f * wdt);
    const float csin = small ? dt : sinwdt / w1s;
    const float ccos = small ? 0.5f * dt * dt : 2.f * hw * hw / (w1s * w1s);
    const float one_m_cos = 2.f * hw * hw;
    const float w3 = w1s * w1s * w1s, w4 = w3 * w1s;
    const float f1 = small ? -dt * dt * dt / 3.f : (wdt * coswdt - sinwdt) / w3;
    const float f2 = small ? dt * dt * dt * dt / 8.f
                           : 0.5f * (wdt * wdt + 2.f * one_m_cos - 2.f * wdt * sinwdt) / w4;
    const float f3 = small ? -dt * dt / 2.f : -one_m_cos / (w1s * w1s);
    const float f4 = small ? dt * dt * dt / 6.f : (wdt - sinwdt) / w3;
    float dR[3][3], Mp[3][3], Mv[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        const float e = r == c ? 1.f : 0.f;
        dR[r][c] = e - csin * wx[r][c] + ccos * wx2[r][c];
        Mp[r][c] = (0.5f * dt * dt) * e + f1 * wx[r][c] + f2 * wx2[r][c];
        Mv[r][c] = dt * e + f3 * wx[r][c] + f4 * wx2[r][c];
      }
    s.dt[k] = dt;
    st3(s.wv + 3 * k, wv);
    st3(s.av + 3 * k, av);
    st33(s.dR + 9 * k, dR);
    st33(s.Mp + 9 * k, Mp);
    st33(s.Mv + 9 * k, Mv);
  }
  const int n = last + 1;
  __syncwarp();
  // the rotation chain Rk <- dR Rk: lane 3 r + c holds entry (r, c) and
  // takes column c from its neighbours
  {
    const int e = lane < 9 ? lane : 0, r = e / 3, c = e % 3;
    float R = R0e;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float* dR = s.dR + 9 * k;
      const float r0 = __shfl_sync(FULL, R, c);
      const float r1 = __shfl_sync(FULL, R, 3 + c);
      const float r2 = __shfl_sync(FULL, R, 6 + c);
      R = dR[3 * r] * r0 + dR[3 * r + 1] * r1 + dR[3 * r + 2] * r2;
      if (lane < 9) s.R[9 * (k + 1) + lane] = R;
    }
  }
  __syncwarp();
  // the increments Rk^T Mp a, Rk^T Mv a with the rotation after sample k
  for (int k = lane; k < n; k += 32) {
    float Rk[3][3], M[3][3], RtM[3][3], av[3], o[3];
    ld33(s.R + 9 * (k + 1), Rk);
    ld3(s.av + 3 * k, av);
    ld33(s.Mp + 9 * k, M);
    mm3_tn(Rk, M, RtM);
    mv3(RtM, av, o);
    st3(s.ip + 3 * k, o);
    ld33(s.Mv + 9 * k, M);
    mm3_tn(Rk, M, RtM);
    mv3(RtM, av, o);
    st3(s.iv + 3 * k, o);
  }
  __syncwarp();
  // the running sums Dt, dp, dv: lane c < 3 the component c
  if (lane < 3) {
    float Dt = 0.f, dp = 0.f, dv = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float dt = s.dt[k];
      Dt = Dt + dt;
      dp = dp + dv * dt + s.ip[3 * k + lane];
      dv = dv + s.iv[3 * k + lane];
      if (lane == 0) s.Dt[k] = Dt;
      s.dp[3 * k + lane] = dp;
      s.dv[3 * k + lane] = dv;
    }
  }
  __syncwarp();
  // pk, vk and gk after each sample
  for (int k = lane; k < n; k += 32) {
    const float Dt = s.Dt[k];
    float Rk[3][3], pk[3], vin[3], vk[3], gk[3];
    ld33(s.R + 9 * (k + 1), Rk);
    for (int c = 0; c < 3; ++c) {
      pk[c] = vR[c] * Dt - (0.5f * gravity) * gR[c] * (Dt * Dt) + s.dp[3 * k + c];
      vin[c] = vR[c] - gravity * gR[c] * Dt + s.dv[3 * k + c];
    }
    mv3(Rk, vin, vk);
    mv3(Rk, gR, gk);
    const float gn = sqrtf(gk[0] * gk[0] + gk[1] * gk[1] + gk[2] * gk[2]);
    for (int c = 0; c < 3; ++c) gk[c] = gk[c] / gn;
    st3(s.v + 3 * (k + 1), vk);
    st3(s.g + 3 * (k + 1), gk);
    if (k == n - 1) {
      st33(Rk_out + (size_t)b * 9, Rk);
      st3(pk_out + 3 * b, pk);
      st3(vk_out + 3 * b, vk);
    }
  }
  return n;
}

__global__ void __launch_bounds__(THREADS) propagate_block_kernel(
    const float* __restrict__ w, const float* __restrict__ a,
    const float* __restrict__ dte, const float* __restrict__ R0,
    const float* __restrict__ vR, const float* __restrict__ gR,
    const float* __restrict__ bg, const float* __restrict__ ba,
    const float* __restrict__ P0, float* __restrict__ Rk_out,
    float* __restrict__ pk_out, float* __restrict__ vk_out,
    float* __restrict__ P_out, float* __restrict__ Psi_out, int K,
    float gravity, float small_angle, float s_g, float s_wg, float s_a,
    float s_wa) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float P[2][N * N], Psi[2][N * N];
  __shared__ __align__(16) float T[NA][PS];   // T = Phi[9:18] P, columns 6..
  __shared__ int s_n;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Samples s = carve(dyn, K);

  // phase: load P0, zero Phi and Q; the state (warp 6)
  if (warp < SW) {
    // P0 into buffer 0, and its block outside rows and columns 9..17 into
    // buffer 1 too: there a sample changes only the diagonal of rows
    // 18..23, so the block never has to be copied
    for (int e = tid; e < N * N; e += 32 * SW) {
      const float p = P0[(size_t)b * N * N + e];
      const int r = e / N, c = e % N;
      P[0][e] = p;
      if ((r < A0 || r >= A0 + NA) && (c < A0 || c >= A0 + NA)) P[1][e] = p;
      const float id = r == c ? 1.f : 0.f;
      Psi[0][e] = id;
      Psi[1][e] = id;
    }
    for (int e = tid; e < (NA * PS + NA * NA) * K; e += 32 * SW) s.phi[e] = 0.f;
  } else {
    const int n = state(s, lane, b, K, w, a, dte, R0, vR, gR, bg, ba, Rk_out,
                        pk_out, vk_out, gravity, small_angle);
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n = s_n;

  // phase: Phi and Q of every sample
  for (int x = tid; x < 18 * n; x += THREADS)
    form(s, x / 18, x % 18, gravity, s_g, s_a);
  __syncthreads();

  int cur = 0;
  for (int k = 0; k < n; ++k) {
    // phase: covariance steps
    const int nxt = cur ^ 1;
    const float* ph = s.phi + NA * PS * k;
    if (warp < G && lane < N) {
      // T[i][lane] = (Phi P)[i][lane] for the group's rows i
      const int i0 = 3 * warp;
      float f[3][PS];
#pragma unroll
      for (int r = 0; r < 3; ++r) ld_row(ph + (i0 + r) * PS, f[r]);
      const float* Pc = P[cur];
      float* Pn = P[nxt];
      float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float x = Pc[(C0 + m) * N + lane];
#pragma unroll
        for (int r = 0; r < 3; ++r) t[r] += f[r][m] * x;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int i = A0 + i0 + r;
        if (lane >= C0) T[i0 + r][lane - C0] = t[r];
        if (lane < A0 || lane >= A0 + NA) {    // P' = T there, and its mirror
          Pn[i * N + lane] = t[r];
          Pn[lane * N + i] = t[r];
        }
      }
    } else if (warp < SW && lane < N) {
      // Psi'[i][lane] = (Phi Psi)[i][lane] for the group's rows i
      const int i0 = 3 * (warp - G);
      float f[3][PS];
#pragma unroll
      for (int r = 0; r < 3; ++r) ld_row(ph + (i0 + r) * PS, f[r]);
      float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float x = Psi[cur][(C0 + m) * N + lane];
#pragma unroll
        for (int r = 0; r < 3; ++r) t[r] += f[r][m] * x;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) Psi[nxt][(A0 + i0 + r) * N + lane] = t[r];
    } else if (warp == SW && lane >= 18 && lane < N) {
      // Q's diagonal on rows 18..23
      const float q = __fmul_rn(s.dt[k], lane < 21 ? s_wg : s_wa);
      P[nxt][lane * (N + 1)] = P[cur][lane * (N + 1)] + q;
    }
    if (warp < G) {
      __syncwarp();
      if (lane < 3 * NA) {
        // P'[i][9 + j] = (T Phi^T)[i][9 + j] + Q for row i0 + lane / 9
        const int r = 3 * warp + lane / NA, j = lane % NA;
        float tr[PS], fj[PS];
        ld_row(T[r], tr);
        ld_row(ph + j * PS, fj);
        float p = 0.f;
#pragma unroll
        for (int m = 0; m < NC; ++m) p += tr[m] * fj[m];
        P[nxt][(A0 + r) * N + A0 + j] = p + s.Q[NA * NA * k + r * NA + j];
      }
    }
    __syncthreads();
    cur = nxt;
  }

  // phase: store
  for (int e = tid; e < N * N; e += THREADS) {
    P_out[(size_t)b * N * N + e] = P[cur][e];
    Psi_out[(size_t)b * N * N + e] = Psi[cur][e];
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
  if (K < 1 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // The shared-memory attribute is set once per device and size, outside
  // any graph capture (the first launch of a size runs eagerly); a failure
  // is taken off the runtime's last-error state before it is returned.
  static size_t configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = sizeof(float) * static_cast<size_t>(sample_floats(K));
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(propagate_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    configured[dev] = smem;
  }
  propagate_block_kernel<<<B, THREADS, smem, stream>>>(
      w, a, dte, R0, vR, gR, bg, ba, P0, Rk, pk, vk, P, Psi, K, gravity,
      small_angle, s_g, s_wg, s_a, s_wa);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
