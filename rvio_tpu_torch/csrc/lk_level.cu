// One Lucas-Kanade pyramid level for N features (the oracle's klt_track,
// rvio_tpu/frontend/klt.py:178-268, from the gathered tiles on).
//
// Replaces rvio_tpu/ops/klt_iterate.py (lk_level_pallas / _lk_level_kernel)
// with the CPU oracle's borders: taps clip one by one to [0, tile-2] (the TPU
// kernel clamps the whole window).  Latency-bound (a chain of up to
// max_iters dependent Gauss-Newton steps per feature), so:
//
//   lk_level_kernel: one block per feature, 256 threads.  The template tile,
//     its two Scharr gradient tiles (reflect pad) and the search tile sit in
//     shared memory (4 * TH * TW floats, 20 KB at 40 x 32).  Thread t owns
//     window tap t (win*win <= 256): it samples its template and gradient
//     taps once and keeps them in registers; each step samples its search
//     tap, and two block sums give the right-hand side.  Every thread runs
//     the same scalar recursion on the same sums, so control flow stays
//     uniform.  The block stops when its feature converges or dies, and
//     writes its trip count, its status, whether its final position is
//     within the wander bound, and (last level) the mean-abs error.
//   lk_finish_kernel: one block.  The oracle's batch loop runs T = the
//     largest trip count; a converged feature whose own trips ended before
//     T is tested once more against the wander bound at its final position.
//     Then, at the last level, the in-bounds test of the result.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

__device__ __forceinline__ int reflect(int k, int n) {
  return k < 0 ? -k : (k >= n ? 2 * n - 2 - k : k);
}

__global__ void __launch_bounds__(NT)
lk_level_kernel(const float* __restrict__ t_tiles,
                const float* __restrict__ n_tiles,
                const float* __restrict__ loc0,
                const float* __restrict__ g_init,
                const int* __restrict__ o1,
                const bool* __restrict__ status,
                float* __restrict__ g_out, float* __restrict__ err_out,
                int* __restrict__ trips_out, bool* __restrict__ alive_out,
                bool* __restrict__ dok_out, int TH, int TW, int win,
                int max_iters, float eps, float min_eig, float wander,
                int last) {
  extern __shared__ float sh[];
  __shared__ float red[3 * NW];
  const int TT = TH * TW;
  float* Tt = sh;
  float* Ts = sh + TT;
  float* GX = sh + 2 * TT;
  float* GY = sh + 3 * TT;
  const int n = blockIdx.x, tid = threadIdx.x;

  for (int idx = tid; idx < TT; idx += NT) {
    Tt[idx] = t_tiles[(size_t)n * TT + idx];
    Ts[idx] = n_tiles[(size_t)n * TT + idx];
  }
  __syncthreads();

  // Scharr /32 of the template tile, reflect-padded (klt._tile_scharr)
  const float ca = 3.f / 32.f, cb = 10.f / 32.f;
  for (int idx = tid; idx < TT; idx += NT) {
    const int i = idx / TW, j = idx - i * TW;
    const int iu = reflect(i - 1, TH), id = reflect(i + 1, TH);
    float sy[3], dy[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int jj = reflect(j - 1 + k, TW);
      const float u = Tt[iu * TW + jj], m = Tt[i * TW + jj], d = Tt[id * TW + jj];
      sy[k] = ca * u + cb * m + ca * d;
      dy[k] = d - u;
    }
    GX[idx] = sy[2] - sy[0];
    GY[idx] = ca * dy[0] + cb * dy[1] + ca * dy[2];
  }
  __syncthreads();

  const int r = win / 2, area = win * win;
  const bool tap = tid < area;
  const int a = tap ? tid / win : 0, b = tap ? tid - a * win : 0;
  const float l0y = loc0[2 * n + 1], l0x = loc0[2 * n];
  float tm = 0.f, gx = 0.f, gy = 0.f;
  if (tap) {
    tm = rvio::sample_tap(Tt, TH, TW, l0y, l0x, a, b, r);
    gx = rvio::sample_tap(GX, TH, TW, l0y, l0x, a, b, r);
    gy = rvio::sample_tap(GY, TH, TW, l0y, l0x, a, b, r);
  }
  float h[3] = {gx * gx, gx * gy, gy * gy};
  rvio::block_sums<3, NT>(h, red);
  const float gxx = h[0], gxy = h[1], gyy = h[2];
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float meig = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / (2.f * area);
  const bool ok_level = (meig > min_eig) && (det > 1e-12f);
  const float dets = det == 0.f ? 1.f : det;
  const float inv00 = ok_level ? gyy / dets : 0.f;
  const float inv01 = ok_level ? -gxy / dets : 0.f;
  const float inv11 = ok_level ? gxx / dets : 0.f;

  const float giy = g_init[2 * n + 1], gix = g_init[2 * n];
  const float oy = (float)o1[2 * n + 1], ox = (float)o1[2 * n];
  float py = giy, px = gix;
  bool alive = status[n] && ok_level, conv = false;
  int trips = 0;
  for (int it = 0; it < max_iters && alive && !conv; ++it) {
    ++trips;
    if (!(fabsf(py - giy) <= wander && fabsf(px - gix) <= wander)) {
      alive = false;
      break;
    }
    const float ly = fminf(fmaxf(py - oy, 0.f), (float)(TH - 1));
    const float lx = fminf(fmaxf(px - ox, 0.f), (float)(TW - 1));
    const float di = tap ? rvio::sample_tap(Ts, TH, TW, ly, lx, a, b, r) - tm : 0.f;
    float rhs[2] = {di * gx, di * gy};
    rvio::block_sums<2, NT>(rhs, red);
    const float sx = -(inv00 * rhs[0] + inv01 * rhs[1]);
    const float sy = -(inv01 * rhs[0] + inv11 * rhs[1]);
    px += sx;
    py += sy;
    conv = sx * sx + sy * sy < eps * eps;
  }

  float e = 0.f;
  if (last) {
    const float ly = fminf(fmaxf(py - oy, 0.f), (float)(TH - 1));
    const float lx = fminf(fmaxf(px - ox, 0.f), (float)(TW - 1));
    float s[1] = {
        tap ? fabsf(rvio::sample_tap(Ts, TH, TW, ly, lx, a, b, r) - tm) : 0.f};
    rvio::block_sums<1, NT>(s, red);
    e = s[0] / (float)area;
  }
  if (tid == 0) {
    g_out[2 * n] = px;
    g_out[2 * n + 1] = py;
    err_out[n] = e;
    trips_out[n] = trips;
    alive_out[n] = alive;
    dok_out[n] = fabsf(py - giy) <= wander && fabsf(px - gix) <= wander;
  }
}

__global__ void __launch_bounds__(NT)
lk_finish_kernel(const float* __restrict__ g, const int* __restrict__ trips,
                 const bool* __restrict__ alive, const bool* __restrict__ dok,
                 bool* __restrict__ status_out, int N, int last, int H, int W,
                 int rb) {
  __shared__ int red[NW];
  int m = 0;
  for (int i = threadIdx.x; i < N; i += NT) m = max(m, trips[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  int T = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) T = max(T, red[i]);
  const float lo = (float)rb, hx = (float)(W - rb - 1), hy = (float)(H - rb - 1);
  for (int i = threadIdx.x; i < N; i += NT) {
    bool s = alive[i] && (trips[i] >= T || dok[i]);
    if (last) {
      const float x = g[2 * i], y = g[2 * i + 1];
      s = s && x > lo && x < hx && y > lo && y < hy;
    }
    status_out[i] = s;
  }
}

}  // namespace

extern "C" {

int rvio_lk_level(const float* t_tiles, const float* n_tiles, const float* loc0,
                  const float* g_init, const int* o1, const bool* status,
                  float* g_out, bool* status_out, float* err_out, int* trips,
                  bool* alive, bool* dok, int N, int TH, int TW, int win,
                  int max_iters, float eps, float min_eig, float wander,
                  int last, int H, int W, cudaStream_t stream) {
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * 4 * (size_t)TH * TW;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(lk_level_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  lk_level_kernel<<<N, NT, smem, stream>>>(
      t_tiles, n_tiles, loc0, g_init, o1, status, g_out, err_out, trips, alive,
      dok, TH, TW, win, max_iters, eps, min_eig, wander, last);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lk_finish_kernel<<<1, NT, 0, stream>>>(g_out, trips, alive, dok, status_out,
                                         N, last, H, W, win / 2 + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
