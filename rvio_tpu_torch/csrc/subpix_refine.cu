// Batched cv::cornerSubPix on gathered tiles (the oracle's corner_subpix loop,
// rvio_tpu/frontend/detector.py:198-237).
//
// Replaces rvio_tpu/ops/klt_iterate.py (subpix_refine_pallas /
// _subpix_kernel), keeping the oracle's 40 x 32 tiles and per-tap clipping
// (the TPU kernel samples edge-padded 56 x 48 tiles).  Latency-bound: a
// fixed chain of `iters` dependent steps per corner.  One block per corner,
// 256 threads: the tile sits in shared memory; each iteration the block
// samples the (2 win + 3)^2 patch into shared memory, thread t takes window
// tap t (central differences are shifted reads of the patch), and five
// block sums give the 2 x 2 system.  Every thread runs the same scalar
// update on the same sums; the step is clipped to +-1 px.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAX_PATCH = 32 * 32;

__global__ void __launch_bounds__(NT)
subpix_kernel(const float* __restrict__ tiles, const int* __restrict__ origin,
              const float* __restrict__ pts, float* __restrict__ out,
              int TH, int TW, int win, int iters) {
  extern __shared__ float T[];
  __shared__ float P[MAX_PATCH];
  __shared__ float red[5 * NW];
  const int TT = TH * TW;
  const int n = blockIdx.x, tid = threadIdx.x;
  for (int idx = tid; idx < TT; idx += NT) T[idx] = tiles[(size_t)n * TT + idx];

  const int size = 2 * win + 1, ps = size + 2;
  const bool tap = tid < size * size;
  const int a = tap ? tid / size : 0, b = tap ? tid - a * size : 0;
  const float oy = (float)(a - win), ox = (float)(b - win);
  const float sig = win / 2.f;
  const float w = expf(-(ox * ox + oy * oy) / (2.f * sig * sig));
  const float ofy = (float)origin[2 * n + 1], ofx = (float)origin[2 * n];
  float cx = pts[2 * n], cy = pts[2 * n + 1];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float ly = fminf(fmaxf(cy - ofy, 0.f), (float)(TH - 1));
    const float lx = fminf(fmaxf(cx - ofx, 0.f), (float)(TW - 1));
    for (int idx = tid; idx < ps * ps; idx += NT) {
      const int pa = idx / ps;
      P[idx] = rvio::sample_tap(T, TH, TW, ly, lx, pa, idx - pa * ps, ps / 2);
    }
    __syncthreads();
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (tap) {
      const float gx = (P[(a + 1) * ps + b + 2] - P[(a + 1) * ps + b]) * 0.5f;
      const float gy = (P[(a + 2) * ps + b + 1] - P[a * ps + b + 1]) * 0.5f;
      s[0] = w * gx * gx;
      s[1] = w * gx * gy;
      s[2] = w * gy * gy;
      s[3] = w * (gx * gx * ox + gx * gy * oy);
      s[4] = w * (gx * gy * ox + gy * gy * oy);
    }
    rvio::block_sums<5, NT>(s, red);   // its barriers also retire the reads of P
    const float gxx = s[0], gxy = s[1], gyy = s[2], bx = s[3], by = s[4];
    const float det = gxx * gyy - gxy * gxy;
    const bool safe = fabsf(det) > 1e-12f;
    const float dx = safe ? (gyy * bx - gxy * by) / det : 0.f;
    const float dy = safe ? (-gxy * bx + gxx * by) / det : 0.f;
    cx += fminf(fmaxf(dx, -1.f), 1.f);
    cy += fminf(fmaxf(dy, -1.f), 1.f);
  }
  if (tid == 0) {
    out[2 * n] = cx;
    out[2 * n + 1] = cy;
  }
}

}  // namespace

extern "C" {

int rvio_subpix_refine(const float* tiles, const int* origin, const float* pts,
                       float* out, int N, int TH, int TW, int win, int iters,
                       cudaStream_t stream) {
  if (N == 0) return 0;
  if ((2 * win + 3) * (2 * win + 3) > MAX_PATCH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)TH * TW;
  if (smem > 48 * 1024 - sizeof(float) * (MAX_PATCH + 5 * NW))
    cudaFuncSetAttribute(subpix_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  subpix_kernel<<<N, NT, smem, stream>>>(tiles, origin, pts, out, TH, TW, win,
                                         iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
