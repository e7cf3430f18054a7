// Batched cv::cornerSubPix on gathered tiles (the oracle's corner_subpix loop,
// rvio_tpu/frontend/detector.py:198-237).
//
// Replaces rvio_tpu/ops/klt_iterate.py (subpix_refine_pallas /
// _subpix_kernel), keeping the oracle's 40 x 32 tiles and per-tap clipping
// (the TPU kernel samples edge-padded 56 x 48 tiles).
//
// Bound: at the tracker's operating point (200 corners, win 7, 10
// iterations) the function needs about 15.5 MFLOP (0.23 us at 67 TFLOP/s)
// and reads about 0.35 MB of tile pixels: bound by operations, and far
// under a launch.  What sets the time is a chain of `iters` dependent steps
// a corner, each a few hundred instructions that one warp alone issues one
// after another.  So a corner gets NW warps and one barrier a step:
//
//   A block of NW warps a corner.  Thread 0 brings the corner's tile into
//   shared memory by one 1-D bulk copy (cp.async.bulk on an mbarrier) while
//   the lanes lay out their share of the fixed window once, with no
//   division: warp w takes a band of the window's rows and the patch rows
//   under it (its own buffer), and lane l the band's samples and taps l,
//   l + 32, ...: each sample's (row, column) and each tap's patch offset,
//   Gaussian weight and (ox, oy).  A step: each lane issues the 2 x 2 tile
//   loads of all its samples (each sample's top-left pixel clipped to
//   [0, TH-2] x [0, TW-2] as the oracle's _sample_patches clips it), blends
//   them and stores them into its warp's patch buffer; after a __syncwarp
//   its taps' central differences give five products, summed over the warp
//   by five interleaved __shfl_xor_sync butterflies; lane 0 stores the
//   warp's five sums, and after one named barrier every thread adds the
//   warps' sums in warp order (the same bits everywhere), solves the 2 x 2
//   system and clips the step to +-1 px.  The sums alternate between two
//   buffers, and the next step's patch stores depend on this step's result,
//   so the barrier is the only one.  No device memory in the loop.
//
// Every element operation (the blends, the differences, the products, the
// solve's products and its two divisions) rounds on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction), as the plain
// version's element-wise tensor operations do, so the two part only by the
// order of the sums.  That matters at the refill's weak candidates (cells
// without a corner, a structure tensor whose smaller eigenvalue is near
// 0), where ten steps amplify rounding to the order of the check's
// tolerance (PERF.md, the K9 findings).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NW = 2;                          // warps a corner
constexpr int MAX_WIN = 7;                     // the wrapper's bound: 15^2 taps
constexpr int MAX_PS = 2 * MAX_WIN + 3;        // patch side, 17
constexpr int BAND = (2 * MAX_WIN + 1 + NW - 1) / NW;   // window rows a warp
constexpr int KS = ((BAND + 2) * MAX_PS + 31) / 32;     // samples a lane
constexpr int KT = (BAND * (2 * MAX_WIN + 1) + 31) / 32;  // taps a lane
constexpr int SUB = ((BAND + 2) * MAX_PS + 3) / 4 * 4;  // a warp's patch rows
constexpr int RED = 2 * NW * 8;                // the sums, double-buffered

// bytes of a block's shared memory: the mbarrier (16, keeping what follows
// 16-byte aligned), the warps' patch rows, the sums, the tile
size_t smem_bytes(int tt) {
  return 16 + 4 * (NW * SUB + RED + (size_t)tt);
}

using rvio::add;
using rvio::mul;
using rvio::sub;

// (row, column) of index i = i0 + 32 k of a row-major layout `width`
// wide, k = 0, 1, ..., by steps of 32 from i0's: no division a k.
template <int K>
__device__ __forceinline__ void walk(int i0, int width, int (&row)[K],
                                     int (&col)[K]) {
  const int dq = 32 / width, dr = 32 - dq * width;
  int r = i0 / width, c = i0 - r * width;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row[k] = r;
    col[k] = c;
    r += dq;
    c += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// phase sync: __syncwarp()
__global__ void __launch_bounds__(32 * NW)
subpix_kernel(const float* __restrict__ tiles, const int* __restrict__ origin,
              const float* __restrict__ pts, float* __restrict__ out,
              int TH, int TW, int win, int iters, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = reinterpret_cast<float*>(smem + 16) + warp * SUB;
  float* red = reinterpret_cast<float*>(smem + 16) + NW * SUB;
  float* T = red + RED;
  const int n = blockIdx.x;
  const int TT = TH * TW;
  const float* tile = tiles + (size_t)n * TT;

  // phase: the tile's copy, the lanes' layout
  if (bulk) {
    if (threadIdx.x == 0) {
      rvio::mbar_init_expect(bar, 4u * TT);
      rvio::bulk_copy(T, tile, 4 * TT, bar);
    }
  } else {
    for (int i = threadIdx.x; i < TT; i += 32 * NW) T[i] = tile[i];
  }
  const float ofx = (float)origin[2 * n], ofy = (float)origin[2 * n + 1];
  float cx = pts[2 * n], cy = pts[2 * n + 1];
  const int size = 2 * win + 1, ps = size + 2;
  // this warp's window rows [a0, a1) and patch rows a0 .. a1 + 1
  const int band = (size + NW - 1) / NW;
  const int a0 = min(warp * band, size), a1 = min(a0 + band, size);
  const int ntap = (a1 - a0) * size, nsamp = (a1 - a0 + 2) * ps;
  // sample lane + 32 k of the warp's patch rows: its patch row and column
  // (a lane past them repeats a sample and stores nothing)
  int sy[KS], sx[KS];
  walk(lane, ps, sy, sx);
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (lane + 32 * k >= nsamp) {
      sy[k] = 0;
      sx[k] = 0;
    }
    sy[k] += a0;
  }
  // tap lane + 32 k of the warp's band: its centre in the warp's patch
  // rows, weight, (ox, oy); a tap past the band weighs 0
  int tc[KT];
  float tw[KT], tox[KT], toy[KT];
  {
    int ta[KT], tb[KT];
    walk(lane, size, ta, tb);
    const float sig = win / 2.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const bool on = lane + 32 * k < ntap;
      const int a = on ? ta[k] : 0, b = on ? tb[k] : 0;
      tc[k] = (a + 1) * ps + b + 1;
      toy[k] = (float)(a0 + a - win);
      tox[k] = (float)(b - win);
      tw[k] = on ? expf(-(tox[k] * tox[k] + toy[k] * toy[k]) /
                        (2.f * sig * sig))
                 : 0.f;
    }
  }
  __syncthreads();   // the mbarrier's initialisation before any wait
  if (bulk) rvio::mbar_wait(bar);

  for (int it = 0; it < iters; ++it) {
    // phase: patch samples
    const float ly = fminf(fmaxf(cy - ofy, 0.f), (float)(TH - 1));
    const float lx = fminf(fmaxf(cx - ofx, 0.f), (float)(TW - 1));
    const float fy = floorf(ly), fx = floorf(lx);
    const float wy = ly - fy, wx = lx - fx;
    const float vy = sub(1.f, wy), vx = sub(1.f, wx);
    const int iy = (int)fy - (win + 1), jx = (int)fx - (win + 1);
    float q00[KS], q01[KS], q10[KS], q11[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int i = min(max(iy + sy[k], 0), TH - 2);
      const int j = min(max(jx + sx[k], 0), TW - 2);
      const float* p = T + i * TW + j;
      q00[k] = p[0];
      q01[k] = p[1];
      q10[k] = p[TW];
      q11[k] = p[TW + 1];
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float r0 = add(mul(q00[k], vy), mul(q10[k], wy));
      const float r1 = add(mul(q01[k], vy), mul(q11[k], wy));
      if (lane + 32 * k < nsamp)
        P[lane + 32 * k] = add(mul(r0, vx), mul(r1, wx));
    }
    __syncwarp();

    // phase: taps and sums
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int c = tc[k];
      const float gx = mul(sub(P[c + 1], P[c - 1]), 0.5f);
      const float gy = mul(sub(P[c + ps], P[c - ps]), 0.5f);
      const float w = tw[k];
      const float xx = mul(gx, gx), xy = mul(gx, gy), yy = mul(gy, gy);
      s[0] = add(s[0], mul(mul(w, gx), gx));
      s[1] = add(s[1], mul(mul(w, gx), gy));
      s[2] = add(s[2], mul(mul(w, gy), gy));
      s[3] = add(s[3], mul(w, add(mul(xx, tox[k]), mul(xy, toy[k]))));
      s[4] = add(s[4], mul(w, add(mul(xy, tox[k]), mul(yy, toy[k]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int m = 0; m < 5; ++m)
        s[m] += __shfl_xor_sync(rvio::FULL_MASK, s[m], o);

    // phase: the warps' sums
    float* r = red + (it & 1) * NW * 8;
    if (lane == 0)
#pragma unroll
      for (int m = 0; m < 5; ++m) r[warp * 8 + m] = s[m];
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NW) : "memory");
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      s[m] = r[m];
#pragma unroll
      for (int w = 1; w < NW; ++w) s[m] += r[w * 8 + m];
    }

    // phase: the step
    const float gxx = s[0], gxy = s[1], gyy = s[2], bx = s[3], by = s[4];
    const float det = sub(mul(gxx, gyy), mul(gxy, gxy));
    const bool safe = fabsf(det) > 1e-12f;
    const float dx = safe ? __fdiv_rn(sub(mul(gyy, bx), mul(gxy, by)), det)
                          : 0.f;
    const float dy = safe ? __fdiv_rn(add(mul(-gxy, bx), mul(gxx, by)), det)
                          : 0.f;
    cx = add(cx, fminf(fmaxf(dx, -1.f), 1.f));
    cy = add(cy, fminf(fmaxf(dy, -1.f), 1.f));
  }
  // phase: store
  if (threadIdx.x == 0) {
    out[2 * n] = cx;
    out[2 * n + 1] = cy;
  }
}

}  // namespace

extern "C" {

// The wrapper checks shapes, types and (2 win + 1)^2 <= 256; this refuses
// the rest.  Tiles that are not one bulk copy (TH * TW % 4, or not 16-byte
// aligned) are read by the threads instead.
int rvio_subpix_refine(const float* tiles, const int* origin, const float* pts,
                       float* out, int N, int TH, int TW, int win, int iters,
                       cudaStream_t stream) {
  if (win < 0 || win > MAX_WIN || TH < 2 || TW < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = smem_bytes(TH * TW);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(subpix_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int bulk =
      (TH * TW) % 4 == 0 && reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
  subpix_kernel<<<N, 32 * NW, smem, stream>>>(tiles, origin, pts, out, TH, TW,
                                              win, iters, bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
