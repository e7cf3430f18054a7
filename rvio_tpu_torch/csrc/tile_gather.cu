// Batched tile gathers: out[b, n, i, j] = img[b, min(oy + i, H-1),
// min(ox + j, W-1)] with (ox, oy) the n-th origin of image b clamped to
// [0, W-tw] x [0, H-th].  B images (the segments of a batched tracker) are
// one launch: grid.y is the image, and a tile reads its own image only.
//
// rvio_gather_tiles (K6) replaces rvio_tpu/ops/tile_gather.py
// (gather_tiles_narrow_pallas / _gather_narrow_kernel) and computes the
// function of its oracle, frontend.klt._gather_tiles.  Bound by bytes (a
// copy: the image pixels the tiles cover, read once, and the tiles written
// once; about 2.0 MB or 0.60 us at 3.35 TB/s for 200 tiles of 40 x 32 from
// a 480 x 752 level), and in practice by latency: the tracker's calls move
// about 1 MB each, so the time is the launch plus the round trips a thread
// waits on.  The tracker's one shape, 40 x 32, is specialised at compile
// time (gather_narrow_kernel<40>): one block a tile, one lane a column
// (32 = a warp), each of the 8 warps takes 5 rows of the tile and starts
// all 5 loads before its first store, so a lane waits on one round trip
// (after the origin's).  Each row it stores is one aligned 128-byte line.
// After the origin clamp a tile lies inside the image whenever H >= 40 and
// W >= 32 (every pyramid level of RVIOConfig(), down to 60 x 94); only a
// tile that does not fit takes the edge-clamped addresses, a branch inside
// the kernel.  Other tile shapes take the generic instantiation of
// gather_tiles_kernel (one thread a pixel, edge-clamped).  No TMA tensor
// map: the pyramid levels are new allocations every frame, so a
// CUtensorMap would be encoded on the host at every call to move 5 KB a
// tile.
//
// rvio_gather_tiles_aligned (K7) replaces gather_tiles_pallas /
// _gather_kernel and computes that kernel's own function: after the clamp,
// x aligns down to a multiple of 128 and y to a multiple of 8, then the
// same copy.  Also bound by bytes.  Where the tile fits the image and
// W % 4 == 0 (tw % 4 == 0, a 16-byte aligned image), every tile row starts
// on a 16-byte boundary and a thread copies four pixels with one float4
// load and store; otherwise one pixel, edge-clamped as K6.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// ALIGN (K7): after the clamp, x aligns down to 128 and y to 8.  VEC copies
// float4s and needs the tile inside the image (rows then start on 16-byte
// boundaries); otherwise one pixel a thread, edge-clamped.
template <bool ALIGN, bool VEC>
__global__ void gather_tiles_kernel(const float* __restrict__ img,
                                    const int* __restrict__ origin,
                                    float* __restrict__ out,
                                    int H, int W, int N, int th, int tw) {
  const int n = blockIdx.x;
  const size_t b = blockIdx.y;   // the image
  img += b * H * W;
  origin += 2 * b * N;
  out += b * N * th * tw;
  int ox = origin[2 * n], oy = origin[2 * n + 1];
  ox = min(max(ox, 0), max(W - tw, 0));
  oy = min(max(oy, 0), max(H - th, 0));
  if constexpr (ALIGN) {
    ox = ox / 128 * 128;
    oy = oy / 8 * 8;
  }
  float* dst = out + (size_t)n * th * tw;
  if constexpr (VEC) {
    const int tw4 = tw / 4;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int idx = threadIdx.x; idx < th * tw4; idx += blockDim.x) {
      const int i = idx / tw4, j = idx - i * tw4;
      dst4[idx] = reinterpret_cast<const float4*>(
          img + (size_t)(oy + i) * W + ox)[j];
    }
  } else {
    for (int idx = threadIdx.x; idx < th * tw; idx += blockDim.x) {
      const int i = idx / tw, j = idx - i * tw;
      const int r = min(oy + i, H - 1), c = min(ox + j, W - 1);
      dst[idx] = img[(size_t)r * W + c];
    }
  }
}

// K6 at the tracker's tile, TH x 32: one block a tile, warp w copies rows
// [w R, w R + R), lane j column j, every load before the first store.
constexpr int NARROW_WARPS = 8;

template <int TH>
__global__ void __launch_bounds__(32 * NARROW_WARPS)
gather_narrow_kernel(const float* __restrict__ img,
                     const int* __restrict__ origin, float* __restrict__ out,
                     int H, int W, int N) {
  constexpr int TW = 32, R = TH / NARROW_WARPS;
  static_assert(TH % NARROW_WARPS == 0, "rows split evenly over the warps");
  const int n = blockIdx.x, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;   // the image
  img += b * H * W;
  origin += 2 * b * N;
  out += b * N * TH * TW;
  const int i0 = (threadIdx.x >> 5) * R;
  const int ox = min(max(origin[2 * n], 0), max(W - TW, 0));
  const int oy = min(max(origin[2 * n + 1], 0), max(H - TH, 0));
  float v[R];
  if (H >= TH && W >= TW) {
    const float* src = img + (size_t)(oy + i0) * W + ox + lane;
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = __ldg(src + (size_t)k * W);
  } else {
    const int c = min(ox + lane, W - 1);
#pragma unroll
    for (int k = 0; k < R; ++k)
      v[k] = __ldg(img + (size_t)min(oy + i0 + k, H - 1) * W + c);
  }
  float* dst = out + ((size_t)n * TH + i0) * TW + lane;
#pragma unroll
  for (int k = 0; k < R; ++k) dst[k * TW] = v[k];
}

}  // namespace

extern "C" {

// B images (H, W), B x N origins, B x N tiles out; B < 65536.
int rvio_gather_tiles_batch(const float* img, const int* origin, float* out,
                            int H, int W, int B, int N, int th, int tw,
                            cudaStream_t stream) {
  if (N == 0 || B == 0) return 0;
  const dim3 grid(N, B);
  if (th == 40 && tw == 32)
    gather_narrow_kernel<40><<<grid, 32 * NARROW_WARPS, 0, stream>>>(
        img, origin, out, H, W, N);
  else
    gather_tiles_kernel<false, false><<<grid, 256, 0, stream>>>(
        img, origin, out, H, W, N, th, tw);
  return static_cast<int>(cudaGetLastError());
}

// One image: B = 1.
int rvio_gather_tiles(const float* img, const int* origin, float* out,
                      int H, int W, int N, int th, int tw,
                      cudaStream_t stream) {
  return rvio_gather_tiles_batch(img, origin, out, H, W, 1, N, th, tw,
                                 stream);
}

int rvio_gather_tiles_aligned(const float* img, const int* origin,
                              float* out, int H, int W, int N, int th, int tw,
                              int vec, cudaStream_t stream) {
  if (N == 0) return 0;
  if (vec)
    gather_tiles_kernel<true, true><<<N, 256, 0, stream>>>(img, origin, out,
                                                           H, W, N, th, tw);
  else
    gather_tiles_kernel<true, false><<<N, 256, 0, stream>>>(img, origin, out,
                                                            H, W, N, th, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
