// Batched tile gathers: out[n, i, j] = img[min(oy + i, H-1), min(ox + j, W-1)]
// with (ox, oy) the n-th origin clamped to [0, W-tw] x [0, H-th].
//
// rvio_gather_tiles (K6) replaces rvio_tpu/ops/tile_gather.py
// (gather_tiles_narrow_pallas / _gather_narrow_kernel) and computes the
// function of its oracle, frontend.klt._gather_tiles.  Bound by bytes (a
// copy): one block per tile, one thread per output pixel, threads of a warp
// on neighbouring columns of one row so loads and stores coalesce.  Each
// block reads its own origin.
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
                                    int H, int W, int th, int tw) {
  const int n = blockIdx.x;
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

}  // namespace

extern "C" {

int rvio_gather_tiles(const float* img, const int* origin, float* out,
                      int H, int W, int N, int th, int tw,
                      cudaStream_t stream) {
  if (N == 0) return 0;
  gather_tiles_kernel<false, false><<<N, 256, 0, stream>>>(img, origin, out,
                                                           H, W, th, tw);
  return static_cast<int>(cudaGetLastError());
}

int rvio_gather_tiles_aligned(const float* img, const int* origin,
                              float* out, int H, int W, int N, int th, int tw,
                              int vec, cudaStream_t stream) {
  if (N == 0) return 0;
  if (vec)
    gather_tiles_kernel<true, true><<<N, 256, 0, stream>>>(img, origin, out,
                                                           H, W, th, tw);
  else
    gather_tiles_kernel<true, false><<<N, 256, 0, stream>>>(img, origin, out,
                                                            H, W, th, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
