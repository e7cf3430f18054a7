// Batched tile gather: out[n, i, j] = img[min(oy + i, H-1), min(ox + j, W-1)]
// with (ox, oy) the n-th origin clamped to [0, W-tw] x [0, H-th].
//
// Replaces rvio_tpu/ops/tile_gather.py (gather_tiles_narrow_pallas /
// _gather_narrow_kernel) and computes the function of its oracle,
// frontend.klt._gather_tiles.  Bound by bytes (a copy): one block per tile,
// one thread per output pixel, threads of a warp on neighbouring columns of
// one row so loads and stores coalesce.  Each block reads its own origin.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void gather_tiles_kernel(const float* __restrict__ img,
                                    const int* __restrict__ origin,
                                    float* __restrict__ out,
                                    int H, int W, int th, int tw) {
  const int n = blockIdx.x;
  int ox = origin[2 * n], oy = origin[2 * n + 1];
  ox = min(max(ox, 0), max(W - tw, 0));
  oy = min(max(oy, 0), max(H - th, 0));
  float* dst = out + (size_t)n * th * tw;
  for (int idx = threadIdx.x; idx < th * tw; idx += blockDim.x) {
    const int i = idx / tw, j = idx - i * tw;
    const int r = min(oy + i, H - 1), c = min(ox + j, W - 1);
    dst[idx] = img[(size_t)r * W + c];
  }
}

}  // namespace

extern "C" {

int rvio_gather_tiles(const float* img, const int* origin, float* out,
                      int H, int W, int N, int th, int tw,
                      cudaStream_t stream) {
  if (N == 0) return 0;
  gather_tiles_kernel<<<N, 256, 0, stream>>>(img, origin, out, H, W, th, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
