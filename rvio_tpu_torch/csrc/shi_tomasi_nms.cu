// Shi-Tomasi min-eigenvalue response, alone (K12) or with 3x3 non-maximum
// suppression (K13).
//
// rvio_shi_tomasi_nms replaces rvio_tpu/ops/shi_tomasi.py
// (shi_tomasi_nms_pallas / _shi_nms_kernel) and computes its oracle,
// detector.nms_masked_response, on the whole map; rvio_shi_tomasi replaces
// shi_tomasi_pallas / _shi_kernel and computes detector.shi_tomasi_response,
// the same kernel without the NMS stage (the response written where it is
// formed, 0 on the 2-px border; the TPU kernel's lane-roll wrap has no
// counterpart here):
//   ix = Sobel/8 in x, iy = Sobel/8 in y (reflect border, never reached:
//        the response needs them only at rows/cols [1, H-1) x [1, W-1)),
//   s** = 3x3 box sums of ix*ix, ix*iy, iy*iy,
//   resp = (tr - sqrt(max(tr^2 - 4 det, 0))) / 2, zero on the 2-px border,
//   out  = resp where resp >= all 8 neighbours (-inf outside), else -inf.
// Bound by bytes: one read of the image, one write of the map.  A block
// owns a TY x TX output tile; it loads the tile with a 3-px halo into
// shared memory once, forms the gradient products (TY+4 x TX+4), the
// response (TY+2 x TX+2) and the NMS there.  Every product and sum rounds
// on its own (__fmul_rn / __fadd_rn, no FMA contraction) in the plain
// version's order, so kernel and plain version agree bitwise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 16;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// NMS false: the response alone, written from the response stage.
template <bool NMS>
__global__ void shi_kernel(const float* __restrict__ img,
                           float* __restrict__ out, int H, int W) {
  __shared__ float I[TY + 6][TX + 6];
  __shared__ float PXX[TY + 4][TX + 4], PXY[TY + 4][TX + 4], PYY[TY + 4][TX + 4];
  __shared__ float R[TY + 2][TX + 2];
  const int y0 = blockIdx.y * TY - 3, x0 = blockIdx.x * TX - 3;
  const int tid = threadIdx.x;

  // image tile with a 3-px halo (clamped: out-of-image values never reach
  // an interior response)
  for (int idx = tid; idx < (TY + 6) * (TX + 6); idx += blockDim.x) {
    const int r = idx / (TX + 6), c = idx - r * (TX + 6);
    const int gy = min(max(y0 + r, 0), H - 1), gx = min(max(x0 + c, 0), W - 1);
    I[r][c] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  // gradient products at (y0+1+r, x0+1+c)
  for (int idx = tid; idx < (TY + 4) * (TX + 4); idx += blockDim.x) {
    const int r = idx / (TX + 4), c = idx - r * (TX + 4);
    // ix: columns smoothed [1,2,1]/8 over rows, then the right minus the left
    const float sl = add(add(mul(I[r][c], 0.125f), mul(I[r + 1][c], 0.25f)),
                         mul(I[r + 2][c], 0.125f));
    const float sr = add(add(mul(I[r][c + 2], 0.125f), mul(I[r + 1][c + 2], 0.25f)),
                         mul(I[r + 2][c + 2], 0.125f));
    const float ix = add(mul(sl, -1.f), mul(sr, 1.f));
    // iy: row differences, then smoothed [1,2,1]/8 over columns
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d[k] = add(mul(I[r][c + k], -1.f), mul(I[r + 2][c + k], 1.f));
    const float iy = add(add(mul(d[0], 0.125f), mul(d[1], 0.25f)), mul(d[2], 0.125f));
    PXX[r][c] = mul(ix, ix);
    PXY[r][c] = mul(ix, iy);
    PYY[r][c] = mul(iy, iy);
  }
  __syncthreads();

  // response at (y0+2+r, x0+2+c): 0 on the 2-px border, -inf off the image
  for (int idx = tid; idx < (TY + 2) * (TX + 2); idx += blockDim.x) {
    const int r = idx / (TX + 2), c = idx - r * (TX + 2);
    const int gy = y0 + 2 + r, gx = x0 + 2 + c;
    float v;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      v = -CUDART_INF_F;
    } else if (gy < 2 || gy >= H - 2 || gx < 2 || gx >= W - 2) {
      v = 0.f;
    } else {
      float s[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[0][k] = add(add(PXX[r][c + k], PXX[r + 1][c + k]), PXX[r + 2][c + k]);
        s[1][k] = add(add(PXY[r][c + k], PXY[r + 1][c + k]), PXY[r + 2][c + k]);
        s[2][k] = add(add(PYY[r][c + k], PYY[r + 1][c + k]), PYY[r + 2][c + k]);
      }
      const float sxx = add(add(s[0][0], s[0][1]), s[0][2]);
      const float sxy = add(add(s[1][0], s[1][1]), s[1][2]);
      const float syy = add(add(s[2][0], s[2][1]), s[2][2]);
      const float tr = add(sxx, syy);
      const float det = sub(mul(sxx, syy), mul(sxy, sxy));
      const float disc = __fsqrt_rn(fmaxf(sub(mul(tr, tr), mul(4.f, det)), 0.f));
      v = mul(sub(tr, disc), 0.5f);
    }
    if constexpr (NMS) {
      R[r][c] = v;
    } else if (r >= 1 && r <= TY && c >= 1 && c <= TX && gy < H && gx < W) {
      out[(size_t)gy * W + gx] = v;
    }
  }
  if constexpr (!NMS) return;
  __syncthreads();

  // 3x3 local maximum at (y0+3+r, x0+3+c)
  for (int idx = tid; idx < TY * TX; idx += blockDim.x) {
    const int r = idx / TX, c = idx - r * TX;
    const int gy = y0 + 3 + r, gx = x0 + 3 + c;
    if (gy >= H || gx >= W) continue;
    const float m = R[r + 1][c + 1];
    bool keep = true;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (dy != 1 || dx != 1) keep = keep && (m >= R[r + dy][c + dx]);
    out[(size_t)gy * W + gx] = keep ? m : -CUDART_INF_F;
  }
}

}  // namespace

extern "C" {

int rvio_shi_tomasi_nms(const float* img, float* out, int H, int W,
                        cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  shi_kernel<true><<<grid, 256, 0, stream>>>(img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

int rvio_shi_tomasi(const float* img, float* out, int H, int W,
                    cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  shi_kernel<false><<<grid, 256, 0, stream>>>(img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
