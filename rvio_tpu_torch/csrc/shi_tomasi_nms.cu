// Shi-Tomasi min-eigenvalue response, alone (K12) or with 3x3 non-maximum
// suppression (K13).
//
// rvio_shi_tomasi_nms replaces rvio_tpu/ops/shi_tomasi.py
// (shi_tomasi_nms_pallas / _shi_nms_kernel) and computes its oracle,
// detector.nms_masked_response, on the whole map; rvio_shi_tomasi replaces
// shi_tomasi_pallas / _shi_kernel and computes detector.shi_tomasi_response,
// the same function without the NMS stage (the response written where it is
// formed, 0 on the 2-px border; the TPU kernel's lane-roll wrap has no
// counterpart here):
//   ix = Sobel/8 in x, iy = Sobel/8 in y (reflect border, never reached:
//        the response needs them only at rows/cols [1, H-1) x [1, W-1)),
//   s** = 3x3 box sums of ix*ix, ix*iy, iy*iy,
//   resp = (tr - sqrt(max(tr^2 - 4 det, 0))) / 2, zero on the 2-px border,
//   out  = resp where resp >= all 8 neighbours (-inf outside), else -inf.
// Every product and sum rounds on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) in the plain version's order (frontend/image.py
// _sep_filter: rows first, then columns), so kernel and plain version agree
// bitwise.  Bound by bytes: one read of the image, one write of the map.
//
// K12 (shi_kernel<false>): a block owns a TY x TX output tile; it loads the
// tile with a halo into shared memory once and forms the gradient products
// and the response there, a block barrier between the stages.
//
// K13 (shi_nms_kernel): what one block's chain of four stages cost above is
// the whole time of a one-wave grid, so K13 has no shared memory and no
// barrier.  A warp owns a strip of NMS_ROWS output rows by 26 columns: lane
// l holds image column x = 26 s - 3 + l, issues the loads of its NMS_ROWS +
// 6 image rows before any arithmetic, and keeps every row of its column in
// registers.  Horizontal neighbours come from the adjacent lanes by
// __shfl_up_sync / __shfl_down_sync: each stage is valid one lane further
// in from each side (gradients 1..30, box sums and responses 2..29, the
// NMS 3..28), so the warp writes its inner 26 columns.  The 3x3 test is
// resp >= the NaN-propagating maximum of its 3x3 neighbourhood, taken as
// each lane's column maximum and two shuffles: the same decision as the 8
// comparisons (a NaN anywhere fails both).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 16;

using rvio::add;
using rvio::mul;
using rvio::sub;

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

// K13 (see the head of the file).  NMS_ROWS by measurement
// (scripts/filter_kernel_phases.py --kernel k13).
constexpr int NMS_COLS = 26;
constexpr int NMS_ROWS = 6;
constexpr int NMS_WARPS = 4;    // warps a block, each on its own strip

__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// The value of lane l - 1 (left) and of lane l + 1 (right).
__device__ __forceinline__ float left(float v) {
  return __shfl_up_sync(rvio::FULL_MASK, v, 1);
}
__device__ __forceinline__ float right(float v) {
  return __shfl_down_sync(rvio::FULL_MASK, v, 1);
}

// The 3x3 box sum at row k + 1 of a column's rows p: the column's three
// rows, then the three columns across the lanes.
template <int N>
__device__ __forceinline__ float box3(const float (&p)[N], int k) {
  const float cs = add(add(p[k], p[k + 1]), p[k + 2]);
  return add(add(left(cs), cs), right(cs));
}

// phase sync: __syncwarp()
template <int ROWS>
__global__ void __launch_bounds__(32 * NMS_WARPS)
shi_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
               int W, int strips_x) {
  const int lane = threadIdx.x & 31;
  const int strip = blockIdx.x * NMS_WARPS + (threadIdx.x >> 5);
  const int sy = strip / strips_x, sx = strip - sy * strips_x;
  const int y0 = sy * ROWS;
  if (y0 >= H) return;   // a warp past the map
  const int x = sx * NMS_COLS - 3 + lane;

  // phase: loads
  // image rows y0-3 .. y0+ROWS+2, clamped to the image: a clamped row or
  // column reaches no response inside the 2-px border
  const float* col = img + min(max(x, 0), W - 1);
  float I[ROWS + 6];
#pragma unroll
  for (int k = 0; k < ROWS + 6; ++k)
    I[k] = __ldg(col + (size_t)min(max(y0 - 3 + k, 0), H - 1) * W);

  // phase: gradient products
  // product row k (image row y0-2+k) from image rows k .. k+2; the column
  // sums of each filter, then the row sums across the lanes.  -s + t and
  // t - s round alike, and so do s * -1 and -s.
  float pxx[ROWS + 4], pxy[ROWS + 4], pyy[ROWS + 4];
#pragma unroll
  for (int k = 0; k < ROWS + 4; ++k) {
    const float sm = add(add(mul(I[k], 0.125f), mul(I[k + 1], 0.25f)),
                         mul(I[k + 2], 0.125f));
    const float d = sub(I[k + 2], I[k]);
    const float ix = sub(right(sm), left(sm));
    const float iy = add(add(mul(left(d), 0.125f), mul(d, 0.25f)),
                         mul(right(d), 0.125f));
    pxx[k] = mul(ix, ix);
    pxy[k] = mul(ix, iy);
    pyy[k] = mul(iy, iy);
  }

  // phase: responses
  // response row k (image row y0-1+k) from product rows k .. k+2: 0 on the
  // 2-px border, -inf off the image
  float R[ROWS + 2];
#pragma unroll
  for (int k = 0; k < ROWS + 2; ++k) {
    const float sxx = box3(pxx, k), sxy = box3(pxy, k), syy = box3(pyy, k);
    const float tr = add(sxx, syy);
    const float det = sub(mul(sxx, syy), mul(sxy, sxy));
    const float disc = __fsqrt_rn(fmaxf(sub(mul(tr, tr), mul(4.f, det)), 0.f));
    const int y = y0 - 1 + k;
    R[k] = y < 0 || y >= H || x < 0 || x >= W ? -CUDART_INF_F
           : y < 2 || y >= H - 2 || x < 2 || x >= W - 2
               ? 0.f
               : mul(sub(tr, disc), 0.5f);
  }

  // phase: NMS and store
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const float cm = max_nan(max_nan(R[k], R[k + 1]), R[k + 2]);
    const float m9 = max_nan(max_nan(left(cm), cm), right(cm));
    const int y = y0 + k;
    if (lane >= 3 && lane < 3 + NMS_COLS && x < W && y < H)
      out[(size_t)y * W + x] = R[k + 1] >= m9 ? R[k + 1] : -CUDART_INF_F;
  }
}

}  // namespace

extern "C" {

int rvio_shi_tomasi_nms(const float* img, float* out, int H, int W,
                        cudaStream_t stream) {
  const int strips_x = (W + NMS_COLS - 1) / NMS_COLS;
  const int warps = strips_x * ((H + NMS_ROWS - 1) / NMS_ROWS);
  shi_nms_kernel<NMS_ROWS><<<(warps + NMS_WARPS - 1) / NMS_WARPS,
                             32 * NMS_WARPS, 0, stream>>>(img, out, H, W,
                                                          strips_x);
  return static_cast<int>(cudaGetLastError());
}

int rvio_shi_tomasi(const float* img, float* out, int H, int W,
                    cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  shi_kernel<false><<<grid, 256, 0, stream>>>(img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
