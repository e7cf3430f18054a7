// Shi-Tomasi min-eigenvalue response, alone (K12) or with 3x3 non-maximum
// suppression (K13).
//
// rvio_shi_tomasi_nms replaces rvio_tpu/ops/shi_tomasi.py
// (shi_tomasi_nms_pallas / _shi_nms_kernel) and computes its oracle,
// detector.nms_masked_response, on the whole map; rvio_shi_tomasi replaces
// shi_tomasi_pallas / _shi_kernel and computes detector.shi_tomasi_response,
// the same function without the NMS stage (the response, 0 on the 2-px
// border; the TPU kernel's lane-roll wrap has no counterpart here):
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
// Both are one strip kernel, shi_strip_kernel<ROWS, NMS>: a block barrier
// and a shared-memory stage cost more than the whole arithmetic of a
// one-wave grid, so it has neither.  A warp owns a strip of ROWS output
// rows by 32 - 2 HALO columns, HALO = 3 with the NMS stage (K13: 26
// columns) and 2 without it (K12: 28): lane l holds image column
// x = COLS s - HALO + l, issues the loads of its ROWS + 2 HALO image rows
// before any arithmetic, and keeps every row of its column in registers.
// Horizontal neighbours come from the adjacent lanes by __shfl_up_sync /
// __shfl_down_sync: each stage is valid one lane further in from each side
// (gradients 1..30, box sums and responses 2..29, the NMS 3..28), so the
// warp writes its inner COLS columns: K12 from the response stage, K13 from
// the NMS stage.  The 3x3 test is resp >= the NaN-propagating maximum of
// its 3x3 neighbourhood, taken as each lane's column maximum and two
// shuffles: the same decision as the 8 comparisons (a NaN anywhere fails
// both).  The kernel keeps no state between launches, so a CUDA graph
// replays it and streams may run it at once.  B images of one size (a
// batched tracker's segments) are one launch, grid.y the image: a strip's
// rows and columns stay inside its own image, whose edges it clamps to as
// at B = 1, so no strip reads across from one image into the next.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

using rvio::add;
using rvio::mul;
using rvio::sub;

// Strip widths (32 lanes less a halo each side) and heights, ROWS by
// measurement (scripts/filter_kernel_phases.py --kernel k13 / --kernel k12).
constexpr int NMS_COLS = 26;    // K13
constexpr int NMS_ROWS = 6;
constexpr int RESP_COLS = 28;   // K12
constexpr int RESP_ROWS = 4;
constexpr int STRIP_WARPS = 4;  // warps a block, each on its own strip

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
template <int ROWS, bool NMS>
__global__ void __launch_bounds__(32 * STRIP_WARPS)
shi_strip_kernel(const float* __restrict__ img, float* __restrict__ out,
                 int H, int W, int strips_x) {
  constexpr int HALO = NMS ? 3 : 2;
  constexpr int COLS = NMS ? NMS_COLS : RESP_COLS;
  static_assert(COLS == 32 - 2 * HALO, "a strip is the lanes less its halo");
  constexpr int NR = ROWS + 2 * (HALO - 2);   // response rows
  const int lane = threadIdx.x & 31;
  {
    const size_t b = blockIdx.y;   // the image
    img += b * H * W;
    out += b * H * W;
  }
  const int strip = blockIdx.x * STRIP_WARPS + (threadIdx.x >> 5);
  const int sy = strip / strips_x, sx = strip - sy * strips_x;
  const int y0 = sy * ROWS;
  if (y0 >= H) return;   // a warp past the map
  const int x = sx * COLS - HALO + lane;
  const bool writes = lane >= HALO && lane < HALO + COLS && x < W;

  // phase: loads
  // image rows y0-HALO .. y0+ROWS+HALO-1, clamped to the image: a clamped
  // row or column reaches no response inside the 2-px border
  const float* col = img + min(max(x, 0), W - 1);
  float I[NR + 4];
#pragma unroll
  for (int k = 0; k < NR + 4; ++k)
    I[k] = __ldg(col + (size_t)min(max(y0 - HALO + k, 0), H - 1) * W);

  // phase: gradient products
  // product row k (image row y0-HALO+1+k) from image rows k .. k+2; the
  // column sums of each filter, then the row sums across the lanes.
  // -s + t and t - s round alike, and so do s * -1 and -s.
  float pxx[NR + 2], pxy[NR + 2], pyy[NR + 2];
#pragma unroll
  for (int k = 0; k < NR + 2; ++k) {
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
  // response row k (image row y0-HALO+2+k) from product rows k .. k+2: 0 on
  // the 2-px border, -inf off the image; K12 stores it
  float R[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const float sxx = box3(pxx, k), sxy = box3(pxy, k), syy = box3(pyy, k);
    const float tr = add(sxx, syy);
    const float det = sub(mul(sxx, syy), mul(sxy, sxy));
    const float disc = __fsqrt_rn(fmaxf(sub(mul(tr, tr), mul(4.f, det)), 0.f));
    const int y = y0 - HALO + 2 + k;
    R[k] = y < 0 || y >= H || x < 0 || x >= W ? -CUDART_INF_F
           : y < 2 || y >= H - 2 || x < 2 || x >= W - 2
               ? 0.f
               : mul(sub(tr, disc), 0.5f);
    if constexpr (!NMS) {
      if (writes && y < H) out[(size_t)y * W + x] = R[k];
    }
  }

  // phase: NMS and store
  if constexpr (NMS) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float cm = max_nan(max_nan(R[k], R[k + 1]), R[k + 2]);
      const float m9 = max_nan(max_nan(left(cm), cm), right(cm));
      const int y = y0 + k;
      if (writes && y < H)
        out[(size_t)y * W + x] = R[k + 1] >= m9 ? R[k + 1] : -CUDART_INF_F;
    }
  }
}

template <int ROWS, bool NMS>
int launch_strips(const float* img, float* out, int B, int H, int W,
                  cudaStream_t stream) {
  constexpr int COLS = NMS ? NMS_COLS : RESP_COLS;
  if (B == 0) return 0;
  const int strips_x = (W + COLS - 1) / COLS;
  const int warps = strips_x * ((H + ROWS - 1) / ROWS);
  const dim3 grid((warps + STRIP_WARPS - 1) / STRIP_WARPS, B);
  shi_strip_kernel<ROWS, NMS><<<grid, 32 * STRIP_WARPS, 0, stream>>>(
      img, out, H, W, strips_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B images (H, W) -> B maps; B < 65536.
int rvio_shi_tomasi_nms_batch(const float* img, float* out, int B, int H,
                              int W, cudaStream_t stream) {
  return launch_strips<NMS_ROWS, true>(img, out, B, H, W, stream);
}

// One image: B = 1.
int rvio_shi_tomasi_nms(const float* img, float* out, int H, int W,
                        cudaStream_t stream) {
  return launch_strips<NMS_ROWS, true>(img, out, 1, H, W, stream);
}

// K12 takes one image: B = 1 of the same template.
int rvio_shi_tomasi(const float* img, float* out, int H, int W,
                    cudaStream_t stream) {
  return launch_strips<RESP_ROWS, false>(img, out, 1, H, W, stream);
}

}  // extern "C"
