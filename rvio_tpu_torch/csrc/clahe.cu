// CLAHE (contrast-limited adaptive histogram equalization), the two halves.
//
// Replaces rvio_tpu/ops/clahe.py (_hist_call / _hist_kernel and
// _apply_call / _apply_kernel) and computes the function of their oracle's
// XLA path, rvio_tpu/frontend/image.py:clahe, on an (H, W) f32 image cut
// into a g x g grid of th x tw tiles (th = ceil(H/g), tw = ceil(W/g)) over
// its reflect-padded (g th, g tw) extension.
//
// clahe_luts_kernel (K10): one block per tile.  The tile's 256-bin
// histogram is counted exactly in shared memory by atomicAdd (the padded
// rows and columns are read from their reflections by index arithmetic, no
// padded copy); then, in the same block, the clip at `limit`, the excess
// spread uniformly over the bins, the CDF and its scaling to 255/area, and
// one bf16 rounding of each LUT entry, stored as f32.  The CDF is summed in
// bin order in double and each entry rounded to f32, which is what
// torch.cumsum does on the CPU, so the LUTs agree bitwise with the plain
// version run on the CPU (the excess is a sum of multiples of 1/256 and is
// exact in any order).  Bound by bytes: one read of the image.
//
// clahe_apply_kernel (K11): one thread per output pixel, the g*g*256 f32
// LUTs staged in shared memory by each block.  The bin is read from the
// pixel's clamped, truncated value, the LUT entries of the (clamped) 2 x 2
// surrounding tiles are blended bilinearly with the oracle's tile
// coordinates ty = (y - (th-1)/2) / th: first over rows in each tile
// column, the second product fused (__fmaf_rn, as the oracle's contraction
// and the plain version's torch.addcmul round it), then over columns.
// Every other operation rounds on its own (__fdiv_rn, __fmul_rn,
// __fadd_rn: no other fusion, IEEE division) in the plain version's order,
// so the two agree bitwise.  Bound by bytes: one read of the image and the
// LUTs, one write of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NBINS = 256;
constexpr int LUT_THREADS = 1024;
constexpr int APPLY_COLS = 256;   // threads of an apply block, one per column
constexpr int APPLY_ROWS = 8;     // rows an apply block covers

// Reflection of index i >= n into [0, n) (numpy "reflect": no edge repeat);
// the pad is under n, so one reflection suffices.
__device__ __forceinline__ int reflect(int i, int n) {
  return i < n ? i : 2 * (n - 1) - i;
}

// The bin of a pixel: clamp(trunc(v), 0, 255), computed as the truncation
// of the clamped value (the same for every finite v).
__device__ __forceinline__ int bin_of(float v) {
  return static_cast<int>(fminf(fmaxf(v, 0.f), 255.f));
}

__global__ void __launch_bounds__(LUT_THREADS)
clahe_luts_kernel(const float* __restrict__ img, float* __restrict__ luts,
                  int* __restrict__ hist_out, int H, int W, int th, int tw,
                  int g, float limit, float scale) {
  __shared__ int hist[NBINS];
  __shared__ float clipped[NBINS];
  __shared__ double warp_excess[NBINS / 32];
  __shared__ float cdf[NBINS];
  const int t = blockIdx.x;
  const int p = t / g, q = t - p * g;
  const int tid = threadIdx.x;
  for (int b = tid; b < NBINS; b += blockDim.x) hist[b] = 0;
  __syncthreads();

  const int area = th * tw;
  for (int idx = tid; idx < area; idx += blockDim.x) {
    const int r = idx / tw, c = idx - r * tw;
    const int y = reflect(p * th + r, H), x = reflect(q * tw + c, W);
    atomicAdd(&hist[bin_of(img[(size_t)y * W + x])], 1);
  }
  __syncthreads();

  // clip; the excess summed in double (exact) over the 8 warps of the bins
  if (tid < NBINS) {
    const int h = hist[tid];
    if (hist_out != nullptr) hist_out[t * NBINS + tid] = h;
    const float hf = static_cast<float>(h);
    const float c = fminf(hf, limit);
    clipped[tid] = c;
    double e = static_cast<double>(__fsub_rn(hf, c));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if ((tid & 31) == 0) warp_excess[tid >> 5] = e;
  }
  __syncthreads();
  if (tid < NBINS) {
    double e = 0.0;
#pragma unroll
    for (int w = 0; w < NBINS / 32; ++w) e += warp_excess[w];
    const float excess = static_cast<float>(e);
    clipped[tid] = __fadd_rn(clipped[tid], __fdiv_rn(excess, (float)NBINS));
  }
  __syncthreads();

  // the CDF in bin order, accumulated in double, each entry rounded to f32
  if (tid == 0) {
    double acc = 0.0;
    for (int b = 0; b < NBINS; ++b) {
      acc += static_cast<double>(clipped[b]);
      cdf[b] = static_cast<float>(acc);
    }
  }
  __syncthreads();
  if (tid < NBINS) {
    const float v = __fmul_rn(cdf[tid], scale);
    luts[t * NBINS + tid] = __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The two tiles along one axis at pixel index i (c = (size-1)/2) and their
// weights; where the clamped pair coincides the second weight joins the
// first, as the oracle's one-hot weight rows add them.
__device__ __forceinline__ void tile_pair(int i, float c, int size, int g,
                                          int* t0, int* t1, float* w0,
                                          float* w1) {
  const float t = __fdiv_rn(__fsub_rn(static_cast<float>(i), c),
                            static_cast<float>(size));
  const float t0f = fminf(fmaxf(floorf(t), 0.f), static_cast<float>(g - 1));
  const float f = fminf(fmaxf(__fsub_rn(t, t0f), 0.f), 1.f);
  *t0 = static_cast<int>(t0f);
  *t1 = min(*t0 + 1, g - 1);
  const float rest = __fsub_rn(1.f, f);
  *w0 = *t0 == *t1 ? __fadd_rn(rest, f) : rest;
  *w1 = *t0 == *t1 ? 0.f : f;
}

__global__ void __launch_bounds__(APPLY_COLS)
clahe_apply_kernel(const float* __restrict__ img,
                   const float* __restrict__ luts, float* __restrict__ out,
                   int H, int W, int th, int tw, int g, float cy, float cx) {
  extern __shared__ float slut[];
  const int n = g * g * NBINS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) slut[i] = luts[i];
  __syncthreads();

  const int x = blockIdx.x * APPLY_COLS + threadIdx.x;
  if (x >= W) return;
  int tx0, tx1;
  float wx0, wx1;
  tile_pair(x, cx, tw, g, &tx0, &tx1, &wx0, &wx1);

  const int y_end = min(H, (blockIdx.y + 1) * APPLY_ROWS);
  for (int y = blockIdx.y * APPLY_ROWS; y < y_end; ++y) {
    int ty0, ty1;
    float wy0, wy1;
    tile_pair(y, cy, th, g, &ty0, &ty1, &wy0, &wy1);
    const int b = bin_of(img[(size_t)y * W + x]);
    const float* l0 = slut + b;
    const float s0 = __fmaf_rn(wy1, l0[(ty1 * g + tx0) * NBINS],
                               __fmul_rn(wy0, l0[(ty0 * g + tx0) * NBINS]));
    const float s1 = __fmaf_rn(wy1, l0[(ty1 * g + tx1) * NBINS],
                               __fmul_rn(wy0, l0[(ty0 * g + tx1) * NBINS]));
    out[(size_t)y * W + x] = __fadd_rn(__fmul_rn(s0, wx0), __fmul_rn(s1, wx1));
  }
}

}  // namespace

extern "C" {

int rvio_clahe_luts(const float* img, float* luts, int* hist, int H, int W,
                    int g, float limit, float scale, cudaStream_t stream) {
  const int th = (H + g - 1) / g, tw = (W + g - 1) / g;
  clahe_luts_kernel<<<g * g, LUT_THREADS, 0, stream>>>(
      img, luts, hist, H, W, th, tw, g, limit, scale);
  return static_cast<int>(cudaGetLastError());
}

int rvio_clahe_apply(const float* img, const float* luts, float* out, int H,
                     int W, int g, float cy, float cx, cudaStream_t stream) {
  const int th = (H + g - 1) / g, tw = (W + g - 1) / g;
  const size_t smem = sizeof(float) * g * g * NBINS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + APPLY_COLS - 1) / APPLY_COLS,
                  (H + APPLY_ROWS - 1) / APPLY_ROWS);
  clahe_apply_kernel<<<grid, APPLY_COLS, smem, stream>>>(
      img, luts, out, H, W, th, tw, g, cy, cx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
