// CLAHE (contrast-limited adaptive histogram equalization), the two halves.
//
// Replaces rvio_tpu/ops/clahe.py (_hist_call / _hist_kernel and
// _apply_call / _apply_kernel) and computes the function of their oracle's
// XLA path, rvio_tpu/frontend/image.py:clahe, on an (H, W) f32 image cut
// into a g x g grid of th x tw tiles (th = ceil(H/g), tw = ceil(W/g)) over
// its reflect-padded (g th, g tw) extension.
//
// clahe_luts_kernel (K10): a thread block cluster of CL = 8 CTAs a tile.
// Bound by bytes: one read of the image (1.44 MB at 752 x 480, about
// 0.44 us at 3.35 TB/s).  What held a one-block-a-tile design far from it
// was latency: 25 of 132 SMs busy, an integer division a pixel and, above
// all, one thread adding 256 dependent doubles for the CDF.  Here:
//
//   - CTA rank r of a tile counts a band of ceil(th / CL) of its rows: a
//     lane a column (tiles narrower than the block take several row
//     phases), no division a pixel, the reflected column computed once,
//     the loads of a strip of 16 rows issued before the first pixel is
//     binned, one shared atomic a pixel into a histogram a warp (measured
//     faster on the card than counting runs of equal bins, along a lane's
//     rows or across a warp's lanes, and than __match_any_sync);
//   - each CTA stores its band's histogram into rank 0's shared memory
//     (distributed shared memory) and arrives at the cluster barrier; the
//     others leave, and rank 0 alone waits and finishes (one wait on the
//     critical path: the barrier's first phase, arrived at on entry and
//     waited for before the store, makes sure rank 0 has started);
//   - rank 0: the clip at `limit`, the excess summed in double (exact),
//     spread uniformly, the CDF, its scaling to 255/area and one bf16
//     rounding of each LUT entry, stored as f32.
//
// The CDF must equal torch.cumsum's on the CPU (bin order, a double
// accumulator, each entry rounded to f32) bitwise.  When the f32 limit lies
// on a grid 2^-k with area 2^k < 2^24 and (limit + area/256) 2^(k+8) <
// 2^24 (the wrapper decides; `any_order`), every h - c, the excess e and
// every clipped bin c + e/256 are exact in f32 and every partial sum is
// exact in double in any order: the CDF is a warp shuffle scan of c, the
// warps' totals before it, plus (b + 1) e/256, one block barrier.
// Otherwise the clipped bins are summed in bin order by one thread; there
// the LUTs are bitwise the plain version's wherever its f32 sum of the
// excess is exact (the kernel rounds the exact sum once).  The kernel keeps
// no state between launches, so a CUDA graph replays it and streams may
// run it at once.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NBINS = 256;
constexpr int CL = 8;             // CTAs of a tile's cluster, a band each
constexpr int LUT_THREADS = 256;  // a bin a thread in the finish
constexpr int LUT_WARPS = LUT_THREADS / 32;
constexpr int STRIP = 16;         // rows of a strip whose loads go together
static_assert(LUT_THREADS == NBINS, "the finish takes a bin a thread");
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

// The cluster barrier in two halves: arrive (relaxed: orders nothing;
// release: this thread's writes, remote ones included, are seen by every
// thread that waits on the same phase) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(LUT_THREADS)
clahe_luts_kernel(const float* __restrict__ img, float* __restrict__ luts,
                  int* __restrict__ hist_out, int H, int W, int th, int tw,
                  int g, float limit, float scale, int any_order) {
  __shared__ int wh[LUT_WARPS][NBINS];   // a histogram a warp
  __shared__ int bands[CL][NBINS];       // rank 0: every band's histogram
  __shared__ double we[LUT_WARPS], wc[LUT_WARPS];
  __shared__ float cdf_in[NBINS];        // rank 0, bin-order branch
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // every CTA of the cluster has started once this phase completes, so
  // rank 0's shared memory may be written (waited for before the send)
  cluster_arrive_relaxed();
  const int t = blockIdx.x / CL;
  const int p = t / g, q = t - p * g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* h = wh[warp];
  for (int b = lane; b < NBINS; b += 32) h[b] = 0;
  __syncwarp();

  // phase: count the band
  // the band of rows [r0, r1) of the tile; a lane on column c, rows r0 + rp,
  // r0 + rp + nph, ... (tiles narrower than the block: several row phases;
  // wider: columns c, c + LUT_THREADS, ...); a strip's loads issued before
  // the first pixel is counted, one shared atomic a pixel
  const int bh = (th + CL - 1) / CL;
  const int r0 = min(th, rank * bh), r1 = min(th, r0 + bh);
  int nph = 1, rp = 0, c = tid, cstep = LUT_THREADS;
  if (tw < LUT_THREADS) {
    nph = LUT_THREADS / tw;
    rp = tid / tw;
    c = rp < nph ? tid - rp * tw : tw;
    cstep = tw;
  }
  for (; c < tw; c += cstep) {
    const float* colp = img + reflect(q * tw + c, W);
    for (int r = r0 + rp; r < r1; r += STRIP * nph) {
      float v[STRIP];
#pragma unroll
      for (int k = 0; k < STRIP; ++k) {
        const int rr = r + k * nph;
        v[k] = rr < r1 ? colp[(size_t)reflect(p * th + rr, H) * W] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < STRIP; ++k)
        if (r + k * nph < r1) atomicAdd(h + bin_of(v[k]), 1);
    }
  }
  __syncthreads();

  // phase: send the band
  // the band's histogram into this rank's row of rank 0's bands
  {
    int s = 0;
#pragma unroll
    for (int w = 0; w < LUT_WARPS; ++w) s += wh[w][tid];
    cluster_wait();
    *cluster.map_shared_rank(&bands[rank][tid], 0) = s;
  }
  cluster_arrive();
  if (rank != 0) return;            // nobody reads this CTA's memory

  // phase: gather the bands
  cluster_wait();
  int hb = 0;
#pragma unroll
  for (int k = 0; k < CL; ++k) hb += bands[k][tid];

  // phase: clip, excess and CDF
  const float hf = static_cast<float>(hb);
  const float cl = fminf(hf, limit);
  double e = static_cast<double>(__fsub_rn(hf, cl));
  float cdf;
  if (hist_out != nullptr) hist_out[t * NBINS + tid] = hb;
  if (any_order) {
    // every clipped bin c + e/256 is exact in f32 and every partial sum in
    // double: the CDF is the scan of c plus (b + 1) e/256, one barrier
    double s = static_cast<double>(cl);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    e = warp_sum(e);
    if (lane == 31) {
      we[warp] = e;
      wc[warp] = s;
    }
    __syncthreads();
    double et = 0.0, pre = 0.0;
#pragma unroll
    for (int w = 0; w < LUT_WARPS; ++w) {
      et += we[w];
      if (w < warp) pre += wc[w];
    }
    const float share = __fdiv_rn(static_cast<float>(et), (float)NBINS);
    cdf = static_cast<float>(pre + s + static_cast<double>(tid + 1) * share);
  } else {
    // the excess, then the clipped bins summed in bin order, as
    // torch.cumsum does
    e = warp_sum(e);
    if (lane == 0) we[warp] = e;
    __syncthreads();
    double et = 0.0;
#pragma unroll
    for (int w = 0; w < LUT_WARPS; ++w) et += we[w];
    const float excess = static_cast<float>(et);
    cdf_in[tid] = __fadd_rn(cl, __fdiv_rn(excess, (float)NBINS));
    __syncthreads();
    if (tid == 0) {
      double acc = 0.0;
      for (int b = 0; b < NBINS; ++b) {
        acc += static_cast<double>(cdf_in[b]);
        cdf_in[b] = static_cast<float>(acc);
      }
    }
    __syncthreads();
    cdf = cdf_in[tid];
  }

  // phase: LUT store
  luts[t * NBINS + tid] =
      __bfloat162float(__float2bfloat16_rn(__fmul_rn(cdf, scale)));
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
                    int g, float limit, float scale, int any_order,
                    cudaStream_t stream) {
  const int th = (H + g - 1) / g, tw = (W + g - 1) / g;
  clahe_luts_kernel<<<g * g * CL, LUT_THREADS, 0, stream>>>(
      img, luts, hist, H, W, th, tw, g, limit, scale, any_order);
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
