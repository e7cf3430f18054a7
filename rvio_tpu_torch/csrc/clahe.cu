// CLAHE (contrast-limited adaptive histogram equalization), the two halves.
//
// Replaces rvio_tpu/ops/clahe.py (_hist_call / _hist_kernel and
// _apply_call / _apply_kernel) and computes the function of their oracle's
// XLA path, rvio_tpu/frontend/image.py:clahe, on an (H, W) f32 image cut
// into a g x g grid of th x tw tiles (th = ceil(H/g), tw = ceil(W/g)) over
// its reflect-padded (g th, g tw) extension.  B images of one size (a
// batched tracker's segments) are one launch of each kernel: the image is
// grid.y of K10 (one cluster per image and tile) and grid.z of K11 (one set
// of blocks per image and cell).
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
// clahe_apply_kernel (K11): the bin is read from the pixel's clamped,
// truncated value, the LUT entries of the (clamped) 2 x 2 surrounding tiles
// are blended bilinearly with the oracle's tile coordinates
// ty = (y - (th-1)/2) / th: first over rows in each tile column, the second
// product fused (__fmaf_rn, as the oracle's contraction and the plain
// version's torch.addcmul round it), then over columns.  Every other
// operation rounds on its own (__fdiv_rn, __fmul_rn, __fadd_rn: no other
// fusion, IEEE division) in the plain version's order, so the two agree
// bitwise.  Bound by bytes: one read of the image (1.44 MB at 752 x 480),
// one write of the output, 25.6 kB of LUTs (0.87 us at 3.35 TB/s).  What
// held a thread-a-pixel design (every block staging all g^2 LUTs, a barrier
// before its first pixel, one DRAM round trip a row) far from it was
// latency and the table's copies.  Here:
//
//   - the image is cut into the cells between four tile centres: along an
//     axis of tiles of `size`, cell j spans [B_j, B_j+1), B_0 = 0,
//     B_j = j size + size/2, B_g = n (t0 = j on it, t1 = min(j+1, g-1)), so
//     every pixel of a cell reads the same four LUTs;
//   - a block covers APPLY_QX quads of columns by APPLY_RY * APPLY_R rows
//     of one cell (quads aligned to 4 columns, those on a cell's edge
//     loaded by both cells' blocks, each storing its own columns), and
//     stages only its cell's four LUTs, interleaved by bin (one float4 a
//     bin, 4 kB), by cp.async, issued before its pixel loads and waited for
//     after them;
//   - a thread loads its quad's APPLY_R rows (a float4 each, four floats
//     where W % 4 != 0 or a pointer is not 16-byte aligned) before the first
//     blend, forms its four columns' weights once and each row's once, and
//     reads a pixel's four entries with one 16-byte shared load;
//   - the grid is a handful of blocks a cell (240 of 128 threads at 752 x
//     480, g = 5): one wave on the 132 SMs, and no limit on g.

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
constexpr int APPLY_QX = 16;      // apply: threads along a row, a quad each
constexpr int APPLY_RY = 8;       // rows of threads
constexpr int APPLY_R = 4;        // rows a thread
constexpr int APPLY_THREADS = APPLY_QX * APPLY_RY;
static_assert(4 * NBINS % APPLY_THREADS == 0, "the LUT copies divide evenly");

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
  {
    const size_t b = blockIdx.y;   // the image
    img += b * H * W;
    luts += b * g * g * NBINS;
    if (hist_out != nullptr) hist_out += b * g * g * NBINS;
  }
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

// The start of cell j along an axis of n pixels in tiles of `size`: the
// first index whose t0 is j (exact while j size < 2^23: the quotient of a
// half-integer by size is then never rounded up to j from below).
__host__ __device__ __forceinline__ int cell_start(int j, int n, int size,
                                                   int g) {
  const int b = j * size + size / 2;
  return j <= 0 ? 0 : j >= g || b > n ? n : b;
}

// Chunks of cell j: column quads (unit 4, a quad on the cell's edge counted
// by both cells) or rows (unit 1), `per` a chunk.
__host__ __device__ __forceinline__ int cell_chunks(int j, int n, int size,
                                                    int g, int unit,
                                                    int per) {
  const int a = cell_start(j, n, size, g), b = cell_start(j + 1, n, size, g);
  if (b <= a) return 0;
  const int units = (b - 1) / unit - a / unit + 1;
  return (units + per - 1) / per;
}

// The cell of chunk c (cells in order, each cell_chunks of them); c becomes
// the chunk's index within its cell.
__device__ __forceinline__ int find_cell(int* c, int n, int size, int g,
                                         int unit, int per) {
  int j = 0;
  for (; j < g - 1; ++j) {
    const int k = cell_chunks(j, n, size, g, unit, per);
    if (*c < k) break;
    *c -= k;
  }
  return j;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   rvio::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// VEC: the quads by float4 (W % 4 == 0, 16-byte aligned image and output).
template <bool VEC>
__global__ void __launch_bounds__(APPLY_THREADS)
clahe_apply_kernel(const float* __restrict__ img,
                   const float* __restrict__ luts, float* __restrict__ out,
                   int H, int W, int th, int tw, int g, float cy, float cx) {
  __shared__ float4 s4[NBINS];   // a bin's entries of the cell's four LUTs
  const int tid = threadIdx.y * APPLY_QX + threadIdx.x;
  {
    const size_t b = blockIdx.z;   // the image
    img += b * H * W;
    luts += b * g * g * NBINS;
    out += b * H * W;
  }

  // phase: the cell, the LUT copies
  // the block's cell and chunk along each axis; the four LUTs in the order
  // (ty0, tx0), (ty1, tx0), (ty0, tx1), (ty1, tx1), a bin a float4
  int bx = blockIdx.x, by = blockIdx.y;
  const int jx = find_cell(&bx, W, tw, g, 4, APPLY_QX);
  const int jy = find_cell(&by, H, th, g, 1, APPLY_RY * APPLY_R);
  const int tx1 = min(jx + 1, g - 1), ty1 = min(jy + 1, g - 1);
  float* s = reinterpret_cast<float*>(s4);
#pragma unroll
  for (int i = 0; i < 4 * NBINS / APPLY_THREADS; ++i) {
    const int e = tid + i * APPLY_THREADS;
    const int k = e / NBINS, b = e % NBINS;
    const int t = ((k & 1) ? ty1 : jy) * g + ((k & 2) ? tx1 : jx);
    cp_async4(s + 4 * b + k, luts + t * NBINS + b);
  }

  // phase: pixel loads
  // the thread's quad of columns and APPLY_R rows of the chunk, loaded
  // before the first blend
  const int xa = cell_start(jx, W, tw, g), xb = cell_start(jx + 1, W, tw, g);
  const int x0 = 4 * (xa / 4 + bx * APPLY_QX + threadIdx.x);
  const int ya = cell_start(jy, H, th, g) + by * APPLY_RY * APPLY_R,
            yb = min(cell_start(jy + 1, H, th, g), ya + APPLY_RY * APPLY_R);
  const bool quad = x0 < xb;     // a quad of the cell (its edge columns aside)
  float4 v[APPLY_R];
#pragma unroll
  for (int k = 0; k < APPLY_R; ++k) {
    const int y = ya + threadIdx.y + k * APPLY_RY;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (quad && y < yb) {
      const float* p = img + (size_t)y * W + x0;
      if constexpr (VEC) {
        v[k] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[k].x = __ldg(p);
        if (x0 + 1 < W) v[k].y = __ldg(p + 1);
        if (x0 + 2 < W) v[k].z = __ldg(p + 2);
        if (x0 + 3 < W) v[k].w = __ldg(p + 3);
      }
    }
  }

  // phase: column weights, the LUTs' wait
  // each column's weights once; its tiles are the cell's
  float wx0[4], wx1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int t0, t1;
    tile_pair(x0 + c, cx, tw, g, &t0, &t1, &wx0[c], &wx1[c]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // phase: blend and store
  // each row's weights once; a pixel's four entries by one shared load;
  // the cell's columns stored (a float4 where the quad lies inside it)
  const bool inside = VEC && x0 >= xa && x0 + 4 <= xb;
#pragma unroll
  for (int k = 0; k < APPLY_R; ++k) {
    const int y = ya + threadIdx.y + k * APPLY_RY;
    if (!quad || y >= yb) continue;
    int t0, t1;
    float wy0, wy1;
    tile_pair(y, cy, th, g, &t0, &t1, &wy0, &wy1);
    const float in[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 e = s4[bin_of(in[c])];
      const float s0 = __fmaf_rn(wy1, e.y, __fmul_rn(wy0, e.x));
      const float s1 = __fmaf_rn(wy1, e.w, __fmul_rn(wy0, e.z));
      o[c] = __fadd_rn(__fmul_rn(s0, wx0[c]), __fmul_rn(s1, wx1[c]));
    }
    float* q = out + (size_t)y * W + x0;
    if (inside) {
      *reinterpret_cast<float4*>(q) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (x0 + c >= xa && x0 + c < xb) q[c] = o[c];
    }
  }
}

}  // namespace

extern "C" {

// B images (H, W) -> B x g^2 LUTs (and histograms); B < 65536.
int rvio_clahe_luts_batch(const float* img, float* luts, int* hist, int B,
                          int H, int W, int g, float limit, float scale,
                          int any_order, cudaStream_t stream) {
  if (B == 0) return 0;
  const int th = (H + g - 1) / g, tw = (W + g - 1) / g;
  clahe_luts_kernel<<<dim3(g * g * CL, B), LUT_THREADS, 0, stream>>>(
      img, luts, hist, H, W, th, tw, g, limit, scale, any_order);
  return static_cast<int>(cudaGetLastError());
}

// One image: B = 1.
int rvio_clahe_luts(const float* img, float* luts, int* hist, int H, int W,
                    int g, float limit, float scale, int any_order,
                    cudaStream_t stream) {
  return rvio_clahe_luts_batch(img, luts, hist, 1, H, W, g, limit, scale,
                               any_order, stream);
}

// B images (H, W) and their B x g^2 LUTs -> B images; B < 65536.
int rvio_clahe_apply_batch(const float* img, const float* luts, float* out,
                           int B, int H, int W, int g, float cy, float cx,
                           cudaStream_t stream) {
  if (B == 0) return 0;
  const int th = (H + g - 1) / g, tw = (W + g - 1) / g;
  dim3 grid(0, 0, B);
  for (int j = 0; j < g; ++j) {
    grid.x += cell_chunks(j, W, tw, g, 4, APPLY_QX);
    grid.y += cell_chunks(j, H, th, g, 1, APPLY_RY * APPLY_R);
  }
  const dim3 block(APPLY_QX, APPLY_RY);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    clahe_apply_kernel<true><<<grid, block, 0, stream>>>(
        img, luts, out, H, W, th, tw, g, cy, cx);
  else
    clahe_apply_kernel<false><<<grid, block, 0, stream>>>(
        img, luts, out, H, W, th, tw, g, cy, cx);
  return static_cast<int>(cudaGetLastError());
}

// One image: B = 1.
int rvio_clahe_apply(const float* img, const float* luts, float* out, int H,
                     int W, int g, float cy, float cx, cudaStream_t stream) {
  return rvio_clahe_apply_batch(img, luts, out, 1, H, W, g, cy, cx, stream);
}

}  // extern "C"
