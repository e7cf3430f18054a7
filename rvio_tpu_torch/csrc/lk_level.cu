// One Lucas-Kanade pyramid level for N features (the oracle's klt_track,
// rvio_tpu/frontend/klt.py:178-268, from the gathered tiles on).
//
// Replaces rvio_tpu/ops/klt_iterate.py (lk_level_pallas / _lk_level_kernel)
// with the CPU oracle's borders: taps clip one by one to [0, tile-2] (the TPU
// kernel clamps the whole window).
//
// Bound: at the tracker's operating point (200 features, 40 x 32 f32 tiles,
// win 15, at most 30 trips) the function reads about 0.48 MB of tile pixels
// (each template's tap support with its Scharr halo, the search-tile windows
// its live trips visit) and does about 7 MFLOP: 0.14 us at 3.35 TB/s, far
// under a launch.  What sets the time is latency: a chain of up to max_iters
// dependent Gauss-Newton steps per feature, and the slowest feature ends the
// launch.  So the design keeps every step inside one warp:
//
//   One warp per feature, up to WPB_MAX warps a block (three fit 48 KB at
//   40 x 32), each with its own slice of shared memory: an mbarrier, the
//   template and search tiles (each one contiguous run of TH * TW floats,
//   brought by one 1-D bulk copy, cp.async.bulk, that lane 0 starts before
//   anything else) and the template's Scharr gradients over the support box
//   of its clipped taps only (at most (win + 1)^2 pixels, reflect-padded at
//   the tile edge as klt._tile_scharr is).  Lane l takes a strip of the
//   window: column l % win, KT consecutive rows (KT = 8 at win 15, two
//   strips a column; from win 17 to 31 one strip a column, win taps a lane,
//   two warps a block, whose samples spill to local memory: correct, not
//   fast; past 31 the instance KT = 0 below), so where no tap clips the
//   strip's KT + 1 pixel rows
//   are read once; it keeps its template and gradient samples in registers,
//   and the search pixels too, which a trip reads again only when the
//   window's integer position moved.  Every sum is a __shfl_xor_sync
//   butterfly, which leaves the same bits in every lane, so control flow
//   stays uniform across the warp and no step waits on a block barrier; a
//   warp whose feature converged or died leaves its loop on its own.
//
//   The finish runs in the same launch: each warp stores its feature's
//   trips and flags (alive; within the wander bound at its final position;
//   in bounds), the block takes a ticket (a release-acquire atomicInc modulo
//   gridDim.x, so the counter is back at 0 after every launch and a
//   CUDA-graph replay needs no reset), and the block that draws the last
//   ticket takes T, the largest trip count, and writes every status.  The
//   oracle's batch loop runs T trips: a converged feature whose own trips
//   ended before T is tested once more against the wander bound at its final
//   position.  At the last level the result must also lie in bounds.  The
//   ticket is one 32-bit counter per CUDA stream and segment
//   (ops/klt_iterate.py keeps them): launches on one stream run one after
//   another, so they never share a count.
//
//   B segments (a batched tracker's images) are one launch, grid.y the
//   segment.  The oracle's batch loop, vmapped over segments, stops each
//   segment at its own T, so the finish is per segment: no block holds
//   features of two segments, each segment's blocks draw tickets on its own
//   counter, and the block that draws the segment's last ticket takes that
//   segment's T and writes its statuses.
//
// Where the time goes (scripts/filter_kernel_phases.py --kernel k8): a trip
// costs about 450-600 cycles (the sample's shared-memory round trip, a
// five-level butterfly of two sums, the step), the template's setup about
// 4500 and the ticket and the last block's finish about 3000; at T = 30 the
// trips are two thirds of a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WPB_MAX = 4;         // warps (features) a block, at most
constexpr int WIN_MAX = 31;        // the widest strip window (a column a lane)
constexpr int SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// Taps a lane: ceil(win / (32 / win)), one of 1, 2, 3, 4, 6, 7 or 8 up to
// win 16; from win 17 on a lane takes a whole column of the window, and
// the instances KT = 24 and 31 serve (the taps past the window at zero
// weight); past WIN_MAX, 0: the instance without trips.
__host__ __device__ __forceinline__ int taps_a_lane(int win) {
  if (win > WIN_MAX) return 0;
  const int strips = 32 / win, kt = (win + strips - 1) / strips;
  return kt <= 8 ? kt : (kt <= 24 ? 24 : 31);
}

// Floats of one gradient box, rounded up to 16 bytes: its rows are win + 1
// wide, and a strip's reads span (32 / win) KT + 1 of them (17 x 17 floats
// cover every window up to 16).
__host__ __device__ __forceinline__ int box_floats(int win) {
  return win <= 16 ? 292
         : win > WIN_MAX ? 0
                         : ((win + 1) * (taps_a_lane(win) + 1) + 3) & ~3;
}

// bytes of one warp's slice: the mbarrier (16, keeping what follows 16-byte
// aligned), both tiles, both gradient boxes
__host__ __device__ __forceinline__ int warp_bytes(int tt, int win) {
  return 16 + 8 * tt + 8 * box_floats(win);
}

__device__ __forceinline__ int reflect(int k, int n) {
  return k < 0 ? -k : (k >= n ? 2 * n - 2 - k : k);
}

// Scharr / 32 of the tile T (TH x TW, reflect-padded) at pixel (i, j), in
// the order of the strip instances' box and of klt._tile_scharr.
__device__ __forceinline__ void scharr_at(const float* T, int TH, int TW,
                                          int i, int j, float& gx,
                                          float& gy) {
  const float ca = 3.f / 32.f, cb = 10.f / 32.f;
  const int jl = reflect(j - 1, TW), jr = reflect(j + 1, TW);
  const float* U = T + reflect(i - 1, TH) * TW;
  const float* M = T + i * TW;
  const float* D = T + reflect(i + 1, TH) * TW;
  const float s0 = ca * U[jl] + cb * M[jl] + ca * D[jl];
  const float s2 = ca * U[jr] + cb * M[jr] + ca * D[jr];
  gx = s2 - s0;
  gy = ca * (D[jl] - U[jl]) + cb * (D[j] - U[j]) + ca * (D[jr] - U[jr]);
}

// The bilinear sample at fractions (wy, wx) of the 2 x 2 pixels from (y, x)
// of T (row stride ld), as Strip::blend and _sample_patches take it.
__device__ __forceinline__ float blend_at(const float* T, int ld, int y,
                                          int x, float wy, float wx) {
  const float* p = T + y * ld + x;
  const float r0 = p[0] * (1.f - wy) + p[ld] * wy;
  const float r1 = p[1] * (1.f - wy) + p[ld + 1] * wy;
  return r0 * (1.f - wx) + r1 * wx;
}

// This lane's strip of KT window taps (window column b, rows a0 ..
// a0 + KT - 1): each tap's 2 x 2 pixels, read from T (row stride ld) for
// the window whose first tap lies at row iy, column jx of T, each tap's
// top-left pixel clipped to [0, imax] x [0, jmax] as the oracle's
// _sample_patches clips it.  Where no row of the strip clips and its last row,
// iy + a0 + KT, lies in T (`whole`, uniform over the warp), the strip's
// KT + 1 rows are read once each.
template <int KT>
struct Strip {
  float p00[KT], p01[KT], p10[KT], p11[KT];

  __device__ __forceinline__ void read(const float* T, int ld, int iy,
                                       int jx, int a0, int b, int imax,
                                       int jmax, bool whole) {
    if (whole) {
      const float* p = T + (iy + a0) * ld + jx + b;
      p00[0] = p[0];
      p01[0] = p[1];
#pragma unroll
      for (int m = 0; m < KT; ++m) {
        p10[m] = p[(m + 1) * ld];
        p11[m] = p[(m + 1) * ld + 1];
        if (m + 1 < KT) {
          p00[m + 1] = p10[m];
          p01[m + 1] = p11[m];
        }
      }
    } else {
      const int j = min(max(jx + b, 0), jmax);
#pragma unroll
      for (int m = 0; m < KT; ++m) {
        const float* q = T + min(max(iy + a0 + m, 0), imax) * ld + j;
        p00[m] = q[0];
        p01[m] = q[1];
        p10[m] = q[ld];
        p11[m] = q[ld + 1];
      }
    }
  }

  // The taps' bilinear samples at the window's fractions (wy, wx).
  __device__ __forceinline__ void blend(float wy, float wx,
                                        float (&out)[KT]) const {
#pragma unroll
    for (int m = 0; m < KT; ++m) {
      const float r0 = p00[m] * (1.f - wy) + p10[m] * wy;
      const float r1 = p01[m] * (1.f - wy) + p11[m] * wy;
      out[m] = r0 * (1.f - wx) + r1 * wx;
    }
  }
};

// The strip in the search tile, kept in registers between trips: a trip
// whose window starts at the same integer position as the trip before (the
// rule once a feature settles) reads no shared memory, only blends again
// with its new fractions.
template <int KT>
struct SearchStrip {
  Strip<KT> px;
  int iy = -(1 << 30), jx = 0;   // the window px was read at

  // The taps' samples around (ly, lx), tile coordinates clamped to the
  // tile as the oracle clamps them.
  __device__ __forceinline__ void sample(const float* Ts, int TH, int TW,
                                         float ly, float lx, int r, int win,
                                         int P, int a0, int b,
                                         float (&out)[KT]) {
    ly = fminf(fmaxf(ly, 0.f), (float)(TH - 1));
    lx = fminf(fmaxf(lx, 0.f), (float)(TW - 1));
    const float fy = floorf(ly), fx = floorf(lx);
    const int y = (int)fy - r, x = (int)fx - r;
    if (y != iy || x != jx) {
      iy = y;
      jx = x;
      px.read(Ts, TW, y, x, a0, b, TH - 2, TW - 2,
              y >= 0 && y + P * KT <= TH - 1 && x >= 0 && x + win <= TW - 1);
    }
    px.blend(ly - fy, lx - fx, out);
  }
};

// atomicInc with release-acquire semantics at device scope: returns the old
// value and leaves (old >= wrap ? 0 : old + 1).
__device__ __forceinline__ unsigned ticket_inc(unsigned* p, unsigned wrap) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(wrap) : "memory");
  return old;
}

// scratch word of a feature: trips << 3 | in bounds << 2 | within the
// wander bound << 1 | alive
constexpr int ALIVE = 1, DOK = 2, INB = 4, TRIPS_SHIFT = 3;
constexpr int FIN = 8;   // the finish's loads in flight a thread

// KT: taps a lane (taps_a_lane): 8 at win 15, 24 at win 21.
// phase sync: __syncwarp()
template <int KT>
__global__ void __launch_bounds__(32 * WPB_MAX)
lk_level_kernel(const float* __restrict__ t_tiles,
                const float* __restrict__ n_tiles,
                const float* __restrict__ loc0,
                const float* __restrict__ g_init,
                const int* __restrict__ o1,
                const bool* __restrict__ status,
                float* __restrict__ g_out, float* __restrict__ err_out,
                int* __restrict__ scratch, bool* __restrict__ status_out,
                unsigned* __restrict__ ticket, int N, int TH, int TW, int win,
                int max_iters, float eps, float min_eig, float wander,
                int last, int H, int W) {
  // the segment: its features, outputs, scratch words and ticket
  {
    const size_t sg = blockIdx.y;
    const size_t tt = (size_t)TH * TW;
    t_tiles += sg * N * tt;
    n_tiles += sg * N * tt;
    loc0 += 2 * sg * N;
    g_init += 2 * sg * N;
    o1 += 2 * sg * N;
    status += sg * N;
    g_out += 2 * sg * N;
    err_out += sg * N;
    scratch += sg * N;
    status_out += sg * N;
    ticket += sg;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[WPB_MAX];
  __shared__ bool last_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int TT = TH * TW;
  unsigned char* mine = smem + warp * warp_bytes(TT, win);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mine);
  float* Tt = reinterpret_cast<float*>(mine + 16);
  float* Ts = Tt + TT;
  float* GX = Ts + TT;
  float* GY = GX + box_floats(win);
  const int n = blockIdx.x * wpb + warp;

  // phase: bulk copies of both tiles, the feature's scalars
  if (n < N) {
    if (lane == 0) {
      rvio::mbar_init_expect(bar, 8u * TT);
      rvio::bulk_copy(Tt, t_tiles + (size_t)n * TT, 4 * TT, bar);
      rvio::bulk_copy(Ts, n_tiles + (size_t)n * TT, 4 * TT, bar);
    }
    __syncwarp();
    const float l0x = loc0[2 * n], l0y = loc0[2 * n + 1];
    const float gix = g_init[2 * n], giy = g_init[2 * n + 1];
    const float ox = (float)o1[2 * n], oy = (float)o1[2 * n + 1];
    const bool live = status[n];
    const int r = win / 2, area = win * win;
    // the template window: every tap shares one fraction, its rows start
    // at iy0 + a clipped to [0, TH-2] (columns alike), so the taps read the
    // box [by0, by1] x [bx0, bx1]
    const float fy = floorf(l0y), fx = floorf(l0x);
    const float wy0 = l0y - fy, wx0 = l0x - fx;
    const int iy0 = (int)fy - r, jx0 = (int)fx - r;
    const int by0 = min(max(iy0, 0), TH - 2);
    const int by1 = min(max(iy0 + win - 1, 0), TH - 2) + 1;
    const int bx0 = min(max(jx0, 0), TW - 2);
    const int bx1 = min(max(jx0 + win - 1, 0), TW - 2) + 1;
    const int bw = bx1 - bx0 + 1, bh = by1 - by0 + 1, ld = win + 1;
    rvio::mbar_wait(bar);

    // phase: Scharr /32 over the support box, reflect-padded
    // lane -> (row parity, column) for a box up to 16 wide, (row, column)
    // up to 32; a lane past the box's width repeats its last column
    {
      const float ca = 3.f / 32.f, cb = 10.f / 32.f;
      const int cbits = bw <= 16 ? 4 : 5;
      const int c = min(lane & ((1 << cbits) - 1), bw - 1);
      const int j = bx0 + c;
      const int jl = reflect(j - 1, TW), jr = reflect(j + 1, TW);
#pragma unroll 4
      for (int pi = lane >> cbits; pi < bh; pi += 32 >> cbits) {
        const int i = by0 + pi;
        const float* U = Tt + reflect(i - 1, TH) * TW;
        const float* M = Tt + i * TW;
        const float* D = Tt + reflect(i + 1, TH) * TW;
        const float u0 = U[jl], u1 = U[j], u2 = U[jr];
        const float m0 = M[jl], m2 = M[jr];
        const float d0 = D[jl], d1 = D[j], d2 = D[jr];
        const float s0 = ca * u0 + cb * m0 + ca * d0;
        const float s2 = ca * u2 + cb * m2 + ca * d2;
        GX[pi * ld + c] = s2 - s0;
        GY[pi * ld + c] = ca * (d0 - u0) + cb * (d1 - u1) + ca * (d2 - u2);
      }
    }
    __syncwarp();

    // phase: template taps, the 2 x 2 system
    // Lane l takes window column b = l % win and the KT rows from
    // a0 = (l / win) KT: a strip.  A tap past the window (or a lane past
    // P win) has zero weight, so no tap is a branch.
    const int P = 32 / win;
    const bool lane_on = lane < P * win;
    const int strip = lane_on ? lane / win : 0;
    const int b = lane_on ? lane - strip * win : win - 1;
    const int a0 = strip * KT;
    float tm[KT], gx[KT], gy[KT];
    {
      const bool whole = iy0 >= 0 && iy0 + P * KT <= TH - 1 && jx0 >= 0 &&
                         jx0 + win <= TW - 1;
      Strip<KT> s;
      s.read(Tt, TW, iy0, jx0, a0, b, TH - 2, TW - 2, whole);
      s.blend(wy0, wx0, tm);
      // the box holds the taps' pixels from (by0, bx0) on
      s.read(GX, ld, iy0 - by0, jx0 - bx0, a0, b, bh - 2, bw - 2, whole);
      s.blend(wy0, wx0, gx);
      s.read(GY, ld, iy0 - by0, jx0 - bx0, a0, b, bh - 2, bw - 2, whole);
      s.blend(wy0, wx0, gy);
    }
    float gxx = 0.f, gxy = 0.f, gyy = 0.f;
#pragma unroll
    for (int m = 0; m < KT; ++m) {
      const bool on = lane_on && a0 + m < win;
      tm[m] = on ? tm[m] : 0.f;
      gx[m] = on ? gx[m] : 0.f;
      gy[m] = on ? gy[m] : 0.f;
      gxx += gx[m] * gx[m];
      gxy += gx[m] * gy[m];
      gyy += gy[m] * gy[m];
    }
    gxx = rvio::warp_sum(gxx);
    gxy = rvio::warp_sum(gxy);
    gyy = rvio::warp_sum(gyy);
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float meig =
        (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / (2.f * area);
    const bool ok_level = (meig > min_eig) && (det > 1e-12f);
    const float dets = det == 0.f ? 1.f : det;
    const float inv00 = ok_level ? gyy / dets : 0.f;
    const float inv01 = ok_level ? -gxy / dets : 0.f;
    const float inv11 = ok_level ? gxx / dets : 0.f;

    // phase: Gauss-Newton trips
    SearchStrip<KT> search;
    float py = giy, px = gix;
    bool alive = live && ok_level, conv = false;
    int trips = 0;
    for (int it = 0; it < max_iters && alive && !conv; ++it) {
      ++trips;
      // the wander test of the trip's start, taken after its sums (they
      // do not depend on it) so its latency hides under theirs
      const bool wandered =
          !(fabsf(py - giy) <= wander && fabsf(px - gix) <= wander);
      float cur[KT];
      search.sample(Ts, TH, TW, py - oy, px - ox, r, win, P, a0, b, cur);
      float bx = 0.f, by = 0.f, bx2 = 0.f, by2 = 0.f;
#pragma unroll
      for (int m = 0; m < KT; m += 2) {
        const float di = cur[m] - tm[m];
        bx += di * gx[m];   // a tap past the window: gx = gy = 0
        by += di * gy[m];
        if (m + 1 < KT) {
          const float dj = cur[m + 1] - tm[m + 1];
          bx2 += dj * gx[m + 1];
          by2 += dj * gy[m + 1];
        }
      }
      bx += bx2;
      by += by2;
      bx = rvio::warp_sum(bx);
      by = rvio::warp_sum(by);
      if (wandered) {
        alive = false;
        break;
      }
      const float sx = -(inv00 * bx + inv01 * by);
      const float sy = -(inv01 * bx + inv11 * by);
      px += sx;
      py += sy;
      conv = sx * sx + sy * sy < eps * eps;
    }

    // phase: last-level error
    float e = 0.f;
    if (last) {
      float cur[KT];
      search.sample(Ts, TH, TW, py - oy, px - ox, r, win, P, a0, b, cur);
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < KT; ++m)
        s += lane_on && a0 + m < win ? fabsf(cur[m] - tm[m]) : 0.f;
      e = rvio::warp_sum(s) / (float)area;
    }

    // phase: store
    if (lane == 0) {
      const float lo = (float)(r + 1);
      const bool dok = fabsf(py - giy) <= wander && fabsf(px - gix) <= wander;
      const bool inb = px > lo && px < (float)(W - r - 2) && py > lo &&
                       py < (float)(H - r - 2);
      g_out[2 * n] = px;
      g_out[2 * n + 1] = py;
      err_out[n] = e;
      scratch[n] = trips << TRIPS_SHIFT | (alive ? ALIVE : 0) |
                   (dok ? DOK : 0) | (inb ? INB : 0);
    }
  }

  // phase: ticket
  // The block's stores, then one release-acquire increment: the block that
  // draws the last ticket sees every block's stores.
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = ticket_inc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  // phase: finish (the last block)
  if (!last_block) return;

  // T over every feature, keeping their words in the (now free) shared
  // memory, then every status
  int* keep = reinterpret_cast<int*>(smem);
  const int cap = wpb * (warp_bytes(TT, win) / 4);
  int m = 0;
  for (int i0 = threadIdx.x; i0 < N; i0 += FIN * blockDim.x) {
    int w[FIN];   // FIN words a thread in flight together
#pragma unroll
    for (int k = 0; k < FIN; ++k) {
      const int i = i0 + k * blockDim.x;
      w[k] = i < N ? __ldcg(scratch + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < FIN; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < min(N, cap)) keep[i] = w[k];
      m = max(m, w[k] >> TRIPS_SHIFT);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  int T = 0;
  for (int i = 0; i < wpb; ++i) T = max(T, red[i]);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int w = i < cap ? keep[i] : __ldcg(scratch + i);
    status_out[i] = (w & ALIVE) && ((w >> TRIPS_SHIFT) >= T || (w & DOK)) &&
                    (!last || (w & INB));
  }
}

template <int KT>
void launch(dim3 grid, int wpb, const float* t_tiles, const float* n_tiles,
            const float* loc0, const float* g_init, const int* o1,
            const bool* status, float* g_out, float* err_out, int* scratch,
            bool* status_out, unsigned* ticket, int N, int TH, int TW,
            int win, int max_iters, float eps, float min_eig, float wander,
            int last, int H, int W, cudaStream_t stream) {
  lk_level_kernel<KT><<<grid, 32 * wpb, wpb * warp_bytes(TH * TW, win),
                        stream>>>(
      t_tiles, n_tiles, loc0, g_init, o1, status, g_out, err_out, scratch,
      status_out, ticket, N, TH, TW, win, max_iters, eps, min_eig, wander,
      last, H, W);
}

// Windows past WIN_MAX (the instance KT = 0).  The tile is TILE = 32 wide,
// so the wander bound the tracker passes, (TILE - win) / 2 - 1, is
// negative there (the entry refuses such a window with a bound >= 0), and
// the plain version's first trip kills every live feature before its step:
// the guess stays g_init, every status is false once a trip runs (with
// max_iters < 1, the level's test and at the last level the in-bounds
// test), and at the last level err is the mean |sample - template| over
// the window at g_init.  This instance writes exactly those outputs: a warp
// a feature, both tiles by plain loads into its slice of shared memory,
// the window's win^2 taps strided over the lanes (the template, its Scharr
// gradients at each tap's four pixels for the level's test, the search
// samples), each sum a warp butterfly.  No trip runs, so no T: the finish
// and its ticket are not needed and the counter stays at 0.
template <>
__global__ void __launch_bounds__(32 * WPB_MAX)
lk_level_kernel<0>(const float* __restrict__ t_tiles,
                   const float* __restrict__ n_tiles,
                   const float* __restrict__ loc0,
                   const float* __restrict__ g_init,
                   const int* __restrict__ o1,
                   const bool* __restrict__ status,
                   float* __restrict__ g_out, float* __restrict__ err_out,
                   int* __restrict__, bool* __restrict__ status_out,
                   unsigned* __restrict__, int N, int TH, int TW, int win,
                   int max_iters, float, float min_eig, float, int last,
                   int H, int W) {
  {
    const size_t sg = blockIdx.y;
    const size_t tt = (size_t)TH * TW;
    t_tiles += sg * N * tt;
    n_tiles += sg * N * tt;
    loc0 += 2 * sg * N;
    g_init += 2 * sg * N;
    o1 += 2 * sg * N;
    status += sg * N;
    g_out += 2 * sg * N;
    err_out += sg * N;
    status_out += sg * N;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TT = TH * TW;
  float* Tt = reinterpret_cast<float*>(smem + warp * warp_bytes(TT, win) + 16);
  float* Ts = Tt + TT;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  for (int i = lane; i < TT; i += 32) {
    Tt[i] = t_tiles[(size_t)n * TT + i];
    Ts[i] = n_tiles[(size_t)n * TT + i];
  }
  __syncwarp();
  const float l0x = loc0[2 * n], l0y = loc0[2 * n + 1];
  const float gix = g_init[2 * n], giy = g_init[2 * n + 1];
  const float ox = (float)o1[2 * n], oy = (float)o1[2 * n + 1];
  const int r = win / 2, area = win * win;
  const float fy = floorf(l0y), fx = floorf(l0x);
  const float wy0 = l0y - fy, wx0 = l0x - fx;
  const int iy0 = (int)fy - r, jx0 = (int)fx - r;
  // the search window at g_init, clamped to the tile as the plain version
  // clamps it
  const float ly = fminf(fmaxf(giy - oy, 0.f), (float)(TH - 1));
  const float lx = fminf(fmaxf(gix - ox, 0.f), (float)(TW - 1));
  const float sy = floorf(ly), sx = floorf(lx);
  const float wy1 = ly - sy, wx1 = lx - sx;
  const int iy1 = (int)sy - r, jx1 = (int)sx - r;
  float gxx = 0.f, gxy = 0.f, gyy = 0.f, e = 0.f;
  for (int t = lane; t < area; t += 32) {
    const int a = t / win, c = t - a * win;
    const int y = min(max(iy0 + a, 0), TH - 2);
    const int x = min(max(jx0 + c, 0), TW - 2);
    float gx[4], gy[4];
    scharr_at(Tt, TH, TW, y, x, gx[0], gy[0]);
    scharr_at(Tt, TH, TW, y, x + 1, gx[1], gy[1]);
    scharr_at(Tt, TH, TW, y + 1, x, gx[2], gy[2]);
    scharr_at(Tt, TH, TW, y + 1, x + 1, gx[3], gy[3]);
    const float r0x = gx[0] * (1.f - wy0) + gx[2] * wy0;
    const float r1x = gx[1] * (1.f - wy0) + gx[3] * wy0;
    const float r0y = gy[0] * (1.f - wy0) + gy[2] * wy0;
    const float r1y = gy[1] * (1.f - wy0) + gy[3] * wy0;
    const float sgx = r0x * (1.f - wx0) + r1x * wx0;
    const float sgy = r0y * (1.f - wx0) + r1y * wx0;
    gxx += sgx * sgx;
    gxy += sgx * sgy;
    gyy += sgy * sgy;
    if (last) {
      const float tm = blend_at(Tt, TW, y, x, wy0, wx0);
      const int ys = min(max(iy1 + a, 0), TH - 2);
      const int xs = min(max(jx1 + c, 0), TW - 2);
      e += fabsf(blend_at(Ts, TW, ys, xs, wy1, wx1) - tm);
    }
  }
  gxx = rvio::warp_sum(gxx);
  gxy = rvio::warp_sum(gxy);
  gyy = rvio::warp_sum(gyy);
  e = rvio::warp_sum(e);
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float meig =
      (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / (2.f * area);
  const bool ok_level = (meig > min_eig) && (det > 1e-12f);
  bool alive = status[n] && ok_level && max_iters < 1;
  if (last) {
    const float lo = (float)(r + 1);
    alive = alive && gix > lo && gix < (float)(W - r - 2) && giy > lo &&
            giy < (float)(H - r - 2);
  }
  if (lane == 0) {
    g_out[2 * n] = gix;
    g_out[2 * n + 1] = giy;
    err_out[n] = last ? e / (float)area : 0.f;
    status_out[n] = alive;
  }
}

}  // namespace

extern "C" {

// The wrapper checks what it can name (shapes, types, 16-byte aligned tiles
// with TH * TW % 4 == 0, a wander bound < 0 past win 31, B within its
// ticket pool); this refuses the rest.  `ticket` points at B counters, one
// a segment.
int rvio_lk_level_batch(const float* t_tiles, const float* n_tiles,
                        const float* loc0, const float* g_init, const int* o1,
                        const bool* status, float* g_out, bool* status_out,
                        float* err_out, int* scratch, unsigned* ticket, int B,
                        int N, int TH, int TW, int win, int max_iters,
                        float eps, float min_eig, float wander, int last,
                        int H, int W, cudaStream_t stream) {
  if (win < 1 || (win > WIN_MAX && !(wander < 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wb = warp_bytes(TH * TW, win);
  if (TH < 2 || TW < 2 || (TH * TW) % 4 || wb > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kt = taps_a_lane(win);
  if (N == 0 || B == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = min(WPB_MAX, SMEM_MAX / wb);
  const dim3 grid((N + wpb - 1) / wpb, B);
#define RVIO_LK_ARGS                                                       \
  grid, wpb, t_tiles, n_tiles, loc0, g_init, o1, status, g_out, err_out,   \
      scratch, status_out, ticket, N, TH, TW, win, max_iters, eps, min_eig, \
      wander, last, H, W, stream
  switch (kt) {
    case 0: launch<0>(RVIO_LK_ARGS); break;
    case 1: launch<1>(RVIO_LK_ARGS); break;
    case 2: launch<2>(RVIO_LK_ARGS); break;
    case 3: launch<3>(RVIO_LK_ARGS); break;
    case 4: launch<4>(RVIO_LK_ARGS); break;
    case 6: launch<6>(RVIO_LK_ARGS); break;
    case 7: launch<7>(RVIO_LK_ARGS); break;
    case 8: launch<8>(RVIO_LK_ARGS); break;
    case 24: launch<24>(RVIO_LK_ARGS); break;
    default: launch<31>(RVIO_LK_ARGS); break;
  }
#undef RVIO_LK_ARGS
  return static_cast<int>(cudaGetLastError());
}

// One segment: B = 1.
int rvio_lk_level(const float* t_tiles, const float* n_tiles, const float* loc0,
                  const float* g_init, const int* o1, const bool* status,
                  float* g_out, bool* status_out, float* err_out, int* scratch,
                  unsigned* ticket, int N, int TH, int TW, int win,
                  int max_iters, float eps, float min_eig, float wander,
                  int last, int H, int W, cudaStream_t stream) {
  return rvio_lk_level_batch(t_tiles, n_tiles, loc0, g_init, o1, status,
                             g_out, status_out, err_out, scratch, ticket, 1,
                             N, TH, TW, win, max_iters, eps, min_eig, wander,
                             last, H, W, stream);
}

}  // extern "C"
