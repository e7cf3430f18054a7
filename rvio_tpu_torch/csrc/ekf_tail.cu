// The MSCKF update's dense tail in one kernel (K5): Cholesky compression of
// the information matrix C = Hw^T Hw, S = Hn P Hn^T + sig2 I, the gain
// K = P Hn^T S^-1, dx = K rn and the Joseph-form covariance.
//
// Replaces rvio_tpu/ops/ekf_tail.py (ekf_tail_pallas / _ekf_tail_kernel).
// It computes the port's unfused chain (ops/ekf_tail.py cholesky_tail), in
// the chain's order of operations (the TPU kernel's: rvio_tpu/ops/
// ekf_tail.py:192-226):
//
//   1. C + 1e-8 max(tr C, 1) I, lower Cholesky Lc; where a pivot is <= 0 or
//      not finite, C + n eps_f32 max(tr C, 1) I instead and `fallback` set;
//      if that fails too, dx and P_new are NaN;
//   2. rn = Lc^-1 b, Hn = [0 | Lc^T];
//   3. (P Hn^T)^T = Lc^T P[24:, :] (P symmetric: no transpose of P);
//   4. S = Lc^T P22 Lc + sig2 I, whole rows, then (S + S^T) / 2 and its
//      Cholesky Ls (NaN results where it fails);
//   5. K^T = Ls^-T Ls^-1 (P Hn^T)^T, dx = K rn;
//   6. E = I - K Hn, formed before it multiplies anything: its live
//      columns are E[:, 24:] = I[:, 24:] - K Lc^T (a clone row's diagonal
//      coefficient is 1 - g, taken before the product), then
//      X = (E P) E^T + sig2 K K^T and P_new = (X + X^T) / 2.
// Where the update observes the state, E's clone block is small: the
// products sum small terms.  Subtracting K Hn P from P after the product, an
// earlier design's order, cancels large ones, and in f32 cost P_new's
// small, well-observed entries about 6e-4 of their scale
// (scripts/joseph_order.py).
//
// Bound on the H100 at the operating point (n = 84, D = 108, one entry): the
// call moves about 85 KB (C's lower triangle, b, P's upper triangle, dx and
// P_new; 0.03 us at 3.35 TB/s) and needs about 8 MFLOP (0.12 us at
// 67 TFLOP/s; ops/checks.py ekf_tail_flops), so it is bound by latency: two
// 84-step factorizations and two 84-step triangular solves, each step
// waiting on the one before, then about 4 M multiply-adds of products.  The
// first design (one block of 512 threads, a column of a factorization or a
// row of a solve a step, one barrier each) spent 170 of its 256 us on
// those 336 steps, at about 1370 cycles a step (NVIDIA H100 80GB HBM3,
// 700 W; scripts/ekf_tail_phases.py).
//
// This design is Hopper's: a cluster of CL = 8 CTAs of 256 threads for each
// batch entry (B = 16 fills 128 of the 132 SMs), which share their inputs
// and intermediates through the tensor memory accelerator and distributed
// shared memory.
// - Inputs: P[24:, :], C and b reach every CTA by multicast bulk copies,
//   CTA r asking for rows r, r + 8, ... of each, so each SM reads an eighth
//   of them; its own rows of P by a bulk copy of its own.
// - Both factorizations run redundantly in every CTA (the same
//   instructions on the same data: bitwise the same factor everywhere, and
//   no traffic), blocked: the matrix is padded to a multiple of 8 with an
//   identity block, a panel of 8 columns is factored a row a thread, each
//   thread first factoring the 8 x 8 diagonal block in its registers
//   (rsqrt pivots), then solving its row against it, and the trailing
//   update is a rank-8 product, a row and 8 columns a thread.  Two barriers
//   a panel, 22 a factorization at n = 84, in place of 84.
// - Work that is independent by row or column is split over the CTAs: CTA
//   r forms the whole rows r hs .. of S (hs = ceil(n / 8)) and sends them
//   to every CTA by bulk copies into their shared memory, where each CTA
//   symmetrizes S alike; it owns a block of 16 of the D columns of
//   (P Hn^T)^T, solves its columns of K^T (blocked: a thread holds 8 rows
//   of a column, solves its diagonal block in registers, then the product
//   update, one barrier per 8 rows), forms its columns of E^T's clone rows,
//   I - Lc K^T (E's rows are the columns of E^T it owns), and its rows of
//   E P, sends its columns of K^T and E^T to every CTA (bulk copies), and
//   forms its rows of X, whose entries it stores straight into the CTAs
//   that own the matching rows of P_new.
// - Two cluster barriers (before K^T and E^T are sent, since the targets
//   must be done with what they overwrite; before X^T is read), and
//   mbarriers that count the bytes of the bulk copies.
// - All sums are f32 on the FP32 pipes: the port keeps TF32 off, so the
//   tensor cores are not used.  The TPU kernel's 8-wide panels, ones-matmul
//   broadcasts, selection matmuls and identity padding are Mosaic
//   workarounds and are not carried over.
// Rows are held a multiple of 4 wide (the padding zero) so the products
// read whole float4 vectors.  About 56 us a launch at the operating point,
// of which the load about 4, the two factorizations 21 and the solves 6
// (NVIDIA H100 80GB HBM3, 700 W; scripts/ekf_tail_phases.py).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;              // CTAs of a cluster, one cluster an entry
constexpr int NT = 256;            // threads per CTA
constexpr int NW = NT / 32;        // warps per CTA
constexpr int NB = 8;              // block width of the factorizations/solves
constexpr float INFO_RIDGE = 1e-8f;
constexpr int NX = 24;             // error-state rows before the clone block
// The largest n (ops/ekf_tail.py NMAX): smem_floats(92) is 193 KB of the
// 227 KB a CTA may opt into, and a panel's rows and the solves' threads
// (16 columns x 12 blocks of 8 rows) fit the CTA's 256 threads.
constexpr int NMAX = 92;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void fma4(float4& s, float a, const float4& v) {
  s.x += a * v.x; s.y += a * v.y; s.z += a * v.z; s.w += a * v.w;
}

__device__ __forceinline__ float dot8(const float4& a0, const float4& a1,
                                      const float4& b0, const float4& b1) {
  return a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w +
         a1.x * b1.x + a1.y * b1.y + a1.z * b1.z + a1.w * b1.w;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

// The CL column blocks of a width w (a multiple of 4): 4 ceil(w / 4 / CL)
// columns each, rank r's starting at r times that (the last ones may be
// short or empty).
__host__ __device__ __forceinline__ int block_width(int w) {
  return 4 * ((w / 4 + CL - 1) / CL);
}

// Row stride of the m x m matrices (m = round8(n)): at least m, and ld / 4
// odd, so that float4 reads of eight consecutive rows at one column fall
// on distinct banks.
__host__ __device__ __forceinline__ int mat_ld(int n) { return round8(n) + 4; }

// In-place lower Cholesky of the symmetric m x m matrix A (m a multiple of
// NB and at most NT; row stride ld, a multiple of 4), reading and writing
// only the lower triangle until the end, when the rest of each ld-wide row
// is set to zero (the triangular products read whole vectors).  The
// callers pad an n x n matrix to m with an identity block, so every panel
// is NB wide and no loop has a bound to test.  Panel p (columns p .. p+7):
// thread t < m - p takes row p + t, factors the 8 x 8 diagonal block in
// its registers (every such thread the same block, bitwise alike: rsqrt
// pivots, as in the TPU kernel), then its row's panel entries against it;
// after a barrier the trailing lower triangle takes the panel's rank-8
// update, a row and eight columns a thread (the lanes of a warp on
// consecutive rows of the same columns: their float4 reads of their own
// rows fall on distinct banks, the columns' rows are one broadcast).  Two
// barriers a panel.  Returns false where a pivot is <= 0 or not finite,
// the same value in every thread (through shared memory `flag`).
__device__ bool cholesky_blocked(float* A, int m, int ld, int* flag) {
  const int tid = threadIdx.x;
  if (tid == 0) *flag = 1;
  __syncthreads();
  for (int p = 0; p < m; p += NB) {
    const int i = p + tid;
    float x[NB];
    if (i < m) {
      float a[NB][NB];
#pragma unroll
      for (int r = 0; r < NB; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c) a[r][c] = A[(p + r) * ld + p + c];
      float rs[NB];
      bool good = true;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float d = a[j][j];
        good = good && d > 0.f && d < INFINITY;
        rs[j] = rsqrtf(d);
        a[j][j] = d * rs[j];
#pragma unroll
        for (int r = j + 1; r < NB; ++r) a[r][j] *= rs[j];
#pragma unroll
        for (int r = j + 1; r < NB; ++r)
#pragma unroll
          for (int c = j + 1; c <= r; ++c) a[r][c] -= a[r][j] * a[c][j];
      }
      if (!good && tid == 0) *flag = 0;
      if (tid < NB) {
        // a row of the diagonal block: written after the barrier, since
        // the other threads read the block until then
#pragma unroll
        for (int r = 0; r < NB; ++r)
          if (r == tid)
#pragma unroll
            for (int c = 0; c < NB; ++c) x[c] = c <= r ? a[r][c] : 0.f;
      } else {
        const float4 x0 = ld4(&A[i * ld + p]), x1 = ld4(&A[i * ld + p + 4]);
        x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
        x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
#pragma unroll
          for (int q = 0; q < c; ++q) x[c] -= x[q] * a[c][q];
          x[c] *= rs[c];
        }
        st4(&A[i * ld + p], make_float4(x[0], x[1], x[2], x[3]));
        st4(&A[i * ld + p + 4], make_float4(x[4], x[5], x[6], x[7]));
      }
    }
    __syncthreads();
    if (!*flag) {
      __syncthreads();            // nobody reuses `flag` before all have read
      return false;
    }
    if (tid < NB) {
      st4(&A[i * ld + p], make_float4(x[0], x[1], x[2], x[3]));
      st4(&A[i * ld + p + 4], make_float4(x[4], x[5], x[6], x[7]));
    }
    // trailing update of rows and columns s .. m-1
    const int s = p + NB, m2 = m - s, groups = m2 / NB;
    for (int t = tid; t < m2 * groups; t += NT) {
      const int gq = t / m2, i = s + t - gq * m2, k0 = s + NB * gq;
      if (k0 > i) continue;
      const float4 li0 = ld4(&A[i * ld + p]), li1 = ld4(&A[i * ld + p + 4]);
      float4 v0 = ld4(&A[i * ld + k0]), v1 = ld4(&A[i * ld + k0 + 4]);
      float u[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        u[c] = dot8(li0, li1, ld4(&A[(k0 + c) * ld + p]),
                    ld4(&A[(k0 + c) * ld + p + 4]));
      v0.x -= u[0]; v0.y -= u[1]; v0.z -= u[2]; v0.w -= u[3];
      v1.x -= u[4]; v1.y -= u[5]; v1.z -= u[6]; v1.w -= u[7];
      st4(&A[i * ld + k0], v0);
      st4(&A[i * ld + k0 + 4], v1);
    }
    __syncthreads();
  }
  const int lane = tid & 31;
  for (int i = tid >> 5; i < m; i += NW)
    for (int k = i + 1 + lane; k < ld; k += 32) A[i * ld + k] = 0.f;
  __syncthreads();
  return true;
}

// Load C + ridge I into A, padded to m = round8(n) rows with an identity
// block (row stride ld, the rest of each row zero).
__device__ void load_ridged(float* A, int ld, const float* C, int n,
                            float ridge) {
  const int lane = threadIdx.x & 31, m = round8(n);
  for (int i = threadIdx.x >> 5; i < m; i += NW)
    for (int k = lane; k < ld; k += 32)
      A[i * ld + k] = i < n && k < n ? C[i * n + k] + (i == k ? ridge : 0.f)
                                     : (i == k ? 1.f : 0.f);
  __syncthreads();
}

// Y = L^-1 Y, then Y = L^-T Y, in place, for the lower m x m factor L (m a
// multiple of NB, row stride ld, the padding rows of Y zero) and the m x w
// right-hand sides Y (row stride ldy, w <= 16).  Thread (j, g) holds rows
// 8 g .. 8 g + 7 of column j in registers.  Step b of the forward solve:
// thread (j, b) solves its rows against L's diagonal block (reciprocal
// pivots rd, taken ahead; the block read into registers before any store)
// and publishes them; after a barrier every thread (j, g > b) subtracts
// L[8 g.., 8 b..] times them.  The backward solve runs the blocks the other
// way with L^T.  One barrier per block and direction.
__device__ void solve_blocked(const float* L, int m, int ld, float* Y, int w,
                              int ldy, const float* rd) {
  const int tid = threadIdx.x;
  const int nblk = m / NB;
  const int j = tid % 16, g = tid / 16;
  const bool mine = j < w && g < nblk;
  float v[NB];
#pragma unroll
  for (int a = 0; a < NB; ++a) v[a] = mine ? Y[(NB * g + a) * ldy + j] : 0.f;
  for (int b = 0; b < nblk; ++b) {
    if (mine && g == b) {
      float lb[NB][NB], r[NB];        // the block's strict lower triangle
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        r[q] = rd[NB * b + q];
#pragma unroll
        for (int c = 0; c < q; ++c) lb[q][c] = L[(NB * b + q) * ld + NB * b + c];
      }
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        v[a] *= r[a];
#pragma unroll
        for (int c = a + 1; c < NB; ++c) v[c] -= lb[c][a] * v[a];
      }
#pragma unroll
      for (int a = 0; a < NB; ++a) Y[(NB * b + a) * ldy + j] = v[a];
    }
    __syncthreads();
    if (mine && g > b) {
      float y[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) y[c] = Y[(NB * b + c) * ldy + j];
      const float4 y0 = make_float4(y[0], y[1], y[2], y[3]);
      const float4 y1 = make_float4(y[4], y[5], y[6], y[7]);
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        const int i = NB * g + a;
        v[a] -= dot8(ld4(&L[i * ld + NB * b]), ld4(&L[i * ld + NB * b + 4]),
                     y0, y1);
      }
    }
  }
  __syncthreads();
  for (int b = nblk - 1; b >= 0; --b) {
    if (mine && g == b) {
      float lb[NB][NB], r[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        r[q] = rd[NB * b + q];
#pragma unroll
        for (int c = 0; c < q; ++c) lb[q][c] = L[(NB * b + q) * ld + NB * b + c];
      }
#pragma unroll
      for (int a = NB - 1; a >= 0; --a) {
        v[a] *= r[a];
#pragma unroll
        for (int c = 0; c < a; ++c) v[c] -= lb[a][c] * v[a];
      }
#pragma unroll
      for (int a = 0; a < NB; ++a) Y[(NB * b + a) * ldy + j] = v[a];
    }
    __syncthreads();
    if (mine && g < b) {
      float y[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) y[c] = Y[(NB * b + c) * ldy + j];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const int k = NB * b + c;
        const float4 l0 = ld4(&L[k * ld + NB * g]);
        const float4 l1 = ld4(&L[k * ld + NB * g + 4]);
        v[0] -= l0.x * y[c]; v[1] -= l0.y * y[c];
        v[2] -= l0.z * y[c]; v[3] -= l0.w * y[c];
        v[4] -= l1.x * y[c]; v[5] -= l1.y * y[c];
        v[6] -= l1.z * y[c]; v[7] -= l1.w * y[c];
      }
    }
  }
  __syncthreads();
}

// Shared memory of one CTA, in floats, for n (see the layout in the kernel).
__host__ __device__ __forceinline__ int b2_floats(int n) {
  const int DP = round4(NX + n), hs = (n + CL - 1) / CL;
  return max(n * DP, hs * (DP + mat_ld(n)));
}

__host__ __device__ int smem_floats(int n) {
  const int m = round8(n), DP = round4(NX + n);
  const int ld = mat_ld(n), cw = block_width(DP);
  return 2 * m * ld + m * cw + n * cw + n * DP + b2_floats(n) + 3 * cw * DP +
         2 * m + NW + 8;             // + the flag and three mbarriers
}

// dst[0 .. cols) = src[0 .. cols) for a row of shared memory from device
// memory, by the 32 lanes of a warp: cp.async copies of 4 bytes, in flight
// together until the caller's __pipeline_wait_prior(0).
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int cols, int lane) {
  for (int k = lane; k < cols; k += 32)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
}

// The tensor memory accelerator's bulk copies (cp.async.bulk): one thread
// asks for a whole run of bytes (16-byte aligned, a multiple of 16) to be
// copied from device memory into this CTA's shared memory, and the copy
// reports its bytes to an mbarrier, on which the threads wait.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int floats, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src),
      "r"(floats * 4), "r"(smem_addr(bar))
      : "memory");
}

// A bulk copy from this CTA's shared memory into CTA `rank`'s at the same
// offset, reporting to that CTA's mbarrier `bar` (the writers of `src` have
// run fence.proxy.async and a barrier first).
__device__ __forceinline__ void bulk_push(float* dst, const float* src,
                                          int floats, int rank,
                                          uint64_t* bar) {
  uint32_t a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(a), "r"(smem_addr(src)), "r"(floats * 4),
      "r"(b)
      : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The same copy into every CTA of the cluster, each reporting to its own
// mbarrier at the same offset.
__device__ __forceinline__ void bulk_copy_all(float* dst, const float* src,
                                              int floats, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(floats * 4), "r"(smem_addr(bar)),
      "h"(static_cast<uint16_t>((1 << CL) - 1))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile("{\n\t.reg .pred p;\n\tWAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n\t"
               "@!p bra WAIT;\n\t}" ::"r"(smem_addr(bar)) : "memory");
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
ekf_tail_kernel(const float* __restrict__ C, const float* __restrict__ b,
                const float* __restrict__ P, const float* __restrict__ sig2,
                float* __restrict__ dx, float* __restrict__ Pn,
                bool* __restrict__ fallback, int n) {
  extern __shared__ __align__(16) float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int D = NX + n, m = round8(n), DP = round4(D);
  const int LD = mat_ld(n), cw = block_width(DP), hs = (n + CL - 1) / CL;
  const int c0 = r * cw, wr = max(min(cw, DP - c0), 0);   // own D columns
  const int i0 = r * hs, hr = max(min(hs, n - i0), 0);    // own rows of S
  // K^T and E^T[24:, :] whole are held by column block: block q (columns
  // q cw .., width wr_q) at n q cw, row stride wr_q, as CTA q holds its own
  float* Lc = sh;                    // m x LD: C + ridge, then Lc
  float* Sf = Lc + m * LD;           // m x LD: S, then Ls
  float* Qc = Sf + m * LD;           // m x wr: own columns of Q, then K^T
  float* Gc = Qc + m * cw;           // n x wr: own columns of E^T[24:, :]
  float* B1 = Gc + n * cw;           // n x DP: P[24:, :], then K^T whole
  float* B2 = B1 + n * DP;           // n x DP: own rows of Lc^T P22 and of
                                     // S, then E^T[24:, :] whole
  float* APr = B2 + b2_floats(n);    // cw x DP: own rows of P, then E P
  float* Xr = APr + cw * DP;         // cw x DP: own rows of X
  float* XT = Xr + cw * DP;          // DP x cw: X^T's entries of own rows
  float* rn = XT + cw * DP;          // m: Lc^-1 b
  float* rd = rn + m;                // m: reciprocal pivots of Ls
  float* red = rd + m;               // NW reduction slots
  int* flag = reinterpret_cast<int*>(red + NW);

  const int e = blockIdx.x / CL, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* Ce = C + (size_t)e * n * n;
  const float* be = b + (size_t)e * n;
  const float* Pe = P + (size_t)e * D * D;
  float* dxe = dx + (size_t)e * D;
  float* Pne = Pn + (size_t)e * D * D;
  const float s2 = sig2[e];
  // bulk copies need 16-byte alignment and sizes: n % 4 == 0 (then D too)
  const bool bulk = n % 4 == 0 && ((reinterpret_cast<size_t>(C) |
                                     reinterpret_cast<size_t>(b) |
                                     reinterpret_cast<size_t>(P)) & 15) == 0;
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + NW + 2);   // the load
  uint64_t* barS = bar + 1;                                     // S
  uint64_t* barK = bar + 2;                                     // K^T, E^T

  // phase: load.  P[24:, :], C and b by the tensor memory accelerator: CTA
  // r asks for rows r, r + 8, ... of each, copied into every CTA of the
  // cluster at once (multicast), so each SM reads an eighth of them; its
  // own rows of P by a bulk copy of its own.  Where sizes or alignment
  // forbid bulk copies, cp.async of 4 bytes a thread.  The paddings:
  // zero, identity blocks for the factorizations.  The cluster barrier
  // first: a multicast, and later DSMEM writes, need every CTA started and
  // its mbarrier armed.
  const int rows = max(min(wr, D - c0), 0);      // own rows of P
  if (tid == 0) {
    mbar_init(barS);                 // S: n rows of every CTA's
    mbar_expect(barS, 4u * n * LD);
    mbar_init(barK);                 // K^T and E^T: n x DP each
    mbar_expect(barK, 8u * n * DP);
    if (bulk) {
      mbar_init(bar);
      mbar_expect(bar, 4u * (n * D + rows * D + n * n + n));
    }
  }
  cluster.sync();
  if (bulk) {
    if (warp == 0) {
      if (lane == 0) {
        if (rows) bulk_copy(APr, Pe + c0 * D, rows * D, bar);
        if (r == 0) bulk_copy_all(rn, be, n, bar);
      }
      for (int i = r + CL * lane; i < n; i += CL * 32) {
        bulk_copy_all(&B1[i * DP], Pe + (NX + i) * D, D, bar);
        bulk_copy_all(&Lc[i * LD], Ce + i * n, n, bar);
      }
    }
  } else {
    for (int i = warp; i < n; i += NW)
      copy_row(&B1[i * DP], &Pe[(NX + i) * D], D, lane);
    for (int a = warp; a < rows; a += NW)
      copy_row(&APr[a * DP], &Pe[(c0 + a) * D], D, lane);
    for (int i = warp; i < n; i += NW)
      copy_row(&Lc[i * LD], &Ce[i * n], n, lane);
    for (int i = tid; i < n; i += NT)
      __pipeline_memcpy_async(&rn[i], &be[i], sizeof(float));
    for (int i = warp; i < n; i += NW)
      for (int k = D + lane; k < DP; k += 32) B1[i * DP + k] = 0.f;
    for (int a = warp; a < rows; a += NW)
      for (int k = D + lane; k < DP; k += 32) APr[a * DP + k] = 0.f;
  }
  for (int idx = rows * DP + tid; idx < cw * DP; idx += NT) APr[idx] = 0.f;
  for (int i = warp; i < m; i += NW)
    for (int k = lane; k < LD; k += 32) {
      if (i >= n) Lc[i * LD + k] = Sf[i * LD + k] = i == k ? 1.f : 0.f;
      else if (k >= n) Lc[i * LD + k] = 0.f;
    }
  for (int i = n + tid; i < m; i += NT) rn[i] = 0.f;
  for (int idx = tid; idx < (m - n) * wr; idx += NT) Qc[n * wr + idx] = 0.f;
  if (bulk) {
    mbar_wait(bar);
  } else {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  float tr[1] = {0.f};
  for (int i = tid; i < n; i += NT) tr[0] += Lc[i * LD + i];
  rvio::block_sums<1, NT>(tr, red);
  const float scale = fmaxf(tr[0], 1.f);
  for (int i = tid; i < n; i += NT) Lc[i * LD + i] += INFO_RIDGE * scale;
  __syncthreads();

  // phase: factor C
  bool ok = cholesky_blocked(Lc, m, LD, flag);
  const bool fb = !ok;
  if (!ok) {
    load_ridged(Lc, LD, Ce, n, (float)n * FLT_EPSILON * scale);
    ok = cholesky_blocked(Lc, m, LD, flag);
  }
  if (r == 0 && tid == 0) fallback[e] = fb;
  const float nan = __int_as_float(0x7fc00000);
  if (!ok) {                         // every CTA alike; no DSMEM access yet
    for (int idx = tid; idx < wr * D; idx += NT) {
      const int a = idx / D, k = idx - a * D;
      if (c0 + a < D) Pne[(c0 + a) * D + k] = nan;
    }
    for (int a = tid; a < wr; a += NT)
      if (c0 + a < D) dxe[c0 + a] = nan;
    return;
  }

  // phase: rn, S and Q columns.  Warp 0: rn = Lc^-1 b, blocked as the
  // solves for K^T are (lane g holds rows 8 g .. 8 g + 7).  The other
  // warps: U = Lc[:, own]^T P22 and the own rows of S = U Lc, whole (S is
  // symmetrized where it arrives, which reads the upper triangle), which go
  // to every CTA's Sf by bulk copies; and Q = Lc^T P[24:, own].
  float* U = B2;                     // hr x DP
  float* Ss = B2 + hs * DP;          // hr x LD
  if (tid < 32) {
    const int g = lane, nblk = m / NB;
    float v[NB], xp[NB];
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int i = NB * g + a;
      v[a] = g < nblk ? rn[i] : 0.f;
      xp[a] = g < nblk ? 1.f / Lc[i * LD + i] : 0.f;
    }
    for (int bk = 0; bk < nblk; ++bk) {
      if (g == bk) {
        float lb[NB][NB];
#pragma unroll
        for (int q = 1; q < NB; ++q)
#pragma unroll
          for (int c = 0; c < q; ++c) lb[q][c] = Lc[(NB * bk + q) * LD + NB * bk + c];
#pragma unroll
        for (int a = 0; a < NB; ++a) {
          v[a] *= xp[a];
#pragma unroll
          for (int c = a + 1; c < NB; ++c) v[c] -= lb[c][a] * v[a];
        }
#pragma unroll
        for (int a = 0; a < NB; ++a) rn[NB * bk + a] = v[a];
      }
      __syncwarp();
      if (g > bk && g < nblk) {
        const float4 y0 = ld4(&rn[NB * bk]), y1 = ld4(&rn[NB * bk + 4]);
#pragma unroll
        for (int a = 0; a < NB; ++a) {
          const int i = NB * g + a;
          v[a] -= dot8(ld4(&Lc[i * LD + NB * bk]),
                       ld4(&Lc[i * LD + NB * bk + 4]), y0, y1);
        }
      }
      __syncwarp();
    }
  } else {
    const int t0 = tid - 32, nt = NT - 32;
    const int tn4 = round4(n) / 4, tc4 = wr / 4;
    for (int t = t0; t < hr * tn4; t += nt) {
      const int a = t / tn4, j = 4 * (t - a * tn4), i = i0 + a;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l = i; l < n; ++l)
        fma4(acc, Lc[l * LD + i], ld4(&B1[l * DP + NX + j]));
      st4(&U[a * DP + j], acc);
    }
    asm volatile("bar.sync 1, %0;" ::"r"(NT - 32));
    for (int t = t0; t < hr * tn4 + n * tc4; t += nt) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < hr * tn4) {
        const int a = t / tn4, k = 4 * (t - a * tn4);
        for (int j = k; j < n; ++j)
          fma4(acc, U[a * DP + j], ld4(&Lc[j * LD + k]));
        st4(&Ss[a * LD + k], acc);
      } else {
        const int u = t - hr * tn4, i = u / tc4, k = c0 + 4 * (u - i * tc4);
        for (int l = i; l < n; ++l)
          fma4(acc, Lc[l * LD + i], ld4(&B1[l * DP + k]));
        st4(&Qc[i * wr + k - c0], acc);
      }
    }
    fence_async();
    asm volatile("bar.sync 1, %0;" ::"r"(NT - 32));
    if (tid == 32 && hr)
      for (int rk = 0; rk < CL; ++rk)
        bulk_push(&Sf[i0 * LD], Ss, hr * LD, rk, barS);
  }

  // phase: S arrives.  Every CTA's rows of S, counted by barS; then
  // (S + S^T) / 2 on the lower triangle (the factorization reads nothing
  // else; the writes touch no entry the reads do) and + sig2 I, as the
  // chain does, in every CTA alike.
  mbar_wait(barS);
  for (int idx = tid; idx < n * n; idx += NT) {
    const int i = idx / n, k = idx - i * n;
    if (k < i) Sf[i * LD + k] = 0.5f * (Sf[i * LD + k] + Sf[k * LD + i]);
  }
  for (int i = tid; i < n; i += NT) Sf[i * LD + i] += s2;
  __syncthreads();

  // phase: factor S
  ok = cholesky_blocked(Sf, m, LD, flag);
  if (!ok) {                         // every CTA alike; no DSMEM access left
    for (int idx = tid; idx < wr * D; idx += NT) {
      const int a = idx / D, k = idx - a * D;
      if (c0 + a < D) Pne[(c0 + a) * D + k] = nan;
    }
    for (int a = tid; a < wr; a += NT)
      if (c0 + a < D) dxe[c0 + a] = nan;
    return;
  }

  // phase: solves.  K^T = Ls^-T Ls^-1 Q on the own columns.
  for (int i = tid; i < m; i += NT) rd[i] = 1.f / Sf[i * LD + i];
  __syncthreads();
  solve_blocked(Sf, m, LD, Qc, wr, wr, rd);

  // phase: dx and E^T.  dx = K rn on the own columns; the own columns of
  // E^T's clone rows, I - Lc K^T (E = I - K Hn, whose live columns are
  // I - K Lc^T): E's diagonal coefficient 1 - g of a clone row is taken
  // here, before any product.
  {
    const int tc4 = wr / 4;
    for (int t = tid; t < wr + n * tc4; t += NT) {
      if (t < wr) {
        if (c0 + t < D) {
          float s = 0.f;
          for (int i = 0; i < n; ++i) s += Qc[i * wr + t] * rn[i];
          dxe[c0 + t] = s;
        }
        continue;
      }
      const int u = t - wr, i = u / tc4, k = 4 * (u - i * tc4);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l = 0; l <= i; ++l) fma4(acc, Lc[i * LD + l], ld4(&Qc[l * wr + k]));
      float4 e = make_float4(-acc.x, -acc.y, -acc.z, -acc.w);
      const int dg = NX + i - c0 - k;          // the component on E's diagonal
      if (dg == 0) e.x += 1.f;
      else if (dg == 1) e.y += 1.f;
      else if (dg == 2) e.z += 1.f;
      else if (dg == 3) e.w += 1.f;
      st4(&Gc[i * wr + k], e);
    }
  }
  __syncthreads();

  // phase: E P.  Own rows: (E P)[c, :] = [c < 24] P[c, :] +
  // E[c, 24:] P[24:, :], two rows by four columns a thread (row a of E is
  // column a of E^T); a clone row's sum starts at 0, its diagonal
  // coefficient 1 - g inside it.  c0 and a are even and NX is, so both
  // rows of a pair lie on one side of 24.
  {
    const int TD = DP / 4;
    for (int t = tid; t < (wr / 2) * TD; t += NT) {
      const int a = 2 * (t / TD), k = 4 * (t % TD);
      const bool cl = c0 + a >= NX;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x0 = cl ? z : ld4(&APr[a * DP + k]);
      float4 x1 = cl ? z : ld4(&APr[(a + 1) * DP + k]);
      for (int l = 0; l < n; ++l) {
        const float4 p = ld4(&B1[l * DP + k]);
        fma4(x0, Gc[l * wr + a], p);
        fma4(x1, Gc[l * wr + a + 1], p);
      }
      st4(&APr[a * DP + k], x0);
      st4(&APr[(a + 1) * DP + k], x1);
    }
  }
  fence_async();
  // phase: cluster barrier 1
  cluster.sync();

  // phase: K^T and E^T arrive.  Each CTA sends its columns of both to
  // every CTA (bulk copies; their P[24:, :] and the rest of B2 are done).
  if (tid == 0 && wr)
    for (int rk = 0; rk < CL; ++rk) {
      bulk_push(&B1[n * c0], Qc, n * wr, rk, barK);
      bulk_push(&B2[n * c0], Gc, n * wr, rk, barK);
    }
  mbar_wait(barK);

  // phase: X.  Own rows: X = (E P) E^T + sig2 K K^T, that is
  // X[c, k] = [k < 24] (E P)[c, k] + (E P)[c, 24:] E^T[24:, k] +
  // sig2 K[c, :] K[k, :] (E's first 24 columns are the identity's), two rows
  // by four columns a thread (row a of K is column a of K^T); each finished
  // tile also goes to the CTA that owns its columns' rows of P_new, as
  // entries of X^T.
  {
    const int TD = DP / 4;
    for (int t = tid; t < (wr / 2) * TD; t += NT) {
      const int a = 2 * (t / TD), k = 4 * (t % TD);
      const int q = k / cw, wq = min(cw, DP - q * cw);
      const float* kt = B1 + n * q * cw + k - q * cw;   // K^T[0][k], stride wq
      const float* et = B2 + n * q * cw + k - q * cw;   // E^T[24][k]
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x0 = k < NX ? ld4(&APr[a * DP + k]) : z;
      float4 x1 = k < NX ? ld4(&APr[(a + 1) * DP + k]) : z;
      float4 k0 = z, k1 = z;
      for (int l = 0; l < n; ++l) {
        const float4 g = ld4(et + l * wq);
        const float4 q4 = ld4(kt + l * wq);
        fma4(x0, APr[a * DP + NX + l], g);
        fma4(x1, APr[(a + 1) * DP + NX + l], g);
        fma4(k0, Qc[l * wr + a], q4);
        fma4(k1, Qc[l * wr + a + 1], q4);
      }
      fma4(x0, s2, k0);
      fma4(x1, s2, k1);
      st4(&Xr[a * DP + k], x0);
      st4(&Xr[(a + 1) * DP + k], x1);
      // X[c0 + a][k ..] is X^T[k ..][c0 + a]: row c0 + a of XT of the CTA
      // q whose own rows of P_new are k ..
      float* xt = cluster.map_shared_rank(XT, q);
      st4(xt + (c0 + a) * cw + k - q * cw, x0);
      st4(xt + (c0 + a + 1) * cw + k - q * cw, x1);
    }
  }
  // phase: cluster barrier 2
  cluster.sync();

  // phase: store.  P_new = (X + X^T) / 2 on the own rows, a row a warp.
  for (int a = warp; a < wr; a += NW) {
    const int c = c0 + a;
    if (c < D)
      for (int k = lane; k < D; k += 32)
        Pne[c * D + k] = 0.5f * (Xr[a * DP + k] + XT[k * cw + a]);
  }
}

// Sets the kernel's dynamic shared memory limit for size n on the current
// device, once per device and size, outside any graph capture (the first
// launch of a size runs eagerly).  Where setting it fails the error is
// taken off the runtime's last-error state, or the next launch's check
// would report it again.
cudaError_t configure(int n, size_t* smem_out) {
  static size_t configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(n));
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(ekf_tail_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    configured[dev] = smem;
  }
  *smem_out = smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int rvio_ekf_tail(const float* C, const float* b, const float* P,
                  const float* sig2, float* dx, float* Pn, bool* fallback,
                  int B, int n, cudaStream_t stream) {
  if (n < 1 || n > NMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  size_t smem = 0;
  const cudaError_t e = configure(n, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ekf_tail_kernel<<<B * CL, NT, smem, stream>>>(C, b, P, sig2, dx, Pn,
                                                fallback, n);
  return static_cast<int>(cudaGetLastError());
}

// How many of the kernel's clusters of CL CTAs (at size n, B systems) can
// be resident on the current device at once (cudaOccupancyMaxActiveClusters):
// B systems above it run in more than one wave.  Launches nothing.
int rvio_ekf_tail_max_clusters(int* out, int B, int n, cudaStream_t) {
  if (n < 1 || n > NMAX || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t e = configure(n, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * CL);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem;
  e = cudaOccupancyMaxActiveClusters(out, ekf_tail_kernel, &config);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
