// K5's wide route: the MSCKF update's dense tail for windows whose n
// (6 x the clones) is past what csrc/ekf_tail.cu keeps in one CTA's shared
// memory (n > 92: windows of 16 or more clones).
//
// Replaces rvio_tpu/ops/ekf_tail.py (ekf_tail_pallas / _ekf_tail_kernel),
// which takes any n.  It computes what csrc/ekf_tail.cu computes, the
// port's unfused chain (ops/ekf_tail.py cholesky_tail), in the chain's own
// order of operations:
//
//   1. C + 1e-8 max(tr C, 1) I, lower Cholesky Lc; where a pivot is <= 0 or
//      not finite, C + n eps_f32 max(tr C, 1) I instead and `fallback` set;
//      if that fails too, dx and P_new are NaN;
//   2. rn = Lc^-1 b, Hn = [0 | Lc^T];
//   3. P Hn^T = P[:, 24:] Lc;
//   4. S = Lc^T (P Hn^T)[24:, :] + sig2 I, (S + S^T) / 2 and its Cholesky
//      Ls, NaN results where it fails;
//   5. W = P Hn^T Ls^-T, K = W Ls^-1, dx = K rn;
//   6. E = I - K Hn (its live columns I - K Lc^T, formed before any
//      product), X = (E P) E^T + sig2 K K^T, P_new = (X + X^T) / 2.
//
// Bound on the H100: at n = 96 (D = 120) about 11 MFLOP and 0.17 us at
// 67 TFLOP/s, at n = 384 (D = 408) 573 MFLOP and 8.6 us
// (ops/checks.ekf_tail_flops); the bytes are smaller still.  What holds a
// system back is the chain of dependent steps of the two factorizations
// and the two triangular solves; the products are ordinary FP32 work.
//
// Design: the work goes where what bounds it is served, in eight launches
// in stream order (one `ekf_tail` call; no host sync, every intermediate
// in the workspace the wrapper allocates, `Layout`).
// - The two factorizations are chains: each runs in one cluster of CL = 8
//   CTAs a system (`factor_kernel`), with the working matrix spread over
//   the CTAs' shared memory (row i in CTA i mod 8: about 76 KB a CTA at
//   n = 384) in place of L2.  Panels of PW = 32 columns, one cluster
//   barrier a panel (12 panels at n = 384): warp 0 of every CTA reads the
//   32 x 32 diagonal block from its owners (distributed shared memory) and
//   factors it alike in registers, a row a lane (the same instructions on
//   the same data: the same bits and the same verdict on the pivots
//   everywhere); each CTA solves its own rows of the panel against it, a
//   row a thread, and sends them to the other CTAs' copies of the panel by
//   bulk copies counted on their mbarriers; then the trailing update of
//   its own rows from its local panel, a row and eight columns a task, the
//   row in registers.  C's factorization carries b^T as one more row below
//   C, which ends as rn^T = b^T Lc^-T; S's rows are symmetrized across the
//   cluster after they load.  Past n = 512 the rows do not fit shared
//   memory: the same kernel keeps them and the panel in the workspace
//   (read through L2) with a second cluster barrier a panel, slower but
//   alike.
// - The two solves are row-independent: W and K for a block of 8 of the
//   D rows a CTA (`solve_kernel`, a grid over the card), its rows held
//   transposed in shared memory; the solves go by blocks of 32 columns,
//   each the product update of the block from the finished columns (Ls
//   streamed through shared memory by cp.async) and then the block's
//   substitution, 8 lanes a row and a shuffle a step; dx = K rn at the
//   end.
// - The products (P Hn^T, S, E, E P) are tiles of 32 x 32 outputs, a CTA a
//   tile and a system (`product_kernel`), both operands staged 16 deep
//   through shared memory by cp.async (eight slices in a ring), 4 x 2
//   outputs a thread; a triangular operand starts or ends the depth at the
//   tile.
//   X = (E P) E^T + sig2 K K^T and P_new = (X + X^T) / 2 are one launch
//   (`joseph_kernel`): a CTA takes a pair of tiles (I, J), I <= J, and
//   forms X's tile (I, J) and the transpose of its tile (J, I) from the
//   same staged slices, so it stores P_new's two tiles, bitwise symmetric.
// All sums are f32 on the FP32 pipes (the port keeps TF32 off).  The long
// ones are two-level: a product's or a solve update's terms 16 at a time
// into a partial, added to the total (the factorizations': a panel's 32),
// so the rounding grows with about n / 16 + 16 terms, not n.  At n = 384
// an f32 product summed term by term carries dx about 6e-5 of its largest
// entry from f64, about 1.5e-5 in 16-term blocks (an emulation on the
// CPU; the unfused chain's own gap is about 6e-5).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;              // CTAs of a factorization's cluster
constexpr int FT = 256;            // threads of a factorization CTA
constexpr int PW = 32;             // panel width (a warp's lanes)
constexpr int PLD = PW + 4;        // row stride of a panel copy
constexpr int GW = 8;              // columns of a trailing-update task
constexpr int SR = 8;              // rows of a solve CTA
constexpr int ST = 128;            // threads of a solve CTA
constexpr int SCH = 256;           // depth of one staged chunk of Ls
constexpr int SLD = PW + 4;        // row stride of a staged chunk
constexpr int TM = 32;             // product tile: TM x TM outputs
constexpr int TK = 16;             // depth of a staged slice
constexpr int TLD = TM + 4;        // row stride of a staged slice
constexpr int PT = 128;            // threads of a product CTA
constexpr int PNS = 8;             // slices in a ring: a product's stages
constexpr int JNS = 5;             // ... and the Joseph form's (dynamic)
constexpr float INFO_RIDGE = 1e-8f;
constexpr int NX = 24;             // error-state rows before the clone block
constexpr int SMEM_MAX = 232448;   // shared memory a CTA may opt into
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round32(int x) {
  return (x + 31) & ~31;
}

__host__ __device__ __forceinline__ size_t up4(size_t x) {
  return (x + 3) & ~static_cast<size_t>(3);
}

// The workspace of one system, in floats; every matrix row-major, every
// region 16-byte aligned.  m = round32(n): both factors are padded to m
// with an identity block.
struct Layout {
  int n, D, m;
  size_t lc;        // (m + 1) x m: Lc, then rn^T as row m
  size_t s;         // m x m: S (its n x n block)
  size_t ls;        // m x m: Ls
  size_t pht;       // D x m: P Hn^T (n columns)
  size_t k;         // D x m: K (zero past column n)
  size_t ec;        // D x m: E[:, 24:] (n columns)
  size_t y;         // D x D: E P
  size_t pan;       // (m + 1) x PLD: the panel, where the rows spill
  size_t wt;        // ceil(D / SR) SR x m: the solves' rows, where they
                    // spill (past n of about 2600)
  size_t flags;     // C factored, S factored (ints)
  size_t total;
  __host__ __device__ explicit Layout(int n_)
      : n(n_), D(NX + n_), m(round32(n_)) {
    const size_t mm = static_cast<size_t>(m) * m;
    const size_t Dm = static_cast<size_t>(D) * m;
    lc = 0;
    s = up4(lc + mm + m);
    ls = up4(s + mm);
    pht = up4(ls + mm);
    k = up4(pht + Dm);
    ec = up4(k + Dm);
    y = up4(ec + Dm);
    pan = up4(y + static_cast<size_t>(D) * D);
    wt = up4(pan + static_cast<size_t>(m + 1) * PLD);
    flags = up4(wt + static_cast<size_t>((D + SR - 1) / SR) * SR * m);
    total = up4(flags + 4);
  }
};

// --- the factorizations: one cluster a system ---------------------------------

// Floats of shared memory a factorization CTA takes where its rows stay in
// shared memory (rows: m + 1 for C's, with b^T; m for S's): its rows
// (every CL-th, row stride m + 4), its copy of the panel (CL regions of
// ceil(rows / CL) rows of PW, one a CTA), the panel's mbarrier, the
// diagonal block, its reciprocal pivots, the reduction slots and the flag.
__host__ __device__ __forceinline__ int factor_floats(int m, int rows,
                                                      bool spill) {
  const int fixed = 4 + PW * (PW + 1) + PW + FT / 32 + 4;
  if (spill) return fixed;
  const int cap = (rows + CL - 1) / CL;
  return cap * (m + 4) + CL * cap * PW + fixed;
}

// The panel rows that CTA q solves at panel start s: its rows i >= s.
__device__ __forceinline__ int panel_rows(int q, int s, int rows) {
  return rows > s + q ? (rows - s - q + CL - 1) / CL : 0;
}

// A bulk copy (the tensor memory accelerator) of `bytes` from this CTA's
// shared memory into CTA `rank`'s at the same offset, reporting them to
// that CTA's mbarrier `bar`.
__device__ __forceinline__ void bulk_push(const float* src, int bytes,
                                          int rank, uint64_t* bar) {
  const uint32_t s = rvio::smem_addr(src);
  uint32_t a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(s), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(rvio::smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(a), "r"(s), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(rvio::smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait_parity(uint64_t* bar,
                                                 uint32_t parity) {
  asm volatile("{\n\t.reg .pred p;\n\tWAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
               "@!p bra WAIT;\n\t}" ::"r"(rvio::smem_addr(bar)), "r"(parity)
               : "memory");
}

__host__ __device__ __forceinline__ bool factor_spills(int m) {
  return 4 * factor_floats(m, m + 1, false) > SMEM_MAX;
}

template <bool G>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (G) return __ldcg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}

template <bool G>
__device__ __forceinline__ void st4(float* p, float4 v) {
  if constexpr (G) __stcg(reinterpret_cast<float4*>(p), v);
  else *reinterpret_cast<float4*>(p) = v;
}

// The 32 x 32 diagonal block, row `lane` in a[0 .. 31] of each lane (the
// entries c <= lane are read), factored across the warp in registers:
// afterwards a[c] = L[lane][c] for c <= lane, and rs[j] = 1 / L[j][j] (by
// rsqrtf, the TPU kernel's pivots) for the row solves.  Returns whether
// every pivot was > 0 and finite, alike in every lane.
__device__ __forceinline__ bool factor_diag(float (&a)[PW], float* rs) {
  const int lane = threadIdx.x & 31;
  bool good = true;
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    const float d = __shfl_sync(FULL, a[j], j);
    good = good && d > 0.f && d < INFINITY;
    const float r = rsqrtf(d);
    if (lane == j) rs[j] = r;
    a[j] = lane == j ? d * r : a[j] * r;
#pragma unroll
    for (int c = j + 1; c < PW; ++c) {
      const float lcj = __shfl_sync(FULL, a[j], c);
      if (lane >= c) a[c] -= a[j] * lcj;
    }
  }
  return good;
}

// Where the working rows are: in shared memory (row i in CTA i mod CL at
// local index i / CL, row stride m + 4) or, spilled, in the output matrix
// itself (row i at out + i m, read through L2).
template <bool SPILL>
struct Rows {
  float* base;
  int ld;
  __device__ __forceinline__ float* row(int i) const {
    return SPILL ? base + static_cast<size_t>(i) * ld
                 : base + static_cast<size_t>(i / CL) * ld;
  }
};

// The lower Cholesky factor of the working matrix (m x m, the rows past m
// solved along: row m of C's is b^T, which ends as rn^T), in panels of PW
// columns.  Returns false, alike in every CTA, where a pivot is <= 0 or
// not finite, after a cluster barrier (so the caller may reload).  In
// shared memory each CTA writes its solved panel rows into its region of
// its panel copy and sends the region to the other CTAs by bulk copies,
// which count their bytes on the receivers' mbarrier `bar` (phase parity
// `ph`); spilled, the rows go to one panel in the workspace and a cluster
// barrier follows.
template <bool SPILL>
__device__ bool factor_panels(const Rows<SPILL>& R, float* pan, int m,
                              int rows, float* Ld, float* rs, int* flag,
                              uint64_t* bar, uint32_t& ph) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = (rows + CL - 1) / CL;        // rows of a panel region
  for (int p = 0; p < m; p += PW) {
    // (a) the previous trailing update (or the load) is done everywhere
    cluster.sync();
    // phase: factor barrier a
    // (b) the diagonal block, from its rows' owners, factored alike by
    // warp 0 of every CTA
    if (warp == 0) {
      const int i = p + lane;
      const float* src;
      if constexpr (SPILL) src = R.row(i) + p;
      else src = cluster.map_shared_rank(R.base, i % CL) +
                 static_cast<size_t>(i / CL) * R.ld + p;
      float a[PW];
#pragma unroll
      for (int c = 0; c < PW; c += 4) {
        const float4 v = ld4<SPILL>(src + c);
        a[c] = v.x; a[c + 1] = v.y; a[c + 2] = v.z; a[c + 3] = v.w;
      }
      const bool good = factor_diag(a, rs);
#pragma unroll
      for (int c = 0; c < PW; ++c) Ld[lane * (PW + 1) + c] = c <= lane ? a[c] : 0.f;
      if (lane == 0) *flag = good;
    }
    __syncthreads();
    // phase: factor diagonal block
    if (!*flag) {
      cluster.sync();
      return false;
    }
    // (c) the own rows below the block, a row a thread: x L^T = a, then
    // into this CTA's region of the panel (or the one spilled panel)
    const int s = p + PW;
    if (!SPILL && tid == 0) {        // the bytes the other CTAs will send
      uint32_t bytes = 0;
      for (int q = 0; q < CL; ++q)
        if (q != r) bytes += 4u * PW * panel_rows(q, s, rows);
      mbar_arrive_expect(bar, bytes);
    }
    for (int i = s + r + CL * tid; i < rows; i += CL * FT) {
      float* row = R.row(i) + p;
      float x[PW];
#pragma unroll
      for (int c = 0; c < PW; c += 4) {
        const float4 v = ld4<SPILL>(row + c);
        x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        x[c] *= rs[c];
#pragma unroll
        for (int q = c + 1; q < PW; ++q) x[q] -= x[c] * Ld[q * (PW + 1) + c];
      }
#pragma unroll
      for (int c = 0; c < PW; c += 4)
        st4<SPILL>(row + c, make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]));
      float* dst = SPILL ? pan + static_cast<size_t>(i) * PLD
                         : pan + static_cast<size_t>(r * cap + (i - s) / CL) * PW;
#pragma unroll
      for (int c = 0; c < PW; c += 4)
        st4<SPILL>(dst + c, make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]));
    }
    // phase: factor panel rows
    // (d) the panel whole in every CTA: the own region to the others by
    // bulk copies (their writers' stores fenced for the async proxy), the
    // others' regions awaited (or, spilled, a cluster barrier); then the
    // block's owners store its factored rows (read by nobody until the end)
    if constexpr (SPILL) {
      cluster.sync();
    } else {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      const int cnt = panel_rows(r, s, rows);
      if (tid == 0 && cnt)
        for (int q = 0; q < CL; ++q)
          if (q != r)
            bulk_push(pan + static_cast<size_t>(r) * cap * PW, 4 * PW * cnt, q,
                      bar);
      mbar_wait_parity(bar, ph);
      ph ^= 1;
    }
    // phase: factor barrier d
    if (warp == 0 && (p + lane) % CL == r) {
      float* row = R.row(p + lane) + p;
#pragma unroll
      for (int c = 0; c < PW; c += 4)
        st4<SPILL>(row + c, make_float4(Ld[lane * (PW + 1) + c],
                                        Ld[lane * (PW + 1) + c + 1],
                                        Ld[lane * (PW + 1) + c + 2],
                                        Ld[lane * (PW + 1) + c + 3]));
    }
    // (e) the trailing update of the own rows i >= s, columns s .. i (all
    // of them in the row past m), GW columns a task: the own row's panel
    // entries (in registers) and the columns' panel rows (one broadcast
    // read for the lanes, which hold consecutive own rows), a dot product
    // each.  In shared memory a thread keeps one row and takes every
    // (FT / rows)-th of its column groups; spilled, tasks are flat.
    const int i0 = s + r;           // s is a multiple of CL
    const int nr = rows > i0 ? (rows - i0 + CL - 1) / CL : 0;
    auto update = [&](float* row, const float (&li)[PW], int k0) {
      float u[GW];
#pragma unroll
      for (int q = 0; q < GW; ++q) {
        // row k0 + q (k0 - s a multiple of CL: region q)
        const float* pk =
            SPILL ? pan + static_cast<size_t>(k0 + q) * PLD
                  : pan + static_cast<size_t>(q * cap + (k0 - s) / CL) * PW;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < PW; c += 4) {
          const float4 v = ld4<SPILL>(pk + c);
          acc += li[c] * v.x + li[c + 1] * v.y + li[c + 2] * v.z +
                 li[c + 3] * v.w;
        }
        u[q] = acc;
      }
      float4 v0 = ld4<SPILL>(row + k0), v1 = ld4<SPILL>(row + k0 + 4);
      v0.x -= u[0]; v0.y -= u[1]; v0.z -= u[2]; v0.w -= u[3];
      v1.x -= u[4]; v1.y -= u[5]; v1.z -= u[6]; v1.w -= u[7];
      st4<SPILL>(row + k0, v0);
      st4<SPILL>(row + k0 + 4, v1);
    };
    auto own_row = [&](float* row, float (&li)[PW]) {
#pragma unroll
      for (int c = 0; c < PW; c += 4) {
        const float4 v = ld4<SPILL>(row + p + c);
        li[c] = v.x; li[c + 1] = v.y; li[c + 2] = v.z; li[c + 3] = v.w;
      }
    };
    if constexpr (!SPILL) {          // here nr <= ceil(513 / CL) < FT
      const int tpr = nr ? FT / nr : 0;
      if (tid < nr * tpr) {
        const int j = tid % nr, i = i0 + CL * j;
        float* row = R.row(i);
        float li[PW];
        own_row(row, li);
        const int ng = i < m ? (i - s) / GW + 1 : (m - s) / GW;
        for (int g = tid / nr; g < ng; g += tpr) update(row, li, s + GW * g);
      }
    } else {
      const int ng = (m - s) / GW;
      for (int t = tid; t < nr * ng; t += FT) {
        const int g = t / nr, i = i0 + CL * (t - g * nr), k0 = s + GW * g;
        if (i < m && k0 > i) continue;             // the upper triangle
        float* row = R.row(i);
        float li[PW];
        own_row(row, li);
        update(row, li, k0);
      }
    }
    // phase: factor trailing update
  }
  __syncthreads();
  return true;
}

// One cluster a system: C's factor (is_s = 0: C + ridge with b^T below it,
// the wider ridge where the first fails; Lc and rn^T into the workspace,
// `fallback` and flags[0]) or S's (is_s = 1: (S + S^T) / 2 from the
// workspace; Ls and flags[1]; nothing where C's failed).
template <bool SPILL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(FT, 1)
factor_kernel(const float* __restrict__ C, const float* __restrict__ b,
              float* __restrict__ ws, bool* __restrict__ fallback, int n,
              int is_s) {
  extern __shared__ __align__(16) float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / CL, tid = threadIdx.x;
  const Layout lay(n);
  const int m = lay.m, rows = is_s ? m : m + 1;
  float* W = ws + static_cast<size_t>(e) * lay.total;
  int* flags = reinterpret_cast<int*>(W + lay.flags);
  float* out = W + (is_s ? lay.ls : lay.lc);
  if (is_s && !flags[0]) {             // alike in every CTA: no peer access
    if (r == 0 && tid == 0) flags[1] = 0;
    return;
  }
  const int nown = (rows + CL - 1) / CL;
  Rows<SPILL> R;
  float* pan;
  float* small;
  if constexpr (SPILL) {
    R = {out, m};
    pan = W + lay.pan;
    small = sh;
  } else {
    R = {sh, m + 4};
    pan = sh + static_cast<size_t>(nown) * (m + 4);
    small = pan + static_cast<size_t>(CL) * nown * PW;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(small);   // the panel's
  float* Ld = small + 4;               // PW x (PW + 1)
  float* rs = Ld + PW * (PW + 1);      // PW
  float* red = rs + PW;                // FT / 32
  int* flag = reinterpret_cast<int*>(red + FT / 32);
  if (!SPILL && tid == 0) {            // before the first cluster barrier
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(rvio::smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float* Ce = C + static_cast<size_t>(e) * n * n;
  const float* be = b + static_cast<size_t>(e) * n;
  const float* Se = W + lay.s;

  float scale = 0.f;
  if (!is_s) {                         // every CTA takes the trace alike
    float tr[1] = {0.f};
    for (int i = tid; i < n; i += FT) tr[0] += Ce[static_cast<size_t>(i) * n + i];
    rvio::block_sums<1, FT>(tr, red);
    scale = fmaxf(tr[0], 1.f);
  }
  // the own rows: C + ridge (b^T as row m) or S, padded to m with an
  // identity block (C's upper triangle zero: it is never read; S's whole
  // rows, for the symmetrization below).  LU entries a thread in flight.
  constexpr int LU = 8;
  const int own = rows > r ? (rows - r + CL - 1) / CL : 0;
  auto value = [&](int i, int k, float ridge) {
    if (i >= n) return i < m ? (i == k ? 1.f : 0.f) : (k < n ? be[k] : 0.f);
    if (k >= n) return 0.f;
    if (is_s) {
      if (SPILL && k < i)              // the spilled rows: symmetrized here
        return 0.5f * (Se[static_cast<size_t>(i) * m + k] +
                       Se[static_cast<size_t>(k) * m + i]);
      return Se[static_cast<size_t>(i) * m + k];
    }
    return k > i ? 0.f
                 : Ce[static_cast<size_t>(i) * n + k] + (i == k ? ridge : 0.f);
  };
  auto load = [&](float ridge) {
    for (int base = tid; base < own * m; base += FT * LU) {
      float v[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int idx = base + u * FT, j = idx / m;
        v[u] = idx < own * m ? value(r + CL * j, idx - j * m, ridge) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int idx = base + u * FT, j = idx / m;
        if (idx < own * m) {
          float* p = R.row(r + CL * j) + idx - j * m;
          if constexpr (SPILL) __stcg(p, v[u]);
          else *p = v[u];
        }
      }
    }
  };

  load(is_s ? 0.f : INFO_RIDGE * scale);
  if (!SPILL && is_s) {
    // (S + S^T) / 2 on the own rows' lower triangle: S[k][i] (k < i) from
    // row k's owner, whose upper triangle nobody writes
    cluster.sync();
    const int cnt = own * n;
    constexpr int RU = 2 * LU;
    for (int base = tid; base < cnt; base += FT * RU) {
      float v[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int idx = base + u * FT, j = idx / n, k = idx - j * n;
        const int i = r + CL * j;
        v[u] = idx < cnt && i < n && k < i
                   ? cluster.map_shared_rank(R.base, k % CL)[
                         static_cast<size_t>(k / CL) * R.ld + i]
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int idx = base + u * FT, j = idx / n, k = idx - j * n;
        const int i = r + CL * j;
        if (idx < cnt && i < n && k < i) {
          float* p = R.row(i) + k;
          *p = 0.5f * (*p + v[u]);
        }
      }
    }
  }
  // phase: factor load
  uint32_t ph = 0;
  bool ok = factor_panels<SPILL>(R, pan, m, rows, Ld, rs, flag, bar, ph);
  if (!is_s) {
    const bool fb = !ok;
    if (!ok) {
      load(static_cast<float>(n) * FLT_EPSILON * scale);
      ok = factor_panels<SPILL>(R, pan, m, rows, Ld, rs, flag, bar, ph);
    }
    if (r == 0 && tid == 0) {
      fallback[e] = fb;
      flags[0] = ok;
    }
  } else if (r == 0 && tid == 0) {
    flags[1] = ok;
  }
  if (!ok) return;
  // the factor out, dense with zeros above the diagonal (row m: rn^T)
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = r + CL * warp; i < rows; i += CL * (FT / 32)) {
    const float* row = R.row(i);
    float* dst = out + static_cast<size_t>(i) * m;
    for (int k = lane; k < m; k += 32) {
      if constexpr (SPILL) {
        if (k > i) __stcg(dst + k, 0.f);
      } else {
        dst[k] = k <= i ? row[k] : 0.f;
      }
    }
  }
  // phase: factor store
}

// --- the solves: W = P Hn^T Ls^-T, K = W Ls^-1, dx = K rn ---------------------

// One staged piece of Ls (a unit): of the forward solve's block q, rows
// j0 .. j0 + 31 and columns [c0, c1), stored transposed (Lb[l - c0][j] =
// Ls[j0 + j][l]); of the backward solve's block q, rows [c0, c1) and
// columns j0 .. j0 + 31 (Lb[l - c0][j] = Ls[l][j0 + j]).  A block's pieces
// are SCH deep, aligned to SCH from column 0 (forward) or from j0
// (backward), and ordered so that the one holding the diagonal block
// comes last: its update part first, then the block's substitution.
struct Unit {
  bool fwd, last;
  int q, c0, c1;
};

__device__ Unit unit_at(int u, int m) {
  const int nb = m / PW;
  for (int q = 0; q < nb; ++q) {
    const int j0 = q * PW, k = (j0 + PW + SCH - 1) / SCH;
    if (u < k) return {true, u == k - 1, q, u * SCH, min((u + 1) * SCH, j0 + PW)};
    u -= k;
  }
  for (int q = nb - 1; q >= 0; --q) {
    const int j0 = q * PW, k = (m - j0 + SCH - 1) / SCH;
    if (u < k) {
      const int c = k - 1 - u;                  // from the deepest piece
      return {false, c == 0, q, j0 + c * SCH, min(j0 + (c + 1) * SCH, m)};
    }
    u -= k;
  }
  return {false, false, -1, 0, 0};
}

__host__ __device__ __forceinline__ int solve_units(int m) {
  int u = 0;
  for (int j0 = 0; j0 < m; j0 += PW)
    u += (j0 + PW + SCH - 1) / SCH + (m - j0 + SCH - 1) / SCH;
  return u;
}

// A CTA takes SR of the D rows of one system; its rows live transposed in
// shared memory (Wt[l * SR + r] is row r's column l).  Both solves go by
// blocks of PW columns: each block's update from the finished columns, a
// row and 2 columns a thread, then its substitution against the
// diagonal block, 8 lanes a row.  Ls streams through shared
// memory in units (`Unit`) by cp.async, the next unit in flight while the
// current one is used.
__global__ void __launch_bounds__(ST)
solve_kernel(float* __restrict__ ws, float* __restrict__ dx, int n,
             int wt_global) {
  extern __shared__ __align__(16) float sh[];
  const Layout lay(n);
  const int m = lay.m, D = lay.D;
  const int e = blockIdx.y, d0 = blockIdx.x * SR, tid = threadIdx.x;
  float* W = ws + static_cast<size_t>(e) * lay.total;
  const int* flags = reinterpret_cast<const int*>(W + lay.flags);
  const float* Ls = W + lay.ls;
  const float* PHt = W + lay.pht;
  float* K = W + lay.k;
  float* dxe = dx + static_cast<size_t>(e) * D;
  if (!flags[0] || !flags[1]) {
    if (tid < SR && d0 + tid < D) dxe[d0 + tid] = __int_as_float(0x7fc00000);
    return;
  }
  // m x SR: in shared memory, or past its room in this CTA's own slice
  // of the workspace (no other CTA touches it)
  float* Wt = wt_global ? W + lay.wt + static_cast<size_t>(d0) * m : sh;
  float* Lb[2] = {wt_global ? sh : sh + static_cast<size_t>(m) * SR, nullptr};
  Lb[1] = Lb[0] + SCH * SLD;
  const int lane = tid & 31, warp = tid >> 5;
  auto fetch = [&](int u, float* T) {
    const Unit t = unit_at(u, m);
    const int w = t.c1 - t.c0, j0 = t.q * PW;
    if (t.fwd) {
      for (int j = warp; j < PW; j += ST / 32)
        for (int l = lane; l < w; l += 32)
          __pipeline_memcpy_async(&T[l * SLD + j],
                                  &Ls[static_cast<size_t>(j0 + j) * m + t.c0 + l],
                                  sizeof(float));
    } else {                         // whole rows of 32: 16 bytes a copy
      for (int idx = tid; idx < 8 * w; idx += ST) {
        const int l = idx >> 3, q = 4 * (idx & 7);
        __pipeline_memcpy_async(&T[l * SLD + q],
                                &Ls[static_cast<size_t>(t.c0 + l) * m + j0 + q],
                                4 * sizeof(float));
      }
    }
    __pipeline_commit();
  };
  const int U = solve_units(m);
  fetch(0, Lb[0]);
  for (int idx = tid; idx < SR * m; idx += ST) {
    const int r = idx / m, l = idx - r * m, d = d0 + r;
    Wt[l * SR + r] = d < D && l < n ? PHt[static_cast<size_t>(d) * m + l] : 0.f;
  }
  const int ty = tid / 16, tx = tid % 16;          // row ty, cols 2 tx ..
  float acc[2] = {};
  for (int u = 0; u < U; ++u) {
    if (u + 1 < U) {
      fetch(u + 1, Lb[(u + 1) & 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    // phase: solve wait
    const Unit t = unit_at(u, m);
    const float* T = Lb[u & 1];
    const int j0 = t.q * PW;
    // the update part: l in [c0, j0) forward, [j0 + PW, c1) backward
    const int l0 = t.fwd ? t.c0 : max(t.c0, j0 + PW);
    const int l1 = t.fwd ? min(t.c1, j0) : t.c1;
    for (int lb = l0; lb < l1; lb += TK) {        // l0, l1: multiples of 32
      float part[2] = {};
#pragma unroll
      for (int l = lb; l < lb + TK; ++l) {
        const float a = Wt[l * SR + ty];
        const float2 b = *reinterpret_cast<const float2*>(&T[(l - t.c0) * SLD + 2 * tx]);
        part[0] = fmaf(a, b.x, part[0]);
        part[1] = fmaf(a, b.y, part[1]);
      }
      acc[0] += part[0];
      acc[1] += part[1];
    }
    // phase: solve update
    if (t.last) {
      // the block's right-hand sides, then its substitution against the
      // diagonal block L (L[a][c] = Ls[j0 + a][j0 + c]: Tg[c SLD + a]
      // forward, where the unit is stored transposed, Tg[a SLD + c]
      // backward): 8 lanes a row, each holding 4 of its entries; at step j
      // the entry's lane scales it by 1 / L[j][j] and the row's lanes take
      // it by a shuffle
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        Wt[(j0 + 2 * tx + y) * SR + ty] -= acc[y];
        acc[y] = 0.f;
      }
      __syncthreads();
      const float* Tg = t.fwd ? T + (j0 - t.c0) * SLD : T;
      const int ra = t.fwd ? 1 : SLD, ca = t.fwd ? SLD : 1;   // L[a][c] strides
      const int rr = (tid >> 3) % SR, h = tid & 7, base = lane & ~7;
      float v[4], rinv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * h + k;
        v[k] = Wt[(j0 + i) * SR + rr];
        rinv[k] = 1.f / Tg[i * ra + i * ca];
      }
      if (t.fwd) {
#pragma unroll
        for (int j = 0; j < PW; ++j) {
          if (h == j / 4) v[j % 4] *= rinv[j % 4];
          const float vj = __shfl_sync(FULL, v[j % 4], base | (j / 4));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * h + k > j) v[k] -= Tg[(4 * h + k) * ra + j * ca] * vj;
        }
      } else {
#pragma unroll
        for (int j = PW - 1; j >= 0; --j) {
          if (h == j / 4) v[j % 4] *= rinv[j % 4];
          const float vj = __shfl_sync(FULL, v[j % 4], base | (j / 4));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * h + k < j) v[k] -= Tg[j * ra + (4 * h + k) * ca] * vj;
        }
      }
      if (tid < 8 * SR)
#pragma unroll
        for (int k = 0; k < 4; ++k) Wt[(j0 + 4 * h + k) * SR + rr] = v[k];
    }
    __syncthreads();                               // T is free, Wt written
    // phase: solve substitution
  }
  // K out (every m column: zero past n), dx = K rn a row a warp
  for (int idx = tid; idx < SR * m; idx += ST) {
    const int r = idx / m, l = idx - r * m, d = d0 + r;
    if (d < D) K[static_cast<size_t>(d) * m + l] = Wt[l * SR + r];
  }
  const float* rn = W + lay.lc + static_cast<size_t>(m) * m;
  for (int r = warp; r < SR; r += ST / 32) {
    float s = 0.f;
    for (int l = lane; l < n; l += 32) s = fmaf(Wt[l * SR + r], rn[l], s);
    s = rvio::warp_sum(s);
    if (lane == 0 && d0 + r < D) dxe[d0 + r] = s;
  }
  // phase: solve store
}

// --- the products ------------------------------------------------------------

// An operand of a product: element (o, l), o the output row (A) or column
// (B) and l the depth, at p[o ld + l] or, transposed, at p[l ld + o]; bs
// floats between systems.
struct Opnd {
  const float* p;
  long long bs;
  int ld, t;
};

// out[i][j] = init[i][j] (i < irows) + scale sum_l A(i, l) B(j, l)
// (+ dval, or sig2 of the system, where i == j + doff), over rows x cols;
// the depth runs [0, depth), from the tile's first column (lo = 1: B a
// lower factor read as B(j, l) = L[l][j]) or its first row (lo = 2), to
// the tile's last column (hi = 1: B(j, l) = L[j][l]).
struct Prod {
  Opnd A, B;
  float* out;
  long long obs;
  int ldo, rows, cols, depth, lo, hi;
  float scale;
  int doff;
  float dval;
  const float* dsig;
  const float* init;
  long long ibs;
  int ild, irows;
};

// Stage a TM x TK slice of an operand (outputs o0 .., depth l0 .. l1) into
// T[kk][oo] by cp.async of 4 bytes, consecutive threads on consecutive
// addresses; zero past the edges.
template <int NTH>
__device__ __forceinline__ void stage(float* T, const float* p, int ld, int t,
                                      int o0, int on, int l0, int l1) {
  for (int q = threadIdx.x; q < TM * TK; q += NTH) {
    const int oo = t ? q % TM : q / TK, kk = t ? q / TM : q % TK;
    const int o = o0 + oo, l = l0 + kk;
    float* dst = T + kk * TLD + oo;
    if (o < on && l < l1)
      __pipeline_memcpy_async(dst, p + (t ? static_cast<size_t>(l) * ld + o
                                          : static_cast<size_t>(o) * ld + l),
                              sizeof(float));
    else
      *dst = 0.f;
  }
}

// A tile of TM x TM outputs a CTA (blockIdx.z the system); a thread 4
// rows (4 ty ..) by 2 columns (2 tx ..).  PNS slices in a ring, PNS - 1 of
// them in flight while one is used.
__global__ void __launch_bounds__(PT) product_kernel(const Prod q) {
  __shared__ __align__(16) float As[PNS][TK * TLD];
  __shared__ __align__(16) float Bs[PNS][TK * TLD];
  const int e = blockIdx.z, i0 = blockIdx.y * TM, j0 = blockIdx.x * TM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* A = q.A.p + e * q.A.bs;
  const float* B = q.B.p + e * q.B.bs;
  const int l_lo = q.lo == 1 ? j0 : (q.lo == 2 ? i0 : 0);
  const int l_hi = q.hi == 1 ? min(q.depth, j0 + TM) : q.depth;
  const int nst = l_hi > l_lo ? (l_hi - l_lo + TK - 1) / TK : 0;
  auto load = [&](int st) {
    if (st < nst) {
      const int l0 = l_lo + st * TK;
      stage<PT>(As[st % PNS], A, q.A.ld, q.A.t, i0, q.rows, l0, l_hi);
      stage<PT>(Bs[st % PNS], B, q.B.ld, q.B.t, j0, q.cols, l0, l_hi);
    }
    __pipeline_commit();
  };
  float acc[4][2] = {};
  for (int st = 0; st < PNS - 1; ++st) load(st);
  for (int t = 0; t < nst; ++t) {
    __pipeline_wait_prior(PNS - 2);
    __syncthreads();                 // slice t landed; slice t - 1 is free
    load(t + PNS - 1);
    const int buf = t % PNS;
    float part[4][2] = {};
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk * TLD + 4 * ty]);
      const float2 bb = *reinterpret_cast<const float2*>(&Bs[buf][kk * TLD + 2 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        part[x][0] = fmaf(av[x], bb.x, part[x][0]);
        part[x][1] = fmaf(av[x], bb.y, part[x][1]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[x][0] += part[x][0];
      acc[x][1] += part[x][1];
    }
  }
  const float dv = q.dsig ? q.dsig[e] : q.dval;
  float* out = q.out + e * q.obs;
  const float* init = q.init ? q.init + e * q.ibs : nullptr;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int i = i0 + 4 * ty + x, j = j0 + 2 * tx + y;
      if (i < q.rows && j < q.cols) {
        float v = (init && i < q.irows ? init[static_cast<size_t>(i) * q.ild + j]
                                       : 0.f) + q.scale * acc[x][y];
        if (i == j + q.doff) v += dv;
        out[static_cast<size_t>(i) * q.ldo + j] = v;
      }
    }
}

// X = (E P) E^T + sig2 K K^T and P_new = (X + X^T) / 2 (blockIdx.y the
// system).  The CTA of the tile pair (I, J), I <= J, forms for i in I and
// k in J: X[i][k] = [k < 24] Y[i][k] + Y[i][24:] . Ec[k] + sig2 K[i] . K[k]
// and X[k][i] = [i < 24] Y[k][i] + Ec[i] . Y[k][24:] + sig2 K[i] . K[k]
// (the same products in the same order as tile (J, I) would take them),
// and stores P_new[i][k] = P_new[k][i].  NaN where a factorization failed.
__global__ void __launch_bounds__(PT)
joseph_kernel(const float* __restrict__ ws, const float* __restrict__ sig2,
              float* __restrict__ Pn, int n, int T) {
  extern __shared__ __align__(16) float jsm[];
  auto Sm = reinterpret_cast<float (*)[6][TK * TLD]>(jsm);
  const Layout lay(n);
  const int D = lay.D, m = lay.m, e = blockIdx.y;
  int I = 0, J = blockIdx.x;
  while (J >= T - I) {
    J -= T - I;
    ++I;
  }
  J += I;
  const int i0 = I * TM, k0 = J * TM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* W = ws + static_cast<size_t>(e) * lay.total;
  const int* flags = reinterpret_cast<const int*>(W + lay.flags);
  float* Pe = Pn + static_cast<size_t>(e) * D * D;
  if (!flags[0] || !flags[1]) {
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < TM * TM; idx += PT) {
      const int i = i0 + idx / TM, k = k0 + idx % TM;
      if (i < D && k < D) {
        Pe[static_cast<size_t>(i) * D + k] = nan;
        Pe[static_cast<size_t>(k) * D + i] = nan;
      }
    }
    return;
  }
  const float* Y = W + lay.y;
  const float* Ec = W + lay.ec;
  const float* K = W + lay.k;
  // slices: Y[I, 24:], Ec[I], K[I], Ec[J], Y[J, 24:], K[J]
  const float* src[6] = {Y + NX, Ec, K, Ec, Y + NX, K};
  const int lds[6] = {D, m, m, m, D, m};
  const int o0[3] = {i0, i0, i0};
  const int nst = (n + TK - 1) / TK;
  auto load = [&](int st) {
    if (st < nst)
#pragma unroll
      for (int s = 0; s < 6; ++s)
        stage<PT>(Sm[st % JNS][s], src[s], lds[s], 0, s < 3 ? o0[s] : k0, D,
                  st * TK, n);
    __pipeline_commit();
  };
  float a1[4][2] = {}, a2[4][2] = {}, a3[4][2] = {};
  for (int st = 0; st < JNS - 1; ++st) load(st);
  for (int t = 0; t < nst; ++t) {
    __pipeline_wait_prior(JNS - 2);
    __syncthreads();                 // slice t landed; slice t - 1 is free
    load(t + JNS - 1);
    const int buf = t % JNS;
    float p1[4][2] = {}, p2[4][2] = {}, p3[4][2] = {};
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 ya = *reinterpret_cast<const float4*>(&Sm[buf][0][kk * TLD + 4 * ty]);
      const float4 ea = *reinterpret_cast<const float4*>(&Sm[buf][1][kk * TLD + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&Sm[buf][2][kk * TLD + 4 * ty]);
      const float2 eb = *reinterpret_cast<const float2*>(&Sm[buf][3][kk * TLD + 2 * tx]);
      const float2 yb = *reinterpret_cast<const float2*>(&Sm[buf][4][kk * TLD + 2 * tx]);
      const float2 kb = *reinterpret_cast<const float2*>(&Sm[buf][5][kk * TLD + 2 * tx]);
      const float yv[4] = {ya.x, ya.y, ya.z, ya.w};
      const float ev[4] = {ea.x, ea.y, ea.z, ea.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p1[x][0] = fmaf(yv[x], eb.x, p1[x][0]);
        p1[x][1] = fmaf(yv[x], eb.y, p1[x][1]);
        p2[x][0] = fmaf(ev[x], yb.x, p2[x][0]);
        p2[x][1] = fmaf(ev[x], yb.y, p2[x][1]);
        p3[x][0] = fmaf(kv[x], kb.x, p3[x][0]);
        p3[x][1] = fmaf(kv[x], kb.y, p3[x][1]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        a1[x][y] += p1[x][y];
        a2[x][y] += p2[x][y];
        a3[x][y] += p3[x][y];
      }
  }
  const float s2 = sig2[e];
  const float* Ye = Y;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int i = i0 + 4 * ty + x, k = k0 + 2 * tx + y;
      if (i < D && k < D) {
        const float kk = s2 * a3[x][y];
        const float xik = ((k < NX ? Ye[static_cast<size_t>(i) * D + k] : 0.f) +
                           a1[x][y]) + kk;
        const float xki = ((i < NX ? Ye[static_cast<size_t>(k) * D + i] : 0.f) +
                           a2[x][y]) + kk;
        const float v = 0.5f * (xik + xki);
        Pe[static_cast<size_t>(i) * D + k] = v;
        if (I != J) Pe[static_cast<size_t>(k) * D + i] = v;
      }
    }
}

// The dynamic shared memory limits, once per device: the factorization's
// largest (it may fill a CTA) and the solve's (m SR floats of rows), set
// to the most a CTA may opt into, so no later call (nor a graph capture)
// sets them again.  Where setting fails the error is taken off the
// runtime's last-error state.
cudaError_t configure() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  for (const void* f : {reinterpret_cast<const void*>(factor_kernel<false>),
                        reinterpret_cast<const void*>(factor_kernel<true>),
                        reinterpret_cast<const void*>(solve_kernel),
                        reinterpret_cast<const void*>(joseph_kernel)}) {
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
  }
  done[dev] = true;
  return cudaSuccess;
}

size_t solve_smem(int m, bool wt_global) {
  return sizeof(float) *
         ((wt_global ? 0 : static_cast<size_t>(m) * SR) + 2 * SCH * SLD);
}

}  // namespace

extern "C" {

// Floats of workspace a system needs at size n (the wrapper allocates B of
// them a call).  The route takes any n >= 1; `ekf_tail` sends it n > NMAX
// (scripts/ekf_tail_phases.py times it below that too).
int rvio_ekf_tail_wide_workspace(long long* out, int n, cudaStream_t) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *out = static_cast<long long>(Layout(n).total);
  return 0;
}

int rvio_ekf_tail_wide(const float* C, const float* b, const float* P,
                       const float* sig2, float* dx, float* Pn,
                       bool* fallback, float* ws, int B, int n,
                       cudaStream_t stream) {
  if (n < 1 || !ws) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout lay(n);
  const int m = lay.m, D = lay.D;
  const long long tot = static_cast<long long>(lay.total);
  const long long DD = static_cast<long long>(D) * D;
  const bool spill = factor_spills(m);
  const size_t fsm = 4 * static_cast<size_t>(factor_floats(m, m + 1, spill));
  const bool wt_global = solve_smem(m, false) > SMEM_MAX;
#define RVIO_CHECK()                                     \
  do {                                                   \
    err = cudaGetLastError();                            \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
  auto factor = [&](int is_s) {
    if (spill)
      factor_kernel<true><<<B * CL, FT, fsm, stream>>>(C, b, ws, fallback, n,
                                                       is_s);
    else
      factor_kernel<false><<<B * CL, FT, fsm, stream>>>(C, b, ws, fallback, n,
                                                        is_s);
  };
  auto product = [&](const Prod& q) {
    const dim3 grid((q.cols + TM - 1) / TM, (q.rows + TM - 1) / TM, B);
    product_kernel<<<grid, PT, 0, stream>>>(q);
  };
  float* Lc = ws + lay.lc;
  float* PHt = ws + lay.pht;
  Prod base = {};
  base.scale = 1.f;
  base.doff = 1 << 30;

  // 1. Lc and rn (C's cluster)
  factor(0);
  RVIO_CHECK();
  // 2. P Hn^T[d][j] = sum_{l >= j} P[d][24 + l] Lc[l][j]
  Prod q = base;
  q.A = {P + NX, DD, D, 0};
  q.B = {Lc, tot, m, 1};
  q.out = PHt; q.obs = tot; q.ldo = m;
  q.rows = D; q.cols = n; q.depth = n; q.lo = 1;
  product(q);
  RVIO_CHECK();
  // 3. S[i][k] = sum_{l >= i} Lc[l][i] P Hn^T[24 + l][k] + sig2 [i == k]
  q = base;
  q.A = {Lc, tot, m, 1};
  q.B = {PHt + static_cast<size_t>(NX) * m, tot, m, 1};
  q.out = ws + lay.s; q.obs = tot; q.ldo = m;
  q.rows = n; q.cols = n; q.depth = n; q.lo = 2;
  q.doff = 0; q.dsig = sig2;
  product(q);
  RVIO_CHECK();
  // 4. Ls (S's cluster)
  factor(1);
  RVIO_CHECK();
  // 5. K and dx
  solve_kernel<<<dim3((D + SR - 1) / SR, B), ST, solve_smem(m, wt_global),
                 stream>>>(ws, dx, n, wt_global);
  RVIO_CHECK();
  // 6. Ec[d][j] = [d == 24 + j] - sum_{l <= j} K[d][l] Lc[j][l]
  q = base;
  q.A = {ws + lay.k, tot, m, 0};
  q.B = {Lc, tot, m, 0};
  q.out = ws + lay.ec; q.obs = tot; q.ldo = m;
  q.rows = D; q.cols = n; q.depth = n; q.hi = 1;
  q.scale = -1.f; q.doff = NX; q.dval = 1.f;
  product(q);
  RVIO_CHECK();
  // 7. Y[i][k] = [i < 24] P[i][k] + sum_l Ec[i][l] P[24 + l][k]
  q = base;
  q.A = {ws + lay.ec, tot, m, 0};
  q.B = {P + static_cast<size_t>(NX) * D, DD, D, 1};
  q.out = ws + lay.y; q.obs = tot; q.ldo = D;
  q.rows = D; q.cols = D; q.depth = n;
  q.init = P; q.ibs = DD; q.ild = D; q.irows = NX;
  product(q);
  RVIO_CHECK();
  // 8. X and P_new
  const int T = (D + TM - 1) / TM;
  joseph_kernel<<<dim3(T * (T + 1) / 2, B), PT,
                  sizeof(float) * JNS * 6 * TK * TLD, stream>>>(ws, sig2, Pn,
                                                                 n, T);
  RVIO_CHECK();
#undef RVIO_CHECK
  return 0;
}

// How many of the factorization's clusters can be resident on the current
// device at once (cudaOccupancyMaxActiveClusters, at its shared memory for
// n).  Launches nothing.
int rvio_ekf_tail_wide_max_clusters(int* out, int B, int n, cudaStream_t) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m = round32(n);
  const bool spill = factor_spills(m);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * CL);
  config.blockDim = dim3(FT);
  config.dynamicSmemBytes = 4 * static_cast<size_t>(factor_floats(m, m + 1, spill));
  e = spill ? cudaOccupancyMaxActiveClusters(out, factor_kernel<true>, &config)
            : cudaOccupancyMaxActiveClusters(out, factor_kernel<false>, &config);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
