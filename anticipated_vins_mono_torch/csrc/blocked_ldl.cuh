// Blocked right-looking LDL^T of a symmetric matrix that sits in shared
// memory, for one thread block. Shared by logdet_psd.cu (the pivots' logs) and
// schur_solve_fused.cu (factorization, right-hand side, backward
// substitution): the Hopper counterpart of the elimination loops inside
// `_logdet_kernel` and `_schur_solve_kernel` of
// anticipated_vins_mono_tpu/ops/pallas_kernels.py.
//
// What bounds those kernels on an H100 is neither bytes nor operations (a
// 126- or 178-order f32 factorization is 0.7-1.9 Mflop) but the chain of
// dependent steps. An unblocked elimination pays one block-wide barrier and a
// shared-memory round trip per column. Here the chain is cut into panels of
// NB columns:
//
//   diagonal block   NB x NB, held one row per lane in registers and
//                    eliminated by ONE warp with shuffles: no block barrier
//                    inside the chain. That warp updates and factors the next
//                    diagonal block while the other warps are still in the
//                    trailing update of this panel (look-ahead).
//   panel solve      every row below the block is owned by one thread, which
//                    forward-solves its NB entries in registers against the
//                    block (read by broadcast). The scaled entries L stay in
//                    the lower triangle; the unscaled ones W = L*D go,
//                    transposed, into the upper triangle, which nothing else
//                    uses.
//   trailing update  A[i][j] -= sum_k L[i][k] * W[j][k] over the lower
//                    triangle in TM x 4 register micro-tiles; both operands
//                    arrive as 16-byte loads (L along k, W^T along j), the
//                    NB-deep sums stay in registers, IEEE fmaf. Tiles are
//                    dealt round-robin, so thread counts differ by at most one.
//   right-hand side  optional extra row: it takes part in the panel solve
//                    (that is the forward substitution) and in the update.
//   backward         blocked too: the diagonal block by one warp with
//                    shuffles, then every row above takes an NB-wide update
//                    read from the upper triangle.
//
// Two or three block barriers per panel replace NB of them. The order must be
// a multiple of NB: callers pad with identity rows (pivot 1, log 0). The row
// stride `lda` must be a multiple of 4 (16-byte rows); lda = 4 (mod 32) puts
// eight consecutive rows on eight different bank quads.
//
// Everything is IEEE f32 on the CUDA cores. No TF32 and no tensor-core path:
// the work is microseconds at the plain f32 rate, the chain sets the time, and
// the matrices (condition number ~5e9 in the selector, a cancelling Schur
// complement in the solver) cannot spare the 13 mantissa bits TF32 drops.
//
// Measured (one NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): the
// factorization takes 20.0 us at order 126 and 36.3 us at order 178 with the
// right-hand side, 290-380 clocks a column where the unblocked versions took
// 1,000-3,400. Panel width 16 with 4x4 update tiles and look-ahead was the
// fastest of the variants timed while the kernels were written (width 32, 8x4
// tiles, no look-ahead); only it is kept. What is left of the time: the tile
// update is bound by shared-memory bandwidth (a 4x4 tile loads 512 bytes for
// 256 fmaf; a pass of all warps takes 3,000-4,000 clocks where one warp alone
// needs 600), and the pivot chain of the one-warp diagonal block costs about
// 170 clocks a column.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace avm {

constexpr unsigned kFullMask = 0xffffffffu;

enum PivotRule {
  kPivotFloor,  // d < 1e-30 -> 1e-30, a NaN stays NaN (log-determinant)
  kPivotAbs     // |p| <= 1e-30 or NaN -> 1e-30         (Schur solve)
};

template <PivotRule R>
__device__ __forceinline__ float guard_pivot(float p) {
  if (R == kPivotFloor) return (p < 1e-30f) ? 1e-30f : p;
  return (fabsf(p) > 1e-30f) ? p : 1e-30f;
}

// ---------------------------------------------------------------- stamps

// clock64() of block 0 at a phase boundary, for the optional phase split.
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stamps[i] = clock64();
}

// ---------------------------------------------------------------- cp.async

template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem_dst, const float* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats per copy that rows of `cols` floats starting at `src` allow: 4, 2
// or 1 (every row start must be aligned to the copy's size).
__device__ __forceinline__ int row_vector_width(const float* src, int cols) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if ((cols & 3) == 0 && (a & 15) == 0) return 4;
  if ((cols & 1) == 0 && (a & 7) == 0) return 2;
  return 1;
}

template <int V>
__device__ __forceinline__ void copy_rows_async_v(float* dst, int ldd,
                                                  const float* src, int rows,
                                                  int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int segs = cols / V;
  for (int r = warp; r < rows; r += nwarps) {
    float* d = dst + r * ldd;
    const float* s = src + static_cast<size_t>(r) * cols;
    for (int q = lane; q < segs; q += 32) cp_async<4 * V>(d + V * q, s + V * q);
  }
}

// Queues asynchronous copies of a dense [rows][cols] global array into shared
// rows of stride `ldd` (a multiple of 4): one warp per row, one lane per 16-,
// 8- or 4-byte segment, no division. The caller commits and waits.
__device__ __forceinline__ void copy_rows_async(float* dst, int ldd,
                                                const float* src, int rows,
                                                int cols) {
  const int v = row_vector_width(src, cols);
  if (v == 4) copy_rows_async_v<4>(dst, ldd, src, rows, cols);
  else if (v == 2) copy_rows_async_v<2>(dst, ldd, src, rows, cols);
  else copy_rows_async_v<1>(dst, ldd, src, rows, cols);
}

// ---------------------------------------------------------------- diagonal

// Eliminates the NB x NB diagonal block at (k0, k0); called by all 32 lanes
// of ONE warp. Lane i holds row i in registers; the pivot and the column
// below it travel by shuffle. Leaves the unscaled columns W = L*D in the
// block's lower triangle, the pivot (before the guard) on the diagonal and
// 1/guard(pivot) in dinv[k0..k0+NB). With kLog, lane i adds
// log(guard(pivot_i)) to its `logacc` if its row comes before row `n`: a
// padding row's pivot is 1 by construction, but 0 * inf from an overflowed
// column above it would make it a NaN that is none of the matrix's.
template <int NB, PivotRule R, bool kLog>
__device__ __forceinline__ void ldl_diag_block(float* A, int lda, int k0,
                                               int n, float* dinv,
                                               float& logacc) {
  static_assert(NB == 16 || NB == 32, "one row per lane");
  const int lane = threadIdx.x & 31;
  const int row = (lane < NB) ? lane : NB - 1;
  float* arow = A + (k0 + row) * lda + k0;
  float a[NB];
#pragma unroll
  for (int c = 0; c < NB; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(arow + c);
    a[c] = v.x; a[c + 1] = v.y; a[c + 2] = v.z; a[c + 3] = v.w;
  }
  // The chain per column is shuffle -> guard -> reciprocal -> multiply ->
  // fmaf. __frcp_rn is the correctly rounded 1/d without the division's slow
  // path; the logarithm waits until the chain is through.
  float my_inv = 0.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = guard_pivot<R>(__shfl_sync(kFullMask, a[j], j));
    const float inv = __frcp_rn(d);
    if (lane == j) my_inv = inv;
    const float l = a[j] * inv;
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const float w = __shfl_sync(kFullMask, a[j], c);
      if (lane >= c) a[c] = fmaf(-l, w, a[c]);
    }
  }
  if (lane < NB) {
#pragma unroll
    for (int c = 0; c < NB; c += 4)
      *reinterpret_cast<float4*>(arow + c) =
          make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    dinv[k0 + lane] = my_inv;
    // lane i's own pivot is a[i] of its finished row
    if (kLog && k0 + lane < n) {
      float d = a[0];
#pragma unroll
      for (int c = 1; c < NB; ++c) d = (lane == c) ? a[c] : d;
      logacc += logf(guard_pivot<R>(d));
    }
  }
}

// ---------------------------------------------------------------- panel

// One thread forward-solves one row's NB entries against the factored
// diagonal block at (k0, k0). x: the row's entries (16-byte aligned). Writes
// the scaled entries L to l_out[0..NB) and the unscaled ones W to
// w_out[k * w_stride]. x, l_out and w_out may alias: everything is read
// before anything is written.
template <int NB>
__device__ __forceinline__ void ldl_panel_row(const float* x_in,
                                              const float* A, int lda, int k0,
                                              const float* dinv, float* l_out,
                                              float* w_out, int w_stride) {
  float x[NB], l[NB];
#pragma unroll
  for (int c = 0; c < NB; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x_in + c);
    x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float* brow = A + (k0 + k) * lda + k0;  // block row k, broadcast
#pragma unroll
    for (int m = 0; m < k; m += 4) {
      const float4 b = *reinterpret_cast<const float4*>(brow + m);
      x[k] = fmaf(-l[m], b.x, x[k]);
      if (m + 1 < k) x[k] = fmaf(-l[m + 1], b.y, x[k]);
      if (m + 2 < k) x[k] = fmaf(-l[m + 2], b.z, x[k]);
      if (m + 3 < k) x[k] = fmaf(-l[m + 3], b.w, x[k]);
    }
    l[k] = x[k] * dinv[k0 + k];
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) w_out[k * w_stride] = x[k];
#pragma unroll
  for (int c = 0; c < NB; c += 4)
    *reinterpret_cast<float4*>(l_out + c) =
        make_float4(l[c], l[c + 1], l[c + 2], l[c + 3]);
}

// ---------------------------------------------------------------- trailing

// Tile t of the lower triangle in rows of TM and columns of 4, row-major:
// its first row and column, relative to the triangle's corner.
template <int TM>
__device__ __forceinline__ void tile_origin(int t, int& i0, int& j0) {
  if (TM == 4) {  // row r holds r + 1 tiles
    int r = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (r * (r + 1) / 2 > t) --r;
    while ((r + 1) * (r + 2) / 2 <= t) ++r;
    i0 = 4 * r;
    j0 = 4 * (t - r * (r + 1) / 2);
  } else {  // TM == 8: row r holds 2r + 2 tiles
    int r = static_cast<int>((sqrtf(4.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (r * (r + 1) > t) --r;
    while ((r + 1) * (r + 2) <= t) ++r;
    i0 = 8 * r;
    j0 = 4 * (t - r * (r + 1));
  }
}

// Tiles of the lower triangle of an m x m matrix, m a multiple of TM.
template <int TM>
__device__ __forceinline__ int tile_count(int m) {
  const int r = m / TM;
  return (TM == 4) ? r * (r + 1) / 2 : r * (r + 1);
}

// A[i0.., j0..] -= L[i0.., k0..k0+NB) * W^T[k0..k0+NB), j0..] for one
// TM x 4 tile (absolute indices). A tile that straddles the diagonal also
// writes entries above it; nothing reads those.
template <int NB, int TM>
__device__ __forceinline__ void ldl_update_tile(float* A, int lda, int k0,
                                                int i0, int j0) {
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NB; kk += 4) {
    float4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = *reinterpret_cast<const float4*>(A + (k0 + kk + k) * lda + j0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 l =
          *reinterpret_cast<const float4*>(A + (i0 + i) * lda + k0 + kk);
      const float lk[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][0] = fmaf(lk[k], w[k].x, acc[i][0]);
        acc[i][1] = fmaf(lk[k], w[k].y, acc[i][1]);
        acc[i][2] = fmaf(lk[k], w[k].z, acc[i][2]);
        acc[i][3] = fmaf(lk[k], w[k].w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float4* p = reinterpret_cast<float4*>(A + (i0 + i) * lda + j0);
    float4 v = *p;
    v.x -= acc[i][0]; v.y -= acc[i][1]; v.z -= acc[i][2]; v.w -= acc[i][3];
    *p = v;
  }
}

// ---------------------------------------------------------------- factor

// Blocked LDL^T of the np x np matrix A (np a multiple of NB, row stride
// lda; rows from n on are padding), lower triangle, by the whole block. Leaves L (scaled) below the
// diagonal blocks, W = L*D inside them and, transposed, above them;
// 1/guard(pivot) in dinv[np]. With kRhs, `rhs`[np] rides along as an extra
// row and ends as z = L^-1 rhs; `lrhs`[NB] is scratch. With kLog, lane i of
// warp 0 adds the logs of the pivots it owned (rows before n only) to its
// `logacc`. Ends with a block barrier. Warp 0 updates the next diagonal block
// first and factors it while the other warps finish the trailing update.
template <int NB, int TM, PivotRule R, bool kLog, bool kRhs>
__device__ __forceinline__ void blocked_ldl_factor(float* A, int lda, int np,
                                                   int n, float* dinv,
                                                   float* rhs,
                                                   float* lrhs,
                                                   float& logacc) {
  static_assert(NB % TM == 0, "the next diagonal block is whole tiles");
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (warp == 0) ldl_diag_block<NB, R, kLog>(A, lda, 0, n, dinv, logacc);
  __syncthreads();
  for (int k0 = 0; k0 < np; k0 += NB) {
    const int k1 = k0 + NB;
    const int m = np - k1;  // rows below the block
    for (int r = tid; r < m + (kRhs ? 1 : 0); r += nthreads) {
      if (r < m) {
        float* row = A + (k1 + r) * lda + k0;
        ldl_panel_row<NB>(row, A, lda, k0, dinv, row, A + k0 * lda + k1 + r,
                          lda);
      } else {
        ldl_panel_row<NB>(rhs + k0, A, lda, k0, dinv, lrhs, rhs + k0, 1);
      }
    }
    __syncthreads();
    if (m == 0) break;

    const int ntiles = tile_count<TM>(m);
    const int nfirst = tile_count<TM>(NB);  // tiles of the next diag block
    if (warp == 0) {
      for (int t = lane; t < nfirst; t += 32) {
        int i0, j0;
        tile_origin<TM>(t, i0, j0);
        ldl_update_tile<NB, TM>(A, lda, k0, k1 + i0, k1 + j0);
      }
      __syncwarp();
      ldl_diag_block<NB, R, kLog>(A, lda, k1, n, dinv, logacc);
    } else {
      for (int t = nfirst + tid - 32; t < ntiles; t += nthreads - 32) {
        int i0, j0;
        tile_origin<TM>(t, i0, j0);
        ldl_update_tile<NB, TM>(A, lda, k0, k1 + i0, k1 + j0);
      }
    }
    if (kRhs) {  // dealt from the last thread down: warp 0 is busy
      for (int c = nthreads - 1 - tid; c < m; c += nthreads) {
        float s = rhs[k1 + c];
#pragma unroll
        for (int k = 0; k < NB; ++k)
          s = fmaf(-lrhs[k], A[(k0 + k) * lda + k1 + c], s);
        rhs[k1 + c] = s;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward

// Solves D L^T y = z after blocked_ldl_factor (z is consumed). Per diagonal
// block from the last: one warp substitutes inside the block (lane c holds
// z_c and column c of the block), then every row above subtracts its NB-wide
// share, read from the upper triangle. Ends with a block barrier.
template <int NB>
__device__ __forceinline__ void blocked_ldl_backward(const float* A, int lda,
                                                     int np, const float* dinv,
                                                     float* z, float* y) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int k0 = np - NB; k0 >= 0; k0 -= NB) {
    if (warp == 0) {
      const int c = (lane < NB) ? lane : NB - 1;
      float zc = z[k0 + c];
      const float di = dinv[k0 + c];
      float wcol[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) wcol[j] = A[(k0 + j) * lda + k0 + c];
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        const float yj = __shfl_sync(kFullMask, zc * di, j);
        if (lane == j) y[k0 + j] = yj;
        if (lane < j) zc = fmaf(-wcol[j], yj, zc);
      }
    }
    __syncthreads();
    for (int r = tid; r < k0; r += nthreads) {
      const float* row = A + r * lda + k0;
      float s = z[r];
#pragma unroll
      for (int j = 0; j < NB; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(row + j);
        const float4 v = *reinterpret_cast<const float4*>(y + k0 + j);
        s = fmaf(-a.x, v.x, s);
        s = fmaf(-a.y, v.y, s);
        s = fmaf(-a.z, v.z, s);
        s = fmaf(-a.w, v.w, s);
      }
      z[r] = s;
    }
    __syncthreads();
  }
}

}  // namespace avm
