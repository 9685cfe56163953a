// Fused damped Schur-reduced solve of the sliding-window LM step.
//
// Replaces the TPU kernel `_schur_solve_kernel` / `_schur_solve_fused_batched`
// of anticipated_vins_mono_tpu/ops/pallas_kernels.py. Per scenario, in one
// launch, all in IEEE f32 (FMA on the CUDA cores; no TF32, no tensor cores,
// no library call: see blocked_ldl.cuh for why):
//
//   inv_h = 1/(h_ll(1+lam)+1e-12), 0 where h_ll <= 1e-10
//   H_red = H - H_lp^T diag(inv_h) H_lp        g_red = g - H_lp^T (inv_h g_l)
//   damp  = lam*max(diag(H_red),1e-8)+1e-10    A = H_red + diag(damp)
//   ds    = 1/sqrt(max(diag(A),1e-20))         An = ds A ds  (Jacobi scaling)
//   solve An y = -g_red*ds without pivoting    dx = y*ds
//   d_rho = -inv_h (g_l + H_lp dx)
//   pred  = 1/2 sum dx(damp dx - g_red) + 1/2 sum d_rho(lam h_ll d_rho - g_l)
//
// What bounds it on an H100: bytes are small (219 KB per scenario at D=178,
// F=128) and so are operations (6 Mflop); one block works on one SM, so the
// time is what one SM needs for a chain of dependent phases. The first
// version spent it on 2*D block barriers (one per column of the elimination
// and of the backward substitution) and on a Schur product whose tiles were
// loaded synchronously.
//
// Design. One block per scenario factors and solves. The working matrix
// lives in shared memory, padded to a multiple of the panel width with
// identity rows (row stride dp + 4: 16-byte rows, consecutive rows four banks
// apart).
//   load     H arrives by cp.async (one warp per row, no division), in flight
//            together with the first tile of H_lp.
//   product  H_lp streams through a two-stage cp.async ring of 32 landmark
//            rows: tile t+1 loads while tile t is multiplied. Each thread
//            owns one 8x4 register tile of the lower triangle (552 tiles on
//            608 threads at D=178: one pass), keeps its sums in registers
//            over all of H_lp, scales the four column operands by inv_h in
//            registers and accumulates with fmaf; g_red rides along.
//   cluster  the product is bound by one SM's FMA rate, so where the batch
//            leaves SMs idle (batch * CS <= SM count) a scenario is a
//            thread-block cluster of CS = 2, 4 or 8 CTAs: each CTA takes 1/CS
//            of the tiles and splits the 32 rows of every stage over CS
//            thread groups (every thread stays busy, 1/CS of the depth), the
//            groups add their sums into the CTA's shared memory in turn, and
//            after cluster.sync() CTA 0 subtracts the other CTAs' slabs from H
//            through distributed shared memory and goes on alone.
//   scale    damping and Jacobi scaling of the lower triangle.
//   factor   blocked LDL^T (blocked_ldl.cuh) with the right-hand side as
//            the extra row: the forward substitution is free.
//   solve    blocked backward substitution.
//   epilogue dx, landmark back-substitution (H_lp read again, from L2),
//            predicted reduction.
// No pivoting; a pivot with |p| <= 1e-30 is replaced by 1e-30, as in the TPU
// kernel.
//
// Measured (one NVIDIA H100 80GB HBM3, 700.00 W; D=178, F=128; chip_smoke.py,
// launches replayed from a CUDA graph, split from the clock64() stamps of
// block 0): 0.0692 ms at B=64 (clusters of 2) and 0.0639 ms at B=1 (a cluster
// of 8), against 0.2846 and 0.2838 ms for the first version. Split at B=1:
// load 6 %, product with the gather 20 %, scaling 2 %, factorization 56 %,
// backward substitution 10 %, epilogue 6 %. Without clusters
// (avm_schur_set_max_cluster(1)) the kernel takes 0.079-0.080 ms at every
// batch size and load + product are 37 % of it: more than a quarter, which is
// why the cluster split is here. The device holds 66 clusters of 2, 30 of 4
// and 15 of 8 CTAs of this kernel at once; the width is the widest that
// keeps the batch in one wave (0.0692, 0.0651, 0.0639 ms).

#include <cooperative_groups.h>

#include "blocked_ldl.cuh"

namespace {

using namespace avm;
namespace cg = cooperative_groups;

constexpr int kNB = 16;        // panel width of the factorization
constexpr int kTM = 4;         // rows of an update tile
constexpr int kThreads = 608;  // one 8x4 product tile each up to D = 192
constexpr int kTileF = 32;  // landmark rows of H_lp per stage of the ring
constexpr int kMaxSmem = 232448;

struct Layout {
  int dp;        // D rounded up to a multiple of the panel width
  int lda;       // row stride of the working matrix and of the H_lp stages
  int fp;        // F rounded up to a multiple of kTileF
  int off_a;     // working matrix            [dp][lda]
  int off_st;    // two stages of H_lp rows   [2][kTileF][lda]
  int off_b;     // rhs / z                   [dp]
  int off_y;     // solution of the scaled system, then dx [dp]
  int off_g;     // g_red                     [dp]
  int off_damp;  // [dp]
  int off_ds;    // [dp]
  int off_dinv;  // reciprocal pivots         [dp]
  int off_lrhs;  // the rhs row's scaled panel entries [kNB]
  int off_invh;  // [fp]
  int off_gl;    // [fp]
  int off_red;   // [64] reduction scratch
  int total;     // floats
};

__host__ __device__ inline Layout make_layout(int D, int F) {
  Layout L;
  L.dp = (D + kNB - 1) / kNB * kNB;
  L.lda = L.dp + 4;
  L.fp = (F + kTileF - 1) / kTileF * kTileF;
  L.off_a = 0;
  L.off_st = L.off_a + L.dp * L.lda;
  L.off_b = L.off_st + 2 * kTileF * L.lda;
  L.off_y = L.off_b + L.dp;
  L.off_g = L.off_y + L.dp;
  L.off_damp = L.off_g + L.dp;
  L.off_ds = L.off_damp + L.dp;
  L.off_dinv = L.off_ds + L.dp;
  L.off_lrhs = L.off_dinv + L.dp;
  L.off_invh = L.off_lrhs + kNB;
  L.off_gl = L.off_invh + L.fp;
  L.off_red = L.off_gl + L.fp;
  L.total = L.off_red + 64;
  return L;
}

__device__ inline float clamp_min(float x, float lo) {
  return (x < lo) ? lo : x;  // a NaN stays NaN
}

// Sum of `v` over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = (lane < (blockDim.x >> 5)) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFullMask, s, o);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// Queues the copy of landmark rows [f0, f0 + kTileF) of H_lp into one stage;
// rows past F are zero-filled.
__device__ __forceinline__ void queue_hlp_tile(float* stage, int lda,
                                               const float* Hlp, int f0, int F,
                                               int D) {
  const int rows = min(kTileF, F - f0);
  copy_rows_async(stage, lda, Hlp + static_cast<size_t>(f0) * D, rows, D);
  for (int idx = threadIdx.x; idx < (kTileF - rows) * D; idx += blockDim.x)
    stage[(rows + idx / D) * lda + idx % D] = 0.0f;
  cp_async_commit();
}

// acc[8][4] += sum_f Hlp[f][i0 + i] * (inv_h[f] * Hlp[f][j0 + c]) over the rows
// [f_begin, f_end) of one stage.
__device__ __forceinline__ void schur_accumulate(float (&acc)[8][4],
                                                 const float* stage, int lda,
                                                 const float* invh, int i0,
                                                 int j0, int f_begin,
                                                 int f_end) {
#pragma unroll 4
  for (int f = f_begin; f < f_end; ++f) {
    const float* hrow = stage + f * lda;
    const float ih = invh[f];
    const float4 c4 = *reinterpret_cast<const float4*>(hrow + j0);
    const float4 ra = *reinterpret_cast<const float4*>(hrow + i0);
    const float4 rb = *reinterpret_cast<const float4*>(hrow + i0 + 4);
    const float w[4] = {c4.x * ih, c4.y * ih, c4.z * ih, c4.w * ih};
    const float r[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(r[i], w[c], acc[i][c]);
  }
}

// tile = sign * acc (kSet) or tile += sign * acc, one 8x4 tile of A.
template <bool kSet>
__device__ __forceinline__ void schur_store_tile(float* A, int lda,
                                                 const float (&acc)[8][4],
                                                 float sign, int i0, int j0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4* p = reinterpret_cast<float4*>(A + (i0 + i) * lda + j0);
    float4 v = kSet ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *p;
    v.x += sign * acc[i][0]; v.y += sign * acc[i][1];
    v.z += sign * acc[i][2]; v.w += sign * acc[i][3];
    *p = v;
  }
}

template <int CS>
__global__ void __launch_bounds__(kThreads)
schur_solve_fused_kernel(const float* __restrict__ H_all,
                         const float* __restrict__ g_all,
                         const float* __restrict__ Hlp_all,
                         const float* __restrict__ hll_all,
                         const float* __restrict__ gl_all,
                         const float* __restrict__ lam_all,
                         float* __restrict__ dx_all,
                         float* __restrict__ drho_all,
                         float* __restrict__ pred_all, int D, int F,
                         long long* stamps) {
  static_assert(kTileF % CS == 0, "a stage's rows split evenly over groups");
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(D, F);
  const int dp = L.dp, lda = L.lda;
  float* A = smem + L.off_a;
  float* stages = smem + L.off_st;
  float* bvec = smem + L.off_b;
  float* yv = smem + L.off_y;
  float* gred = smem + L.off_g;
  float* damp = smem + L.off_damp;
  float* ds = smem + L.off_ds;
  float* dinv = smem + L.off_dinv;
  float* lrhs = smem + L.off_lrhs;
  float* invh = smem + L.off_invh;
  float* glw = smem + L.off_gl;
  float* red = smem + L.off_red;

  // a scenario is a cluster of CS consecutive blocks; rank 0 owns the solve
  const int b = blockIdx.x / CS;
  int rank = 0;
  if (CS > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const float* H = H_all + static_cast<size_t>(b) * D * D;
  const float* g = g_all + static_cast<size_t>(b) * D;
  const float* Hlp = Hlp_all + static_cast<size_t>(b) * F * D;
  const float* hll = hll_all + static_cast<size_t>(b) * F;
  const float* gl = gl_all + static_cast<size_t>(b) * F;
  const float lam = lam_all[b];
  stamp(stamps, 0);

  // ---- load: H and the first H_lp tile in flight together; vectors
  if (rank == 0) copy_rows_async(A, lda, H, D, D);
  cp_async_commit();
  queue_hlp_tile(stages, lda, Hlp, 0, F, D);
  for (int c = tid; c < dp; c += nthreads) gred[c] = (c < D) ? g[c] : 0.0f;
  for (int f = tid; f < L.fp; f += nthreads) {
    const float h = (f < F) ? hll[f] : 0.0f;
    invh[f] = (h > 1e-10f) ? 1.0f / (h * (1.0f + lam) + 1e-12f) : 0.0f;
    glw[f] = (f < F) ? gl[f] : 0.0f;
  }
  cp_async_wait<1>();  // H has landed (this thread's share)
  __syncthreads();
  stamp(stamps, 1);

  // ---- Schur product over the lower triangle, H_lp streamed in two stages.
  //      Tiles also cover the rows D..dpp-1 and touch entries above the
  //      diagonal: both are overwritten or never read afterwards. This CTA
  //      owns the tiles [rank*slab, (rank+1)*slab); thread group `grp` takes
  //      kTileF/CS rows of every stage. One tile per thread: the launcher
  //      refuses a D whose tiles outnumber the threads.
  const int dpp = (D + 7) & ~7;
  const int ntiles = tile_count<8>(dpp);
  const int slab = (ntiles + CS - 1) / CS;
  const int grp = tid / slab;
  const int tile = rank * slab + tid - grp * slab;
  const bool active = grp < CS && tile < ntiles;
  constexpr int kSub = kTileF / CS;
  int i0 = 0, j0 = 0;
  if (active) tile_origin<8>(tile, i0, j0);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  const int nstages = L.fp / kTileF;
  for (int t = 0; t < nstages; ++t) {
    float* stage = stages + (t & 1) * kTileF * lda;
    if (t + 1 < nstages) {
      queue_hlp_tile(stages + ((t + 1) & 1) * kTileF * lda, lda, Hlp,
                     (t + 1) * kTileF, F, D);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is visible to every thread
    const float* ih = invh + t * kTileF;
    if (active)
      schur_accumulate(acc, stage, lda, ih, i0, j0, grp * kSub,
                       (grp + 1) * kSub);
    if (rank == 0) {
      for (int c = nthreads - 1 - tid; c < D; c += nthreads) {
        float s = 0.0f;
#pragma unroll 8
        for (int f = 0; f < kTileF; ++f)
          s = fmaf(stage[f * lda + c] * ih[f], glw[t * kTileF + f], s);
        gred[c] -= s;
      }
    }
    __syncthreads();  // the stage may be refilled
  }
  // the groups' sums meet in shared memory, one group at a time: CTA 0
  // subtracts from H, the others build their slab of the product
  for (int gg = 0; gg < CS; ++gg) {
    if (active && grp == gg) {
      if (rank == 0) schur_store_tile<false>(A, lda, acc, -1.0f, i0, j0);
      else if (gg == 0) schur_store_tile<true>(A, lda, acc, 1.0f, i0, j0);
      else schur_store_tile<false>(A, lda, acc, 1.0f, i0, j0);
    }
    __syncthreads();
  }
  if (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every slab is complete
    if (rank == 0) {
      for (int q = slab + tid; q < ntiles; q += nthreads) {
        const float* remote = cluster.map_shared_rank(A, q / slab);
        int ri, rj;
        tile_origin<8>(q, ri, rj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int at = (ri + i) * lda + rj;
          const float4 part = *reinterpret_cast<const float4*>(remote + at);
          float4* p = reinterpret_cast<float4*>(A + at);
          float4 v = *p;
          v.x -= part.x; v.y -= part.y; v.z -= part.z; v.w -= part.w;
          *p = v;
        }
      }
    }
    cluster.sync();  // the other CTAs' shared memory may go
    if (rank != 0) return;
  }
  stamp(stamps, 2);

  // ---- damping and Jacobi scaling (lower triangle), rhs b = -g_red*ds;
  //      identity rows up to the padded order
  for (int c = tid; c < dp; c += nthreads) {
    float dmp = 0.0f, s = 1.0f;
    if (c < D) {
      const float diag = A[c * lda + c];
      dmp = lam * clamp_min(diag, 1e-8f) + 1e-10f;
      s = 1.0f / sqrtf(clamp_min(diag + dmp, 1e-20f));
    }
    damp[c] = dmp;
    ds[c] = s;
    bvec[c] = -gred[c] * s;
  }
  __syncthreads();
  // every thread scales one 8x4 tile of the lower triangle (the product's
  // tiling); what lies past D becomes identity
  for (int q = tid; q < ntiles; q += nthreads) {
    int r0, c0;
    tile_origin<8>(q, r0, c0);
    const float4 dc = *reinterpret_cast<const float4*>(ds + c0);
    const float4 pc = *reinterpret_cast<const float4*>(damp + c0);
    const float dsc[4] = {dc.x, dc.y, dc.z, dc.w};
    const float dmc[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      float4* p = reinterpret_cast<float4*>(A + r * lda + c0);
      const float4 v4 = *p;
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
      const float dsr = ds[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        float a = v[e];
        if (r == c) a += dmc[e];
        a = a * dsr * dsc[e];
        v[e] = (r < D && c < D) ? a : ((r == c) ? 1.0f : 0.0f);
      }
      *p = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int r = dpp + warp; r < dp; r += nwarps)
    for (int c = lane; c <= r; c += 32) A[r * lda + c] = (r == c) ? 1.0f : 0.0f;
  __syncthreads();
  stamp(stamps, 3);

  // ---- blocked LDL^T, the rhs riding along; then backward substitution
  float unused = 0.0f;
  blocked_ldl_factor<kNB, kTM, kPivotAbs, false, true>(
      A, lda, dp, D, dinv, bvec, lrhs, unused);
  stamp(stamps, 4);
  blocked_ldl_backward<kNB>(A, lda, dp, dinv, bvec, yv);
  stamp(stamps, 5);

  // ---- dx, landmark back-substitution, predicted reduction
  float s1 = 0.0f;
  for (int c = tid; c < D; c += nthreads) {
    const float dxc = yv[c] * ds[c];
    yv[c] = dxc;
    dx_all[static_cast<size_t>(b) * D + c] = dxc;
    s1 += dxc * (damp[c] * dxc - gred[c]);
  }
  __syncthreads();
  // four landmark rows per warp at a time, their loads in flight together
  float s2 = 0.0f;
  for (int fb = warp; fb < F; fb += 4 * nwarps) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = lane; c < D; c += 32) {
      const float y = yv[c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = fb + u * nwarps;
        if (f < F) s[u] = fmaf(Hlp[f * D + c], y, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      for (int o = 16; o > 0; o >>= 1)
        s[u] += __shfl_down_sync(kFullMask, s[u], o);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = fb + u * nwarps;
        if (f < F) {
          const float glf = glw[f];
          const float dr = -invh[f] * (glf + s[u]);
          drho_all[static_cast<size_t>(b) * F + f] = dr;
          s2 += dr * (lam * hll[f] * dr - glf);
        }
      }
    }
  }
  const float t1 = block_sum(s1, red);
  const float t2 = block_sum(s2, red);
  if (tid == 0) pred_all[b] = 0.5f * t1 + 0.5f * t2;
  stamp(stamps, 6);
}

}  // namespace

// Shared memory one block needs for state dimension D and F landmarks.
extern "C" int avm_schur_solve_fused_smem_bytes(int D, int F) {
  return make_layout(D, F).total * static_cast<int>(sizeof(float));
}

namespace {

// set by init: clusters of 1, 2, 4 and 8 CTAs of this kernel that the device
// holds at the same time (index log2 of the width; 0 = cannot be scheduled)
int g_active_clusters[4] = {0, 0, 0, 0};
// widest cluster the launcher may take: 8, unless a measurement lowers it
int g_max_cluster = 8;

// 8x4 product tiles of the lower triangle for state dimension D: every thread
// of a block owns at most one of them.
int product_tiles(int D) {
  const int r = (D + 7) / 8;
  return r * (r + 1);
}

template <int CS>
cudaError_t launch(int batch, int smem, cudaStream_t stream, const float* H,
                   const float* g, const float* H_lp, const float* h_ll,
                   const float* g_l, const float* lam, float* dx, float* d_rho,
                   float* pred, int D, int F, long long* stamps) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, schur_solve_fused_kernel<CS>, H, g, H_lp,
                            h_ll, g_l, lam, dx, d_rho, pred, D, F, stamps);
}

// Opts the CS-wide kernel into the full shared memory and asks whether the
// device can hold one such cluster at the largest layout.
template <int CS>
cudaError_t init_one(int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      schur_solve_fused_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       schur_solve_fused_kernel<CS>, &cfg);
  *active = (err == cudaSuccess) ? clusters : 0;
  if (err != cudaSuccess) cudaGetLastError();  // an unsupported width is no fault
  return cudaSuccess;
}

}  // namespace

// Opts every cluster width of the kernel into the shared memory a block may
// have on an H100 and records how many clusters of each width the device
// holds at once. Called once after the library is loaded; returns a CUDA
// error code.
extern "C" int avm_schur_solve_fused_init() {
  cudaError_t err;
  if ((err = init_one<1>(&g_active_clusters[0])) != cudaSuccess ||
      (err = init_one<2>(&g_active_clusters[1])) != cudaSuccess ||
      (err = init_one<4>(&g_active_clusters[2])) != cudaSuccess ||
      (err = init_one<8>(&g_active_clusters[3])) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

// Clusters of `width` (1, 2, 4, 8) CTAs that the device holds at once.
extern "C" int avm_schur_active_clusters(int width) {
  for (int i = 0; i < 4; ++i)
    if (width == (1 << i)) return g_active_clusters[i];
  return 0;
}

// Caps the cluster width (1, 2, 4 or 8; 8 when the library is loaded). For
// measuring what the cluster split is worth; the port never lowers it.
extern "C" int avm_schur_set_max_cluster(int width) {
  g_max_cluster = width;
  return 0;
}

// CTAs per scenario for a batch: the widest cluster of 8, 4, 2 or 1 of which
// the device holds `batch` at once, so that the whole batch still runs as one
// wave.
extern "C" int avm_schur_cluster_size(int batch) {
  for (int i = 3; i > 0; --i)
    if ((1 << i) <= g_max_cluster && batch <= g_active_clusters[i])
      return 1 << i;
  return 1;
}

// Launches on `stream`; returns the launch's CUDA error code (0 = launched).
// `stamps`: null, or 7 clock64() values of block 0.
extern "C" int avm_schur_solve_fused(const float* H, const float* g,
                                     const float* H_lp, const float* h_ll,
                                     const float* g_l, const float* lam,
                                     float* dx, float* d_rho, float* pred,
                                     int batch, int D, int F,
                                     long long* stamps, void* stream) {
  if (batch <= 0) return 0;
  const int smem = avm_schur_solve_fused_smem_bytes(D, F);
  // one product tile per thread, for every cluster width (8 slabs of
  // ceil(tiles / 8) threads are the most any width needs)
  if (D <= 0 || F <= 0 || smem > kMaxSmem ||
      (product_tiles(D) + 7) / 8 * 8 > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define AVM_LAUNCH(CS) \
  launch<CS>(batch, smem, st, H, g, H_lp, h_ll, g_l, lam, dx, d_rho, pred, D, \
             F, stamps)
  switch (avm_schur_cluster_size(batch)) {
    case 8: err = AVM_LAUNCH(8); break;
    case 4: err = AVM_LAUNCH(4); break;
    case 2: err = AVM_LAUNCH(2); break;
    default: err = AVM_LAUNCH(1); break;
  }
#undef AVM_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
