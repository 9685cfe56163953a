// Fused damped Schur-reduced solve of the sliding-window LM step.
//
// Replaces the TPU kernel `_schur_solve_kernel` / `_schur_solve_fused_batched`
// of anticipated_vins_mono_tpu/ops/pallas_kernels.py. Per scenario, in one
// launch, all in IEEE f32 (FMA on the CUDA cores; no TF32, no library call):
//
//   inv_h = 1/(h_ll(1+lam)+1e-12), 0 where h_ll <= 1e-10
//   H_red = H - H_lp^T diag(inv_h) H_lp        g_red = g - H_lp^T (inv_h g_l)
//   damp  = lam*max(diag(H_red),1e-8)+1e-10    A = H_red + diag(damp)
//   ds    = 1/sqrt(max(diag(A),1e-20))         An = ds A ds  (Jacobi scaling)
//   solve An y = -g_red*ds without pivoting    dx = y*ds
//   d_rho = -inv_h (g_l + H_lp dx)
//   pred  = 1/2 sum dx(damp dx - g_red) + 1/2 sum d_rho(lam h_ll d_rho - g_l)
//
// Design for Hopper. One thread block per scenario. The D x D working matrix
// lives in shared memory (odd row stride); H_lp does not fit beside it, so it
// is streamed from global memory in tiles of 16 landmark rows for the Schur
// product (each thread owns 4x4 micro-tiles of the lower triangle and keeps
// their sums in registers) and read once more for the back-substitution (it
// is still in L2 then). The TPU kernel used Gauss-Jordan because that
// vectorises on its vector unit; here the solve is an LDL^T elimination of
// the lower triangle with the right-hand side riding along as one extra row
// (that is the forward substitution), followed by a backward substitution:
// half the work, same dx. No pivoting; a pivot with |p| <= 1e-30 is replaced
// by 1e-30, as in the TPU kernel.
//
// What bounds it: bytes are small (H + H_lp + vectors ~ 219 KB per scenario
// at D=178, F=128) and so are operations (~6 Mflop); the time is the chain of
// 2*D dependent column steps, each a block-wide barrier plus a shared-memory
// round trip. One block works on one SM: at B = 1 one SM of 132 is busy, at
// B = 64 fewer than half.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileF = 16;  // landmark rows of H_lp per streamed tile

struct Layout {
  int dp;      // D rounded up to a multiple of 4
  int lda;     // row stride of the working matrix (odd)
  int off_w;   // tile of inv_h * H_lp      [kTileF][dp]
  int off_h;   // tile of H_lp              [kTileF][dp]
  int off_a;   // working matrix            [dp][lda]
  int off_b;   // rhs / z                   [dp]
  int off_y;   // solution of the scaled system, then dx [dp]
  int off_g;   // g_red                     [dp]
  int off_damp;
  int off_ds;
  int off_invh;  // [F]
  int off_red;   // [64] reduction scratch
  int total;     // floats
};

__host__ __device__ inline Layout make_layout(int D, int F) {
  Layout L;
  L.dp = (D + 3) & ~3;
  L.lda = L.dp + 1;
  L.off_w = 0;
  L.off_h = L.off_w + kTileF * L.dp;
  L.off_a = L.off_h + kTileF * L.dp;
  L.off_b = L.off_a + L.dp * L.lda;
  L.off_y = L.off_b + L.dp;
  L.off_g = L.off_y + L.dp;
  L.off_damp = L.off_g + L.dp;
  L.off_ds = L.off_damp + L.dp;
  L.off_invh = L.off_ds + L.dp;
  L.off_red = L.off_invh + F;
  L.total = L.off_red + 64;
  return L;
}

__device__ inline float guard_pivot(float p) {
  return (fabsf(p) > 1e-30f) ? p : 1e-30f;
}

__device__ inline float clamp_min(float x, float lo) {
  return (x < lo) ? lo : x;  // a NaN stays NaN
}

// Sum of `v` over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = (lane < (blockDim.x >> 5)) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kThreads)
schur_solve_fused_kernel(const float* __restrict__ H_all,
                         const float* __restrict__ g_all,
                         const float* __restrict__ Hlp_all,
                         const float* __restrict__ hll_all,
                         const float* __restrict__ gl_all,
                         const float* __restrict__ lam_all,
                         float* __restrict__ dx_all,
                         float* __restrict__ drho_all,
                         float* __restrict__ pred_all, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(D, F);
  const int dp = L.dp, lda = L.lda;
  float* Wt = smem + L.off_w;
  float* Ht = smem + L.off_h;
  float* A = smem + L.off_a;
  float* bvec = smem + L.off_b;
  float* yv = smem + L.off_y;
  float* gred = smem + L.off_g;
  float* damp = smem + L.off_damp;
  float* ds = smem + L.off_ds;
  float* invh = smem + L.off_invh;
  float* red = smem + L.off_red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const float* H = H_all + static_cast<size_t>(b) * D * D;
  const float* g = g_all + static_cast<size_t>(b) * D;
  const float* Hlp = Hlp_all + static_cast<size_t>(b) * F * D;
  const float* hll = hll_all + static_cast<size_t>(b) * F;
  const float* gl = gl_all + static_cast<size_t>(b) * F;
  const float lam = lam_all[b];

  // ---- load H (padding rows/columns zero), g, and the landmark inverses
  for (int idx = tid; idx < dp * dp; idx += nthreads) {
    const int r = idx / dp, c = idx - r * dp;
    A[r * lda + c] = (r < D && c < D) ? H[r * D + c] : 0.0f;
  }
  for (int c = tid; c < dp; c += nthreads) gred[c] = (c < D) ? g[c] : 0.0f;
  for (int f = tid; f < F; f += nthreads) {
    const float h = hll[f];
    invh[f] = (h > 1e-10f) ? 1.0f / (h * (1.0f + lam) + 1e-12f) : 0.0f;
  }
  __syncthreads();

  // ---- Schur product, lower triangle, streamed over tiles of H_lp rows
  const int nt = dp >> 2;                  // 4x4 micro-tiles per side
  const int ntiles = nt * (nt + 1) / 2;
  for (int f0 = 0; f0 < F; f0 += kTileF) {
    for (int idx = tid; idx < kTileF * dp; idx += nthreads) {
      const int fr = idx / dp, c = idx - fr * dp;
      const int f = f0 + fr;
      const float v = (f < F && c < D) ? Hlp[f * D + c] : 0.0f;
      Ht[idx] = v;
      Wt[idx] = (f < F) ? v * invh[f] : 0.0f;
    }
    __syncthreads();
    for (int t = tid; t < ntiles; t += nthreads) {
      int tr = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (tr * (tr + 1) / 2 > t) --tr;
      while ((tr + 1) * (tr + 2) / 2 <= t) ++tr;
      const int tc = t - tr * (tr + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
#pragma unroll 4
      for (int fr = 0; fr < kTileF; ++fr) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(Wt + fr * dp + 4 * tr);
        const float4 h4 =
            *reinterpret_cast<const float4*>(Ht + fr * dp + 4 * tc);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
        const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(w[i], h[k], acc[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          A[(4 * tr + i) * lda + 4 * tc + k] -= acc[i][k];
    }
    for (int c = tid; c < dp; c += nthreads) {
      float s = 0.0f;
      for (int fr = 0; fr < kTileF; ++fr) {
        const int f = f0 + fr;
        if (f < F) s = fmaf(Wt[fr * dp + c], gl[f], s);
      }
      gred[c] -= s;
    }
    __syncthreads();
  }

  // ---- damping and Jacobi scaling (lower triangle), rhs b = -g_red*ds
  for (int c = tid; c < D; c += nthreads) {
    const float diag = A[c * lda + c];
    const float dmp = lam * clamp_min(diag, 1e-8f) + 1e-10f;
    damp[c] = dmp;
    ds[c] = 1.0f / sqrtf(clamp_min(diag + dmp, 1e-20f));
  }
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += nthreads) {
    const int r = idx / D, c = idx - r * D;
    if (c > r) continue;
    float a = A[r * lda + c];
    if (r == c) a += damp[c];
    A[r * lda + c] = a * ds[r] * ds[c];
  }
  for (int c = tid; c < D; c += nthreads) bvec[c] = -gred[c] * ds[c];
  __syncthreads();

  // ---- LDL^T elimination; the rhs is row D of the working matrix, so the
  //      forward substitution is part of the trailing update
  for (int j = 0; j < D; ++j) {
    const float inv_d = 1.0f / guard_pivot(A[j * lda + j]);
    for (int r = j + 1 + warp; r <= D; r += nwarps) {
      float* row = (r < D) ? (A + r * lda) : bvec;
      const float lr = row[j] * inv_d;
      const int cmax = (r < D) ? r : D - 1;
      for (int c = j + 1 + lane; c <= cmax; c += 32) {
        row[c] -= lr * A[c * lda + j];
      }
    }
    __syncthreads();
  }

  // ---- backward substitution: y_j = z_j/d_j, then z_c -= A[j][c]*y_j
  for (int j = D - 1; j >= 0; --j) {
    const float yj = bvec[j] / guard_pivot(A[j * lda + j]);
    if (tid == 0) yv[j] = yj;
    for (int c = tid; c < j; c += nthreads) bvec[c] -= A[j * lda + c] * yj;
    __syncthreads();
  }

  // ---- dx, landmark back-substitution, predicted reduction
  float s1 = 0.0f;
  for (int c = tid; c < D; c += nthreads) {
    const float dxc = yv[c] * ds[c];
    yv[c] = dxc;
    dx_all[static_cast<size_t>(b) * D + c] = dxc;
    s1 += dxc * (damp[c] * dxc - gred[c]);
  }
  __syncthreads();
  float s2 = 0.0f;
  for (int f = warp; f < F; f += nwarps) {
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s = fmaf(Hlp[f * D + c], yv[c], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float glf = gl[f];
      const float dr = -invh[f] * (glf + s);
      drho_all[static_cast<size_t>(b) * F + f] = dr;
      s2 += dr * (lam * hll[f] * dr - glf);
    }
  }
  const float t1 = block_sum(s1, red);
  const float t2 = block_sum(s2, red);
  if (tid == 0) pred_all[b] = 0.5f * t1 + 0.5f * t2;
}

}  // namespace

// Shared memory one block needs for state dimension D and F landmarks.
extern "C" int avm_schur_solve_fused_smem_bytes(int D, int F) {
  return make_layout(D, F).total * static_cast<int>(sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int avm_schur_solve_fused(const float* H, const float* g,
                                     const float* H_lp, const float* h_ll,
                                     const float* g_l, const float* lam,
                                     float* dx, float* d_rho, float* pred,
                                     int batch, int D, int F, void* stream) {
  if (batch <= 0) return 0;
  const int smem = avm_schur_solve_fused_smem_bytes(D, F);
  cudaError_t err = cudaFuncSetAttribute(
      schur_solve_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  schur_solve_fused_kernel<<<batch, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      H, g, H_lp, h_ll, g_l, lam, dx, d_rho, pred, D, F);
  return static_cast<int>(cudaGetLastError());
}
