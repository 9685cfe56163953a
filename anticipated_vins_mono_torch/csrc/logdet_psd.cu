// Batched log-determinant of symmetric positive (semi-)definite matrices.
//
// Replaces the TPU kernel `_logdet_kernel` / `logdet_psd_batched` of
// anticipated_vins_mono_tpu/ops/pallas_kernels.py: f32 [B,N,N] -> f32 [B],
// unpivoted elimination, sum of log(pivot), pivot floored at 1e-30 (a NaN
// pivot stays NaN).
//
// What bounds it on an H100: not bytes (each matrix is read once: 8.1 MB for
// 128 x 126 x 126, 2.4 us at 3.35 TB/s) and not operations (85 Mflop for the
// batch, 1.3 us at the f32 rate) but the chain of N dependent pivots. The
// first version paid a block barrier and a shared-memory round trip per
// column (1.8 us a step, 0.226 ms).
//
// Design. One block per matrix (128 blocks are one wave on 132 SMs), the
// matrix resident in dynamic shared memory, padded to a multiple of the panel
// width with identity rows (pivot 1, log 0), factored by the blocked LDL^T of
// blocked_ldl.cuh: the pivot chain runs inside one warp, in registers and
// shuffles, and the flops are register-tiled rank-NB updates. The sum of the
// logs, of the matrix's own rows only, is reduced once at the end.
//
// Two loaders fill shared memory, neither divides per element (one warp per
// row, one lane per segment):
//   plain   cp.async per 16-, 8- or 4-byte row segment, whatever the row
//           length allows (126 floats = 504 bytes: 8-byte segments). Chosen
//           over one cp.async.bulk per matrix because the shared rows are
//           padded (stride np + 4) for the factorization's 16-byte loads and
//           bank spread, and a 1-D bulk copy can only land a dense image.
//   affine  A = Om + scale_f * Deltas_f formed on the way in (product rounded,
//           then sum rounded: the bits the materialised expression has), so
//           the selector writes no [F,N,N] temporary per greedy round and
//           Deltas (8 MB) stays resident in the 50 MB L2 across the rounds.
//
// IEEE f32 on the CUDA cores; no TF32, no tensor cores: see blocked_ldl.cuh.
//
// Measured (one NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, [128,126,126],
// launches replayed from a CUDA graph, split from the clock64() stamps of
// block 0): 0.0227 ms against 0.2262 ms for the first version; load 11 %
// (2.5 us), factorization 88 % (20.0 us), final reduction under 1 %. Through
// the affine loader 0.0259 ms (load 3.5 us: register loads, four rows in
// flight per warp, instead of cp.async); materialising the sum first and then
// running the kernel costs 0.0359 ms.

#include "blocked_ldl.cuh"

namespace {

using namespace avm;

constexpr int kNB = 16;        // panel width of the factorization
constexpr int kTM = 4;         // rows of an update tile
constexpr int kThreads = 288;  // 160 to 512 change the time by < 5 %
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int padded_order(int n) {
  return (n + kNB - 1) / kNB * kNB;
}

template <typename VT>
__device__ __forceinline__ VT affine(VT o, VT d, float s);
template <>
__device__ __forceinline__ float affine<float>(float o, float d, float s) {
  return __fadd_rn(o, __fmul_rn(s, d));
}
template <>
__device__ __forceinline__ float2 affine<float2>(float2 o, float2 d, float s) {
  return make_float2(affine(o.x, d.x, s), affine(o.y, d.y, s));
}
template <>
__device__ __forceinline__ float4 affine<float4>(float4 o, float4 d, float s) {
  return make_float4(affine(o.x, d.x, s), affine(o.y, d.y, s),
                     affine(o.z, d.z, s), affine(o.w, d.w, s));
}

// A[r][c] = Om[r][c] + s * Dl[r][c], rows of stride lda in shared memory. A
// warp takes four rows at a time and issues all their loads before the first
// sum, so that enough bytes are in flight.
template <typename VT>
__device__ __forceinline__ void load_affine_v(float* A, int lda,
                                              const float* Om, const float* Dl,
                                              float s, int n) {
  constexpr int V = sizeof(VT) / sizeof(float);
  constexpr int kRows = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int segs = n / V;
  for (int r0 = warp * kRows; r0 < n; r0 += nwarps * kRows) {
    for (int q = lane; q < segs; q += 32) {
      VT o[kRows], d[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = min(r0 + u, n - 1);
        const size_t at = static_cast<size_t>(r) * n;
        o[u] = __ldg(reinterpret_cast<const VT*>(Om + at) + q);
        d[u] = __ldg(reinterpret_cast<const VT*>(Dl + at) + q);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (r0 + u < n)
          reinterpret_cast<VT*>(A + (r0 + u) * lda)[q] = affine<VT>(o[u], d[u], s);
    }
  }
}

template <bool kAffine>
__global__ void __launch_bounds__(kThreads)
logdet_psd_kernel(const float* __restrict__ M, const float* __restrict__ Deltas,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int n, long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded_order(n);
  const int lda = np + 4;
  float* A = smem;              // np rows of stride lda
  float* dinv = A + np * lda;   // np
  const int tid = threadIdx.x;
  stamp(stamps, 0);

  if (kAffine) {
    const float* Dl = Deltas + static_cast<size_t>(blockIdx.x) * n * n;
    const float s = scale[blockIdx.x];
    const int v = min(row_vector_width(M, n), row_vector_width(Dl, n));
    if (v == 4) load_affine_v<float4>(A, lda, M, Dl, s, n);
    else if (v == 2) load_affine_v<float2>(A, lda, M, Dl, s, n);
    else load_affine_v<float>(A, lda, M, Dl, s, n);
  } else {
    copy_rows_async(A, lda, M + static_cast<size_t>(blockIdx.x) * n * n, n, n);
    cp_async_commit();
  }
  // identity rows up to the padded order (lower triangle only is read)
  for (int r = n + (tid >> 5); r < np; r += blockDim.x >> 5)
    for (int c = tid & 31; c <= r; c += 32) A[r * lda + c] = (c == r) ? 1.0f : 0.0f;
  if (!kAffine) cp_async_wait<0>();
  __syncthreads();
  stamp(stamps, 1);

  float logacc = 0.0f;
  blocked_ldl_factor<kNB, kTM, kPivotFloor, true, false>(
      A, lda, np, n, dinv, nullptr, nullptr, logacc);
  stamp(stamps, 2);

  if (tid < 32) {
    for (int o = 16; o > 0; o >>= 1)
      logacc += __shfl_down_sync(kFullMask, logacc, o);
    if (tid == 0) out[blockIdx.x] = logacc;
  }
  stamp(stamps, 3);
}

int smem_bytes(int n) {
  const int np = padded_order(n);
  return (np * (np + 4) + np) * static_cast<int>(sizeof(float));
}

}  // namespace

// Shared memory one block needs for matrices of order n, in bytes.
extern "C" int avm_logdet_psd_smem_bytes(int n) { return smem_bytes(n); }

// Raises both kernels' dynamic shared-memory limit to what a block may have on
// an H100. Called once after the library is loaded; returns a CUDA error code.
extern "C" int avm_logdet_psd_init() {
  cudaError_t err = cudaFuncSetAttribute(
      logdet_psd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(logdet_psd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  return static_cast<int>(err);
}

// out[b] = logdet(M[b]). Launches on `stream`; returns cudaGetLastError()
// (0 = launched). `stamps`: null, or 4 clock64() values of block 0.
extern "C" int avm_logdet_psd_batched(const float* M, float* out, int batch,
                                      int n, long long* stamps, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  logdet_psd_kernel<false><<<batch, kThreads, smem_bytes(n),
                             static_cast<cudaStream_t>(stream)>>>(
      M, nullptr, nullptr, out, n, stamps);
  return static_cast<int>(cudaGetLastError());
}

// out[f] = logdet(Om + scale[f] * Deltas[f]). As above.
extern "C" int avm_logdet_psd_affine_batched(const float* Om,
                                             const float* Deltas,
                                             const float* scale, float* out,
                                             int batch, int n,
                                             long long* stamps, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  logdet_psd_kernel<true><<<batch, kThreads, smem_bytes(n),
                            static_cast<cudaStream_t>(stream)>>>(
      Om, Deltas, scale, out, n, stamps);
  return static_cast<int>(cudaGetLastError());
}
