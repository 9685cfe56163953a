// Batched log-determinant of symmetric positive (semi-)definite matrices.
//
// Replaces the TPU kernel `_logdet_kernel` / `logdet_psd_batched` of
// anticipated_vins_mono_tpu/ops/pallas_kernels.py: f32 [B,N,N] -> f32 [B],
// unpivoted right-looking elimination, sum of log(pivot), pivot floored at
// 1e-30.
//
// Design for Hopper. One thread block per matrix; the matrix sits in shared
// memory with an odd row stride, so that a walk down a column touches 32
// different banks. Only the lower triangle is eliminated (half the work of
// the full rank-1 update). At step j every warp takes whole rows r > j and
// its lanes the columns j < c <= r; one __syncthreads() per column. Nothing
// of what the TPU needed is kept: no padding of N to 128, no identity
// matrices to fill a batch tile, no masked reduce to read a column.
//
// What bounds it: not bytes (each matrix is read once: B*N*N*4 bytes, 8.1 MB
// for 128 x 126 x 126) and not operations (B*N^3/3 flop), but the chain of N
// dependent column steps, each a barrier plus a shared-memory round trip.
// With B = 128 the launch is a single wave on 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
logdet_psd_kernel(const float* __restrict__ M, float* __restrict__ out,
                  int n, int lda) {
  extern __shared__ float A[];  // n rows of stride lda
  const float* src = M + static_cast<size_t>(blockIdx.x) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n;
    const int c = idx - r * n;
    A[r * lda + c] = src[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    float d = A[j * lda + j];
    d = (d < 1e-30f) ? 1e-30f : d;  // floor; a NaN pivot stays NaN
    if (threadIdx.x == 0) acc += logf(d);
    const float inv_d = 1.0f / d;
    for (int r = j + 1 + warp; r < n; r += nwarps) {
      const float lr = A[r * lda + j] * inv_d;
      for (int c = j + 1 + lane; c <= r; c += 32) {
        A[r * lda + c] -= lr * A[c * lda + j];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

// Shared memory one block needs for matrices of order n, in bytes.
extern "C" int avm_logdet_psd_smem_bytes(int n) {
  return n * (n | 1) * static_cast<int>(sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int avm_logdet_psd_batched(const float* M, float* out, int batch,
                                      int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int lda = n | 1;
  const int smem = avm_logdet_psd_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      logdet_psd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  logdet_psd_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(M, out, n, lda);
  return static_cast<int>(cudaGetLastError());
}
