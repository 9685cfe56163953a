// IMU preintegration of a batch of frame pairs: the whole midpoint scan of a
// `preintegrate` call, with its whitening tail, in one launch.
//
// Replaces no TPU kernel. The JAX package preintegrates with a lax.scan over
// the samples of one pair, vmapped over pairs
// (anticipated_vins_mono_tpu/ops/preintegration.py, `preintegrate`); the port
// ran it as a Python loop over the padded samples
// (ops/preintegration.preintegrate_plain), ~217 small launches a sample and
// 64 samples a call, two calls a keyframe frame. That loop stays as the
// plain version, and as the path for CPU tensors.
//
// What bounds it on an H100: neither bytes (~45 KB a call at [10, 64]
// float32, 0.01 us at 3.35 TB/s) nor operations (~0.2 Mflop a pair) but the
// chain of dependent steps: each sample's Jacobian and covariance need the
// previous sample's, ~20 real samples a pair at 200 Hz over a 10 Hz frame.
// The design answers with few barriers a step and nothing sent to device
// memory before the end:
//   - one block per pair (the leading dimensions flattened into the grid);
//     the carry lives in shared memory and registers for the whole scan;
//   - per chunk of 32 samples, everything that does not depend on the
//     covariance is done for all its samples at once: the quaternion chain
//     (one thread, the only serial part), then F's and V's 3x3 blocks from
//     R0, R1 and the skews, one thread per (sample, block entry);
//   - per sample, two barriers: T1 = F.P and F.J (one thread per output
//     entry), then P <- T1.F^T + s.V.Q.V^T, each thread with its rows of F
//     and V in registers (the zeros in them add exact zeros); Q is the
//     diagonal of `ImuNoise.noise_cov18` passed by value;
//   - the scan stops after the last row whose dt is not 0 (found by the
//     block, no host read): later rows only renormalise dq, which is done
//     until it stops changing, so the 64-step loop's result is kept;
//   - the tail in the same launch: the Cholesky factor of P + 1e-11 I (one
//     warp; a pivot that is not positive makes the whole factor NaN, as
//     `lie.cholesky_or_nan`) and its inverse S by forward substitution.
// Every product is summed in the working type (float32 or float64, one
// template), as the loop does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // samples whose F and V blocks are built at once
constexpr int kLd = 16;     // row stride of the 15x15 matrices in shared memory
constexpr int kNxn = 15 * 15;

// the 3x3 blocks of F and V kept per sample (row-major, 9 entries each);
// F's dt.I, -dt.I and I blocks and V's 0.5dt.I and dt.I blocks are scalars
enum Block { PQ, PBA, PBG, QQ, VQ, VBA, VBG, VP0, VPQ, VP1, VV0, VVQ, VV1,
             kBlocks };

template <typename T>
struct Args {
  const T *dts, *accs, *gyrs, *acc0, *gyr0, *ba, *bg;
  T *dp, *dq, *dv, *J, *P, *dt_sum, *S;
  int n;
  bool with_cov;
  T q[18];  // the diagonal of the noise covariance Q
  T dt_ref;
};

template <typename T>
struct Smem {
  T P[15 * kLd], J[15 * kLd], T1[15 * kLd];
  T blk[kChunk][kBlocks * 9];
  T dt[kChunk], s[kChunk];  // each sample's dt and noise scale
  T dq[kChunk][4];          // each sample's delta_q
  T q[kChunk + 1][4];       // the orientation before each sample, and after
  T w[kChunk][3];           // un_gyr
  T a0[kChunk][3], a1[kChunk][3];  // acc - ba at the start and end
  T uacc[kChunk][3];
  int last;
};

// the working type's fused multiply-add and square root, IEEE-rounded
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return ::fma(a, b, c);
}
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return ::sqrt(x); }

template <typename T> __device__ __forceinline__ T qnan();
template <> __device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__device__ __forceinline__ void normalize(T* q) {
  const T n = root(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int c = 0; c < 4; ++c) q[c] = q[c] / n;
}

// v + 2 (w (u x v) + u x (u x v)), q = (w, u): `lie.quat_rotate`
template <typename T>
__device__ __forceinline__ void rotate(const T* q, const T* v, T* out) {
  const T uv[3] = {q[2] * v[2] - q[3] * v[1], q[3] * v[0] - q[1] * v[2],
                   q[1] * v[1] - q[2] * v[0]};
  const T uuv[3] = {q[2] * uv[2] - q[3] * uv[1], q[3] * uv[0] - q[1] * uv[2],
                    q[1] * uv[1] - q[2] * uv[0]};
  for (int c = 0; c < 3; ++c) out[c] = v[c] + T(2) * (q[0] * uv[c] + uuv[c]);
}

// row r of the rotation matrix of unit quaternion q: `lie.quat_to_rot`
template <typename T>
__device__ __forceinline__ void rot_row(const T* q, int r, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  if (r == 0) {
    R[0] = T(1) - T(2) * (y * y + z * z);
    R[1] = T(2) * (x * y - w * z);
    R[2] = T(2) * (x * z + w * y);
  } else if (r == 1) {
    R[0] = T(2) * (x * y + w * z);
    R[1] = T(1) - T(2) * (x * x + z * z);
    R[2] = T(2) * (y * z - w * x);
  } else {
    R[0] = T(2) * (x * z - w * y);
    R[1] = T(2) * (y * z + w * x);
    R[2] = T(1) - T(2) * (x * x + y * y);
  }
}

// entry (m, c) of skew(v)
template <typename T>
__device__ __forceinline__ T skew(const T* v, int m, int c) {
  if (m == c) return T(0);
  const int k = 3 - m - c;  // the third axis
  const T s = v[k];
  return ((m + 1) % 3 == c) ? -s : s;
}

// Row i of F (block rows p, theta, v, ba, bg) into registers, from the
// sample's blocks: [I, f_pq, dt I, f_pba, f_pbg], [0, f_qq, 0, 0, -dt I],
// [0, f_vq, I, f_vba, f_vbg], then the bias rows of I. A thread takes its
// rows once a step, so the warp's branches on the row block are paid once
// and the products below run without them; the zeros they keep add exact
// zeros. (Constant register indices only: the arrays stay in registers.)
template <typename T>
__device__ __forceinline__ void f_row(const T* b, T dt, int i, T* f) {
  const int r = i % 3, rb = i / 3;
  const T* mid = b + (rb == 0 ? PQ : rb == 1 ? QQ : VQ) * 9 + r * 3;
  const T* bias_a = b + (rb == 0 ? PBA : VBA) * 9 + r * 3;
  const T* bias_g = b + (rb == 0 ? PBG : VBG) * 9 + r * 3;
  const bool pv = rb == 0 || rb == 2;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    f[m] = rb == 0 && m == r ? T(1) : T(0);
    f[3 + m] = rb < 3 ? mid[m] : T(0);
    f[6 + m] = m != r ? T(0) : rb == 0 ? dt : rb == 2 ? T(1) : T(0);
    f[9 + m] = pv ? bias_a[m] : rb == 3 && m == r ? T(1) : T(0);
    f[12 + m] = pv ? bias_g[m]
                   : m != r ? T(0) : rb == 1 ? -dt : rb == 4 ? T(1) : T(0);
  }
}

// Row i of V (columns in threes: na0, ng0, na1, ng1, nba, nbg) into
// registers: [v_p0, v_pq, v_p1, v_pq, 0, 0], [0, dt/2 I, 0, dt/2 I, 0, 0],
// [v_v0, v_vq, v_v1, v_vq, 0, 0], [0, 0, 0, 0, dt I, 0], [0, .., dt I].
template <typename T>
__device__ __forceinline__ void v_row(const T* b, T dt, int i, T* v) {
  const int r = i % 3, rb = i / 3;
  const bool pv = rb == 0 || rb == 2;
  const T* v0 = b + (rb == 0 ? VP0 : VV0) * 9 + r * 3;
  const T* vq = b + (rb == 0 ? VPQ : VVQ) * 9 + r * 3;
  const T* v1 = b + (rb == 0 ? VP1 : VV1) * 9 + r * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T d = c == r ? dt : T(0);
    v[c] = pv ? v0[c] : T(0);
    v[3 + c] = v[9 + c] = pv ? vq[c] : rb == 1 ? T(0.5) * d : T(0);
    v[6 + c] = pv ? v1[c] : T(0);
    v[12 + c] = rb == 3 ? d : T(0);
    v[15 + c] = rb == 4 ? d : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
preint_scan_kernel(const Args<T> args) {
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x;
  const int n = args.n;
  const size_t pair = blockIdx.x;
  const T* dts = args.dts + pair * n;
  const T* accs = args.accs + pair * n * 3;
  const T* gyrs = args.gyrs + pair * n * 3;
  const T* ba = args.ba + pair * 3;
  const T* bg = args.bg + pair * 3;
  const T* acc0 = args.acc0 + pair * 3;
  const T* gyr0 = args.gyr0 + pair * 3;

  // the carry: J = I, P = 0; the last row whose dt is not 0
  if (tid == 0) sm.last = -1;
  for (int t = tid; t < kNxn; t += kThreads) {
    const int i = t / 15, j = t % 15;
    sm.J[i * kLd + j] = i == j ? T(1) : T(0);
    sm.P[i * kLd + j] = T(0);
  }
  __syncthreads();
  for (int k = tid; k < n; k += kThreads)
    if (dts[k] != T(0)) atomicMax(&sm.last, k);
  __syncthreads();
  const int rows = sm.last + 1;

  // registers of the state chains: q (thread 0), dp/dv (threads 0-2, one
  // axis each), dt_sum (thread 3)
  T qc[4] = {T(1), T(0), T(0), T(0)};
  T dpc = T(0), dvc = T(0), dtc = T(0);

  for (int c0 = 0; c0 < rows; c0 += kChunk) {
    const int kc = min(kChunk, rows - c0);
    // 1. per sample: dt, noise scale, un_gyr, delta_q, acc - ba
    for (int k = tid; k < kc; k += kThreads) {
      const int g = c0 + k;
      const T dt = dts[g];
      const T* g0 = g == 0 ? gyr0 : gyrs + (g - 1) * 3;
      const T* a0 = g == 0 ? acc0 : accs + (g - 1) * 3;
      T dq[4] = {T(1), T(0), T(0), T(0)};
      for (int c = 0; c < 3; ++c) {
        const T w = T(0.5) * (g0[c] + gyrs[g * 3 + c]) - bg[c];
        sm.w[k][c] = w;
        dq[1 + c] = T(0.5) * (w * dt);
        sm.a0[k][c] = a0[c] - ba[c];
        sm.a1[k][c] = accs[g * 3 + c] - ba[c];
      }
      normalize(dq);
      for (int c = 0; c < 4; ++c) sm.dq[k][c] = dq[c];
      T r = dt / args.dt_ref;
      r = r < T(1) ? T(1) : r;  // clamp(min=1); a NaN stays NaN
      sm.dt[k] = dt;
      sm.s[k] = r * r;
    }
    __syncthreads();
    // 2. the quaternion chain: q_{k+1} = normalize(q_k (x) delta_q_k)
    if (tid == 0) {
      for (int c = 0; c < 4; ++c) sm.q[0][c] = qc[c];
      for (int k = 0; k < kc; ++k) {
        const T* p = sm.dq[k];
        const T w = qc[0] * p[0] - (qc[1] * p[1] + qc[2] * p[2] + qc[3] * p[3]);
        T v[3];
        v[0] = qc[0] * p[1] + p[0] * qc[1] + (qc[2] * p[3] - qc[3] * p[2]);
        v[1] = qc[0] * p[2] + p[0] * qc[2] + (qc[3] * p[1] - qc[1] * p[3]);
        v[2] = qc[0] * p[3] + p[0] * qc[3] + (qc[1] * p[2] - qc[2] * p[1]);
        qc[0] = w;
        for (int c = 0; c < 3; ++c) qc[1 + c] = v[c];
        normalize(qc);
        for (int c = 0; c < 4; ++c) sm.q[k + 1][c] = qc[c];
      }
    }
    __syncthreads();
    // 3. per (sample, block entry): the blocks of F and V; per sample the
    // mean rotated acceleration
    for (int t = tid; args.with_cov && t < kc * 9; t += kThreads) {
      const int k = t / 9, r = (t % 9) / 3, c = t % 3;
      const T dt = sm.dt[k];
      T R0[3], R1[3];
      rot_row(sm.q[k], r, R0);
      rot_row(sm.q[k + 1], r, R1);
      T A0 = T(0), A1[3], G[3];
      for (int m = 0; m < 3; ++m) A0 = mad(R0[m], skew(sm.a0[k], m, c), A0);
      for (int e = 0; e < 3; ++e) {
        A1[e] = T(0);
        for (int m = 0; m < 3; ++m)
          A1[e] = mad(R1[m], skew(sm.a1[k], m, e), A1[e]);
        // (I - [w]x dt)[e][c]
        G[e] = (e == c ? T(1) : T(0)) - skew(sm.w[k], e, c) * dt;
      }
      T A1G = T(0);
      for (int e = 0; e < 3; ++e) A1G = mad(A1[e], G[e], A1G);
      const T A1c = A1[c];
      const T R01 = R0[c] + R1[c];
      T* b = sm.blk[k] + r * 3 + c;
      b[PQ * 9] = T(-0.25) * (A0 * dt * dt) + T(-0.25) * (A1G * dt * dt);
      b[PBA * 9] = T(-0.25) * R01 * dt * dt;
      b[PBG * 9] = T(0.25) * (A1c * dt * dt * dt);
      b[QQ * 9] = G[r];  // column c of (I - [w]x dt), row r
      b[VQ * 9] = T(-0.5) * (A0 * dt) + T(-0.5) * (A1G * dt);
      b[VBA * 9] = T(-0.5) * R01 * dt;
      b[VBG * 9] = T(0.5) * (A1c * dt * dt);
      b[VP0 * 9] = T(0.25) * R0[c] * dt * dt;
      b[VPQ * 9] = T(-0.125) * (A1c * dt * dt * dt);
      b[VP1 * 9] = T(0.25) * R1[c] * dt * dt;
      b[VV0 * 9] = T(0.5) * R0[c] * dt;
      b[VVQ * 9] = T(-0.25) * (A1c * dt * dt);
      b[VV1 * 9] = T(0.5) * R1[c] * dt;
    }
    for (int k = tid; k < kc; k += kThreads) {
      T u0[3], u1[3];
      rotate(sm.q[k], sm.a0[k], u0);
      rotate(sm.q[k + 1], sm.a1[k], u1);
      for (int c = 0; c < 3; ++c) sm.uacc[k][c] = T(0.5) * (u0[c] + u1[c]);
    }
    __syncthreads();
    // 4. per sample: J <- F J, P <- F P F^T + s V Q V^T; the dp/dv chain
    const int i = tid / 15, j = tid % 15;
    for (int k = 0; k < kc; ++k) {
      const T* b = sm.blk[k];
      const T dt = sm.dt[k];
      T jn = T(0);
      if (args.with_cov && tid < kNxn) {
        T f[15];
        f_row(b, dt, i, f);
        T a = f[0] * sm.P[j], aj = f[0] * sm.J[j];
#pragma unroll
        for (int m = 1; m < 15; ++m) {
          a = mad(f[m], sm.P[m * kLd + j], a);
          aj = mad(f[m], sm.J[m * kLd + j], aj);
        }
        sm.T1[i * kLd + j] = a;
        jn = aj;  // F J; rows 9-14 stay the identity's
      }
      if (tid < 3) {
        const T ua = sm.uacc[k][tid];
        dpc = dpc + dvc * dt + T(0.5) * ua * dt * dt;
        dvc = dvc + ua * dt;
      } else if (tid == 3) {
        dtc = dtc + dt;
      }
      if (!args.with_cov) continue;
      __syncthreads();
      if (tid < kNxn) {
        T f[15], vi[18], vj[18];
        f_row(b, dt, j, f);
        v_row(b, dt, i, vi);
        v_row(b, dt, j, vj);
        const T* t1 = sm.T1 + i * kLd;
        T fpf = t1[0] * f[0], vqv = (vi[0] * args.q[0]) * vj[0];
#pragma unroll
        for (int m = 1; m < 15; ++m) fpf = mad(t1[m], f[m], fpf);
#pragma unroll
        for (int m = 1; m < 18; ++m) vqv = mad(vi[m] * args.q[m], vj[m], vqv);
        sm.P[i * kLd + j] = fpf + sm.s[k] * vqv;
        if (i < 9) sm.J[i * kLd + j] = jn;
      }
      __syncthreads();
    }
    __syncthreads();  // the next chunk overwrites the sample buffers
  }

  // rows after the last nonzero dt: dq <- normalize(dq ⊗ [1,0,0,0]), which
  // is normalize(dq), until it no longer changes
  if (tid == 0) {
    for (int k = rows; k < n; ++k) {
      T q2[4] = {qc[0], qc[1], qc[2], qc[3]};
      normalize(q2);
      if (q2[0] == qc[0] && q2[1] == qc[1] && q2[2] == qc[2] && q2[3] == qc[3])
        break;
      for (int c = 0; c < 4; ++c) qc[c] = q2[c];
    }
    for (int c = 0; c < 4; ++c) args.dq[pair * 4 + c] = qc[c];
  }
  if (tid == 3) args.dt_sum[pair] = dtc;
  if (tid < 3) {
    args.dp[pair * 3 + tid] = dpc;
    args.dv[pair * 3 + tid] = dvc;
  }
  for (int t = tid; t < kNxn; t += kThreads) {
    const int i = t / 15, j = t % 15;
    args.J[pair * kNxn + t] = sm.J[i * kLd + j];
    args.P[pair * kNxn + t] = sm.P[i * kLd + j];
  }
  if (!args.with_cov || tid >= 32) return;

  // the tail, one warp: L = chol(P + 1e-11 I) by columns, lane i owning row
  // i; then S = L^-1, lane j owning column j
  const int lane = tid;
  T* L = sm.T1;
  T* Sb = &sm.blk[0][0];  // 240 of the chunk buffer's kChunk * 117 entries
  for (int t = lane; t < kNxn; t += 32) {
    const int i = t / 15, j = t % 15;
    if (j <= i) L[i * kLd + j] = sm.P[i * kLd + j] + (i == j ? T(1e-11) : T(0));
  }
  __syncwarp();
  bool ok = true;
  for (int j = 0; j < 15; ++j) {
    T s = T(0);
    if (lane >= j && lane < 15) {
      s = L[lane * kLd + j];
      for (int k = 0; k < j; ++k)
        s = mad(-L[lane * kLd + k], L[j * kLd + k], s);
    }
    const T d = __shfl_sync(0xffffffffu, s, j);
    ok = ok && d > T(0);  // a NaN pivot fails too
    const T ljj = root(d);
    __syncwarp();
    if (lane == j) L[j * kLd + j] = ljj;
    else if (lane > j && lane < 15) L[lane * kLd + j] = s / ljj;
    __syncwarp();
  }
  if (lane < 15) {
    const int j = lane;
    for (int i = 0; i < 15; ++i) {
      T a = T(0);
      if (i >= j) {
        a = i == j ? T(1) : T(0);
        for (int k = j; k < i; ++k)
          a = mad(-L[i * kLd + k], Sb[k * kLd + j], a);
        a = a / L[i * kLd + i];
      }
      Sb[i * kLd + j] = ok ? a : qnan<T>();
    }
  }
  __syncwarp();
  for (int t = lane; t < kNxn; t += 32)
    args.S[pair * kNxn + t] = Sb[(t / 15) * kLd + t % 15];
}

template <typename T>
int launch(const void* const* in, void* const* out, int batch, int n,
           int with_cov, const double* noise_var, double dt_ref,
           void* stream) {
  Args<T> a;
  a.dts = static_cast<const T*>(in[0]);
  a.accs = static_cast<const T*>(in[1]);
  a.gyrs = static_cast<const T*>(in[2]);
  a.acc0 = static_cast<const T*>(in[3]);
  a.gyr0 = static_cast<const T*>(in[4]);
  a.ba = static_cast<const T*>(in[5]);
  a.bg = static_cast<const T*>(in[6]);
  a.dp = static_cast<T*>(out[0]);
  a.dq = static_cast<T*>(out[1]);
  a.dv = static_cast<T*>(out[2]);
  a.J = static_cast<T*>(out[3]);
  a.P = static_cast<T*>(out[4]);
  a.dt_sum = static_cast<T*>(out[5]);
  a.S = static_cast<T*>(out[6]);
  a.n = n;
  a.with_cov = with_cov != 0;
  for (int m = 0; m < 18; ++m) a.q[m] = static_cast<T>(noise_var[m]);
  a.dt_ref = static_cast<T>(dt_ref);
  preint_scan_kernel<T><<<batch, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Loads both instances (float32, float64) now rather than at their first
// launch inside a frame. Called once after the library is loaded; returns a
// CUDA error code.
extern "C" int avm_preint_scan_init() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, preint_scan_kernel<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaFuncGetAttributes(&attr, preint_scan_kernel<double>));
}

// Preintegrates `batch` pairs of `n` samples each: inputs dts [batch, n],
// accs, gyrs [batch, n, 3], acc0, gyr0, ba, bg [batch, 3]; outputs dp, dv
// [batch, 3], dq [batch, 4], J, P [batch, 15, 15], dt_sum [batch], S [batch,
// 15, 15] (not written without the covariance), all contiguous, of one type:
// float64 if `f64`, else float32. `noise_var`: the 18 variances of the
// noise covariance's diagonal (host memory, read before the launch);
// `dt_ref`: the sample period they assume. Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int avm_preint_scan(const void* dts, const void* accs,
                               const void* gyrs, const void* acc0,
                               const void* gyr0, const void* ba,
                               const void* bg, void* dp, void* dq, void* dv,
                               void* J, void* P, void* dt_sum, void* S,
                               int batch, int n, int with_cov, int f64,
                               const double* noise_var, double dt_ref,
                               void* stream) {
  if (batch <= 0) return 0;
  const void* in[7] = {dts, accs, gyrs, acc0, gyr0, ba, bg};
  void* out[7] = {dp, dq, dv, J, P, dt_sum, S};
  return f64 ? launch<double>(in, out, batch, n, with_cov, noise_var, dt_ref,
                              stream)
             : launch<float>(in, out, batch, n, with_cov, noise_var, dt_ref,
                             stream);
}
