// The window's factors on the device: the geometry of `ops/lie.py` and the
// projection and IMU residuals of `ops/factors.py`, generic over plain numbers
// and forward-mode dual numbers. Shared by normal_eq_fused.cu (the residuals
// and their tangent columns, linearized in registers) and lm_cost_fused.cu
// (the residuals at a candidate state, for the robust cost).
//
// How the plain arithmetic rounds is a policy, the first template argument of
// each function that has a choice:
//   Unfused    every product and sum rounded on its own, sums left to right
//              (normal_eq_fused.cu, built with -fmad=false);
//   TorchCuda  as PyTorch's CUDA kernels round the same expressions:
//              `torch.linalg.cross`'s a*b - c*d as fma(a, b, -(c*d)), and the
//              small sums over the last axis (`torch.sum`, the squares inside
//              `torch.linalg.norm`) in its reduction kernel's order
//              (`torch_sum`). With it a retraction equals `window.retract`
//              bit for bit, and a projection factor's cost
//              `window._cost_terms`'. The products of matrices (the IMU's bias
//              correction and whitening), which PyTorch hands to the CUDA
//              matrix library, are summed left to right under both
//              policies.
// Dual numbers take the Unfused rules: only normal_eq_fused.cu carries them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace avm {

constexpr double kFocal = 460.0 / 1.5;
constexpr double kGravity = 9.81007;

// ---------------------------------------------------------------------------
// Forward-mode dual numbers: a value and N tangents
// ---------------------------------------------------------------------------

template <typename T, int N>
struct Dual {
  T v;
  T t[N];
};

template <typename X> struct Traits { using scalar = X; static constexpr bool dual = false; };
template <typename T, int N> struct Traits<Dual<T, N>> {
  using scalar = T;
  static constexpr bool dual = true;
};

// the type of an operation on an A and a B: a dual if either is one
template <typename A, typename B> struct Promote { using type = A; };
template <typename T, int N> struct Promote<T, Dual<T, N>> { using type = Dual<T, N>; };
template <typename A, typename B> using Pr = typename Promote<A, B>::type;

template <typename T> __device__ __forceinline__ T val(T x) { return x; }
template <typename T, int N>
__device__ __forceinline__ T val(const Dual<T, N>& x) { return x.v; }

// a plain number as a dual with no tangent, or as itself
template <typename Out, typename T>
__device__ __forceinline__ Out lift(T x) {
  if constexpr (Traits<Out>::dual) {
    Out r;
    r.v = x;
#pragma unroll
    for (int k = 0; k < int(sizeof(r.t) / sizeof(T)); ++k) r.t[k] = T(0);
    return r;
  } else {
    return x;
  }
}
template <typename Out, typename T, int N>
__device__ __forceinline__ Out lift(const Dual<T, N>& x) { return x; }

// The derivatives follow PyTorch's forward-mode formulas for each operation,
// so that the tangent columns round as `torch.func.jvp`'s do:
//   a + b, a - b: a_t +- b_t;  a * b: b_t a + a_t b;  a / b: (a_t - b_t r) / b
// (r the quotient); with one operand plain, the term that has no tangent.
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = a.t[k] + b.t[k];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, T b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(T a, const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = a + b.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = -a.t[k];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = a.t[k] - b.t[k];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, T b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = -b.t[k];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = b.t[k] * a.v + a.t[k] * b.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, T b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = a.t[k] * b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = b.t[k] * a;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = (a.t[k] - b.t[k] * r.v) / b.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, T b) {
  Dual<T, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = a.t[k] / b;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = -(b.t[k] * r.v) / b.v;
  return r;
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return ::sqrt(x); }
__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }

// ---------------------------------------------------------------------------
// Rounding policies
// ---------------------------------------------------------------------------

struct Unfused {};
struct TorchCuda {};

// a*b - c*d, the value of one component of a cross product
template <typename R, typename T>
__device__ __forceinline__ T cross_value(T a, T b, T c, T d) {
  if constexpr (std::is_same_v<R, TorchCuda>) return fused(a, b, -(c * d));
  else return a * b - c * d;
}

// e[0] + ... + e[k-1] as PyTorch's CUDA reduction adds a contiguous last axis
// of k < 128 entries: w = min(2^floor(log2 k), 32) lanes, lane x summing
// e[x], e[x + w], ... in that order (each from zero), then the lanes folded
// with halving offsets, lane x taking lane x + off
template <typename T>
__device__ __forceinline__ T torch_sum(const T* e, int k) {
  int w = 1;
  while (2 * w <= k && w < 32) w *= 2;
  T lane[32];
  for (int x = 0; x < w; ++x) {
    T s = T(0) + e[x];
    for (int i = x + w; i < k; i += w) s = s + (T(0) + e[i]);
    lane[x] = s;
  }
  for (int off = w / 2; off > 0; off /= 2)
    for (int x = 0; x < off; ++x) lane[x] = lane[x] + lane[x + off];
  return lane[0];
}

// the sums of three and of four terms of the geometry (a dot product's, a
// quaternion's squared norm); TorchCuda's as `torch_sum` adds them
template <typename R, typename S>
__device__ __forceinline__ S sum3(S a, S b, S c) {
  if constexpr (std::is_same_v<R, TorchCuda>) return ((S(0) + a) + (S(0) + c)) + (S(0) + b);
  else return (a + b) + c;
}
template <typename R, typename S>
__device__ __forceinline__ S sum4(S a, S b, S c, S d) {
  if constexpr (std::is_same_v<R, TorchCuda>)
    return ((S(0) + a) + (S(0) + c)) + ((S(0) + b) + (S(0) + d));
  else return ((a + b) + c) + d;
}

// ‖q‖ of a quaternion: `torch.linalg.norm`, its tangent sum(q q_t) / ‖q‖
template <typename R = Unfused, typename S>
__device__ __forceinline__ S norm4(const S* q) {
  using T = typename Traits<S>::scalar;
  const T n = root(sum4<R>(val(q[0]) * val(q[0]), val(q[1]) * val(q[1]),
                           val(q[2]) * val(q[2]), val(q[3]) * val(q[3])));
  if constexpr (Traits<S>::dual) {
    S r;
    r.v = n;
#pragma unroll
    for (int k = 0; k < int(sizeof(r.t) / sizeof(T)); ++k)
      r.t[k] = (((q[0].v * q[0].t[k] + q[1].v * q[1].t[k]) + q[2].v * q[2].t[k]) +
                q[3].v * q[3].t[k]) / n;
    return r;
  } else {
    return n;
  }
}

// ---------------------------------------------------------------------------
// The geometry, generic over plain and dual operands (`ops/lie.py`)
// ---------------------------------------------------------------------------

// a x b, differentiated as `torch.linalg.cross`: a_t x b + a x b_t
template <typename R = Unfused, typename A, typename B>
__device__ __forceinline__ void cross(const A* a, const B* b, Pr<A, B>* out) {
  using T = typename Traits<Pr<A, B>>::scalar;
  constexpr bool da = Traits<A>::dual, db = Traits<B>::dual;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int i = (c + 1) % 3, j = (c + 2) % 3;
    const T v = cross_value<R>(val(a[i]), val(b[j]), val(a[j]), val(b[i]));
    if constexpr (da || db) {
      Pr<A, B>& r = out[c];
      r.v = v;
#pragma unroll
      for (int k = 0; k < int(sizeof(r.t) / sizeof(T)); ++k) {
        T ta = T(0), tb = T(0);
        if constexpr (da) ta = a[i].t[k] * val(b[j]) - a[j].t[k] * val(b[i]);
        if constexpr (db) tb = val(a[i]) * b[j].t[k] - val(a[j]) * b[i].t[k];
        if constexpr (da && db) r.t[k] = ta + tb;
        else if constexpr (da) r.t[k] = ta;
        else r.t[k] = tb;
      }
    } else {
      out[c] = v;
    }
  }
}

// v + 2 (w (u x v) + u x (u x v)), q = (w, u): `lie.quat_rotate`
template <typename R = Unfused, typename Q, typename V>
__device__ __forceinline__ void rotate(const Q* q, const V* v, Pr<Q, V>* out) {
  using P = Pr<Q, V>;
  using T = typename Traits<P>::scalar;
  P uv[3], uuv[3];
  cross<R>(q + 1, v, uv);
  cross<R>(q + 1, uv, uuv);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = v[c] + T(2) * (q[0] * uv[c] + uuv[c]);
}

// q (x) p in scalar/vector form: `lie.quat_mul`
template <typename R = Unfused, typename Q, typename P>
__device__ __forceinline__ void quat_mul(const Q* q, const P* p, Pr<Q, P>* out) {
  using O = Pr<Q, P>;
  O c[3];
  cross<R>(q + 1, p + 1, c);
  out[0] = q[0] * p[0] - sum3<R, O>(q[1] * p[1], q[2] * p[2], q[3] * p[3]);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[1 + k] = (q[0] * p[1 + k] + p[0] * q[1 + k]) + c[k];
}

template <typename S>
__device__ __forceinline__ void conj(const S* q, S* out) {
  out[0] = q[0];
#pragma unroll
  for (int c = 1; c < 4; ++c) out[c] = -q[c];
}

// q / ‖q‖: `lie.quat_normalize`
template <typename R = Unfused, typename S>
__device__ __forceinline__ void normalize(S* q) {
  const S n = norm4<R>(q);
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = q[c] / n;
}

// ---------------------------------------------------------------------------
// The factors (`ops/factors.py`)
// ---------------------------------------------------------------------------

// `projection_residual`: the landmark at inverse depth rho along pt_i of the
// anchor's camera, carried into frame j's camera, against pt_j, whitened. The
// observations may be duals (the time offset's tangent, `proj_factor_td`).
template <typename R = Unfused, typename A, typename J, typename E, typename Rh, typename Pi,
          typename Pj>
__device__ __forceinline__ void proj_residual(
    const A* pa, const A* qa, const J* pj, const J* qj, const E* tic,
    const E* qic, const Rh& rho, const Pi* pt_i, const Pj* pt_j,
    Pr<Pj, Pr<E, Pr<J, Pr<A, Pr<E, Pr<Pi, Rh>>>>>>* r) {
  using T = typename Traits<Pj>::scalar;
  using C0 = Pr<Pi, Rh>;
  using C1 = Pr<E, C0>;
  using C2 = Pr<A, C1>;
  using C3 = Pr<J, C2>;
  using C4 = Pr<E, C3>;
  C0 cam_i[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) cam_i[c] = pt_i[c] / rho;
  C1 imu_i[3];
  rotate<R>(qic, cam_i, imu_i);
#pragma unroll
  for (int c = 0; c < 3; ++c) imu_i[c] = imu_i[c] + tic[c];
  C2 w[3];
  rotate<R>(qa, imu_i, w);
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = w[c] + pa[c];
  J qjc[4];
  conj(qj, qjc);
  C3 d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = w[c] - pj[c];
  C3 imu_j[3];
  rotate<R>(qjc, d, imu_j);
  E qicc[4];
  conj(qic, qicc);
  C4 e[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) e[c] = imu_j[c] - tic[c];
  C4 cam_j[3];
  rotate<R>(qicc, e, cam_j);
  C4 z = cam_j[2];
  if (fabs(val(z)) < T(1e-9)) z = lift<C4>(T(1e-9));
#pragma unroll
  for (int c = 0; c < 2; ++c) r[c] = (cam_j[c] / z - pt_j[c]) * T(kFocal);
}

// The constants of one observation under the time offset and the rolling
// shutter (`factors.projection_td_residual_raw`): its image velocity, td at
// its frame's capture, and TR / ROW, fy and cy - ROW / 2 of the row recovery
template <typename T>
struct TdObs {
  const T* vel;
  T td_k, tr_over_row, row_fy, row_c0;
};

// The observation shifted along its image velocity by (td - td_k) +
// TR / ROW * row, the row recovered from its own y as row_fy y + row_c0:
// `pt - shift * [vel, 0]` with each product and sum rounded on its own. `td`
// may be a dual (its tangent that of the time offset).
template <typename S, typename T>
__device__ __forceinline__ void td_shift(const T* pt, const TdObs<T>& o, const S& td,
                                         S* out) {
  const T row = o.row_fy * pt[1] + o.row_c0;
  const S shift = (td - o.td_k) + o.tr_over_row * row;
#pragma unroll
  for (int c = 0; c < 2; ++c) out[c] = pt[c] - shift * o.vel[c];
  out[2] = pt[2] - shift * T(0);
}

// one pair's preintegrated measurement (`preintegration.Preintegrated`)
template <typename T>
struct Pre {
  const T *dp, *dq, *dv, *J, *ba, *bg;
  T dt;
};

// `imu_residual_raw`: the bias-corrected deltas (`corrected_deltas`) against
// the state's (the whitening by S is a product the caller takes).
// sb = (v, ba, bg) of each frame.
template <typename R = Unfused, typename Pi, typename Si, typename Pj, typename Sj, typename T>
__device__ __forceinline__ void imu_residual(
    const Pi* pi, const Pi* qi, const Si* sbi, const Pj* pj, const Pj* qj,
    const Sj* sbj, const Pre<T>& pre, Pr<Pr<Pr<Pi, Si>, Pj>, Sj>* out) {
  using Out = Pr<Pr<Pr<Pi, Si>, Pj>, Sj>;
  const T* Jm = pre.J;
  Si dba[3], dbg[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dba[c] = sbi[3 + c] - pre.ba[c];
    dbg[c] = sbi[6 + c] - pre.bg[c];
  }
  // J's blocks times the bias offsets, as `J[..., r0:r1, c0:c1] @ d`
  auto mv = [&](int row, int col, const Si* x) {
    return (Jm[row * 15 + col] * x[0] + Jm[row * 15 + col + 1] * x[1]) +
           Jm[row * 15 + col + 2] * x[2];
  };
  Si dp[3], dv[3], dq[4], small[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dp[c] = pre.dp[c] + (mv(c, 9, dba) + mv(c, 12, dbg));
    dv[c] = pre.dv[c] + (mv(6 + c, 9, dba) + mv(6 + c, 12, dbg));
  }
  // delta_q(theta) = normalize([1, theta / 2])
  small[0] = lift<Si>(T(1));
#pragma unroll
  for (int c = 0; c < 3; ++c) small[1 + c] = T(0.5) * mv(3 + c, 12, dbg);
  normalize<R>(small);
  const T pdq[4] = {pre.dq[0], pre.dq[1], pre.dq[2], pre.dq[3]};
  quat_mul<R>(pdq, small, dq);
  normalize<R>(dq);

  const T dt = pre.dt;
  Pi qii[4];
  conj(qi, qii);
  // 0.5 g dt dt + p_j - p_i - v_i dt and g dt + v_j - v_i, left to right
  using AP = Pr<Pr<Pj, Pi>, Si>;
  using AV = Pr<Sj, Si>;
  AP ap[3];
  AV av[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T gc = c == 2 ? T(kGravity) : T(0);
    const T half_gtt = ((T(0.5) * gc) * dt) * dt;
    ap[c] = lift<AP>((half_gtt + pj[c]) - pi[c]) - sbi[c] * dt;
    av[c] = (gc * dt + sbj[c]) - sbi[c];
  }
  Out* r = out;
  Pr<Pi, AP> rp[3];
  Pr<Pi, AV> rv[3];
  rotate<R>(qii, ap, rp);
  rotate<R>(qii, av, rv);
  Si dqc[4];
  conj(dq, dqc);
  Pr<Pi, Pj> qq[4];
  quat_mul<R>(qii, qj, qq);
  Pr<Si, Pr<Pi, Pj>> rq[4];
  quat_mul<R>(dqc, qq, rq);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = lift<Out>(rp[c] - dp[c]);
    r[3 + c] = lift<Out>(T(2) * rq[1 + c]);
    r[6 + c] = lift<Out>(rv[c] - dv[c]);
    r[9 + c] = lift<Out>(sbj[3 + c] - sbi[3 + c]);
    r[12 + c] = lift<Out>(sbj[6 + c] - sbi[6 + c]);
  }
}

}  // namespace avm
