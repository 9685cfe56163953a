// The cost phase of one Levenberg-Marquardt iteration of the window solve, for
// a batch of scenarios, in one launch: the step sanitized, the candidate
// retracted, the robust cost at the candidate, the accept / reject decision,
// the damping's update and the next iterate (`window._lm_cost_plain`).
//
// Replaces no Pallas kernel. The JAX package's `robust_cost` and its blend
// run inside the solve's `lax.scan`, compiled by XLA
// (anticipated_vins_mono_tpu/ops/window.py); the port ran the same chain as
// ~394 small PyTorch launches an iteration, and a host synchronisation for
// the gravity vector (ops/window._lm_cost_plain, which stays the plain
// version and the path for CPU tensors).
//
// Modes, per scenario (one block of 256 threads):
//   step      the step (dx, d_rho, pred) is finite when all of it is; its
//             non-finite entries become 0. The candidate x [+] dx
//             (`window.retract`: every pose and the extrinsic by
//             `lie.pose_boxplus`, speeds, biases and td added, inverse
//             depths clamped at min_inv_depth) goes to shared memory. Then
//             its robust cost; ok = cost(candidate) < cost & pred > 0 &
//             finite; the gain ratio, the damping's update ("halving" or
//             "nielsen") clamped to [1e-12, 1e8], the next cost; the next
//             iterate ok * candidate + (1 - ok) * iterate, the plain
//             version's blend computed as it is (so bit for bit, NaN and
//             signed zeros included), its quaternions renormalised;
//   evaluate  the cost at the state as given, and where asked the closing
//             diagnostics (`window.imu_chi2_mean`, `window.prior_chi2`);
//   retract   the candidate and its cost, no decision (for the tests).
// Nothing is written into the inputs: every output is a tensor of its own,
// in the launchers' [B, ...] layout. A solve that estimates the time offset td
// takes the second instance, `lm_cost_fused_td_kernel`, whose projection
// factors shift each observation along its image velocity by (td - td_k) +
// TR / ROW * row at x's td first (`factors.projection_td_residual`).
//
// The cost is `window._cost_terms` summed: each projection factor's Cauchy
// cost with `feat_w` and the validity mask, each IMU pair's whitened
// residual by `pre_valid` (gravity a constant), the prior r0 + J0 (x [-]
// x_lin) by its weight, the gauge anchor with `pin_rp`, the ZUPT rows where
// their weights are given. Each term is formed in the state's type, with
// PyTorch's rounding where its CUDA kernels' is known (window_factors.cuh's
// TorchCuda policy, and built with -fmad=false); the matrix products, which
// PyTorch hands to the CUDA matrix library (the IMU's bias correction and
// whitening, J0's product, the anchor's rotation), are summed left to right. The terms are summed in
// float64, as `robust_cost` sums them: LM's decision compares costs ~1e-7
// apart. The order is fixed (a thread's terms in order, then the warps'
// butterflies, then the warps in order), so a launch is deterministic
// without atomics.
//
// Bytes and operations at the flagship shape (NF = 11, F = 128, D = 178),
// float32, per scenario: reads the prior's J0 (126 KB) once, ~40 KB of the
// other inputs and the step; writes ~1 KB. Work: 1,408 projection factors x
// ~330 flop (four rotations, the divisions, the Cauchy cost's log1p), 10 IMU
// pairs x ~900 and their whitening, J0's product 2 x 178 x 178; about 0.6
// Mflop. At 3.35 TB/s and 67 TFLOP/s the bound is the bytes, ~0.05 us a
// scenario (`chip_smoke.lm_cost_work`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_factors.cuh"

namespace {

using namespace avm;
using Torch = TorchCuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 48 * 1024;

enum Mode : int { kEvaluate = 0, kStep = 1, kRetract = 2 };

template <typename T>
struct Args {
  // the state, per scenario: p, v, ba, bg [NF,3], q [NF,4], tic [3], qic [4],
  // td [], inverse depths [F]
  const T *p, *q, *v, *ba, *bg, *tic, *qic, *td, *inv_depth;
  // the W = NF-1 pairs: dp, dv, ba, bg [W,3], dq [W,4], J, S [W,15,15],
  // dt_sum and pre_valid [W]
  const T *pre_dp, *pre_dq, *pre_dv, *pre_J, *pre_dt, *pre_ba, *pre_bg,
      *pre_S, *pre_valid;
  // observations [F,NF,3], mask [F,NF], slot use and weight [F] (feat_w may
  // be null: no weight), ZUPT weights [NF] (may be null: none)
  const T *pts, *mask, *feat_valid, *feat_w, *zupt_w;
  // the prior: J0 [D,D], r0 [D], its linearization point, its weight []
  const T *J0, *r0, *lin_p, *lin_q, *lin_v, *lin_ba, *lin_bg, *lin_tic,
      *lin_qic, *lin_td, *prior_w;
  // the gauge anchor's reference pose, its roll/pitch scale [] (may be null: 1)
  const T *p_ref, *q_ref, *pin_rp;
  // anchor frames [F]
  const int64_t* anchor;
  // the step (step, retract): dx [D], d_rho [F], pred [] (float64 if
  // pred_f64, else float32); the damping [] and cost [] (float64) of the
  // iterate (step)
  const T *dx, *d_rho, *lam;
  const void* pred;
  const double* cost;
  // outputs: the next iterate (step) or the candidate (retract), like the
  // state; the damping (step); the cost (float64); ok (step) or finite
  // (retract) as 0/1; the diagnostics (evaluate; may be null)
  T *o_p, *o_q, *o_v, *o_ba, *o_bg, *o_tic, *o_qic, *o_td, *o_inv_depth,
      *o_lam;
  double* o_cost;
  uint8_t* o_ok;
  T *o_imu_chi2, *o_prior_chi2;
  int nf, nfeat, mode, pred_f64, nielsen;
  double c2, sqrt_aw, min_inv_depth, lam_up, lam_down;
  // the td instance's: image velocities [F,NF,2], td at each frame's capture
  // [NF] (may be null: 0), TR / ROW, fy and cy - ROW / 2 of the row recovery
  const T *vel, *td_obs;
  double tr_over_row, row_fy, row_c0;
};

// A state in shared memory: p [NF,3], q [NF,4], v, ba, bg [NF,3], tic [3],
// qic [4], td, inverse depths [F]
template <typename T>
struct State {
  T *p, *q, *v, *ba, *bg, *tic, *qic, *td, *inv;
};

__host__ __device__ inline int state_elems(int nf, int F) { return 16 * nf + 8 + F; }

template <typename T>
__device__ State<T> state_at(T* s, int nf) {
  State<T> x;
  x.p = s;
  x.q = x.p + 3 * nf;
  x.v = x.q + 4 * nf;
  x.ba = x.v + 3 * nf;
  x.bg = x.ba + 3 * nf;
  x.tic = x.bg + 3 * nf;
  x.qic = x.tic + 3;
  x.td = x.qic + 4;
  x.inv = x.td + 1;
  return x;
}

// Offsets (in elements of the working type) of the block's shared memory,
// after kWarps doubles (the warps' partial sums of the cost)
struct Layout {
  int st, cand, dx, drho, dxl, raw, white, pr2, chi2, okf, total;
};

__host__ __device__ inline Layout layout(int nf, int F) {
  Layout L;
  const int D = 15 * nf + 13, W = nf - 1, S = state_elems(nf, F);
  L.st = 0;
  L.cand = L.st + S;
  L.dx = L.cand + S;
  L.drho = L.dx + D;
  L.dxl = L.drho + F;
  L.raw = L.dxl + D;
  L.white = L.raw + 15 * W;
  L.pr2 = L.white + 15 * W;
  L.chi2 = L.pr2 + D;
  L.okf = L.chi2 + W;
  L.total = L.okf + 1;
  return L;
}

inline size_t smem_bytes(int nf, int F, int elem) {
  return kWarps * sizeof(double) + static_cast<size_t>(layout(nf, F).total) * elem;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int m = 16; m; m >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

__device__ __forceinline__ float lg1p(float x) { return log1pf(x); }
__device__ __forceinline__ double lg1p(double x) { return ::log1p(x); }

// `torch.clamp(x, min=lo)`: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}

// +1 where the scalar part is >= 0, else -1: `window._sign_w`
template <typename T>
__device__ __forceinline__ T sign_w(const T* q) {
  return q[0] >= T(0) ? T(1) : T(-1);
}

// p [+] (dp, dtheta): `lie.pose_boxplus`
template <typename T>
__device__ void boxplus(const T* p, const T* q, const T* d, T* po, T* qo) {
  for (int c = 0; c < 3; ++c) po[c] = p[c] + d[c];
  T dq[4] = {T(1), T(0.5) * d[3], T(0.5) * d[4], T(0.5) * d[5]};
  normalize<Torch>(dq);
  quat_mul<Torch>(q, dq, qo);
  normalize<Torch>(qo);
}

// vec(q_lin^-1 (x) q) with the sign of its scalar part: `state_boxminus`'s
// rotation block (times 2 for the extrinsic)
template <typename T>
__device__ void rot_boxminus(const T* q, const T* lq, T scale, T* out) {
  T lc[4], qrel[4];
  conj(lq, lc);
  quat_mul<Torch>(lc, q, qrel);
  const T sgn = sign_w(qrel);
  for (int c = 0; c < 3; ++c) out[c] = (scale * qrel[1 + c]) * sgn;
}

// The kernel's body; TD: the instance that estimates the time offset
template <bool TD, typename T>
__device__ __forceinline__ void lm_cost_body(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* wsum = reinterpret_cast<double*>(smem_raw);
  T* sm = reinterpret_cast<T*>(wsum + kWarps);
  const int nf = a.nf, F = a.nfeat, W = nf - 1;
  const int P = 6 * nf, X = 15 * nf, D = X + 13;
  const Layout L = layout(nf, F);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const State<T> st = state_at(sm + L.st, nf);
  const State<T> cand = state_at(sm + L.cand, nf);
  T* dx = sm + L.dx;
  T* drho = sm + L.drho;
  T* dxl = sm + L.dxl;

  // 0. the iterate, and the step sanitized
  {
    const T* src[9] = {a.p, a.q, a.v, a.ba, a.bg, a.tic, a.qic, a.td, a.inv_depth};
    T* dst[9] = {st.p, st.q, st.v, st.ba, st.bg, st.tic, st.qic, st.td, st.inv};
    const int n[9] = {3 * nf, 4 * nf, 3 * nf, 3 * nf, 3 * nf, 3, 4, 1, F};
    for (int k = 0; k < 9; ++k)
      for (int i = tid; i < n[k]; i += kThreads) dst[k][i] = src[k][b * n[k] + i];
  }
  int bad = 0;
  if (a.mode != kEvaluate) {
    for (int i = tid; i < D; i += kThreads) {
      const T x = a.dx[b * D + i];
      bad |= !isfinite(x);
      dx[i] = isfinite(x) ? x : T(0);
    }
    for (int f = tid; f < F; f += kThreads) {
      const T x = a.d_rho[b * F + f];
      bad |= !isfinite(x);
      drho[f] = isfinite(x) ? x : T(0);
    }
    if (tid == 0)
      bad |= a.pred_f64 ? !isfinite(static_cast<const double*>(a.pred)[b])
                        : !isfinite(static_cast<const float*>(a.pred)[b]);
  }
  const bool finite = !__syncthreads_or(bad);

  // 1. the candidate, `window.retract`
  const State<T> x = a.mode == kEvaluate ? st : cand;
  if (a.mode != kEvaluate) {
    if (tid < nf) {
      const int i = tid;
      boxplus(st.p + 3 * i, st.q + 4 * i, dx + 6 * i, cand.p + 3 * i, cand.q + 4 * i);
      for (int c = 0; c < 3; ++c) {
        cand.v[3 * i + c] = st.v[3 * i + c] + dx[P + 9 * i + c];
        cand.ba[3 * i + c] = st.ba[3 * i + c] + dx[P + 9 * i + 3 + c];
        cand.bg[3 * i + c] = st.bg[3 * i + c] + dx[P + 9 * i + 6 + c];
      }
    } else if (tid == nf) {
      boxplus(st.tic, st.qic, dx + X, cand.tic, cand.qic);
      cand.td[0] = st.td[0] + dx[X + 6];
    }
    const T lo = static_cast<T>(a.min_inv_depth);
    for (int f = tid; f < F; f += kThreads) cand.inv[f] = clamp_min(st.inv[f] + drho[f], lo);
    __syncthreads();
  }

  // 2. the cost at x: every thread sums its own terms in float64
  double acc = 0.0;
  const T pw = a.prior_w[b];
  if (warp == 0) {
    // x [-] x_lin (`window.state_boxminus`)
    for (int i = lane; i <= nf; i += 32) {
      if (i < nf) {
        const size_t s = (b * nf + i) * 3;
        for (int c = 0; c < 3; ++c) {
          dxl[6 * i + c] = x.p[3 * i + c] - a.lin_p[s + c];
          dxl[P + 9 * i + c] = x.v[3 * i + c] - a.lin_v[s + c];
          dxl[P + 9 * i + 3 + c] = x.ba[3 * i + c] - a.lin_ba[s + c];
          dxl[P + 9 * i + 6 + c] = x.bg[3 * i + c] - a.lin_bg[s + c];
        }
        rot_boxminus(x.q + 4 * i, a.lin_q + (b * nf + i) * 4, T(1), dxl + 6 * i + 3);
      } else {
        for (int c = 0; c < 3; ++c) dxl[X + c] = x.tic[c] - a.lin_tic[b * 3 + c];
        rot_boxminus(x.qic, a.lin_qic + b * 4, T(2), dxl + X + 3);
        dxl[X + 6] = x.td[0] - a.lin_td[b];
        for (int c = X + 7; c < D; ++c) dxl[c] = T(0);
      }
    }
  } else if (warp == 1) {
    // the IMU pairs' unwhitened residuals
    for (int w = lane; w < W; w += 32) {
      const size_t pw_ = b * W + w;
      Pre<T> pre;
      pre.dp = a.pre_dp + pw_ * 3;
      pre.dq = a.pre_dq + pw_ * 4;
      pre.dv = a.pre_dv + pw_ * 3;
      pre.J = a.pre_J + pw_ * 225;
      pre.ba = a.pre_ba + pw_ * 3;
      pre.bg = a.pre_bg + pw_ * 3;
      pre.dt = a.pre_dt[pw_];
      T sbi[9], sbj[9];
      for (int c = 0; c < 3; ++c) {
        sbi[c] = x.v[3 * w + c];
        sbi[3 + c] = x.ba[3 * w + c];
        sbi[6 + c] = x.bg[3 * w + c];
        sbj[c] = x.v[3 * (w + 1) + c];
        sbj[3 + c] = x.ba[3 * (w + 1) + c];
        sbj[6 + c] = x.bg[3 * (w + 1) + c];
      }
      imu_residual<Torch>(x.p + 3 * w, x.q + 4 * w, sbi, x.p + 3 * (w + 1),
                          x.q + 4 * (w + 1), sbj, pre, sm + L.raw + 15 * w);
    }
  } else if (warp == 2 && lane == 0) {
    // the gauge anchor (`window._anchor_rows`) on pose 0
    const T* qr = a.q_ref + b * 4;
    const T* pr = a.p_ref + b * 3;
    const T w = static_cast<T>(a.sqrt_aw) * (T(1) - pw);
    const T pin = a.pin_rp ? a.pin_rp[b] : T(1);
    T qrc[4], qrel[4];
    conj(qr, qrc);
    quat_mul<Torch>(qrc, x.q, qrel);
    const T sgn = sign_w(qrel);
    T dth[3];
    for (int k = 0; k < 3; ++k) dth[k] = (T(2) * qrel[1 + k]) * sgn;
    // quat_to_rot(q_ref)
    const T qw = qr[0], qx = qr[1], qy = qr[2], qz = qr[3];
    const T xx = qx * qx, yy = qy * qy, zz = qz * qz, wx = qw * qx, wy = qw * qy,
            wz = qw * qz, xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const T R[9] = {T(1) - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy),
                    T(2) * (xy + wz), T(1) - T(2) * (xx + zz), T(2) * (yz - wx),
                    T(2) * (xz - wy), T(2) * (yz + wx), T(1) - T(2) * (xx + yy)};
    const T wr[3] = {w * pin, w * pin, w};
    for (int c = 0; c < 3; ++c) {
      const T r = w * (x.p[c] - pr[c]);
      acc += static_cast<double>((T(0.5) * r) * r);
    }
    for (int i = 0; i < 3; ++i) {
      const T rd = (R[3 * i] * dth[0] + R[3 * i + 1] * dth[1]) + R[3 * i + 2] * dth[2];
      const T r = wr[i] * rd;
      acc += static_cast<double>((T(0.5) * r) * r);
    }
  } else if (warp == 3 && a.zupt_w) {
    // the zero-velocity rows
    for (int i = lane; i < 3 * nf; i += 32) {
      const T z = a.zupt_w[b * nf + i / 3] * x.v[i];
      acc += static_cast<double>(T(0.5) * (z * z));
    }
  }
  __syncthreads();

  // the IMU rows whitened, S r as `einsum("...ij,...j->...i")`
  for (int t = tid; t < 15 * W; t += kThreads) {
    const int w = t / 15, m = t % 15;
    const T* S = a.pre_S + ((b * W + w) * 15 + m) * 15;
    const T* r = sm + L.raw + 15 * w;
    T d = S[0] * r[0];
    for (int j = 1; j < 15; ++j) d = d + S[j] * r[j];
    sm[L.white + t] = d;
  }
  // the prior's rows (r0 + J0 dx_lin) w, a warp a row
  const T* J0 = a.J0 + b * D * D;
  for (int i = warp; i < D; i += kWarps) {
    T s = T(0);
    for (int c = lane; c < D; c += 32) s = s + J0[i * D + c] * dxl[c];
    s = warp_sum(s);
    if (lane == 0) {
      const T r = (a.r0[b * D + i] + s) * pw;
      sm[L.pr2 + i] = r * r;
      acc += static_cast<double>((T(0.5) * r) * r);
    }
  }
  // the projection factors: consecutive threads take a landmark's frames
  {
    const T inv_c2 = T(1) / static_cast<T>(a.c2);
    const T half_c2 = static_cast<T>(0.5 * a.c2);
    for (int t = tid; t < F * nf; t += kThreads) {
      const int f = t / nf, j = t % nf;
      int af = static_cast<int>(a.anchor[b * F + f]);
      af = af < 0 ? 0 : af >= nf ? nf - 1 : af;
      const T* pt = a.pts + (b * F + f) * nf * 3;
      const T* pt_i = pt + 3 * af;
      const T* pt_j = pt + 3 * j;
      T sh_i[3], sh_j[3];
      if constexpr (TD) {
        TdObs<T> o;
        o.tr_over_row = static_cast<T>(a.tr_over_row);
        o.row_fy = static_cast<T>(a.row_fy);
        o.row_c0 = static_cast<T>(a.row_c0);
        o.vel = a.vel + ((b * F + f) * nf + af) * 2;
        o.td_k = a.td_obs ? a.td_obs[b * nf + af] : T(0);
        td_shift(pt_i, o, x.td[0], sh_i);
        o.vel = a.vel + ((b * F + f) * nf + j) * 2;
        o.td_k = a.td_obs ? a.td_obs[b * nf + j] : T(0);
        td_shift(pt_j, o, x.td[0], sh_j);
        pt_i = sh_i;
        pt_j = sh_j;
      }
      T r[2];
      proj_residual<Torch>(x.p + 3 * af, x.q + 4 * af, x.p + 3 * j, x.q + 4 * j,
                           x.tic, x.qic, x.inv[f], pt_i, pt_j, r);
      const T* mk = a.mask + (b * F + f) * nf;
      const T valid = ((mk[af] * mk[j]) * a.feat_valid[b * F + f]) *
                      (j != af ? T(1) : T(0));
      T s2 = (T(0) + r[0] * r[0]) + (T(0) + r[1] * r[1]);
      if (a.feat_w) {
        const T fw = a.feat_w[b * F + f];
        s2 = (s2 * fw) * fw;
      }
      acc += static_cast<double>((half_c2 * lg1p(s2 * inv_c2)) * valid);
    }
  }
  __syncthreads();
  // the IMU terms, 0.5 |S r|^2 pre_valid
  if (warp == 0)
    for (int w = lane; w < W; w += 32) {
      T e[15];
      for (int m = 0; m < 15; ++m) e[m] = sm[L.white + 15 * w + m] * sm[L.white + 15 * w + m];
      const T chi2 = torch_sum(e, 15);
      const T valid = a.pre_valid[b * W + w];
      sm[L.chi2 + w] = chi2 * valid;
      acc += static_cast<double>((T(0.5) * chi2) * valid);
    }
  acc = warp_sum(acc);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();

  // 3. the decision (step), the scalars
  if (tid == 0) {
    double total = wsum[0];
    for (int w = 1; w < kWarps; ++w) total += wsum[w];
    if (a.mode == kStep) {
      const double cost = a.cost[b];
      double pred_c;
      bool pos;
      if (a.pred_f64) {
        const double p = static_cast<const double*>(a.pred)[b];
        pos = p > 0.0;
        pred_c = clamp_min(p, 1e-30);
      } else {
        const float p = static_cast<const float*>(a.pred)[b];
        pos = p > 0.0f;
        pred_c = static_cast<double>(clamp_min(p, static_cast<float>(1e-30)));
      }
      const bool ok = total < cost && pos && finite;
      const T rho = static_cast<T>((cost - total) / pred_c);
      const T lam = a.lam[b];
      T next;
      if (a.nielsen) {
        const T t = T(2) * rho - T(1);
        const T shrink = clamp_min(T(1) - (t * t) * t, static_cast<T>(1.0 / 3.0));
        next = ok ? lam * shrink : lam * T(2);
      } else {
        next = ok ? lam * static_cast<T>(a.lam_down) : lam * static_cast<T>(a.lam_up);
      }
      const T lo = static_cast<T>(1e-12), hi = static_cast<T>(1e8);
      a.o_lam[b] = isnan(next) ? next : (next < lo ? lo : next > hi ? hi : next);
      a.o_cost[b] = ok ? total : cost;
      a.o_ok[b] = ok;
      sm[L.okf] = ok ? T(1) : T(0);
    } else {
      a.o_cost[b] = total;
      if (a.mode == kRetract) a.o_ok[b] = finite;
    }
    if (a.mode == kEvaluate && a.o_imu_chi2) {
      T pv[32];
      for (int w = 0; w < W; ++w) pv[w] = a.pre_valid[b * W + w];
      const T n = torch_sum(pv, W);
      a.o_imu_chi2[b] = torch_sum(sm + L.chi2, W) / (n < T(1) ? T(1) : n);
    }
    if (a.mode == kEvaluate && a.o_prior_chi2) {
      T s = T(0);
      for (int i = 0; i < D; ++i) s = s + sm[L.pr2 + i];
      a.o_prior_chi2[b] = s;
    }
  }
  if (a.mode == kEvaluate) return;
  __syncthreads();

  // 4. the outputs: the candidate (retract) or the blend (step), every leaf
  // as `ok * candidate + (1 - ok) * iterate`, then q and qic renormalised
  const bool blend = a.mode == kStep;
  const T okf = blend ? sm[L.okf] : T(1);
  const T rest = T(1) - okf;
  const T* from[9] = {cand.p, cand.q, cand.v, cand.ba, cand.bg, cand.tic, cand.qic, cand.td, cand.inv};
  const T* keep[9] = {st.p, st.q, st.v, st.ba, st.bg, st.tic, st.qic, st.td, st.inv};
  T* to[9] = {a.o_p, a.o_q, a.o_v, a.o_ba, a.o_bg, a.o_tic, a.o_qic, a.o_td, a.o_inv_depth};
  const int n[9] = {3 * nf, 4 * nf, 3 * nf, 3 * nf, 3 * nf, 3, 4, 1, F};
  for (int k = 0; k < 9; ++k) {
    if (blend && (k == 1 || k == 6)) continue;
    for (int i = tid; i < n[k]; i += kThreads)
      to[k][b * n[k] + i] = blend ? okf * from[k][i] + rest * keep[k][i] : from[k][i];
  }
  if (blend && tid <= nf) {
    const int k = tid < nf ? 1 : 6, i = tid < nf ? tid : 0;
    T qb[4];
    for (int c = 0; c < 4; ++c) qb[c] = okf * from[k][4 * i + c] + rest * keep[k][4 * i + c];
    normalize<Torch>(qb);
    for (int c = 0; c < 4; ++c) to[k][b * n[k] + 4 * i + c] = qb[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_cost_fused_kernel(const __grid_constant__ Args<T> a) {
  lm_cost_body<false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lm_cost_fused_td_kernel(const __grid_constant__ Args<T> a) {
  lm_cost_body<true>(a);
}

template <typename T>
int launch(const void* const* ptr, int batch, int nf, int nfeat, int mode,
           double c2, double sqrt_aw, double min_inv_depth, int nielsen,
           double lam_up, double lam_down, int pred_f64,
           const double* td_consts, void* stream) {
  Args<T> a;
  const bool td = td_consts != nullptr;
  const T** in[] = {&a.p, &a.q, &a.v, &a.ba, &a.bg, &a.tic, &a.qic, &a.td,
                    &a.inv_depth, &a.pre_dp, &a.pre_dq, &a.pre_dv, &a.pre_J,
                    &a.pre_dt, &a.pre_ba, &a.pre_bg, &a.pre_S, &a.pre_valid,
                    &a.pts, &a.mask, &a.feat_valid, &a.feat_w, &a.zupt_w,
                    &a.J0, &a.r0, &a.lin_p, &a.lin_q, &a.lin_v, &a.lin_ba,
                    &a.lin_bg, &a.lin_tic, &a.lin_qic, &a.lin_td, &a.prior_w,
                    &a.p_ref, &a.q_ref, &a.pin_rp, &a.vel, &a.td_obs};
  // the td instance's two inputs follow pin_rp
  const int n_in = sizeof(in) / sizeof(in[0]) - (td ? 0 : 2);
  for (int i = 0; i < n_in; ++i) *in[i] = static_cast<const T*>(ptr[i]);
  if (!td) a.vel = a.td_obs = nullptr;
  a.tr_over_row = td ? td_consts[0] : 0.0;
  a.row_fy = td ? td_consts[1] : 0.0;
  a.row_c0 = td ? td_consts[2] : 0.0;
  int k = n_in;
  a.anchor = static_cast<const int64_t*>(ptr[k++]);
  a.dx = static_cast<const T*>(ptr[k++]);
  a.d_rho = static_cast<const T*>(ptr[k++]);
  a.pred = ptr[k++];
  a.lam = static_cast<const T*>(ptr[k++]);
  a.cost = static_cast<const double*>(ptr[k++]);
  T** out[] = {&a.o_p, &a.o_q, &a.o_v, &a.o_ba, &a.o_bg, &a.o_tic, &a.o_qic,
               &a.o_td, &a.o_inv_depth, &a.o_lam};
  for (T** o : out) *o = static_cast<T*>(const_cast<void*>(ptr[k++]));
  a.o_cost = static_cast<double*>(const_cast<void*>(ptr[k++]));
  a.o_ok = static_cast<uint8_t*>(const_cast<void*>(ptr[k++]));
  a.o_imu_chi2 = static_cast<T*>(const_cast<void*>(ptr[k++]));
  a.o_prior_chi2 = static_cast<T*>(const_cast<void*>(ptr[k++]));
  a.nf = nf;
  a.nfeat = nfeat;
  a.mode = mode;
  a.pred_f64 = pred_f64;
  a.nielsen = nielsen;
  a.c2 = c2;
  a.sqrt_aw = sqrt_aw;
  a.min_inv_depth = min_inv_depth;
  a.lam_up = lam_up;
  a.lam_down = lam_down;
  const size_t smem = smem_bytes(nf, nfeat, sizeof(T));
  if (nf < 2 || nf > 33 || mode < kEvaluate || mode > kRetract || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (td)
    lm_cost_fused_td_kernel<T><<<batch, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  else
    lm_cost_fused_kernel<T><<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Loads the four instances (float32, float64; with and without td) now
// rather than at their first launch inside a solve. Called once after the
// library is loaded; returns a CUDA error code.
extern "C" int avm_lm_cost_init() {
  cudaFuncAttributes attr;
  const cudaError_t errs[] = {
      cudaFuncGetAttributes(&attr, lm_cost_fused_kernel<float>),
      cudaFuncGetAttributes(&attr, lm_cost_fused_kernel<double>),
      cudaFuncGetAttributes(&attr, lm_cost_fused_td_kernel<float>),
      cudaFuncGetAttributes(&attr, lm_cost_fused_td_kernel<double>)};
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

// The cost phase of `batch` scenarios of NF frames and `nfeat` landmark slots.
// `ptr` holds, in this order, the device pointers of Args' inputs as `launch`
// lists them (feat_w, zupt_w and pin_rp may be 0), the anchor frames (int64),
// the step dx, d_rho, pred, the damping and the cost (0 in evaluate mode; dx,
// d_rho and pred only in retract mode), then the outputs p, q, v, ba, bg, tic,
// qic, td, inv_depth, the damping (0 in evaluate mode; the damping 0 in
// retract mode), the cost (float64), ok (uint8; 0 in evaluate mode), imu_chi2
// and prior_chi2 (evaluate mode; may be 0). All contiguous, [batch, ...], of
// one type, float64 if `f64`, else float32, but for the cost (float64) and
// pred (float64 if `pred_f64`, else float32). `mode`: 0 evaluate, 1 step, 2
// retract. `c2`: the Cauchy scale squared; `sqrt_aw`: the square root of the
// gauge anchor's weight; `nielsen`: the "nielsen" damping rule, else
// "halving" by `lam_up` and `lam_down`; `td_consts`: null for a solve that
// holds td, else (TR / ROW, fy, cy - ROW / 2) of the time offset's instance,
// whose inputs vel and td_obs (may be 0) follow pin_rp in `ptr`. Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int avm_lm_cost_fused(const void* const* ptr, int batch, int nf,
                                 int nfeat, int mode, double c2,
                                 double sqrt_aw, double min_inv_depth,
                                 int nielsen, double lam_up, double lam_down,
                                 int pred_f64, int f64,
                                 const double* td_consts, void* stream) {
  if (batch <= 0) return 0;
  return f64 ? launch<double>(ptr, batch, nf, nfeat, mode, c2, sqrt_aw,
                              min_inv_depth, nielsen, lam_up, lam_down,
                              pred_f64, td_consts, stream)
             : launch<float>(ptr, batch, nf, nfeat, mode, c2, sqrt_aw,
                             min_inv_depth, nielsen, lam_up, lam_down,
                             pred_f64, td_consts, stream);
}
