// The normal equations of one Levenberg-Marquardt iteration of the window
// solve, for a batch of scenarios, in one launch: every projection factor and
// every IMU factor linearized in registers and summed straight into the
// outputs the fused Schur kernel reads, H [B,D,D], g [B,D], H_lp [B,F,D],
// h_ll [B,F] and g_l [B,F].
//
// Replaces no Pallas kernel. The JAX package linearizes with XLA
// (anticipated_vins_mono_tpu/ops/window.py, `normal_equations_fast`: jacfwd of
// the factors, then einsums); the port ran the same chain as ~780 small
// PyTorch launches an iteration (ops/window.normal_equations_fast_plain, which
// stays the plain version and the path for CPU tensors).
//
// What it computes, per scenario (one block of 256 threads):
//   - each projection factor (landmark f, frame j != anchor a) of the [F,NF]
//     grid: the residual at the state as given, and its 19 tangent columns
//     (anchor pose 6, frame pose 6, extrinsic 6, inverse depth 1) by forward
//     mode, at the point `factors.tangent_jacobian` takes: the position as
//     given, the quaternion renormalised, the rotation's tangent that of
//     normalize(q (x) [1, dtheta/2]). A lane carries one factor through three
//     passes (anchor and depth, frame, extrinsic), each a dual number of 7 or
//     6 tangents, and follows the residual's own operations with PyTorch's
//     rules for their derivatives (built without fused multiply-adds, so each
//     product and sum rounds as PyTorch's elementwise operations do). Then
//     the Cauchy sqrt-weight with `feat_w` and the validity mask; J_e is zero
//     without `estimate_extrinsic`;
//   - each IMU factor (pair w, w+1): the residual with the bias-corrected
//     deltas and its 30 tangent columns (two poses, two speed-bias blocks),
//     one warp a pass, a lane a pair; then the block whitens them by S and
//     weights them by `pre_valid`; gravity is a constant;
//   - the gradient of the prior (r0 + J0 (x [-] x_lin), by its weight), of
//     the gauge anchor on pose 0 and of the zero-velocity rows. Their
//     H-block is constant over a solve and comes in as H0 (J_s^T J_s, formed
//     once per solve by the caller);
//   - H = (projection + IMU) + H0, g likewise, H_lp, h_ll, g_l.
// A solve that estimates the camera-IMU time offset td (VINS-Mono's
// `ProjectionTdFactor`, `factors.projection_td_residual`) takes the second
// instance, `normal_eq_fused_td_kernel`: each observation is shifted along its
// image velocity by (td - td_k) + TR / ROW * row before the same chain, and
// a projection factor carries a 20th tangent column, td's, from a fourth
// pass of one tangent; td's column of H joins the square the warps sum
// (6NF + 7), its entries of g and H_lp likewise. TR / ROW is a number the
// launch passes: a global shutter is TR = 0, not another build.
//
// Determinism: no atomics. Each of the block's eight warps takes landmarks in
// a fixed order, two at a time (a lane a factor, its columns in registers),
// and sums them into its own copy of the 6NF+6 square of H that projection
// factors touch (pose and extrinsic, packed upper triangle, plus its
// gradient): a factor adds its frame's blocks itself, and a landmark's sums
// over its factors are reduced across its lanes in a fixed pattern. The
// copies are added in warp order. An IMU product or an output entry is summed
// by the one thread that owns it, over a fixed order of rows and pairs.
//
// Bytes and operations at the flagship shape (NF = 11, F = 128, D = 178),
// float32, per scenario: reads 126 KB (H0) + 126 KB (J0, twice: its product
// with the state's offset and its transpose's with the residual) + ~40 KB of
// the factors' inputs; writes 127 KB (H) + 91 KB (H_lp). Work: 1,280
// projection factors x ~3,100 flop of dual arithmetic and ~840 of sums, 10
// IMU pairs x ~45,000, the prior's two 178 x 178 products; about 5.6 Mflop.
// At 3.35 TB/s and 67 TFLOP/s the bound is the bytes, ~0.19 us a scenario
// (`chip_smoke.ne_work`). What bounds it in fact: one block per scenario (at
// B = 1 one SM), eight warps an SM (the dual passes take 255 registers), and
// the dependent chains of the dual arithmetic; ~0.25 ms a launch at B <= 132
// on an H100.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_factors.cuh"

namespace {

using namespace avm;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a projection factor's row in a lane's registers: 19 tangent columns
// (anchor 0-5, frame 6-11, extrinsic 12-17, inverse depth 18), with td
// estimation td's (19), then the residual
template <bool TD> constexpr int kCols = 20 + TD;
template <bool TD> constexpr int kRes = 19 + TD;
constexpr int kRho = 18, kTd = 19;
// an IMU row in shared memory: 30 tangent columns (pose i 0-5, pose j 6-11,
// speed-bias i 12-20, speed-bias j 21-29), then the residual
constexpr int kImuCols = 31;
// a pair's products of those columns: [30][31], the last the gradient's
constexpr int kImuProd = 30 * kImuCols;
// a frame's (and the extrinsic's) entry: p 3, q 4, q normalised 4, the
// normalised quaternion's three rotation tangents 12
constexpr int kFrame = 23;
constexpr int kMaxSmem = 232448;

// The linearization point and rotation tangents of a pose's quaternion, as
// `factors.tangent_jacobian` takes them: qn = q / ‖q‖ and, for each rotation
// direction e_k, t/‖q‖ − q (q·t)/‖q‖³ with t = q (x) [0, e_k / 2].
template <typename T>
__device__ __forceinline__ void pose_tangents(const T* q, T* qn, T* tq) {
  const T n = root(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  const T n3 = (n * n) * n;
#pragma unroll
  for (int c = 0; c < 4; ++c) qn[c] = q[c] / n;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T half[4] = {T(0), k == 0 ? T(0.5) : T(0), k == 1 ? T(0.5) : T(0),
                       k == 2 ? T(0.5) : T(0)};
    T t[4];
    quat_mul(q, half, t);
    const T s = ((q[0] * t[0] + q[1] * t[1]) + q[2] * t[2]) + q[3] * t[3];
#pragma unroll
    for (int c = 0; c < 4; ++c) tq[4 * k + c] = t[c] / n - q[c] * (s / n3);
  }
}

// A pose (p, qn) of a frame entry as duals: its six tangents in slots off..off+5
template <typename T, int N>
__device__ __forceinline__ void seed_pose(const T* fr, int off, Dual<T, N>* p,
                                          Dual<T, N>* q) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c].v = fr[c];
#pragma unroll
    for (int k = 0; k < N; ++k) p[c].t[k] = k == off + c ? T(1) : T(0);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q[c].v = fr[7 + c];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int d = k - off - 3;
      q[c].t[k] = d >= 0 && d < 3 ? fr[11 + 4 * d + c] : T(0);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> seed_lin(T x, int slot) {
  Dual<T, N> r;
  r.v = x;
#pragma unroll
  for (int k = 0; k < N; ++k) r.t[k] = k == slot ? T(1) : T(0);
  return r;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

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
  // be null: 1), anchor frames [F], ZUPT weights [NF] (may be null: none)
  const T *pts, *mask, *feat_valid, *feat_w, *zupt_w;
  const int64_t* anchor;
  // the prior: J0 [D,D], r0 [D], its linearization point, its weight []
  const T *J0, *r0, *lin_p, *lin_q, *lin_v, *lin_ba, *lin_bg, *lin_tic,
      *lin_qic, *lin_td, *prior_w;
  // the gauge anchor's reference pose, its roll/pitch scale [] (may be null: 1)
  const T *p_ref, *q_ref, *pin_rp;
  // J_s^T J_s of the prior, anchor and ZUPT rows [D,D]
  const T* H0;
  T *H, *g, *H_lp, *h_ll, *g_l;
  // optional: block 0's clock64() at the phase boundaries (`NE_STAMPS`)
  long long* stamps;
  int nf, nfeat, nw;
  T c2, sqrt_aw;
  int est_ext;
  // the td instance's: image velocities [F,NF,2], td at each frame's capture
  // [NF] (may be null: 0), TR / ROW, fy and cy - ROW / 2 of the row recovery
  const T *vel, *td_obs;
  T tr_over_row, row_fy, row_c0;
};

// Offsets (in elements of the working type) of the block's shared memory.
struct Layout {
  int fdat, dx, rp, gs, acc0, wacc, raw, imu, ip, total, npk, E;
};

__host__ __device__ inline Layout layout(int nf, int nw, bool td) {
  Layout L;
  const int D = 15 * nf + 13;
  L.E = 6 * nf + 6 + td;
  L.npk = L.E * (L.E + 1) / 2;
  L.fdat = 0;
  L.dx = L.fdat + (nf + 1) * kFrame;
  L.rp = L.dx + D;
  L.gs = L.rp + D;
  L.acc0 = L.gs + D;
  L.wacc = L.acc0 + L.npk + L.E;  // warps 1.. follow warp 0's copy
  // the IMU rows whitened, then unwhitened, whose place their products take:
  // over warp 1.. copies, once they are added up
  L.imu = L.wacc;
  L.raw = L.imu + (nf - 1) * 15 * kImuCols;
  L.ip = L.raw;
  const int a = L.wacc + (nw - 1) * (L.npk + L.E);
  const int b = L.ip + (nf - 1) * kImuProd;
  L.total = a > b ? a : b;
  return L;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int m = 16; m; m >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// index of (r, c) in the packed upper triangle of an E x E matrix
__device__ __forceinline__ int packed(int r, int c, int E) {
  if (r > c) {
    const int x = r;
    r = c;
    c = x;
  }
  return r * E - r * (r - 1) / 2 + (c - r);
}

// One projection factor (f, j) of anchor frame af: its weighted tangent
// columns and residual, `u` [2][kCols], in registers. With TD the
// observations are shifted by the time offset first (`td_shift`), and a
// fourth pass carries td's tangent.
template <bool TD, typename T>
__device__ __forceinline__ void proj_factor(const Args<T>& a, size_t b,
                                            const T* fd, int f, int af, int j,
                                            T (&u)[2][kCols<TD>]) {
  const int nf = a.nf, F = a.nfeat;
  const T* fa = fd + af * kFrame;
  const T* fj = fd + j * kFrame;
  const T* fe = fd + nf * kFrame;
  const T* obs_i = a.pts + ((b * F + f) * nf + af) * 3;
  const T* obs_j = a.pts + ((b * F + f) * nf + j) * 3;
  const T rho = a.inv_depth[b * F + f];
  TdObs<T> oi, oj;
  T sh_i[3], sh_j[3];
  const T* pt_i = obs_i;
  const T* pt_j = obs_j;
  if constexpr (TD) {
    oi.vel = a.vel + ((b * F + f) * nf + af) * 2;
    oj.vel = a.vel + ((b * F + f) * nf + j) * 2;
    oi.td_k = a.td_obs ? a.td_obs[b * nf + af] : T(0);
    oj.td_k = a.td_obs ? a.td_obs[b * nf + j] : T(0);
    oi.tr_over_row = oj.tr_over_row = a.tr_over_row;
    oi.row_fy = oj.row_fy = a.row_fy;
    oi.row_c0 = oj.row_c0 = a.row_c0;
    const T td = a.td[b];
    td_shift(obs_i, oi, td, sh_i);
    td_shift(obs_j, oj, td, sh_j);
    pt_i = sh_i;
    pt_j = sh_j;
  }
  T r[2];
  proj_residual(fa, fa + 3, fj, fj + 3, fe, fe + 3, rho, pt_i, pt_j, r);
  // the Cauchy sqrt-weight, validity and feature weight
  const T fw = a.feat_w ? a.feat_w[b * F + f] : T(1);
  const T* mk = a.mask + (b * F + f) * nf;
  const T valid = ((mk[af] * mk[j]) * a.feat_valid[b * F + f]) *
                  (j != af ? T(1) : T(0));
  const T sq = ((r[0] * r[0] + r[1] * r[1]) * fw) * fw;
  const T w = (root(T(1) / (T(1) + sq / a.c2)) * valid) * fw;
  {  // anchor pose and inverse depth
    Dual<T, 7> pa[3], qa[4], rr[2];
    seed_pose(fa, 0, pa, qa);
    const Dual<T, 7> rh = seed_lin<T, 7>(rho, 6);
    proj_residual(pa, qa, fj, fj + 7, fe, fe + 7, rh, pt_i, pt_j, rr);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int k = 0; k < 6; ++k) u[m][k] = rr[m].t[k] * w;
      u[m][kRho] = rr[m].t[6] * w;
    }
  }
  {  // frame pose
    Dual<T, 6> pj[3], qj[4], rr[2];
    seed_pose(fj, 0, pj, qj);
    proj_residual(fa, fa + 7, pj, qj, fe, fe + 7, rho, pt_i, pt_j, rr);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 6; ++k) u[m][6 + k] = rr[m].t[k] * w;
  }
  {  // extrinsic
    Dual<T, 6> pe[3], qe[4], rr[2];
    seed_pose(fe, 0, pe, qe);
    proj_residual(fa, fa + 7, fj, fj + 7, pe, qe, rho, pt_i, pt_j, rr);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 6; ++k)
        u[m][12 + k] = a.est_ext ? rr[m].t[k] * w : T(0) * w;
  }
  if constexpr (TD) {  // the time offset, through both observations
    const Dual<T, 1> td = seed_lin<T, 1>(a.td[b], 0);
    Dual<T, 1> di[3], dj[3], rr[2];
    td_shift(obs_i, oi, td, di);
    td_shift(obs_j, oj, td, dj);
    proj_residual(fa, fa + 7, fj, fj + 7, fe, fe + 7, rho, di, dj, rr);
#pragma unroll
    for (int m = 0; m < 2; ++m) u[m][kTd] = rr[m].t[0] * w;
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) u[m][kRes<TD>] = r[m] * w;
}

// The sums a factor adds on its own: its frame j's columns against every
// column of its rows (blocks (a, j), (j, j), (j, e), with TD (j, td), g_j and
// H_lp's frame block), the two rows summed in order.
template <bool TD, typename T>
__device__ __forceinline__ void frame_sums(const T (&u)[2][kCols<TD>], int af,
                                           int j, int E, int P, T* acc,
                                           T* Hl) {
  constexpr int n_add = 19 + TD;
  const int npk = E * (E + 1) / 2;
  auto dot = [&](int k, int l) { return u[0][k] * u[0][l] + u[1][k] * u[1][l]; };
  // a row k of the frame's columns at a time: its entries' old values are
  // all read before any is written, so the reads go out together
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int idx[n_add];
    T add[n_add], old[n_add];
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      idx[l] = packed(6 * af + k, 6 * j + l, E);
      add[l] = dot(k, 6 + l);
      idx[6 + l] = packed(6 * j + k, 6 * j + l, E);
      add[6 + l] = dot(6 + k, 6 + l);
      idx[12 + l] = packed(6 * j + k, P + l, E);
      add[12 + l] = dot(6 + k, 12 + l);
    }
    if constexpr (TD) {
      idx[18] = packed(6 * j + k, P + 6, E);
      add[18] = dot(6 + k, kTd);
    }
    idx[n_add - 1] = npk + 6 * j + k;
    add[n_add - 1] = dot(6 + k, kRes<TD>);
#pragma unroll
    for (int n = 0; n < n_add; ++n)
      if (n < 6 || n >= 6 + k) old[n] = acc[idx[n]];
#pragma unroll
    for (int n = 0; n < n_add; ++n)
      if (n < 6 || n >= 6 + k) acc[idx[n]] = old[n] + add[n];
    Hl[6 * j + k] = dot(kRho, 6 + k);
  }
}

// The entries of the upper triangle of u u^T over a landmark's shared
// columns (anchor pose 0-5, extrinsic 6-11, with TD td 12, then inverse depth
// and residual; 14 + TD columns, 105 or 120 entries), which every factor of
// the landmark adds to: the e-th entry's (k, l)
template <bool TD> constexpr int kShared = 14 + TD;
template <bool TD> constexpr int kGram = kShared<TD> * (kShared<TD> + 1) / 2;
template <bool TD>
__host__ __device__ constexpr int gram_k(int e) {
  int k = 0;
  while (e >= kShared<TD> - k) {
    e -= kShared<TD> - k;
    ++k;
  }
  return k;
}
template <bool TD>
__host__ __device__ constexpr int gram_l(int e) {
  int k = 0;
  while (e >= kShared<TD> - k) {
    e -= kShared<TD> - k;
    ++k;
  }
  return k + e;
}
// a shared column's place among a factor's kCols
template <bool TD>
__host__ __device__ constexpr int gram_col(int k) {
  return k < 6 ? k : k < 12 ? 6 + k : TD && k == 12 ? kTd : k == 12 + TD ? kRho : kRes<TD>;
}

// v[i] = entry c0 + i of one factor's u u^T (0 past the last entry), the two
// rows summed in order; every index a constant
template <bool TD, int c0, int i, typename T>
__device__ __forceinline__ void gram_fill(const T (&u)[2][kCols<TD>], T (&v)[16]) {
  if constexpr (i < 16) {
    constexpr int e = c0 + i < kGram<TD> ? c0 + i : 0;
    constexpr int k = gram_col<TD>(gram_k<TD>(e)), l = gram_col<TD>(gram_l<TD>(e));
    v[i] = u[0][k] * u[0][l] + u[1][k] * u[1][l];
    gram_fill<TD, c0, i + 1>(u, v);
  }
}

// One step of the reduction across a 16-lane group: the lane whose bit n is
// set keeps the upper n of its 2n values, its partner the lower n, each adds
// what the other gives up. After n = 8, 4, 2, 1 lane L holds entry L.
template <int n, typename T>
__device__ __forceinline__ void halve(T (&v)[16], bool up) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const T give = up ? v[i] : v[i + n];
    const T got = __shfl_xor_sync(0xffffffffu, give, n);
    v[i] = (up ? v[i + n] : v[i]) + got;
  }
}

// Entry e of a landmark's u u^T summed over its factors, `s`, into the
// warp's copy or the landmark's own outputs (H_lp's anchor, extrinsic and td
// blocks, h_ll, g_l: set by the first chunk of frames, added to by later ones)
template <bool TD, typename T>
__device__ __forceinline__ void gram_write(int e, T s, int af, int E, int P,
                                           int X, bool first, T* acc, T* Hl,
                                           T* hll, T* gl) {
  constexpr int nc = 12 + TD;  // the shared columns that are columns of H
  const int npk = E * (E + 1) / 2;
  const int k = gram_k<TD>(e), l = gram_l<TD>(e);
  auto col = [&](int c) { return c < 6 ? 6 * af + c : P + c - 6; };
  auto set = [&](T* x) { *x = first ? s : *x + s; };
  if (l < nc) {
    const int idx = packed(col(k), col(l), E);
    acc[idx] = acc[idx] + s;
  } else if (l == nc) {
    if (k < 6) set(Hl + 6 * af + k);
    else if (k < nc) set(Hl + X + k - 6);
    else set(hll);
  } else if (k < nc) {
    acc[npk + col(k)] = acc[npk + col(k)] + s;
  } else if (k == nc) {
    set(gl);
  }
}

// One pass of one IMU pair: `pass` 0, 1 the poses of frames w, w+1; 2, 3
// their speed-bias blocks. Writes the pass's tangent columns of the pair's 15
// unwhitened rows, and with pass 0 the unwhitened residual.
template <typename T>
__device__ void imu_pass(const Args<T>& a, size_t b, const T* fd, int pass,
                         int w, T* out) {
  const int nf = a.nf, W = nf - 1;
  const size_t pw = b * W + w;
  Pre<T> pre;
  pre.dp = a.pre_dp + pw * 3;
  pre.dq = a.pre_dq + pw * 4;
  pre.dv = a.pre_dv + pw * 3;
  pre.J = a.pre_J + pw * 225;
  pre.ba = a.pre_ba + pw * 3;
  pre.bg = a.pre_bg + pw * 3;
  pre.dt = a.pre_dt[pw];
  const T* fi = fd + w * kFrame;
  const T* fj = fd + (w + 1) * kFrame;
  T sbi[9], sbj[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sbi[c] = a.v[(b * nf + w) * 3 + c];
    sbi[3 + c] = a.ba[(b * nf + w) * 3 + c];
    sbi[6 + c] = a.bg[(b * nf + w) * 3 + c];
    sbj[c] = a.v[(b * nf + w + 1) * 3 + c];
    sbj[3 + c] = a.ba[(b * nf + w + 1) * 3 + c];
    sbj[6 + c] = a.bg[(b * nf + w + 1) * 3 + c];
  }
  if (pass == 0) {
    T r[15];
    imu_residual(fi, fi + 3, sbi, fj, fj + 3, sbj, pre, r);
    for (int m = 0; m < 15; ++m) out[m * kImuCols + 30] = r[m];
    Dual<T, 6> pp[3], qq[4], rr[15];
    seed_pose(fi, 0, pp, qq);
    imu_residual(pp, qq, sbi, fj, fj + 7, sbj, pre, rr);
    for (int m = 0; m < 15; ++m)
#pragma unroll
      for (int k = 0; k < 6; ++k) out[m * kImuCols + k] = rr[m].t[k];
  } else if (pass == 1) {
    Dual<T, 6> pp[3], qq[4], rr[15];
    seed_pose(fj, 0, pp, qq);
    imu_residual(fi, fi + 7, sbi, pp, qq, sbj, pre, rr);
    for (int m = 0; m < 15; ++m)
#pragma unroll
      for (int k = 0; k < 6; ++k) out[m * kImuCols + 6 + k] = rr[m].t[k];
  } else {
    Dual<T, 9> sb[9], rr[15];
    const T* x = pass == 2 ? sbi : sbj;
#pragma unroll
    for (int c = 0; c < 9; ++c) sb[c] = seed_lin<T, 9>(x[c], c);
    if (pass == 2) imu_residual(fi, fi + 7, sb, fj, fj + 7, sbj, pre, rr);
    else imu_residual(fi, fi + 7, sbi, fj, fj + 7, sb, pre, rr);
    const int off = pass == 2 ? 12 : 21;
    for (int m = 0; m < 15; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k) out[m * kImuCols + off + k] = rr[m].t[k];
  }
}

// The entry of the gradient of the gauge anchor's six rows at column c < 6:
// `window._anchor_rows`' residual times its Jacobian's column
template <typename T>
__device__ T anchor_grad(const Args<T>& a, size_t b, int c) {
  const int nf = a.nf;
  const T* q0 = a.q + b * nf * 4;
  const T* p0 = a.p + b * nf * 3;
  const T* qr = a.q_ref + b * 4;
  const T* pr = a.p_ref + b * 3;
  const T w = a.sqrt_aw * (T(1) - a.prior_w[b]);
  const T pin = a.pin_rp ? a.pin_rp[b] : T(1);
  if (c < 3) return w * (w * (p0[c] - pr[c]));
  T qrc[4], qrel[4];
  conj(qr, qrc);
  quat_mul(qrc, q0, qrel);
  const T sgn = qrel[0] >= T(0) ? T(1) : T(-1);
  T dth[3];
  for (int k = 0; k < 3; ++k) dth[k] = (T(2) * qrel[1 + k]) * sgn;
  // quat_to_rot(q_ref)
  const T qw = qr[0], x = qr[1], y = qr[2], z = qr[3];
  const T xx = x * x, yy = y * y, zz = z * z, wx = qw * x, wy = qw * y,
          wz = qw * z, xy = x * y, xz = x * z, yz = y * z;
  const T R[9] = {T(1) - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy),
                  T(2) * (xy + wz), T(1) - T(2) * (xx + zz), T(2) * (yz - wx),
                  T(2) * (xz - wy), T(2) * (yz + wx), T(1) - T(2) * (xx + yy)};
  const T wr[3] = {w * pin, w * pin, w};
  const int k = c - 3;
  T s = T(0);
  for (int i = 0; i < 3; ++i) {
    const T rd = (R[3 * i] * dth[0] + R[3 * i + 1] * dth[1]) + R[3 * i + 2] * dth[2];
    s = s + (wr[i] * R[3 * i + k]) * (wr[i] * rd);
  }
  return s;
}

// the H index r as a column of an IMU pair's 30: frame and offset, or false
__device__ __forceinline__ bool imu_slot(int r, int nf, int& fr, int& off) {
  const int P = 6 * nf;
  if (r < P) {
    fr = r / 6, off = r % 6;
    return true;
  }
  if (r < 15 * nf) {
    fr = (r - P) / 9, off = 12 + (r - P) % 9;
    return true;
  }
  return false;
}

// column of slot (fr, off) in pair w: pose of w 0-5, of w+1 6-11, speed-bias
// of w 12-20, of w+1 21-29
__device__ __forceinline__ int imu_col(int fr, int off, int w) {
  const int next = fr == w + 1;
  return off < 12 ? off + 6 * next : off + 9 * next;
}

// The kernel's body; TD: the instance that estimates the time offset
template <bool TD, typename T>
__device__ __forceinline__ void normal_eq_body(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nf = a.nf, F = a.nfeat, nw = a.nw, W = nf - 1;
  const int P = 6 * nf, E = P + 6 + TD, X = 15 * nf, D = X + 13;
  const Layout L = layout(nf, nw, TD);
  const int npk = L.npk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  T* fd = sm + L.fdat;
  T* dx = sm + L.dx;
  T* rp = sm + L.rp;
  T* gs = sm + L.gs;
  T* acc0 = sm + L.acc0;
  const bool stamp = a.stamps && b == 0 && tid == 0;
  if (stamp) a.stamps[0] = clock64();

  // 0. the frames' linearization points, the state's offset from the
  // prior's (`state_boxminus`), the warps' sums set to zero
  for (int i = tid; i <= nf; i += kThreads) {
    T* r = fd + i * kFrame;
    const T* pp = i < nf ? a.p + (b * nf + i) * 3 : a.tic + b * 3;
    const T* qq = i < nf ? a.q + (b * nf + i) * 4 : a.qic + b * 4;
    for (int c = 0; c < 3; ++c) r[c] = pp[c];
    for (int c = 0; c < 4; ++c) r[3 + c] = qq[c];
    pose_tangents(r + 3, r + 7, r + 11);
    const T* lq = i < nf ? a.lin_q + (b * nf + i) * 4 : a.lin_qic + b * 4;
    T lc[4], qrel[4];
    conj(lq, lc);
    quat_mul(lc, qq, qrel);
    const T sgn = qrel[0] >= T(0) ? T(1) : T(-1);
    if (i < nf) {
      const size_t s = (b * nf + i) * 3;
      for (int c = 0; c < 3; ++c) {
        dx[6 * i + c] = a.p[s + c] - a.lin_p[s + c];
        dx[6 * i + 3 + c] = qrel[1 + c] * sgn;
        dx[P + 9 * i + c] = a.v[s + c] - a.lin_v[s + c];
        dx[P + 9 * i + 3 + c] = a.ba[s + c] - a.lin_ba[s + c];
        dx[P + 9 * i + 6 + c] = a.bg[s + c] - a.lin_bg[s + c];
      }
    } else {
      for (int c = 0; c < 3; ++c) {
        dx[X + c] = a.tic[b * 3 + c] - a.lin_tic[b * 3 + c];
        dx[X + 3 + c] = (T(2) * qrel[1 + c]) * sgn;
      }
      dx[X + 6] = a.td[b] - a.lin_td[b];
      for (int c = X + 7; c < D; ++c) dx[c] = T(0);
    }
  }
  for (int i = tid; i < nw * (npk + E); i += kThreads) acc0[i] = T(0);
  __syncthreads();
  if (stamp) a.stamps[1] = clock64();

  // 1. projection factors: warp `warp` takes landmark pairs 2 warp, 2 (warp +
  // nw), ...; lanes 0-15 the first landmark's frames, 16-31 the second's,
  // each lane its factor's columns in registers. A landmark's sums over its
  // factors are reduced across its 16 lanes in a fixed pattern (halving:
  // lane L ends with entry L of each chunk of 16); the two landmarks add to
  // the warp's copy one after the other.
  if (warp < nw) {
    T* acc = warp == 0 ? acc0 : sm + L.wacc + (warp - 1) * (npk + E);
    const int h = lane >> 4, jl = lane & 15;
    for (int f0 = 2 * warp; f0 < F; f0 += 2 * nw) {
      const int f = f0 + h;
      int af = f < F ? int(a.anchor[b * F + f]) : 0;
      af = af < 0 ? 0 : af >= nf ? nf - 1 : af;
      T* Hl = a.H_lp + (b * F + (f < F ? f : 0)) * D;
      if (f < F)
        for (int c = jl; c < D; c += 16)
          if ((c >= P && c < X) || c >= X + 6 + TD) Hl[c] = T(0);
      for (int j0 = 0; j0 < nf; j0 += 16) {
        const int j = j0 + jl;
        const bool on = f < F && j < nf && j != af;
        T u[2][kCols<TD>];
        if (f < F && j < nf) proj_factor<TD>(a, b, fd, f, af, j, u);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int k = 0; k < kCols<TD>; ++k) u[m][k] = on ? u[m][k] : T(0);
        for (int round = 0; round < 2; ++round) {
          if (h == round && on) frame_sums<TD>(u, af, j, E, P, acc, Hl);
          __syncwarp();
        }
        auto chunk = [&](auto c0, T (&v)[16]) {
          halve<8>(v, jl & 8);
          halve<4>(v, jl & 4);
          halve<2>(v, jl & 2);
          halve<1>(v, jl & 1);
          for (int round = 0; round < 2; ++round) {
            if (h == round && f < F && c0 + jl < kGram<TD>)
              gram_write<TD>(c0 + jl, v[0], af, E, P, X, j0 == 0, acc, Hl,
                             a.h_ll + b * F + f, a.g_l + b * F + f);
            __syncwarp();
          }
        };
        T v[16];
        gram_fill<TD, 0, 0>(u, v);
        chunk(0, v);
        gram_fill<TD, 16, 0>(u, v);
        chunk(16, v);
        gram_fill<TD, 32, 0>(u, v);
        chunk(32, v);
        gram_fill<TD, 48, 0>(u, v);
        chunk(48, v);
        gram_fill<TD, 64, 0>(u, v);
        chunk(64, v);
        gram_fill<TD, 80, 0>(u, v);
        chunk(80, v);
        gram_fill<TD, 96, 0>(u, v);
        chunk(96, v);
        if constexpr (TD) {
          gram_fill<TD, 112, 0>(u, v);
          chunk(112, v);
        }
      }
    }
  }
  __syncthreads();
  if (stamp) a.stamps[2] = clock64();

  // 2. the warps' copies added in warp order; the prior's residual
  // (r0 + J0 dx) w, a warp a row
  for (int i = tid; i < npk + E; i += kThreads) {
    T s = acc0[i];
    for (int w = 1; w < nw; ++w) s = s + sm[L.wacc + (w - 1) * (npk + E) + i];
    acc0[i] = s;
  }
  const T* J0 = a.J0 + b * D * D;
  const T pw = a.prior_w[b];
  for (int i = warp; i < D; i += kWarps) {
    T s = T(0);
    for (int c0 = lane; c0 < D; c0 += 8 * 32) {
      T x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = c0 + 32 * k < D ? J0[i * D + c0 + 32 * k] : T(0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (c0 + 32 * k < D) s = s + x[k] * dx[c0 + 32 * k];
    }
    s = warp_sum(s);
    if (lane == 0) rp[i] = (a.r0[b * D + i] + s) * pw;
  }
  __syncthreads();
  if (stamp) a.stamps[3] = clock64();

  // 3. the IMU pairs, warp p their pass p; the small rows' gradient
  T* raw = sm + L.raw;
  T* imu = sm + L.imu;
  if (warp < 4)
    for (int w = lane; w < W; w += 32)
      imu_pass(a, b, fd, warp, w, raw + w * 15 * kImuCols);
  for (int c = tid; c < D; c += kThreads) {
    T s = T(0);
    for (int i0 = 0; i0 < D; i0 += 8) {
      T x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = i0 + k < D ? J0[(i0 + k) * D + c] : T(0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i0 + k < D) s = s + (x[k] * pw) * rp[i0 + k];
    }
    if (c < 6) s = s + anchor_grad(a, b, c);
    if (a.zupt_w && c >= P && c < X && (c - P) % 9 < 3) {
      const int i = (c - P) / 9;
      const T zw = a.zupt_w[b * nf + i];
      s = s + zw * (zw * a.v[(b * nf + i) * 3 + (c - P) % 9]);
    }
    gs[c] = s;
  }
  __syncthreads();
  // the IMU rows whitened, S r as `einsum("...ij,...j->...i")`, then weighted
  // by `pre_valid`
  for (int t = tid; t < W * 15 * kImuCols; t += kThreads) {
    const int w = t / (15 * kImuCols), m = t / kImuCols % 15, k = t % kImuCols;
    const T* S = a.pre_S + ((b * W + w) * 15 + m) * 15;
    const T* x = raw + w * 15 * kImuCols + k;
    T d = S[0] * x[0];
    for (int j = 1; j < 15; ++j) d = d + S[j] * x[j * kImuCols];
    imu[t] = d * a.pre_valid[b * W + w];
  }
  __syncthreads();
  if (stamp) a.stamps[4] = clock64();

  // 4. each pair's products of its columns, JᵀJ and Jᵀr (upper triangle,
  // mirrored), the 15 rows summed in order
  T* ip = sm + L.ip;
  constexpr int kPairTasks = 30 * 31 / 2 + 30;
  for (int t = tid; t < W * kPairTasks; t += kThreads) {
    const int w = t / kPairTasks;
    int u = t % kPairTasks, k, l;
    if (u < 30) {
      k = u, l = 30;
    } else {
      u -= 30;
      k = 0;
      while (u >= 30 - k) {
        u -= 30 - k;
        ++k;
      }
      l = k + u;
    }
    const T* m0 = imu + w * 15 * kImuCols;
    T d = T(0);
    for (int m = 0; m < 15; ++m) d = d + m0[m * kImuCols + k] * m0[m * kImuCols + l];
    ip[w * kImuProd + k * kImuCols + l] = d;
    if (l < 30) ip[w * kImuProd + l * kImuCols + k] = d;
  }
  __syncthreads();

  // 5. H and g: each entry the projection sum, the IMU pairs that touch it,
  // then the small rows; a warp a row of H
  T* H = a.H + b * D * D;
  const T* H0 = a.H0 + b * D * D;
  for (int r = warp; r < D; r += kWarps) {
    const int ar = r < P ? r : (r >= X && r < X + 6 + TD) ? P + r - X : -1;
    int fr, orr;
    const bool ri = imu_slot(r, nf, fr, orr);
    for (int c0 = lane; c0 < D; c0 += 8 * 32) {
      T h0[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h0[i] = c0 + 32 * i < D ? H0[r * D + c0 + 32 * i] : T(0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + 32 * i;
        if (c >= D) break;
        const int ac = c < P ? c : (c >= X && c < X + 6 + TD) ? P + c - X : -1;
        T s = ar >= 0 && ac >= 0 ? acc0[packed(ar, ac, E)] : T(0);
        int fc, oc;
        if (ri && imu_slot(c, nf, fc, oc)) {
          const int lo = (fr > fc ? fr : fc) - 1, hi = fr < fc ? fr : fc;
          for (int w = lo < 0 ? 0 : lo; w <= hi && w < W; ++w)
            s = s + ip[w * kImuProd + imu_col(fr, orr, w) * kImuCols +
                       imu_col(fc, oc, w)];
        }
        H[r * D + c] = s + h0[i];
      }
    }
  }
  for (int r = tid; r < D; r += kThreads) {
    const int ar = r < P ? r : (r >= X && r < X + 6 + TD) ? P + r - X : -1;
    T s = ar >= 0 ? acc0[npk + ar] : T(0);
    int fr, orr;
    if (imu_slot(r, nf, fr, orr))
      for (int w = fr - 1 < 0 ? 0 : fr - 1; w <= fr && w < W; ++w)
        s = s + ip[w * kImuProd + imu_col(fr, orr, w) * kImuCols + 30];
    a.g[b * D + r] = s + gs[r];
  }
  if (a.stamps) {
    __syncthreads();
    if (stamp) a.stamps[5] = clock64();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
normal_eq_fused_kernel(const __grid_constant__ Args<T> a) {
  normal_eq_body<false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
normal_eq_fused_td_kernel(const __grid_constant__ Args<T> a) {
  normal_eq_body<true>(a);
}

// the number of warps that sum projection factors, the most (up to 8) whose
// copies fit in a block's shared memory; 0 if not even one does
int warps_for(int nf, int elem, bool td) {
  for (int nw = kWarps; nw >= 1; --nw)
    if (static_cast<long>(layout(nf, nw, td).total) * elem <= kMaxSmem) return nw;
  return 0;
}

template <typename T>
int launch(const void* const* ptr, int batch, int nf, int nfeat, double c2,
           double sqrt_aw, int est_ext, const double* td_consts, void* stream) {
  Args<T> a;
  const bool td = td_consts != nullptr;
  const T** in[] = {&a.p, &a.q, &a.v, &a.ba, &a.bg, &a.tic, &a.qic, &a.td,
                    &a.inv_depth, &a.pre_dp, &a.pre_dq, &a.pre_dv, &a.pre_J,
                    &a.pre_dt, &a.pre_ba, &a.pre_bg, &a.pre_S, &a.pre_valid,
                    &a.pts, &a.mask, &a.feat_valid, &a.feat_w, &a.zupt_w,
                    &a.J0, &a.r0, &a.lin_p, &a.lin_q, &a.lin_v, &a.lin_ba,
                    &a.lin_bg, &a.lin_tic, &a.lin_qic, &a.lin_td, &a.prior_w,
                    &a.p_ref, &a.q_ref, &a.pin_rp, &a.H0, &a.vel, &a.td_obs};
  // the td instance's two inputs follow H0
  const int n_in = sizeof(in) / sizeof(in[0]) - (td ? 0 : 2);
  for (int i = 0; i < n_in; ++i) *in[i] = static_cast<const T*>(ptr[i]);
  if (!td) a.vel = a.td_obs = nullptr;
  a.anchor = static_cast<const int64_t*>(ptr[n_in]);
  a.H = static_cast<T*>(const_cast<void*>(ptr[n_in + 1]));
  a.g = static_cast<T*>(const_cast<void*>(ptr[n_in + 2]));
  a.H_lp = static_cast<T*>(const_cast<void*>(ptr[n_in + 3]));
  a.h_ll = static_cast<T*>(const_cast<void*>(ptr[n_in + 4]));
  a.g_l = static_cast<T*>(const_cast<void*>(ptr[n_in + 5]));
  a.stamps = static_cast<long long*>(const_cast<void*>(ptr[n_in + 6]));
  a.nf = nf;
  a.nfeat = nfeat;
  a.nw = warps_for(nf, sizeof(T), td);
  a.c2 = static_cast<T>(c2);
  a.sqrt_aw = static_cast<T>(sqrt_aw);
  a.est_ext = est_ext;
  a.tr_over_row = static_cast<T>(td ? td_consts[0] : 0.0);
  a.row_fy = static_cast<T>(td ? td_consts[1] : 0.0);
  a.row_c0 = static_cast<T>(td ? td_consts[2] : 0.0);
  if (a.nw == 0 || nf < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(layout(nf, a.nw, td).total) * sizeof(T);
  if (td)
    normal_eq_fused_td_kernel<T><<<batch, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  else
    normal_eq_fused_kernel<T><<<batch, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

// Lets the four instances (float32, float64; with and without td) take the
// shared memory a block may have, and loads them now rather than at their
// first launch inside a solve. Called once after the library is loaded;
// returns a CUDA error code.
extern "C" int avm_normal_eq_init() {
  const cudaError_t errs[] = {allow_smem(normal_eq_fused_kernel<float>),
                              allow_smem(normal_eq_fused_kernel<double>),
                              allow_smem(normal_eq_fused_td_kernel<float>),
                              allow_smem(normal_eq_fused_td_kernel<double>)};
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

// Warps that sum projection factors for NF frames in the given type, with or
// without the td column (the kernel's choice; 0: NF too large for a block's
// shared memory).
extern "C" int avm_normal_eq_warps(int nf, int f64, int td) {
  return warps_for(nf, f64 ? 8 : 4, td != 0);
}

// The normal equations of `batch` scenarios of NF frames and `nfeat`
// landmark slots. `ptr` holds, in this order, the device pointers of
// Args' inputs as `launch` lists them (feat_w, zupt_w and pin_rp may be 0;
// vel and td_obs only where `td_consts` is given, td_obs may be 0),
// the anchor frames (int64), then the outputs H, g, H_lp, h_ll, g_l; all
// contiguous, [batch, ...], of one type: float64 if `f64`, else float32;
// last the optional int64 stamps (0: none).
// `c2`: the Cauchy scale squared; `sqrt_aw`: the square root of the gauge
// anchor's weight; `td_consts`: null for a solve that holds td, else
// (TR / ROW, fy, cy - ROW / 2) of the time offset's instance. Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int avm_normal_eq_fused(const void* const* ptr, int batch, int nf,
                                   int nfeat, double c2, double sqrt_aw,
                                   int est_ext, int f64,
                                   const double* td_consts, void* stream) {
  if (batch <= 0) return 0;
  return f64 ? launch<double>(ptr, batch, nf, nfeat, c2, sqrt_aw, est_ext,
                              td_consts, stream)
             : launch<float>(ptr, batch, nf, nfeat, c2, sqrt_aw, est_ext,
                             td_consts, stream);
}
