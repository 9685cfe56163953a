"""The sliding-window VIO optimizer — batched Levenberg-Marquardt on torch.

Counterpart of `anticipated_vins_mono_tpu/ops/window.py`. The JAX version is
written for ONE scenario and batched from outside with `jax.vmap`; a
hand-written CUDA kernel cannot sit under `torch.func.vmap`, so here the
batch is written out: every leaf of `WindowState` / `WindowMeasurements` may
carry leading batch dimensions `[B, ...]`, every function broadcasts over
them, λ / cost / accept-reject are kept per scenario, and the whole
`[B,D,D]` batch of normal equations goes to the fused Schur kernel in one
launch (`WindowConfig.fused_schur`).

- projection factors are evaluated over a dense [F, NF] landmark×frame grid
  with validity masks; IMU factors over the W adjacent pairs; one
  marginalization prior; per-factor tangent Jacobians are forward-mode
  derivatives (`torch.func.jvp`, all tangent directions in one call);
- inverse-depth landmarks are eliminated with a Schur complement whose
  landmark block is exactly diagonal;
- the LM loop has a fixed iteration count with branchless accept/reject and
  no host synchronisation inside;
- Cauchy robust loss on projection factors via sqrt-weight reweighting.

State-vector tangent layout (D = 6·NF + 9·NF + 6 + 1 + 6):
  [6i:6i+6]          pose i       (δp, δθ)        i = 0..NF-1
  [6NF+9i : +9]      speed/bias i (δv, δba, δbg)
  [15NF : 15NF+6]    camera-IMU extrinsic (δtic, δθic)
  [15NF+6]           time offset td
  [15NF+7 : +6]      relocalization pose (zero columns without a relo frame)
Inverse depths are separate (Schur-eliminated), one per landmark slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from anticipated_vins_mono_torch.ops import factors, lie
from anticipated_vins_mono_torch.ops.preintegration import Preintegrated
from anticipated_vins_mono_torch.utils.timing import span, spanned
from anticipated_vins_mono_torch.utils.tree import tree_map, tree_to

Tensor = torch.Tensor


class WindowConfig(NamedTuple):
    """Static solver configuration; defaults mirror the reference deployment
    (10-keyframe window, 8 LM iterations, CauchyLoss(1.0))."""

    window: int = 10            # keyframe pairs; NF = window+1 frames
    max_feats: int = 128        # landmark slots F
    iters: int = 8              # LM outer iterations
    estimate_extrinsic: bool = True
    estimate_td: bool = False
    # rolling-shutter compensation: per-observation time shift
    # TR/ROW · (row − ROW/2), rows recovered from the normalized y-coordinate
    tr_over_row: float = 0.0       # TR / ROW  [s per pixel row]
    row_fy: float = 460.0          # fy for row recovery
    row_c0: float = 8.1            # cy − ROW/2
    cauchy_scale: float = 1.0
    anchor_weight: float = 1e3  # gauge anchor on pose 0 when no prior
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    min_inv_depth: float = 0.01  # clamp: depths beyond 100 m
    tri_min_parallax: float = 1.5 / 460.0
    lm_strategy: str = "halving"  # "halving" | "nielsen"
    # fused Schur-reduction/solve CUDA kernel (f32, one launch for the whole
    # batch, ops/hopper_kernels.schur_solve_fused) instead of the f64
    # einsum→cholesky→cholesky_solve chain of `schur_solve`. The counterpart
    # of the JAX package's `pallas_schur`.
    fused_schur: bool = False
    # kept for field parity with the JAX config: its blocked Cholesky exists
    # for the TPU's triangular kernels; here both values take
    # torch.linalg.cholesky / cholesky_solve
    fast_chol: bool = False
    # accumulation precision of the delicate steps. The JAX package's "df32"
    # (double-float emulation for a chip without f64) maps to the genuine
    # f64 path here: both values cast to float64.
    accum: str = "f64"

    @property
    def nf(self) -> int:
        return self.window + 1

    @property
    def dim(self) -> int:
        return 15 * self.nf + 6 + 1 + 6


class WindowState(NamedTuple):
    """Optimizable window state; every leaf may carry leading batch dims."""

    p: Tensor          # [...,NF,3]
    q: Tensor          # [...,NF,4] wxyz
    v: Tensor          # [...,NF,3]
    ba: Tensor         # [...,NF,3]
    bg: Tensor         # [...,NF,3]
    tic: Tensor        # [...,3]
    qic: Tensor        # [...,4]
    td: Tensor         # [...]
    inv_depth: Tensor  # [...,F]
    relo_p: Optional[Tensor] = None   # [...,3] relocalization-frame pose
    relo_q: Optional[Tensor] = None   # [...,4]

    @staticmethod
    def identity(cfg: WindowConfig, dtype=torch.float64,
                 device=None) -> "WindowState":
        nf, f = cfg.nf, cfg.max_feats
        kw = dict(dtype=dtype, device=device)
        qI = lie.quat_identity(dtype, device)
        return WindowState(
            p=torch.zeros((nf, 3), **kw), q=qI.repeat(nf, 1),
            v=torch.zeros((nf, 3), **kw),
            ba=torch.zeros((nf, 3), **kw), bg=torch.zeros((nf, 3), **kw),
            tic=torch.zeros(3, **kw), qic=qI.clone(),
            td=torch.zeros((), **kw), inv_depth=torch.ones(f, **kw))


class PriorFactor(NamedTuple):
    """Marginalization prior: r(x) = r0 + J0 · ⊟(x, x_lin). Rows are padded
    to D; `weight` gates validity."""

    J0: Tensor           # [...,D,D]
    r0: Tensor           # [...,D]
    lin: WindowState     # linearization point (inv_depth ignored)
    weight: Tensor       # [...] 0.0 or 1.0

    @staticmethod
    def empty(cfg: WindowConfig, dtype=torch.float64,
              device=None) -> "PriorFactor":
        d = cfg.dim
        kw = dict(dtype=dtype, device=device)
        return PriorFactor(
            J0=torch.zeros((d, d), **kw), r0=torch.zeros(d, **kw),
            lin=WindowState.identity(cfg, dtype, device),
            weight=torch.zeros((), **kw))


class WindowMeasurements(NamedTuple):
    """Static-shape measurement bundle for one window solve."""

    pre: Preintegrated    # leaves [...,W,·]
    pre_valid: Tensor     # [...,W] 1/0 — pair participates
    pts: Tensor           # [...,F,NF,3] normalized-plane obs (z=1)
    vel: Tensor           # [...,F,NF,2] normalized-plane velocity (for td)
    mask: Tensor          # [...,F,NF] 1/0 observation validity
    anchor: Tensor        # [...,F] integer first observing frame
    feat_valid: Tensor    # [...,F] 1/0 slot in use
    prior: PriorFactor
    relo_pts: Optional[Tensor] = None    # [...,F,3] matched obs in the relo frame
    relo_valid: Optional[Tensor] = None  # [...,F] 1/0 match per landmark slot
    anchor_pin_rp: Optional[Tensor] = None  # [...] roll/pitch anchor scaling
    zupt_w: Optional[Tensor] = None      # [...,NF] sqrt-information on v_i ≈ 0
    td_obs: Optional[Tensor] = None      # [...,NF] td at each frame's capture
    feat_w: Optional[Tensor] = None      # [...,F] per-landmark sqrt-info multiplier


# ----------------------------------------------------------------------------
# Tangent-vector plumbing
# ----------------------------------------------------------------------------


def _sign_w(q: Tensor) -> Tensor:
    """+1 where the scalar part is ≥ 0, else −1; shape [...,1]."""
    w = q[..., :1]
    return torch.where(w >= 0, torch.ones_like(w), -torch.ones_like(w))


def state_boxminus(x: WindowState, lin: WindowState, cfg: WindowConfig) -> Tensor:
    """dx = x ⊟ lin as a flat [...,D] tangent.

    Kept equal to the JAX function term by term — including its per-frame
    rotation block, which carries vec(q_lin⁻¹ ⊗ q) WITHOUT the factor 2 that
    the extrinsic block (and the reference's marginalization factor) has.
    """
    batch = x.p.shape[:-2]
    qrel_f = lie.quat_mul(lie.quat_conj(lin.q), x.q)
    pose = torch.cat([x.p - lin.p, qrel_f[..., 1:4] * _sign_w(qrel_f)], dim=-1)
    sb = torch.cat([x.v - lin.v, x.ba - lin.ba, x.bg - lin.bg], dim=-1)
    dext_p = x.tic - lin.tic
    qrel = lie.quat_mul(lie.quat_conj(lin.qic), x.qic)
    dext_th = 2.0 * qrel[..., 1:4] * _sign_w(qrel)
    return torch.cat([
        pose.reshape(batch + (-1,)), sb.reshape(batch + (-1,)),
        dext_p, dext_th, (x.td - lin.td)[..., None],
        x.p.new_zeros(batch + (6,))], dim=-1)  # relo block: never in the prior


def retract(x: WindowState, dx: Tensor, d_rho: Tensor,
            cfg: WindowConfig) -> WindowState:
    """x ⊞ dx — boxplus on every block; dx [...,D], d_rho [...,F]."""
    nf = cfg.nf
    batch = dx.shape[:-1]
    pose_dx = dx[..., : 6 * nf].reshape(batch + (nf, 6))
    sb_dx = dx[..., 6 * nf: 15 * nf].reshape(batch + (nf, 9))
    ext_dx = dx[..., 15 * nf: 15 * nf + 6]
    td_dx = dx[..., 15 * nf + 6]
    p, q = lie.pose_boxplus(x.p, x.q, pose_dx)
    tic, qic = lie.pose_boxplus(x.tic, x.qic, ext_dx)
    inv_depth = torch.clamp(x.inv_depth + d_rho, min=cfg.min_inv_depth)
    relo_p, relo_q = x.relo_p, x.relo_q
    if relo_p is not None:
        relo_dx = dx[..., 15 * nf + 7: 15 * nf + 13]
        relo_p, relo_q = lie.pose_boxplus(relo_p, relo_q, relo_dx)
    return WindowState(
        p=p, q=q, v=x.v + sb_dx[..., 0:3], ba=x.ba + sb_dx[..., 3:6],
        bg=x.bg + sb_dx[..., 6:9], tic=tic, qic=qic, td=x.td + td_dx,
        inv_depth=inv_depth, relo_p=relo_p, relo_q=relo_q)


# ----------------------------------------------------------------------------
# Gathers over the landmark × frame grid
# ----------------------------------------------------------------------------


def _take_frames(x: Tensor, idx: Tensor) -> Tensor:
    """x [...,NF,C], idx [...,F] → x[..., idx, :] as [...,F,C] (per batch)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _take_anchor_obs(x: Tensor, idx: Tensor) -> Tensor:
    """x [...,F,NF,C], idx [...,F] → x[..., l, idx[l], :] as [...,F,C]."""
    g = idx[..., None, None].expand(idx.shape + (1,) + x.shape[-1:])
    return torch.gather(x, -2, g)[..., 0, :]


def _grid(x: Tensor, lead: tuple, trailing: tuple) -> Tensor:
    return x.expand(lead + trailing)


class _ProjGrid(NamedTuple):
    """What every projection factor of the [F,NF] grid needs, already
    gathered and expanded to the grid shape."""

    pose_a: factors.PoseTangent
    pose_j: factors.PoseTangent
    pose_e: factors.PoseTangent
    invd: Tensor
    pt_i: Tensor
    pt_j: Tensor
    valid: Tensor      # [...,F,NF]
    anchor: Tensor     # [...,F] int64


def _proj_grid(state: WindowState, meas: WindowMeasurements,
               cfg: WindowConfig) -> _ProjGrid:
    F, NF = cfg.max_feats, cfg.nf
    batch = state.p.shape[:-2]
    lead = batch + (F, NF)
    a = meas.anchor.long()
    p_a = _take_frames(state.p, a)
    q_a = _take_frames(state.q, a)
    pt_i = _take_anchor_obs(meas.pts, a)
    frame = torch.arange(NF, device=a.device)
    mask_a = torch.gather(meas.mask, -1, a[..., None])         # [...,F,1]
    valid = (mask_a * meas.mask * meas.feat_valid[..., None]
             * (frame != a[..., None]).to(meas.mask.dtype))
    return _ProjGrid(
        pose_a=factors.PoseTangent(_grid(p_a[..., :, None, :], lead, (3,)),
                                   _grid(q_a[..., :, None, :], lead, (4,))),
        pose_j=factors.PoseTangent(_grid(state.p[..., None, :, :], lead, (3,)),
                                   _grid(state.q[..., None, :, :], lead, (4,))),
        pose_e=factors.PoseTangent(
            _grid(state.tic[..., None, None, :], lead, (3,)),
            _grid(state.qic[..., None, None, :], lead, (4,))),
        invd=_grid(state.inv_depth[..., :, None], lead, ()),
        pt_i=_grid(pt_i[..., :, None, :], lead, (3,)),
        pt_j=meas.pts, valid=valid, anchor=a)


def _td_consts(state: WindowState, meas: WindowMeasurements,
               cfg: WindowConfig, g: _ProjGrid):
    """Per-factor constants of the td / rolling-shutter observation model."""
    lead = g.invd.shape
    vel_i = _grid(_take_anchor_obs(meas.vel, g.anchor)[..., :, None, :],
                  lead, (2,))
    if meas.td_obs is not None:
        td_i = torch.gather(meas.td_obs, -1, g.anchor)[..., :, None]
        td_i = _grid(td_i, lead, ())
        td_j = _grid(meas.td_obs[..., None, :], lead, ())
    else:
        td_i = td_j = torch.zeros(lead, dtype=g.pt_i.dtype,
                                  device=g.pt_i.device)
    # centered pixel rows from normalized y
    row_i = cfg.row_fy * g.pt_i[..., 1] + cfg.row_c0
    row_j = cfg.row_fy * g.pt_j[..., 1] + cfg.row_c0
    return (g.pt_i, g.pt_j, vel_i, meas.vel, td_i, td_j, row_i, row_j)


# ----------------------------------------------------------------------------
# Linearization (batched)
# ----------------------------------------------------------------------------


def _proj_factor_rows(state: WindowState, meas: WindowMeasurements,
                      cfg: WindowConfig):
    """All projection factors of the [F,NF] grid: residual [...,F,NF,2],
    tangent Jacobian blocks (anchor/frame/extrinsic [...,2,6], td [...,2]),
    landmark column [...,2], robust×validity weight, robust-loss argument."""
    g = _proj_grid(state, meas, cfg)
    if cfg.estimate_td:
        def res_fn(pa, pj, pe, rho, td, pt_i, pt_j, vel_i, vel_j,
                   td_i, td_j, row_i, row_j):
            return factors.projection_td_residual(
                pa.p, pa.q, pj.p, pj.q, pe.p, pe.q, rho, td,
                pt_i, pt_j, vel_i, vel_j,
                td_i, td_j, row_i, row_j, cfg.tr_over_row)

        td = _grid(state.td[..., None, None], g.invd.shape, ())
        res, (J_a, J_j, J_e, J_rho, J_td) = factors.tangent_jacobian(
            res_fn, (g.pose_a, g.pose_j, g.pose_e), (g.invd, td),
            _td_consts(state, meas, cfg, g))
    else:
        def res_fn(pa, pj, pe, rho, pt_i, pt_j):
            return factors.projection_residual(
                pa.p, pa.q, pj.p, pj.q, pe.p, pe.q, rho, pt_i, pt_j)

        res, (J_a, J_j, J_e, J_rho) = factors.tangent_jacobian(
            res_fn, (g.pose_a, g.pose_j, g.pose_e), (g.invd,),
            (g.pt_i, g.pt_j))
        J_td = torch.zeros_like(res)

    if meas.feat_w is not None:
        fw = meas.feat_w[..., :, None]
    else:
        fw = torch.ones_like(g.valid[..., :1])
    sq = torch.sum(res * res, dim=-1) * fw * fw
    w = factors.cauchy_weight(sq, cfg.cauchy_scale) * g.valid * fw
    if not cfg.estimate_extrinsic:
        J_e = torch.zeros_like(J_e)
    return res, (J_a, J_j, J_e, J_td), J_rho, w, sq * g.valid


def _weighted_proj_rows(state, meas, cfg):
    """`_proj_factor_rows` with the Triggs sqrt(ρ') weight applied to the
    residual and to every Jacobian block."""
    p_res, (J_a, J_j, J_e, J_td), p_rho, p_w, p_sq = _proj_factor_rows(
        state, meas, cfg)
    p_res = p_res * p_w[..., None]
    wj = p_w[..., None, None]
    J_a, J_j, J_e = J_a * wj, J_j * wj, J_e * wj
    J_td = J_td * p_w[..., None]
    p_rho = p_rho * p_w[..., None]
    return p_res, (J_a, J_j, J_e, J_td), p_rho, p_sq


def _pair_args(state: WindowState, meas: WindowMeasurements, cfg: WindowConfig):
    W = cfg.window
    sb = torch.cat([state.v, state.ba, state.bg], dim=-1)       # [...,NF,9]
    pose_i = factors.PoseTangent(state.p[..., :W, :], state.q[..., :W, :])
    pose_j = factors.PoseTangent(state.p[..., 1:W + 1, :],
                                 state.q[..., 1:W + 1, :])
    return pose_i, pose_j, sb[..., :W, :], sb[..., 1:W + 1, :]


def _imu_residuals(state: WindowState, meas: WindowMeasurements,
                   cfg: WindowConfig) -> Tensor:
    """Whitened IMU residuals of the W pairs, [...,W,15]."""
    W = cfg.window
    s = state
    return factors.imu_residual(
        s.p[..., :W, :], s.q[..., :W, :], s.v[..., :W, :], s.ba[..., :W, :],
        s.bg[..., :W, :],
        s.p[..., 1:W + 1, :], s.q[..., 1:W + 1, :], s.v[..., 1:W + 1, :],
        s.ba[..., 1:W + 1, :], s.bg[..., 1:W + 1, :], meas.pre)


def _imu_factor_rows(state: WindowState, meas: WindowMeasurements,
                     cfg: WindowConfig):
    """IMU factors between frames i and i+1 for all W pairs: whitened
    residual [...,W,15], tangent Jacobian blocks, validity weight [...,W]."""
    pose_i, pose_j, sb_i, sb_j = _pair_args(state, meas, cfg)

    def res_fn(pi, pj, si, sj, pre_i):
        return factors.imu_residual(
            pi.p, pi.q, si[..., 0:3], si[..., 3:6], si[..., 6:9],
            pj.p, pj.q, sj[..., 0:3], sj[..., 3:6], sj[..., 6:9], pre_i)

    res, (J_pi, J_pj, J_si, J_sj) = factors.tangent_jacobian(
        res_fn, (pose_i, pose_j), (sb_i, sb_j), (meas.pre,))
    return res, (J_pi, J_pj, J_si, J_sj), meas.pre_valid


def _relo_grid(state: WindowState, meas: WindowMeasurements,
               cfg: WindowConfig):
    F = cfg.max_feats
    lead = state.p.shape[:-2] + (F,)
    a = meas.anchor.long()
    pose_a = factors.PoseTangent(_take_frames(state.p, a),
                                 _take_frames(state.q, a))
    pose_r = factors.PoseTangent(_grid(state.relo_p[..., None, :], lead, (3,)),
                                 _grid(state.relo_q[..., None, :], lead, (4,)))
    pose_e = factors.PoseTangent(_grid(state.tic[..., None, :], lead, (3,)),
                                 _grid(state.qic[..., None, :], lead, (4,)))
    pt_i = _take_anchor_obs(meas.pts, a)
    mask_a = torch.gather(meas.mask, -1, a[..., None])[..., 0]
    valid = mask_a * meas.feat_valid * meas.relo_valid
    return pose_a, pose_r, pose_e, pt_i, valid


def _relo_factor_rows(state: WindowState, meas: WindowMeasurements,
                      cfg: WindowConfig):
    """Relocalization projection factors, one per landmark: the landmark
    (anchored in the window) reprojected into the relo pose against its
    matched observation."""
    pose_a, pose_r, pose_e, pt_i, valid = _relo_grid(state, meas, cfg)

    def res_fn(pa, pr, pe, rho, pt_a, pt_r):
        return factors.projection_residual(
            pa.p, pa.q, pr.p, pr.q, pe.p, pe.q, rho, pt_a, pt_r)

    res, (J_a, J_r, J_e, J_rho) = factors.tangent_jacobian(
        res_fn, (pose_a, pose_r, pose_e), (state.inv_depth,),
        (pt_i, meas.relo_pts))
    sq = torch.sum(res * res, dim=-1)
    w = factors.cauchy_weight(sq, cfg.cauchy_scale) * valid
    if not cfg.estimate_extrinsic:
        J_e = torch.zeros_like(J_e)
    return res, (J_a, J_r, J_e), J_rho, w, sq * valid


def _anchor_rows(state: WindowState, anchor_ref, cfg: WindowConfig,
                 has_prior: Tensor, pin_rp=None):
    """Gauge anchor: soft prior pinning pose 0 to its value at solve entry,
    active only when no marginalization prior exists yet.

    `pin_rp` (default 1.0) scales the ROLL/PITCH rows: the rotation error is
    expressed on world axes, the world-z row is yaw (always pinned), the
    world-x/y rows are roll/pitch. A reboot path passes 0 there so that a
    one-sample gravity alignment stays correctable."""
    d = cfg.dim
    dtype, dev = state.p.dtype, state.p.device
    batch = state.p.shape[:-2]
    p_ref, q_ref = anchor_ref
    w = (cfg.anchor_weight ** 0.5) * (1.0 - has_prior)
    w = w.to(dtype).expand(batch)
    if pin_rp is None:
        pin_rp = torch.ones((), dtype=dtype, device=dev)
    qrel = lie.quat_mul(lie.quat_conj(q_ref), state.q[..., 0, :])
    dth = 2.0 * qrel[..., 1:4] * _sign_w(qrel)
    R_ref = lie.quat_to_rot(q_ref)
    w_rows = torch.stack([w * pin_rp, w * pin_rp, w], dim=-1)    # [...,3]
    r_rot = w_rows * (R_ref @ dth[..., None])[..., 0]
    r = torch.cat([w[..., None] * (state.p[..., 0, :] - p_ref), r_rot], dim=-1)
    J = torch.zeros(batch + (6, d), dtype=dtype, device=dev)
    J[..., :3, :3] = torch.eye(3, dtype=dtype, device=dev) * w[..., None, None]
    J[..., 3:6, 3:6] = w_rows[..., :, None] * R_ref
    return r, J


def _imu_rows_dense(state, meas, cfg):
    """IMU residuals and their dense [...,W,15,D] Jacobian rows."""
    NF, W = cfg.nf, cfg.window
    dtype, dev = state.p.dtype, state.p.device
    batch = state.p.shape[:-2]
    i_res, (J_pi, J_pj, J_si, J_sj), i_w = _imu_factor_rows(state, meas, cfg)
    i_res = i_res * i_w[..., None]
    wi = i_w[..., None, None]
    J_pi, J_pj, J_si, J_sj = J_pi * wi, J_pj * wi, J_si * wi, J_sj * wi
    eye_nf = torch.eye(NF, dtype=dtype, device=dev)
    ipose = torch.einsum("wn,...wrc->...wrnc", eye_nf[:W], J_pi) + \
        torch.einsum("wn,...wrc->...wrnc", eye_nf[1:W + 1], J_pj)
    isb = torch.einsum("wn,...wrc->...wrnc", eye_nf[:W], J_si) + \
        torch.einsum("wn,...wrc->...wrnc", eye_nf[1:W + 1], J_sj)
    i_rows = torch.cat(
        [ipose.reshape(batch + (W, 15, 6 * NF)),
         isb.reshape(batch + (W, 15, 9 * NF)),
         torch.zeros(batch + (W, 15, 13), dtype=dtype, device=dev)], dim=-1)
    return i_res, i_rows


def _prior_rows(state, meas, cfg):
    dx_lin = state_boxminus(state, meas.prior.lin, cfg)
    wgt = meas.prior.weight
    pr_res = (meas.prior.r0 + (meas.prior.J0 @ dx_lin[..., None])[..., 0]) \
        * wgt[..., None]
    return pr_res, meas.prior.J0 * wgt[..., None, None]


def _zupt_rows(state, meas, cfg):
    """Zero-velocity pseudo-measurement rows: residual [...,3NF] and the
    identity on each frame's velocity block, scaled by `zupt_w`."""
    NF, D = cfg.nf, cfg.dim
    dtype, dev = state.p.dtype, state.p.device
    batch = state.p.shape[:-2]
    z_res = (meas.zupt_w[..., :, None] * state.v).reshape(batch + (-1,))
    zrows = torch.zeros((NF, 3, D), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    for i_f in range(NF):
        zrows[i_f, :, 6 * NF + 9 * i_f: 6 * NF + 9 * i_f + 3] = eye3
    zrows = zrows * meas.zupt_w[..., :, None, None]
    return z_res, zrows.reshape(batch + (-1, D))


def _small_dense_rows(state, meas, cfg, anchor_ref):
    """IMU + prior + anchor (+ ZUPT) residuals [...,Ns] and rows [...,Ns,D]:
    the row groups that stay dense in both linearization paths."""
    D = cfg.dim
    batch = state.p.shape[:-2]
    i_res, i_rows = _imu_rows_dense(state, meas, cfg)
    pr_res, pr_rows = _prior_rows(state, meas, cfg)
    if anchor_ref is None:
        anchor_ref = (state.p[..., 0, :], state.q[..., 0, :])
    a_res, a_rows = _anchor_rows(state, anchor_ref, cfg, meas.prior.weight,
                                 pin_rp=meas.anchor_pin_rp)
    res = [i_res.reshape(batch + (-1,)), pr_res, a_res]
    rows = [i_rows.reshape(batch + (-1, D)), pr_rows.expand(batch + (D, D)),
            a_rows]
    if meas.zupt_w is not None:
        z_res, z_rows = _zupt_rows(state, meas, cfg)
        res.append(z_res)
        rows.append(z_rows)
    return torch.cat(res, dim=-1), torch.cat(rows, dim=-2)


def linearize(state: WindowState, meas: WindowMeasurements, cfg: WindowConfig,
              anchor_ref=None):
    """All residual rows + dense Jacobian blocks (the general path, used when
    a relocalization frame is attached).

    Returns (r_all [...,N], J_all [...,N,D], p_res [...,F,NFx,2],
    p_rows [...,F,NFx,2,D], p_rho [...,F,NFx,2], p_sq [...,F,NFx]) where
    NFx = NF (+1 with a relo frame): the landmark columns stay factored out
    for the Schur step and p_sq carries the raw robust-loss arguments.
    """
    F, NF, D = cfg.max_feats, cfg.nf, cfg.dim
    dtype, dev = state.p.dtype, state.p.device
    batch = state.p.shape[:-2]
    zeros = lambda *s: torch.zeros(batch + s, dtype=dtype, device=dev)

    p_res, (J_a, J_j, J_e, J_td), p_rho, p_sq = _weighted_proj_rows(
        state, meas, cfg)
    p_sq = p_sq.clone()

    # dense rows: anchor blocks through the one-hot of the anchor index,
    # frame blocks at their own grid column, extrinsic/td columns appended
    onehot_a = torch.nn.functional.one_hot(meas.anchor.long(), NF).to(dtype)
    pose_a = torch.einsum("...fn,...fjrc->...fjrnc", onehot_a, J_a)
    pose_j = torch.einsum("jn,...fjrc->...fjrnc",
                          torch.eye(NF, dtype=dtype, device=dev), J_j)
    pose_cols = (pose_a + pose_j).reshape(batch + (F, NF, 2, 6 * NF))
    p_rows = torch.cat(
        [pose_cols, zeros(F, NF, 2, 9 * NF), J_e, J_td[..., None],
         zeros(F, NF, 2, 6)], dim=-1)                          # [...,F,NF,2,D]

    if meas.relo_pts is not None:
        # relo factors enter as one extra pseudo-frame column of the grid so
        # that the Schur elimination sees their landmark terms
        rr, (rJ_a, rJ_r, rJ_e), r_rho, r_w, r_sq = _relo_factor_rows(
            state, meas, cfg)
        rr = rr * r_w[..., None]
        rw2 = r_w[..., None, None]
        rJ_a, rJ_r, rJ_e = rJ_a * rw2, rJ_r * rw2, rJ_e * rw2
        r_rho = r_rho * r_w[..., None]
        rpose = torch.einsum("...fn,...frc->...frnc", onehot_a, rJ_a)\
            .reshape(batch + (F, 2, 6 * NF))
        r_rows = torch.cat(
            [rpose, zeros(F, 2, 9 * NF), rJ_e, zeros(F, 2, 1), rJ_r], dim=-1)
        p_res = torch.cat([p_res, rr[..., :, None, :]], dim=-2)
        p_rows = torch.cat([p_rows, r_rows[..., :, None, :, :]], dim=-3)
        p_rho = torch.cat([p_rho, r_rho[..., :, None, :]], dim=-2)
        p_sq = torch.cat([p_sq, r_sq[..., :, None]], dim=-1)

    s_res, s_rows = _small_dense_rows(state, meas, cfg, anchor_ref)
    r_all = torch.cat([p_res.reshape(batch + (-1,)), s_res], dim=-1)
    J_all = torch.cat([p_rows.reshape(batch + (-1, D)), s_rows], dim=-2)
    return r_all, J_all, p_res, p_rows, p_rho, p_sq


def _cauchy_cost(res: Tensor, fw, valid: Tensor, cfg: WindowConfig) -> Tensor:
    s2 = torch.sum(res * res, dim=-1)
    if fw is not None:
        s2 = s2 * fw * fw
    c2 = cfg.cauchy_scale ** 2
    return 0.5 * c2 * torch.log1p(s2 / c2) * valid


def _cost_terms(state: WindowState, meas: WindowMeasurements,
                cfg: WindowConfig, anchor_ref=None) -> Tensor:
    """Per-factor cost contributions 0.5·ρ(‖r‖²) as one flat [...,N] vector
    in the state's dtype; `robust_cost` sums it in f64."""
    batch = state.p.shape[:-2]
    g = _proj_grid(state, meas, cfg)
    pa, pj, pe = g.pose_a, g.pose_j, g.pose_e
    if cfg.estimate_td:
        # the observation model must match the linearization's: LM accepts
        # steps against this objective
        td = _grid(state.td[..., None, None], g.invd.shape, ())
        res = factors.projection_td_residual(
            pa.p, pa.q, pj.p, pj.q, pe.p, pe.q, g.invd, td,
            *_td_consts(state, meas, cfg, g), cfg.tr_over_row)
    else:
        res = factors.projection_residual(
            pa.p, pa.q, pj.p, pj.q, pe.p, pe.q, g.invd, g.pt_i, g.pt_j)
    fw = meas.feat_w[..., :, None] if meas.feat_w is not None else None
    pc = _cauchy_cost(res, fw, g.valid, cfg).reshape(batch + (-1,))

    i_res = _imu_residuals(state, meas, cfg)
    ic = 0.5 * torch.sum(i_res * i_res, dim=-1) * meas.pre_valid

    terms = [pc, ic]
    if meas.relo_pts is not None:
        ra, rr, re, pt_i, valid = _relo_grid(state, meas, cfg)
        res = factors.projection_residual(
            ra.p, ra.q, rr.p, rr.q, re.p, re.q, state.inv_depth,
            pt_i, meas.relo_pts)
        terms.append(_cauchy_cost(res, None, valid, cfg))

    pr, _ = _prior_rows(state, meas, cfg)
    terms.append(0.5 * pr * pr)

    if anchor_ref is None:
        anchor_ref = (state.p[..., 0, :], state.q[..., 0, :])
    a_res, _ = _anchor_rows(state, anchor_ref, cfg, meas.prior.weight,
                            pin_rp=meas.anchor_pin_rp)
    terms.append(0.5 * a_res * a_res)
    if meas.zupt_w is not None:
        terms.append(0.5 * ((meas.zupt_w[..., :, None] * state.v) ** 2)
                     .reshape(batch + (-1,)))
    return torch.cat(terms, dim=-1)


def imu_chi2_mean(state: WindowState, meas: WindowMeasurements,
                  cfg: WindowConfig) -> Tensor:
    """Mean whitened IMU-residual chi² per valid preintegration pair — a
    noise-model consistency diagnostic (≈15 under a correct model)."""
    res = _imu_residuals(state, meas, cfg)
    chi2 = torch.sum(res * res, dim=-1) * meas.pre_valid
    return torch.sum(chi2, dim=-1) / torch.clamp(
        torch.sum(meas.pre_valid, dim=-1), min=1.0)


def prior_chi2(state: WindowState, meas: WindowMeasurements,
               cfg: WindowConfig) -> Tensor:
    """‖r₀ + J₀·⊟(x, x_lin)‖² of the marginalization prior at `state`."""
    pr, _ = _prior_rows(state, meas, cfg)
    return torch.sum(pr * pr, dim=-1)


def robust_cost(state: WindowState, meas: WindowMeasurements,
                cfg: WindowConfig, anchor_ref=None) -> Tensor:
    """0.5·Σ ρ(‖r‖²) over all factors per scenario, accumulated in f64: LM's
    accept/reject compares costs whose difference is ~1e-7 relative, which
    f32 summation noise over thousands of terms would bury."""
    t = _cost_terms(state, meas, cfg, anchor_ref)
    return torch.sum(t.to(torch.float64), dim=-1)


# ----------------------------------------------------------------------------
# Normal equations + Schur complement + LM loop
# ----------------------------------------------------------------------------


def build_normal_equations(r_all, J_all, p_res, p_rows, p_rho,
                           cfg: WindowConfig):
    """H_pp, g_p, plus the landmark blocks for Schur elimination, from the
    dense rows of `linearize`. H_ll is diagonal by construction (no factor
    touches two landmarks); H_pl is a per-landmark sum over its factors."""
    H = J_all.mT @ J_all                                    # [...,D,D]
    g = (J_all.mT @ r_all[..., None])[..., 0]               # [...,D]
    H_lp = torch.einsum("...fnr,...fnrd->...fd", p_rho, p_rows)
    h_ll = torch.einsum("...fnr,...fnr->...f", p_rho, p_rho)
    g_l = torch.einsum("...fnr,...fnr->...f", p_rho, p_res)
    return H, g, H_lp, h_ll, g_l


def normal_equations_fast(state: WindowState, meas: WindowMeasurements,
                          cfg: WindowConfig, anchor_ref=None):
    """Blockwise normal equations for the LM hot loop.

    `linearize` materializes dense projection rows [F,NF,2,D]; here H's
    projection contribution is assembled directly from the 6-dim factor
    blocks with one-hot anchor einsums — identical math (the outer product
    of a row whose only nonzero blocks are (anchor, frame, ext, td) expands
    into block-pair terms) at a fraction of the memory traffic. The small
    row groups (IMU, prior, anchor, ZUPT) stay dense. Used when no relo
    frame is attached.
    """
    F, NF, D = cfg.max_feats, cfg.nf, cfg.dim
    dtype, dev = state.p.dtype, state.p.device
    batch = state.p.shape[:-2]

    p_res, (J_a, J_j, J_e, J_td), p_rho, _ = _weighted_proj_rows(
        state, meas, cfg)

    A = torch.nn.functional.one_hot(meas.anchor.long(), NF).to(dtype)  # [...,F,NF]
    es = torch.einsum
    # pose-pose block grid [...,NF,NF,6,6]
    AJ_a = es("...fn,...fjra->...nfjra", A, J_a)     # anchor blocks by frame
    T_aa = es("...nfjra,...fjrb->...nab", AJ_a, J_a)
    T_jj = es("...fjra,...fjrb->...jab", J_j, J_j)
    T_aj = es("...nfjra,...fjrb->...njab", AJ_a, J_j)
    eyeNF = torch.eye(NF, dtype=dtype, device=dev)
    H_pp = (eyeNF[:, :, None, None] * (T_aa + T_jj)[..., :, None, :, :]
            + T_aj + T_aj.transpose(-4, -3).transpose(-2, -1))
    H_pp = H_pp.transpose(-3, -2).reshape(batch + (6 * NF, 6 * NF))
    # pose-ext / pose-td columns
    H_pe = (es("...nfjra,...fjrb->...nab", AJ_a, J_e)
            + es("...fjra,...fjrb->...jab", J_j, J_e))\
        .reshape(batch + (6 * NF, 6))
    H_pt = (es("...nfjra,...fjr->...na", AJ_a, J_td)
            + es("...fjra,...fjr->...ja", J_j, J_td)).reshape(batch + (6 * NF,))
    H_ee = es("...fjra,...fjrb->...ab", J_e, J_e)
    H_et = es("...fjra,...fjr->...a", J_e, J_td)
    H_tt = es("...fjr,...fjr->...", J_td, J_td)
    g_p = (es("...nfjra,...fjr->...na", AJ_a, p_res)
           + es("...fjra,...fjr->...ja", J_j, p_res)).reshape(batch + (6 * NF,))
    g_e = es("...fjra,...fjr->...a", J_e, p_res)
    g_t = es("...fjr,...fjr->...", J_td, p_res)

    P, E, T = 6 * NF, 15 * NF, 15 * NF + 6
    H = torch.zeros(batch + (D, D), dtype=dtype, device=dev)
    H[..., :P, :P] = H_pp
    H[..., :P, E:E + 6] = H_pe
    H[..., E:E + 6, :P] = H_pe.mT
    H[..., :P, T] = H_pt
    H[..., T, :P] = H_pt
    H[..., E:E + 6, E:E + 6] = H_ee
    H[..., E:E + 6, T] = H_et
    H[..., T, E:E + 6] = H_et
    H[..., T, T] = H_tt
    g = torch.zeros(batch + (D,), dtype=dtype, device=dev)
    g[..., :P] = g_p
    g[..., E:E + 6] = g_e
    g[..., T] = g_t

    # small dense row groups: IMU + prior + anchor + ZUPT
    r_s, J_s = _small_dense_rows(state, meas, cfg, anchor_ref)
    H = H + J_s.mT @ J_s
    g = g + (J_s.mT @ r_s[..., None])[..., 0]

    # landmark blocks
    lp_a = es("...fn,...fa->...fna", A, es("...fjr,...fjra->...fa", p_rho, J_a))
    lp_j = es("...fjr,...fjra->...fja", p_rho, J_j)
    H_lp = torch.cat(
        [(lp_a + lp_j).reshape(batch + (F, 6 * NF)),
         torch.zeros(batch + (F, 9 * NF), dtype=dtype, device=dev),
         es("...fjr,...fjra->...fa", p_rho, J_e),
         es("...fjr,...fjr->...f", p_rho, J_td)[..., None],
         torch.zeros(batch + (F, 6), dtype=dtype, device=dev)], dim=-1)
    h_ll = es("...fjr,...fjr->...f", p_rho, p_rho)
    g_l = es("...fjr,...fjr->...f", p_rho, p_res)
    return H, g, H_lp, h_ll, g_l


def schur_solve(H, g, H_lp, h_ll, g_l, lam, cfg: WindowConfig):
    """Damped Schur-reduced solve, per scenario over leading batch dims.

    H_red = H − H_plᵀ diag(1/h_ll) H_pl (the landmark elimination), then the
    damped reduced system, then landmark back-substitution. LM damping is
    multiplicative on the diagonal (Marquardt scaling). The reduction and
    the factorization run in float64: the subtraction cancels
    catastrophically in f32 when landmark information dominates.
    Returns (dx [...,D], d_rho [...,F]) in the input dtype and pred in f64.
    """
    dtype = H.dtype
    f64 = torch.float64
    H, g, H_lp = H.to(f64), g.to(f64), H_lp.to(f64)
    h_ll, g_l = h_ll.to(f64), g_l.to(f64)
    lam = lam.to(f64)[..., None]
    h_ll_d = h_ll * (1.0 + lam) + 1e-12           # damp landmarks too
    inv_h = torch.where(h_ll > 1e-10, 1.0 / h_ll_d, torch.zeros_like(h_ll))
    H_red = H - torch.einsum("...fd,...f,...fe->...de", H_lp, inv_h, H_lp)
    g_red = g - (H_lp.mT @ (inv_h * g_l)[..., None])[..., 0]

    diag = torch.diagonal(H_red, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag, min=1e-8) + 1e-10
    A = H_red + torch.diag_embed(damp)
    # Jacobi preconditioning: the IMU whitening spreads H's diagonal over
    # ~10 decades; normalizing to a unit diagonal keeps the factorization
    # well-scaled
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                                     min=1e-20))
    An = A * dscale[..., :, None] * dscale[..., None, :]
    # a failed factorization gives NaN (not an exception): lm_solve treats
    # the iteration as rejected
    L, info = torch.linalg.cholesky_ex(An)
    y = -torch.cholesky_solve((g_red * dscale)[..., None], L)[..., 0]
    y = torch.where((info > 0)[..., None], torch.full_like(y, float("nan")), y)
    dx = y * dscale
    d_rho = -inv_h * (g_l + (H_lp @ dx[..., None])[..., 0])
    # predicted cost reduction of the damped quadratic model (for the LM
    # gain ratio); the landmark part uses its own damping term
    pred = 0.5 * torch.sum(dx * (damp * dx - g_red), dim=-1) + \
        0.5 * torch.sum(d_rho * (lam * h_ll * d_rho - g_l), dim=-1)
    return dx.to(dtype), d_rho.to(dtype), pred


def _expand_like(flag: Tensor, leaf: Tensor) -> Tensor:
    """A per-scenario [...] value shaped to broadcast against `leaf`."""
    return flag.reshape(flag.shape + (1,) * (leaf.dim() - flag.dim()))


def lm_solve(state: WindowState, meas: WindowMeasurements, cfg: WindowConfig,
             device="cuda"):
    """Fixed-iteration branchless Levenberg-Marquardt over a scenario batch.

    Every leaf of `state` and `meas` carries the same leading batch
    dimensions (`[B, ...]`, B = 1 allowed; none at all is one scenario).
    λ, cost and the accept/reject decision are per scenario; nothing inside
    the loop synchronises with the host. With `cfg.fused_schur` the linear
    solve of every iteration is ONE launch of the fused Schur kernel over the
    whole batch (float32 only). `device` is where the solve runs: the inputs
    are moved there, and a CUDA device that is not present raises.
    Returns (state, diagnostics dict of per-scenario tensors).
    """
    device = torch.device(device)
    state, meas = tree_to(state, device), tree_to(meas, device)
    with torch.no_grad():
        return _lm_solve(state, meas, cfg)


@spanned("lm.solve")
def _lm_solve(state, meas, cfg):
    anchor_ref = (state.p[..., 0, :], state.q[..., 0, :])
    batch = state.p.shape[:-2]
    dtype, dev = state.p.dtype, state.p.device
    D, F = cfg.dim, cfg.max_feats

    def body(st, lam, cost):
        with span("lm.normal_equations"):
            if meas.relo_pts is None:
                H, g, H_lp, h_ll, g_l = normal_equations_fast(
                    st, meas, cfg, anchor_ref)
            else:
                r_all, J_all, p_res, p_rows, p_rho, _ = linearize(
                    st, meas, cfg, anchor_ref)
                H, g, H_lp, h_ll, g_l = build_normal_equations(
                    r_all, J_all, p_res, p_rows, p_rho, cfg)
        with span("lm.schur"):
            if cfg.fused_schur:
                from anticipated_vins_mono_torch.ops.hopper_kernels import \
                    schur_solve_fused
                dx, d_rho, pred = schur_solve_fused(
                    H.reshape(-1, D, D), g.reshape(-1, D),
                    H_lp.reshape(-1, F, D), h_ll.reshape(-1, F),
                    g_l.reshape(-1, F), lam.reshape(-1))
                dx = dx.reshape(batch + (D,)).to(dtype)
                d_rho = d_rho.reshape(batch + (F,)).to(dtype)
                pred = pred.reshape(batch)
            else:
                dx, d_rho, pred = schur_solve(H, g, H_lp, h_ll, g_l, lam, cfg)
        with span("lm.cost"):
            # a failed factorization (possible in f32 when λ underflows the
            # representable curvature) yields NaN; 0·NaN = NaN would pass the
            # branchless blend below, so sanitize the step and reject it
            finite = (torch.isfinite(dx).all(dim=-1)
                      & torch.isfinite(d_rho).all(dim=-1)
                      & torch.isfinite(pred))
            dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
            d_rho = torch.where(torch.isfinite(d_rho), d_rho,
                                torch.zeros_like(d_rho))
            cand = retract(st, dx, d_rho, cfg)
            new_cost = robust_cost(cand, meas, cfg, anchor_ref)
            drop = cost - new_cost
            ok = (new_cost < cost) & (pred > 0) & finite
            rho = (drop / torch.clamp(pred, min=1e-30)).to(lam.dtype)
            okf = ok.to(dtype)
            st_next = tree_map(
                lambda a, b: _expand_like(okf, a) * b
                + (1.0 - _expand_like(okf, a)) * a, st, cand)
            st_next = st_next._replace(q=lie.quat_normalize(st_next.q),
                                       qic=lie.quat_normalize(st_next.qic))
            if cfg.lm_strategy == "nielsen":
                shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                     min=1.0 / 3.0)
                lam_next = torch.where(ok, lam * shrink, lam * 2.0)
            else:
                lam_next = torch.where(ok, lam * cfg.lm_lambda_down,
                                       lam * cfg.lm_lambda_up)
            lam_next = torch.clamp(lam_next, 1e-12, 1e8)
            cost_next = torch.where(ok, new_cost, cost)
        return st_next, lam_next, cost_next

    lam = torch.full(batch, cfg.lm_lambda_init, dtype=dtype, device=dev)
    cost0 = robust_cost(state, meas, cfg, anchor_ref)
    st, cost = state, cost0
    for _ in range(cfg.iters):
        st, lam, cost = body(st, lam, cost)
    return st, {"cost0": cost0, "cost": cost, "lambda": lam,
                "imu_chi2": imu_chi2_mean(st, meas, cfg),
                "prior_chi2": prior_chi2(st, meas, cfg)}
