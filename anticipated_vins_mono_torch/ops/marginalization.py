"""Marginalization: fold sliding-out states into a Gaussian prior.

Counterpart of `anticipated_vins_mono_tpu/ops/marginalization.py`:

- re-linearize every factor touching the drop set (prior, IMU 0→1, all
  projection factors anchored at the oldest frame);
- assemble H = JᵀJ, b = Jᵀr over (window tangent ⊕ dropped landmarks) by
  the solver's own route: on CUDA tensors from one launch of the normal
  equations' kernel (`window.normal_equations_fast`), whose H, g, H_lp,
  h_ll, g_l are the system's blocks; on CPU tensors, and with a
  relocalization frame (the kernel has no rows for it), from the dense
  rows of `linearize`;
- Schur-eliminate the drop set, expressed as a mask over the fixed [D+F]
  tangent, via an eigendecomposition pseudo-inverse (eps = 1e-8);
- factor the kept information into (J0, r0) via the eigenvalue square root;
- remap kept-variable addresses for the slid window.

Only the float64 path is here. The JAX package's `_schur_drop_df` and
`_sqrt_factor_df` emulate double precision with float32 pairs for a chip
without a usable float64; this card has one, so `accum="df32"` takes the
float64 path, as in `ops/window.py`.

`_sqrt_factor` returns J0 = s·Vᵀ: its rows change sign, and rotate inside
repeated eigenvalues, from one `eigh` implementation to the next. Compare
J0ᵀJ0 and J0ᵀr0 across packages, never J0 or r0 themselves; the solve is
invariant to the difference up to rounding. `torch.linalg.eigh` on a CUDA
tensor synchronises with the host (it checks `info`).

One scenario per call (no batch dimensions).
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.ops.window import (
    PriorFactor, WindowConfig, WindowMeasurements, WindowState, linearize,
    normal_equations_fast, state_boxminus)

Tensor = torch.Tensor

EIG_EPS = 1e-8  # the reference's eps in its pseudo-inverse and square root


def _augmented_system(state: WindowState, meas: WindowMeasurements,
                      cfg: WindowConfig, anchor_ref):
    """H, b over the augmented tangent [D + F] (window ⊕ inverse depths),
    built from the factors in `meas` (caller pre-masks to the drop-touching
    subset): from the normal equations' kernel on CUDA tensors, from
    `linearize`'s dense rows on CPU tensors or with a relocalization
    frame."""
    if state.p.is_cuda and meas.relo_pts is None:
        return _assemble_augmented(
            *normal_equations_fast(state, meas, cfg, anchor_ref))
    return _linearized_augmented_system(state, meas, cfg, anchor_ref)


def _assemble_augmented(H, g, H_lp, h_ll, g_l):
    """The [D + F] system from the normal equations' blocks: each landmark's
    column touches only its own factors, so H_aug = [[H, H_lpᵀ],
    [H_lp, diag(h_ll)]] and b = [g; g_l]."""
    top = torch.cat([H, H_lp.mT], dim=-1)
    bottom = torch.cat([H_lp, torch.diag_embed(h_ll)], dim=-1)
    return torch.cat([top, bottom], dim=-2), torch.cat([g, g_l], dim=-1)


def _linearized_augmented_system(state: WindowState,
                                 meas: WindowMeasurements, cfg: WindowConfig,
                                 anchor_ref):
    """`_augmented_system` as J_augᵀJ_aug, J_augᵀr of the dense rows of the
    solver's batched `linearize`, each projection row augmented with its
    landmark's column."""
    d, f, nf = cfg.dim, cfg.max_feats, cfg.nf
    r_all, J_all, _, p_rows, p_rho, _ = linearize(state, meas, cfg, anchor_ref)
    # augment projection rows with their landmark column (block-diagonal in l)
    eye_f = torch.eye(f, dtype=p_rho.dtype, device=p_rho.device)
    p_aug = p_rho[..., None] * eye_f[:, None, None, :]      # [F,NF,2,F]
    n_proj = f * nf * 2
    J_proj = torch.cat(
        [p_rows.reshape(n_proj, d), p_aug.reshape(n_proj, f)], dim=1)
    J_rest = torch.cat(
        [J_all[n_proj:], J_all.new_zeros((J_all.shape[0] - n_proj, f))], dim=1)
    J_aug = torch.cat([J_proj, J_rest], dim=0)              # [N, D+F]
    return J_aug.T @ J_aug, J_aug.T @ r_all


def _masked_schur(H: Tensor, b: Tensor, drop_mask: Tensor):
    """Schur-eliminate the (dynamically) masked subset, in float64.

    H_dd's pseudo-inverse comes from `eigh` with eps-thresholding, which also
    makes the masked-out zero rows/cols harmless: they give exactly-zero
    eigenvalues that fall under `EIG_EPS`.
    """
    H = H.to(torch.float64)
    b = b.to(torch.float64)
    drop_mask = drop_mask.to(torch.float64)
    keep = 1.0 - drop_mask
    Hdd = H * drop_mask[:, None] * drop_mask[None, :]
    Hkd = H * keep[:, None] * drop_mask[None, :]
    w, V = torch.linalg.eigh(Hdd)
    ok = w > EIG_EPS
    inv_w = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    Hdd_inv = (V * inv_w[None, :]) @ V.T
    H_new = H * keep[:, None] * keep[None, :] - Hkd @ Hdd_inv @ Hkd.T
    b_new = b * keep - Hkd @ (Hdd_inv @ (b * drop_mask))
    return H_new, b_new


def _sqrt_factor(H: Tensor, b: Tensor):
    """(J0, r0) with J0ᵀJ0 = H, J0ᵀr0 = b via eigenvalue sqrt, in float64."""
    w, V = torch.linalg.eigh(H.to(torch.float64))
    b = b.to(torch.float64)
    ok = w > EIG_EPS
    root = torch.sqrt(torch.where(ok, w, torch.ones_like(w)))
    s = root * ok
    s_inv = torch.where(ok, 1.0 / root, torch.zeros_like(w))
    J0 = s[:, None] * V.T
    r0 = (s_inv[:, None] * V.T) @ b
    return J0, r0


def _shift_matrix(cfg: WindowConfig, drop_frame: int) -> np.ndarray:
    """S [D,D]: dx_old = S @ dx_new after deleting `drop_frame` and appending
    a fresh newest frame — the address-shift bookkeeping as a pure index
    remapping."""
    d, nf = cfg.dim, cfg.nf
    S = np.zeros((d, d))
    off = 6 * nf
    for i in range(nf):
        if i == drop_frame:
            continue
        new_i = i if i < drop_frame else i - 1
        S[6 * i: 6 * i + 6, 6 * new_i: 6 * new_i + 6] = np.eye(6)
        S[off + 9 * i: off + 9 * i + 9,
          off + 9 * new_i: off + 9 * new_i + 9] = np.eye(9)
    # extrinsic + td (+ relo block) unchanged
    S[15 * nf:, 15 * nf:] = np.eye(d - 15 * nf)
    return S


def _slide_lin_state(state: WindowState, drop_frame: int,
                     cfg: WindowConfig) -> WindowState:
    """Linearization point for the new prior: frames after `drop_frame`
    shifted down; the (duplicated) newest slot is never referenced because
    the shifted prior has zero columns there."""
    nf = cfg.nf
    idx = torch.tensor([i for i in range(nf) if i != drop_frame] + [nf - 1],
                       device=state.p.device)
    return state._replace(
        p=state.p[idx], q=state.q[idx], v=state.v[idx],
        ba=state.ba[idx], bg=state.bg[idx])


def _shifted_prior(J0: Tensor, r0: Tensor, state: WindowState,
                   drop_frame: int, weight: Tensor,
                   cfg: WindowConfig, dtype) -> PriorFactor:
    S = torch.from_numpy(_shift_matrix(cfg, drop_frame)).to(J0)
    return PriorFactor(J0=(J0 @ S).to(dtype), r0=r0.to(dtype),
                       lin=_slide_lin_state(state, drop_frame, cfg),
                       weight=weight)


def _drop_touching(meas: WindowMeasurements, cfg: WindowConfig,
                   dtype) -> WindowMeasurements:
    """`meas` restricted to the factors that touch MARGIN_OLD's drop set:
    the landmarks anchored at frame 0 and the IMU pair 0→1 (the prior
    stays whole); the masks' products in `dtype`, the state's."""
    anchored0 = (meas.anchor == 0).to(dtype) * meas.feat_valid
    first_pair = (torch.arange(cfg.window, device=meas.feat_valid.device)
                  == 0).to(dtype)
    return meas._replace(feat_valid=anchored0,
                         pre_valid=meas.pre_valid * first_pair)


def marginalize_oldest(state: WindowState, meas: WindowMeasurements,
                       cfg: WindowConfig) -> PriorFactor:
    """MARGIN_OLD: absorb frame 0 (pose+speedbias), its IMU factor, all
    projection factors anchored at it (and those landmarks), and the previous
    prior, into a new prior over the slid window."""
    d, f, nf = cfg.dim, cfg.max_feats, cfg.nf
    dtype, dev = state.p.dtype, state.p.device
    with torch.no_grad():
        meas_m = _drop_touching(meas, cfg, dtype)
        anchored0 = meas_m.feat_valid
        # gauge anchor rows participate in the system (they touch pose 0
        # only when no prior exists — exactly when their info must seed the
        # prior)
        anchor_ref = (state.p[0], state.q[0])
        H, b = _augmented_system(state, meas_m, cfg, anchor_ref)

        drop = torch.zeros(d + f, dtype=dtype, device=dev)
        drop[0:6] = 1.0                        # pose 0
        drop[6 * nf: 6 * nf + 9] = 1.0         # speed/bias 0
        drop[d:] = anchored0                   # dropped landmarks
        H2, b2 = _masked_schur(H, b, drop)
        # kept landmarks never appear in the marginalized factors → their
        # rows are zero; restrict to the window tangent
        J0, r0 = _sqrt_factor(H2[:d, :d], b2[:d])
        return _shifted_prior(J0, r0, state, 0,
                              torch.ones((), dtype=dtype, device=dev),
                              cfg, dtype)


def marginalize_second_newest(state: WindowState, prior: PriorFactor,
                              cfg: WindowConfig) -> PriorFactor:
    """MARGIN_SECOND_NEW: drop frame NF-2 from the *prior only* — its visual
    factors are simply discarded (non-keyframe) and its IMU measurements are
    merged by the estimator.

    The prior is re-linearized at the CURRENT state before the Schur drop:
    b must be the gradient at the new linearization point (r0 + J0·dx), not
    the stale r0 — otherwise long runs of non-keyframe slides (hover phases)
    accumulate the mismatch and corrupt the prior.
    """
    d, nf = cfg.dim, cfg.nf
    dtype, dev = prior.J0.dtype, prior.J0.device
    fidx = nf - 2
    with torch.no_grad():
        dx = state_boxminus(state, prior.lin, cfg)
        r_now = prior.r0 + prior.J0 @ dx
        H = prior.J0.T @ prior.J0
        b = prior.J0.T @ r_now
        drop = torch.zeros(d, dtype=dtype, device=dev)
        drop[6 * fidx: 6 * fidx + 6] = 1.0
        drop[6 * nf + 9 * fidx: 6 * nf + 9 * fidx + 9] = 1.0
        H2, b2 = _masked_schur(H, b, drop)
        J0, r0 = _sqrt_factor(H2, b2)
        return _shifted_prior(J0, r0, state, fidx, prior.weight, cfg, dtype)
