"""Anticipation + attention: expected-information feature selection on torch.

Counterpart of `anticipated_vins_mono_tpu/models/anticipation.py`
(Carlone & Karaman, ICRA'17, as in the reference's FeatureSelector and
HorizonGenerator):

- future-horizon propagation (`imu` constant-rate mode and `gt` mode);
- Ω_{k:k+H} from the linear-IMU-factor model (slerped rotation sums N/M,
  covImu, Ablk, 4-block accumulation) plus the identity prior placeholder;
- per-candidate expected information Δ_ℓ: forward-projected bearings with a
  FOV check, Bh = [û]×·R, Ch = BhᵀBh, landmark Schur W = (ΣCh)⁻¹, Δ blocks
  C_i·δij − C_i W C_jᵀ on the position sub-blocks;
- nearest-neighbour depth guess by brute-force masked argmin;
- greedy submodular logdet maximisation: every round scores ALL candidates
  at once by a batched Cholesky log-determinant ("chol"; the port's
  log-det kernel and its "lowrank" scoring are not in this copy).

Where the JAX version maps a one-candidate function over the candidates
with `vmap`, the functions here take the candidates as a leading dimension.
As in the JAX package (a documented deviation from the reference), the
camera-IMU extrinsic enters Bh once.

Dimensions: HORIZON=13, STATE_SIZE=9 (t,v,ba), Ω ∈ R^{126×126}.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import lie

Tensor = torch.Tensor

HORIZON = 13
STATE_SIZE = 9


class SelectorConfig(NamedTuple):
    horizon: int = HORIZON
    max_features: int = 30        # κ̄
    init_threshold: int = 0       # pass-through below this count
    acc_var: float = 0.0064       # discrete accel variance
    acc_bias_var: float = 1.6e-9
    fov_margin: float = 1.0       # multiplier on the FOV half-tangents
    fov_x: float = 0.58           # ≈ EuRoC pinhole half-tangent
    fov_y: float = 0.44
    # treat the prob channel as a PER-FRAME track-survival probability:
    # block C_h is weighted p^h instead of every block getting the same p
    survival_weighting: bool = False

    @property
    def dim(self) -> int:
        return STATE_SIZE * (self.horizon + 1)


# ----------------------------------------------------------------------------
# Horizon generation
# ----------------------------------------------------------------------------


def imu_horizon(p_k1, q_k1, v_k1, acc_body, gyr_body, ba, bg,
                horizon: int, n_imu: int, dt_imu: float):
    """Constant-ω / constant-a propagation at IMU rate over the horizon: from
    the (k+1) state, the latest bias-corrected IMU sample is applied as if
    constant. Returns (p [H+1,3], q [H+1,4], v [H+1,3]) with index 0 the
    (k+1) state itself.

    The JAX package scans horizon·n_imu Euler steps
        a_k = R(q_k)(acc − ba) + g,  p += v·dt + ½a_k·dt²,  v += a_k·dt,
        q_{k+1} = q_k ⊗ exp(ω·dt).
    With ω constant, q_k = q_0 ⊗ exp(k·ω·dt) in closed form, so all a_k are
    known at once and p, v are prefix sums of them: the same recurrence,
    evaluated with two `cumsum`s instead of a loop of hundreds of tiny
    launches.
    """
    dt_ = p_k1.dtype
    dev = p_k1.device
    q0, v0 = q_k1.to(dt_), v_k1.to(dt_)
    acc_body, gyr_body = acc_body.to(dt_), gyr_body.to(dt_)
    ba, bg = ba.to(dt_), bg.to(dt_)
    g = torch.tensor([0.0, 0.0, -9.81007], dtype=dt_, device=dev)
    w = gyr_body - bg
    n = horizon * n_imu
    steps = torch.arange(n + 1, dtype=dt_, device=dev)[:, None]   # k = 0..n
    q_all = lie.quat_normalize(lie.quat_mul(
        q0[..., None, :], lie.exp_so3_quat(steps * (w * dt_imu)[..., None, :])))
    a_w = lie.quat_rotate(q_all[..., :n, :],
                          (acc_body - ba)[..., None, :]) + g      # a_0..a_{n-1}
    zero = torch.zeros_like(a_w[..., :1, :])
    cum_a = torch.cat([zero, torch.cumsum(a_w, dim=-2)], dim=-2)  # Σ_{i<k} a_i
    v_all = v0[..., None, :] + dt_imu * cum_a                     # v_0..v_n
    cum_v = torch.cat([zero, torch.cumsum(v_all[..., :n, :], dim=-2)], dim=-2)
    p_all = p_k1[..., None, :] + dt_imu * cum_v \
        + (0.5 * dt_imu * dt_imu) * cum_a
    frames = slice(0, n + 1, n_imu)
    return p_all[..., frames, :], q_all[..., frames, :], v_all[..., frames, :]


def gt_horizon(p_k1, q_k1, gt_p: Tensor, gt_q: Tensor):
    """Ground-truth mode: compose *relative* GT transforms onto the current
    estimate. gt_p/gt_q: [H+1] GT poses at the horizon frame times
    (gt[0] ↔ now)."""
    q0_inv = lie.quat_conj(gt_q[0])
    rel_q = lie.quat_mul(q0_inv[None], gt_q)
    rel_p = lie.quat_rotate(q0_inv[None], gt_p - gt_p[0])
    q_est = lie.quat_mul(q_k1[None], rel_q)
    p_est = p_k1[None] + lie.quat_rotate(q_k1[None], rel_p)
    return p_est, q_est


# ----------------------------------------------------------------------------
# Ω from robot motion
# ----------------------------------------------------------------------------


def _slerp(q0, q1, t):
    rel = lie.quat_mul(lie.quat_conj(q0), q1)
    return lie.quat_mul(q0, lie.exp_so3_quat(t[..., None] * lie.log_so3(rel)))


def _block3(rows) -> Tensor:
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def linear_imu_matrices(q_i, q_j, n_imu: int, dt_imu: float,
                        acc_var: float, acc_bias_var: float):
    """(Ω=covImu⁻¹ [...,9,9], Ablk [...,9,9]) for horizon pairs q_i, q_j
    [...,4]: N/M sums of slerp-interpolated rotations, covImu per eq (52),
    Ablk per eq (50) of the paper."""
    dtype, dev = q_i.dtype, q_i.device
    batch = q_i.shape[:-1]
    idx = torch.arange(n_imu, dtype=dtype, device=dev)
    ts = idx / n_imu
    qs = _slerp(q_i[..., None, :], q_j[..., None, :], ts)   # [...,n,4]
    Rs = lie.quat_to_rot(qs)                                # [...,n,3,3]
    jkh = n_imu - idx - 0.5
    Nij = torch.einsum("n,...nij->...ij", jkh, Rs)
    Mij = torch.sum(Rs, dim=-3)
    cct_11 = torch.sum(jkh * jkh)
    cct_12 = torch.sum(jkh)

    dt2 = dt_imu * dt_imu
    dt3 = dt2 * dt_imu
    dt4 = dt3 * dt_imu
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    cov = _block3([
        [I3 * (n_imu * cct_11 * dt4 * acc_var), I3 * (cct_12 * dt3 * acc_var), Z3],
        [I3 * (cct_12 * dt3 * acc_var), I3 * (n_imu * dt2 * acc_var), Z3],
        [Z3, Z3, I3 * (n_imu * acc_bias_var)],
    ])
    omega = torch.linalg.inv(cov).expand(batch + (9, 9))

    I3b, Z3b = I3.expand(batch + (3, 3)), Z3.expand(batch + (3, 3))
    Ablk = _block3([
        [-I3b, -I3b * (n_imu * dt_imu), Nij * dt2],
        [Z3b, -I3b, Mij * dt_imu],
        [Z3b, Z3b, -I3b],
    ])
    return omega, Ablk


def omega_from_motion(q_horizon: Tensor, n_imu: int, dt_imu: float,
                      cfg: SelectorConfig) -> Tensor:
    """Ω_{k:k+H} [D,D] from the horizon orientations [H+1,4]: each
    consecutive pair contributes the four 9×9 blocks [AᵀΩA, AᵀΩ; ΩA, Ω]
    shifting along the diagonal."""
    H, S, D = cfg.horizon, STATE_SIZE, cfg.dim
    om, Ab = linear_imu_matrices(q_horizon[:-1], q_horizon[1:], n_imu, dt_imu,
                                 cfg.acc_var, cfg.acc_bias_var)
    AtO = torch.einsum("hji,hjk->hik", Ab, om)          # AᵀΩ
    AtOA = torch.einsum("hij,hjk->hik", AtO, Ab)        # AᵀΩA

    Omega = torch.zeros((D, D), dtype=q_horizon.dtype, device=q_horizon.device)
    for h in range(H):
        i, j = S * h, S * (h + 1)
        Omega[i:i + S, i:i + S] += AtOA[h]
        Omega[i:i + S, j:j + S] += AtO[h]
        Omega[j:j + S, i:i + S] += AtO[h].T
        Omega[j:j + S, j:j + S] += om[h]
    return Omega


def add_omega_prior(Omega: Tensor) -> Tensor:
    """Identity prior on the first state block — the reference's placeholder
    (the real state prior was never wired there)."""
    S = STATE_SIZE
    out = Omega.clone()
    out[:S, :S] += torch.eye(S, dtype=Omega.dtype, device=Omega.device)
    return out


# ----------------------------------------------------------------------------
# Per-feature expected information Δ_ℓ
# ----------------------------------------------------------------------------


def nn_depths(cand_uv: Tensor, lm_uv: Tensor, lm_depth: Tensor,
              lm_mask: Tensor, default: float = 5.0) -> Tensor:
    """Depth guess per candidate: depth of the nearest current landmark on
    the normalized image plane (brute-force masked argmin)."""
    d2 = torch.sum((cand_uv[:, None, :] - lm_uv[None, :, :]) ** 2, -1)
    d2 = torch.where(lm_mask[None, :] > 0, d2,
                     torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=1)
    best = lm_depth.index_select(0, idx)
    any_lm = torch.any(lm_mask > 0)
    return torch.where(any_lm, best, torch.full_like(best, default))


def delta_ell(bearing_c: Tensor, depth: Tensor,
              p_wc: Tensor, q_wc: Tensor,
              cfg: SelectorConfig, prob=None):
    """Δ_ℓ [...,D,D] + visibility count [...] for candidate features.

    bearing_c: [...,3] calibrated [u,v,1] in the (k+1) camera, depth [...];
    p_wc/q_wc: camera poses over the horizon [H+1] (index 1 = frame k+1).
    The leading dimensions are the candidates.

    With cfg.survival_weighting and a `prob` [...], block C_h is scaled p^h
    — the expected information at horizon frame h given per-frame track
    survival p. The caller must then NOT multiply Δ by p again.
    """
    H, S, D = cfg.horizon, STATE_SIZE, cfg.dim
    dtype, dev = bearing_c.dtype, bearing_c.device
    batch = bearing_c.shape[:-1]

    u1 = bearing_c / torch.clamp(
        torch.linalg.norm(bearing_c, dim=-1, keepdim=True), min=1e-9)
    pell = p_wc[1] + lie.quat_rotate(q_wc[1], u1 * depth[..., None])

    # C_h = BᵀB at horizon frames h = 2..H, with FOV gating
    q_cw = lie.quat_conj(q_wc[2:])                              # [H-1,4]
    rel = lie.quat_rotate(q_cw, pell[..., None, :] - p_wc[2:])  # [...,H-1,3]
    norm = torch.linalg.norm(rel, dim=-1, keepdim=True)
    uell = rel / torch.clamp(norm, min=1e-9)
    z = torch.clamp(rel[..., 2], min=1e-9)
    in_fov = (rel[..., 2] > 0.0) & \
        (torch.abs(rel[..., 0] / z) < cfg.fov_x * cfg.fov_margin) & \
        (torch.abs(rel[..., 1] / z) < cfg.fov_y * cfg.fov_margin)
    Bh = lie.skew(uell) @ lie.quat_to_rot(q_cw)
    Ch_tail = (Bh.mT @ Bh) * in_fov.to(dtype)[..., None, None]
    n_visible = 1 + torch.sum(in_fov, dim=-1)

    # frame k+1 block (always visible there — it was just detected)
    R_cw1 = lie.quat_to_rot(lie.quat_conj(q_wc[1]))
    B1 = lie.skew(u1) @ R_cw1
    C1 = B1.mT @ B1
    Ch = torch.cat([C1[..., None, :, :], Ch_tail], dim=-3)     # [...,H,3,3]
    if cfg.survival_weighting and prob is not None:
        w = prob[..., None] ** torch.arange(1, H + 1, dtype=dtype, device=dev)
        Ch = Ch * w[..., None, None]

    EtE = torch.sum(Ch, dim=-3)
    # `inv_ex`: a candidate seen only in frame k+1 has a rank-2 EtE, and in
    # float32 the 1e-12 ridge vanishes in its O(1) entries; `jnp.linalg.inv`
    # then returns inf/NaN for that candidate without a word, where
    # `torch.linalg.inv` would raise and stop the frame
    W = torch.linalg.inv_ex(
        EtE + 1e-12 * torch.eye(3, dtype=dtype, device=dev)).inverse

    # Big = blkdiag(C) − C W Cᵀ over the 3H-dim stacked position space,
    # embedded into the D-dim horizon state by the constant selector E
    D_off = torch.einsum("...iab,...bc,...jdc->...iajd", Ch, W, Ch)
    eyeH = torch.eye(H, dtype=dtype, device=dev)
    blkdiag = Ch[..., :, :, None, :] * eyeH[:, None, :, None]  # [...,H,3,H,3]
    Big = (blkdiag - D_off).reshape(batch + (3 * H, 3 * H))
    E = _pos_embedding(H, S, D, dtype, dev)                    # [3H, D]
    Delta = E.T @ Big @ E
    usable = n_visible >= 2   # must be triangulable over the horizon
    return Delta * usable.to(dtype)[..., None, None], n_visible


@functools.lru_cache(maxsize=8)
def _pos_embedding_np(H: int, S: int, D: int):
    E = np.zeros((3 * H, D))
    for i in range(H):
        for a in range(3):
            E[3 * i + a, S * (i + 1) + a] = 1.0
    return E


def _pos_embedding(H: int, S: int, D: int, dtype, device) -> Tensor:
    return torch.tensor(_pos_embedding_np(H, S, D), dtype=dtype, device=device)


# ----------------------------------------------------------------------------
# Greedy submodular logdet selection
# ----------------------------------------------------------------------------


def _take_cands(x: Tensor, idx: Tensor) -> Tensor:
    """x [...,F,*t], idx [...,G] → x[..., idx, *t] as [...,G,*t]."""
    t = x.shape[idx.dim():]
    g = idx.reshape(idx.shape + (1,) * len(t)).expand(idx.shape + t)
    return torch.gather(x, idx.dim() - 1, g)


def _mask_gain(gain, valid, sel):
    ninf = torch.full_like(gain, float("-inf"))
    gain = torch.where((valid > 0) & (sel < 0.5), gain, ninf)
    return torch.where(torch.isnan(gain), ninf, gain)


def select_informative(Omega: Tensor, Deltas: Tensor, probs: Tensor,
                       valid: Tensor, kappa: int, impl: str = None,
                       budget=None, group: int = None, device="cuda"):
    """Exact greedy logdet maximization, all candidates scored per round.

    Omega [...,D,D], Deltas [...,F,D,D], probs/valid [...,F]; leading
    dimensions are independent selection problems.

    Scoring ("chol", the only one in this copy; `impl` None or "chol"):
    logdet(Ω_acc + p_ℓ Δ_ℓ) for every candidate by a batched Cholesky of
    the materialised sums (`lie.logdet_psd`; NaN where one fails).

    `budget` (optional scalar or tensor ≤ kappa) caps how many of the
    `kappa` rounds actually select. `group` (default 1): blocked greedy —
    each round admits the top-`group` candidates and applies their Ω updates
    together, in ⌈κ/group⌉ rounds; group=1 is the exact greedy.

    The loop never synchronises with the host: the argmax index stays on
    the device and Δ_best is gathered there.
    Returns (selected mask [...,F], Ω after the selected updates).
    """
    device = torch.device(device)
    Omega, Deltas = Omega.to(device), Deltas.to(device)
    probs, valid = probs.to(device), valid.to(device)
    if impl not in (None, "chol"):
        raise ValueError(f"the reference scores by 'chol' only, got {impl!r}")
    if group is None:
        group = 1
    group = max(1, min(group, kappa)) if kappa else 1
    if budget is None:
        budget = kappa
    F = Deltas.shape[-3]
    D = Omega.shape[-1]
    dtype = Omega.dtype
    batch = Omega.shape[:-2]

    with torch.no_grad():
        def score(Om):
            cand = Om[..., None, :, :] + probs[..., None, None] * Deltas
            return lie.logdet_psd(cand)

        Om = Omega
        sel = torch.zeros(batch + (F,), dtype=dtype, device=device)
        for _ in range(-(-kappa // group)):
            gain = _mask_gain(score(Om), valid, sel)
            Om, sel = _apply_topg(Om, sel, gain, probs, Deltas, budget,
                                  group, dtype)
    return sel, Om


def _apply_topg(Om, sel, gain, probs, Deltas, budget, group: int, dtype):
    """One blocked-greedy round: admit the top-`group` candidates by gain
    (subject to the remaining budget), apply their Ω updates together.
    group=1 reduces to the exact-greedy argmax round."""
    n_already = torch.sum(sel, dim=-1, keepdim=True)
    if group == 1:
        vals, idx = torch.max(gain, dim=-1, keepdim=True)
        ranks = 0
    else:
        vals, idx = torch.topk(gain, group, dim=-1)
        ranks = torch.arange(group, dtype=n_already.dtype,
                             device=n_already.device)
    if torch.is_tensor(budget):
        budget = budget[..., None]
    ok = (torch.isfinite(vals) & (n_already + ranks < budget)).to(dtype)
    sel = sel.scatter_add(-1, idx, ok)
    Om = Om + torch.einsum("...g,...gde->...de",
                           ok * _take_cands(probs, idx),
                           _take_cands(Deltas, idx))
    return Om, torch.clamp(sel, max=1.0)
