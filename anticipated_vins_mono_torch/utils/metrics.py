"""Trajectory evaluation: ATE / RTE in the style of `evo`.

The port's own copy of `anticipated_vins_mono_tpu/utils/metrics.py` (numpy
only): SE(3) (or similarity) Umeyama alignment followed by RMSE of
translation (ATE) and relative-pose deltas over a time horizon (RTE)."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/SE(3) alignment est → gt. Returns (s, R, t)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / len(est)
    U, S, Vt = np.linalg.svd(C)
    sgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        sgn[2, 2] = -1
    R = U @ sgn @ Vt
    s = float(np.trace(np.diag(S) @ sgn) / (E ** 2).sum() * len(est)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_t: np.ndarray, est_p: np.ndarray,
             gt_t: np.ndarray, gt_p: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after time association + alignment."""
    idx = np.searchsorted(gt_t, est_t)
    idx = np.clip(idx, 0, len(gt_t) - 1)
    gt_assoc = gt_p[idx]
    if align:
        s, R, t = align_umeyama(est_p, gt_assoc, with_scale)
        est_p = (s * (R @ est_p.T)).T + t
    err = np.linalg.norm(est_p - gt_assoc, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rte(est_t: np.ndarray, est_p: np.ndarray,
        gt_t: np.ndarray, gt_p: np.ndarray,
        delta_s: float = 10.0) -> dict:
    """Relative translation error over `delta_s`-second sub-trajectories.

    The estimate is SE(3)-aligned to GT first (displacement vectors live in
    a global frame; comparing them unaligned measures the gauge, not drift).
    """
    idx = np.clip(np.searchsorted(gt_t, est_t), 0, len(gt_t) - 1)
    gt_assoc = gt_p[idx]
    s, R, t = align_umeyama(est_p, gt_assoc)
    est_p = (R @ est_p.T).T + t
    errs = []
    j0 = 0
    for i in range(len(est_t)):
        while est_t[i] - est_t[j0] > delta_s:
            j0 += 1
        if j0 == i:
            continue
        d_est = est_p[i] - est_p[j0]
        d_gt = gt_assoc[i] - gt_assoc[j0]
        errs.append(np.linalg.norm(d_est - d_gt))
    errs = np.asarray(errs) if errs else np.zeros(1)
    return {"rmse": float(np.sqrt(np.mean(errs ** 2))),
            "median": float(np.median(errs)),
            "mean": float(np.mean(errs))}


def write_tum(path: str, ts, ps, qs):
    """Write trajectory in TUM format (t x y z qx qy qz qw) so external
    `evo` tooling still works."""
    with open(path, "w") as f:
        for t, p, q in zip(ts, ps, qs):
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
