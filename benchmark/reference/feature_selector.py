"""Frozen copy of the port's `models/feature_selector._device_select`: the
anticipation pipeline of one frame (horizon → Ω → batched Δ_ℓ → κ-round
greedy → backfill to κ̄ by tracking probability). Part of the benchmark's
plain reference; imports nothing of the port.
"""

from __future__ import annotations

import torch

from benchmark.reference import anticipation as ant
from benchmark.reference import lie


def selection_problem(cfg: ant.SelectorConfig, n_imu: int, dt_imu: float,
                      p_k1, q_k1, v_k1, acc, gyr, ba, bg,
                      tic, qic,
                      cand_pts, cand_probs, cand_valid,
                      used_pts, used_depths, used_valid,
                      lm_uv, lm_depth, lm_mask,
                      gt_p=None, gt_q=None):
    """The greedy's problem in one frame, its arguments on one device:
    (Ω with the motion's and the tracked features' information, Δ_ℓ [F,D,D]
    of the candidates, the weights p_ℓ the greedy applies, the candidates it
    may pick [F]). The greedy maximises logdet(Ω + Σ_{ℓ∈S} p_ℓ Δ_ℓ)."""
    with torch.no_grad():
        # 1. horizon: imu mode, or ground-truth relative composition
        if gt_p is not None:
            ps, qs = ant.gt_horizon(p_k1, q_k1, gt_p, gt_q)
        else:
            ps, qs, _ = ant.imu_horizon(p_k1, q_k1, v_k1, acc, gyr, ba, bg,
                                        cfg.horizon, n_imu, dt_imu)
        # camera poses over the horizon
        p_wc = ps + lie.quat_rotate(qs, tic.expand_as(ps))
        q_wc = lie.quat_mul(qs, qic.expand_as(qs))

        # 2. Omega from motion + prior placeholder
        Omega = ant.omega_from_motion(qs, n_imu, dt_imu, cfg)
        Omega = ant.add_omega_prior(Omega)

        # 3. candidate depths by nearest current landmark
        cand_depths = ant.nn_depths(cand_pts[:, :2], lm_uv, lm_depth, lm_mask)

        # 4. Δ_ℓ for candidates and for the tracked subset. Under
        # survival_weighting the per-frame p^h decay is folded into Δ itself
        # and the greedy must NOT multiply by p again.
        if cfg.survival_weighting:
            Deltas, nvis = ant.delta_ell(cand_pts, cand_depths, p_wc, q_wc,
                                         cfg, prob=cand_probs)
            D_used, _ = ant.delta_ell(used_pts, used_depths, p_wc, q_wc, cfg,
                                      prob=torch.ones_like(used_depths))
            greedy_probs = torch.ones_like(cand_probs)
        else:
            Deltas, nvis = ant.delta_ell(cand_pts, cand_depths, p_wc, q_wc, cfg)
            D_used, _ = ant.delta_ell(used_pts, used_depths, p_wc, q_wc, cfg)
            greedy_probs = cand_probs
        Deltas = torch.where((cand_valid > 0)[:, None, None], Deltas,
                             torch.zeros_like(Deltas))
        D_used = torch.where((used_valid > 0)[:, None, None], D_used,
                             torch.zeros_like(D_used))
        # 5. Ω ← Ω + Σ Δ_used
        Omega = Omega + torch.sum(D_used, dim=0)
        valid = cand_valid * (nvis >= 2).to(cand_valid.dtype)
    return Omega, Deltas, greedy_probs, valid


def _device_select(cfg: ant.SelectorConfig, kappa: int, n_imu: int,
                   dt_imu: float,
                   p_k1, q_k1, v_k1, acc, gyr, ba, bg,
                   tic, qic,
                   cand_pts, cand_probs, cand_valid,
                   used_pts, used_depths, used_valid,
                   lm_uv, lm_depth, lm_mask,
                   gt_p=None, gt_q=None, budget=None,
                   impl=None, group=None, device="cuda"):
    """The full anticipation pipeline for one frame.

    kappa is the maximum round count (κ̄); `budget` (scalar or tensor,
    default kappa) is the dynamic κ̄−tracked budget. `impl` and `group` are
    passed to `anticipation.select_informative`. `device` is where the
    pipeline runs: tensor arguments are moved there, and a CUDA device that
    is not present raises. Returns (selected mask [F], final Ω).
    """
    device = torch.device(device)
    args = tuple(x if x is None else x.to(device) for x in (
        p_k1, q_k1, v_k1, acc, gyr, ba, bg, tic, qic, cand_pts,
        cand_probs, cand_valid, used_pts, used_depths, used_valid,
        lm_uv, lm_depth, lm_mask, gt_p, gt_q))
    cand_probs, cand_valid = args[10], args[11]
    if torch.is_tensor(budget):
        budget = budget.to(device)
    Omega, Deltas, greedy_probs, valid = selection_problem(
        cfg, n_imu, dt_imu, *args)
    with torch.no_grad():
        # 6. greedy over candidates
        if budget is None:
            budget = kappa
        sel, OmF = ant.select_informative(
            Omega, Deltas, greedy_probs, valid, kappa,
            impl=impl, budget=budget, group=group, device=device)
        # backfill to κ by tracking probability when anticipation finds fewer
        # informative candidates than budget (fast rotation can FOV-gate
        # every candidate out of the horizon; the reference's greedy still
        # fills κ — zero-gain candidates tie and argmax picks one)
        F = cand_probs.shape[0]
        n_sel = torch.sum(sel)
        score = torch.where((cand_valid > 0) & (sel < 0.5), cand_probs,
                            torch.full_like(cand_probs, float("-inf")))
        order = torch.argsort(-score, stable=True)
        rank = torch.zeros(F, dtype=sel.dtype, device=device).scatter(
            0, order, torch.arange(F, dtype=sel.dtype, device=device))
        extra = (rank < (budget - n_sel)) & torch.isfinite(score)
        sel = torch.clamp(sel + extra.to(sel.dtype), max=1.0)
    return sel, OmF

