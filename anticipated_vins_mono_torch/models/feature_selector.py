"""Attention feature selection orchestration — FeatureSelector::select parity.

Counterpart of `anticipated_vins_mono_tpu/models/feature_selector.py`. It
mirrors the reference's feature_selector.cpp:74-202:

1. split incoming measurements into tracked vs new by feature-id watermark
   (splitOnFeatureId, :208-219)
2. generate the future state horizon (imu | gt mode)
3. Ω_{k:k+H} from anticipated motion + identity prior
4. Δ_ℓ for new candidates and for the already-tracked subset
5. κ = max_features − |tracked|; greedy logdet selection of new features

Host part (`AttentionSelector`): id bookkeeping and dict packing, numpy.
Device part (`_device_select`): horizon → Ω → batched Δ_ℓ → κ-round greedy
→ backfill to κ̄ by tracking probability, on the selector's `device`. Where
the JAX package reads `ANT_SELECT_IMPL` / `ANT_SELECT_GROUP` from the
environment, both take `impl=` and `group=` keywords.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.ops import lie


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
    passed to `anticipation.select_informative` (the JAX package reads them
    from environment variables instead). `device` is where the pipeline
    runs: tensor arguments are moved there, and a CUDA device that is not
    present raises. Returns (selected mask [F], final Ω, horizon p, q).
    """
    device = torch.device(device)
    (p_k1, q_k1, v_k1, acc, gyr, ba, bg, tic, qic, cand_pts, cand_probs,
     cand_valid, used_pts, used_depths, used_valid, lm_uv, lm_depth,
     lm_mask, gt_p, gt_q) = (
        x if x is None else x.to(device) for x in (
            p_k1, q_k1, v_k1, acc, gyr, ba, bg, tic, qic, cand_pts,
            cand_probs, cand_valid, used_pts, used_depths, used_valid,
            lm_uv, lm_depth, lm_mask, gt_p, gt_q))
    if torch.is_tensor(budget):
        budget = budget.to(device)
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

        # 5. Ω ← Ω + Σ Δ_used, then greedy over candidates
        Omega = Omega + torch.sum(D_used, dim=0)
        if budget is None:
            budget = kappa
        sel, OmF = ant.select_informative(
            Omega, Deltas, greedy_probs,
            cand_valid * (nvis >= 2).to(cand_valid.dtype), kappa,
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
    return sel, OmF, ps, qs


device_select = _device_select


def _np_quat_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _np_quat_mul(q, p):
    qw, qx, qy, qz = q
    pw, px, py, pz = p
    return np.array([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw])


def _np_exp_quat(theta):
    angle = np.linalg.norm(theta)
    if angle < 1e-9:
        return np.array([1.0, *(0.5 * theta)])
    k = np.sin(0.5 * angle) / angle
    return np.array([np.cos(0.5 * angle), *(k * theta)])


class AttentionSelector:
    """Host wrapper holding the id watermark + config.

    The JAX constructor's arguments, plus `impl` / `group` (handed to
    `_device_select`) and `device` (where the anticipation pipeline runs;
    default the card). `n_anticipate` counts the calls that ran the
    pipeline: each makes κ̄ greedy rounds."""

    def __init__(self, cfg: ant.SelectorConfig, max_candidates: int = 128,
                 tic: Optional[np.ndarray] = None,
                 qic: Optional[np.ndarray] = None,
                 frame_dt: float = 0.1, imu_rate: float = 200.0,
                 policy: str = "anticipate", seed: int = 0,
                 gt_provider=None,
                 validity_aware: bool = False,
                 validity_thresh: float = 0.15,
                 validity_ema: float = 0.7,
                 impl: Optional[str] = None, group: Optional[int] = None,
                 device="cuda"):
        # gt_provider(t) -> (gt_p [H+1,3], gt_q [H+1,4]) at the horizon frame
        # times — enables the reference's groundTruth horizon mode (planner/
        # MPC emulation, use_ground_truth_hgen)
        # policy: "anticipate" (attention algorithm) | "quality" (top-κ by
        # tracking score) | "random" (random κ) — the three variants of
        # results.tex:41-50
        assert policy in ("anticipate", "quality", "random"), policy
        self.policy = policy
        self.rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.max_candidates = max_candidates
        self.last_feature_id = -1
        self.first_image = True
        # ids ever passed to the backend (trackedFeatures_,
        # feature_selector.cpp:103-110,195-197): previously-seen ids NOT in
        # this set were rejected before and stay dropped
        self.tracked_ids: set = set()
        self.tic = np.zeros(3) if tic is None else np.asarray(tic, float)
        self.qic = np.array([1.0, 0, 0, 0]) if qic is None else np.asarray(qic, float)
        self.n_imu = int(round(frame_dt * imu_rate))
        self.dt_imu = 1.0 / imu_rate
        self.gt_provider = gt_provider
        self.frame_dt = frame_dt
        # horizon-validity-aware policy: every frame the horizon's own
        # one-step prediction is checked against the realized state; when
        # the EMA of the relative error exceeds the threshold, selection
        # falls back to quality (top-κ by score) until the motion becomes
        # predictable again
        self.validity_aware = validity_aware
        self.validity_thresh = validity_thresh
        self.validity_ema = validity_ema
        self._pred = None     # (t_expected, p_pred, step_mag)
        self._mis = 0.0       # EMA of relative one-step prediction error
        self.diag_mis: list = []
        self.diag_fallback = 0
        self.impl = impl
        self.group = group
        self.device = torch.device(device)
        self.n_anticipate = 0

    def select(self, feats: dict, state_k1: dict, db=None,
               initialized: bool = True, dtype=torch.float64) -> dict:
        """feats: {id: (pt3, vel2, prob)} → pruned dict (tracked ∪ selected).

        state_k1: {"p","q","v","ba","bg","acc","gyr"} — the IMU-propagated
        next state + latest IMU sample (setNextStateFromImuPropagation,
        feature_selector.h:64-68). `dtype` is the anticipation pipeline's
        (the estimator passes its own; float32 "chol" on the card scores with
        the log-det kernel).
        """
        cfg = self.cfg
        # subset = previously-selected ids found again (:111-120); other old
        # ids were rejected earlier and remain dropped
        tracked = {i: f for i, f in feats.items() if i in self.tracked_ids}
        new = {i: f for i, f in feats.items() if i > self.last_feature_id}
        if new:
            self.last_feature_id = max(new.keys())

        # pass-through regimes (feature_selector.cpp:151-187): before the
        # backend initializes, no selection runs; every pre-init feature
        # passes AND registers (a deliberate change from the reference,
        # kept from the JAX package), and the κ budget engages the moment
        # the backend is initialized
        if not initialized:
            self.first_image = False
            self.tracked_ids.update(feats.keys())
            return feats

        if self.first_image:
            self.first_image = False
            self.tracked_ids.update(feats.keys())
            return feats

        kappa = cfg.max_features - len(tracked)
        if kappa <= 0 or not new:
            return tracked

        active_policy = self.policy
        if self.validity_aware and self.policy == "anticipate":
            active_policy = self._validity_update(state_k1)

        if active_policy != "anticipate":
            ids = list(new.keys())
            if active_policy == "quality":
                ids.sort(key=lambda i: -new[i][2])   # top-κ by score
            else:
                self.rng.shuffle(ids)
            out = dict(tracked)
            for i in ids[:kappa]:
                out[i] = new[i]
                self.tracked_ids.add(i)
            return out

        F = self.max_candidates
        ids = list(new.keys())[:F]
        cand_pts = np.zeros((F, 3))
        cand_probs = np.ones(F)
        cand_valid = np.zeros(F)
        for k, i in enumerate(ids):
            pt, vel, prob = new[i]
            cand_pts[k] = pt
            cand_probs[k] = prob
            cand_valid[k] = 1.0

        # tracked subset with current depth estimates (for Δ_used)
        U = F
        used_pts = np.zeros((U, 3))
        used_depths = np.full(U, 5.0)
        used_valid = np.zeros(U)
        lm_uv = np.zeros((F, 2))
        lm_depth = np.full(F, 5.0)
        lm_mask = np.zeros(F)
        if db is not None:
            slots = np.nonzero((db.ids >= 0) & (db.solved > 0))[0][:F]
            for k, s in enumerate(slots):
                a = db.anchor[s]
                lm_uv[k] = db.pts[s, a, :2]
                lm_depth[k] = 1.0 / max(db.inv_depth[s], 1e-3)
                lm_mask[k] = 1.0
        for k, i in enumerate(list(tracked.keys())[:U]):
            pt, vel, prob = tracked[i]
            used_pts[k] = pt
            used_valid[k] = 1.0
            if db is not None:
                s = db._find(i)
                if s >= 0 and db.solved[s] > 0:
                    used_depths[k] = 1.0 / max(db.inv_depth[s], 1e-3)

        def t(x):
            return torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                                device=self.device)

        gt_args = ()
        if self.gt_provider is not None and "t" in state_k1:
            pair = self.gt_provider(state_k1["t"])
            if pair is not None:
                gt_args = (t(pair[0]), t(pair[1]))

        sel, _, _, _ = _device_select(
            cfg, cfg.max_features, self.n_imu, self.dt_imu,
            t(state_k1["p"]), t(state_k1["q"]), t(state_k1["v"]),
            t(state_k1["acc"]), t(state_k1["gyr"]),
            t(state_k1.get("ba", np.zeros(3))),
            t(state_k1.get("bg", np.zeros(3))),
            t(self.tic), t(self.qic),
            t(cand_pts), t(cand_probs), t(cand_valid),
            t(used_pts), t(used_depths), t(used_valid),
            t(lm_uv), t(lm_depth), t(lm_mask),
            *gt_args, budget=torch.tensor(int(kappa), device=self.device),
            impl=self.impl, group=self.group, device=self.device)
        self.n_anticipate += 1
        sel = sel.cpu().numpy()   # the one read back of the call

        out = dict(tracked)
        for k, i in enumerate(ids):
            if sel[k] > 0.5:
                out[i] = new[i]
                self.tracked_ids.add(i)
        return out

    # ------------------------------------------------------------------
    # horizon validity (validity_aware policy)
    # ------------------------------------------------------------------

    def _validity_update(self, state_k1: dict) -> str:
        """Check the previous frame's one-step horizon prediction against
        the realized state, update the mismatch EMA, store this frame's
        prediction, and return the policy to use NOW."""
        t = state_k1.get("t")
        p_now = np.asarray(state_k1["p"], float)
        if t is not None and self._pred is not None:
            t_exp, p_pred, step = self._pred
            if abs(t - t_exp) < 0.5 * self.frame_dt:
                rel = np.linalg.norm(p_now - p_pred) / max(step, 0.02)
                self._mis = self.validity_ema * self._mis \
                    + (1.0 - self.validity_ema) * rel
                self.diag_mis.append(float(self._mis))
        # one-step constant-ω/a prediction — the numpy mirror of
        # ant.imu_horizon's first frame_step (n_imu substeps)
        p = p_now.copy()
        v = np.asarray(state_k1["v"], float).copy()
        q = np.asarray(state_k1["q"], float).copy()
        a_b = np.asarray(state_k1["acc"], float) \
            - np.asarray(state_k1.get("ba", np.zeros(3)), float)
        w = (np.asarray(state_k1["gyr"], float)
             - np.asarray(state_k1.get("bg", np.zeros(3)), float))
        g = np.array([0.0, 0.0, -9.81007])
        dt = self.dt_imu
        for _ in range(self.n_imu):
            a_w = _np_quat_rot(q) @ a_b + g
            p += v * dt + 0.5 * a_w * dt * dt
            v += a_w * dt
            q = _np_quat_mul(q, _np_exp_quat(w * dt))
            q /= np.linalg.norm(q)
        if t is not None:
            self._pred = (t + self.frame_dt, p,
                          float(np.linalg.norm(p - p_now)))
        if self._mis > self.validity_thresh:
            self.diag_fallback += 1
            return "quality"
        return "anticipate"
