"""Multi-rank sharding of the window solver — feature shards, all-reduced
normal equations.

Counterpart of `anticipated_vins_mono_tpu/parallel/sharded.py`, where a
`shard_map` over a device mesh runs one solve per (dp, fp) shard and `psum`
reduces over fp. Here every rank of a `torch.distributed` process group is
one (dp, fp) shard, and each `psum` is a `dist.all_reduce` over the rank's
fp group:

- **dp** (scenario parallelism): independent window problems split over
  ranks — no collectives inside a scenario;
- **fp** (feature parallelism): each scenario's landmark slots are split
  over ranks; every rank linearizes only its landmark shard, the
  Gauss-Newton normal equations, each shard's Schur correction, the
  vision-only cost and the landmark part of the predicted reduction are
  all-reduced, the small reduced pose system is factored by
  `torch.linalg.cholesky` redundantly on every rank (as the JAX module uses
  `jnp.linalg`; the fused Schur kernel has no place here), and landmark
  back-substitution stays on the rank that owns the landmark.

The shared rows (IMU, prior, anchor) are linearized on every fp rank and
scaled by 1/√fp, so the all-reduced normal equations count them once.
Results agree with the single-rank solve up to floating-point
reassociation.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops.preintegration import Preintegrated
from anticipated_vins_mono_torch.ops.window import (
    PriorFactor, WindowConfig, WindowMeasurements, WindowState,
    build_normal_equations, linearize, retract, robust_cost)
from anticipated_vins_mono_torch.parallel.distributed import (
    P, axis_size, global_mesh, shard_problem)
from anticipated_vins_mono_torch.utils.synthetic import make_window_problem
from anticipated_vins_mono_torch.utils.tree import tree_map


def make_mesh(n_dp: int, n_fp: int):
    """The (dp, fp) mesh over the n_dp · n_fp ranks of the process group."""
    return global_mesh(fp=n_fp, dp=n_dp)


def _local_cfg(cfg: WindowConfig, n_fp: int) -> WindowConfig:
    assert cfg.max_feats % n_fp == 0, "max_feats must divide fp shards"
    return cfg._replace(max_feats=cfg.max_feats // n_fp)


def _psum_fn(mesh, axis: str):
    """All-reduce SUM over the rank's `axis` group (identity for one rank)."""
    if axis_size(mesh, axis) == 1:
        return lambda x: x
    group = mesh.get_group(axis)

    def psum(x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x
    return psum


def _blend(okf, a, b):
    """okf·b + (1 − okf)·a per scenario, as the JAX module blends."""
    f = okf.reshape(okf.shape + (1,) * (a.dim() - okf.dim()))
    return f * b + (1.0 - f) * a


def sharded_lm_solve(cfg: WindowConfig, mesh):
    """The multi-rank LM solver on `mesh`.

    Returns `solve(state, meas)` for this rank's block (layout of
    `solver_specs`, leading axis = the rank's scenarios): state fields
    whole except `inv_depth` (fp-sharded); meas fields pts / vel / mask /
    anchor / feat_valid fp-sharded on the feature axis, preintegration and
    prior whole except the prior's `lin.inv_depth`. `solve` returns
    (state block, {"cost0", "cost"} per scenario); the costs are the
    global (all-reduced) ones, equal on every fp rank."""
    n_fp = axis_size(mesh, "fp")
    cfg_l = _local_cfg(cfg, n_fp)
    inv_scale = 1.0 / math.sqrt(float(n_fp))
    psum = _psum_fn(mesh, "fp")
    n_proj = cfg_l.max_feats * cfg_l.nf * 2

    def solve(state: WindowState, meas: WindowMeasurements):
        with torch.no_grad():
            return _solve(state, meas)

    def _solve(state, meas):
        anchor_ref = (state.p[..., 0, :], state.q[..., 0, :])
        vision_meas = meas._replace(
            pre_valid=torch.zeros_like(meas.pre_valid),
            prior=meas.prior._replace(
                weight=torch.zeros_like(meas.prior.weight)))
        cfg_v = cfg_l._replace(anchor_weight=0.0)

        def global_cost(st):
            local = robust_cost(st, meas, cfg_l, anchor_ref)
            # shared factors (IMU + prior + anchor) are evaluated on every
            # fp rank: count them once by subtracting the vision-only part
            vision_only = robust_cost(st, vision_meas, cfg_v, anchor_ref)
            shared = local - vision_only
            return psum(vision_only) + shared

        def body(st, lam, cost):
            r_all, J_all, p_res, p_rows, p_rho, _ = linearize(
                st, meas, cfg_l, anchor_ref)
            r_s = torch.cat([r_all[..., :n_proj],
                             r_all[..., n_proj:] * inv_scale], dim=-1)
            J_s = torch.cat([J_all[..., :n_proj, :],
                             J_all[..., n_proj:, :] * inv_scale], dim=-2)
            H, g, H_lp, h_ll, g_l = build_normal_equations(
                r_s, J_s, p_res, p_rows, p_rho, cfg_l)
            H, g = psum(H), psum(g)
            # Schur reduction of the local landmark block, then all-reduce
            # the reduced system: equal to the global Schur step because
            # the landmark block is diagonal
            lam_ = lam[..., None]
            h_ll_d = h_ll * (1.0 + lam_) + 1e-12
            inv_h = torch.where(h_ll > 1e-10, 1.0 / h_ll_d,
                                torch.zeros_like(h_ll))
            H_red_corr = torch.einsum("...fd,...f,...fe->...de",
                                      H_lp, inv_h, H_lp)
            g_red_corr = (H_lp.mT @ (inv_h * g_l)[..., None])[..., 0]
            H_red = H - psum(H_red_corr)
            g_red = g - psum(g_red_corr)

            diag = torch.diagonal(H_red, dim1=-2, dim2=-1)
            damp = lam_ * torch.clamp(diag, min=1e-8) + 1e-10
            L = lie.cholesky_or_nan(H_red + torch.diag_embed(damp))
            dx = -torch.cholesky_solve(g_red[..., None], L)[..., 0]
            d_rho = -inv_h * (g_l + (H_lp @ dx[..., None])[..., 0])

            pred_local = 0.5 * torch.sum(d_rho * (lam_ * h_ll * d_rho - g_l),
                                         dim=-1)
            pred = 0.5 * torch.sum(dx * (damp * dx - g_red), dim=-1) + \
                psum(pred_local)

            cand = retract(st, dx, d_rho, cfg_l)
            new_cost = global_cost(cand)
            ok = (new_cost < cost) & (pred > 0)
            okf = ok.to(dx.dtype)
            st_next = tree_map(lambda a, b: _blend(okf, a, b), st, cand)
            st_next = st_next._replace(q=lie.quat_normalize(st_next.q),
                                       qic=lie.quat_normalize(st_next.qic))
            lam_next = torch.clamp(
                torch.where(ok, lam * cfg.lm_lambda_down,
                            lam * cfg.lm_lambda_up), 1e-12, 1e8)
            return st_next, lam_next, torch.where(ok, new_cost, cost)

        cost0 = global_cost(state)
        lam = torch.full(state.p.shape[:-2], cfg.lm_lambda_init,
                         dtype=state.p.dtype, device=state.p.device)
        st, cost = state, cost0
        for _ in range(cfg.iters):
            st, lam, cost = body(st, lam, cost)
        return st, {"cost0": cost0, "cost": cost}

    solve.mesh = mesh
    return solve


def solver_specs():
    """Partition trees for sharded_lm_solve's (state, meas) blocks — batch
    axis over dp; the landmark-slot axis over fp for `inv_depth`, `pts`,
    `vel`, `mask`, `anchor`, `feat_valid` and `prior.lin.inv_depth`;
    everything else whole on every fp rank."""
    dp, dpfp = P("dp"), P("dp", "fp")
    state_specs = WindowState(
        p=dp, q=dp, v=dp, ba=dp, bg=dp, tic=dp, qic=dp, td=dp,
        inv_depth=dpfp)
    prior_specs = PriorFactor(
        J0=dp, r0=dp,
        lin=WindowState(p=dp, q=dp, v=dp, ba=dp, bg=dp, tic=dp, qic=dp,
                        td=dp, inv_depth=dpfp),
        weight=dp)
    meas_specs = WindowMeasurements(
        pre=Preintegrated(*([dp] * len(Preintegrated._fields))),
        pre_valid=dp, pts=dpfp, vel=dpfp, mask=dpfp, anchor=dpfp,
        feat_valid=dpfp, prior=prior_specs)
    return state_specs, meas_specs


# ----------------------------------------------------------------------------
# One rank's part of a sharded solve (the worker `spawn_ranks` runs)
# ----------------------------------------------------------------------------


def solve_problems(mesh, cfg: WindowConfig, problems: list, dtype, device):
    """Build the batch of window problems `problems` (one dict of
    `make_window_problem` arguments per scenario; every rank builds them
    all from their seeds), take this rank's block and solve it with
    `sharded_lm_solve`. Returns this rank's results as numpy: its dp and fp
    index, its scenarios' positions and global costs."""
    probs = [make_window_problem(cfg, dtype=dtype, device="cpu", **kw)
             for kw in problems]
    stack = lambda *x: torch.stack(x)
    state = tree_map(stack, *[p.init for p in probs])
    meas = tree_map(stack, *[p.meas for p in probs])
    state, meas = shard_problem(mesh, state, meas, device)
    out, diag = sharded_lm_solve(cfg, mesh)(state, meas)
    return {"dp": mesh.get_local_rank("dp"), "fp": mesh.get_local_rank("fp"),
            "p": out.p.cpu().numpy(), "inv_depth": out.inv_depth.cpu().numpy(),
            "cost0": diag["cost0"].cpu().numpy(),
            "cost": diag["cost"].cpu().numpy()}


def solve_rank(rank, n_ranks, cfg: WindowConfig, n_fp: int, problems: list,
               dtype=torch.float64, device="cuda"):
    """Worker for `spawn_ranks`: `solve_problems` on a (n_ranks / n_fp,
    n_fp) mesh."""
    mesh = make_mesh(n_ranks // n_fp, n_fp)
    return solve_problems(mesh, cfg, problems, dtype, torch.device(device))
