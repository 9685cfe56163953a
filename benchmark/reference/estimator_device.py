"""Device-resident sliding-window VIO: the whole steady-state per-frame
estimator step — IMU propagation → anticipation gate → feature DB update
(slot bookkeeping) → keyframe decision → triangulation → window LM solve →
outlier demotion → marginalization → window slide.

Counterpart of `anticipated_vins_mono_tpu/models/estimator_device.py`,
function for function. Everything (window states, landmark slots, raw-IMU
pair buffers, the marginalization prior) is held as fixed-size tensors on
the device; list surgery is masked shifts, dict insertion is one-hot id
matching plus rank-matched slot filling.

Where the two differ:

- the JAX step is one jitted program; here it is eager PyTorch. The keyframe
  decision is read on the host once per frame and only the marginalization
  that is taken runs (the JAX `lax.cond`): `torch.linalg.eigh`, which both
  marginalizations call, synchronises with the host anyway;
- the failure path stays a `torch.where` blend over the state tree;
- every `.at[...].set(...)` of the JAX code is a write into a fresh clone:
  `vio_step` leaves the state it was given unchanged;
- `_propagate` evaluates the 64-step midpoint recurrence with a prefix
  product of the per-sample rotations and two prefix sums in place of a
  sample-by-sample loop (same recurrence; padding rows, dt = 0, are exact
  no-ops);
- `DeviceVioParams` carries `sel_impl` / `sel_group`, which the JAX package
  reads from the environment (`ANT_SELECT_IMPL`, `ANT_SELECT_GROUP`);
- `vio_init_oracle` fills the first NF−1 frames from a known initial state
  on device arrays; `vio_init_from_host` snapshots the port's host
  `VioEstimator` (`models/estimator.py`) after its initialization chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import anticipation as ant
from benchmark.reference.feature_selector import (_device_select,
                                                   selection_problem)
from benchmark.reference import lie
from benchmark.reference import marginalization as mg
from benchmark.reference.preintegration import (
    ImuNoise, preintegrate)
from benchmark.reference.triangulation import triangulate
from benchmark.reference.window import (
    PriorFactor, WindowConfig, WindowMeasurements, WindowState, lm_solve)
from benchmark.reference.tree import tree_map, tree_to

Tensor = torch.Tensor

MAX_IMU_PER_PAIR = 64   # static pad of the raw-IMU pair buffers
MIN_PARALLAX = 10.0 / 460.0


class DeviceVioParams(NamedTuple):
    """Static configuration of the device VIO step."""
    wcfg: WindowConfig = WindowConfig()
    noise: ImuNoise = ImuNoise()
    # anticipation/attention selection on the device: None = no budget (all
    # tracker features enter the DB). With a SelectorConfig, each step runs
    # the full horizon→Ω→Δ→greedy pipeline (feature_selector._device_select)
    # on the tracker's candidates with the dynamic κ̄ − tracked budget, and
    # only tracked + selected features are inserted.
    sel_cfg: "ant.SelectorConfig" = None
    sel_n_imu: int = 20             # horizon IMU substeps (frame_dt*rate)
    sel_dt_imu: float = 0.005
    min_parallax: float = MIN_PARALLAX
    demote_px: float = 5.0
    demote_focal: float = 460.0
    max_speed_fail: float = 10.0    # [m/s]
    zupt: bool = True
    zupt_weight: float = 30.0
    zupt_gyr_thresh: float = 0.05
    zupt_gyr_mean_thresh: float = 0.03
    zupt_acc_thresh: float = 1.0
    # on the fail flag, perform the device-side reboot (_device_reboot)
    # instead of freezing; False restores flag-only behavior
    reboot_on_fail: bool = True
    # weight of the post-reboot velocity-damping rows (see _measurements)
    recovery_vel_weight: float = 1.5
    # junk-slot eviction in _db_add_frame
    slot_evict: bool = True
    # scoring of the greedy selection and its group size, handed to
    # `_device_select(impl=, group=)`
    sel_impl: str = None
    sel_group: int = None


class DeviceVioState(NamedTuple):
    """Fixed-size device-resident estimator state of one scenario.

    Window arrays are [NF,*]; landmark slots [F,*]; raw-IMU pair buffers
    [W, S] with dt==0 padding (pair i connects frames i → i+1)."""
    p: Tensor          # [NF,3]
    q: Tensor          # [NF,4]
    v: Tensor          # [NF,3]
    ba: Tensor         # [NF,3]
    bg: Tensor         # [NF,3]
    tic: Tensor        # [3]
    qic: Tensor        # [4]
    td: Tensor         # []
    # feature DB
    ids: Tensor        # [F] i32, -1 = free
    pts: Tensor        # [F,NF,3]
    vel: Tensor        # [F,NF,2]
    prob: Tensor       # [F]
    mask: Tensor       # [F,NF]
    inv_depth: Tensor  # [F]
    solved: Tensor     # [F]
    # raw IMU per adjacent pair
    imu_dts: Tensor    # [W,S]
    imu_acc: Tensor    # [W,S,3]
    imu_gyr: Tensor    # [W,S,3]
    imu_a0: Tensor     # [W,3]
    imu_g0: Tensor     # [W,3]
    stationary: Tensor  # [NF]
    td_at_frame: Tensor  # [NF]
    prior: PriorFactor
    speed_hist: Tensor  # [8] rolling ‖v[newest]‖ (tripwire)
    n_solves: Tensor    # [] i32
    # id watermark: ids ≤ watermark that are not in the DB were rejected by
    # a past selection round and stay dropped
    last_id: Tensor     # [] i32
    # frames since the last device reboot. While < 2·NF the marginalization
    # prior is held at weight 0 (post-reboot holdoff): the reboot's attitude
    # comes from ONE raw accel sample, and building a prior before vision
    # refills would lock in the gravity misalignment.
    since_fail: Tensor  # [] i32


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _quat_prefix_products(dq: Tensor) -> Tensor:
    """out[k] = dq[0] ⊗ dq[1] ⊗ … ⊗ dq[k] for dq [S,4], by a log-step scan
    (the quaternion product is associative)."""
    S = dq.shape[0]
    out = dq
    eye = lie.quat_identity(dq.dtype, dq.device)
    shift = 1
    while shift < S:
        left = torch.cat([eye.expand(shift, 4), out[:-shift]], dim=0)
        out = lie.quat_mul(left, out)
        shift *= 2
    return out


def _propagate(p, q, v, ba, bg, dts, accs, gyrs, acc0, gyr0):
    """Midpoint IMU propagation over a dt-padded buffer.

    The JAX package scans the samples:
        ω̄ = ½(ω_prev + ω_k) − bg,   q_k = q_{k−1} ⊗ exp(ω̄·dt_k),
        ā = ½(R(q_{k−1})(a_prev − ba) + R(q_k)(a_k − ba)) + g,
        p += v·dt + ½ā·dt²,  v += ā·dt,
    skipping rows with dt = 0. The rotation increments do not depend on p or
    v, so q_k is a prefix product, and v and p are prefix sums of ā·dt: the
    same recurrence without the sample-by-sample loop. A row with dt = 0 has
    exp(0) = identity and adds zero, whatever it holds."""
    S = dts.shape[0]
    dev = dts.device
    valid = dts > 0
    # the sample before each row: the last valid row before it, else the
    # interval's start sample
    ar = torch.arange(S, device=dev)
    last = torch.cummax(torch.where(valid, ar, torch.full_like(ar, -1)),
                        dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]]) + 1
    a_prev = torch.cat([acc0[None], accs], dim=0)[prev]
    w_prev = torch.cat([gyr0[None], gyrs], dim=0)[prev]

    dt = dts[:, None]
    un_w = 0.5 * (w_prev + gyrs) - bg
    q_all = lie.quat_normalize(lie.quat_mul(
        q[None], _quat_prefix_products(lie.exp_so3_quat(un_w * dt))))
    q_before = torch.cat([q[None], q_all[:-1]], dim=0)
    g = torch.tensor([0.0, 0.0, -9.81007], dtype=p.dtype, device=dev)
    un_a = 0.5 * (lie.quat_rotate(q_before, a_prev - ba)
                  + lie.quat_rotate(q_all, accs - ba)) + g
    dv = torch.cumsum(un_a * dt, dim=0)
    v_before = v[None] + torch.cat([torch.zeros_like(dv[:1]), dv[:-1]], dim=0)
    p_new = p + torch.sum(v_before * dt + 0.5 * un_a * dt * dt, dim=0)
    return p_new, q_all[-1], v + dv[-1]


def _zupt_flag(pr: DeviceVioParams, dts, accs, gyrs, bg_prev):
    """Stationarity detection from the raw pair buffer."""
    valid = (dts > 0)[:, None]
    count = torch.sum(valid)
    n = torch.clamp(count.to(dts.dtype), min=1.0)
    zero = torch.zeros((), dtype=accs.dtype, device=accs.device)
    g_mean = torch.sum(gyrs * valid, dim=0) / n
    a_mean = torch.sum(accs * valid, dim=0) / n
    g_fluct = torch.max(torch.where(valid, torch.abs(gyrs - g_mean), zero))
    a_fluct = torch.max(torch.where(valid, torch.abs(accs - a_mean), zero))
    g_norm = torch.linalg.norm(g_mean - bg_prev)
    flag = ((g_fluct < pr.zupt_gyr_thresh)
            & (g_norm < pr.zupt_gyr_mean_thresh)
            & (a_fluct < pr.zupt_acc_thresh)
            & (count > 0))
    return flag.to(dts.dtype)


def _first_true(x: Tensor, dim: int) -> Tensor:
    """Index of the first True along `dim` (0 where there is none), as
    `jnp.argmax` gives on a boolean array: `torch.argmax` returns the first
    of several maxima."""
    return torch.argmax(x.to(torch.int32), dim=dim)


def _match_ids(st: DeviceVioState, in_ids, in_active):
    """One-hot [F,N] match of the occupied slots' ids against the active
    input ids."""
    occupied = st.ids >= 0
    eq = (st.ids[:, None] == in_ids[None, :]) & in_active[None, :] \
        & occupied[:, None]
    return occupied, eq


def _db_add_frame(st: DeviceVioState, k: int, in_ids, in_pts, in_vel,
                  in_prob, in_active, min_parallax, slot_evict: bool = True):
    """Observation insertion + keyframe decision as masked array ops: id
    matching is a one-hot [F,N] equality; free-slot allocation matches the
    rank of each available slot to the rank of each new feature.

    Returns (state, keyframe [] bool, tracked [])."""
    F = st.ids.shape[0]
    dtype, dev = st.pts.dtype, st.pts.device
    occupied, eq = _match_ids(st, in_ids, in_active)
    matched_slot = torch.any(eq, dim=1)                       # [F]
    match_idx = _first_true(eq, 1)                            # [F]
    matched_in = torch.any(eq, dim=0)                         # [N]
    tracked = torch.sum(matched_slot)

    is_new = in_active & ~matched_in
    rank_new = torch.cumsum(is_new.to(torch.int32), dim=0) - 1   # [N]
    free = ~occupied
    # junk eviction: when free slots run out, occupied slots with no
    # observation in the previous frame and <2 total observations are fair
    # game — dead 1-obs tracks can never become factors. Allocation order =
    # all free slots (by index), then junk slots (by index).
    junk = occupied & (st.mask[:, k - 1] <= 0) \
        & (torch.sum(st.mask, dim=1) < 2)
    if not slot_evict:
        junk = torch.zeros_like(junk)
    avail = free | junk
    arange_f = torch.arange(F, device=dev)
    key = torch.where(avail,
                      torch.where(free, arange_f, F + arange_f),
                      2 * F + arange_f)
    order = torch.argsort(key, stable=True)
    rank_avail = torch.zeros(F, dtype=torch.int32, device=dev).scatter(
        0, order, torch.arange(F, dtype=torch.int32, device=dev))
    fill = avail[:, None] & is_new[None, :] \
        & (rank_avail[:, None] == rank_new[None, :])          # [F,N]
    fills = torch.any(fill, dim=1)
    fill_idx = _first_true(fill, 1)

    take = matched_slot | fills
    src = torch.where(matched_slot, match_idx, fill_idx)
    # fresh slots: clear history, reset depth
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    pts = torch.where(fills[:, None, None], zero, st.pts)
    vel = torch.where(fills[:, None, None], zero, st.vel)
    mask = torch.where(fills[:, None], zero, st.mask)
    inv_depth = torch.where(fills, one, st.inv_depth)
    solved = torch.where(fills, zero, st.solved)
    ids = torch.where(fills, in_ids[fill_idx], st.ids)

    obs_p = in_pts[src]                                       # [F,3]
    obs_v = in_vel[src]
    obs_pr = in_prob[src]
    # pts / vel / mask are fresh tensors (torch.where above): writing a
    # column touches nothing of the caller's state
    pts[:, k] = torch.where(take[:, None], obs_p, pts[:, k])
    vel[:, k] = torch.where(take[:, None], obs_v, vel[:, k])
    mask[:, k] = torch.where(take, one, mask[:, k])
    prob = torch.where(take, obs_pr, st.prob)
    # anchor-velocity backfill: a feature's first observation carries the
    # tracker's 0-velocity sentinel, and that observation is the td factor's
    # anchor — copy the now-known velocity back one frame
    prev_first = matched_slot & (mask[:, k - 1] > 0) \
        & ~torch.any(vel[:, k - 1] != 0.0, dim=-1)
    vel[:, k - 1] = torch.where(prev_first[:, None], obs_v, vel[:, k - 1])

    # keyframe: parallax between frames k-2 and k-1
    both = (mask[:, k - 2] > 0) & (mask[:, k - 1] > 0)
    dist = torch.linalg.norm(pts[:, k - 2, :2] - pts[:, k - 1, :2], dim=-1)
    par = torch.sum(torch.where(both, dist, zero)) \
        / torch.clamp(torch.sum(both).to(dtype), min=1.0)
    keyframe = (tracked < 20) | (par >= min_parallax)

    st = st._replace(ids=ids, pts=pts, vel=vel, mask=mask, prob=prob,
                     inv_depth=inv_depth, solved=solved)
    return st, keyframe, tracked.to(dtype)


def _feat_valid(st: DeviceVioState):
    return ((st.ids >= 0) & (torch.sum(st.mask, dim=1) >= 2)).to(st.pts.dtype)


def _anchor(st: DeviceVioState):
    return _first_true(st.mask > 0, 1).to(torch.int32)


def _window_state(st: DeviceVioState, cfg: WindowConfig) -> WindowState:
    return WindowState(p=st.p, q=st.q, v=st.v, ba=st.ba, bg=st.bg,
                       tic=st.tic, qic=st.qic, td=st.td,
                       inv_depth=st.inv_depth)


def _anchor_obs(st: DeviceVioState, a: Tensor) -> Tensor:
    """Each slot's observation at its anchor frame, [F,3]."""
    idx = a.long()[:, None, None].expand(-1, 1, st.pts.shape[-1])
    return torch.gather(st.pts, 1, idx)[:, 0]


def _measurements(st: DeviceVioState, pr: DeviceVioParams, feat_valid):
    cfg = pr.wcfg
    W = cfg.window
    dtype, dev = st.pts.dtype, st.pts.device
    pre = preintegrate(st.imu_dts, st.imu_acc, st.imu_gyr, st.imu_a0,
                       st.imu_g0, st.ba[:W], st.bg[:W], pr.noise)
    zupt_w = None
    if pr.zupt or pr.reboot_on_fail:
        zupt_w = st.stationary * pr.zupt_weight if pr.zupt \
            else torch.zeros(cfg.nf, dtype=dtype, device=dev)
        if pr.reboot_on_fail:
            # post-reboot velocity damping: a weak pull of every window
            # velocity toward 0 while the prior is held off. Without an
            # absolute velocity reference, a global attitude tilt is an
            # exact gauge mode that lets ‖v‖ ramp at g·sin(tilt) with zero
            # residual everywhere; the damping rows select the
            # minimum-velocity member of that family, which re-couples the
            # tilt to the IMU residuals.
            recov = (st.since_fail < 2 * cfg.nf).to(dtype)
            zupt_w = zupt_w + recov * pr.recovery_vel_weight
    # roll/pitch anchor: pinned in normal operation; freed during the
    # post-reboot recovery window so the one-sample attitude error stays
    # correctable
    pin_rp = None
    if pr.reboot_on_fail:
        pin_rp = (st.since_fail >= 2 * cfg.nf).to(dtype)
    return WindowMeasurements(
        pre=pre, pre_valid=torch.ones(W, dtype=dtype, device=dev),
        pts=st.pts, vel=st.vel, mask=st.mask, anchor=_anchor(st),
        feat_valid=feat_valid, prior=st.prior,
        anchor_pin_rp=pin_rp,
        zupt_w=zupt_w,
        td_obs=st.td_at_frame if cfg.estimate_td else None)


def _demote_outliers(st: DeviceVioState, pr: DeviceVioParams):
    """Demote (solved=0, depth reset) landmarks whose depth collapsed or
    whose mean reprojection error exceeds demote_px — never delete (the
    observation history is preserved)."""
    cfg = pr.wcfg
    dtype, dev = st.pts.dtype, st.pts.device
    R = lie.quat_to_rot(st.q)                                 # [NF,3,3]
    Ric = lie.quat_to_rot(st.qic)
    a = _anchor(st)
    al = a.long()
    valid = (_feat_valid(st) * st.solved) > 0
    pt_a = _anchor_obs(st, a)
    ptc = pt_a / torch.clamp(st.inv_depth, min=1e-6)[:, None]
    pw = torch.einsum("fij,fj->fi", R[al], ptc @ Ric.T + st.tic) \
        + st.p[al]                                            # [F,3]
    rel = pw[:, None, :] - st.p[None, :, :]                   # [F,NF,3]
    pc = torch.einsum("ij,fnj->fni", Ric.T,
                      torch.einsum("nji,fnj->fni", R, rel) - st.tic)
    proj = pc[..., :2] / torch.clamp(pc[..., 2:], min=1e-9)
    err = torch.linalg.norm(proj - st.pts[..., :2], dim=-1) * pr.demote_focal
    err = torch.where(pc[..., 2] < 1e-3, torch.full_like(err, 100.0), err)
    use = (st.mask > 0) & (torch.arange(st.mask.shape[1], device=dev)[None, :]
                           != al[:, None])
    n = torch.sum(use, dim=1)
    mean_err = torch.sum(torch.where(use, err, torch.zeros_like(err)), dim=1) \
        / torch.clamp(n, min=1).to(dtype)
    demote = valid & (
        (st.inv_depth <= cfg.min_inv_depth * 1.001)
        | ((n >= 1) & (mean_err > pr.demote_px)))
    return st._replace(
        solved=torch.where(demote, torch.zeros_like(st.solved), st.solved),
        inv_depth=torch.where(demote, torch.full_like(st.inv_depth, 0.2),
                              st.inv_depth))


def _shift_left(arr: Tensor, k: int) -> Tensor:
    """arr[k:-1] = arr[k+1:] along axis 0; the last row keeps its old value
    (it is overwritten by the next frame's propagation before any read)."""
    return torch.cat([arr[:k], arr[k + 1:], arr[-1:]], dim=0)


def _merge_pair_buffers(dts_a, acc_a, gyr_a, dts_b, acc_b, gyr_b):
    """Concatenate two padded pair buffers; if the result exceeds the static
    cap, fuse adjacent samples pairwise (dt-summed, dt-weighted means). Both
    forms are computed (a few hundred elements) and one is selected."""
    S = dts_a.shape[0]
    dev = dts_a.device
    na = torch.sum(dts_a > 0)
    idx = torch.arange(S, device=dev)

    def joined(x_a, x_b):
        out = x_a.new_zeros((2 * S,) + x_a.shape[1:])
        out.index_add_(0, idx, x_a)
        out.index_add_(0, na + idx, x_b)
        return out

    d2, a2, g2 = joined(dts_a, dts_b), joined(acc_a, acc_b), joined(gyr_a, gyr_b)
    total = na + torch.sum(dts_b > 0)

    dp = d2.reshape(S, 2)
    w = dp / torch.clamp(torch.sum(dp, dim=1, keepdim=True), min=1e-12)
    fused = (torch.sum(dp, dim=1),
             torch.sum(a2.reshape(S, 2, 3) * w[..., None], dim=1),
             torch.sum(g2.reshape(S, 2, 3) * w[..., None], dim=1))
    over = total > S
    return tuple(torch.where(over, f, t)
                 for f, t in zip(fused, (d2[:S], a2[:S], g2[:S])))


def _drop_dead_slots(st: DeviceVioState, mask, solved):
    """ids / solved with the slots freed whose tracks fell below one
    observation in the slid `mask`."""
    dead = (st.ids >= 0) & (torch.sum(mask, dim=1) < 1)
    return (torch.where(dead, torch.full_like(st.ids, -1), st.ids),
            torch.where(dead, torch.zeros_like(solved), solved))


def _slide_oldest_db(st: DeviceVioState, cfg: WindowConfig):
    """Feature DB slide on a keyframe: re-anchor frame-0 depths, shift
    tracks left, free dead slots."""
    R0 = lie.quat_to_rot(st.q[0])
    R1 = lie.quat_to_rot(st.q[1])
    Ric = lie.quat_to_rot(st.qic)
    anchored0 = (st.ids >= 0) & (st.mask[:, 0] > 0)
    keep = anchored0 & (torch.sum(st.mask[:, 1:], dim=1) >= 1)
    pt = st.pts[:, 0] / torch.clamp(st.inv_depth, min=1e-6)[:, None]
    pw = (pt @ Ric.T + st.tic) @ R0.T + st.p[0]
    pc = ((pw - st.p[1]) @ R1 - st.tic) @ Ric
    ok = pc[:, 2] > 0.1
    re_d = torch.where(ok, 1.0 / torch.clamp(pc[:, 2], min=1e-6),
                       torch.full_like(pc[:, 2], 0.2))
    upd = keep & (st.solved > 0)
    inv_depth = torch.where(upd, re_d, st.inv_depth)
    solved = torch.where(upd & ~ok, torch.zeros_like(st.solved), st.solved)

    left = lambda x: torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    pts, vel, mask = left(st.pts), left(st.vel), left(st.mask)
    ids, solved = _drop_dead_slots(st, mask, solved)
    return st._replace(ids=ids, pts=pts, vel=vel, mask=mask,
                       inv_depth=inv_depth, solved=solved)


def _slide_second_newest_db(st: DeviceVioState, cfg: WindowConfig):
    """Feature DB slide on a non-keyframe: the newest frame's observations
    take the place of the second-newest's."""
    k = cfg.nf - 2

    def drop(x):
        x = x.clone()
        x[:, k] = x[:, k + 1]
        x[:, k + 1] = 0.0
        return x

    pts, vel, mask = drop(st.pts), drop(st.vel), drop(st.mask)
    ids, solved = _drop_dead_slots(st, mask, st.solved)
    return st._replace(ids=ids, pts=pts, vel=vel, mask=mask, solved=solved)


def _selector_args(pr: DeviceVioParams, st: DeviceVioState, k: int,
                   in_ids, in_pts, in_prob, in_active, imu_dts, imu_acc,
                   imu_gyr):
    """(features already in the DB [N], the dynamic κ̄−tracked budget, the
    frame's arguments of `_device_select` after its first four)."""
    scfg = pr.sel_cfg
    dtype = st.pts.dtype
    occupied, eq = _match_ids(st, in_ids, in_active)
    matched_in = torch.any(eq, dim=0)                         # [N]
    slot_matched = torch.any(eq, dim=1)                       # [F]
    slot_in = _first_true(eq, 1)                              # [F]
    tracked_n = torch.sum(slot_matched)
    budget = torch.clamp(scfg.max_features - tracked_n,
                         0, scfg.max_features)

    is_new = in_active & ~matched_in & (in_ids > st.last_id)
    # latest IMU sample of the incoming batch
    n = torch.sum(imu_dts > 0)
    last = torch.clamp(n - 1, 0, imu_dts.shape[0] - 1)
    acc_l = imu_acc[last]
    gyr_l = imu_gyr[last]

    a = _anchor(st)
    lm_mask = (occupied & (st.solved > 0)).to(dtype)
    lm_uv = _anchor_obs(st, a)[:, :2]
    lm_depth = 1.0 / torch.clamp(st.inv_depth, min=1e-3)
    used_pts = in_pts[slot_in]                                # [F,3]
    used_depths = torch.where(st.solved > 0, lm_depth,
                              torch.full_like(lm_depth, 5.0))
    used_valid = slot_matched.to(dtype)
    args = (st.p[k], st.q[k], st.v[k], acc_l, gyr_l,
            st.ba[k], st.bg[k], st.tic, st.qic,
            in_pts, in_prob, is_new.to(dtype),
            used_pts, used_depths, used_valid,
            lm_uv, lm_depth, lm_mask)
    return matched_in, budget, args


def _select_stage(pr: DeviceVioParams, st: DeviceVioState, k: int,
                  in_ids, in_pts, in_vel, in_prob, in_active,
                  imu_dts, imu_acc, imu_gyr):
    """On-device anticipation gate: features already in the DB pass through
    (tracked subset); candidates are active features with id above the
    watermark; selection runs the horizon/Ω/Δ/greedy pipeline with the
    dynamic κ̄−tracked budget. Returns (gated in_active, new watermark)."""
    scfg = pr.sel_cfg
    matched_in, budget, args = _selector_args(
        pr, st, k, in_ids, in_pts, in_prob, in_active, imu_dts, imu_acc,
        imu_gyr)
    sel, _ = _device_select(
        scfg, scfg.max_features, pr.sel_n_imu, pr.sel_dt_imu, *args,
        budget=budget, impl=pr.sel_impl, group=pr.sel_group,
        device=st.pts.device)
    gated = in_active & (matched_in | (sel > 0.5))
    new_last = torch.maximum(
        st.last_id,
        torch.max(torch.where(in_active, in_ids, torch.full_like(in_ids, -1))))
    return gated, new_last


def gate_objective(pr: DeviceVioParams, st: DeviceVioState,
                   in_ids, in_pts, in_vel, in_prob, in_active,
                   imu_dts, imu_acc, imu_gyr, acc0, gyr0, picks):
    """The objective of the frame's gate at each pick set: logdet(Ω +
    Σ_{ℓ∈S} p_ℓ Δ_ℓ) for S = picks[i] ([S,N] bool), over the candidates the
    greedy may pick, with the frame's Ω, Δ_ℓ and p_ℓ worked out from the
    state `st` the step is given. Returns ([S] objectives, logdet Ω)."""
    with torch.no_grad():
        st = _enter_frame(pr, st, pr.wcfg.nf - 1, imu_dts, imu_acc, imu_gyr,
                          acc0, gyr0)
        _, _, args = _selector_args(
            pr, st, pr.wcfg.nf - 1, in_ids, in_pts, in_prob, in_active,
            imu_dts, imu_acc, imu_gyr)
        Om, Dl, probs, valid = selection_problem(
            pr.sel_cfg, pr.sel_n_imu, pr.sel_dt_imu, *args)
        w = picks.to(Om.dtype) * probs * valid
        M = Om + torch.einsum("sn,nde->sde", w, Dl)
        return torch.linalg.slogdet(M)[1], torch.linalg.slogdet(Om)[1]


def _given_picks(st: DeviceVioState, in_ids, in_active, picks):
    """The gate with its selection given: features already in the DB pass
    through, and of the others those in `picks` [N] bool. Returns (gated
    in_active, new watermark), as `_select_stage` does."""
    occupied, eq = _match_ids(st, in_ids, in_active)
    matched_in = torch.any(eq, dim=0)
    gated = in_active & (matched_in | picks)
    new_last = torch.maximum(
        st.last_id,
        torch.max(torch.where(in_active, in_ids, torch.full_like(in_ids, -1))))
    return gated, new_last


def candidates(st: DeviceVioState, in_ids, in_active):
    """[N] bool: the frame's selection candidates, active features not in the
    DB with ids above the watermark (as `_select_stage` forms them)."""
    occupied, eq = _match_ids(st, in_ids, in_active)
    return in_active & ~torch.any(eq, dim=0) & (in_ids > st.last_id)


def _device_reboot(pr: DeviceVioParams, st: DeviceVioState,
                   acc0) -> DeviceVioState:
    """Device-side failure reboot as pure state surgery, so that the loop
    survives corruption without a host babysitter:

    - window poses → gravity-aligned identity (from the latest raw
      accelerometer sample), v = 0, biases = 0
    - landmark DB cleared, marginalization prior cleared
    - raw IMU pair buffers KEPT (they are measurements, not state)

    Afterwards (`since_fail`) the marginalization prior is held at weight 0
    and weak velocity-damping rows are added for 2·NF frames (see
    _measurements). The damped window stays finite and IMU-odometric; metric
    re-initialization (gravity + scale + velocity) is the initialization
    chain's job and is triggered host-side off the fail flag. As in the JAX
    package, `last_id` is not reset."""
    cfg = pr.wcfg
    dtype, dev = st.p.dtype, st.p.device
    R0 = lie.gravity_to_rot(acc0.to(dtype))
    q0 = lie.rot_to_quat(R0.T)
    return st._replace(
        p=torch.zeros_like(st.p),
        q=q0.expand(cfg.nf, 4).to(dtype).contiguous(),
        v=torch.zeros_like(st.v),
        ba=torch.zeros_like(st.ba),
        bg=torch.zeros_like(st.bg),
        ids=torch.full_like(st.ids, -1),
        pts=torch.zeros_like(st.pts),
        vel=torch.zeros_like(st.vel),
        mask=torch.zeros_like(st.mask),
        inv_depth=torch.ones_like(st.inv_depth),
        solved=torch.zeros_like(st.solved),
        prior=PriorFactor.empty(cfg, dtype, dev),
        speed_hist=torch.zeros_like(st.speed_hist),
        stationary=torch.zeros_like(st.stationary),
        since_fail=torch.zeros_like(st.since_fail))


def _set_row(x: Tensor, k: int, value) -> Tensor:
    """`x.at[k].set(value)`: a clone of x with row k replaced."""
    x = x.clone()
    x[k] = value
    return x


def _enter_frame(pr: DeviceVioParams, st: DeviceVioState, k: int,
                 imu_dts, imu_acc, imu_gyr, acc0, gyr0) -> DeviceVioState:
    """IMU propagation into frame slot k: the raw batch is stored as pair
    k−1, the ZUPT flag set, the state propagated and the biases copied."""
    p_k, q_k, v_k = _propagate(
        st.p[k - 1], st.q[k - 1], st.v[k - 1], st.ba[k - 1], st.bg[k - 1],
        imu_dts, imu_acc, imu_gyr, acc0, gyr0)
    return st._replace(
        p=_set_row(st.p, k, p_k), q=_set_row(st.q, k, q_k),
        v=_set_row(st.v, k, v_k),
        ba=_set_row(st.ba, k, st.ba[k - 1]),
        bg=_set_row(st.bg, k, st.bg[k - 1]),
        imu_dts=_set_row(st.imu_dts, k - 1, imu_dts),
        imu_acc=_set_row(st.imu_acc, k - 1, imu_acc),
        imu_gyr=_set_row(st.imu_gyr, k - 1, imu_gyr),
        imu_a0=_set_row(st.imu_a0, k - 1, acc0),
        imu_g0=_set_row(st.imu_g0, k - 1, gyr0),
        stationary=_set_row(
            st.stationary, k,
            _zupt_flag(pr, imu_dts, imu_acc, imu_gyr, st.bg[k - 1])
            if pr.zupt else 0.0),
        # 0, not st.td: no stream re-stamping here → absolute td correction
        td_at_frame=_set_row(st.td_at_frame, k, 0.0))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _margin_old(pr: DeviceVioParams, st: DeviceVioState) -> DeviceVioState:
    """Keyframe: marginalize the oldest frame, slide DB and state left."""
    cfg = pr.wcfg
    meas_m = _measurements(st, pr, _feat_valid(st))
    prior = mg.marginalize_oldest(_window_state(st, cfg), meas_m, cfg)
    st = _slide_oldest_db(st, cfg)
    shifted = {name: _shift_left(getattr(st, name), 0) for name in (
        "p", "q", "v", "ba", "bg", "stationary", "td_at_frame",
        "imu_dts", "imu_acc", "imu_gyr", "imu_a0", "imu_g0")}
    return st._replace(prior=prior, **shifted)


def _margin_second(pr: DeviceVioParams, st: DeviceVioState) -> DeviceVioState:
    """Non-keyframe: drop the second-newest frame from the prior, merge its
    IMU interval into the newest pair."""
    cfg = pr.wcfg
    W, fidx = cfg.window, cfg.nf - 2
    prior = mg.marginalize_second_newest(_window_state(st, cfg), st.prior, cfg)
    st = _slide_second_newest_db(st, cfg)
    merged = _merge_pair_buffers(
        st.imu_dts[W - 2], st.imu_acc[W - 2], st.imu_gyr[W - 2],
        st.imu_dts[W - 1], st.imu_acc[W - 1], st.imu_gyr[W - 1])
    imu = {}
    for name, m in zip(("imu_dts", "imu_acc", "imu_gyr"), merged):
        x = _set_row(getattr(st, name), W - 2, m)
        x[W - 1] = 0.0
        imu[name] = x
    shifted = {name: _shift_left(getattr(st, name), fidx) for name in (
        "p", "q", "v", "ba", "bg", "stationary", "td_at_frame")}
    return st._replace(prior=prior, **imu, **shifted)


def vio_step(pr: DeviceVioParams, st: DeviceVioState,
             in_ids, in_pts, in_vel, in_prob, in_active,
             imu_dts, imu_acc, imu_gyr, acc0, gyr0, device="cuda",
             picks=None):
    """One steady-state VIO frame (window full, initialized) of one scenario.

    Inputs are the tracker's fixed-size measurement arrays ([N] ids / prob /
    active, [N,3] rays, [N,2] velocities) plus the dt-padded raw IMU batch
    since the previous frame (`pack_frame`). Returns (state', out) with out =
    dict of the newest solved pose/velocity, solver diagnostics, keyframe
    flag, and the failure flag. The state it is given is left unchanged.

    On failure (pr.reboot_on_fail, default) the step performs the reboot on
    the device (_device_reboot) and the output trajectory restarts
    gravity-aligned at the origin; the flag marks the discontinuity.

    `device` is where the step runs: state and inputs are moved there, and a
    CUDA device that is not present raises. The keyframe flag is read on the
    host once per frame.
    """
    device = torch.device(device)
    st = tree_to(st, device)
    (in_ids, in_pts, in_vel, in_prob, in_active,
     imu_dts, imu_acc, imu_gyr, acc0, gyr0) = tree_to(
        (in_ids, in_pts, in_vel, in_prob, in_active,
         imu_dts, imu_acc, imu_gyr, acc0, gyr0), device)
    with torch.no_grad():
        return _vio_step(pr, st, in_ids, in_pts, in_vel, in_prob, in_active,
                         imu_dts, imu_acc, imu_gyr, acc0, gyr0, picks=picks)


def _vio_step(pr, st, in_ids, in_pts, in_vel, in_prob, in_active,
              imu_dts, imu_acc, imu_gyr, acc0, gyr0, picks=None):
    cfg = pr.wcfg
    nf = cfg.nf
    dtype, dev = st.p.dtype, st.p.device
    k = nf - 1

    # -- IMU propagation into the new frame slot
    st = _enter_frame(pr, st, k, imu_dts, imu_acc, imu_gyr, acc0, gyr0)

    # -- anticipation/attention gate (optional, pr.sel_cfg), or the
    # selection given from outside (`picks`)
    if picks is not None:
        in_active, new_last = _given_picks(st, in_ids, in_active, picks)
        st = st._replace(last_id=new_last)
    elif pr.sel_cfg is not None:
        in_active, new_last = _select_stage(
            pr, st, k, in_ids, in_pts, in_vel, in_prob, in_active,
            imu_dts, imu_acc, imu_gyr)
        st = st._replace(last_id=new_last)

    # -- feature DB insert + keyframe decision
    st, keyframe, tracked = _db_add_frame(
        st, k, in_ids, in_pts, in_vel, in_prob, in_active, pr.min_parallax,
        slot_evict=pr.slot_evict)

    # -- triangulate fresh landmarks
    fv = _feat_valid(st)
    inv_d, good = triangulate(_window_state(st, cfg), st.pts, st.mask,
                              _anchor(st), cfg)
    fresh = (st.solved < 0.5) & (fv > 0)
    st = st._replace(
        inv_depth=torch.where(fresh, inv_d, st.inv_depth),
        solved=torch.where(fresh, good, st.solved))

    # -- window solve (only solved landmarks participate), a batch of one
    wstate = _window_state(st, cfg)
    meas = _measurements(st, pr, fv * st.solved)
    new_state, sdiag = lm_solve(tree_map(lambda x: x[None], wstate),
                                tree_map(lambda x: x[None], meas), cfg,
                                device=dev)
    new_state = tree_map(lambda x: x[0], new_state)
    sdiag = {name: x[0] for name, x in sdiag.items()}

    # -- failure statistics
    speed = torch.linalg.norm(new_state.v[k])
    speed_hist = torch.cat([st.speed_hist[1:], speed[None]])
    dp = new_state.p[k] - st.p[k]
    # median of 8 = mean of the two middle values (torch.median would return
    # the lower one)
    median_speed = torch.sort(speed_hist).values[3:5].mean()
    fail = (torch.linalg.norm(new_state.ba[k]) > 2.5) \
        | (torch.linalg.norm(new_state.bg[k]) > 1.0) \
        | (torch.linalg.norm(dp) > 5.0) | (torch.abs(dp[2]) > 1.0) \
        | ~torch.all(torch.isfinite(new_state.p)) \
        | (median_speed > pr.max_speed_fail)

    # -- adopt + demote outliers, marginalize + slide (healthy)
    st_h = st._replace(p=new_state.p, q=new_state.q, v=new_state.v,
                       ba=new_state.ba, bg=new_state.bg,
                       td=new_state.td,
                       tic=new_state.tic, qic=new_state.qic,
                       inv_depth=new_state.inv_depth,
                       speed_hist=speed_hist,
                       n_solves=st.n_solves + 1)
    st_h = _demote_outliers(st_h, pr)
    # the one host read of the frame: only the marginalization taken runs
    if bool(keyframe):
        st_h = _margin_old(pr, st_h)
    else:
        st_h = _margin_second(pr, st_h)

    if pr.reboot_on_fail:
        # post-reboot prior holdoff (see DeviceVioState.since_fail): keep the
        # freshly-built prior at weight 0 until vision has refilled a full
        # window. None of this runs with reboot_on_fail=False.
        since = torch.clamp(st_h.since_fail + 1, max=10_000)
        ok = (since >= 2 * nf).to(dtype)
        st_h = st_h._replace(
            since_fail=since,
            prior=st_h.prior._replace(weight=st_h.prior.weight * ok))
        # -- OR device reboot (fail): blended in, the reboot branch is a
        # handful of zeros and one gravity alignment
        st_r = _device_reboot(pr, st, acc0)
        st_r = st_r._replace(n_solves=st_r.n_solves + 1)
        st = tree_map(lambda r, h: torch.where(fail, r, h), st_r, st_h)
    else:
        st = st_h

    out = {
        "t_slot": nf - 2,
        "p": st.p[nf - 2], "q": st.q[nf - 2], "v": st.v[nf - 2],
        "cost": sdiag["cost"], "cost0": sdiag["cost0"],
        "imu_chi2": sdiag["imu_chi2"],
        "keyframe": keyframe, "fail": fail, "speed": speed,
        "tracked": tracked,
        "n_live": torch.sum(st.ids >= 0),
        "n_solved": torch.sum(st.solved > 0),
    }
    return st, out


def pack_frame(fm, n_slots: int, dtype=torch.float64, device="cuda"):
    """Host helper: a `FrameMeasurement` (dict-form features) → the fixed
    arrays `vio_step` consumes, on `device`."""
    ids = np.full(n_slots, -1, np.int32)
    pts = np.zeros((n_slots, 3))
    vel = np.zeros((n_slots, 2))
    prob = np.ones(n_slots)
    act = np.zeros(n_slots, bool)
    # insertion order preserved: free slots are allocated in the order of
    # the features, and slot-assignment parity requires the same order here
    for j, (fid, (pt, vl, pb)) in enumerate(fm.feats.items()):
        if j >= n_slots:
            break
        ids[j] = fid
        pts[j] = pt
        vel[j] = vl
        prob[j] = pb
        act[j] = True
    S = MAX_IMU_PER_PAIR
    dts = np.zeros(S)
    acc = np.zeros((S, 3))
    gyr = np.zeros((S, 3))
    n = min(len(fm.imu_dts), S)
    dts[:n] = fm.imu_dts[:n]
    acc[:n] = fm.imu_acc[:n]
    gyr[:n] = fm.imu_gyr[:n]
    device = torch.device(device)
    f = lambda x: torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)
    return (torch.tensor(ids, device=device), f(pts), f(vel), f(prob),
            torch.tensor(act, device=device),
            f(dts), f(acc), f(gyr), f(fm.acc0), f(fm.gyr0))


def vio_init_oracle(pr: DeviceVioParams, init_state: dict, packed_frames,
                    device="cuda") -> DeviceVioState:
    """The state before the first full-window frame, from a known initial
    state: what the JAX package's host estimator does with an oracle
    `init_state` before its window is full
    (`anticipated_vins_mono_tpu/models/estimator.py:292-375`), on device
    arrays. Frame 0 takes p, q, v from `init_state` and inserts its
    features; frames 1 … NF−2 store the raw IMU pair, set the ZUPT flag,
    propagate, copy the biases and insert their features; extrinsics are
    identity, biases zero, and the prior is empty.

    `packed_frames` are the first NF−1 frames as `pack_frame` gives them
    (their dtype is the state's). The first `vio_step` on the result is the
    first full-window frame. The hand-off from an initialized host estimator
    is `vio_init_from_host`.
    """
    cfg = pr.wcfg
    nf, W, F, S = cfg.nf, cfg.window, cfg.max_feats, MAX_IMU_PER_PAIR
    if len(packed_frames) != nf - 1:
        raise ValueError(f"vio_init_oracle wants {nf - 1} frames, "
                         f"got {len(packed_frames)}")
    device = torch.device(device)
    packed_frames = tree_to(list(packed_frames), device)
    dtype = packed_frames[0][1].dtype
    kw = dict(dtype=dtype, device=device)
    zeros = lambda *s: torch.zeros(s, **kw)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    hint = lambda name: torch.tensor(
        np.asarray(init_state[name], np.float64), **kw)
    ident = WindowState.identity(cfg, dtype, device)
    st = DeviceVioState(
        p=_set_row(ident.p, 0, hint("p")), q=_set_row(ident.q, 0, hint("q")),
        v=_set_row(ident.v, 0, hint("v") if "v" in init_state else 0.0),
        ba=ident.ba, bg=ident.bg, tic=ident.tic, qic=ident.qic, td=ident.td,
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        pts=zeros(F, nf, 3), vel=zeros(F, nf, 2),
        prob=torch.ones(F, **kw), mask=zeros(F, nf),
        inv_depth=torch.ones(F, **kw), solved=zeros(F),
        imu_dts=zeros(W, S), imu_acc=zeros(W, S, 3), imu_gyr=zeros(W, S, 3),
        imu_a0=zeros(W, 3), imu_g0=zeros(W, 3),
        stationary=zeros(nf), td_at_frame=zeros(nf),
        prior=PriorFactor.empty(cfg, dtype, device),
        speed_hist=zeros(8), n_solves=i32(0), last_id=i32(-1),
        since_fail=i32(10_000))
    with torch.no_grad():
        for k, (in_ids, in_pts, in_vel, in_prob, in_active,
                imu_dts, imu_acc, imu_gyr, acc0, gyr0) in enumerate(
                    packed_frames):
            if k > 0:
                st = _enter_frame(pr, st, k, imu_dts, imu_acc, imu_gyr,
                                  acc0, gyr0)
            st, _, _ = _db_add_frame(
                st, k, in_ids, in_pts, in_vel, in_prob, in_active,
                pr.min_parallax, slot_evict=pr.slot_evict)
            seen = torch.max(torch.where(in_active, in_ids,
                                         torch.full_like(in_ids, -1)))
            st = st._replace(last_id=torch.maximum(st.last_id, seen))
    return st
