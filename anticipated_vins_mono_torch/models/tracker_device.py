"""Device-resident tracker: the whole per-frame front end on device arrays —
CLAHE → pyramid → pyramidal LK → essential-matrix RANSAC → min-distance
top-up detection → measurement packaging.

Counterpart of `anticipated_vins_mono_tpu/models/tracker_device.py`.
Capability parity with the reference tracker's readImage loop
(feature_tracker.cpp:27-138): CLAHE (:36-40), calcOpticalFlowPyrLK
(:54-86), rejectWithF (:263-296), enforceMinDist mask + top-up detection
(:161-259), and the [id,u,v,vx,vy,prob] measurement contract
(createMeasurements score/maxscore normalization, :300-343).

The tracker state (feature slots, ids, lifetimes, scores, the previous
pyramid) lives on the device as fixed-size tensors; feature identity is slot
bookkeeping with `cumsum`-ranked refills, RANSAC a batch of K hypotheses
(Gumbel top-8 sampling, batched 9×9 `eigh` nullspace, rank-2 projection,
Sampson gating). No step of a frame reads the device from the host; the
host reads one measurement a frame.

Where the two differ:

- RANSAC randomness: the state carries a PRNG key, as in the JAX package,
  and `tracker_step` splits it and draws the uniforms from it with
  `utils/threefry.py`, JAX's threefry-2x32 in torch: tracker seed k draws
  the same values in both packages (float32 bit for bit). `tracker_step`
  and `track_sequence` also take the draws from the caller (`u=`); the key
  advances all the same.
- `_occupancy` keeps the JAX scatter's index rules: an inactive slot is
  scattered at (−1, −1), which JAX wraps to (H−1, W−1), so that pixel is
  marked occupied whenever a slot is inactive (a reference property,
  reproduced); an index out of range after wrapping is dropped.
- The state's time is float32, as in the JAX package, so `dt` is formed in
  float32.
- `TrackerDeviceParams.follow_flow` (off by default, as the JAX package
  has it) makes LK cut its search patches around the flow the coarser
  levels found (`frontend.lk_track`), so that tracks follow shifts past
  8 px a frame; the JAX package has no such form.
- `TrackerDeviceParams.ransac_f64` (off by default, as the JAX package
  has it) fits and gates the RANSAC's hypotheses in float64, as OpenCV's
  `findFundamentalMat` computes in double. The 8-point systems are close
  to singular at a frame's motion (second-smallest eigenvalue down to
  ~1e-10 of the largest), so at 752×480 a float32 fit picks another
  hypothesis than float64 does in about half the frames and can keep a
  point 10-18 px off the float64 fit's epipolar lines.
- An 8-bit frame (uint8) goes to the device as uint8 and is scaled there
  (`frontend.as_image`).
- The step's stages are program spans (`utils/timing.span`): `track.step`
  > `track.upload`, `track.prep`, `track.lk`, `track.ransac`,
  `track.detect`, `track.refill`, recorded only while a profiler records.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from anticipated_vins_mono_torch.models import frontend as fe
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.utils import threefry
from anticipated_vins_mono_torch.utils.timing import span, spanned


def ransac_uniforms(key: Tensor, iters: int, n: int,
                    dtype=torch.float32) -> Tensor:
    """The draws `ransac_essential_mask` takes, from the key the step
    uses: the JAX package's `jax.random.uniform(key, (iters, n), dtype,
    1e-7, 1 − 1e-7)`."""
    return threefry.uniform(key, (iters, n), dtype, 1e-7, 1.0 - 1e-7)


def ransac_essential_mask(x1: Tensor, x2: Tensor, ok: Tensor, u: Tensor,
                          thresh=3e-3, min_inliers: int = 12) -> Tensor:
    """Batched essential-matrix RANSAC inlier mask on normalized coords.

    Parity with rejectWithF (feature_tracker.cpp:263-296, via
    cv::findFundamentalMat RANSAC): returns the inlier subset of `ok`; if
    too few correspondences or no hypothesis reaches `min_inliers`, the
    input mask passes through unchanged. `u` [iters, N]: uniform draws in
    (0, 1) that pick each hypothesis's 8 points (Gumbel top-8 over the
    masked logits); its first dimension is the number of hypotheses.
    """
    N = x1.shape[0]
    iters = u.shape[0]
    dtype = x1.dtype
    logits = torch.where(ok, torch.zeros((), dtype=dtype, device=x1.device),
                         torch.full((), float("-inf"), dtype=dtype,
                                    device=x1.device))
    gumbel = -torch.log(-torch.log(u.to(dtype)))
    _, idx = torch.topk(logits[None, :] + gumbel, 8, dim=-1)   # [K,8]
    p1, p2 = x1[idx], x2[idx]                                  # [K,8,2]
    o = torch.ones_like(p1[..., 0])
    A = torch.stack([p2[..., 0] * p1[..., 0], p2[..., 0] * p1[..., 1],
                     p2[..., 0],
                     p2[..., 1] * p1[..., 0], p2[..., 1] * p1[..., 1],
                     p2[..., 1],
                     p1[..., 0], p1[..., 1], o], dim=-1)       # [K,8,9]
    AtA = torch.einsum("kni,knj->kij", A, A)
    _, V = lie.eigh_or_nan(AtA)                                # ascending
    E = V[..., 0].reshape(iters, 3, 3)
    # rank-2 projection (findFundamentalMat zeroes the smallest s.v.)
    U, S, Vt = torch.linalg.svd(E)
    S2 = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    E = torch.einsum("kij,kj,kjl->kil", U, S2, Vt)
    one = torch.ones((N, 1), dtype=dtype, device=x1.device)
    x1h = torch.cat([x1, one], -1)
    x2h = torch.cat([x2, one], -1)
    Ex1 = torch.einsum("kij,nj->kni", E, x1h)
    Etx2 = torch.einsum("kji,nj->kni", E, x2h)
    num = torch.abs(torch.einsum("ni,kni->kn", x2h, Ex1))
    den = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                     + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2 + 1e-18)
    inl = (num / den < thresh) & ok[None, :]
    cnt = torch.sum(inl, dim=-1)
    best = torch.argmax(cnt)
    use = (torch.sum(ok) >= 15) & (cnt[best] >= min_inliers)
    return torch.where(use, inl[best], ok)


class TrackerState(NamedTuple):
    """Fixed-size device-resident tracker state (N = max_features slots)."""
    pyr: tuple            # previous frame's pyramid (tuple of [H,W] levels)
    pts: Tensor           # [N,2] pixel positions
    active: Tensor        # [N] bool
    ids: Tensor           # [N] i32 (monotone like the reference's n_id++)
    life: Tensor          # [N] i32 track length
    score: Tensor         # [N] f32 GFTT score at detection
    norm: Tensor          # [N,2] normalized-plane position
    t: Tensor             # 0-d f32 time of this state's frame
    next_id: Tensor       # 0-d i32
    key: Tensor           # [2] PRNG key for RANSAC sampling (uint32 words)


class TrackerDeviceParams(NamedTuple):
    max_features: int = 150
    min_dist: int = 16
    ransac_thresh_px: float = 1.0   # F_THRESHOLD px
    levels: int = 3
    ransac_iters: int = 64
    follow_flow: bool = False      # LK cuts its patches around the flow
    ransac_f64: bool = False       # the RANSAC's hypotheses in float64


def _prep(img: Tensor, levels: int):
    eq = fe.clahe(img)
    return eq, tuple(fe.build_pyramid(eq, levels))


def _occupancy(shape, pts: Tensor, active: Tensor, min_dist: int) -> Tensor:
    """Occupancy mask: dilated scatter of active points (enforceMinDist's
    mask image, feature_tracker.cpp:191-259). Inactive slots scatter at
    (−1, −1), which wraps to (H−1, W−1) as in the JAX package; an index
    still out of range after wrapping is dropped."""
    H, W = shape
    neg = torch.full_like(active, -1, dtype=torch.long)
    ix = torch.where(active, torch.round(pts[:, 0]).long(), neg)
    iy = torch.where(active, torch.round(pts[:, 1]).long(), neg)
    ix = torch.where(ix < 0, ix + W, ix)
    iy = torch.where(iy < 0, iy + H, iy)
    keep = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.where(keep, iy * W + ix, torch.zeros_like(ix))
    occ = torch.zeros(H * W, dtype=pts.dtype, device=pts.device)
    occ.index_add_(0, flat, keep.to(pts.dtype))
    occ = torch.clamp(occ, max=1.0).reshape(H, W)
    return fe._window_max_same(occ, min_dist, 0.0)


def tracker_init(cam, params: TrackerDeviceParams, img, t,
                 seed: int = 0) -> TrackerState:
    """First frame: detect into every slot. The image goes to the camera's
    device as float32; `seed` makes the RANSAC key (`jax.random.PRNGKey`)."""
    N = params.max_features
    eq, pyr = _prep(fe.as_image(img, cam.fx.device), params.levels)
    occ = torch.zeros_like(eq)
    uv, sc, val = fe.detect_features(eq, occ, N, params.min_dist)
    norm = cameras.lift_projective(cam, uv)[:, :2]
    return TrackerState(
        pyr=pyr, pts=uv, active=val,
        ids=torch.arange(N, dtype=torch.int32, device=eq.device),
        life=val.to(torch.int32), score=sc, norm=norm,
        t=torch.tensor(t, dtype=torch.float32, device=eq.device),
        next_id=torch.sum(val).to(torch.int32),
        key=threefry.prng_key(seed, eq.device))


@spanned("track.step")
def tracker_step(cam, params: TrackerDeviceParams, state: TrackerState,
                 img, t, u: Optional[Tensor] = None):
    """One frame through the full front end; returns (state', measurement).

    measurement = (ids [N], rays [N,3], vel [N,2], prob [N], active [N]) —
    the PointCloud channel contract [id,u,v,vx,vy,prob]
    (feature_tracker_ros.cpp:75-115) as fixed-size tensors. `u`: the
    RANSAC's uniform draws [ransac_iters, N]. The state's key is split as
    in the JAX package: the second key draws `u` when it is not given, the
    first is carried.
    """
    p = params
    N = p.max_features
    dev = state.pts.device
    with span("track.upload"):
        t = torch.tensor(t, dtype=torch.float32, device=dev)
        img = fe.as_image(img, dev)
    with span("track.prep"):
        eq, pyr = _prep(img, p.levels)

    # -- track forward
    with span("track.lk"):
        new_pts, lk_ok = fe.lk_track(state.pyr, pyr, state.pts,
                                     state.active.to(state.pts.dtype),
                                     levels=p.levels,
                                     follow_flow=p.follow_flow)
        ok = lk_ok & state.active

    # -- outlier rejection on the normalized plane (rejectWithF)
    with span("track.ransac"):
        n_new = cameras.lift_projective(cam, new_pts)[:, :2]
        key, k1 = threefry.split(state.key)
        if u is None:
            u = ransac_uniforms(k1, p.ransac_iters, N, state.norm.dtype)
        x1, x2, fx = state.norm, n_new, cam.fx
        if p.ransac_f64:
            x1, x2, fx = x1.double(), x2.double(), fx.double()
        ok = ransac_essential_mask(x1, x2, ok, u,
                                   thresh=p.ransac_thresh_px / fx)
    return _top_up(cam, p, state._replace(key=key), eq, pyr, new_pts, ok, t)


def _top_up(cam, p: TrackerDeviceParams, state: TrackerState, eq: Tensor,
            pyr: tuple, new_pts: Tensor, ok: Tensor, t: Tensor):
    """The rest of `tracker_step` after the outlier rejection: top-up
    detection into the free slots, slot bookkeeping and the measurement."""
    return _refill(cam, p, state, pyr, new_pts, ok, t,
                   _detect_free(p, eq, new_pts, ok))


@spanned("track.detect")
def _detect_free(p: TrackerDeviceParams, eq: Tensor, new_pts: Tensor,
                 ok: Tensor):
    """Top-up detection in the regions the kept tracks leave unoccupied:
    (uv, score, valid) of up to `max_features` new corners."""
    occ = _occupancy(eq.shape, new_pts, ok, p.min_dist)
    return fe.detect_features(eq, occ, p.max_features, p.min_dist)


@spanned("track.refill")
def _refill(cam, p: TrackerDeviceParams, state: TrackerState, pyr: tuple,
            new_pts: Tensor, ok: Tensor, t: Tensor, detected):
    """Slot bookkeeping (the free slots take the `detected` corners in rank
    order) and the measurement."""
    N = p.max_features
    uv, sc, val = detected
    n_val = torch.sum(val)
    free = ~ok
    rank = torch.cumsum(free.long(), 0) - 1           # rank among free slots
    fill = free & (rank < n_val)
    cand = torch.clamp(rank, 0, N - 1)
    pts_out = torch.where(fill[:, None], uv[cand],
                          torch.where(ok[:, None], new_pts, state.pts))
    active = ok | fill
    ids = torch.where(fill, state.next_id + rank.to(torch.int32), state.ids)
    life = torch.where(fill, torch.ones_like(state.life),
                       torch.where(ok, state.life + 1,
                                   torch.zeros_like(state.life)))
    score = torch.where(fill, sc[cand], state.score)
    next_id = state.next_id + torch.sum(fill).to(torch.int32)

    # -- measurement packaging
    rays = cameras.lift_projective(cam, pts_out)
    norm = rays[:, :2]
    dt = t - state.t
    vel_ok = ok & (dt > 1e-9)
    vel = torch.where(vel_ok[:, None],
                      (norm - state.norm) / torch.clamp(dt, min=1e-9),
                      torch.zeros_like(norm))
    smax = torch.clamp(torch.max(torch.where(active, score,
                                             torch.zeros_like(score))),
                       min=1e-9)
    prob = torch.where(active, score / smax, torch.zeros_like(score))

    new_state = TrackerState(pyr=pyr, pts=pts_out, active=active, ids=ids,
                             life=life, score=score, norm=norm, t=t,
                             next_id=next_id, key=state.key)
    return new_state, (ids, rays, vel, prob, active)


def track_sequence(cam, params: TrackerDeviceParams, state: TrackerState,
                   imgs, ts, u: Optional[Tensor] = None):
    """The tracker over a frame stack (`imgs` [T,H,W], `ts` [T]), frame after
    frame. `u` [T, ransac_iters, N]: each frame's RANSAC draws (else drawn
    from the state's key). Returns (final state, stacked measurements)."""
    meas = []
    for k in range(len(ts)):
        state, m = tracker_step(cam, params, state, imgs[k], float(ts[k]),
                                None if u is None else u[k])
        meas.append(m)
    return state, tuple(torch.stack(x) for x in zip(*meas))


class DeviceFeatureTracker:
    """Host facade producing the same {id: (ray, vel, prob)} dict as
    `frontend.FeatureTracker.process`, with all per-frame work on the
    camera's device and one read of the measurement a frame. The RANSAC
    draws come from the key `tracker_init` makes from `seed`, as in the JAX
    package; `process(img, t, u=...)` takes them from the caller instead."""

    def __init__(self, cam, params: TrackerDeviceParams = TrackerDeviceParams(),
                 seed: int = 0):
        self.cam = cam
        self.params = params
        self.seed = seed
        self.state = None

    def process(self, img, t: float, u: Optional[Tensor] = None) -> dict:
        if self.state is None:
            self.state = tracker_init(self.cam, self.params, img, t,
                                      self.seed)
            ids = self.state.ids.cpu().numpy()
            act = self.state.active.cpu().numpy()
            rays = np.concatenate([self.state.norm.cpu().numpy(),
                                   np.ones((len(ids), 1))], -1)
            prob = self.state.score.cpu().numpy()
            prob = prob / max(prob.max(), 1e-9)
            return {int(i): (rays[k], np.zeros(2), float(prob[k]))
                    for k, i in enumerate(ids) if act[k]}
        self.state, meas = tracker_step(self.cam, self.params, self.state,
                                        img, t, u)
        ids, rays, vel, prob, active = (m.cpu().numpy() for m in meas)
        return {int(i): (rays[k], vel[k], float(prob[k]))
                for k, i in enumerate(ids) if active[k]}
