"""The plain reference of the device tracker's step: a copy of the port's
`models/tracker_device.{ransac_uniforms, ransac_essential_mask, _prep,
_occupancy, tracker_init, tracker_step, _detect_free, _refill}` in the
form the `euroc_tracker` configuration runs: CLAHE, a 4-level pyramid, LK
that follows the flow, the essential-matrix RANSAC on the state key's
draws, top-up detection outside the kept tracks' min-distance regions, and
the slot refill with the [id, ray, velocity, probability] measurement. It
imports nothing of the port (`frontend`, `cameras`, `threefry` and `lie`
beside it are copies).

Run with float64 images and points it is the reference; with its images in
bfloat16 (`img_dtype`) and its points in float64, the control.

Where the copy departs from the port:

- LK always follows the flow (the port's `follow_flow=True`); the JAX
  form is not copied;
- `tracker_step` also returns its CLAHE'd image, and `detect` is the
  top-up detection on it around any given kept points, so that the
  program's refilled corners can be looked up among the corners the
  reference detects around the program's own kept tracks;
- the step takes the RANSAC draws from the caller or from the state's key
  (float32 uniforms, as the port draws them), and casts them to the
  points' dtype;
- the RANSAC fits and gates its hypotheses in the points' dtype: in
  float64 as the port's `ransac_f64=True` does (the configuration's
  `ransac_fit_dtype`), the control included;
- `DeviceFeatureTracker`, `track_sequence` and `_top_up` are not copied.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from benchmark.reference import cameras, threefry
from benchmark.reference import frontend as fe
from benchmark.reference.lie import eigh_or_nan


class TrackerState(NamedTuple):
    """The tracker's state over N slots (the port's fields)."""
    pyr: tuple            # previous frame's pyramid
    pts: Tensor           # [N,2] pixel positions
    active: Tensor        # [N] bool
    ids: Tensor           # [N] i32
    life: Tensor          # [N] i32 track length
    score: Tensor         # [N] GFTT score at detection
    norm: Tensor          # [N,2] normalized-plane position
    t: Tensor             # 0-d time of this state's frame
    next_id: Tensor       # 0-d i32
    key: Tensor           # [2] PRNG key (uint32 words in int64)


class TrackerParams(NamedTuple):
    max_features: int
    min_dist: int
    ransac_thresh_px: float
    levels: int
    ransac_iters: int
    lk_half: int
    lk_iters: int
    lk_pad: int


def ransac_uniforms(key: Tensor, iters: int, n: int) -> Tensor:
    """The float32 draws the port's step takes from `key`'s second half."""
    return threefry.uniform(threefry.split(key)[1], (iters, n),
                            1e-7, 1.0 - 1e-7)


def ransac_essential_mask(x1: Tensor, x2: Tensor, ok: Tensor, u: Tensor,
                          thresh, min_inliers: int = 12) -> Tensor:
    """Essential-matrix RANSAC on normalized coordinates: each of the
    hypotheses (rows of `u`) fits the 8-point solution to the 8 points its
    Gumbel-perturbed draws rank first among `ok`, projects it to rank 2 and
    gates every point on its Sampson distance; the best hypothesis's
    inliers are kept, or `ok` itself where fewer than 15 points or under
    `min_inliers` inliers."""
    N = x1.shape[0]
    iters = u.shape[0]
    dtype = x1.dtype
    logits = torch.where(ok, torch.zeros((), dtype=dtype, device=x1.device),
                         torch.full((), float("-inf"), dtype=dtype,
                                    device=x1.device))
    gumbel = -torch.log(-torch.log(u.to(dtype)))
    _, idx = torch.topk(logits[None, :] + gumbel, 8, dim=-1)
    p1, p2 = x1[idx], x2[idx]
    o = torch.ones_like(p1[..., 0])
    A = torch.stack([p2[..., 0] * p1[..., 0], p2[..., 0] * p1[..., 1],
                     p2[..., 0],
                     p2[..., 1] * p1[..., 0], p2[..., 1] * p1[..., 1],
                     p2[..., 1],
                     p1[..., 0], p1[..., 1], o], dim=-1)
    AtA = torch.einsum("kni,knj->kij", A, A)
    _, V = eigh_or_nan(AtA)
    E = V[..., 0].reshape(iters, 3, 3)
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


def prep(img: Tensor, levels: int):
    """(CLAHE'd image, its pyramid)."""
    eq = fe.clahe(img)
    return eq, tuple(fe.build_pyramid(eq, levels))


def _occupancy(shape, pts: Tensor, active: Tensor, min_dist: int) -> Tensor:
    """The kept tracks' min-distance regions: each active point's pixel,
    dilated by a min_dist window; an inactive slot marks (H−1, W−1)."""
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
    return fe.window_max_same(occ, min_dist, 0.0)


def tracker_init(cam, p: TrackerParams, img, t, seed: int,
                 dtype=torch.float64, img_dtype=torch.float64):
    """First frame: detect into every slot."""
    dev = cam.fx.device
    eq, pyr = prep(fe.as_image(img, dev, img_dtype), p.levels)
    N = p.max_features
    uv, sc, val = fe.detect_features(eq, torch.zeros_like(eq), N, p.min_dist)
    uv = uv.to(dtype)
    return TrackerState(
        pyr=pyr, pts=uv, active=val,
        ids=torch.arange(N, dtype=torch.int32, device=dev),
        life=val.to(torch.int32), score=sc.to(dtype),
        norm=cameras.lift_projective(cam, uv)[:, :2],
        t=torch.tensor(t, dtype=dtype, device=dev),
        next_id=torch.sum(val).to(torch.int32),
        key=threefry.prng_key(seed, dev))


def detect(p: TrackerParams, eq: Tensor, pts: Tensor, kept: Tensor):
    """Top-up detection on the CLAHE'd image `eq` outside the min-distance
    regions of the `kept` points: (uv, score, valid) of up to
    `max_features` corners."""
    occ = _occupancy(eq.shape, pts, kept, p.min_dist)
    return fe.detect_features(eq, occ, p.max_features, p.min_dist)


def tracker_step(cam, p: TrackerParams, state: TrackerState, img, t,
                 u: Optional[Tensor] = None, img_dtype=torch.float64):
    """One frame; returns (state', measurement (ids, rays, vel, prob,
    active), the CLAHE'd image)."""
    N = p.max_features
    dev, dtype = state.pts.device, state.pts.dtype
    t = torch.tensor(t, dtype=dtype, device=dev)
    eq, pyr = prep(fe.as_image(img, dev, img_dtype), p.levels)
    new_pts, lk_ok = fe.lk_track(state.pyr, pyr, state.pts,
                                 state.active.to(dtype), half=p.lk_half,
                                 iters=p.lk_iters, levels=p.levels,
                                 pad=p.lk_pad)
    ok = lk_ok & state.active
    n_new = cameras.lift_projective(cam, new_pts)[:, :2]
    key = threefry.split(state.key)[0]
    if u is None:
        u = ransac_uniforms(state.key, p.ransac_iters, N)
    ok = ransac_essential_mask(state.norm, n_new, ok, u,
                               thresh=p.ransac_thresh_px / cam.fx)
    new_state, meas = _refill(cam, p, state._replace(key=key), pyr, new_pts,
                              ok, t, detect(p, eq, new_pts, ok))
    return new_state, meas, eq


def _refill(cam, p: TrackerParams, state: TrackerState, pyr, new_pts, ok, t,
            detected):
    """The free slots take the detected corners in rank order; then the
    measurement: rays of every slot, velocities of the kept tracks over the
    frame interval, probabilities as scores over the largest active one."""
    N = p.max_features
    uv, sc, val = detected
    uv, sc = uv.to(new_pts.dtype), sc.to(state.score.dtype)
    n_val = torch.sum(val)
    free = ~ok
    rank = torch.cumsum(free.long(), 0) - 1
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
