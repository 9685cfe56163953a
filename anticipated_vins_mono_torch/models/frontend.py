"""Front end: feature tracking on images.

Counterpart of `anticipated_vins_mono_tpu/models/frontend.py`, function for
function. Capability parity with the reference tracker
(feature_tracker/src/feature_tracker.cpp + cvmodified.cpp):

- contrast-limited adaptive histogram equalization   (feature_tracker.cpp:36-40)
- pyramidal Lucas-Kanade optical flow                (:54-86, cv::calcOpticalFlowPyrLK)
- essential-matrix RANSAC outlier rejection          (rejectWithF, :263-296)
- min-distance mask favoring long-lived features     (enforceMinDist, :191-259)
- Shi-Tomasi (GFTT) corner detection that RETURNS THE QUALITY SCORE — the
  score becomes the tracking probability p_ℓ         (cvmodified.cpp:43+,
  createMeasurements score/maxscore normalization, :300-343)
- measurement packaging {id: (normalized pt, velocity, prob)}

Only the gather forms are ported: `clahe` is the JAX `impl="gather"` form
(per-tile `bincount` histograms, four per-pixel LUT gathers) and `lk_track`
the `impl="gather"` form (patch gathers, a per-feature window slice, the
per-point bilinear residual). The JAX package's one-hot and matmul forms
exist because per-element gathers serialize on the TPU; a gather is what
the card does well, so the `impl` switch is gone.

Where the two differ: `lax.reduce_window(..., "SAME")` pads an even window
asymmetrically ((k-1)//2 below, k//2 above), so the NMS pads explicitly and
then pools without padding; `lax.top_k` breaks ties toward the lower index
and `torch.topk` promises no order among equal values, so detection takes a
stable descending sort. Images are float32 whatever the caller passes; an
8-bit image (uint8, a camera's grey frame) goes to the device as uint8 and
is scaled to [0, 1] there. `lk_track(follow_flow=True)` cuts each level's
search patch around the flow the coarser levels found, as OpenCV does; the
JAX package has only the form that cuts it around the previous corner
(the default here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from anticipated_vins_mono_torch.ops import cameras


# ----------------------------------------------------------------------------
# Image ops
# ----------------------------------------------------------------------------


def as_image(img, device) -> Tensor:
    """An image (tensor or numpy array) as a float32 tensor on `device`; a
    numpy array is copied, never shared. An 8-bit image (uint8, 0-255) is
    copied to `device` as uint8, a quarter of the bytes of float32, and
    divided by 255 there: the same float32 values as `as_image(img / 255)`,
    since both round the exact quotient once."""
    if not torch.is_tensor(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            return torch.tensor(np.asarray(img, np.float32), device=device)
        img = torch.from_numpy(img)
    if img.dtype == torch.uint8:
        return img.to(device).to(torch.float32) / 255.0
    return img.to(device=device, dtype=torch.float32)


def _pad_edge(x: Tensor, axis: int, lo: int, hi: int) -> Tensor:
    """Edge-replicating pad of one axis of a 2-D image."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-lo, n + hi, device=x.device), 0, n - 1)
    return x.index_select(axis, idx)


def equalize(img: Tensor, bins: int = 64) -> Tensor:
    """Global histogram equalization (cheap fallback; the tracker default is
    `clahe` below, matching the reference). The histogram has
    `jnp.histogram`'s edge rule: a value on an inner edge goes to the bin
    above it, 1.0 to the last bin, values outside [0, 1] to none."""
    flat = img.reshape(-1)
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=img.dtype,
                           device=img.device)
    b = torch.searchsorted(edges, flat, right=True)
    b = torch.where(flat == edges[-1], torch.full_like(b, bins), b)
    hist = torch.zeros(bins + 2, dtype=img.dtype, device=img.device)
    hist.index_add_(0, b, torch.ones_like(flat))
    cdf = torch.cumsum(hist[1:bins + 1], 0) / flat.numel()
    idx = torch.clamp((img * bins).to(torch.int32), 0, bins - 1)
    return cdf[idx.long()]


def clahe(img: Tensor, clip_limit: float = 3.0, tiles: int = 8,
          bins: int = 256) -> Tensor:
    """Contrast-limited adaptive histogram equalization.

    Parity with the reference's cv::createCLAHE(3.0, cv::Size(8, 8))
    (feature_tracker.cpp:36-40): per-tile clipped histograms with excess
    redistribution, then bilinear interpolation of the 4 neighboring tile
    mappings per pixel (the JAX package's "gather" form).
    """
    H, W = img.shape
    ty, tx = -(-H // tiles), -(-W // tiles)          # ceil tile size
    imp = _pad_edge(_pad_edge(img, 0, 0, ty * tiles - H), 1, 0,
                    tx * tiles - W)
    idx = torch.clamp((imp * bins).to(torch.int32), 0, bins - 1).long()
    npix = ty * tx
    tile_of = idx.reshape(tiles, ty, tiles, tx).permute(0, 2, 1, 3)
    tile_of = tile_of.reshape(tiles * tiles, ty * tx)
    flat = (torch.arange(tiles * tiles, device=img.device)[:, None] * bins
            + tile_of).reshape(-1)
    hists = torch.bincount(flat, minlength=tiles * tiles * bins)
    hists = hists.reshape(tiles * tiles, bins).to(img.dtype)

    limit = max(clip_limit * npix / bins, 1.0)
    excess = torch.sum(torch.clamp(hists - limit, min=0.0), dim=1,
                       keepdim=True)
    hists = torch.clamp(hists, max=limit) + excess / bins
    luts = (torch.cumsum(hists, dim=1) / npix).reshape(tiles, tiles, bins)

    Hp, Wp = imp.shape
    yy = torch.arange(Hp, dtype=img.dtype, device=img.device)
    xx = torch.arange(Wp, dtype=img.dtype, device=img.device)
    fy = torch.clamp((yy + 0.5) / ty - 0.5, 0.0, tiles - 1.0)
    fx = torch.clamp((xx + 0.5) / tx - 0.5, 0.0, tiles - 1.0)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, tiles - 2)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, tiles - 2)
    wy = (fy - y0)[:, None]
    wx = (fx - x0)[None, :]
    Y0 = y0.long()[:, None].expand(Hp, Wp)
    X0 = x0.long()[None, :].expand(Hp, Wp)
    v00 = luts[Y0, X0, idx]
    v01 = luts[Y0, X0 + 1, idx]
    v10 = luts[Y0 + 1, X0, idx]
    v11 = luts[Y0 + 1, X0 + 1, idx]
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return out[:H, :W]


def _blur3(img: Tensor) -> Tensor:
    """Separable [1 2 1]/4 blur (edge-replicated)."""
    k = (0.25, 0.5, 0.25)

    def conv1(x, axis):
        xp = _pad_edge(x, axis, 1, 1)
        n = x.shape[axis]
        out = 0.0
        for o, kv in enumerate(k):
            out = out + kv * xp.narrow(axis, o, n)
        return out

    return conv1(conv1(img, 0), 1)


def build_pyramid(img: Tensor, levels: int = 3) -> list:
    """Gaussian pyramid, factor-2 downsampling."""
    pyr = [img]
    for _ in range(levels - 1):
        img = _blur3(img)[::2, ::2].contiguous()
        pyr.append(img)
    return pyr


def _gradients(img: Tensor):
    """Central-difference gradients (edge-padded)."""
    xp = _pad_edge(img, 1, 1, 1)
    Ix = 0.5 * (xp[:, 2:] - xp[:, :-2])
    yp = _pad_edge(img, 0, 1, 1)
    Iy = 0.5 * (yp[2:, :] - yp[:-2, :])
    return Ix, Iy


def gftt_response(img: Tensor, window: int = 3) -> Tensor:
    """Shi-Tomasi min-eigenvalue corner response (cvmodified.cpp:43+, the
    per-pixel score the fork surfaces as the tracking probability)."""
    Ix, Iy = _gradients(img)
    a, b, c = Ix * Ix, Ix * Iy, Iy * Iy
    for _ in range(window // 2 + 1):
        a, b, c = _blur3(a), _blur3(b), _blur3(c)
    tr = 0.5 * (a + c)
    det = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    return torch.clamp(tr - det, min=0.0)


def _window_max_same(x: Tensor, k: int, fill: float) -> Tensor:
    """`lax.reduce_window(x, fill, max, (k, k), (1, 1), "SAME")`: the window
    covers (k-1)//2 rows/columns before a pixel and k//2 after it."""
    lo, hi = (k - 1) // 2, k // 2
    xp = F.pad(x[None, None], (lo, hi, lo, hi), value=fill)
    return F.max_pool2d(xp, k, stride=1)[0, 0]


def top_k_stable(x: Tensor, k: int):
    """The k largest entries of a 1-D tensor, largest first, ties toward the
    lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def detect_features(img: Tensor, occupied_mask: Tensor, max_n: int,
                    min_dist: int = 16, quality_level: float = 0.01):
    """Top-`max_n` corners with non-max suppression + occupancy mask.

    Returns (uv [max_n,2] float pixels, score [max_n], valid [max_n]).
    occupied_mask: 1 where features already exist (their min-dist region) —
    the reference's mask image (enforceMinDist :191-259, detectFeatures
    :161-176).
    """
    resp = gftt_response(img)
    resp = resp * (1.0 - occupied_mask)
    # NMS: keep pixels that are the max in their (min_dist x min_dist) window
    wmax = _window_max_same(resp, min_dist, float("-inf"))
    is_peak = (resp >= wmax) & (resp > quality_level * torch.max(resp))
    flat = torch.where(is_peak, resp, torch.zeros_like(resp)).reshape(-1)
    score, idx = top_k_stable(flat, max_n)
    W = img.shape[1]
    uv = torch.stack([(idx % W).to(img.dtype), (idx // W).to(img.dtype)],
                     dim=-1)
    return uv, score, score > 0.0


def _bilinear(img: Tensor, uv: Tensor) -> Tensor:
    """Bilinear sample img at float pixel coords uv [...,2] (x,y)."""
    H, W = img.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _extract_patches(img: Tensor, anchor: Tensor, S: int) -> Tensor:
    """Gather [N,S,S] patches with top-left integer corners `anchor` [N,2]
    (x,y), border-replicated: one gather for all points."""
    H, W = img.shape
    ar = torch.arange(S, device=img.device)
    ys = torch.clamp(anchor[:, 1, None, None] + ar[None, :, None], 0, H - 1)
    xs = torch.clamp(anchor[:, 0, None, None] + ar[None, None, :], 0, W - 1)
    return img[ys, xs]


def _shift_sample(P: Tensor, iy: Tensor, ix: Tensor, fy: Tensor,
                  fx: Tensor, win: int) -> Tensor:
    """Sample [N,win,win] windows from patches P [N,S,S] translated by an
    integer offset (iy, ix) [N] plus a fractional (fy, fx) [N]: a
    per-feature (win+1)² slice (the JAX `dynamic_slice`, in bounds because
    the caller clips iy, ix to [0, S-win-1]) + a separable 2-tap filter."""
    ar = torch.arange(win + 1, device=P.device)
    n = torch.arange(P.shape[0], device=P.device)[:, None, None]
    Pw = P[n, (iy[:, None] + ar)[:, :, None], (ix[:, None] + ar)[:, None, :]]
    fx_ = fx[:, None, None]
    fy_ = fy[:, None, None]
    Px = (1.0 - fx_) * Pw[:, :, :-1] + fx_ * Pw[:, :, 1:]
    return (1.0 - fy_) * Px[:, :-1, :] + fy_ * Px[:, 1:, :]  # [N,win,win]


def lk_track(prev_pyr, cur_pyr, pts: Tensor, valid: Tensor, half: int = 7,
             iters: int = 10, levels: int = 3, pad: int = 8,
             follow_flow: bool = False):
    """Pyramidal Lucas-Kanade: track `pts` [N,2] from prev to cur.

    Mirrors cv::calcOpticalFlowPyrLK usage (feature_tracker.cpp:54-60,
    winsize 15x15 ⇒ half=7). Returns (new_pts [N,2], ok [N]). Each level
    extracts one local patch per image per point; the template and its
    gradients come from static slices + a separable 2-tap fractional
    filter, and every Gauss-Newton iteration samples the moving window with
    a per-feature slice + the same filter. `pad` bounds the per-level
    search excursion (flow beyond it clamps and fails the residual check).

    With `follow_flow=False` (the JAX package's form) every level cuts the
    current image's patch around the previous corner, so the whole flow at
    the finest level must lie within `pad` pixels: a larger shift is not
    followed (ROADMAP queue C 15). With `follow_flow=True` each level cuts
    it around the corner plus the whole pixels of the flow carried down from
    the coarser level, as calcOpticalFlowPyrLK does, and `pad` bounds that
    level's correction only: a shift of up to about pad·(2^levels − 1)
    pixels is followed. The JAX package has no such form.
    """
    N = pts.shape[0]
    dtype = pts.dtype
    win = 2 * half + 1

    def track_level(flow, level):
        scale = 2.0 ** level
        prev_img = prev_pyr[level]
        cur_img = cur_pyr[level]
        p_lvl = pts / scale
        p0 = torch.floor(p_lvl)
        f = p_lvl - p0                                # [N,2] in [0,1)
        p0i = p0.long()

        # template + gradients from one prev-patch gather
        Sp = win + 4                                  # ±(half+1) + bilinear
        Pp = _extract_patches(prev_img, p0i - (half + 1), Sp)
        fx_ = f[:, 0, None, None]
        fy_ = f[:, 1, None, None]
        Px = (1.0 - fx_) * Pp[:, :, :-1] + fx_ * Pp[:, :, 1:]
        Pxy = (1.0 - fy_) * Px[:, :-1, :] + fy_ * Px[:, 1:, :]
        T = Pxy[:, 1:1 + win, 1:1 + win]
        gx = 0.5 * (Pxy[:, 1:1 + win, 2:2 + win]
                    - Pxy[:, 1:1 + win, 0:win])
        gy = 0.5 * (Pxy[:, 2:2 + win, 1:1 + win]
                    - Pxy[:, 0:win, 1:1 + win])
        # 2×2 normal matrix, closed-form inverse
        gxx = torch.sum(gx * gx, (-2, -1)) + 1e-6
        gyy = torch.sum(gy * gy, (-2, -1)) + 1e-6
        gxy = torch.sum(gx * gy, (-2, -1))
        det = gxx * gyy - gxy * gxy

        # cur-patch gather with excursion margin, around the previous
        # corner or, following the flow, around its whole pixels as well
        Sc = win + 2 * pad + 1
        if follow_flow:
            g = torch.floor(flow)
            p0i, f = p0i + g.long(), f - g
        Pc = _extract_patches(cur_img, p0i - (half + pad), Sc)

        fl = flow
        for _ in range(iters):
            t = f + fl                                # total frac+int shift
            ti = torch.floor(t)
            tf = t - ti
            iy = torch.clamp(ti[:, 1].long() + pad, 0, 2 * pad)
            ix = torch.clamp(ti[:, 0].long() + pad, 0, 2 * pad)
            err = _shift_sample(Pc, iy, ix, tf[:, 1], tf[:, 0], win) - T
            bx = torch.sum(gx * err, (-2, -1))
            by = torch.sum(gy * err, (-2, -1))
            dx = -(gyy * bx - gxy * by) / det
            dy = -(gxx * by - gxy * bx) / det
            fl = fl + torch.stack([dx, dy], -1)
        return fl

    flow = torch.zeros((N, 2), dtype=dtype, device=pts.device)
    for level in range(levels - 1, -1, -1):
        flow = track_level(flow, level)
        if level > 0:
            flow = flow * 2.0  # upsample flow to the next finer level
    new_pts = pts + flow

    # validity: in-border (like :68-73 BORDER_SIZE) + residual check
    H, W = cur_pyr[0].shape
    inb = (new_pts[:, 0] > 2) & (new_pts[:, 0] < W - 3) & \
        (new_pts[:, 1] > 2) & (new_pts[:, 1] < H - 3)
    ar = torch.arange(-half, half + 1, dtype=dtype, device=pts.device)
    gy_, gx_ = torch.meshgrid(ar, ar, indexing="ij")
    offs = torch.stack([gx_, gy_], dim=-1).reshape(-1, 2)     # [P,2] (x,y)
    patch_prev = _bilinear(prev_pyr[0], pts[:, None, :] + offs)
    patch_cur = _bilinear(cur_pyr[0], new_pts[:, None, :] + offs)
    resid = torch.mean(torch.abs(patch_cur - patch_prev), dim=-1)
    ok = inb & (resid < 0.25) & (valid > 0)
    return new_pts, ok


# ----------------------------------------------------------------------------
# Tracker orchestration (anticipation::FeatureTracker parity)
# ----------------------------------------------------------------------------


class TrackerParams(NamedTuple):
    max_features: int = 150       # Parameters struct (feature_tracker.h:31-41)
    min_dist: int = 16
    ransac_thresh: float = 1.0    # px (F_THRESHOLD)
    equalize: bool = True
    levels: int = 3


class FeatureTracker:
    """Host wrapper: persistent ids/lifetimes over the image ops on `device`.

    process(img, t) → {id: (normalized pt3, velocity2, prob)} — the same
    measurement dict the ROS node publishes as PointCloud channels
    [id,u,v,vx,vy,prob] (feature_tracker_ros.cpp:75-115). The image ops run
    on `device` (the camera's); ids, lifetimes, the occupancy mask and the
    RANSAC (`initialization.relative_pose_ransac`) are host numpy, as in the
    JAX package.
    """

    def __init__(self, cam: cameras.PinholeCamera,
                 params: TrackerParams = TrackerParams()):
        self.cam = cam
        self.device = cam.fx.device
        self.p = params
        self.prev_pyr = None
        self.prev_pts = np.zeros((0, 2))
        self.ids = np.zeros(0, np.int64)
        self.life = np.zeros(0, np.int64)
        self.scores = np.zeros(0)
        self.next_id = 0
        self.prev_t = None
        self.prev_norm = {}

    def _lift(self, uv: np.ndarray) -> np.ndarray:
        return cameras.lift_projective(
            self.cam, torch.tensor(uv, device=self.device)).cpu().numpy()

    def process(self, img, t: float) -> dict:
        from anticipated_vins_mono_torch.models.initialization import \
            relative_pose_ransac
        p = self.p
        img = as_image(img, self.device)
        if p.equalize:
            # tiled CLAHE, clipLimit 3.0, 8×8 (feature_tracker.cpp:36-40)
            img = clahe(img)
        pyr = tuple(build_pyramid(img, p.levels))

        N = p.max_features
        if self.prev_pyr is not None and len(self.prev_pts):
            pts = np.zeros((N, 2), np.float32)
            val = np.zeros(N, np.float32)
            n = len(self.prev_pts)
            pts[:n] = self.prev_pts
            val[:n] = 1.0
            new_pts, ok = lk_track(
                self.prev_pyr, pyr, torch.tensor(pts, device=self.device),
                torch.tensor(val, device=self.device), levels=p.levels)
            new_pts = new_pts.cpu().numpy()[:n]
            ok = ok.cpu().numpy()[:n]
            # RANSAC on normalized coords (rejectWithF, :263-296)
            if ok.sum() >= 15:
                n1 = self._lift(self.prev_pts[ok])[:, :2]
                n2 = self._lift(new_pts[ok])[:, :2]
                got = relative_pose_ransac(
                    n1, n2, thresh=p.ransac_thresh / float(self.cam.fx))
                if got is not None:
                    sub = np.zeros(int(ok.sum()), bool)
                    sub[got[2]] = True
                    full = np.zeros(len(ok), bool)
                    full[np.nonzero(ok)[0]] = sub
                    ok = full
            self.prev_pts = new_pts[ok]
            self.ids = self.ids[ok]
            self.life = self.life[ok] + 1
            self.scores = self.scores[ok]
        # top-up detection in unoccupied regions
        budget = p.max_features - len(self.prev_pts)
        if budget > 0:
            occ = np.zeros(pyr[0].shape, np.float32)
            r = p.min_dist // 2
            for (x, y) in self.prev_pts:
                x0, y0 = int(x), int(y)
                occ[max(0, y0 - r):y0 + r, max(0, x0 - r):x0 + r] = 1.0
            uv, score, valid = detect_features(
                pyr[0], torch.tensor(occ, device=self.device),
                p.max_features, p.min_dist)
            uv, score, valid = (uv.cpu().numpy(), score.cpu().numpy(),
                                valid.cpu().numpy())
            take = np.nonzero(valid)[0][:budget]
            self.prev_pts = np.concatenate([self.prev_pts, uv[take]], 0)
            self.ids = np.concatenate(
                [self.ids, self.next_id + np.arange(len(take))])
            self.life = np.concatenate([self.life,
                                        np.ones(len(take), np.int64)])
            self.scores = np.concatenate([self.scores, score[take]])
            self.next_id += len(take)

        self.prev_pyr = pyr
        # measurements: undistort → normalized plane + velocity + prob
        out = {}
        if len(self.prev_pts):
            rays = self._lift(self.prev_pts)
            smax = max(self.scores.max(), 1e-9)
            dt = (t - self.prev_t) if self.prev_t is not None else None
            for k, fid in enumerate(self.ids):
                vel = np.zeros(2)
                if dt and fid in self.prev_norm:
                    vel = (rays[k, :2] - self.prev_norm[fid]) / dt
                out[int(fid)] = (rays[k], vel, float(self.scores[k] / smax))
            self.prev_norm = {int(f): rays[k, :2].copy()
                              for k, f in enumerate(self.ids)}
        self.prev_t = t
        return out
