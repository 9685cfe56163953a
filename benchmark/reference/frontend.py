"""The image front end for the tracker's reference: a copy of the port's
`models/frontend.{as_image, clahe, build_pyramid, gftt_response,
detect_features, lk_track}` and their helpers, in plain torch.

Images take one dtype (float64 in the reference, bfloat16 in the control)
and points, weights, coordinates and histograms another (float64; float32
beside bfloat16 images): every image, pyramid level, gradient, response map
and patch is rounded to the image dtype where it is made, and the
arithmetic between an image and a weight runs in the wider of the two, as
torch promotes it.

Where the copy departs from the port:

- `lk_track` has only the form that follows the flow (the port's
  `follow_flow=True`): each level cuts the current image's patch around
  the corner plus the whole pixels of the flow carried down from the
  coarser level, and `pad` bounds that level's correction;
- `as_image` takes the image dtype from the caller (the port's is
  float32);
- CLAHE's pixel coordinates and interpolation weights, the histograms and
  the detected corners' coordinates are in the wider dtype, not the
  image's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def _wide(dtype):
    """The dtype of coordinates and weights beside images of `dtype`."""
    return torch.promote_types(dtype, torch.float32)


def as_image(img, device, dtype=torch.float64) -> Tensor:
    """An 8-bit image (uint8 numpy array or tensor) as `dtype` in [0, 1] on
    `device`: the exact quotient by 255 rounded once; a float image is cast."""
    if not torch.is_tensor(img):
        img = torch.from_numpy(np.asarray(img))
    img = img.to(device)
    if img.dtype == torch.uint8:
        return (img.to(torch.float64) / 255.0).to(dtype)
    return img.to(dtype)


def _pad_edge(x: Tensor, axis: int, lo: int, hi: int) -> Tensor:
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-lo, n + hi, device=x.device), 0, n - 1)
    return x.index_select(axis, idx)


def clahe(img: Tensor, clip_limit: float = 3.0, tiles: int = 8,
          bins: int = 256) -> Tensor:
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(3.0, (8, 8))): per-tile clipped histograms with the
    excess spread evenly, each pixel a bilinear blend of its four nearest
    tiles' mappings."""
    dt, wd = img.dtype, _wide(img.dtype)
    H, W = img.shape
    ty, tx = -(-H // tiles), -(-W // tiles)
    imp = _pad_edge(_pad_edge(img, 0, 0, ty * tiles - H), 1, 0,
                    tx * tiles - W)
    idx = torch.clamp((imp * bins).to(torch.int32), 0, bins - 1).long()
    npix = ty * tx
    tile_of = idx.reshape(tiles, ty, tiles, tx).permute(0, 2, 1, 3)
    tile_of = tile_of.reshape(tiles * tiles, ty * tx)
    flat = (torch.arange(tiles * tiles, device=img.device)[:, None] * bins
            + tile_of).reshape(-1)
    hists = torch.bincount(flat, minlength=tiles * tiles * bins)
    hists = hists.reshape(tiles * tiles, bins).to(wd)
    limit = max(clip_limit * npix / bins, 1.0)
    excess = torch.sum(torch.clamp(hists - limit, min=0.0), dim=1,
                       keepdim=True)
    hists = torch.clamp(hists, max=limit) + excess / bins
    luts = (torch.cumsum(hists, dim=1) / npix).reshape(tiles, tiles, bins)
    luts = luts.to(dt)

    Hp, Wp = imp.shape
    yy = torch.arange(Hp, dtype=wd, device=img.device)
    xx = torch.arange(Wp, dtype=wd, device=img.device)
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
    return out[:H, :W].to(dt)


def _blur3(img: Tensor) -> Tensor:
    """Separable [1 2 1]/4 blur, edges replicated."""
    k = (0.25, 0.5, 0.25)

    def conv1(x, axis):
        xp = _pad_edge(x, axis, 1, 1)
        n = x.shape[axis]
        out = 0.0
        for o, kv in enumerate(k):
            out = out + kv * xp.narrow(axis, o, n)
        return out

    return conv1(conv1(img, 0), 1)


def build_pyramid(img: Tensor, levels: int) -> list:
    """Gaussian pyramid: blur, then every second row and column."""
    pyr = [img]
    for _ in range(levels - 1):
        img = _blur3(img)[::2, ::2].contiguous()
        pyr.append(img)
    return pyr


def _gradients(img: Tensor):
    xp = _pad_edge(img, 1, 1, 1)
    Ix = 0.5 * (xp[:, 2:] - xp[:, :-2])
    yp = _pad_edge(img, 0, 1, 1)
    Iy = 0.5 * (yp[2:, :] - yp[:-2, :])
    return Ix, Iy


def gftt_response(img: Tensor, window: int = 3) -> Tensor:
    """Shi-Tomasi minimum-eigenvalue response of the blurred structure
    tensor."""
    Ix, Iy = _gradients(img)
    a, b, c = Ix * Ix, Ix * Iy, Iy * Iy
    for _ in range(window // 2 + 1):
        a, b, c = _blur3(a), _blur3(b), _blur3(c)
    tr = 0.5 * (a + c)
    det = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    return torch.clamp(tr - det, min=0.0)


def window_max_same(x: Tensor, k: int, fill: float) -> Tensor:
    """Max over a k×k window covering (k−1)//2 before a pixel and k//2
    after it (`lax.reduce_window`'s "SAME")."""
    lo, hi = (k - 1) // 2, k // 2
    xp = F.pad(x[None, None], (lo, hi, lo, hi), value=fill)
    return F.max_pool2d(xp, k, stride=1)[0, 0]


def detect_features(img: Tensor, occupied: Tensor, max_n: int,
                    min_dist: int, quality_level: float = 0.01):
    """The `max_n` strongest corners that are the maximum of their
    min_dist × min_dist window, outside the occupied region, above
    quality_level × the strongest response; ties to the lower pixel index.
    Returns (uv [max_n,2], score [max_n], valid [max_n])."""
    resp = gftt_response(img)
    resp = resp * (1.0 - occupied.to(resp.dtype))
    wmax = window_max_same(resp, min_dist, float("-inf"))
    is_peak = (resp >= wmax) & (resp > quality_level * torch.max(resp))
    flat = torch.where(is_peak, resp, torch.zeros_like(resp)).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    score, idx = vals[:max_n], idx[:max_n]
    W = img.shape[1]
    wd = _wide(img.dtype)
    uv = torch.stack([(idx % W).to(wd), (idx // W).to(wd)], dim=-1)
    return uv, score, score > 0.0


def _bilinear(img: Tensor, uv: Tensor) -> Tensor:
    H, W = img.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def _extract_patches(img: Tensor, anchor: Tensor, S: int) -> Tensor:
    """[N,S,S] patches with top-left corners `anchor` [N,2] (x, y), the
    border replicated."""
    H, W = img.shape
    ar = torch.arange(S, device=img.device)
    ys = torch.clamp(anchor[:, 1, None, None] + ar[None, :, None], 0, H - 1)
    xs = torch.clamp(anchor[:, 0, None, None] + ar[None, None, :], 0, W - 1)
    return img[ys, xs]


def _shift_sample(P: Tensor, iy, ix, fy, fx, win: int) -> Tensor:
    """[N,win,win] windows of the patches P [N,S,S] at the whole offset
    (iy, ix) plus the fraction (fy, fx), bilinearly."""
    ar = torch.arange(win + 1, device=P.device)
    n = torch.arange(P.shape[0], device=P.device)[:, None, None]
    Pw = P[n, (iy[:, None] + ar)[:, :, None], (ix[:, None] + ar)[:, None, :]]
    fx_ = fx[:, None, None]
    fy_ = fy[:, None, None]
    Px = (1.0 - fx_) * Pw[:, :, :-1] + fx_ * Pw[:, :, 1:]
    return ((1.0 - fy_) * Px[:, :-1, :] + fy_ * Px[:, 1:, :]).to(P.dtype)


def lk_track(prev_pyr, cur_pyr, pts: Tensor, valid: Tensor, half: int = 7,
             iters: int = 10, levels: int = 4, pad: int = 8):
    """Pyramidal Lucas-Kanade from the coarsest level down, following the
    flow (calcOpticalFlowPyrLK): at each level a (2·half+1)² template and
    its central-difference gradients around the previous corner, and
    `iters` Gauss-Newton steps of the flow inside a patch of the current
    level cut around the corner plus the carried flow's whole pixels, the
    step bounded by ±pad there. A track is kept where it ends 3 px or more
    inside the frame and its mean absolute residual over the window at the
    finest level is below 0.25. Returns (new_pts [N,2], ok [N])."""
    N = pts.shape[0]
    win = 2 * half + 1

    def track_level(flow, level):
        scale = 2.0 ** level
        prev_img, cur_img = prev_pyr[level], cur_pyr[level]
        dt = prev_img.dtype
        p_lvl = pts / scale
        p0 = torch.floor(p_lvl)
        f = p_lvl - p0
        p0i = p0.long()
        Sp = win + 4
        Pp = _extract_patches(prev_img, p0i - (half + 1), Sp)
        fx_ = f[:, 0, None, None]
        fy_ = f[:, 1, None, None]
        Px = (1.0 - fx_) * Pp[:, :, :-1] + fx_ * Pp[:, :, 1:]
        Pxy = ((1.0 - fy_) * Px[:, :-1, :] + fy_ * Px[:, 1:, :]).to(dt)
        T = Pxy[:, 1:1 + win, 1:1 + win]
        gx = 0.5 * (Pxy[:, 1:1 + win, 2:2 + win] - Pxy[:, 1:1 + win, 0:win])
        gy = 0.5 * (Pxy[:, 2:2 + win, 1:1 + win] - Pxy[:, 0:win, 1:1 + win])
        gxx = torch.sum(gx * gx, (-2, -1)) + 1e-6
        gyy = torch.sum(gy * gy, (-2, -1)) + 1e-6
        gxy = torch.sum(gx * gy, (-2, -1))
        det = gxx * gyy - gxy * gxy

        g = torch.floor(flow)
        Sc = win + 2 * pad + 1
        Pc = _extract_patches(cur_img, p0i + g.long() - (half + pad), Sc)
        fl = flow
        for _ in range(iters):
            t = (f - g) + fl
            ti = torch.floor(t)
            tf = t - ti
            iy = torch.clamp(ti[:, 1].long() + pad, 0, 2 * pad)
            ix = torch.clamp(ti[:, 0].long() + pad, 0, 2 * pad)
            err = _shift_sample(Pc, iy, ix, tf[:, 1], tf[:, 0], win) - T
            bx = torch.sum(gx * err, (-2, -1))
            by = torch.sum(gy * err, (-2, -1))
            dx = -(gyy * bx - gxy * by) / det
            dy = -(gxx * by - gxy * bx) / det
            fl = fl + torch.stack([dx, dy], -1).to(fl.dtype)
        return fl

    flow = torch.zeros((N, 2), dtype=pts.dtype, device=pts.device)
    for level in range(levels - 1, -1, -1):
        flow = track_level(flow, level)
        if level > 0:
            flow = flow * 2.0
    new_pts = pts + flow

    H, W = cur_pyr[0].shape
    inb = (new_pts[:, 0] > 2) & (new_pts[:, 0] < W - 3) & \
        (new_pts[:, 1] > 2) & (new_pts[:, 1] < H - 3)
    ar = torch.arange(-half, half + 1, dtype=pts.dtype, device=pts.device)
    gy_, gx_ = torch.meshgrid(ar, ar, indexing="ij")
    offs = torch.stack([gx_, gy_], dim=-1).reshape(-1, 2)
    patch_prev = _bilinear(prev_pyr[0], pts[:, None, :] + offs)
    patch_cur = _bilinear(cur_pyr[0], new_pts[:, None, :] + offs)
    resid = torch.mean(torch.abs(patch_cur - patch_prev), dim=-1)
    ok = inb & (resid < 0.25) & (valid > 0)
    return new_pts, ok
