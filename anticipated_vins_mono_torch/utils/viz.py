"""Visualization / debug rendering — dependency-free PPM output.

Counterpart of `anticipated_vins_mono_tpu/utils/viz.py`. Covers the
reference's qualitative-output surfaces without RViz:
- attention overlay: tracked / newly-selected / rejected features drawn on
  the image, the attention_viewer node's rendering (attention_viewer_ros.cpp)
- AR demo: virtual boxes projected through the estimated camera
  (ar_demo_node.cpp)
- trajectory plots: top-down estimated-vs-GT path, the benchmark_publisher
  RViz comparison

All rasterization is plain numpy; images are written as binary PPM (P6).
Points are projected through the port's `cameras.space_to_plane`, on the
device and in the dtype of the camera's parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.ops import cameras, lie

COLORS = {
    "tracked": (40, 200, 60),
    "selected": (60, 120, 255),
    "rejected": (220, 60, 50),
    "gt": (120, 120, 120),
    "est": (60, 120, 255),
    "box": (255, 180, 40),
}


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: [H,W,3] uint8 or [H,W] float (gray)."""
    if img.ndim == 2:
        g = np.clip(img * 255.0 if img.dtype != np.uint8 else img,
                    0, 255).astype(np.uint8)
        img = np.stack([g] * 3, -1)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img.astype(np.uint8)).tobytes())


def _to_rgb(img: np.ndarray) -> np.ndarray:
    g = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g] * 3, -1)


def _project(cam, P: np.ndarray) -> np.ndarray:
    """Camera-frame points [N,3] → pixels [N,2] through `cam`."""
    P = torch.as_tensor(np.asarray(P), dtype=cam[0].dtype, device=cam[0].device)
    return cameras.space_to_plane(cam, P).cpu().numpy()


def draw_marker(rgb: np.ndarray, x: float, y: float, color, r: int = 2):
    H, W = rgb.shape[:2]
    x, y = int(round(x)), int(round(y))
    if not (r <= x < W - r and r <= y < H - r):
        return
    rgb[y - r: y + r + 1, x - r: x + r + 1] = color


def draw_line(rgb: np.ndarray, p0, p1, color):
    H, W = rgb.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    rgb[ys[ok], xs[ok]] = color


def attention_overlay(img: np.ndarray, cam, tracked: dict, selected: dict,
                      rejected: dict) -> np.ndarray:
    """Color-coded feature overlay (attention_viewer parity). Feature dicts
    map id → normalized pt3; points are re-projected with `cam`."""
    rgb = _to_rgb(img)
    for feats, key in ((rejected, "rejected"), (tracked, "tracked"),
                       (selected, "selected")):
        if not feats:
            continue
        pts = np.stack([np.asarray(f[0]) if isinstance(f, tuple) else
                        np.asarray(f) for f in feats.values()])
        uv = _project(cam, pts)
        for (u, v) in uv:
            draw_marker(rgb, u, v, COLORS[key])
    return rgb


def ar_boxes(img: np.ndarray, cam, p_wc: np.ndarray, q_wc: np.ndarray,
             box_centers, box_size: float = 0.3) -> np.ndarray:
    """Project virtual axis-aligned cubes through the estimated camera
    (ar_demo parity)."""
    rgb = _to_rgb(img)
    R = lie.quat_to_rot(torch.as_tensor(np.asarray(q_wc, np.float64))).numpy()
    h = box_size / 2
    corners = np.array([[sx, sy, sz] for sx in (-h, h)
                        for sy in (-h, h) for sz in (-h, h)])
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for c in np.atleast_2d(box_centers):
        P_w = corners + c
        P_c = (P_w - p_wc) @ R
        if np.any(P_c[:, 2] < 0.2):
            continue
        uv = _project(cam, P_c)
        for (i, j) in edges:
            draw_line(rgb, uv[i], uv[j], COLORS["box"])
    return rgb


def trajectory_topdown(est_p: np.ndarray, gt_p: np.ndarray = None,
                       size: int = 480) -> np.ndarray:
    """Top-down (x,y) path raster, estimate blue over GT gray."""
    rgb = np.full((size, size, 3), 255, np.uint8)
    allp = est_p if gt_p is None else np.vstack([est_p, gt_p])
    lo = allp[:, :2].min(0) - 0.5
    hi = allp[:, :2].max(0) + 0.5
    scale = (size - 20) / max(hi - lo)

    def to_px(p):
        xy = (p[:, :2] - lo) * scale + 10
        return np.stack([xy[:, 0], size - 1 - xy[:, 1]], -1)

    for path, key in (((gt_p, "gt"),) if gt_p is not None else ()) + \
            ((est_p, "est"),):
        px = to_px(path)
        for k in range(len(px) - 1):
            draw_line(rgb, px[k], px[k + 1], COLORS[key])
    return rgb
