"""Intrinsic camera calibration tooling (L1) — chessboard to intrinsics.

Counterpart of `anticipated_vins_mono_tpu/utils/calibration.py`, with the
reference's calibration surface as its model (camera_model's
intrinsic_calib.cc: the `Chessboard` detector, `CameraCalibration::
addChessboardData` + `calibrate()`):

- chessboard **rendering** and **corner detection** run as tensor programs
  on the image's device (separable Gaussian + Hessian saddle response +
  NMS — image-wide convolutions instead of OpenCV's region growing);
- the nonlinear refinement is ONE branchless Levenberg-Marquardt loop: all
  views' reprojection residuals are evaluated batched, the full Jacobian
  [2·V·N, P+6V] comes from `torch.func.jacfwd` through the *same*
  `cameras.space_to_plane` the runtime uses, in the caller's dtype;
- the closed-form bootstrap is Zhang's method (homography constraints → K),
  host numpy in float64.

The JAX ops' semantics that torch does not share are carried explicitly in
`_saddle_response`: `jnp.correlate(mode="valid")` on an edge-padded image
(a cross-correlation, `conv2d`), `jnp.roll`'s wrap in the finite
differences (`torch.roll`), `reduce_window(..., "SAME")` padding with −inf
(`max_pool2d`'s padding), `lax.top_k`'s order among equal scores (the lower
index first: a stable descending sort), and `lax.dynamic_slice`'s start
index at the border: a negative start has the size added and is then
clamped into the array, so a pick in row 0 reads the last three rows
(torch indexing would wrap to a window across the border, or raise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn

from anticipated_vins_mono_torch.ops import cameras, lie

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Board geometry + synthetic imagery
# ---------------------------------------------------------------------------


def board_points(nx: int, ny: int, square: float) -> np.ndarray:
    """Inner-corner lattice [ny*nx, 3] (z=0), row-major — the `objectPoints`
    the reference builds in CameraCalibration::addChessboardData."""
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    return np.stack([xs.ravel() * square, ys.ravel() * square,
                     np.zeros(nx * ny)], axis=-1)


def render_chessboard(cam, R_cb, t_cb, nx: int, ny: int, square: float,
                      ss: int = 2) -> Tensor:
    """Render the chessboard through the (distorted) camera model, on the
    camera's device.

    R_cb, t_cb: board→camera transform (X_cam = R X_board + t). The board's
    squares span [-square, nx·square] × [-square, ny·square] so the nx×ny
    INNER corners sit at (i·square, j·square). `ss`×`ss` supersampling
    antialiases the edges (the detector's subpixel accuracy depends on it).
    Rendering goes through `lift_projective` — the same fixed-point
    undistortion the runtime uses. The pixel grid is float32 promoted with
    the camera's dtype, as the JAX version's `astype(float32)` promotes
    against its camera.
    """
    dev = cam[0].device
    dtype = torch.promote_types(torch.float32, cam[0].dtype)
    H, W = int(cam.height), int(cam.width)
    jj, ii = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    offs = (torch.arange(ss, device=dev) + 0.5) / ss - 0.5
    ou, ov = torch.meshgrid(offs, offs, indexing="ij")
    uv = torch.stack([ii[None, None] + ou[:, :, None, None],
                      jj[None, None] + ov[:, :, None, None]], dim=-1)
    rays = cameras.lift_projective(cam, uv.to(dtype))        # [ss,ss,H,W,3]
    as_t = lambda a: (a if torch.is_tensor(a) else torch.tensor(np.asarray(a)))
    R_cb, t_cb = as_t(R_cb).to(dev, dtype), as_t(t_cb).to(dev, dtype)
    # camera center + ray directions in board frame
    C_b = -R_cb.T @ t_cb
    d_b = torch.einsum("ab,...b->...a", R_cb.T, rays)
    dz = d_b[..., 2]
    s = -C_b[2] / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    pt = C_b + s[..., None] * d_b
    x, y = pt[..., 0] / square, pt[..., 1] / square
    # checker occupies [-1, nx]×[-1, ny]: interior crossings land EXACTLY on
    # the nx×ny inner corners. A white quiet border keeps the outer
    # black/white junctions from reading as saddle points.
    in_checker = (x >= -1.0) & (x <= nx) & (y >= -1.0) & (y <= ny)
    in_border = (x >= -2.5) & (x <= nx + 1.5) & (y >= -2.5) & (y <= ny + 1.5)
    checker = torch.remainder(torch.floor(x) + torch.floor(y), 2.0)
    full = lambda v: torch.full_like(x, v)
    shade = torch.where(in_checker,
                        torch.where(checker > 0.5, full(0.95), full(0.08)),
                        full(0.95))
    img = torch.where((s > 0) & in_border, shade, full(0.55))
    return img.mean(dim=(0, 1))                       # [H,W] in [0,1]


# ---------------------------------------------------------------------------
# Corner detection (saddle points of the checker pattern)
# ---------------------------------------------------------------------------


def _gauss_kernel(sigma: float, radius: int, device=None) -> Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _saddle_response(img: Tensor, n_corners: int):
    """Hessian-determinant saddle response + 5×5 NMS + top-k subpixel peaks,
    float32 on the image's device.

    Chessboard inner corners are saddle points of the intensity surface:
    det(Hessian) = Ixx·Iyy − Ixy² is strongly NEGATIVE there, so the
    response is −det: separable Gaussian → finite-difference Hessian → NMS
    → top-k → 3×3 quadratic subpixel fit. Returns (uv [n,2], scores [n]).
    """
    f = img.to(torch.float32)
    H, W = f.shape
    k = _gauss_kernel(1.5, 4, f.device)
    # jnp.correlate(mode="valid") over rows, then columns, of the image
    # edge-padded by 4: a cross-correlation (no flip), summed tap by tap
    ap = Fn.pad(f[None, None], (4, 4, 4, 4), mode="replicate")[0, 0]
    ar = sum(ap[:, j:j + W] * k[j] for j in range(9))
    f = sum(ar[j:j + H, :] * k[j] for j in range(9))

    # jnp.roll wraps around the border; so does torch.roll
    r = torch.roll
    fx = 0.5 * (r(f, -1, 1) - r(f, 1, 1))
    fxx = r(f, -1, 1) - 2 * f + r(f, 1, 1)
    fyy = r(f, -1, 0) - 2 * f + r(f, 1, 0)
    fxy = 0.5 * (r(fx, -1, 0) - r(fx, 1, 0))
    resp = -(fxx * fyy - fxy * fxy)
    resp = torch.where(resp > 0, resp, torch.zeros_like(resp))

    # 5×5 NMS via max-pool comparison. Supersampled renders can produce
    # EXACT response ties on adjacent pixels: a tiny index-keyed perturbation
    # (≤1e-6 relative) makes every plateau's argmax unique.
    tie = (torch.arange(H * W, dtype=resp.dtype, device=resp.device)
           .reshape(H, W) / (H * W)) * (resp.max() * 1e-6)
    keyed = resp + tie
    # reduce_window "SAME" pads with −inf; max_pool2d's padding is −inf too
    mx = Fn.max_pool2d(keyed[None, None], 5, stride=1, padding=2)[0, 0]
    is_peak = (keyed >= mx) & (resp > 0)
    # suppress the border (rolling wraps + padding artifacts)
    border = 8
    mask = torch.zeros_like(is_peak)
    mask[border:-border, border:-border] = True
    score = torch.where(is_peak & mask, resp, torch.zeros_like(resp))

    # lax.top_k: among equal scores the lower index first — a stable sort
    vals, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:n_corners], idx[:n_corners]
    py, px = idx // W, idx % W

    # subpixel: quadratic fit on the response in the 3×3 neighborhood.
    # lax.dynamic_slice first adds the size to a negative start (-1 → H-1)
    # and then clamps it so that the window stays inside the array: a pick
    # in row 0 reads the LAST three rows, one in row H-1 the last three
    sy, sx = py - 1, px - 1
    sy = torch.clamp(torch.where(sy < 0, sy + H, sy), 0, H - 3)
    sx = torch.clamp(torch.where(sx < 0, sx + W, sx), 0, W - 3)
    d3 = torch.arange(3, device=resp.device)
    nb = resp[(sy[:, None, None] + d3[None, :, None]),
              (sx[:, None, None] + d3[None, None, :])]          # [n,3,3]
    gx = 0.5 * (nb[:, 1, 2] - nb[:, 1, 0])
    gy = 0.5 * (nb[:, 2, 1] - nb[:, 0, 1])
    hxx = nb[:, 1, 2] - 2 * nb[:, 1, 1] + nb[:, 1, 0]
    hyy = nb[:, 2, 1] - 2 * nb[:, 1, 1] + nb[:, 0, 1]
    hxy = 0.25 * (nb[:, 2, 2] - nb[:, 2, 0] - nb[:, 0, 2] + nb[:, 0, 0])
    det = hxx * hyy - hxy * hxy
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    dx = torch.clamp(-(hyy * gx - hxy * gy) / det, -1.0, 1.0)
    dy = torch.clamp(-(hxx * gy - hxy * gx) / det, -1.0, 1.0)
    uv = torch.stack([px.to(torch.float32) + dx, py.to(torch.float32) + dy],
                     dim=-1)
    return uv, vals


def _order_grid(uv: np.ndarray, nx: int, ny: int) -> Optional[np.ndarray]:
    """Order detected corners into the row-major nx×ny lattice.

    Lattice direction from the histogram of nearest-neighbor angles
    (mod 90°); rows split on the ny−1 largest gaps of the rotated
    y-coordinate; each row sorted by rotated x. Returns [ny*nx, 2] or None
    if the grid structure isn't recovered (the caller drops the view).
    """
    if len(uv) != nx * ny:
        return None
    d2 = ((uv[:, None] - uv[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = d2.argmin(1)
    vec = uv[nn] - uv
    ang = np.arctan2(vec[:, 1], vec[:, 0])
    # lattice orientation mod 90°: NN directions cluster at two ORTHOGONAL
    # angles, which cancel under a doubled-angle mean — fold by 4θ instead
    th = 0.25 * np.arctan2(np.sin(4 * ang).sum(), np.cos(4 * ang).sum())

    def attempt(th):
        R = np.array([[np.cos(-th), -np.sin(-th)],
                      [np.sin(-th), np.cos(-th)]])
        r = uv @ R.T
        order = np.argsort(r[:, 1], kind="stable")
        ys = r[order, 1]
        gaps = np.diff(ys)
        if ny > 1:
            splits = np.sort(np.argsort(gaps)[::-1][: ny - 1]) + 1
        else:
            splits = np.array([], int)
        rows = np.split(order, splits)
        if any(len(row) != nx for row in rows):
            return None
        out = []
        for row in rows:
            out.append(row[np.argsort(r[row, 0], kind="stable")])
        return uv[np.concatenate(out)]

    for cand in (th, th + np.pi / 2):
        got = attempt(cand)
        if got is not None:
            return got
    return None


def detect_chessboard(img, nx: int, ny: int,
                      device="cuda") -> Optional[np.ndarray]:
    """Detect + order the nx×ny inner corners; [ny*nx, 2] pixels or None.
    A tensor image is searched where it lies, a numpy image on `device`."""
    img = img if torch.is_tensor(img) else torch.as_tensor(
        np.asarray(img), device=device)
    uv, vals = _saddle_response(img.to(torch.float32), nx * ny)
    if float(vals[-1]) <= 0:
        return None
    return _order_grid(uv.cpu().numpy(), nx, ny)


# ---------------------------------------------------------------------------
# Zhang closed-form initialization
# ---------------------------------------------------------------------------


def _homography_dlt(xy: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Normalized DLT board-plane → pixels homography (f64 host math — the
    bootstrap is tiny; the refinement runs on the device)."""
    def norm_T(p):
        m, sd = p.mean(0), p.std(0).mean() + 1e-12
        T = np.array([[1 / sd, 0, -m[0] / sd],
                      [0, 1 / sd, -m[1] / sd], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ T.T
        return T, ph
    Ta, a = norm_T(xy[:, :2])
    Tb, b = norm_T(uv)
    rows = []
    for (x, y, _), (u, v, _) in zip(a, b):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(rows))
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ Hn @ Ta
    return H / H[2, 2]


def zhang_intrinsics(Hs: Sequence[np.ndarray], width: int, height: int):
    """Closed-form K from ≥3 homographies (Zhang 2000, §3.1; zero skew).

    The reference's per-model `estimateIntrinsics` plays the same role.
    Falls back to a centered 1.2·W focal guess if the constraint system is
    degenerate.
    """
    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])
    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b0, b1, b2, b3, b4, b5 = Vt[-1]
    fallback = (1.2 * width, 1.2 * width, width / 2.0, height / 2.0)
    denom = b0 * b2 - b1 * b1
    if abs(denom) < 1e-18 or abs(b0) < 1e-18:
        return fallback
    v0 = (b1 * b3 - b0 * b4) / denom
    lam = b5 - (b3 * b3 + v0 * (b1 * b3 - b0 * b4)) / b0
    alpha2, beta2 = lam / b0, lam * b0 / denom
    if not (np.isfinite(alpha2) and np.isfinite(beta2)
            and alpha2 > 0 and beta2 > 0):
        return fallback
    fx, fy = np.sqrt(alpha2), np.sqrt(beta2)
    u0 = -b3 * alpha2 / lam
    if not (0 < u0 < width and 0 < v0 < height
            and 0.2 * width < fx < 5 * width):
        return fallback
    return float(fx), float(fy), float(u0), float(v0)


def _extrinsics_from_H(K: np.ndarray, H: np.ndarray):
    """r1,r2 = λK⁻¹h1,2; R orthonormalized by SVD; t = λK⁻¹h3."""
    A = np.linalg.inv(K) @ H
    lam = 1.0 / (np.linalg.norm(A[:, 0]) + 1e-12)
    r1, r2, t = lam * A[:, 0], lam * A[:, 1], lam * A[:, 2]
    if t[2] < 0:                      # board must be in front of the camera
        r1, r2, t = -r1, -r2, -t
    Rm = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    U, _, Vt = np.linalg.svd(Rm)
    R = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    return R, t


# ---------------------------------------------------------------------------
# Batched LM refinement (model-polymorphic)
# ---------------------------------------------------------------------------

_PARAM_FIELDS = {
    cameras.PinholeCamera: ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
    cameras.EquidistantCamera: ("mu", "mv", "u0", "v0",
                                "k2", "k3", "k4", "k5"),
    cameras.MeiCamera: ("xi", "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
}


def camera_to_vector(cam) -> np.ndarray:
    return np.array([float(getattr(cam, f))
                     for f in _PARAM_FIELDS[type(cam)]])


def vector_to_camera(template, theta):
    fields = _PARAM_FIELDS[type(template)]
    return template._replace(**{f: theta[i] for i, f in enumerate(fields)})


def _lm_refine(theta0: Tensor, rvecs0: Tensor, tvecs0: Tensor, X: Tensor,
               obs: Tensor, tmpl_def, iters: int = 30):
    """Branchless LM over [P + 6V] parameters; residuals [V,N,2] batched,
    in the dtype and on the device of `theta0`.

    tmpl_def: (camera class, width, height). The per-iteration work is
    `torch.func.jacfwd` through `space_to_plane` + one [M,D]ᵀ[M,D] product +
    one Cholesky. A failed factorization gives NaN, as `jnp.linalg.cholesky`
    does, and the step is blended as the JAX loop blends it.
    """
    cls, width, height = tmpl_def
    V = rvecs0.shape[0]
    P = theta0.shape[0]
    dtype, dev = theta0.dtype, theta0.device
    template = cls.create(*np.zeros(P), width=width, height=height,
                          dtype=dtype, device=dev)

    def unpack(z):
        cam = vector_to_camera(template, z[:P])
        rv = z[P:P + 3 * V].reshape(V, 3)
        tv = z[P + 3 * V:].reshape(V, 3)
        return cam, rv, tv

    def residual(z):
        cam, rv, tv = unpack(z)
        Rm = lie.quat_to_rot(lie.exp_so3_quat(rv))
        Xc = torch.einsum("vab,nb->vna", Rm, X) + tv[:, None]
        pred = cameras.space_to_plane(cam, Xc)
        return (pred - obs).reshape(-1)

    jac = torch.func.jacfwd(residual)
    z = torch.cat([theta0, rvecs0.reshape(-1), tvecs0.reshape(-1)])
    cost = 0.5 * torch.sum(residual(z) ** 2)
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    for _ in range(iters):
        r = residual(z)
        J = jac(z)
        Hm = J.T @ J
        g = J.T @ r
        dH = torch.diagonal(Hm)
        damp = lam * torch.clamp(dH, min=1e-8)
        dscale = torch.rsqrt(torch.clamp(dH + damp, min=1e-20))
        A = (Hm + torch.diag(damp)) * dscale[:, None] * dscale[None, :]
        L = lie.cholesky_or_nan(A)
        dz = -dscale * torch.cholesky_solve((g * dscale)[:, None], L)[:, 0]
        cand = z + dz
        new_cost = 0.5 * torch.sum(residual(cand) ** 2)
        ok = new_cost < cost
        okf = ok.to(dtype)
        z = okf * cand + (1 - okf) * z
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-10, 1e8)
        cost = torch.where(ok, new_cost, cost)
    return z, cost


class CalibrationResult(NamedTuple):
    camera: object
    rvecs: np.ndarray          # [V,3] board→camera rotation vectors
    tvecs: np.ndarray          # [V,3]
    rms_px: float              # reprojection RMS over all corners
    n_views: int


def calibrate_camera(detections: Sequence[np.ndarray], board: np.ndarray,
                     template, iters: int = 30) -> CalibrationResult:
    """Full intrinsic calibration: Zhang bootstrap + LM refinement.

    detections: per-view ordered corner pixels [N,2] (from
    `detect_chessboard` or any source); board: [N,3] lattice (z=0);
    template: a camera instance of the target model class carrying
    width/height, dtype and device (parameter values ignored). The
    refinement runs in the template's dtype on its device.

    Parity: CameraCalibration::calibrate (intrinsic_calib.cc) — init via
    homographies, refine all views jointly.
    """
    V = len(detections)
    assert V >= 3, "need ≥3 views"
    xy = board[:, :2]
    Hs = [_homography_dlt(xy, d) for d in detections]
    fx, fy, cx, cy = zhang_intrinsics(Hs, template.width, template.height)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    rvecs, tvecs = [], []
    for H in Hs:
        R, t = _extrinsics_from_H(K, H)
        q = lie.rot_to_quat(torch.as_tensor(R))
        rvecs.append(lie.log_so3(q).numpy())
        tvecs.append(t)

    dtype, dev = template[0].dtype, template[0].device
    fields = _PARAM_FIELDS[type(template)]
    init_map = dict(fx=fx, fy=fy, cx=cx, cy=cy, mu=fx, mv=fy, u0=cx, v0=cy,
                    xi=1.0)
    theta0 = np.array([init_map.get(f, 0.0) for f in fields])
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    with torch.no_grad():
        z, cost = _lm_refine(
            t(theta0), t(np.stack(rvecs)), t(np.stack(tvecs)), t(board),
            t(np.stack(detections)),
            (type(template), template.width, template.height), iters)
    P = len(fields)
    cam = vector_to_camera(template, z[:P])
    z = z.cpu().numpy()
    rv = z[P:P + 3 * V].reshape(V, 3)
    tv = z[P + 3 * V:].reshape(V, 3)
    n = sum(len(d) for d in detections)
    rms = float(np.sqrt(2.0 * float(cost) / n))
    return CalibrationResult(cam, rv, tv, rms, V)


def calibrate_from_images(images: Sequence, nx: int, ny: int,
                          square: float, template,
                          iters: int = 30) -> Optional[CalibrationResult]:
    """Image-in calibration (`intrinsic_calib.cc`'s main flow: detect on
    every frame, drop failures, calibrate on the survivors). Numpy
    images are searched on the template's device."""
    board = board_points(nx, ny, square)
    dets = []
    for img in images:
        d = detect_chessboard(img, nx, ny, device=template[0].device)
        if d is not None:
            dets.append(d)
    if len(dets) < 3:
        return None
    return calibrate_camera(dets, board, template, iters=iters)
