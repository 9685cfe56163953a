"""Pose graph: loop closure + 4-DoF global optimization.

Counterpart of `anticipated_vins_mono_tpu/models/posegraph.py`, function for
function. Capability parity with the reference pose_graph package
(pose_graph/src/pose_graph.{h,cpp}, keyframe.{h,cpp}):

- keyframe database with descriptors            (PoseGraph::addKeyFrame, :42+)
- place recognition: binary descriptors matched against the whole database
  by Hamming distance — products over the bit matrices instead of DBoW2's
  inverted index (detectLoop, pose_graph.cpp:304-385)
- BRIEF descriptors + Hamming matching for geometric verification
  (BriefExtractor / searchByBRIEFDes, keyframe.cpp:87+, 259-430)
- 4-DoF pose-graph optimization: yaw + translation with roll/pitch fixed
  from VIO, sequential edges to up to 4 predecessors + loop edges with
  Huber loss (optimize4DoF, pose_graph.cpp:403-560)
- drift output (r_drift/t_drift) applied to subsequent VIO poses
  (pose_graph.cpp:561-575).

Where the two differ:

- `brief_descriptors` samples all points' patterns in one batched
  `frontend._bilinear` (the JAX package maps one point at a time);
- `direct_similarities` runs on the database's device: the Hamming matrix
  as two products, then a segment minimum over the keyframe offsets
  (`scatter_reduce(..., "amin")` in place of `np.minimum.reduceat`). Counts
  are integers ≤ 256, exact in float32;
- `pgo_solve` is plain float64 torch: each edge's 4×4 Jacobian blocks in
  closed form, H and g assembled by `index_put_(accumulate=True)` of the
  JᵢᵀJᵢ, JᵢᵀJⱼ, JⱼᵀJⱼ blocks (the JAX package embeds every edge's rows in a
  dense [E, 4, 4K] one-hot tensor), `lie.cholesky_or_nan` (NaN where it
  fails, as the JAX Cholesky) + `torch.cholesky_solve`, a Python loop
  over the iterations;
- `PoseGraph` takes `device`, where `pgo_solve` runs (the card unless the
  caller asks for the CPU). Its bookkeeping stays numpy on the host, the
  scalar rotation conversions through the port's `ops/lie` in float64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from anticipated_vins_mono_torch.models.frontend import _bilinear, _blur3
from anticipated_vins_mono_torch.models.initialization import _lie, pnp_gn
from anticipated_vins_mono_torch.ops import lie


# ----------------------------------------------------------------------------
# BRIEF descriptors (DVision::BRIEF parity) — batched bit comparisons
# ----------------------------------------------------------------------------

BRIEF_BITS = 256
PATCH_HALF = 12


@functools.lru_cache(maxsize=1)
def _brief_pattern(bits: int = BRIEF_BITS, half: int = PATCH_HALF):
    rng = np.random.default_rng(12345)
    a = rng.normal(scale=half / 2.5, size=(bits, 2)).clip(-half, half)
    b = rng.normal(scale=half / 2.5, size=(bits, 2)).clip(-half, half)
    return a.astype(np.float32), b.astype(np.float32)


def brief_descriptors(img: Tensor, pts: Tensor) -> Tensor:
    """BRIEF-256 at pixel points [N,2] → bool [N,256], on the image's
    device. Smoothing via the pyramid blur, twice."""
    sm = _blur3(_blur3(img))
    pa_np, pb_np = _brief_pattern()
    pts = torch.as_tensor(pts, device=img.device)
    pa = torch.tensor(pa_np, device=img.device)
    pb = torch.tensor(pb_np, device=img.device)
    va = _bilinear(sm, pts[:, None, :] + pa[None])
    vb = _bilinear(sm, pts[:, None, :] + pb[None])
    return va < vb


def hamming_match(desc1: Tensor, desc2: Tensor) -> Tensor:
    """All-pairs Hamming distance [N1,N2] between bool [*,256] descriptor
    sets — one broadcast XOR-sum."""
    return torch.sum(desc1[:, None, :] ^ desc2[None, :, :], dim=-1)


def global_descriptor(descs: Tensor, valid: Tensor) -> Tensor:
    """Keyframe-level binary signature: per-bit majority over the frame's
    feature descriptors → unit float vector (superseded by `bow_descriptor`
    for place recognition)."""
    cnt = torch.sum(descs & valid[:, None].bool(), dim=0)
    tot = torch.clamp(torch.sum(valid), min=1.0)
    v = cnt / tot
    return v / torch.clamp(torch.linalg.norm(v), min=1e-9)


BOW_WORDS = 512


@functools.lru_cache(maxsize=1)
def _bow_vocab(words: int = BOW_WORDS, bits: int = BRIEF_BITS):
    rng = np.random.default_rng(777)
    return (rng.random((words, bits)) > 0.5).astype(np.float32)


def bow_descriptor(descs: Tensor, valid: Tensor) -> Tensor:
    """DBoW2-style visual-word histogram, L2-normalized."""
    hist = bow_histogram(descs, valid)
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-9)


def bow_histogram(descs: Tensor, valid: Tensor) -> Tensor:
    """Unnormalized sqrt-tf visual-word histogram [BOW_WORDS]: each
    descriptor's nearest of 512 fixed random binary words by Hamming
    distance (two products over the bit matrix; ties to the lower word)."""
    v = torch.tensor(_bow_vocab(), device=descs.device)
    d = descs.to(torch.float32)
    ham = d @ (1.0 - v).T + (1.0 - d) @ v.T          # [N, V] Hamming
    word = torch.argmin(ham, dim=1)
    hist = torch.zeros(BOW_WORDS, dtype=torch.float32, device=descs.device)
    hist.index_add_(0, word, valid.to(device=descs.device,
                                      dtype=torch.float32))
    return torch.sqrt(hist)


def idf_similarities(hists: np.ndarray, query: np.ndarray) -> np.ndarray:
    """tf-idf cosine of `query` [V] against database rows [K,V]; idf from
    the database's own document frequencies (host-side — K is small)."""
    K = len(hists)
    if K == 0:
        return np.zeros(0)
    df = (hists > 0).sum(0)
    idf = np.log(max(K, 2) / (1.0 + df))
    hw = hists * idf
    qw = query * idf
    denom = np.linalg.norm(hw, axis=1) * (np.linalg.norm(qw) + 1e-9) + 1e-9
    return (hw @ qw) / denom


def direct_similarities(db_desc, db_off, query, ham_thresh: int = 48,
                        device="cuda") -> np.ndarray:
    """Direct BRIEF set-matching retrieval score: score(k) = fraction of
    query descriptors whose nearest Hamming neighbour inside keyframe k is
    < ham_thresh bits.

    db_desc: [T,256] 0/1 — all database keyframes' descriptors concatenated
    (a tensor stays where it is; an array goes to `device`); db_off: [K+1]
    int prefix offsets (keyframe k owns rows off[k]:off[k+1]); query:
    [N,256] 0/1. Returns [K] float64 scores in [0,1] (numpy).
    """
    db_off = np.asarray(db_off)
    K = max(len(db_off) - 1, 0)
    if len(query) == 0 or K == 0 or len(db_desc) == 0:
        return np.zeros(K)
    dev = db_desc.device if torch.is_tensor(db_desc) else torch.device(device)
    D = torch.as_tensor(db_desc, device=dev)[int(db_off[0]):]
    D = D.to(torch.float32)
    q = torch.as_tensor(query, device=dev).to(torch.float32)
    N, T = q.shape[0], D.shape[0]
    ham = q @ (1.0 - D).T + (1.0 - q) @ D.T              # [N, T]
    # keyframe k's columns (the last keyframe's run to the end, as reduceat's)
    lengths = np.diff(np.append(db_off[:-1], db_off[0] + T))
    seg = torch.as_tensor(np.repeat(np.arange(K), lengths), device=dev)
    mins = torch.full((N, K), float(BRIEF_BITS + 1), dtype=torch.float32,
                      device=dev)
    mins = mins.scatter_reduce(1, seg[None].expand(N, T), ham, "amin",
                               include_self=False)
    scores = (mins < ham_thresh).sum(dim=0).cpu().numpy() / float(N)
    return np.where(np.diff(db_off) > 0, scores, 0.0)


def find_connection(desc_old, kps_old_3d: np.ndarray,
                    desc_new, kps_new_uv: np.ndarray,
                    max_hamming: int = 80, min_inliers: int = 25,
                    reproj_thresh: float = 10.0 / 460.0,
                    R0: np.ndarray | None = None,
                    p0: np.ndarray | None = None,
                    fail_stats: dict | None = None):
    """Geometric loop verification — KeyFrame::findConnection parity
    (keyframe.cpp:259-430): BRIEF Hamming matching (< 80) between the old
    keyframe's features (with 3-D positions) and the candidate frame's
    features (normalized 2-D), then PnP RANSAC with inlier gating at
    MIN_LOOP_NUM=25 (keyframe.h:15).

    The descriptors are bool tensors (the Hamming matrix is formed on their
    device) or arrays (on the CPU); everything after it is numpy with the
    JAX package's `default_rng(0)` draws in its order, and the port's
    `initialization.pnp_gn`. Returns (R_cw, p_wc, n_inliers, pairs, rms) of
    the NEW camera in the OLD frame's world, or None. R0/p0: the PnP's
    initial world→cam rotation and camera center.
    """
    if R0 is None:
        R0 = np.eye(3)
    if p0 is None:
        p0 = np.zeros(3)
    d_old = torch.as_tensor(desc_old)
    ham = hamming_match(d_old, torch.as_tensor(desc_new, device=d_old.device)
                        ).cpu().numpy()
    best = ham.argmin(axis=1)
    dist = ham[np.arange(len(best)), best]
    ok = dist <= max_hamming
    if ok.sum() < min_inliers:
        if fail_stats is not None:
            fail_stats["match_short"] = fail_stats.get("match_short", 0) + 1
        return None
    X = kps_old_3d[ok]
    uv = kps_new_uv[best[ok]]
    # PnP RANSAC (keyframe.cpp PnPRANSAC): minimal GN fits on random
    # 4-subsets, keep the largest reprojection-inlier set, refit on it
    rng = np.random.default_rng(0)
    n = len(X)

    def reproj_err(R, p):
        Pc = (X - p) @ R.T
        z = np.maximum(Pc[:, 2], 1e-6)
        return np.linalg.norm(Pc[:, :2] / z[:, None] - uv, axis=1)

    best_inl = np.zeros(n, bool)
    for _ in range(150):
        idx = rng.choice(n, 4, replace=False)
        got = pnp_gn(X[idx], uv[idx], R0, p0, iters=10)
        if got is None:
            continue
        inl = reproj_err(*got) < reproj_thresh
        if inl.sum() > best_inl.sum():
            best_inl = inl
            if best_inl.sum() > 0.7 * n:
                break
    if best_inl.sum() < min_inliers:
        if fail_stats is not None:
            fail_stats["ransac_short"] = fail_stats.get("ransac_short", 0) + 1
        return None
    got = pnp_gn(X[best_inl], uv[best_inl], R0, p0, iters=15)
    if got is None:
        return None
    R, p = got
    errs = reproj_err(R, p)
    inl = errs < reproj_thresh
    if inl.sum() < min_inliers:
        if fail_stats is not None:
            fail_stats["refit_short"] = fail_stats.get("refit_short", 0) + 1
        return None
    rows_old = np.nonzero(ok)[0]
    pairs = list(zip(rows_old[inl].tolist(), best[ok][inl].tolist()))
    # final-fit inlier reprojection RMS (normalized plane)
    rms = float(np.sqrt(np.mean(errs[inl] ** 2)))
    return R, p, int(inl.sum()), pairs, rms


# ----------------------------------------------------------------------------
# 4-DoF pose graph optimization
# ----------------------------------------------------------------------------


class PGOConfig(NamedTuple):
    max_kf: int = 256         # static keyframe capacity
    max_loops: int = 64       # static loop-edge capacity
    seq_links: int = 4        # sequential edges to up-to-4 predecessors (:466)
    iters: int = 5            # solver iterations (pose_graph.cpp:437)
    huber: float = 0.1        # loss on loop edges (:441 uses HuberLoss(0.1))
    yaw_weight: float = 1.0   # relative yaw residual scale (0.1 in functor *10)


def _yaw_rot(yaw, pitch, roll):
    return lie.ypr_to_rot(torch.stack([yaw, pitch, roll], dim=-1))


def _edge_residual(p_i, yaw_i, pr_i, p_j, yaw_j, t_meas, yaw_meas):
    """FourDOFError (pose_graph.h:159-200), batched over edges: relative
    translation expressed in frame i (yaw optimized, pitch/roll fixed) +
    relative yaw. Returns (r [E,4], R_i [E,3,3])."""
    R_i = _yaw_rot(yaw_i, pr_i[..., 0], pr_i[..., 1])
    r_t = torch.einsum("eji,ej->ei", R_i, p_j - p_i) - t_meas
    dy = yaw_j - yaw_i - yaw_meas
    dy = torch.remainder(dy + 180.0, 360.0) - 180.0   # NormalizeAngle
    r_y = dy * torch.pi / 180.0
    return torch.cat([r_t, r_y[:, None]], dim=-1), R_i


def _edge_jacobians(p_i, yaw_i, pr_i, p_j, R_i):
    """Closed-form ∂r/∂(p_i, yaw_i) and ∂r/∂(p_j, yaw_j) of `_edge_residual`
    [E,4,4] (columns x, y, z, yaw in degrees): the translation rows are
    ∓R_iᵀ and (∂R_i/∂yaw)ᵀ(p_j − p_i); the yaw row is ∓π/180."""
    c = torch.pi / 180.0
    y = yaw_i * c
    cy, sy = torch.cos(y), torch.sin(y)
    zero, one = torch.zeros_like(y), torch.ones_like(y)
    # ∂Rz/∂y · Rz(y)ᵀ, so that ∂R_i/∂y = that · R_i
    dRz = torch.stack([-sy, -cy, zero, cy, -sy, zero, zero, zero, zero],
                      dim=-1).reshape(-1, 3, 3)
    Rz_T = torch.stack([cy, sy, zero, -sy, cy, zero, zero, zero, one],
                       dim=-1).reshape(-1, 3, 3)
    dR = c * (dRz @ Rz_T @ R_i)
    E = p_i.shape[0]
    Ji = torch.zeros(E, 4, 4, dtype=p_i.dtype, device=p_i.device)
    Jj = torch.zeros_like(Ji)
    Rt = R_i.transpose(1, 2)
    Ji[:, :3, :3] = -Rt
    Jj[:, :3, :3] = Rt
    Ji[:, :3, 3] = torch.einsum("eji,ej->ei", dR, p_j - p_i)
    Ji[:, 3, 3] = -c
    Jj[:, 3, 3] = c
    return Ji, Jj


def _huber_w(sqn, delta):
    n = torch.sqrt(torch.clamp(sqn, min=1e-18))
    return torch.sqrt(torch.where(n <= delta, torch.ones_like(n), delta / n))


def _accumulate(Hb: Tensor, gb: Tensor, i: Tensor, j: Tensor, r: Tensor,
                Ji: Tensor, Jj: Tensor) -> None:
    """Add the edges' blocks into the block normal equations in place:
    Hb [K,K,4,4], gb [K,4]."""
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    Hb.index_put_((i, i), JiT @ Ji, accumulate=True)
    Hb.index_put_((i, j), JiT @ Jj, accumulate=True)
    Hb.index_put_((j, i), JjT @ Ji, accumulate=True)
    Hb.index_put_((j, j), JjT @ Jj, accumulate=True)
    gb.index_add_(0, i, (JiT @ r[..., None])[..., 0])
    gb.index_add_(0, j, (JjT @ r[..., None])[..., 0])


def pgo_solve(pos: Tensor, yaw: Tensor, pitch_roll: Tensor,
              kf_valid: Tensor,
              seq_i: Tensor, seq_j: Tensor, seq_t: Tensor,
              seq_yaw: Tensor, seq_valid: Tensor,
              loop_i: Tensor, loop_j: Tensor, loop_t: Tensor,
              loop_yaw: Tensor, loop_valid: Tensor,
              cfg: PGOConfig, gauge: Tensor | None = None,
              loop_w: Tensor | None = None):
    """Masked Gauss-Newton over (x,y,z,yaw) per keyframe, on the inputs'
    device and in their dtype (float64 in `PoseGraph`).

    `gauge` [K] marks keyframes held constant; when None, the earliest valid
    keyframe is gauge-fixed (pose_graph.cpp:455-460). Returns (pos, yaw).
    """
    K = cfg.max_kf
    dtype, dev = pos.dtype, pos.device
    n_var = 4 * K
    seq_i, seq_j = seq_i.long(), seq_j.long()
    loop_i, loop_j = loop_i.long(), loop_j.long()
    if loop_w is None:
        loop_w = torch.ones_like(loop_valid)
    freeze = 1.0 - kf_valid
    if gauge is None:
        freeze = freeze.clone()
        freeze[torch.argmax(kf_valid)] = 1.0
    else:
        freeze = torch.maximum(freeze, gauge)
    fmask = torch.repeat_interleave(freeze, 4)
    keep = 1.0 - fmask

    for _ in range(cfg.iters):
        Hb = torch.zeros(K, K, 4, 4, dtype=dtype, device=dev)
        gb = torch.zeros(K, 4, dtype=dtype, device=dev)
        for i, j, t, y, w, robust in (
                (seq_i, seq_j, seq_t, seq_yaw, seq_valid, False),
                (loop_i, loop_j, loop_t, loop_yaw,
                 loop_valid * loop_w, True)):
            r, R_i = _edge_residual(pos[i], yaw[i], pitch_roll[i],
                                    pos[j], yaw[j], t, y)
            Ji, Jj = _edge_jacobians(pos[i], yaw[i], pitch_roll[i],
                                     pos[j], R_i)
            if robust:
                # per-edge information weight composes with the Huber
                # robustifier (its weight is a constant of the step)
                w = w * _huber_w(torch.sum(r * r, dim=-1), cfg.huber)
            r = r * w[:, None]
            _accumulate(Hb, gb, i, j, r, Ji * w[:, None, None],
                        Jj * w[:, None, None])
        H = Hb.permute(0, 2, 1, 3).reshape(n_var, n_var)
        g = gb.reshape(n_var)
        # gauge: pin the gauge keyframes; freeze invalid slots
        H = H * keep[:, None] * keep[None, :] + torch.diag(fmask)
        g = g * keep
        H = H + 1e-6 * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        L = lie.cholesky_or_nan(H)
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
        dx = dx.reshape(K, 4)
        # dx[:,3] is already in the yaw variable's unit (degrees)
        pos, yaw = pos + dx[:, :3], yaw + dx[:, 3]
    return pos, yaw


# ----------------------------------------------------------------------------
# Host-side pose graph (keyframe DB + loop detection + drift)
# ----------------------------------------------------------------------------


MAX_SEQUENCES = 5   # reference cap (pose_graph_node.cpp:69-91)


def _np_yaw_rot(yaw, pitch, roll) -> np.ndarray:
    return _lie(lie.ypr_to_rot, [yaw, pitch, roll])


class PoseGraph:
    """Keyframe DB, similarity-based loop detection, 4-DoF optimization,
    drift correction — the pose_graph node's process/optimize4DoF loops
    (pose_graph_node.cpp:294-452, pose_graph.cpp:403-560) without ROS.

    Storage grows (capacity doubling) past cfg.max_kf/max_loops. Image-stream
    discontinuities (>1 s gap or time reversal) open a new sequence
    (pose_graph_node.cpp:93-113, max 5): sequential edges never span
    sequences, and a loop edge landing across sequences rigidly re-aligns
    the newer sequence onto the older one first (pose_graph.cpp:46-57).

    The JAX constructor's arguments, plus `device`: where `pgo_solve` runs
    (float64)."""

    def __init__(self, cfg: PGOConfig = PGOConfig(),
                 sim_thresh: float = 0.9, exclude_recent: int = 50,
                 min_gap: int = 3, device="cuda"):
        self.cfg = cfg
        self.sim_thresh = sim_thresh
        self.exclude_recent = exclude_recent
        self.min_gap = min_gap
        self.device = torch.device(device)
        K, L = cfg.max_kf, cfg.max_loops
        self.n = 0
        self.pos = np.zeros((K, 3))
        self.yaw = np.zeros(K)
        # VIO odometry poses, kept separate from the optimized state: every
        # sequential edge is built from them (getVioPose parity,
        # pose_graph.cpp:466-476), never from the optimized poses
        self.vio_pos = np.zeros((K, 3))
        self.vio_yaw = np.zeros(K)
        self.pitch_roll = np.zeros((K, 2))
        self.gdesc = np.zeros((K, BRIEF_BITS))
        self.seq_id = np.zeros(K, np.int32)   # sequence index per keyframe
        self.seq_i = np.zeros(K * cfg.seq_links, np.int32)
        self.seq_j = np.zeros(K * cfg.seq_links, np.int32)
        self.seq_t = np.zeros((K * cfg.seq_links, 3))
        self.seq_yaw = np.zeros(K * cfg.seq_links)
        self.seq_valid = np.zeros(K * cfg.seq_links)
        self.n_seq = 0
        self.loop_i = np.zeros(L, np.int32)
        self.loop_j = np.zeros(L, np.int32)
        self.loop_t = np.zeros((L, 3))
        self.loop_yaw = np.zeros(L)
        self.loop_valid = np.zeros(L)
        self.loop_w = np.ones(L)
        self.n_loops = 0
        self.t_drift = np.zeros(3)
        self.yaw_drift = 0.0
        self._last_opt_loops = 0
        self.cur_sequence = 0
        self.prev_t: Optional[float] = None
        # persistent per-sequence VIO→world alignment (w_r_vio/w_t_vio,
        # pose_graph.cpp:60-62)
        self._seq_align: dict[int, tuple[float, np.ndarray]] = {}
        # sequences already loop-anchored (sequence_loop gate,
        # pose_graph.cpp:103,123)
        self._seq_anchored: set[int] = set()

    # ------------------------------------------------------------------
    # capacity growth (unbounded-keyframe parity with the reference)
    # ------------------------------------------------------------------

    @staticmethod
    def _grown(arr: np.ndarray, new_len: int) -> np.ndarray:
        out = np.zeros((new_len,) + arr.shape[1:], arr.dtype)
        out[: len(arr)] = arr
        return out

    def _ensure_capacity(self):
        cfg = self.cfg
        if self.n >= cfg.max_kf:
            K2 = cfg.max_kf * 2
            for name in ("pos", "yaw", "vio_pos", "vio_yaw", "pitch_roll",
                         "gdesc", "seq_id"):
                setattr(self, name, self._grown(getattr(self, name), K2))
            for name in ("seq_i", "seq_j", "seq_t", "seq_yaw", "seq_valid"):
                setattr(self, name,
                        self._grown(getattr(self, name), K2 * cfg.seq_links))
            self.cfg = cfg = cfg._replace(max_kf=K2)
        if self.n_loops >= cfg.max_loops:
            L2 = cfg.max_loops * 2
            for name in ("loop_i", "loop_j", "loop_t", "loop_yaw",
                         "loop_valid", "loop_w"):
                setattr(self, name, self._grown(getattr(self, name), L2))
            self.cfg = cfg._replace(max_loops=L2)

    def new_sequence(self):
        """Open a new sequence (restart / stream discontinuity). Beyond the
        reference's 5-sequence cap, data keeps joining the last sequence.
        Zeroes the drift (pose_graph.cpp:47-56)."""
        if self.cur_sequence + 1 < MAX_SEQUENCES:
            self.cur_sequence += 1
            self._seq_align.pop(self.cur_sequence, None)
            self._seq_anchored.discard(self.cur_sequence)
        self.yaw_drift = 0.0
        self.t_drift = np.zeros(3)

    # ------------------------------------------------------------------

    def add_keyframe(self, p, q, gdesc: Optional[np.ndarray] = None,
                     loop_hint: Optional[tuple] = None,
                     t: Optional[float] = None) -> Optional[int]:
        """Insert a keyframe (VIO pose). Returns detected loop index or None.

        `loop_hint` (idx, rel_t, rel_yaw) injects a verified loop edge. `t`
        enables discontinuity detection (>1 s gap / time reversal → new
        sequence, pose_graph_node.cpp:93-113)."""
        self._ensure_capacity()
        cfg = self.cfg
        if t is not None and self.prev_t is not None and \
                (t - self.prev_t > 1.0 or t < self.prev_t):
            self.new_sequence()
        if t is not None:
            self.prev_t = t
        k = self.n
        ypr = _lie(lambda x: lie.rot_to_ypr(lie.quat_to_rot(x)), q)
        p = np.asarray(p, float)
        # the sequence's persistent VIO alignment (pose_graph.cpp:60-62)
        al = self._seq_align.get(self.cur_sequence)
        if al is not None:
            a_yaw, a_t = al
            Ra = _lie(lie.ypr_to_rot, [a_yaw, 0.0, 0.0])
            p = Ra @ p + a_t
            ypr = ypr.copy()
            ypr[0] += a_yaw
        self.vio_pos[k] = p
        self.vio_yaw[k] = ypr[0]
        # optimized-state initialization: the drift-corrected VIO pose
        # (pose_graph.cpp:561-575)
        Rz = _lie(lie.ypr_to_rot, [self.yaw_drift, 0., 0.])
        self.pos[k] = Rz @ p + self.t_drift
        self.yaw[k] = ypr[0] + self.yaw_drift
        self.pitch_roll[k] = ypr[1:3]
        self.seq_id[k] = self.cur_sequence
        if gdesc is not None:
            self.gdesc[k] = gdesc
        self.n += 1

        # sequential edges to up to seq_links predecessors (:461-490), never
        # across a sequence boundary, from the VIO odometry poses
        for back in range(1, cfg.seq_links + 1):
            i = k - back
            if i < 0 or self.seq_id[i] != self.seq_id[k]:
                break
            e = self.n_seq
            R_i = _np_yaw_rot(self.vio_yaw[i], self.pitch_roll[i, 0],
                              self.pitch_roll[i, 1])
            self.seq_i[e] = i
            self.seq_j[e] = k
            self.seq_t[e] = R_i.T @ (self.vio_pos[k] - self.vio_pos[i])
            self.seq_yaw[e] = self.vio_yaw[k] - self.vio_yaw[i]
            self.seq_valid[e] = 1.0
            self.n_seq += 1

        loop = None
        if loop_hint is not None:
            idx, rel_t, rel_yaw = loop_hint
            loop = int(idx)
        elif gdesc is not None and k > self.exclude_recent:
            sims = self.gdesc[: k - self.exclude_recent] @ gdesc
            if len(sims) and sims.max() > self.sim_thresh:
                loop = int(np.argmax(sims))
                rel_t = None
        if loop is not None:
            if loop_hint is None:
                # the VIO relative estimate, from vio_pos/vio_yaw (the frame
                # the sequential edges use), not the optimized state
                R_i = _np_yaw_rot(self.vio_yaw[loop], self.pitch_roll[loop, 0],
                                  self.pitch_roll[loop, 1])
                rel_t = R_i.T @ (self.vio_pos[k] - self.vio_pos[loop])
                rel_yaw = self.vio_yaw[k] - self.vio_yaw[loop]
            self.add_loop_edge(loop, k, rel_t, rel_yaw)
        return loop

    def add_loop_edge(self, i: int, j: int, rel_t, rel_yaw: float,
                      weight: float = 1.0):
        """Insert a geometrically-verified loop edge i←j (rel_t in keyframe
        i's frame, rel_yaw degrees). Cross-sequence edges first rigidly
        re-align the newer sequence (pose_graph.cpp:46-57)."""
        self._ensure_capacity()
        if self.seq_id[i] != self.seq_id[j] \
                and int(self.seq_id[j]) not in self._seq_anchored:
            self._align_sequence_to_loop(i, j, rel_t, rel_yaw)
        e = self.n_loops
        self.loop_i[e] = i
        self.loop_j[e] = j
        self.loop_t[e] = np.asarray(rel_t, float)
        self.loop_yaw[e] = float(rel_yaw)
        self.loop_valid[e] = 1.0
        self.loop_w[e] = float(weight)
        self.n_loops += 1

    def _align_sequence_to_loop(self, i: int, j: int, rel_t, rel_yaw):
        """First loop between sequences: rigidly shift keyframe j's whole
        sequence so the loop edge is satisfied (pose_graph.cpp:46-57)."""
        R_i = _np_yaw_rot(self.yaw[i], self.pitch_roll[i, 0],
                          self.pitch_roll[i, 1])
        p_target = self.pos[i] + R_i @ np.asarray(rel_t)
        yaw_target = self.yaw[i] + rel_yaw
        dyaw = yaw_target - self.yaw[j]
        Rz = _lie(lie.ypr_to_rot, [dyaw, 0.0, 0.0])
        dt = p_target - Rz @ self.pos[j]
        sel = np.nonzero(self.seq_id[: self.n] == self.seq_id[j])[0]
        self.pos[sel] = self.pos[sel] @ Rz.T + dt
        self.yaw[sel] += dyaw
        # rigid-align the sequence's VIO poses too (updateVioPose)
        self.vio_pos[sel] = self.vio_pos[sel] @ Rz.T + dt
        self.vio_yaw[sel] += dyaw
        # persist the alignment (composed with any prior transform)
        sj = int(self.seq_id[j])
        prev = self._seq_align.get(sj)
        if prev is None:
            self._seq_align[sj] = (dyaw, dt)
        else:
            p_yaw, p_t = prev
            self._seq_align[sj] = (p_yaw + dyaw, Rz @ p_t + dt)
        self._seq_anchored.add(sj)

    def _gauge_mask(self) -> np.ndarray:
        """Pin the head of every sequence not loop-anchored to an earlier
        one (disconnected blocks would make H singular)."""
        gauge = np.zeros(self.cfg.max_kf)
        anchored = {int(self.seq_id[0])} if self.n else set()
        # propagate anchoring through loop edges (sequences form few groups)
        for _ in range(MAX_SEQUENCES):
            for e in range(self.n_loops):
                si = int(self.seq_id[self.loop_i[e]])
                sj = int(self.seq_id[self.loop_j[e]])
                if si in anchored or sj in anchored:
                    anchored |= {si, sj}
        seen = set()
        for k in range(self.n):
            s = int(self.seq_id[k])
            if s not in seen:
                seen.add(s)
                if s not in anchored or k == 0:
                    gauge[k] = 1.0
        return gauge

    def optimize(self):
        """Run 4-DoF PGO if there are (new) loop edges; update drift."""
        if self.n_loops == 0 or self.n_loops == self._last_opt_loops:
            return
        cfg = self.cfg
        kf_valid = np.zeros(cfg.max_kf)
        kf_valid[: self.n] = 1.0
        dev = lambda a: torch.tensor(a, device=self.device)
        pos, yaw = pgo_solve(
            dev(self.pos), dev(self.yaw), dev(self.pitch_roll), dev(kf_valid),
            dev(self.seq_i), dev(self.seq_j), dev(self.seq_t),
            dev(self.seq_yaw), dev(self.seq_valid),
            dev(self.loop_i), dev(self.loop_j), dev(self.loop_t),
            dev(self.loop_yaw), dev(self.loop_valid), cfg,
            gauge=dev(self._gauge_mask()), loop_w=dev(self.loop_w))
        self.pos = pos.cpu().numpy().copy()
        self.yaw = yaw.cpu().numpy().copy()
        # drift = optimized pose of the newest keyframe vs its VIO pose
        # (r_drift/t_drift, pose_graph.cpp:561-575)
        self.yaw_drift = self.yaw[self.n - 1] - self.vio_yaw[self.n - 1]
        Rz = _lie(lie.ypr_to_rot, [self.yaw_drift, 0.0, 0.0])
        self.t_drift = self.pos[self.n - 1] - Rz @ self.vio_pos[self.n - 1]
        self._last_opt_loops = self.n_loops

    def correct(self, p, yaw_deg):
        """Apply the current drift to a VIO pose (w_T_vio chaining)."""
        Rz = _lie(lie.ypr_to_rot, [self.yaw_drift, 0.0, 0.0])
        return Rz @ np.asarray(p) + self.t_drift, yaw_deg + self.yaw_drift
