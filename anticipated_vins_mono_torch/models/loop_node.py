"""Runtime loop-closure node: keyframe imagery → place recognition →
geometric verification → relocalization feedback → 4-DoF PGO → drift.

Counterpart of `anticipated_vins_mono_tpu/models/loop_node.py`. The
reference's pose_graph node process loop (pose_graph_node.cpp:294-452):
time-aligned (keyframe pose, window point cloud, raw image) triplets become
KeyFrames (corners + BRIEF, keyframe.cpp:87+), run detectLoop with top-4 /
dual-threshold / 50-frame-exclusion acceptance (pose_graph.cpp:304-385),
verify with BRIEF matching + PnP RANSAC (findConnection,
keyframe.cpp:259-430), publish match_points back to the estimator for
relocalization factors (estimator_node.cpp:406 → setReloFrame), and
optimize the 4-DoF pose graph. The estimator feeds it synchronously via
`VioEstimator.last_keyframe`.

Where the two differ: the node takes `device` (default the card), where the
image work (corner detection, BRIEF, projection), the direct-retrieval
database and the Hamming matrices live; its default `graph` is a
`PoseGraph` on the same device (the JAX field's default factory takes no
device). The database is one float32 [T,256] tensor on that device, its
capacity doubled when a keyframe's corners do not fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.models import frontend as fe
from anticipated_vins_mono_torch.models import posegraph as pg
from anticipated_vins_mono_torch.models.initialization import _lie
from anticipated_vins_mono_torch.ops import cameras, lie


def _wrap_deg(a):
    return (a + 180.0) % 360.0 - 180.0


@dataclass
class KeyframeEntry:
    """Per-keyframe database record (the KeyFrame class, keyframe.h:33-86)."""
    t: float
    p_vio: np.ndarray
    q_vio: np.ndarray
    hist: np.ndarray            # BoW histogram over detected corners
    corner_desc: np.ndarray     # [M,256] BRIEF at freshly detected corners
    corner_norm: np.ndarray     # [M,2] normalized coords of those corners
    win_ids: np.ndarray         # [N] estimator feature ids (window points)
    win_desc: np.ndarray        # [N,256] BRIEF at projected window points
    win_X: np.ndarray           # [N,3] world 3-D of window points (VIO frame)


@dataclass
class LoopClosureNode:
    """detectLoop + findConnection + relocalization + PGO, ROS-free.

    Wire-up (estimator_node.cpp:406, pose_graph_node.cpp:524-548):
      est.process_frame(fm)
      if est.last_keyframe: node.on_keyframe(img, est.last_keyframe, est)
      p_corr, q_corr = node.correct_pose(p, q)   # vins_result_loop analog
    """
    cam: object
    graph: Optional[pg.PoseGraph] = None   # None → PoseGraph(device=device)
    n_corners: int = 300          # reference extracts 500 FAST (keyframe.cpp:87)
    exclude_recent: int = 50      # frame exclusion (pose_graph.cpp:317)
    top_k: int = 4                # query top-4 (pose_graph.cpp:317)
    retrieval: str = "direct"     # "direct" BRIEF set matching | "bow"
    sim_hi: Optional[float] = None  # best-score gate (None → per-retrieval
                                  # default)
    sim_lo_ratio: float = 0.45    # 2nd-candidate gate = sim_hi*ratio
    ham_thresh: int = 16          # direct-retrieval match radius (bits)
    ref_floor: float = 0.05       # min recent-window self-similarity used
                                  # as the normalizer
    min_inliers: int = 25         # MIN_LOOP_NUM (keyframe.h:15)
    skip_cnt: int = 0             # process every (skip_cnt+1)-th keyframe
    skip_dist: float = 0.0        # min translation between pose-graph kfs
    edge_rms_ref: float = 0.003   # kept for diagnostics dumps
    tic: Optional[np.ndarray] = None   # None → zeros(3)
    qic: Optional[np.ndarray] = None   # None → identity
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.graph is None:
            self.graph = pg.PoseGraph(device=self.device)
        self.tic = np.zeros(3) if self.tic is None else np.asarray(self.tic)
        self.qic = np.array([1.0, 0, 0, 0]) if self.qic is None \
            else np.asarray(self.qic)
        self.entries: list[KeyframeEntry] = []
        self.loops: list[dict] = []   # diagnostics of accepted loops
        if self.sim_hi is None:
            # placerec_eval's precision-1.0 operating points
            self.sim_hi = 0.9 if self.retrieval == "direct" else 0.32
        # direct-retrieval database: concatenated corner descriptors (rows
        # [: _desc_off[-1]] in use) + prefix offsets (one contiguous matrix
        # → retrieval is one product)
        self._desc_cat = torch.zeros(16 * self.n_corners, pg.BRIEF_BITS,
                                     dtype=torch.float32, device=self.device)
        self._desc_off = [0]
        self._skip = 0
        self._last_p: Optional[np.ndarray] = None
        self.R_ic = _lie(lie.quat_to_rot, self.qic)
        # funnel counters: where candidate loops die
        self.stats = {"queries": 0, "detected": 0, "verify_fail": 0,
                      "gate_fail": 0, "accepted": 0}
        self.gate_rejects: list = []   # (rel_yaw, |rel_t|) of gated pairs

    # ------------------------------------------------------------------

    def add_to_database(self, corner_desc) -> None:
        """Append one keyframe's corner descriptors to the direct-retrieval
        database."""
        d = torch.as_tensor(corner_desc, device=self.device)
        n0 = self._desc_off[-1]
        n1 = n0 + d.shape[0]
        if n1 > self._desc_cat.shape[0]:
            grown = torch.zeros(max(n1, 2 * self._desc_cat.shape[0]),
                                pg.BRIEF_BITS, dtype=torch.float32,
                                device=self.device)
            grown[:n0] = self._desc_cat[:n0]
            self._desc_cat = grown
        self._desc_cat[n0:n1] = d
        self._desc_off.append(n1)

    def keyframe_features(self, img, snap: dict):
        """The image work of one keyframe on the node's device: corners +
        BRIEF (KeyFrame::computeBRIEFPoint, keyframe.cpp:87+) and BRIEF at
        the window points' pixels (computeWindowBRIEFPoint). Returns
        (corner_desc, corner_norm, inb, win_desc, hist) as numpy."""
        imj = fe.as_image(img, self.device)
        H, W = imj.shape
        uv, _score, valid = fe.detect_features(
            imj, torch.zeros_like(imj), self.n_corners, min_dist=8)
        uv = uv[valid]
        corner_desc = pg.brief_descriptors(imj, uv)
        corner_norm = cameras.lift_projective(self.cam, uv)[:, :2]

        uv_w = np.asarray(snap["uv"])
        pt3 = np.concatenate([uv_w, np.ones((len(uv_w), 1))], -1)
        win_pix = cameras.space_to_plane(self.cam, torch.tensor(
            pt3, dtype=torch.float32, device=self.device)).cpu().numpy()
        inb = ((win_pix[:, 0] >= pg.PATCH_HALF + 2)
               & (win_pix[:, 0] < W - pg.PATCH_HALF - 2)
               & (win_pix[:, 1] >= pg.PATCH_HALF + 2)
               & (win_pix[:, 1] < H - pg.PATCH_HALF - 2))
        win_desc = pg.brief_descriptors(imj, torch.tensor(
            win_pix[inb], device=self.device))
        hist = pg.bow_histogram(corner_desc, torch.ones(
            len(corner_desc), device=self.device))
        return (corner_desc.cpu().numpy(), corner_norm.cpu().numpy(), inb,
                win_desc.cpu().numpy(), hist.cpu().numpy())

    def on_keyframe(self, img, snap: dict, est=None) -> Optional[int]:
        """Ingest one keyframe (rendered/camera image + estimator snapshot).

        Returns the matched older keyframe index when a loop was accepted
        and verified, else None. When `est` is given, verified matches are
        fed back as relocalization factors (setReloFrame parity)."""
        if self._skip > 0:
            self._skip -= 1
            return None
        if self._last_p is not None and self.skip_dist > 0 and \
                np.linalg.norm(snap["p"] - self._last_p) < self.skip_dist:
            return None
        self._skip = self.skip_cnt
        self._last_p = np.asarray(snap["p"], float)

        corner_desc, corner_norm, inb, win_desc, hist = \
            self.keyframe_features(img, snap)
        entry = KeyframeEntry(
            t=snap["t"], p_vio=np.asarray(snap["p"], float),
            q_vio=np.asarray(snap["q"], float), hist=hist,
            corner_desc=corner_desc, corner_norm=corner_norm,
            win_ids=np.asarray(snap["ids"])[inb],
            win_desc=win_desc, win_X=np.asarray(snap["X"])[inb])
        k = self.graph.add_keyframe(entry.p_vio, entry.q_vio, t=entry.t)
        assert k is None  # no gdesc → the graph never self-detects
        k = self.graph.n - 1
        self.entries.append(entry)
        self.add_to_database(corner_desc)

        self.stats["queries"] += 1
        cand = self._detect_loop(k, hist, corner_desc)
        if cand is None:
            return None
        self.stats["detected"] += 1
        got = self._verify(cand, entry)
        if got is None:
            return None
        self.stats["accepted"] += 1
        rel_t, rel_yaw, p_old_b, q_old_b, matches, n_inl, rms = got
        # information weight of the PGO residual: sigma = 0.03 + 0.3|t|,
        # weight 1/sigma normalized to ~1 at |t| = 0.15 m (the JAX
        # package's edge model), composing with the Huber robustifier
        t_norm = float(np.linalg.norm(rel_t))
        w = float(np.clip(0.075 / (0.03 + 0.3 * t_norm), 0.25, 2.5))
        self.graph.add_loop_edge(cand, k, rel_t, rel_yaw, weight=w)
        self.graph.optimize()
        self.loops.append({"old": cand, "new": k, "t": entry.t,
                           "inliers": n_inl, "rms": round(rms, 5),
                           "weight": round(w, 3)})
        if est is not None and len(matches) >= 6:
            # FAST_RELOCALIZATION feedback (pose_graph_node.cpp:524-535 →
            # estimator relocalization_callback → setReloFrame)
            est.set_relo_frame(p_old_b, q_old_b, matches)
        return cand

    # ------------------------------------------------------------------

    def _detect_loop(self, k: int, hist: np.ndarray,
                     corner_desc) -> Optional[int]:
        """detectLoop semantics (pose_graph.cpp:304-385): query top-4 among
        keyframes older than `exclude_recent`, accept when the best score
        clears sim_hi AND a second candidate clears sim_lo, return the
        EARLIEST candidate above sim_lo."""
        n_old = k - self.exclude_recent
        if n_old < 1:
            return None
        if self.retrieval == "direct":
            # score against all previous keyframes; the recent (excluded)
            # window's best score is the per-query normalizer
            off = np.asarray(self._desc_off[: k + 1])
            s_all = pg.direct_similarities(
                self._desc_cat[: off[-1]], off,
                torch.as_tensor(corner_desc, device=self.device),
                ham_thresh=self.ham_thresh)
            ref = max(float(s_all[n_old:].max(initial=0.0)), self.ref_floor)
            sims = s_all[:n_old] / ref
        else:
            hists = np.stack([e.hist for e in self.entries[:n_old]])
            sims = pg.idf_similarities(hists, hist)
        top = np.argsort(sims)[::-1][: self.top_k]
        sim_lo = self.sim_hi * self.sim_lo_ratio
        if sims[top[0]] <= self.sim_hi:
            return None
        others = top[1:]
        if not len(others) or sims[others].max() <= sim_lo:
            return None
        ok = top[sims[top] > sim_lo]
        return int(ok.min())

    def _verify(self, old_idx: int, cur: KeyframeEntry):
        """findConnection (keyframe.cpp:259-430): match the CURRENT window
        points (ids + world 3-D) against the OLD keyframe's detected
        corners, PnP-RANSAC the OLD camera pose in the current VIO world,
        gate on MIN_LOOP_NUM inliers. Returns (rel_t, rel_yaw, old body
        pose p, q, relo matches {id: pt3 in old frame}, inliers, rms)."""
        old = self.entries[old_idx]
        # PnP initial guess: the OLD keyframe's camera pose from VIO
        # (useExtrinsicGuess parity, keyframe.cpp PnPRANSAC)
        R_wb_old = _lie(lie.quat_to_rot, old.q_vio)
        R_wc = R_wb_old @ self.R_ic
        p_wc = np.asarray(old.p_vio, float) + R_wb_old @ self.tic
        got = pg.find_connection(
            torch.as_tensor(cur.win_desc, device=self.device), cur.win_X,
            torch.as_tensor(old.corner_desc, device=self.device),
            old.corner_norm, min_inliers=self.min_inliers, R0=R_wc.T,
            p0=p_wc, fail_stats=self.stats)
        if got is None:
            self.stats["verify_fail"] += 1
            return None
        R_cw, p_wc, n_inl, pairs, rms = got
        # camera → body pose of the OLD keyframe in the current VIO world
        R_wb = R_cw.T @ self.R_ic.T
        p_wb = p_wc - R_wb @ self.tic
        q_old_b = _lie(lie.rot_to_quat, R_wb)
        # loop_info: relative pose old→current (getLoopRelativeT/Yaw,
        # keyframe.h:54-66)
        rel_t = R_wb.T @ (cur.p_vio - p_wb)
        ypr_old = _lie(lie.rot_to_ypr, R_wb)
        ypr_cur = _lie(lambda q: lie.rot_to_ypr(lie.quat_to_rot(q)),
                       cur.q_vio)
        rel_yaw = float(_wrap_deg(ypr_cur[0] - ypr_old[0]))
        # sanity gates of the reference (keyframe.cpp:418-424):
        # |rel_yaw| < 30°, |rel_t| < 20 m
        if abs(rel_yaw) > 30.0 or np.linalg.norm(rel_t) > 20.0:
            self.stats["gate_fail"] += 1
            if len(self.gate_rejects) < 64:
                self.gate_rejects.append(
                    (round(rel_yaw, 1), round(float(np.linalg.norm(rel_t)), 2)))
            return None
        matches = {int(cur.win_ids[i]): np.append(old.corner_norm[j], 1.0)
                   for i, j in pairs}
        return rel_t, rel_yaw, p_wb, q_old_b, matches, n_inl, rms

    # ------------------------------------------------------------------

    def correct_pose(self, p, q):
        """Apply the current PGO drift to a VIO pose — the w_T_vio chaining
        every output pose goes through (pose_graph_node.cpp:501-503,
        pose_graph.cpp:561-575)."""
        g = self.graph
        Rz = _lie(lie.ypr_to_rot, [g.yaw_drift, 0.0, 0.0])
        p2 = Rz @ np.asarray(p, float) + g.t_drift
        q2 = _lie(lambda R, q_: lie.quat_mul(lie.rot_to_quat(R), q_),
                  Rz, np.asarray(q, float))
        return p2, q2
