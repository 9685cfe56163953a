"""Padded landmark database — host-side feature manager.

Counterpart of `anticipated_vins_mono_tpu/models/feature_db.py`, copied
line for line: it is plain numpy in both packages, and the port keeps its
own copy instead of importing the JAX package.

Capability parity with the reference FeatureManager
(vins_estimator/src/feature_manager.{h,cpp}): the `list<FeaturePerId>` of
per-landmark observation tracks becomes a set of fixed-size numpy arrays
(slots) that map 1:1 onto the solver's static [F, NF] measurement tensors —
the host mutates, the device consumes.

Implements:
- observation insertion + slot allocation          (addFeatureCheckParallax, :45-97)
- keyframe decision by mean parallax               (compensatedParallax2, :99-139)
- window slide with anchor re-anchoring            (removeBackShiftDepth, :275-313)
- second-newest frame removal                      (removeFront, :333-353)
- outlier / failure removal                        (removeFailures, removeOutlier)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_PARALLAX_DEFAULT = 10.0 / 460.0  # MIN_PARALLAX pixels / FOCAL (parameters.cpp:79-82)


@dataclass
class FeatureDB:
    max_feats: int
    nf: int  # window + 1 frames

    def __post_init__(self):
        F, NF = self.max_feats, self.nf
        self.ids = np.full(F, -1, np.int64)          # -1 = free slot
        self.pts = np.zeros((F, NF, 3))
        self.vel = np.zeros((F, NF, 2))
        self.prob = np.ones(F)                        # tracking probability
        self.mask = np.zeros((F, NF))
        self.inv_depth = np.ones(F)
        self.solved = np.zeros(F)                     # depth estimated flag
        self.last_obs_count = 0

    # ------------------------------------------------------------------
    # insertion + keyframe decision
    # ------------------------------------------------------------------

    def add_frame(self, frame_idx: int, feats: dict,
                  min_parallax: float = MIN_PARALLAX_DEFAULT) -> bool:
        """Insert observations {id: (pt3, vel2, prob)} at `frame_idx`.

        Returns True if the *previous* frame should be a keyframe — the
        parallax test of addFeatureCheckParallax (feature_manager.cpp:45-97):
        keyframe if few tracked features (<20) or mean parallax between
        frames NF-3 and NF-2 exceeds the threshold.
        """
        tracked = 0
        for fid, (pt, vel, prob) in feats.items():
            slot = self._find(fid)
            if slot < 0:
                slot = self._alloc(fid, frame_idx)
                if slot < 0:
                    continue  # DB full — drop (reference list is unbounded)
            else:
                tracked += 1
            self.pts[slot, frame_idx] = pt
            self.vel[slot, frame_idx] = vel
            self.prob[slot] = prob
            self.mask[slot, frame_idx] = 1.0
            # Anchor-velocity backfill: the front end cannot know a
            # feature's image velocity at its FIRST observation and emits
            # the 0-sentinel (feature_tracker.cpp pts_velocity for new
            # points; frontend.process:554). That first observation is
            # exactly the td factor's ANCHOR (projection_td_factor.cpp:
            # 50-52 corrects BOTH endpoints by td·vel) — leaving it 0
            # silently drops the anchor-side correction and biases td
            # toward 0 (measured: analytic 20 s recovers 0.94 ms of an
            # injected 5 ms; with true first-obs velocities 3.7 ms and
            # climbing — results/r4/td_anchor_vel.json). The velocity
            # becomes known one frame later: copy it back (constant-
            # velocity approx over one frame interval).
            if (frame_idx > 0 and self.mask[slot, frame_idx - 1] > 0
                    and not np.any(self.vel[slot, frame_idx - 1])):
                self.vel[slot, frame_idx - 1] = vel
        self.last_obs_count = tracked

        if frame_idx < 2 or tracked < 20:
            return True
        par = self._mean_parallax(frame_idx)
        return bool(par >= min_parallax)

    def _find(self, fid: int) -> int:
        hit = np.nonzero(self.ids == fid)[0]
        return int(hit[0]) if hit.size else -1

    def _alloc(self, fid: int, frame_idx: int = 0) -> int:
        free = np.nonzero(self.ids < 0)[0]
        if free.size:
            s = int(free[0])
        else:
            # DB full: evict a JUNK slot — a track not observed in the
            # previous frame with <2 total observations can never become a
            # factor (the tracker cannot revisit a lost id), it is pure
            # slot waste. Without eviction, one tracker dropout frame
            # (LK dip) fills every slot with dead 1-obs tracks that take
            # ~NF slides to GC, and track continuity never rebuilds
            # (measured: tracked count decays 12→1 while the tracker
            # itself reports 120+ stable ids — the SfM init starves).
            junk = np.nonzero(
                (self.ids >= 0)
                & (self.mask[:, max(frame_idx - 1, 0)] <= 0)
                & (self.mask[:, frame_idx] <= 0)   # not just inserted —
                # without this the slot JUST filled for the previous new
                # feature of this same frame is immediately re-evicted
                & (self.mask.sum(1) < 2))[0]
            if not junk.size:
                return -1
            s = int(junk[0])
        self.ids[s] = fid
        self.pts[s] = 0
        self.vel[s] = 0
        self.mask[s] = 0
        self.inv_depth[s] = 1.0
        self.solved[s] = 0
        return s

    def _mean_parallax(self, frame_idx: int) -> float:
        """Mean image-plane distance of features seen in frames idx-2 and
        idx-1 (compensatedParallax2 without rotation compensation — the
        reference computes the same du/dv distance, :99-139)."""
        i, j = frame_idx - 2, frame_idx - 1
        both = (self.mask[:, i] > 0) & (self.mask[:, j] > 0)
        if not both.any():
            return 0.0
        d = self.pts[both, i, :2] - self.pts[both, j, :2]
        return float(np.mean(np.linalg.norm(d, axis=-1)))

    # ------------------------------------------------------------------
    # views for the solver
    # ------------------------------------------------------------------

    @property
    def anchor(self) -> np.ndarray:
        m = self.mask > 0
        a = np.argmax(m, axis=1).astype(np.int32)
        return a

    @property
    def feat_valid(self) -> np.ndarray:
        return ((self.ids >= 0) & (self.mask.sum(1) >= 2)).astype(float)

    # ------------------------------------------------------------------
    # window slide
    # ------------------------------------------------------------------

    def slide_oldest(self, R0, p0, R1, p1, tic, Ric):
        """MARGIN_OLD: drop frame 0, shift left, re-anchor depths.

        Landmarks anchored at frame 0 with more observations move their
        anchor to the next observing frame; inverse depth is re-expressed
        there by transforming the 3-D point (removeBackShiftDepth,
        feature_manager.cpp:275-313). R0/p0: old frame-0 pose; R1/p1: the
        frame that becomes the new anchor base (old frame 1).
        """
        anchored0 = (self.ids >= 0) & (self.mask[:, 0] > 0)
        for s in np.nonzero(anchored0)[0]:
            obs_after = self.mask[s, 1:].sum()
            if obs_after < 1:
                self._free(s)
                continue
            if self.solved[s]:
                # point in old anchor cam → world → new base cam
                pt = self.pts[s, 0] / max(self.inv_depth[s], 1e-6)
                pw = R0 @ (Ric @ pt + tic) + p0
                pc = Ric.T @ (R1.T @ (pw - p1) - tic)
                if pc[2] > 0.1:
                    self.inv_depth[s] = 1.0 / pc[2]
                else:
                    self.inv_depth[s] = 1.0 / 5.0
                    self.solved[s] = 0
        # shift all tracks left
        self.pts[:, :-1] = self.pts[:, 1:]
        self.vel[:, :-1] = self.vel[:, 1:]
        self.mask[:, :-1] = self.mask[:, 1:]
        self.pts[:, -1] = 0
        self.vel[:, -1] = 0
        self.mask[:, -1] = 0
        self._gc()

    def slide_second_newest(self):
        """MARGIN_SECOND_NEW: delete frame NF-2's observations and move the
        newest frame down one slot (removeFront, feature_manager.cpp:333-353)."""
        k = self.nf - 2
        self.pts[:, k] = self.pts[:, k + 1]
        self.vel[:, k] = self.vel[:, k + 1]
        self.mask[:, k] = self.mask[:, k + 1]
        self.pts[:, k + 1] = 0
        self.vel[:, k + 1] = 0
        self.mask[:, k + 1] = 0
        self._gc()

    def remove_outliers(self, bad_slots):
        for s in np.asarray(bad_slots, dtype=int):
            self._free(s)

    def _free(self, s: int):
        self.ids[s] = -1
        self.mask[s] = 0
        self.solved[s] = 0

    def _gc(self):
        """Free slots whose tracks fell below 1 observation."""
        dead = (self.ids >= 0) & (self.mask.sum(1) < 1)
        for s in np.nonzero(dead)[0]:
            self._free(s)
