"""Place-recognition fidelity evaluation: precision/recall of keyframe
retrieval against ground-truth revisits.

Counterpart of `anticipated_vins_mono_tpu/utils/placerec_eval.py`. Renders
keyframes along a multi-lap circuit, labels pairs by ground-truth pose
proximity, sweeps the similarity threshold → P/R curve, and reports the
per-query top-1 behaviour `LoopClosureNode` relies on. Scorers:

- ``bow``    — 512-random-word sqrt-tf/idf histogram cosine
  (posegraph.bow_histogram / idf_similarities)
- ``direct`` — brute-force BRIEF set matching
  (posegraph.direct_similarities), normalized by the recent window's best
  score; ``direct-raw`` unnormalized.

Rendering dominates the cost, so raw descriptors can be cached (`cache=`, an
.npz path; `results/placerec_cache.npz` is the one `.gitignore` lists). The
default writes no file. Where the two differ: `device` (renderer, detection,
BRIEF and the retrieval products; default the card).

    python3 -m anticipated_vins_mono_torch.utils.placerec_eval
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from anticipated_vins_mono_torch.models import frontend as fe
from anticipated_vins_mono_torch.models import posegraph as pg
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.utils import render
from anticipated_vins_mono_torch.utils.synthetic import loop_trajectory


def build_keyframe_data(duration: float = 60.0, laps: float = 3.0,
                        radius: float = 3.0, kf_hz: float = 2.0,
                        n_corners: int = 300, seed: int = 0,
                        cam=None, cache: str | None = None, device="cuda"):
    """Render keyframes along the circuit → (desc [T,256] uint8 concat,
    off [K+1], positions [K,3], view dirs [K,3]). Cached in `cache` npz."""
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["desc"], z["off"], z["pos"], z["view"]
    cam = cam or cameras.euroc_camera(device=device)
    gt = loop_trajectory(duration, laps=laps, radius=radius)
    world = render.make_box_world(gt.p, margin=5.0, seed=seed,
                                  device=cam.fx.device)
    rays = render.camera_rays(cam)
    R_all = lie.quat_to_rot(torch.tensor(gt.q)).numpy()
    stride = int(round(200.0 / kf_hz))
    ks = np.arange(0, len(gt.t), stride)
    descs, pos, view = [], [], []
    for k in ks:
        img = render.render_frame(world, cam, rays, gt.p[k], R_all[k])
        uv, _score, valid = fe.detect_features(img, torch.zeros_like(img),
                                               n_corners, 12)
        descs.append(pg.brief_descriptors(img, uv[valid]).cpu().numpy()
                     .astype(np.uint8))
        pos.append(gt.p[k])
        view.append(R_all[k][:, 2])     # camera forward = body +z
    off = np.concatenate([[0], np.cumsum([len(d) for d in descs])])
    desc = np.concatenate(descs)
    pos, view = np.stack(pos), np.stack(view)
    if cache:
        np.savez_compressed(cache, desc=desc, off=off, pos=pos, view=view)
    return desc, off, pos, view


def _labels(pos, view, i, js, dist_thresh, cosa):
    d = np.linalg.norm(pos[js] - pos[i], axis=1)
    a = view[js] @ view[i]
    return (d < dist_thresh) & (a > cosa)


def make_scorer(kind: str, desc, off, ham_thresh: int = 16,
                ref_floor: float = 0.05, device="cuda"):
    """Return scorer(i, js) → similarities of keyframe i vs keyframes js
    (js = causal contiguous 0..n). All scorers only see the causal past.
    The descriptors go to `device` once."""
    desc_t = torch.as_tensor(desc, device=device)
    if kind in ("direct", "direct-raw"):
        def scorer(i, js):
            n = len(js)
            s_all = pg.direct_similarities(
                desc_t[: off[i]], off[: i + 1],
                desc_t[off[i]: off[i + 1]], ham_thresh=ham_thresh)
            if kind == "direct-raw":
                return s_all[:n]
            ref = max(float(s_all[n:].max(initial=0.0)), ref_floor)
            return s_all[:n] / ref
        return scorer
    hists = []
    for k in range(len(off) - 1):
        d = desc_t[off[k]: off[k + 1]]
        hists.append(pg.bow_histogram(d, torch.ones(len(d), device=device))
                     .cpu().numpy())
    hists = np.stack(hists)

    def scorer(i, js):
        return pg.idf_similarities(hists[js], hists[i])
    return scorer


def pr_curve(scorer, pos, view, K, exclude: int = 20,
             dist_thresh: float = 0.6, angle_thresh_deg: float = 25.0):
    """Label every (i, j<i-exclude) pair by GT revisit; sweep threshold."""
    sims, labels = [], []
    cosa = np.cos(np.radians(angle_thresh_deg))
    for i in range(exclude + 1, K):
        js = np.arange(0, i - exclude)
        sims.append(scorer(i, js))
        labels.append(_labels(pos, view, i, js, dist_thresh, cosa))
    sims = np.concatenate(sims)
    labels = np.concatenate(labels)
    order = np.argsort(sims)[::-1]
    tp = np.cumsum(labels[order])
    fp = np.cumsum(~labels[order])
    n_pos = labels.sum()
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(n_pos, 1)
    return sims[order], precision, recall, int(n_pos), int(len(labels))


def best_query_eval(scorer, pos, view, K, exclude: int = 20,
                    dist_thresh: float = 0.6, angle_thresh_deg: float = 25.0,
                    sim_hi: float = 0.32):
    """Per-query top-1 evaluation — the way detectLoop uses the database:
    for every keyframe with ≥1 true revisit, does the best-scoring candidate
    (above threshold) land on a true revisit?"""
    cosa = np.cos(np.radians(angle_thresh_deg))
    n_q = n_hit = n_false = 0
    for i in range(exclude + 1, K):
        js = np.arange(0, i - exclude)
        lab = _labels(pos, view, i, js, dist_thresh, cosa)
        s = scorer(i, js)
        best = int(np.argmax(s))
        fired = s[best] > sim_hi
        if lab.any():
            n_q += 1
            if fired and lab[best]:
                n_hit += 1
        elif fired:
            n_false += 1
    return {"queries_with_revisit": n_q, "top1_hits": n_hit,
            "false_fires": n_false,
            "recall_top1": n_hit / max(n_q, 1)}


def eval_scorer(kind, desc, off, pos, view, sim_hi, ham_thresh=16,
                device="cuda"):
    scorer = make_scorer(kind, desc, off, ham_thresh=ham_thresh,
                         device=device)
    K = len(off) - 1
    sims, prec, rec, n_pos, n_pairs = pr_curve(scorer, pos, view, K)
    r_at_p100 = float(rec[prec >= 1.0].max()) if (prec >= 1.0).any() else 0.0
    r_at_p99 = float(rec[prec >= 0.99].max()) if (prec >= 0.99).any() else 0.0
    t_at_p100 = float(sims[prec >= 1.0][np.argmax(rec[prec >= 1.0])]) \
        if (prec >= 1.0).any() else None
    return {
        "scorer": kind, "sim_hi": sim_hi,
        "keyframes": K, "positive_pairs": n_pos, "pairs": n_pairs,
        "recall_at_precision_1.0": r_at_p100,
        "recall_at_precision_0.99": r_at_p99,
        "sim_threshold_at_precision_1.0": t_at_p100,
        "top1": best_query_eval(scorer, pos, view, K, sim_hi=sim_hi),
    }


def main(duration=60.0, laps=3.0, seed=0, cache=None, out=None,
         device="cuda"):
    desc, off, pos, view = build_keyframe_data(duration, laps, seed=seed,
                                               cache=cache, device=device)
    rows = [eval_scorer("bow", desc, off, pos, view, sim_hi=0.32,
                        device=device),
            eval_scorer("direct-raw", desc, off, pos, view, sim_hi=0.10,
                        device=device),
            eval_scorer("direct", desc, off, pos, view, sim_hi=0.9,
                        device=device)]
    result = {"benchmark": "place_recognition", "rows": rows}
    print(json.dumps(result))
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--laps", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.duration, a.laps, a.seed, a.cache, a.out, a.device)
