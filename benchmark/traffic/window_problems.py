"""Window problems of the batched-solve cells.

`window_problem` is a copy of the port's `utils/synthetic.make_window_problem`
(same draws, in the same order, from `numpy.random.default_rng(seed)`): one
full 10-keyframe window over the analytic trajectory with its ground truth,
the IMU pairs preintegrated (by the reference's float64 `preintegrate`) and
landmark observations with pixel noise. It returns plain nested dicts of
float64 CPU tensors, from which each side builds its own containers.

`scenario_batch` tiles a few distinct problems to a batch of B and gives
every element its own perturbation of the initial state, drawn on the
device from the seed, with the magnitudes `window_problem` uses: so no two
elements are the same scenario, and B problems cost the set-up of a few.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import lie
from benchmark.reference.preintegration import ImuNoise, preintegrate
from benchmark.traffic.trajectories import (analytic_trajectory, quat_to_rot,
                                            sample_landmarks)

FOCAL_LENGTH = 460.0
STATE_KEYS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth")


def window_problem(window: int, max_feats: int, seed: int,
                   pixel_noise: float, perturb: float,
                   frame_hz: float = 10.0, imu_rate: float = 200.0) -> dict:
    """{"gt", "init", "meas"} of one window problem (no IMU noise, zero
    biases, extrinsic tic = (0.05, 0.02, 0), qic = identity)."""
    rng = np.random.default_rng(seed)
    nf = window + 1
    traj = analytic_trajectory(window / frame_hz + 0.01, imu_rate)
    # the port draws the (zero-scaled) biases and the IMU noise here; the
    # draws are kept so that the later ones come out the same
    rng.normal(size=3)
    rng.normal(size=3)
    rng.normal(size=traj.acc_body.shape)
    rng.normal(size=traj.gyr_body.shape)

    stride = int(round(imu_rate / frame_hz))
    fidx = np.arange(nf) * stride
    tic, qic = np.array([0.05, 0.02, 0.0]), np.array([1.0, 0.0, 0.0, 0.0])
    t64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))

    starts = fidx[:-1]
    samp = starts[:, None] + 1 + np.arange(stride)[None, :]
    pre = preintegrate(
        t64(np.full((window, stride), 1.0 / imu_rate)),
        t64(traj.acc_body[samp]), t64(traj.gyr_body[samp]),
        t64(traj.acc_body[starts]), t64(traj.gyr_body[starts]),
        t64(np.zeros((window, 3))), t64(np.zeros((window, 3))), ImuNoise())

    F = max_feats
    lms = sample_landmarks(traj, F, rng)
    R_bw = quat_to_rot(traj.q[fidx])
    R_ic = quat_to_rot(qic)
    pts = np.zeros((F, nf, 3))
    mask = np.zeros((F, nf))
    for j in range(nf):
        P_b = np.einsum("ij,nj->ni", R_bw[j].T, lms - traj.p[fidx[j]])
        P_c = np.einsum("ij,nj->ni", R_ic.T, P_b - tic)
        z = P_c[:, 2]
        ok = (z > 0.5) & (np.abs(P_c[:, 0] / np.maximum(z, 1e-6)) < 0.55) & \
             (np.abs(P_c[:, 1] / np.maximum(z, 1e-6)) < 0.42)
        ptsj = P_c / np.maximum(z[:, None], 1e-6)
        if pixel_noise > 0:
            ptsj[:, :2] += rng.normal(size=(F, 2)) * pixel_noise / FOCAL_LENGTH
        ptsj[:, 2] = 1.0
        pts[:, j] = ptsj
        mask[:, j] = ok

    feat_valid = (mask.sum(1) >= 2).astype(float)
    anchor = np.argmax(mask > 0, axis=1).astype(np.int32)
    inv_depth = np.ones(F)
    for l in range(F):
        a = anchor[l]
        P_c = R_ic.T @ (R_bw[a].T @ (lms[l] - traj.p[fidx[a]]) - tic)
        inv_depth[l] = 1.0 / max(P_c[2], 0.1)

    zeros3 = np.zeros((nf, 3))
    gt = dict(p=traj.p[fidx], q=traj.q[fidx], v=traj.v[fidx], ba=zeros3,
              bg=zeros3, tic=tic, qic=qic, td=np.zeros(()),
              inv_depth=inv_depth)

    def pert(shape, s):
        out = rng.normal(size=shape) * s
        out[0] = 0
        return out

    dth = pert((nf, 3), perturb * 0.02)
    q_init = lie.quat_mul(t64(gt["q"]), lie.exp_so3_quat(t64(dth))).numpy()
    init = dict(gt, p=gt["p"] + pert((nf, 3), perturb * 0.05), q=q_init,
                v=gt["v"] + pert((nf, 3), perturb * 0.05),
                inv_depth=inv_depth * (1 + rng.normal(size=F) * 0.05 * perturb))
    meas = dict(pre=dict(pre._asdict()), pre_valid=np.ones(window), pts=pts,
                vel=np.zeros((F, nf, 2)), mask=mask,
                anchor=torch.as_tensor(anchor), feat_valid=feat_valid)
    conv = lambda d: {k: (v if torch.is_tensor(v) or v is None
                          else t64(v)) if not isinstance(v, dict) else conv(v)
                      for k, v in d.items()}
    return {"gt": conv(gt), "init": conv(init), "meas": conv(meas)}


def problem_seeds(seed: int, n: int) -> list:
    """The seeds of a run's `n` distinct problems, drawn from its seed."""
    return [int(s) for s in np.random.default_rng(seed).integers(0, 2**31, n)]


def problem_of(B: int, n: int) -> torch.Tensor:
    """[B] the problem of each batch element: `n` problems in contiguous
    blocks of ⌈B/n⌉ elements, so that each half of the batch holds
    different problems."""
    return torch.arange(B) // -(-B // n)


def _tile(x: torch.Tensor, B: int, device) -> torch.Tensor:
    return x.to(device)[problem_of(B, x.shape[0]).to(device)].contiguous()


def scenario_batch(problems: list, B: int, seed: int, perturb: float,
                   device) -> dict:
    """{"gt", "init", "meas"} with every leaf stacked to [B, ...] in
    float64 on `device`: element b is problem `problem_of(B, n)[b]`, its
    initial state the ground truth perturbed by draws of a generator on
    `device` seeded from `seed` (first pose kept, the gauge; rotation
    N(0, 0.02·perturb) rad, position and velocity N(0, 0.05·perturb), inverse
    depth × (1 + N(0, 0.05·perturb)), biases zero)."""
    def stack(get):
        return torch.stack([get(p) for p in problems])

    def tree(get_root):
        def walk(template, path):
            if isinstance(template, dict):
                return {k: walk(v, path + (k,)) for k, v in template.items()}

            def leaf(p):
                x = p[get_root]
                for k in path:
                    x = x[k]
                return x
            return _tile(stack(leaf), B, device)
        return walk(problems[0][get_root], ())

    gt, meas = tree("gt"), tree("meas")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    kw = dict(dtype=torch.float64, device=device, generator=gen)
    nf, F = gt["p"].shape[1], gt["inv_depth"].shape[1]
    first = torch.ones(nf, 1, dtype=torch.float64, device=device)
    first[0] = 0.0
    dth = torch.randn(B, nf, 3, **kw) * (perturb * 0.02) * first
    dp = torch.randn(B, nf, 3, **kw) * (perturb * 0.05) * first
    dv = torch.randn(B, nf, 3, **kw) * (perturb * 0.05) * first
    dd = torch.randn(B, F, **kw) * (0.05 * perturb)
    init = dict(gt, p=gt["p"] + dp,
                q=lie.quat_mul(gt["q"], lie.exp_so3_quat(dth)),
                v=gt["v"] + dv, inv_depth=gt["inv_depth"] * (1 + dd),
                ba=torch.zeros_like(gt["ba"]), bg=torch.zeros_like(gt["bg"]))
    return {"gt": gt, "init": init, "meas": meas}
