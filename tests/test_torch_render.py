"""Port vs JAX: the textured-world renderer (utils/render.py), CPU.

The world is made from the same seed on both sides (the same numpy draws);
`render_rays` runs over a few hundred rays of a 160×120 camera at two poses
of the circuit trajectory, `backproject` over a few pixels. Tolerance
1e-6 on pixel values and the per-pixel rays; 1e-5 m on backprojected
points (float32 rays, float64 geometry, as in the JAX package).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils import render as jrender
from anticipated_vins_mono_tpu.utils.synthetic import \
    loop_trajectory as jloop
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils import render as trender
from anticipated_vins_mono_torch.utils.synthetic import \
    loop_trajectory as tloop

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    W, H = 160, 120
    cam = jcam.PinholeCamera.create(0.6 * W, 0.6 * W, W / 2, H / 2,
                                    k1=-0.2, k2=0.05, width=W, height=H)
    traj = jloop(20.0, laps=2.0, radius=3.0)
    jworld = jrender.make_box_world(traj.p, margin=5.0, seed=0)
    tworld = trender.make_box_world(traj.p, margin=5.0, seed=0,
                                    device="cpu")
    tcam = convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, cam),
                                     device="cpu")
    R_all = np.asarray(jlie.quat_to_rot(jnp.asarray(traj.q)))
    return cam, tcam, traj, jworld, tworld, R_all


def test_make_box_world_equals_jax(scene):
    _, _, traj, jworld, tworld, _ = scene
    for name in jworld._fields:
        a, b = getattr(tworld, name), np.asarray(getattr(jworld, name))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    same = convert.box_world_from_numpy(
        jax.tree_util.tree_map(np.asarray, jworld), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(same, tworld))


def test_loop_trajectory_equals_jax():
    a, b = tloop(4.0, laps=1.0, wiggle=0.1), jloop(4.0, laps=1.0, wiggle=0.1)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


def test_camera_rays_equal_jax(scene):
    cam, tcam, *_ = scene
    np.testing.assert_allclose(trender.camera_rays(tcam).numpy(),
                               np.asarray(jrender.camera_rays(cam)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [0, 1130])
def test_render_rays_equal_jax(scene, k):
    cam, tcam, traj, jworld, tworld, R_all = scene
    rays = np.asarray(jrender.camera_rays(cam))
    sel = np.random.default_rng(k).choice(len(rays), 400, replace=False)
    p = traj.p[k].astype(np.float32)
    R = R_all[k].astype(np.float32)
    ref = np.asarray(jrender.render_rays(jworld, jnp.asarray(rays[sel]),
                                         jnp.asarray(p), jnp.asarray(R)))
    out = trender.render_rays(tworld, torch.tensor(rays[sel]),
                              torch.tensor(p), torch.tensor(R)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert out.std() > 0.05              # textured, not flat


def test_render_frame_and_backproject_equal_jax(scene):
    cam, tcam, traj, jworld, tworld, R_all = scene
    k = 400
    img = trender.render_frame(tworld, tcam, trender.camera_rays(tcam),
                               traj.p[k], R_all[k])
    assert img.shape == (120, 160) and img.dtype == torch.float32
    uv = np.array([[10.0, 12.0], [80.0, 60.0], [150.5, 100.25]])
    ref = jrender.backproject(jworld, cam, uv, traj.p[k], R_all[k])
    out = trender.backproject(tworld, tcam, uv, traj.p[k], R_all[k])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # a backprojected point lies on a wall of the box
    lo, hi = tworld.lo.numpy(), tworld.hi.numpy()
    on_wall = np.isclose(out, lo, atol=1e-4) | np.isclose(out, hi, atol=1e-4)
    assert on_wall.any(axis=1).all()


def test_hash_wraps_in_int32():
    """The lattice hash's products overflow int32 and wrap, as in JAX."""
    ix = torch.tensor([40000, -7, 123456], dtype=torch.int32)
    iy = torch.tensor([3, 99999, -5], dtype=torch.int32)
    iz = torch.tensor([-60000, 1, 77], dtype=torch.int32)
    ref = np.asarray(jrender._hash3(jnp.asarray(ix.numpy()),
                                    jnp.asarray(iy.numpy()),
                                    jnp.asarray(iz.numpy())))
    np.testing.assert_array_equal(trender._hash3(ix, iy, iz).numpy(), ref)
