"""Port vs JAX: the camera models (ops/cameras.py), CPU.

The same random points and pixels go through the JAX function and the
port's, for each of the four models (the EuRoC radtan pinhole included),
in float32 and float64. Tolerance: relative to the output's scale
(`atol = rtol · max|ref|`), 1e-6 in float32 and 1e-12 in float64; the
undistortion is the same fixed 20-step contraction in both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_torch.ops import cameras as tcam
from anticipated_vins_mono_torch.utils import convert

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-12}

POLY = [-180.0, 0.0, 1.6e-3, -2.0e-6, 4.0e-9]
INV_POLY = [290.0, 170.0, -10.0, 20.0, 8.0, -3.0, 1.0, 0.5, -0.2, 0.1,
            0.03, -0.01]

# model name → constructor(module, dtype, **device keyword of the port)
MODELS = {
    "euroc": lambda m, dt, **kw: m.euroc_camera(dtype=dt, **kw),
    "pinhole": lambda m, dt, **kw: m.PinholeCamera.create(
        400.0, 410.0, 376.0, 240.0, k1=-0.2, k2=0.05, p1=1e-3, p2=-2e-3,
        dtype=dt, **kw),
    "equidistant": lambda m, dt, **kw: m.EquidistantCamera.create(
        380.8, 380.3, 376.8, 240.5, k2=-0.011, k3=0.021, k4=-0.021,
        k5=0.0065, dtype=dt, **kw),
    "mei": lambda m, dt, **kw: m.MeiCamera.create(
        xi=0.9, fx=700.0, fy=700.0, cx=376.0, cy=240.0, k1=-0.1, k2=0.02,
        dtype=dt, **kw),
    "scaramuzza": lambda m, dt, **kw: m.ScaramuzzaCamera.create(
        POLY, INV_POLY, c=1.001, d=0.002, e=-0.001, cx=376.0, cy=240.0,
        dtype=dt, **kw),
}
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}
TDT = {np.float32: torch.float32, np.float64: torch.float64}


def _cams(name, dt):
    jc = MODELS[name](jcam, JDT[dt])
    tc = MODELS[name](tcam, TDT[dt], device="cpu")
    return jc, tc


def _check(ref, out, dt):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.dtype == ref.dtype == dt
    rtol = RTOL[dt]
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_space_to_plane_and_lift_projective_equal_jax(name, dt):
    rng = np.random.default_rng(sorted(MODELS).index(name))
    jc, tc = _cams(name, dt)
    z = rng.uniform(1.0, 6.0, (200, 1))
    P = np.concatenate([rng.uniform(-0.5, 0.5, (200, 2)) * z, z], -1)
    if name == "scaramuzza":
        P[:, 2] *= -1.0            # the mirror looks along −z
    P = P.astype(dt)
    _check(jcam.space_to_plane(jc, jnp.asarray(P)),
           tcam.space_to_plane(tc, torch.tensor(P, device="cpu")), dt)
    uv = np.stack([rng.uniform(120, 632, 200), rng.uniform(80, 400, 200)],
                  -1).astype(dt)
    _check(jcam.lift_projective(jc, jnp.asarray(uv)),
           tcam.lift_projective(tc, torch.tensor(uv, device="cpu")), dt)


def test_camera_from_numpy_carries_every_model():
    for name in sorted(MODELS):
        jc = MODELS[name](jcam, jnp.float64)
        tc = convert.camera_from_numpy(
            jax.tree_util.tree_map(np.asarray, jc), device="cpu")
        assert type(tc).__name__ == type(jc).__name__
        assert (tc.width, tc.height) == (752, 480)
        uv = np.array([[300.0, 200.0], [500.0, 100.0]])
        np.testing.assert_allclose(
            tcam.lift_projective(tc, torch.tensor(uv)).numpy(),
            np.asarray(jcam.lift_projective(jc, jnp.asarray(uv))),
            rtol=1e-12, atol=1e-12)


def test_unknown_camera_type_raises():
    with pytest.raises(TypeError):
        tcam.lift_projective(object(), torch.zeros(1, 2))
