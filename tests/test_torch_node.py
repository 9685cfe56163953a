"""Port vs JAX: the native library (native/) and the streaming node
(models/node.py), float64, CPU.

Native: the port's C++ aligner, built from its own copy of the source,
equals the port's `_PyAligner` and the JAX package's aligner on the stream
of `tests/test_native.py::test_aligner_batches` (1e-12), and the Hamming
matcher equals numpy exactly. These need `g++` and skip only without it.

Node: `tests/test_estimator.py::test_vio_node_streaming_matches_batch`
(25 frames of `analytic_trajectory(3.0)`, window 6, 64 slots) on both
packages. The port's `VioNode` against the JAX `VioNode` on the 0.3 px
stream the port's host-chain tests use: p within 1e-4 every frame, the
reference's host/device bound (at 0.5 px the two host chains part by
1.5e-4 at frame 24 through the marginalization's eigenvalue cut, ROADMAP
queue C (b)). The JAX test's own check on the port: node against direct
feeding within 5e-2, at 0.5 px.
"""

import shutil

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu import native as jnative
from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JEst
from anticipated_vins_mono_tpu.models.node import VioNode as JNode
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.utils.sequence import SequenceSimulator as JSim
from anticipated_vins_mono_tpu.utils.synthetic import \
    analytic_trajectory as jtraj
from anticipated_vins_mono_torch import native as tnative
from anticipated_vins_mono_torch.models.estimator import VioEstimator as TEst
from anticipated_vins_mono_torch.models.node import VioNode as TNode
from anticipated_vins_mono_torch.models.node import _PyAligner
from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator as TSim
from anticipated_vins_mono_torch.utils.synthetic import \
    analytic_trajectory as ttraj

torch.set_num_threads(1)

CFG = dict(window=6, max_feats=64, iters=6)
N_FRAMES = 25


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native library cannot be built")


def _aligner_stream(al):
    """The stream and frame calls of test_native.py::test_aligner_batches."""
    for k in range(100):
        al.push_imu(k * 0.005, [0.1 * k, 0, 9.8], [0, 0, 0.01 * k])
    return [al.frame_batch(0.1), al.frame_batch(0.2501),
            al.frame_batch(2.0)]


def test_native_aligner_equals_plain_and_jax(gxx):
    out = _aligner_stream(tnative.MeasurementAligner())
    plain = _aligner_stream(_PyAligner())
    ref = _aligner_stream(jnative.MeasurementAligner())
    assert out[2] is None and plain[2] is None and ref[2] is None
    for o, p, r in zip(out[:2], plain[:2], ref[:2]):
        for a, b, c in zip(o, p, r):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[0][0].sum(), 0.1, atol=1e-9)
    np.testing.assert_allclose(out[1][0].sum(), 0.1501, atol=1e-9)


def test_native_builds_into_build_dir(gxx):
    lib = tnative.get_lib()
    assert tnative._lib_path().exists()
    assert tnative._lib_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert lib is tnative.get_lib()


@pytest.mark.parametrize("n1,n2", [(20, 30), (1, 7)])
def test_hamming_matches_numpy(gxx, n1, n2):
    rng = np.random.default_rng(n1)
    b1 = rng.random((n1, 256)) > 0.5
    b2 = rng.random((n2, 256)) > 0.5
    out = tnative.hamming_all_pairs(tnative.pack_descriptors(b1),
                                    tnative.pack_descriptors(b2))
    ref = (b1[:, None, :] ^ b2[None, :, :]).sum(-1)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, jnative.hamming_all_pairs(jnative.pack_descriptors(b1),
                                       jnative.pack_descriptors(b2)))


def test_native_csv_equals_jax(gxx, tmp_path):
    """The native EuRoC ground-truth loader on a small 17-column file with
    a header, as the JAX package's native loader reads it."""
    rng = np.random.default_rng(2)
    rows = np.concatenate([(1403636579758555392 + 5_000_000 * np.arange(
        12))[:, None].astype(float), rng.normal(size=(12, 16))], 1)
    path = tmp_path / "data.csv"
    path.write_text("#timestamp, p_RS_R_x [m], ...\n" + "\n".join(
        ",".join(f"{v:.9f}" if k else f"{int(v)}" for k, v in enumerate(r))
        for r in rows) + "\n")
    out = tnative.load_euroc_csv(str(path), max_rows=50)
    ref = jnative.load_euroc_csv(str(path), max_rows=50)
    assert len(out["t"]) == 12
    for key in ("t", "p", "q", "v", "bg", "ba"):
        np.testing.assert_array_equal(out[key], ref[key])
    np.testing.assert_allclose(out["p"], rows[:, 1:4], rtol=0, atol=1e-9)
    with pytest.raises(FileNotFoundError):
        tnative.load_euroc_csv(str(tmp_path / "missing.csv"))


def _stream(node, traj, frames):
    """IMU and features pushed in timestamp order, IMU first at a tie."""
    for k in range(len(traj.t)):
        node.push_imu(traj.t[k], traj.acc_body[k], traj.gyr_body[k])
        for fm in frames:
            if abs(fm.t - traj.t[k]) < 1e-9:
                node.push_features(fm.t, fm.feats)


def _init(traj):
    return {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}


@pytest.fixture(scope="module")
def jax_node_p():
    traj = jtraj(3.0)
    frames = list(JSim(traj, seed=0, pixel_noise=0.3,
                       max_features=50).frames(N_FRAMES))
    est = JEst(JCfg(**CFG), init_state=_init(traj))
    _stream(JNode(est), traj, frames)
    return np.stack([x[1] for x in est.trajectory])


def test_vio_node_equals_jax_node(gxx, jax_node_p):
    traj = ttraj(3.0)
    frames = list(TSim(traj, seed=0, pixel_noise=0.3,
                       max_features=50).frames(N_FRAMES))
    est = TEst(TCfg(**CFG), init_state=_init(traj), device="cpu")
    node = TNode(est)
    assert isinstance(node.aligner, tnative.MeasurementAligner)
    _stream(node, traj, frames)
    p = np.stack([x[1] for x in est.trajectory])
    assert p.shape == jax_node_p.shape and len(p) >= N_FRAMES - 1
    np.testing.assert_allclose(p, jax_node_p, rtol=0, atol=1e-4)
    assert node.latest_state[0] == est.trajectory[-1][0]


def test_vio_node_streaming_matches_batch(gxx):
    """The JAX test's own check on the port, 0.5 px: the node's trajectory
    equals direct FrameMeasurement feeding within 5e-2."""
    traj = ttraj(3.0)
    frames = list(TSim(traj, seed=0, pixel_noise=0.5,
                       max_features=50).frames(N_FRAMES))
    est_a = TEst(TCfg(**CFG), init_state=_init(traj), device="cpu")
    for fm in frames:
        est_a.process_frame(fm)
    est_b = TEst(TCfg(**CFG), init_state=_init(traj), device="cpu")
    _stream(TNode(est_b), traj, frames)
    assert len(est_b.trajectory) >= len(frames) - 1
    pa = np.stack([x[1] for x in est_a.trajectory])
    pb = np.stack([x[1] for x in est_b.trajectory[:len(est_a.trajectory)]])
    n = min(len(pa), len(pb))
    assert np.linalg.norm(pa[:n] - pb[:n], axis=1).max() < 5e-2


def test_plain_aligner_only_when_asked():
    est = TEst(TCfg(**CFG), device="cpu")
    assert isinstance(TNode(est, use_native=False).aligner, _PyAligner)
