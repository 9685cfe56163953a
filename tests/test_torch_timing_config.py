"""The port's configuration tree and host stopwatch against the JAX
package's (`utils/config.py`, `utils/timing.py`), CPU.

The same YAML goes into both `load_config`: every field of the dataclass
tree is equal, and so are the bridged `WindowConfig`, `ImuNoise`,
`SelectorConfig` fields and the camera's parameters (the port's on the
CPU as asked). The `<name>.bin` sample log is MATLAB-compatible float64 in
both, and one package reads what the other wrote. `torch_profile` writes a
Chrome trace of the block.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.utils import config as jconfig
from anticipated_vins_mono_tpu.utils import timing as jtiming
from anticipated_vins_mono_torch.utils import config, timing

torch.set_num_threads(1)

YAML = """
%YAML:1.0
# a comment line
estimator:
  acc_n: 0.2
  gyr_w: 3.0e-6
  max_solver_iterations: 4
  rolling_shutter: 1
  rolling_shutter_tr: 0.03
  estimate_td: false
camera:
  fx: 455.5
  cy: 250.25
selector:
  use_feature_selector: 1
  max_features: 55
  horizon: 7
tracker:
  equalize: no
output_path: "out/vins.csv"
unknown.key: 3
"""


@pytest.fixture
def yaml_path(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(YAML)
    return str(p)


@pytest.mark.parametrize("overrides", [{}, {"estimator.window": 6,
                                            "selector.max_features": 12}],
                         ids=["file", "file+overrides"])
def test_load_config_equals_jax(yaml_path, overrides):
    assert config.load_yaml_flat(yaml_path) == \
        jconfig.load_yaml_flat(yaml_path)
    t = config.load_config(yaml_path, **overrides)
    j = jconfig.load_config(yaml_path, **overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.selector.use_feature_selector is True
    assert t.estimator.max_solver_iterations == 4


@pytest.mark.parametrize("text", ["true", "yes", "1", "false", "no", "12",
                                  "-3.5", "1e-3", "2.", "abc", "'q'"])
def test_parse_scalar_equals_jax(text):
    a, b = config._parse_scalar(text), jconfig._parse_scalar(text)
    assert a == b and type(a) is type(b)


def test_bridges_equal_jax(yaml_path):
    t = config.load_config(yaml_path)
    j = jconfig.load_config(yaml_path)
    tw, jw = t.window_config()._asdict(), j.window_config()._asdict()
    shared = set(tw) & set(jw)
    assert {k: tw[k] for k in shared} == {k: jw[k] for k in shared}
    # `fused_schur` is the port's name of the JAX `pallas_schur`
    assert set(tw) - shared == {"fused_schur"}
    assert tw["fused_schur"] is False and jw["pallas_schur"] is False
    assert t.window_config().tr_over_row == pytest.approx(0.03 / 480)
    assert t.window_config().estimate_td is True
    tn, jn = t.imu_noise(), j.imu_noise()
    assert tn._asdict() == jn._asdict()
    ts, js = t.selector_config(), j.selector_config()
    assert ts._asdict() == js._asdict() and ts.horizon == 7
    # both in float32, the JAX bridge's type
    tc = t.camera_model(device="cpu")
    jc = j.camera_model()
    assert tc.fx.device.type == "cpu" and tc.fx.dtype == torch.float32
    for f in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"):
        assert float(getattr(tc, f)) == float(getattr(jc, f)), f
    assert float(t.camera_model(dtype=torch.float64, device="cpu").fy) \
        == t.camera.fy
    assert (tc.width, tc.height) == (jc.width, jc.height)


def test_unsupported_camera_model_raises_in_both():
    t, j = config.VinsConfig(), jconfig.VinsConfig()
    t.camera.model = j.camera.model = "MEI"
    with pytest.raises(ValueError):
        j.camera_model()
    with pytest.raises(ValueError):
        t.camera_model(device="cpu")


def test_tictoc_binary_log_reads_in_both_packages(tmp_path):
    timing.reset_stats()
    for _ in range(3):
        with timing.TicToc("unit_cost", log_dir=str(tmp_path)):
            pass
    manual = timing.TicToc("unit_cost", log_dir=str(tmp_path))
    dt = manual.toc()
    s = timing.stats()["unit_cost"]
    assert s["count"] == 4 and s["max"] >= dt >= 0
    assert s["mean"] == pytest.approx(s["mean"])
    path = str(tmp_path / "unit_cost.bin")
    ours, theirs = timing.read_bin_log(path), jtiming.read_bin_log(path)
    np.testing.assert_array_equal(ours, theirs)
    assert len(ours) == 4 and ours[-1] == dt
    # little-endian float64, MATLAB fread(f, 'double') layout
    raw = open(path, "rb").read()
    assert struct.unpack("<4d", raw) == tuple(ours)
    # a log the JAX package wrote reads the same here
    jtiming.reset_stats()
    with jtiming.TicToc("jax_cost", log_dir=str(tmp_path)):
        pass
    np.testing.assert_array_equal(
        timing.read_bin_log(str(tmp_path / "jax_cost.bin")),
        jtiming.read_bin_log(str(tmp_path / "jax_cost.bin")))
    timing.reset_stats()
    assert timing.stats() == {}


def test_stats_equal_jax_for_the_same_samples(monkeypatch):
    """Both registries aggregate the same clock readings to the same table."""
    for mod in (timing, jtiming):
        # each sample reads the clock three times: construction, tic, toc
        ticks = iter([0.0, 0.0, 0.5, 1.0, 1.0, 1.25, 2.0, 2.0, 4.0])
        mod.reset_stats()
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        for _ in range(3):
            with mod.TicToc("stage"):
                pass
    assert timing.stats() == jtiming.stats() == {
        "stage": {"count": 3, "mean": 2.75 / 3, "max": 2.0}}
    timing.reset_stats()
    jtiming.reset_stats()


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    with timing.torch_profile(str(tmp_path)) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert len(prof.key_averages()) > 0
