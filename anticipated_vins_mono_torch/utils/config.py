"""Configuration system — one dataclass tree, YAML-loadable.

Counterpart of `anticipated_vins_mono_tpu/utils/config.py`. Replaces the
reference's two-level roslaunch + OpenCV-YAML FileStorage setup
(parameters.cpp `readParameters`, config/euroc/euroc_config.yaml,
feature_tracker/config/euroc.yaml): every knob the reference reads — IMU
noise, solver budget, extrinsics, selector block
(use_feature_selector/max_features/init_threshold/use_ground_truth_hgen),
tracker knobs — maps to a field here. Window and horizon sizes are static
(they fix tensor shapes), mirroring the reference's compile-time constants.

YAML parsing uses a tiny built-in reader for flat `key: value` files (PyYAML
is not a guaranteed dependency); nested config via dotted keys.

The bridges build the port's own types: `window_config()` its
`WindowConfig`, `imu_noise()` its `ImuNoise`, `selector_config()` its
`SelectorConfig`, and `camera_model(device=)` its `PinholeCamera` on
`device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import torch

from anticipated_vins_mono_torch.models.anticipation import SelectorConfig
from anticipated_vins_mono_torch.ops.preintegration import ImuNoise
from anticipated_vins_mono_torch.ops.window import WindowConfig


@dataclass
class CameraConfig:
    """Pinhole + radtan (euroc_config.yaml:8-19)."""
    model: str = "PINHOLE"
    fx: float = 4.616e02
    fy: float = 4.603e02
    cx: float = 3.630e02
    cy: float = 2.481e02
    k1: float = -2.917e-01
    k2: float = 8.228e-02
    p1: float = 5.333e-05
    p2: float = -1.578e-04
    width: int = 752
    height: int = 480


@dataclass
class EstimatorConfig:
    """Solver + IMU block (euroc_config.yaml:40-66)."""
    window: int = 10                  # WINDOW_SIZE (parameters.h:14)
    max_feats: int = 128              # landmark slots (cf. NUM_OF_F budget)
    max_solver_iterations: int = 8    # max_num_iterations (yaml:55)
    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6
    g_norm: float = 9.81007
    estimate_extrinsic: bool = True   # yaml:22
    estimate_td: bool = False         # yaml:73
    rolling_shutter: bool = False     # yaml rolling_shutter (parameters.cpp:124)
    rolling_shutter_tr: float = 0.0   # readout time of one frame [s] (:127)
    keyframe_parallax: float = 10.0   # MIN_PARALLAX px (yaml:52)
    # extrinsic body_T_cam0 (yaml:26-38)
    tic: tuple = (-0.0216, -0.0647, 0.0098)
    ric_ypr: tuple = (89.15, 1.79, -90.81)  # approx EuRoC cam-imu rotation


@dataclass
class SelectorBlock:
    """The fork's selector knobs (euroc_config.yaml:83-88 →
    parameters.cpp:135-138)."""
    use_feature_selector: bool = False
    max_features: int = 30
    init_threshold: int = 30
    use_ground_truth_hgen: bool = False
    horizon: int = 13                 # HORIZON (state_defs.h:8)


@dataclass
class TrackerConfig:
    """feature_tracker/config/euroc.yaml:20-25."""
    max_cnt: int = 150
    min_dist: int = 30
    freq: int = 10
    f_threshold: float = 1.0
    equalize: bool = True


@dataclass
class VinsConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    selector: SelectorBlock = field(default_factory=SelectorBlock)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    output_path: str = "/tmp/vins_result_no_loop.csv"

    # ------------------------------------------------------------------
    # bridges to the runtime configs
    # ------------------------------------------------------------------

    def window_config(self) -> WindowConfig:
        e, c = self.estimator, self.camera
        tr = e.rolling_shutter_tr if e.rolling_shutter else 0.0
        return WindowConfig(
            window=e.window,
            max_feats=e.max_feats,
            iters=e.max_solver_iterations,
            estimate_extrinsic=e.estimate_extrinsic,
            # rolling shutter needs the td machinery (the shift rides the
            # same velocity model, projection_td_factor.cpp:50-52)
            estimate_td=e.estimate_td or e.rolling_shutter,
            tr_over_row=tr / c.height,
            row_fy=c.fy, row_c0=c.cy - c.height / 2.0)

    def imu_noise(self) -> ImuNoise:
        e = self.estimator
        return ImuNoise(acc_n=e.acc_n, gyr_n=e.gyr_n,
                        acc_w=e.acc_w, gyr_w=e.gyr_w)

    def selector_config(self) -> SelectorConfig:
        return SelectorConfig(
            horizon=self.selector.horizon,
            max_features=self.selector.max_features,
            init_threshold=self.selector.init_threshold)

    def camera_model(self, dtype=torch.float32, device="cuda"):
        from anticipated_vins_mono_torch.ops import cameras
        c = self.camera
        if c.model.upper() == "PINHOLE":
            return cameras.PinholeCamera.create(
                c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2,
                c.width, c.height, dtype=dtype, device=device)
        raise ValueError(f"unsupported camera model {c.model}")


# ----------------------------------------------------------------------------
# YAML loading (flat `a.b: value` or two-level indentation)
# ----------------------------------------------------------------------------

_NUM = re.compile(r"^-?\d+(\.\d*)?([eE][+-]?\d+)?$")


def _parse_scalar(v: str):
    v = v.strip().strip('"').strip("'")
    if v.lower() in ("true", "yes", "1"):
        return True if v.lower() in ("true", "yes") else 1
    if v.lower() in ("false", "no"):
        return False
    if _NUM.match(v):
        f = float(v)
        return int(f) if f.is_integer() and "." not in v and "e" not in v.lower() else f
    return v


def load_yaml_flat(path: str) -> dict:
    """Parse `key: value` / `section:\\n  key: value` files (no deps)."""
    out = {}
    section = None
    for line in open(path):
        line = line.split("#")[0].rstrip()
        if not line.strip() or line.strip().startswith("%"):
            continue
        m = re.match(r"^(\s*)([\w.]+):\s*(.*)$", line)
        if not m:
            continue
        indent, key, val = m.groups()
        if val == "":
            section = key if not indent else section
            continue
        full = f"{section}.{key}" if indent and section else key
        out[full] = _parse_scalar(val)
    return out


def load_config(path: Optional[str] = None, **overrides) -> VinsConfig:
    """Build a VinsConfig from a YAML file + keyword overrides.

    Dotted YAML keys map onto the dataclass tree
    (e.g. `estimator.acc_n: 0.08`, `selector.max_features: 30`)."""
    cfg = VinsConfig()
    kv = load_yaml_flat(path) if path else {}
    kv.update(overrides)
    for key, val in kv.items():
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                obj = None
                break
            obj = getattr(obj, p)
        if obj is not None and hasattr(obj, parts[-1]):
            cur = getattr(obj, parts[-1])
            if isinstance(cur, bool):
                val = bool(val)
            setattr(obj, parts[-1], val)
    return cfg
