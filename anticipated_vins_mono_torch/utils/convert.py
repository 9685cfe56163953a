"""Carrying state between the JAX package's containers and the port's.

The JAX side hands its containers over as numpy arrays (its tests do
`jax.tree_util.tree_map(np.array, x)`), so this module never sees jax.
`from_numpy_tree` rebuilds the port's NamedTuples field by field, keeps each
array's dtype, keeps `None` for the optional fields that are absent, and
ALWAYS COPIES: `torch.from_numpy` alone would alias the source buffer, and a
later in-place update on one side would silently change the other.
`to_numpy_tree` goes back, copying as well.

`device_vio_state_from_numpy` is the function that carries estimator state
across: a `DeviceVioState` of the JAX package (with its nested `PriorFactor`
and linearization state) as a tree of numpy arrays → the port's.
`host_estimator_from_numpy` does the same for the host `VioEstimator`: the
fields of a host estimator as numpy (`HOST_FIELDS`) → into a port
estimator, and `host_estimator_to_numpy` reads them back. For the image
path: `camera_from_numpy` (any of the four camera models),
`box_world_from_numpy` (the renderer's world) and
`tracker_state_{from,to}_numpy` (the device tracker's state: the previous
pyramid, the slots, ids, the float32 time and the RANSAC's PRNG key, so that
a JAX tracker state carried across continues on the same draws).
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.models.estimator_device import DeviceVioState
from anticipated_vins_mono_torch.models.tracker_device import TrackerState
from anticipated_vins_mono_torch.ops import cameras
from anticipated_vins_mono_torch.ops.preintegration import Preintegrated
from anticipated_vins_mono_torch.ops.window import (
    PriorFactor, WindowMeasurements, WindowState)
from anticipated_vins_mono_torch.utils.render import BoxWorld
from anticipated_vins_mono_torch.utils.tree import tree_map


def _to_tensor(x, device) -> torch.Tensor:
    arr = np.array(x)            # always a fresh copy, dtype kept
    return torch.from_numpy(arr).to(device)


def _rebuild(cls, fields, device):
    """`cls(*fields)` with every array leaf copied into a tensor; nested
    containers are rebuilt by their own class."""
    nested = {"pre": Preintegrated, "prior": PriorFactor, "lin": WindowState}
    vals = []
    for name, val in zip(cls._fields, tuple(fields)):
        if val is None:
            vals.append(None)
        elif name in nested:
            vals.append(_rebuild(nested[name], val, device))
        else:
            vals.append(_to_tensor(val, device))
    return cls(*vals)


def window_state_from_numpy(state, device="cuda") -> WindowState:
    """A `WindowState` given as a (named) tuple of numpy arrays → the port's."""
    return _rebuild(WindowState, state, torch.device(device))


def window_measurements_from_numpy(meas, device="cuda") -> WindowMeasurements:
    """A `WindowMeasurements` given as nested tuples of numpy arrays
    (including its `PriorFactor` and stacked `Preintegrated`) → the port's."""
    return _rebuild(WindowMeasurements, meas, torch.device(device))


def device_vio_state_from_numpy(tree, device="cuda") -> DeviceVioState:
    """A `DeviceVioState` given as nested (named) tuples of numpy arrays →
    the port's, copied, dtypes kept (`ids`, `n_solves`, `last_id`,
    `since_fail` stay int32)."""
    return _rebuild(DeviceVioState, tree, torch.device(device))


def device_vio_state_to_numpy(state: DeviceVioState) -> DeviceVioState:
    """The inverse: the same containers holding numpy arrays (copies)."""
    return to_numpy_tree(state)


def from_numpy_tree(tree, device="cuda"):
    """Any tree of numpy arrays (tuples, lists, dicts, `None`) → the same
    tree of tensors on `device`, copied, dtype kept. Used for the selector's
    flat argument lists; the window containers have their own functions
    above, which also restore the port's NamedTuple classes."""
    device = torch.device(device)
    return tree_map(lambda x: _to_tensor(x, device), tree)


def to_numpy_tree(tree):
    """A tree of tensors → the same tree of numpy arrays (copied to the
    host); `None` stays `None`, a leaf that is already numpy is copied."""
    return tree_map(
        lambda x: x.detach().cpu().numpy().copy() if torch.is_tensor(x)
        else np.array(x), tree)


# the state of a host `VioEstimator` that a hand-over carries: window arrays,
# bookkeeping, the raw IMU pairs, the FeatureDB arrays, the prior and the
# selector's id bookkeeping
HOST_FIELDS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "stationary",
               "td_at_frame", "n_frames", "initialized", "imu_pairs",
               "frame_times", "_speed_hist", "_init_attempts")
DB_FIELDS = ("ids", "pts", "vel", "prob", "mask", "inv_depth", "solved",
             "last_obs_count")
SELECTOR_FIELDS = ("last_feature_id", "tracked_ids", "first_image")


def _copy(x):
    """A deep copy of numpy arrays inside lists / dicts; scalars as they are."""
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, list):
        return [_copy(v) for v in x]
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, set):
        return set(x)
    return x


def host_estimator_from_numpy(fields: dict, est):
    """Move the numpy state of a host estimator (`fields`: a dict with the
    keys of `HOST_FIELDS`, `"db"` → a dict of `DB_FIELDS`, `"prior"` → a
    `PriorFactor` as nested tuples of numpy arrays, and optionally
    `"selector"` → a dict of `SELECTOR_FIELDS`) into the port's `est`,
    copying every array. The prior goes to `est.device` in `est.dtype`.
    Returns `est`."""
    for name in HOST_FIELDS:
        if name in fields:
            setattr(est, name, _copy(fields[name]))
    for name, val in fields["db"].items():
        setattr(est.db, name, _copy(val))
    prior = _rebuild(PriorFactor, fields["prior"], est.device)
    est.prior = tree_map(lambda x: x.to(est.dtype), prior)
    if est.selector is not None and "selector" in fields:
        for name, val in fields["selector"].items():
            setattr(est.selector, name, _copy(val))
    return est


def host_estimator_to_numpy(est) -> dict:
    """The inverse: the fields of the port's host estimator as numpy
    (copies), in the layout `host_estimator_from_numpy` takes."""
    out = {name: _copy(getattr(est, name)) for name in HOST_FIELDS
           if hasattr(est, name)}
    out["db"] = {name: _copy(getattr(est.db, name)) for name in DB_FIELDS}
    out["prior"] = to_numpy_tree(est.prior)
    if est.selector is not None:
        out["selector"] = {name: _copy(getattr(est.selector, name))
                           for name in SELECTOR_FIELDS}
    return out


# ----------------------------------------------------------------------------
# The image path: cameras, the rendered world, the device tracker's state
# ----------------------------------------------------------------------------

_CAMERAS = {c.__name__: c for c in (
    cameras.PinholeCamera, cameras.EquidistantCamera, cameras.MeiCamera,
    cameras.ScaramuzzaCamera)}


def camera_from_numpy(cam, device="cuda"):
    """A camera model of the JAX package whose parameters are numpy arrays
    → the port's model of the same name, parameters copied into tensors
    (dtype kept), `width` / `height` as ints."""
    cls = _CAMERAS[type(cam).__name__]
    vals = [int(getattr(cam, f)) if f in ("width", "height")
            else _to_tensor(getattr(cam, f), torch.device(device))
            for f in cls._fields]
    return cls(*vals)


def box_world_from_numpy(world, device="cuda") -> BoxWorld:
    """A `BoxWorld` given as a (named) tuple of numpy arrays → the port's."""
    return _rebuild(BoxWorld, world, torch.device(device))


def tracker_state_from_numpy(state, device="cuda") -> TrackerState:
    """A device tracker's state (the JAX `TrackerState` with numpy leaves,
    or the port's) → the port's `TrackerState`, every field copied, dtypes
    kept (`ids`, `life`, `next_id` int32, `t` float32); the key's two
    uint32 words as int64, the port's key format."""
    dev = torch.device(device)
    vals = {f: _to_tensor(getattr(state, f), dev)
            for f in TrackerState._fields if f not in ("pyr", "key")}
    vals["pyr"] = tuple(_to_tensor(x, dev) for x in state.pyr)
    vals["key"] = _to_tensor(np.asarray(state.key).astype(np.int64), dev)
    return TrackerState(**vals)


def tracker_state_to_numpy(state: TrackerState) -> TrackerState:
    """The inverse: the same container holding numpy arrays (copies), the
    key as uint32 words, as the JAX package holds it."""
    out = to_numpy_tree(state)
    return out._replace(key=out.key.astype(np.uint32))
