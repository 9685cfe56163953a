"""PyTorch/CUDA port of the anticipated visual-inertial estimator.

Same layout as `anticipated_vins_mono_tpu` (`ops/`, `models/`, `utils/`,
same module and function names). This package imports `torch` and numpy
only. Its entry points run on a CUDA device unless the caller passes
`device="cpu"`; the two hand-written Hopper kernels live under `csrc/` and
are built at first use by `ops/hopper_kernels.py`.
"""

from anticipated_vins_mono_torch import models, ops, utils  # noqa: F401

__version__ = "0.1.0"
