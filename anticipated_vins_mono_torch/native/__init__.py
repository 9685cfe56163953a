"""Native (C++) runtime components with build-at-first-use ctypes bindings.

Counterpart of `anticipated_vins_mono_tpu/native/__init__.py`. The host
runtime pieces around the device compute path — EuRoC CSV ingest, the
IMU/frame measurement aligner, the Hamming descriptor matcher — are C++ in
`src/avm_native.cc` (the JAX package's source, copied whole so that the
loop closure finds the matcher here).

Where the two differ: the library is built with `g++` at first use into
`build/native/` at the repository root, under a name that carries a hash
of the source, never into the source tree; and a failed build RAISES
with the compiler's output. The JAX loader swallows it and returns `None`,
after which its callers fall back to Python silently; here there is no
`available()` and no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "avm_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(
        (CXX,) + CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libavm_native_{digest}.so"


def _build(out: Path) -> None:
    """Compile into a file of this process's own, then move it into place
    (another process may be building the same library)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") \
            from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib():
    """Load the native library, building it first if needed. Raises
    `RuntimeError` (with the compiler's output) if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        P = ctypes.POINTER
        d, i32, vp = ctypes.c_double, ctypes.c_int, ctypes.c_void_p
        lib.avm_load_euroc_csv.argtypes = [ctypes.c_char_p, P(d), i32]
        lib.avm_load_euroc_csv.restype = i32
        lib.avm_aligner_create.argtypes = []
        lib.avm_aligner_create.restype = vp
        lib.avm_aligner_destroy.argtypes = [vp]
        lib.avm_aligner_destroy.restype = None
        lib.avm_aligner_push_imu.argtypes = [vp, d, P(d), P(d)]
        lib.avm_aligner_push_imu.restype = None
        lib.avm_aligner_frame_batch.argtypes = [vp, d, P(d), P(d), P(d),
                                                P(d), P(d), i32]
        lib.avm_aligner_frame_batch.restype = i32
        lib.avm_hamming_all_pairs.argtypes = [
            P(ctypes.c_uint64), i32, P(ctypes.c_uint64), i32, P(ctypes.c_int32)]
        lib.avm_hamming_all_pairs.restype = None
        _lib = lib
        return _lib


# ----------------------------------------------------------------------------
# High-level wrappers
# ----------------------------------------------------------------------------

_PD = ctypes.POINTER(ctypes.c_double)


def load_euroc_csv(path: str, max_rows: int = 400000) -> dict:
    """Native CSV load → dict like utils.euroc.load_gt_csv."""
    lib = get_lib()
    buf = np.zeros((max_rows, 17))
    n = lib.avm_load_euroc_csv(path.encode(), buf.ctypes.data_as(_PD),
                               max_rows)
    if n < 0:
        raise FileNotFoundError(path)
    raw = buf[:n]
    return {"t": raw[:, 0], "p": raw[:, 1:4], "q": raw[:, 4:8],
            "v": raw[:, 8:11], "bg": raw[:, 11:14], "ba": raw[:, 14:17]}


class MeasurementAligner:
    """Native IMU/frame aligner (estimator_node getMeasurements parity)."""

    def __init__(self):
        self._lib = get_lib()
        self._h = ctypes.c_void_p(self._lib.avm_aligner_create())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.avm_aligner_destroy(self._h)
            self._h = None

    def push_imu(self, t: float, acc, gyr):
        a = np.ascontiguousarray(acc, dtype=np.float64)
        w = np.ascontiguousarray(gyr, dtype=np.float64)
        if a.shape != (3,) or w.shape != (3,):
            raise ValueError(f"acc, gyr must be 3-vectors: {a.shape}, "
                             f"{w.shape}")
        self._lib.avm_aligner_push_imu(self._h, float(t),
                                       a.ctypes.data_as(_PD),
                                       w.ctypes.data_as(_PD))

    def frame_batch(self, t_frame: float, max_n: int = 256):
        """Returns (dts [n], acc [n,3], gyr [n,3], acc0 [3], gyr0 [3]) or
        None if IMU data hasn't caught up to t_frame yet."""
        dts = np.zeros(max_n)
        acc = np.zeros((max_n, 3))
        gyr = np.zeros((max_n, 3))
        acc0 = np.zeros(3)
        gyr0 = np.zeros(3)
        n = self._lib.avm_aligner_frame_batch(
            self._h, float(t_frame), dts.ctypes.data_as(_PD),
            acc.ctypes.data_as(_PD), gyr.ctypes.data_as(_PD),
            acc0.ctypes.data_as(_PD), gyr0.ctypes.data_as(_PD), max_n)
        if n < 0:
            return None
        return dts[:n], acc[:n], gyr[:n], acc0, gyr0


def pack_descriptors(desc_bool: np.ndarray) -> np.ndarray:
    """bool [N,256] → packed uint64 [N,4]."""
    bits = np.packbits(desc_bool.astype(np.uint8), axis=1, bitorder="little")
    return bits.view(np.uint64)


def hamming_all_pairs(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Native all-pairs Hamming distances over packed [N,4] uint64."""
    lib = get_lib()
    a = np.ascontiguousarray(d1, dtype=np.uint64)
    b = np.ascontiguousarray(d2, dtype=np.uint64)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != 4 or b.shape[1] != 4:
        raise ValueError(f"packed descriptors must be [N,4]: {a.shape}, "
                         f"{b.shape}")
    out = np.zeros((len(a), len(b)), np.int32)
    P64 = ctypes.POINTER(ctypes.c_uint64)
    lib.avm_hamming_all_pairs(a.ctypes.data_as(P64), len(a),
                              b.ctypes.data_as(P64), len(b),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
