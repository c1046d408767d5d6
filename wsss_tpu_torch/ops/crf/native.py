"""ctypes bindings for the native permutohedral dense CRF (the port's own
copy of ``wsss_tpu/ops/crf/native.py``; the library is C++, not JAX).

The C++ library (native/densecrf.cpp) is the host-side equivalent of
pydensecrf and an independent oracle for the mean field.  Build it with
``make -C native`` or with ``build()``; nothing here builds it unasked
(the reference builds on first use).  It computes on the host: callers
hand it numpy arrays, and ``mean_field`` takes this route for tensors
that already lie on the CPU only.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', '..',
                           'native')
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, 'libwsssnative.so'))
_lib: Optional[ctypes.CDLL] = None


def build() -> bool:
    """Run ``make -C native``; whether the library is there afterwards."""
    try:
        subprocess.run(['make', '-C', os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    return os.path.exists(_LIB_PATH)


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wsss_permutohedral_filter.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.wsss_dense_crf.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _as_f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def permutohedral_filter(positions: np.ndarray, values: np.ndarray
                         ) -> np.ndarray:
    """out = K @ values with K = exp(-|p_i - p_j|^2 / 2) over the lattice.
    positions: [N, fd] (pre-scaled by sigma); values: [N, vd]."""
    lib = load()
    if lib is None:
        raise RuntimeError('native library unavailable: build it with '
                           'native.build() or make -C native')
    positions = _as_f32(positions)
    values = _as_f32(values)
    n, fd = positions.shape
    vd = values.shape[1]
    out = np.empty((n, vd), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wsss_permutohedral_filter(
        positions.ctypes.data_as(f32p), values.ctypes.data_as(f32p),
        n, fd, vd, out.ctypes.data_as(f32p))
    return out


def mean_field_native(probs: np.ndarray, img: np.ndarray, config,
                      exclude_self: bool = True) -> np.ndarray:
    """CPU permutohedral mean-field; same spec as
    wsss_tpu_torch.ops.crf.meanfield.mean_field.
    probs/img: [H,W,C]/[H,W,3]."""
    lib = load()
    if lib is None:
        raise RuntimeError('native library unavailable: build it with '
                           'native.build() or make -C native')
    probs = _as_f32(probs)
    img = _as_f32(img)
    h, w, c = probs.shape
    out = np.empty_like(probs)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wsss_dense_crf(
        probs.ctypes.data_as(f32p), img.ctypes.data_as(f32p), h, w, c,
        float(config.g_sxy), float(config.g_compat), float(config.bi_sxy),
        float(config.bi_srgb), float(config.bi_compat),
        int(config.iterations), int(exclude_self),
        out.ctypes.data_as(f32p))
    return out
