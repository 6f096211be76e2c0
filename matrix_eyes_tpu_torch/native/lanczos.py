"""ctypes loader for the host Lanczos3 RGB8 resizer (``lanczos.cpp``), the
port's own copy of ``matrix_eyes_tpu/native/lanczos.py``.

The depth-map PNG path colours at grid resolution and upsizes to the
source photo on the host, so only the grid-resolution image crosses from
the device (~5x fewer bytes for a 12 MP photo). ``available()`` is False
when g++ is missing; callers then keep the device-resize path.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Optional

import numpy as np

from matrix_eyes_tpu_torch import native

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            # -march=native matters: the horizontal pass is much faster
            # vectorised. The library builds on the machine that runs it, so
            # native is safe; plain -O3 only if the toolchain rejects it.
            lib = ctypes.CDLL(native.build("lanczos", [["-O3", "-march=native", "-pthread"],
                                                       ["-O3", "-pthread"]]))
            lib.me_lanczos3_rgb8.restype = ctypes.c_int
            lib.me_lanczos3_rgb8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int,
            ]
            _lib = lib
            return _lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None


def available() -> bool:
    return _load() is not None


def resize_rgb8(rgb: np.ndarray, out_h: int, out_w: int,
                threads: int = 0) -> np.ndarray:
    """Lanczos3-resize an (H, W, 3) u8 image to (out_h, out_w, 3) u8,
    image-crate semantics (one final round-half-away + clamp)."""
    lib = _load()
    if lib is None:
        raise OSError("native lanczos resizer unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"resize_rgb8 expects (H, W, 3) u8, got {rgb.shape}")
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.me_lanczos3_rgb8(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rgb.shape[0], rgb.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h, out_w, threads)
    if rc != 0:
        raise OSError(f"native lanczos resize failed ({rc})")
    return out
