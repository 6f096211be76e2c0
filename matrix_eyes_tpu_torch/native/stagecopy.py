"""ctypes loader for the host staging copy (``stagecopy.cpp``): one
contiguous buffer into another, shared by the calling thread and a pool of
helper threads that never makes the caller wait for a helper to wake (see
the source). ``available()`` is False when g++ is missing; the caller then
copies on its own thread."""

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
            lib = ctypes.CDLL(native.build("stagecopy", [["-O3", "-pthread"]]))
            lib.me_stage_copy.restype = ctypes.c_int
            lib.me_stage_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int]
            _lib = lib
            return _lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None


def available() -> bool:
    return _load() is not None


def copy(src: np.ndarray, dst: np.ndarray, threads: int) -> None:
    """Copy ``src`` into ``dst``, both C-contiguous and of one size in
    bytes, on the calling thread and up to ``threads - 1`` helpers (the
    pool takes its size from the first call). ``src`` may be read-only."""
    lib = _load()
    if lib is None:
        raise OSError("native staging copy unavailable")
    if not (src.flags.c_contiguous and dst.flags.c_contiguous and dst.flags.writeable):
        raise ValueError("copy takes C-contiguous arrays and a writable destination")
    if src.nbytes != dst.nbytes:
        raise ValueError(f"copy of {src.nbytes} bytes into {dst.nbytes}")
    if lib.me_stage_copy(src.ctypes.data, dst.ctypes.data, src.nbytes, threads) != 0:
        raise OSError("native staging copy failed")
