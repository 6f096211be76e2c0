"""ctypes loader for the striped parallel PNG encoder (``pngwriter.cpp``),
the port's own copy of ``matrix_eyes_tpu/native/pngwriter.py``.

A streaming API (begin / write_rows / write_stereo_rows / end), each call
one independently compressed stripe, plus a one-shot ``encode``.
``available()`` is False when g++ or zlib is missing; callers then use
PIL.
"""

from __future__ import annotations

import ctypes
import os
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
            lib = ctypes.CDLL(native.build("pngwriter", [["-O2", "-lz", "-pthread"]]))
            lib.mepng_begin.restype = ctypes.c_void_p
            lib.mepng_begin.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.mepng_write_rows.restype = ctypes.c_int
            lib.mepng_write_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ]
            lib.mepng_write_stereo_rows.restype = ctypes.c_int
            lib.mepng_write_stereo_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ]
            lib.mepng_end.restype = ctypes.c_int
            lib.mepng_end.argtypes = [ctypes.c_void_p]
            lib.mepng_abort.restype = None
            lib.mepng_abort.argtypes = [ctypes.c_void_p]
            lib.mepng_encode.restype = ctypes.c_int
            lib.mepng_encode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ]
            _lib = lib
            return _lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None


def available() -> bool:
    return _load() is not None


FILTER_NONE = 0
FILTER_SUB = 1
FILTER_UP = 2
FILTER_AVERAGE = 3
FILTER_PAETH = 4


class PngEncoder:
    """Streaming RGB8 PNG encode; each write_rows call becomes one
    independently compressed stripe (its own IDAT chunk)."""

    def __init__(self, path: str, width: int, height: int, *, level: int = 1,
                 filter: int = FILTER_NONE, threads: int = 0):
        lib = _load()
        if lib is None:
            raise OSError("native PNG encoder unavailable")
        self._lib = lib
        self._path = path
        self._width = width
        self._handle = lib.mepng_begin(path.encode(), width, height,
                                       level, filter, threads)
        if not self._handle:
            raise OSError(f"mepng_begin failed for {path}")

    def write_rows(self, rows: np.ndarray) -> None:
        """rows: (n, W, 3) u8, C-contiguous. Enqueues and returns."""
        rows = np.ascontiguousarray(rows, np.uint8)
        # the C side only counts rows; a wrong width would over-read the
        # buffer (nrows * encoder-width bytes from an nrows * rows-width
        # allocation) -- validate here where the shape is known
        if rows.ndim != 3 or rows.shape[1] != self._width or rows.shape[2] != 3:
            raise ValueError(
                f"write_rows expects (n, {self._width}, 3) u8, got {rows.shape}")
        rc = self._lib.mepng_write_rows(
            self._handle, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rows.shape[0])
        if rc != 0:
            self.abort()
            raise OSError(f"mepng_write_rows failed ({rc}) for {self._path}")

    def write_stereo_rows(self, shift: np.ndarray, noise: np.ndarray,
                          pattern_width: int) -> None:
        """Enqueue stereogram rows from their compact representation:
        shift (n, W) u8 link shifts, noise (n, pw, 3) u8 seed pixels. The
        worker pool reconstructs the pixels (reference linker scan,
        output.rs:173-185) and compresses. Requires filter None."""
        shift = np.ascontiguousarray(shift, np.uint8)
        noise = np.ascontiguousarray(noise, np.uint8)
        if shift.ndim != 2 or shift.shape[1] != self._width:
            raise ValueError(
                f"write_stereo_rows expects shift (n, {self._width}), "
                f"got {shift.shape}")
        if (noise.ndim != 3 or noise.shape[0] != shift.shape[0]
                or noise.shape[1] != pattern_width or noise.shape[2] != 3):
            raise ValueError(
                f"write_stereo_rows expects noise ({shift.shape[0]}, "
                f"{pattern_width}, 3), got {noise.shape}")
        rc = self._lib.mepng_write_stereo_rows(
            self._handle,
            shift.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            noise.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            shift.shape[0], pattern_width)
        if rc != 0:
            self.abort()
            raise OSError(f"mepng_write_stereo_rows failed ({rc}) for {self._path}")

    def end(self) -> None:
        handle, self._handle = self._handle, None
        rc = self._lib.mepng_end(handle)
        if rc != 0:
            # a truncated/CRC-broken file may be left at the destination
            # (disk full, stripe deflate failure); remove it rather than
            # hand downstream consumers a corrupt PNG
            try:
                os.remove(self._path)
            except OSError:
                pass
            raise OSError(f"mepng_end failed ({rc}) for {self._path}")

    def abort(self) -> None:
        if self._handle:
            handle, self._handle = self._handle, None
            self._lib.mepng_abort(handle)
            try:
                os.remove(self._path)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.end()
        else:
            self.abort()
        return False


def encode(rgb: np.ndarray, path: str, *, level: int = 1,
           filter: int = FILTER_NONE, threads: int = 0,
           stripe_rows: int = 128) -> bool:
    """One-shot encode; returns False if the native encoder is unavailable
    (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rc = lib.mepng_encode(path.encode(),
                          rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          w, h, level, filter, threads, stripe_rows)
    if rc != 0:
        raise OSError(f"native PNG encode failed ({rc}) for {path}")
    return True
