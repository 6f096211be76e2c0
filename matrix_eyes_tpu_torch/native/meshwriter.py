"""ctypes loader for the native OBJ serializer (``meshwriter.cpp``), the
port's own copy of ``matrix_eyes_tpu/native/meshwriter.py``.

Two entries: ``index_mesh``, the first-use vertex numbering of a face list
in one O(n) pass, and ``write_obj``, the OBJ text with Rust Display floats.
``available()`` is False when g++ is missing; callers then take the numpy
numbering and the Python writer, which give the same numbers and bytes.
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
            lib = ctypes.CDLL(native.build("meshwriter", [["-O2"]]))
            lib.me_write_obj.restype = ctypes.c_int
            lib.me_write_obj.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_void_p,  # rgb or NULL
                ctypes.c_void_p, ctypes.c_void_p,  # us, vs or NULL
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int, ctypes.c_char_p,
            ]
            lib.me_index_mesh.restype = ctypes.c_int64
            lib.me_index_mesh.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
            return _lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None


def available() -> bool:
    return _load() is not None


def index_mesh(faces: np.ndarray, grid_size: int):
    """First-use vertex numbering. faces: (nf, 3) int64 grid indices.
    Returns (vertex_orig int64 (nv,), remapped faces int32 (nf, 3)), or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int64)
    nf = faces.shape[0]
    out_faces = np.empty((nf, 3), np.int32)
    out_vertex = np.empty(min(3 * nf, grid_size), np.int64)
    nv = lib.me_index_mesh(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(nf), ctypes.c_int64(grid_size),
        out_faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_vertex.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if nv < 0:
        raise ValueError("face index out of range in index_mesh")
    return out_vertex[:nv].copy(), out_faces


def write_obj(path, x, y, z, rgb, uvs, faces, texture: bool, mtl_stem: str) -> bool:
    """Write the OBJ natively; False without the library (the caller then
    writes it in Python). x, y, z: f64 (nv,) as written; rgb: u8 (nv, 3) or
    None; uvs: (u, v) f32 or None; faces: i32 (nf, 3), 0-based."""
    lib = _load()
    if lib is None:
        return False
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    z = np.ascontiguousarray(z, np.float64)
    faces = np.ascontiguousarray(faces, np.int32)
    rgb_p = us_p = vs_p = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        rgb_p = rgb.ctypes.data_as(ctypes.c_void_p)
    if uvs is not None:
        us = np.ascontiguousarray(uvs[0], np.float32)
        vs = np.ascontiguousarray(uvs[1], np.float32)
        us_p = us.ctypes.data_as(ctypes.c_void_p)
        vs_p = vs.ctypes.data_as(ctypes.c_void_p)
    rc = lib.me_write_obj(
        path.encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(x.shape[0]),
        rgb_p, us_p, vs_p,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(faces.shape[0]),
        ctypes.c_int(1 if texture else 0),
        mtl_stem.encode(),
    )
    if rc != 0:
        raise OSError(f"native OBJ writer failed with code {rc} for {path}")
    return True
