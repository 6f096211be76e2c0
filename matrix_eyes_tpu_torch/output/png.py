"""PNG serialisation of depth maps (port of the depth-map part of
``matrix_eyes_tpu/output/png.py``).

The native striped encoder and the native host Lanczos3 resizer are
imported from the JAX package's ``native`` modules, which are jax-free.
Depth maps are encoded with the fixed Up filter at zlib level 1 in
ENCODE_ROWS stripes, so the bytes match the JAX package's for the same
pixels. Without the native encoder, PIL writes the file.
"""

from __future__ import annotations

import numpy as np

from matrix_eyes_tpu.errors import OutputError
from matrix_eyes_tpu.native import pngwriter

DEPTH_MAP = {"level": 1, "filter": pngwriter.FILTER_UP}
ENCODE_ROWS = 256


def _host_stripes(arr: np.ndarray):
    return [arr[i:i + ENCODE_ROWS] for i in range(0, arr.shape[0], ENCODE_ROWS)]


def host_resize_supported() -> bool:
    """Whether the depth-map save can take the grid-transfer path (native
    striped encoder + native host Lanczos3 resizer)."""
    from matrix_eyes_tpu.native import lanczos

    return pngwriter.available() and lanczos.available()


def _encode(rgb: np.ndarray, path: str) -> None:
    h, w = rgb.shape[:2]
    try:
        with pngwriter.PngEncoder(path, w, h, **DEPTH_MAP) as enc:
            for stripe in _host_stripes(rgb):
                enc.write_rows(stripe)
    except OSError as e:
        raise OutputError(f"Image error: {e}") from e


def save_depthmap_host_resize(grid: np.ndarray, path: str, out_h: int, out_w: int) -> None:
    """Encode a depth-map PNG from its grid-resolution colour image (u8
    (H, W, 3) on the host): Lanczos3-upsize to (out_h, out_w) on the host,
    then stripe-encode."""
    from matrix_eyes_tpu.native import lanczos

    try:
        full = lanczos.resize_rgb8(grid, out_h, out_w)
    except OSError as e:
        raise OutputError(f"Image error: {e}") from e
    _encode(full, path)


def save_rgb(rgb: np.ndarray, path: str) -> None:
    """Encode a full-size (H, W, 3) u8 depth-map image."""
    if pngwriter.available():
        _encode(np.ascontiguousarray(rgb), path)
    else:
        pil_save(rgb, path, compress_level=DEPTH_MAP["level"])


def pil_save(rgb: np.ndarray, path: str, **kw) -> None:
    from PIL import Image

    try:
        Image.fromarray(rgb, mode="RGB").save(path, **kw)
    except (OSError, ValueError) as e:
        raise OutputError(f"Image error: {e}") from e
