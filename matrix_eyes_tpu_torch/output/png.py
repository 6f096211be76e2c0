"""PNG serialisation of depth maps and stereograms (port of
``matrix_eyes_tpu/output/png.py``).

The native striped encoder and the native host Lanczos3 resizer are the
port's own copies (``matrix_eyes_tpu_torch/native``). Images are encoded
in ENCODE_ROWS stripes at zlib level 1, depth maps with the fixed Up
filter and stereograms with filter None (their pixel chains are long
exact LZ matches that row filters would obscure), so the bytes match the
JAX package's for the same pixels. A stereogram in its compact
(shift, noise) form is encoded by the native encoder, which replays the
linker scan per stripe. Without the native encoder, PIL writes the file.
"""

from __future__ import annotations

import numpy as np

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.errors import OutputError
from matrix_eyes_tpu_torch.native import pngwriter

DEPTH_MAP = {"level": 1, "filter": pngwriter.FILTER_UP}
STEREOGRAM = {"level": 1, "filter": pngwriter.FILTER_NONE}
ENCODE_ROWS = 256


def _host_stripes(arr: np.ndarray):
    return [arr[i:i + ENCODE_ROWS] for i in range(0, arr.shape[0], ENCODE_ROWS)]


def host_resize_supported() -> bool:
    """Whether the depth-map save can take the grid-transfer path (native
    striped encoder + native host Lanczos3 resizer)."""
    from matrix_eyes_tpu_torch.native import lanczos

    return pngwriter.available() and lanczos.available()


def split_supported() -> bool:
    """Whether the compact (shift, noise) stereogram save can run: the
    linker-scan replay lives in the native encoder."""
    return pngwriter.available()


def _encode(rgb: np.ndarray, path: str, profile: dict) -> None:
    h, w = rgb.shape[:2]
    try:
        with timings.trace("output.encode"):
            with pngwriter.PngEncoder(path, w, h, **profile) as enc:
                for stripe in _host_stripes(rgb):
                    enc.write_rows(stripe)
    except OSError as e:
        raise OutputError(f"Image error: {e}") from e


def save_depthmap_host_resize(grid: np.ndarray, path: str, out_h: int, out_w: int) -> None:
    """Encode a depth-map PNG from its grid-resolution colour image (u8
    (H, W, 3) on the host): Lanczos3-upsize to (out_h, out_w) on the host,
    then stripe-encode."""
    from matrix_eyes_tpu_torch.native import lanczos

    try:
        with timings.trace("output.resize"):
            full = lanczos.resize_rgb8(grid, out_h, out_w)
    except OSError as e:
        raise OutputError(f"Image error: {e}") from e
    _encode(full, path, DEPTH_MAP)


def save_rgb(rgb: np.ndarray, path: str, profile: dict = DEPTH_MAP) -> None:
    """Encode a full-size (H, W, 3) u8 image under ``profile`` (DEPTH_MAP
    or STEREOGRAM); PIL at the profile's level without the native encoder."""
    if pngwriter.available():
        _encode(np.ascontiguousarray(rgb), path, profile)
    else:
        pil_save(rgb, path, compress_level=profile["level"])


def save_stereogram_split(shift: np.ndarray, noise: np.ndarray, path: str, pw: int) -> None:
    """Encode a stereogram from its compact form, shift (H, W) u8 and noise
    (H, pw, 3) u8 on the host: both are sliced in lockstep at ENCODE_ROWS
    (noise is per row, so rows align) and the native worker pool replays
    the reference linker scan and compresses the stripes in parallel."""
    h, w = shift.shape
    try:
        with pngwriter.PngEncoder(path, w, h, **STEREOGRAM) as enc:
            for ss, ns in zip(_host_stripes(shift), _host_stripes(noise)):
                enc.write_stereo_rows(ss, ns, pw)
    except OSError as e:
        raise OutputError(f"Image error: {e}") from e


def pil_save(rgb: np.ndarray, path: str, **kw) -> None:
    from PIL import Image

    try:
        Image.fromarray(rgb, mode="RGB").save(path, **kw)
    except (OSError, ValueError) as e:
        raise OutputError(f"Image error: {e}") from e
