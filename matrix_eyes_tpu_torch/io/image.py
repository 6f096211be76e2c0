"""Source-image loading: decode, EXIF focal length + orientation (the
port's own copy of ``matrix_eyes_tpu/io/image.py``).

Mirrors ``SourceImage`` (reconstruction.rs:74-153): decode JPEG/PNG, read
the EXIF ``FocalLengthIn35mmFilm`` tag (reconstruction.rs:133-143), apply
the EXIF orientation (reconstruction.rs:103-105), and compute the focal
length in pixels from the 35mm equivalent via the diagonal ratio
``f_px = f35 * diag(img) / sqrt(24^2 + 36^2)`` (reconstruction.rs:145-152).

Only the decode happens on the host; the Lanczos3 resize to the model
resolution and normalisation run on the device (pipeline.preprocess_image).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.errors import ImageError

_EXIF_FOCAL_35MM = 0xA405  # FocalLengthIn35mmFilm


@dataclasses.dataclass
class SourceImage:
    rgb: np.ndarray  # (H, W, 3) u8, EXIF orientation applied
    original_size: Tuple[int, int]  # (width, height)
    focal_length_35mm: Optional[float]

    def focal_length_px(self) -> Optional[float]:
        """reconstruction.rs:145-152."""
        if self.focal_length_35mm is None:
            return None
        diagonal_35mm = math.sqrt(24.0 * 24.0 + 36.0 * 36.0)
        w, h = float(self.original_size[0]), float(self.original_size[1])
        diagonal = math.sqrt(w * w + h * h)
        return self.focal_length_35mm * diagonal / diagonal_35mm

    def f_norm(self) -> Optional[float]:
        """Normalised focal length: f_px / original_width (reconstruction.rs:174-176)."""
        f_px = self.focal_length_px()
        if f_px is None:
            return None
        return float(np.float32(f_px / float(self.original_size[0])))


def probe_focal_length_35mm(path: str) -> Optional[float]:
    """The EXIF FocalLengthIn35mmFilm tag alone, without decoding pixels
    (PIL decodes lazily, so this reads the header only); None when the file
    has none or cannot be read. Directory mode uses it to load the FOV
    weights only when some photo lacks a focal length."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            exif = im.getexif()
            raw = exif.get_ifd(0x8769).get(_EXIF_FOCAL_35MM) if exif else None
            if raw is None and exif:
                raw = exif.get(_EXIF_FOCAL_35MM)
            return float(int(raw)) if raw is not None else None
    except Exception:
        return None


def load_source_image(path: str, focal_length_35mm: Optional[float] = None) -> SourceImage:
    with timings.trace("pipeline.decode"):
        return _decode(path, focal_length_35mm)


def _decode(path: str, focal_length_35mm: Optional[float]) -> SourceImage:
    from PIL import Image, ImageOps

    try:
        with Image.open(path) as im:
            if focal_length_35mm is None:
                try:
                    exif = im.getexif()
                    raw = exif.get_ifd(0x8769).get(_EXIF_FOCAL_35MM) if exif else None
                    if raw is None and exif:
                        raw = exif.get(_EXIF_FOCAL_35MM)
                    if raw is not None:
                        # the reference reads it as an unsigned int
                        focal_length_35mm = float(int(raw))
                except Exception:
                    focal_length_35mm = None
            im = ImageOps.exif_transpose(im)
            rgb = np.asarray(im.convert("RGB"))
    except FileNotFoundError as e:
        raise ImageError(f"IO error: {e}") from e
    except (OSError, ValueError) as e:
        raise ImageError(f"Image error: {e}") from e
    h, w = rgb.shape[:2]
    return SourceImage(rgb=rgb, original_size=(w, h), focal_length_35mm=focal_length_35mm)
