"""The photo side of the reference, in plain NumPy and float32 PyTorch:
decoding, the EXIF focal length, the Lanczos3 resize to the model's input,
the normalisation, and the viridis depth map at the photo's size.

Semantics written from the upstream tool the program reproduces: the
image crate's Lanczos3 (``ratio = in / out``, support ``3 * max(ratio, 1)``,
taps in ``[floor(c - s), ceil(c + s))`` clamped to the image around
``c = (o + 0.5) * ratio``, weights ``sinc(x) sinc(x / 3)`` at
``(i + 0.5 - c) / max(ratio, 1)`` normalised by their sum, a vertical pass
then a horizontal pass, rounding half away from zero to u8 at the end);
the focal length in pixels ``f35 * diagonal / sqrt(24^2 + 36^2)`` and its
normalised form over the width; the input scaled to [-1, 1]; the depth map
clamped to depths in [0.1, 250], normalised near-bright over its range and
coloured by linear interpolation between viridis entries.
"""

from __future__ import annotations

import json
import math
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

_EXIF_IFD = 0x8769
_FOCAL_35MM = 0xA405


def decode(path: str) -> Tuple[np.ndarray, Optional[float]]:
    """(H, W, 3) u8 pixels with the EXIF orientation applied, and the EXIF
    35 mm focal length (None when absent)."""
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        exif = im.getexif()
        raw = exif.get_ifd(_EXIF_IFD).get(_FOCAL_35MM) if exif else None
        if raw is None and exif:
            raw = exif.get(_FOCAL_35MM)
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return rgb, (float(int(raw)) if raw is not None else None)


def f_norm(focal_35mm: Optional[float], width: int, height: int) -> Optional[float]:
    if focal_35mm is None:
        return None
    f_px = focal_35mm * math.hypot(width, height) / math.hypot(24.0, 36.0)
    return float(np.float32(f_px / width))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    nz = (np.abs(x) < 3.0) & (x != 0.0)
    t = np.pi * x[nz]
    out[nz] = (np.sin(t) / t) * (np.sin(t / 3.0) / (t / 3.0))
    out[x == 0.0] = 1.0
    return out


@lru_cache(maxsize=16)
def lanczos3_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 resampling matrix of one axis."""
    ratio = n_in / n_out
    sratio = max(ratio, 1.0)
    support = 3.0 * sratio
    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        c = (o + 0.5) * ratio
        left = min(max(math.floor(c - support), 0), n_in - 1)
        right = min(max(math.ceil(c + support), left + 1), n_in)
        w = _lanczos3((np.arange(left, right) + 0.5 - c) / sratio)
        m[o, left:right] = w / w.sum() if w.sum() != 0.0 else w
    return m


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Lanczos3 of (H, W, C) float32 data to (out_h, out_w, C), float32."""
    H, W, _ = img.shape
    rv = torch.from_numpy(lanczos3_matrix(H, out_h)).float().to(img.device)
    rh = torch.from_numpy(lanczos3_matrix(W, out_w)).float().to(img.device)
    x = torch.einsum("oh,hwc->owc", rv, img.float())
    return torch.einsum("ow,hwc->hoc", rh, x)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def preprocess(rgb: np.ndarray, size: int, device) -> torch.Tensor:
    """(1, size, size, 3) float32 model input of a (H, W, 3) u8 photo."""
    x = to_u8(resize(torch.from_numpy(np.array(rgb)).to(device).float(), size, size))
    return ((x.float() / 255.0 - 0.5) / 0.5)[None]


@lru_cache(maxsize=None)
def _viridis() -> np.ndarray:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "viridis.json")) as f:
        return np.asarray(json.load(f)["rgb"], np.float32)


def depth_map_grid(inverse_depth: torch.Tensor) -> torch.Tensor:
    """(S, S) inverse depth -> the (S, S, 3) u8 viridis image."""
    d = torch.clamp(inverse_depth.float(), 1.0 / 250.0, 1.0 / 0.1)
    lo, hi = d.min(), d.max()
    v = torch.where(hi > lo, (hi - d) / (hi - lo), torch.zeros_like(d))
    lut = torch.from_numpy(_viridis()).to(d.device)
    step = 1.0 / 255.0
    box = torch.clamp(torch.floor(v / step), 0, 254).long()
    r = ((v - step * box.float()) / step)[..., None]
    c = torch.floor(lut[box + 1] * r + lut[box] * (1.0 - r) + 0.5)
    return torch.where((v >= 1.0)[..., None], lut[255], c).to(torch.uint8)


def depth_map(inverse_depth: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The depth-map PNG's pixels: the grid image Lanczos3-resized to the
    photo's size, (out_h, out_w, 3) u8."""
    return to_u8(resize(depth_map_grid(inverse_depth).float(), out_h, out_w))
