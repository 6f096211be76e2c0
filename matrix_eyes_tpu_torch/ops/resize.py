"""Image resampling as dense matrix products.

Port of ``matrix_eyes_tpu/ops/resize.py`` (the numpy matrix builder is
copied: the JAX module imports jax):

* ``downsample_half`` / ``downsample_quarter``: the model's bilinear
  (align_corners=False) downsamples by exact factors, written as exact
  means, not interpolation;
* ``resize_lanczos3``: the image crate's Lanczos3 resampler as two f32
  matmuls, vertical pass then horizontal pass;
* ``to_u8``: round half away from zero (``floor(x + 0.5)``, not
  ``torch.round``, which rounds half to even) and clamp;
* ``depthmap_bilinear_resample``: the stereogram's sampling of the depth
  grid at every output pixel, as two f32 matmuls (TF32 must stay off, see
  ``config.configure_precision``: the shift plane rounds these values).
"""

from __future__ import annotations

import collections
import math
import threading
from functools import lru_cache

import numpy as np
import torch

from matrix_eyes_tpu_torch import aot


def downsample_half(x: torch.Tensor) -> torch.Tensor:
    """Exact factor-2 bilinear downsample = 2x2 mean. x: (B, H, W, C)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H // 2, 2, W // 2, 2, C)
    return xf.mean(dim=(2, 4)).to(x.dtype)


def downsample_quarter(x: torch.Tensor) -> torch.Tensor:
    """Exact factor-4 bilinear downsample: output pixel i samples input
    4i + 1.5, the mean of pixels 4i+1 and 4i+2 in both axes."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H // 4, 4, W // 4, 4, C)[:, :, 1:3, :, 1:3, :]
    return xf.mean(dim=(2, 4)).to(x.dtype)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """sinc(x) * sinc(x/3) on |x| < 3, following the image crate's kernel."""
    x = np.asarray(x, dtype=np.float32)
    out = np.zeros_like(x)
    nz = (np.abs(x) < 3.0) & (x != 0.0)
    t = np.pi * x[nz]
    out[nz] = (np.sin(t) / t) * (np.sin(t / 3.0) / (t / 3.0))
    out[x == 0.0] = 1.0
    return out


@lru_cache(maxsize=64)
def _lanczos3_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Resampling matrix (n_out, n_in) for one axis, image-crate semantics:
    ratio = in/out, sratio = max(ratio, 1), support 3 * sratio, taps in
    [floor(c - s), ceil(c + s)) clamped to the image around the centre
    c = (out + 0.5) * ratio, weights lanczos3((i + 0.5 - c) / sratio)
    normalised by their sum."""
    ratio = n_in / n_out
    sratio = max(ratio, 1.0)
    support = 3.0 * sratio
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        center = (o + 0.5) * ratio
        left = int(np.clip(math.floor(center - support), 0, n_in - 1))
        right = int(np.clip(math.ceil(center + support), left + 1, n_in))
        taps = np.arange(left, right, dtype=np.float64)
        w = _lanczos3(((taps + 0.5 - center) / sratio).astype(np.float32))
        s = w.sum()
        if s != 0.0:
            w = w / s
        m[o, left:right] = w
    return m


_DEVICE_MATRICES = 32
_device_matrices: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_device_matrices_lock = threading.Lock()


def _on_device(make, n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``make(n_in, n_out)`` on ``device``: one copy per (matrix, device),
    made on the first call (never inside a graph capture, whose warm-up call
    comes first) and kept for the next ``_DEVICE_MATRICES`` distinct
    matrices; a graph that reads one keeps it alive (``aot.keep_alive``)."""
    key = (make.__name__, n_in, n_out, device)
    with _device_matrices_lock:
        m = _device_matrices.get(key)
        if m is not None:
            _device_matrices.move_to_end(key)
    if m is None:
        m = torch.from_numpy(make(n_in, n_out)).to(device)
        with _device_matrices_lock:
            _device_matrices[key] = m
            while len(_device_matrices) > _DEVICE_MATRICES:
                _device_matrices.popitem(last=False)
    return aot.keep_alive(m)


def resize_lanczos3(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Lanczos3 resize of (H, W, C) data; returns (out_h, out_w, C) f32.
    The caller rounds and clamps to u8 where needed."""
    H, W, _ = img.shape
    rv = _on_device(_lanczos3_matrix, H, out_h, img.device)
    rh = _on_device(_lanczos3_matrix, W, out_w, img.device)
    x = torch.einsum("oh,hwc->owc", rv, img.float())
    return torch.einsum("ow,hwc->hoc", rh, x)


def to_u8(img_f32: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (values are non-negative) and clamp to
    [0, 255], the image crate's float-to-u8 conversion."""
    return torch.clamp(torch.floor(img_f32 + 0.5), 0.0, 255.0).to(torch.uint8)


@lru_cache(maxsize=32)
def _depthmap_bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Per-axis sampling matrix for DepthMap.interpolate_point (output.rs:83-98).

    For output position o in [0, n_out): normalised coord o/n_out, scaled by
    n_in (no half-pixel shift), floor/ceil taps clamped to [0, n_in-1],
    linear weights from the fractional part.
    """
    m = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        x = max((o / n_out) * n_in, 0.0)
        x0 = min(int(math.floor(x)), n_in - 1)
        x1 = min(x0 + 1, n_in - 1)
        f = x - math.floor(x)
        m[o, x0] += np.float32(1.0 - f)
        m[o, x1] += np.float32(f)
    return m


def depthmap_bilinear_resample(depth: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Sample a (H, W) depth grid at every pixel of the (out_h, out_w)
    output: rows, then columns, each an f32 matmul."""
    H, W = depth.shape
    rv = _on_device(_depthmap_bilinear_matrix, H, out_h, depth.device)
    rh = _on_device(_depthmap_bilinear_matrix, W, out_w, depth.device)
    return (rv @ depth.float()) @ rh.T
