"""Viridis depth-map colouring as one LUT gather + lerp on the device.

Port of ``matrix_eyes_tpu/ops/colormap.py``: for a value in [0, 1] the
LUT box is ``clamp(floor(value * 255), 0, 254)``, the colour is the linear
interpolation between box and box + 1, rounded half away from zero;
values >= 1 take the last entry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch.ops.viridis_data import VIRIDIS_B, VIRIDIS_G, VIRIDIS_R

_LUT = np.stack(
    [np.asarray(VIRIDIS_R), np.asarray(VIRIDIS_G), np.asarray(VIRIDIS_B)], axis=1
).astype(np.float32)  # (256, 3)


@functools.lru_cache(maxsize=None)
def _lut_on(device: torch.device) -> torch.Tensor:
    """The table on ``device``, copied there once (on the first call, never
    inside a graph capture, whose warm-up call comes first)."""
    return torch.from_numpy(_LUT).to(device)


def map_depth(value: torch.Tensor) -> torch.Tensor:
    """value: (...,) floats in [0, 1]; returns (..., 3) uint8 RGB."""
    lut = aot.keep_alive(_lut_on(value.device))
    v = value.float()
    step = 1.0 / 255.0
    box = torch.clamp(torch.floor(v / step), 0, 254).long()
    ratio = ((v - step * box.float()) / step)[..., None]
    c1 = lut[box]
    c2 = lut[box + 1]
    # floor(x + 0.5): the reference's round half away from zero
    mixed = torch.floor(c2 * ratio + c1 * (1.0 - ratio) + 0.5)
    out = torch.where((v >= 1.0)[..., None], lut[255], mixed)
    return out.to(torch.uint8)
