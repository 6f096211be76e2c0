"""Depth-map container and its image outputs, the viridis depth map and
the autostereogram (port of ``matrix_eyes_tpu/output/depthmap.py``).

The inverse depth stays on the device through clamping, normalisation, the
colour lookup and the stereogram's shift plane; the host sees pixels only
to encode. Save policy, as the JAX package's:

* depth map: a PNG larger than the grid is upsized on the host from the
  grid image (3 B/px crosses to the host at grid size) when the native
  resizer and encoder are present; otherwise the image is resized on the
  device and encoded at full size; other formats go through PIL;
* stereogram: a PNG takes the compact (shift, noise) form when the native
  encoder is present and the geometry allows it (shifts up to 255, not
  ``wide``); otherwise the image is resolved on the device (the linker-scan
  kernel on the card) and encoded under the STEREOGRAM profile, or written
  by PIL for other formats.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from matrix_eyes_tpu_torch.errors import OutputError
from matrix_eyes_tpu_torch.ops.colormap import map_depth
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.ops.stereogram import (
    synthesize_stereogram,
    synthesize_stereogram_split,
)
from matrix_eyes_tpu_torch.output import png

CLIP_DEPTH_MIN = 0.1
CLIP_DEPTH_MAX = 250.0


class ImageOutputFormat(enum.Enum):
    DEPTH_MAP = "depthmap"
    STEREOGRAM = "stereogram"


def stereogram_size(original_size: Tuple[int, int],
                    resize_scale: Optional[float]) -> Tuple[int, int]:
    """(ow, oh) of the stereogram output: the source size under the
    reference's f32::round (half away from zero) scaling (output.rs:154)."""
    ow, oh = original_size
    if resize_scale is not None:
        ow = int(np.floor(np.float32(ow) * np.float32(resize_scale) + 0.5))
        oh = int(np.floor(np.float32(oh) * np.float32(resize_scale) + 0.5))
    return ow, oh


def clamp_inverse_depth(inverse_depth: torch.Tensor) -> torch.Tensor:
    return torch.clamp(inverse_depth.float(), 1.0 / CLIP_DEPTH_MAX, 1.0 / CLIP_DEPTH_MIN)


def render_depth_map_grid(data: torch.Tensor) -> torch.Tensor:
    """Normalise (near = bright) and colour at grid resolution: u8 (H, W, 3)."""
    dmin = data.min()
    dmax = data.max()
    denom = dmax - dmin
    value = torch.where(denom > 0, (dmax - data) / denom, torch.zeros_like(data))
    return map_depth(value)


def render_depth_map(data: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The grid image Lanczos3-resized to (out_h, out_w) on the device."""
    rgb = render_depth_map_grid(data)
    return to_u8(resize_lanczos3(rgb.float(), out_h, out_w))


@dataclass
class DepthMap:
    """Clamped inverse-depth grid + original image size (width, height)."""

    data: torch.Tensor  # (H, W) f32, clamped to [1/250, 1/0.1]
    original_size: Tuple[int, int]

    @classmethod
    def new(cls, inverse_depth: torch.Tensor, original_size: Tuple[int, int]) -> "DepthMap":
        return cls(data=clamp_inverse_depth(inverse_depth), original_size=original_size)

    def render_stereogram(self, resize_scale: Optional[float], amplitude: float,
                          seed: int = 0) -> torch.Tensor:
        """The device-resolved stereogram, (oh, ow, 3) u8 on the grid's device."""
        ow, oh = stereogram_size(self.original_size, resize_scale)
        return synthesize_stereogram(self.data, oh, ow, amplitude, seed)

    def output_image(self, destination_path: str,
                     image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
                     resize_scale: Optional[float] = None, amplitude: float = 1.0 / 16.0,
                     seed: int = 0) -> None:
        """Write the viridis depth map at the source size, or the
        stereogram at the source size times ``resize_scale``."""
        dest = destination_path.lower()
        if dest.endswith(".ply") or dest.endswith(".obj"):
            raise OutputError("mesh output is not supported by the PyTorch port yet")
        if ImageOutputFormat(image_format) == ImageOutputFormat.STEREOGRAM:
            self._output_stereogram(destination_path, resize_scale, amplitude, seed)
            return
        ow, oh = self.original_size
        gh, gw = self.data.shape
        if dest.endswith(".png") and oh * ow > gh * gw and png.host_resize_supported():
            grid = render_depth_map_grid(self.data).cpu().numpy()
            png.save_depthmap_host_resize(grid, destination_path, oh, ow)
            return
        rgb = render_depth_map(self.data, oh, ow).cpu().numpy()
        if dest.endswith(".png"):
            png.save_rgb(rgb, destination_path)
        else:
            png.pil_save(rgb, destination_path)

    def _output_stereogram(self, destination_path: str, resize_scale: Optional[float],
                           amplitude: float, seed: int) -> None:
        dest = destination_path.lower()
        if dest.endswith(".png") and png.split_supported():
            ow, oh = stereogram_size(self.original_size, resize_scale)
            split = synthesize_stereogram_split(self.data, oh, ow, amplitude, seed)
            if split is not None:
                pw, shift, noise = split
                png.save_stereogram_split(shift, noise, destination_path, pw)
                return
        rgb = self.render_stereogram(resize_scale, amplitude, seed).cpu().numpy()
        if dest.endswith(".png"):
            png.save_rgb(rgb, destination_path, png.STEREOGRAM)
        else:
            png.pil_save(rgb, destination_path)
