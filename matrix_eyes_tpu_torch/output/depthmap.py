"""Depth-map container and its viridis PNG output (port of the depth-map
part of ``matrix_eyes_tpu/output/depthmap.py``).

The inverse depth stays on the device through clamping, normalisation and
the colour lookup at grid resolution; the host sees pixels only to encode.
Save policy, as the JAX package's: a PNG larger than the grid is upsized
on the host from the grid image (3 B/px crosses to the host at grid size)
when the native resizer and encoder are present; otherwise the image is
resized on the device and encoded at full size; other formats go through
PIL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from matrix_eyes_tpu.errors import OutputError
from matrix_eyes_tpu_torch.ops.colormap import map_depth
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.output import png

CLIP_DEPTH_MIN = 0.1
CLIP_DEPTH_MAX = 250.0


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

    def output_image(self, destination_path: str) -> None:
        """Write the viridis depth map at the source size."""
        dest = destination_path.lower()
        if dest.endswith(".ply") or dest.endswith(".obj"):
            raise OutputError("mesh output is not supported by the PyTorch port yet")
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
