"""Depth Anything V2 (``depth_anything_v2/dpt.py``'s ``DepthAnythingV2``):
the DINOv2 ViT's four taps (``models.vit.forward_taps``) through the DPT
head (``models.dpt``). The output is relative inverse depth
(affine-invariant disparity) at the input's size, ReLU'd: no focal length
enters and no metric depth comes out. It runs on one device: no mesh.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from matrix_eyes_tpu_torch.config import DepthAnythingConfig
from matrix_eyes_tpu_torch.models import dpt, vit

Params = Dict[str, Any]


@torch.no_grad()
def forward(cfg: DepthAnythingConfig, params: Params, img: torch.Tensor) -> torch.Tensor:
    """img: (B, H, W, 3) normalised NHWC, H and W multiples of the patch.
    Returns the (B, H, W) f32 relative inverse depth."""
    taps = vit.forward_taps(cfg, params["pretrained"], img)
    return dpt.forward(cfg, params["depth_head"], taps, img.shape[1], img.shape[2]).float()
