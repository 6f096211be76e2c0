"""Depth Anything V2's DPT head (``depth_anything_v2/dpt.py``'s ``DPTHead``
with ``use_bn`` and ``use_clstoken`` False; ``util/blocks.py``'s fusion
blocks), NHWC, on the port's primitives:

* each tap's (B, gh, gw, C) patch tokens through a 1x1 projection
  (``nn.linear``) to ``out_channels[i]``, then reassembled: a 4x4/s4 and a
  2x2/s2 transposed conv (``nn.deconv``: a matmul and depth-to-space),
  nothing, and a 3x3/s2 conv (``F.conv2d``);
* ``layer{i}_rn``: bias-free 3x3 convs to ``features`` (the conv3x3 kernel);
* four fusion blocks, coarse to fine: ``x0 + RCU1(x1)`` (where there is a
  skip input) and ``RCU2``, both residual conv units as Depth Pro's
  decoder runs them (``models.decoder.residual_conv_unit``: ReLU on load
  and the residuals added in the second conv's epilogue), then bilinear
  resampling with ``align_corners=True`` to the next level's size (2x for
  the finest), then the 1x1 ``out_conv``;
* the head: 3x3 to ``head_widths[0]``, bilinear to the input's size, 3x3 to
  ``head_widths[1]``, ReLU, 1x1 to one channel, ReLU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from matrix_eyes_tpu_torch.config import DepthAnythingConfig
from matrix_eyes_tpu_torch.models.decoder import residual_conv_unit
from matrix_eyes_tpu_torch.ops import nn

Params = Dict


def _fusion(p: Params, x0: torch.Tensor, x1: Optional[torch.Tensor],
            size: Tuple[int, int]) -> torch.Tensor:
    out = x0 if x1 is None else residual_conv_unit(p["resnet1"], x1, extra_skip=x0)
    out = residual_conv_unit(p["resnet2"], out)
    out = nn.resize_bilinear(out, *size)
    return nn.linear(out, p["out_conv_w"], p["out_conv_b"])


def reassemble(p: Params, taps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The four levels at 4x, 2x, 1x and 1/2x the patch grid, projected."""
    out = []
    for i, t in enumerate(taps):
        x = nn.linear(t, p["projects"][i]["w"], p["projects"][i]["b"])
        if i == 0:
            x = nn.deconv(x, p["resize0"]["w"], p["resize0"]["b"], 4)
        elif i == 1:
            x = nn.deconv(x, p["resize1"]["w"], p["resize1"]["b"], 2)
        elif i == 3:
            x = nn.conv2d(x, p["resize3"]["w"], p["resize3"]["b"], stride=2, padding=1)
        out.append(x)
    return out


def forward(cfg: DepthAnythingConfig, p: Params, taps: Sequence[torch.Tensor],
            out_h: int, out_w: int) -> torch.Tensor:
    """taps: four (B, gh, gw, C) tap grids. Returns the (B, out_h, out_w)
    relative inverse depth in the taps' dtype, ReLU'd."""
    levels = reassemble(p, taps)
    rn = [nn.conv2d(x, p["layer_rn"][i]["w"], padding=1) for i, x in enumerate(levels)]
    r = p["refinenets"]
    path = _fusion(r[3], rn[3], None, tuple(rn[2].shape[1:3]))
    path = _fusion(r[2], path, rn[2], tuple(rn[1].shape[1:3]))
    path = _fusion(r[1], path, rn[1], tuple(rn[0].shape[1:3]))
    path = _fusion(r[0], path, rn[0], (2 * rn[0].shape[1], 2 * rn[0].shape[2]))
    out = nn.conv2d(path, p["output_conv1"]["w"], p["output_conv1"]["b"], padding=1)
    out = nn.resize_bilinear(out, out_h, out_w)
    out = nn.conv2d(out, p["output_conv2"]["w"], p["output_conv2"]["b"], padding=1)
    out = nn.relu(nn.linear(nn.relu(out), p["output_conv3"]["w"], p["output_conv3"]["b"]))
    return out[..., 0]
