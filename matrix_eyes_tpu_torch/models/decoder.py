"""DPT-style multiresolution fusion decoder (port of
``matrix_eyes_tpu/models/decoder.py``).

* residual conv unit: x + conv3x3(relu(conv3x3(relu(x)))), both convs
  through the conv3x3 kernel with ReLU on load, and the residual (plus the
  fusion block's skip) added in the second conv's epilogue;
* fusion block: optional skip-add of RCU(skip), RCU, then the bias-free
  2x2/s2 deconv composed with the 1x1 out conv into one matmul;
* decoder: per-level 3x3 projections to the decoder width (none for the
  finest level), fusion blocks coarse to fine.

Returns (features, lowres_features): the finest fused grid and the
coarsest projected grid, which feeds the FOV head.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3

Params = Dict


def residual_conv_unit(p: Params, x: torch.Tensor,
                       extra_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = conv3x3(x, p["conv1_w"], p["conv1_b"], relu_in=True)
    return conv3x3(h, p["conv2_w"], p["conv2_b"], skip=x, skip2=extra_skip, relu_in=True)


def feature_fusion_block(p: Params, x0: torch.Tensor,
                         x1: Optional[torch.Tensor]) -> torch.Tensor:
    out = x0
    if x1 is not None:
        out = residual_conv_unit(p["resnet1"], x1, extra_skip=x0)
    out = residual_conv_unit(p["resnet2"], out)
    if "deconv_w" in p:
        # no nonlinearity between the deconv and the 1x1: compose them in f32
        wd = p["deconv_w"].float()  # (Ci, 4*Co)
        w1 = p["out_conv_w"].float()  # (Co, Cout)
        ci, co = wd.shape[0], wd.shape[1] // 4
        w = (wd.reshape(ci, 4, co) @ w1).reshape(ci, 4 * w1.shape[1])
        return nn.deconv2x2(out, w.to(out.dtype), p["out_conv_b"])
    return nn.linear(out, p["out_conv_w"], p["out_conv_b"])


def forward(params: Params, encodings: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    convs = params["convs"]
    fusions = params["fusions"]
    if len(encodings) != len(fusions):
        raise ValueError(
            f"got encoder output levels {len(encodings)}, expected levels {len(fusions)}")
    features = nn.conv2d(encodings[-1], convs[-1]["w"], padding=1)
    lowres_features = features
    features = feature_fusion_block(fusions[-1], features, None)
    for i in range(len(encodings) - 2, -1, -1):
        enc = encodings[i]
        if i > 0:
            enc = nn.conv2d(enc, convs[i - 1]["w"], padding=1)
        features = feature_fusion_block(fusions[i], features, enc)
    return features, lowres_features
