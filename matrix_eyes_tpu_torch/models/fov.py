"""Field-of-view head (port of ``matrix_eyes_tpu/models/fov.py``).

A third ViT-L runs on the image downsampled 1536 -> 384; its tokens go
through a linear 1024 -> 128, drop the cls token and fold to a (24, 24,
128) grid; a strided conv of the decoder's lowres features is added; a
small conv head reduces to one scalar, the FOV in degrees.

The FOV scalar divides every output depth, so this network runs its
activations in f32 under every dtype. Its float weights are the policy's
values upcast to f32 (``pt.convert`` and ``models.init`` store them so);
the upcast here is a no-op for them. Under ``--dtype int8`` its block
matmul weights stay int8 codes with their f32 scales: the JAX package
casts them to f32 and its int8 x f32 product returns integers, so the
products are the int8 products ``ops/quant.qlinear`` computes.
"""

from __future__ import annotations

from typing import Dict

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models import vit
from matrix_eyes_tpu_torch.models.spec import tree_map
from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.ops.resize import downsample_quarter

Params = Dict


def forward(cfg: ModelConfig, params: Params, x: torch.Tensor,
            lowres_feature: torch.Tensor) -> torch.Tensor:
    """x: (B, 1536, 1536, 3) input image; lowres_feature: (B, 48, 48, 256)
    from the decoder. Returns the FOV in degrees, shape (B,)."""
    s = cfg.tokens_per_side
    x = downsample_quarter(x.float())
    lowres_feature = lowres_feature.float()
    params = tree_map(lambda _path, t: t.float() if t.is_floating_point() else t, params)
    tokens, _ = vit.forward_features(cfg, params["encoder"], x)
    tokens = nn.linear(tokens, params["linear"]["w"], params["linear"]["b"])
    feat = tokens[:, 1:, :].reshape(x.shape[0], s, s, -1)

    low = nn.conv2d(lowres_feature, params["downsample0"]["w"], params["downsample0"]["b"],
                    stride=2, padding=1)
    h = feat + nn.relu(low)
    h = nn.relu(nn.conv2d(h, params["head0"]["w"], params["head0"]["b"], stride=2, padding=1))
    h = nn.relu(nn.conv2d(h, params["head1"]["w"], params["head1"]["b"], stride=2, padding=1))
    h = nn.conv2d(h, params["head2"]["w"], params["head2"]["b"])  # 6x6, valid
    return h.reshape(x.shape[0])
