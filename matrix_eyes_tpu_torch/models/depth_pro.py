"""Depth Pro assembly: encoder -> decoder -> head (-> FOV).

Port of ``matrix_eyes_tpu/models/depth_pro.py``. The output is the
canonical inverse depth divided by the normalised focal length, clamped to
[1e-4, 1e4]; without a known focal length the FOV head estimates it as
``f_norm = tan(0.5 * fov_deg * pi / 180) / 0.5``, on the device (for a
whole batch, or for the images of a batch that lack one).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models import decoder as decoder_mod
from matrix_eyes_tpu_torch.models import encoder as encoder_mod
from matrix_eyes_tpu_torch.models import fov as fov_mod
from matrix_eyes_tpu_torch.models import head as head_mod

Params = Dict[str, Any]


def canonical_inverse_depth(cfg: ModelConfig, params: Params,
                            img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img: (B, S, S, 3) normalised NHWC. Returns (canonical (B, S, S),
    lowres_features for the FOV head)."""
    encodings = encoder_mod.forward_encodings(cfg, params["encoder"], img)
    features, lowres = decoder_mod.forward(params["decoder"], encodings)
    canonical = head_mod.forward(params["head"], features)
    return canonical[..., 0], lowres


@torch.no_grad()
def forward_with_fnorm(cfg: ModelConfig, params: Params, img: torch.Tensor,
                       f_norm) -> torch.Tensor:
    """Inverse depth for a known focal length. f_norm: scalar or (B,)."""
    canonical, _ = canonical_inverse_depth(cfg, params, img)
    f = torch.as_tensor(f_norm, dtype=torch.float32, device=img.device).reshape(-1, 1, 1)
    return torch.clamp(canonical.float() / f, 1e-4, 1e4)


@torch.no_grad()
def forward_with_fov(cfg: ModelConfig, params: Params,
                     img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse depth with the FOV head estimating the focal length.
    Returns (inverse_depth (B, S, S), fov_deg (B,))."""
    canonical, lowres = canonical_inverse_depth(cfg, params, img)
    fov_deg = fov_mod.forward(cfg, params["fov"], img, lowres).float()
    f_norm = torch.tan(0.5 * fov_deg * math.pi / 180.0) / 0.5
    inv = canonical.float() / f_norm.reshape(-1, 1, 1)
    return torch.clamp(inv, 1e-4, 1e4), fov_deg


@torch.no_grad()
def forward_with_mixed_fnorm(cfg: ModelConfig, params: Params, img: torch.Tensor,
                             f_norm: torch.Tensor,
                             has_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch in which only some images have a known focal length: the FOV
    head runs once for the batch and fills ``f_norm`` where ``has_f`` is
    False. img: (B, S, S, 3); f_norm: (B,) f32 (ignored where has_f is
    False); has_f: (B,) bool. Returns (inverse_depth (B, S, S), fov_deg (B,))."""
    canonical, lowres = canonical_inverse_depth(cfg, params, img)
    fov_deg = fov_mod.forward(cfg, params["fov"], img, lowres).float()
    f_est = torch.tan(0.5 * fov_deg * math.pi / 180.0) / 0.5
    f_known = torch.as_tensor(f_norm, dtype=torch.float32, device=img.device)
    f = torch.where(torch.as_tensor(has_f, device=img.device), f_known, f_est)
    inv = canonical.float() / f.reshape(-1, 1, 1)
    return torch.clamp(inv, 1e-4, 1e4), fov_deg
