"""Depth Pro assembly: encoder -> decoder -> head (-> FOV).

Port of ``matrix_eyes_tpu/models/depth_pro.py``. The output is the
canonical inverse depth divided by the normalised focal length, clamped to
[1e-4, 1e4]; without a known focal length the FOV head estimates it as
``f_norm = tan(0.5 * fov_deg * pi / 180) / 0.5``, on the device (for a
whole batch, or for the images of a batch that lack one).

Inside ``parallel.patch_sharded`` each rank runs its shard: where the data
axis divides the batch, the decoder, head and FOV run on this rank's
images and the inverse depth and FOV are gathered at the end (the JAX
package's ``shard_batch``); otherwise they run replicated.
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
from matrix_eyes_tpu_torch.parallel.sharding import gather_batch, shard_batch

Params = Dict[str, Any]


def canonical_inverse_depth(cfg: ModelConfig, params: Params,
                            img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img: (B, S, S, 3) normalised NHWC. Returns (canonical (B, S, S),
    lowres_features for the FOV head); on a data mesh that divides B, this
    rank's B / data images of both."""
    encodings = encoder_mod.forward_encodings(cfg, params["encoder"], img)
    features, lowres = decoder_mod.forward(params["decoder"], encodings)
    canonical = head_mod.forward(params["head"], features)
    return canonical[..., 0], lowres


def _per_image(v, img: torch.Tensor) -> torch.Tensor:
    """A scalar or per-image (B,) value as a (B or 1,) f32 tensor on img's
    device, this rank's images of it where the batch is sharded."""
    t = torch.as_tensor(v, device=img.device).reshape(-1)
    return shard_batch(t) if t.shape[0] == img.shape[0] else t


@torch.no_grad()
def forward_with_fnorm(cfg: ModelConfig, params: Params, img: torch.Tensor,
                       f_norm) -> torch.Tensor:
    """Inverse depth for a known focal length. f_norm: scalar or (B,)."""
    canonical, _ = canonical_inverse_depth(cfg, params, img)
    f = _per_image(f_norm, img).float().reshape(-1, 1, 1)
    return gather_batch(torch.clamp(canonical.float() / f, 1e-4, 1e4), img.shape[0])


@torch.no_grad()
def forward_with_fov(cfg: ModelConfig, params: Params,
                     img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse depth with the FOV head estimating the focal length.
    Returns (inverse_depth (B, S, S), fov_deg (B,))."""
    canonical, lowres = canonical_inverse_depth(cfg, params, img)
    fov_deg = fov_mod.forward(cfg, params["fov"], shard_batch(img), lowres).float()
    f_norm = torch.tan(0.5 * fov_deg * math.pi / 180.0) / 0.5
    inv = canonical.float() / f_norm.reshape(-1, 1, 1)
    B = img.shape[0]
    return gather_batch(torch.clamp(inv, 1e-4, 1e4), B), gather_batch(fov_deg, B)


@torch.no_grad()
def forward_with_mixed_fnorm(cfg: ModelConfig, params: Params, img: torch.Tensor,
                             f_norm: torch.Tensor,
                             has_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch in which only some images have a known focal length: the FOV
    head runs once for the batch and fills ``f_norm`` where ``has_f`` is
    False. img: (B, S, S, 3); f_norm: (B,) f32 (ignored where has_f is
    False); has_f: (B,) bool. Returns (inverse_depth (B, S, S), fov_deg (B,))."""
    canonical, lowres = canonical_inverse_depth(cfg, params, img)
    fov_deg = fov_mod.forward(cfg, params["fov"], shard_batch(img), lowres).float()
    f_est = torch.tan(0.5 * fov_deg * math.pi / 180.0) / 0.5
    f_known = _per_image(f_norm, img).float()
    f = torch.where(_per_image(has_f, img), f_known, f_est)
    inv = canonical.float() / f.reshape(-1, 1, 1)
    B = img.shape[0]
    return gather_batch(torch.clamp(inv, 1e-4, 1e4), B), gather_batch(fov_deg, B)
