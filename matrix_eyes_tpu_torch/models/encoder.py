"""Multi-scale pyramid encoder (port of ``matrix_eyes_tpu/models/encoder.py``).

Pyramid 1536/768/384 -> overlapping 384^2 patch split (25 + 9 + 1 = 35
patches per image) -> shared ViT-L patch encoder with highres
intermediates -> overlap-trimmed merge back to feature grids -> per-scale
projection + upsample chains -> low-res fusion with the separate ViT-L
image encoder. On a device mesh the pyramid's patches are split over the
data ranks and gathered before the merge, as the JAX package's
``shard_patches`` constraint has GSPMD do.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models import vit
from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.ops.resize import downsample_half, downsample_quarter
from matrix_eyes_tpu_torch.parallel.sharding import gather_patches, shard_batch, shard_patches

Params = Dict


def split(x: torch.Tensor, patch: int, overlap_div: int) -> torch.Tensor:
    """Split (B, S, S, C) into overlapping (patch x patch) tiles, stacked on
    the batch axis rows outer, columns inner."""
    stride = patch - patch // overlap_div
    size = x.shape[1]
    tiles = [x[:, j:j + patch, i:i + patch, :]
             for j in range(0, size - patch + 1, stride)
             for i in range(0, size - patch + 1, stride)]
    return torch.cat(tiles, dim=0)


def merge(x: torch.Tensor, batch_size: int, padding: int) -> torch.Tensor:
    """Inverse of split on feature grids: trim ``padding`` feature pixels
    from interior tile edges and re-tile (steps*steps*B, h, w, C) into
    (B, H, W, C)."""
    b, h, w, _ = x.shape
    steps = int((b // batch_size) ** 0.5)
    rows = []
    for j in range(steps):
        row = []
        for i in range(steps):
            idx = j * steps + i
            tile = x[batch_size * idx:batch_size * (idx + 1)]
            h0 = padding if j > 0 else 0
            h1 = h - padding if j < steps - 1 else h
            w0 = padding if i > 0 else 0
            w1 = w - padding if i < steps - 1 else w
            row.append(tile[:, h0:h1, w0:w1, :])
        rows.append(torch.cat(row, dim=2))
    return torch.cat(rows, dim=1)


def reshape_feature(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Drop the cls token and fold tokens to an NHWC grid."""
    b, _, c = tokens.shape
    s = cfg.tokens_per_side
    return tokens[:, 1:, :].reshape(b, s, s, c)


def _upsample_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """1x1 projection (no bias) + chain of bias-free 2x2/s2 deconvs."""
    x = nn.linear(x, p["proj"])
    for w in p["deconvs"]:
        x = nn.deconv2x2(x, w)
    return x


def forward_encodings(cfg: ModelConfig, params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (B, 1536, 1536, 3) NHWC. Returns 5 NHWC encodings, finest to
    coarsest: 768^2@256, 384^2@256, 192^2@512, 96^2@1024, 48^2@1024 for
    ``DEPTH_PRO``. Inside ``parallel.patch_sharded`` the patch ViT runs on
    this rank's patches and, where the data axis divides B, the encodings
    are this rank's B / data images (``parallel.sharding.shard_batch``)."""
    P = cfg.vit_img_size
    out_size = cfg.tokens_per_side
    pad_hi = out_size // 8
    pad_lo = out_size // 4
    batch_size = x.shape[0]

    x1 = downsample_half(x)
    x2 = downsample_quarter(x)
    x0_patches = split(x, P, 4)  # 25 * B
    x1_patches = split(x1, P, 2)  # 9 * B
    n0, n1 = x0_patches.shape[0], x1_patches.shape[0]
    pyramid = torch.cat([x0_patches, x1_patches, x2], dim=0)  # 35 * B

    # on a data mesh: this rank's rows of the pyramid, padded to a multiple
    # of the data axis; the feature grids are gathered back before the merge
    pyramid, n_patches = shard_patches(pyramid)
    encodings, (highres0, highres1) = vit.forward_features(
        cfg, params["patch_encoder"], pyramid, intermediate_blocks=cfg.highres_block_ids)
    enc_grid, highres0, highres1 = (gather_patches(reshape_feature(cfg, t), n_patches)
                                    for t in (encodings, highres0, highres1))
    # where the data axis divides the batch, the rest runs on this rank's
    # images (the stacks are tile-major: tile outer, image inner)
    local = shard_batch(x2).shape[0]
    # highres intermediates come from the x0 patches only
    latent0 = merge(shard_batch(highres0[:n0], batch_size), local, pad_hi)
    latent1 = merge(shard_batch(highres1[:n0], batch_size), local, pad_hi)
    x0_feat = merge(shard_batch(enc_grid[:n0], batch_size), local, pad_hi)
    x1_feat = merge(shard_batch(enc_grid[n0:n0 + n1], batch_size), local, pad_lo)
    x2_feat = shard_batch(enc_grid[n0 + n1:], batch_size)

    global_tokens, _ = vit.forward_features(cfg, params["image_encoder"], shard_batch(x2))
    global_feat = reshape_feature(cfg, global_tokens)

    latent0 = _upsample_block(params["upsample_latent0"], latent0)
    latent1 = _upsample_block(params["upsample_latent1"], latent1)
    x0_feat = _upsample_block(params["upsample0"], x0_feat)
    x1_feat = _upsample_block(params["upsample1"], x1_feat)
    x2_feat = _upsample_block(params["upsample2"], x2_feat)

    global_feat = nn.deconv2x2(global_feat, params["upsample_lowres"]["w"],
                               params["upsample_lowres"]["b"])
    fused = torch.cat([x2_feat, global_feat], dim=-1)
    global_feat = nn.linear(fused, params["fuse_lowres"]["w"], params["fuse_lowres"]["b"])
    return [latent0, latent1, x0_feat, x1_feat, global_feat]
