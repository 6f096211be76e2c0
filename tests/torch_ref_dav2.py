"""Depth Anything V2 in plain ``torch.nn``: the port's reference on the CPU.

Written from the published code (github.com/DepthAnything/Depth-Anything-V2):
``depth_anything_v2/dinov2.py`` and ``dinov2_layers/`` (the ViT: patch
embed, LayerScale blocks, ``interpolate_pos_encoding``,
``get_intermediate_layers``), ``util/blocks.py`` (``ResidualConvUnit``,
``FeatureFusionBlock``, ``_make_scratch``), ``dpt.py`` (``DPTHead``,
``DepthAnythingV2``, ``image2tensor``) and ``util/transform.py`` (``Resize``,
``NormalizeImage``), under the published state-dict key names
(``pretrained.*``, ``depth_head.*``), so that ``state_dict()`` is what
``depth_anything_v2_vit*.pth`` holds. It imports nothing of either
package. Float32, TF32 off.

Departures from the published code, each kept to what a test can hold:

* ``image2tensor`` resizes with ``F.interpolate(mode="bicubic",
  align_corners=False)`` where the published code calls
  ``cv2.resize(..., interpolation=cv2.INTER_CUBIC)``: the same kernel
  (a = -0.75, half-pixel centres, no antialias), borders clamped;
* no xFormers, no drop path, no mask token in the forward (inference);
* ``DINOv2`` keeps only what ``vit_large`` and the smaller presets use:
  plain MLP blocks, no register tokens, ``block_chunks`` 0.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INTERMEDIATE_LAYER_IDX = {"vits": [2, 5, 8, 11], "vitb": [2, 5, 8, 11],
                          "vitl": [4, 11, 17, 23], "vitg": [9, 19, 29, 39]}


# -- dinov2_layers ----------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)  # (B, N, C)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)).softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(init_values * torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    """``dinov2.py`` at ``img_size`` 518, ``interpolate_offset`` 0.1,
    ``interpolate_antialias`` False, no register tokens."""

    def __init__(self, img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                 mlp_ratio=4, interpolate_offset=0.1, interpolate_antialias=False):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.interpolate_offset = interpolate_offset
        self.interpolate_antialias = interpolate_antialias
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos_encoding(self, x, w, h):
        previous_dtype = x.dtype
        npatch = x.shape[1] - 1
        N = self.pos_embed.shape[1] - 1
        if npatch == N and w == h:
            return self.pos_embed
        pos_embed = self.pos_embed.float()
        class_pos_embed = pos_embed[:, 0]
        patch_pos_embed = pos_embed[:, 1:]
        dim = x.shape[-1]
        w0 = w // self.patch_size
        h0 = h // self.patch_size
        # a small number added to avoid floating point error in the interpolation
        w0, h0 = w0 + self.interpolate_offset, h0 + self.interpolate_offset
        sqrt_N = math.sqrt(N)
        sx, sy = float(w0) / sqrt_N, float(h0) / sqrt_N
        patch_pos_embed = F.interpolate(
            patch_pos_embed.reshape(1, int(sqrt_N), int(sqrt_N), dim).permute(0, 3, 1, 2),
            scale_factor=(sx, sy), mode="bicubic", antialias=self.interpolate_antialias)
        assert int(w0) == patch_pos_embed.shape[-2]
        assert int(h0) == patch_pos_embed.shape[-1]
        patch_pos_embed = patch_pos_embed.permute(0, 2, 3, 1).view(1, -1, dim)
        return torch.cat((class_pos_embed.unsqueeze(0), patch_pos_embed), dim=1).to(
            previous_dtype)

    def prepare_tokens(self, x):
        B, nc, w, h = x.shape
        x = self.patch_embed(x)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        return x + self.interpolate_pos_encoding(x, w, h)

    def get_intermediate_layers(self, x, n: Sequence[int], norm=True):
        """``return_class_token=True``: ((patch tokens, class token), ...)."""
        x = self.prepare_tokens(x)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in n:
                outputs.append(x)
        if norm:
            outputs = [self.norm(out) for out in outputs]
        return tuple((out[:, 1:], out[:, 0]) for out in outputs)


# -- util/blocks.py ---------------------------------------------------------------------

def _make_scratch(in_shape, out_shape):
    scratch = nn.Module()
    for i in range(4):
        setattr(scratch, f"layer{i + 1}_rn",
                nn.Conv2d(in_shape[i], out_shape, kernel_size=3, stride=1, padding=1, bias=False))
    return scratch


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.conv2 = nn.Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.activation = nn.ReLU(False)

    def forward(self, x):
        out = self.activation(x)
        out = self.conv1(out)
        out = self.activation(out)
        out = self.conv2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, align_corners=True):
        super().__init__()
        self.align_corners = align_corners
        self.out_conv = nn.Conv2d(features, features, kernel_size=1, stride=1, padding=0,
                                  bias=True)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs, size=None):
        output = xs[0]
        if len(xs) == 2:
            output = output + self.resConfUnit1(xs[1])
        output = self.resConfUnit2(output)
        modifier = {"scale_factor": 2} if size is None else {"size": size}
        output = F.interpolate(output, **modifier, mode="bilinear",
                               align_corners=self.align_corners)
        return self.out_conv(output)


# -- dpt.py -----------------------------------------------------------------------------

class DPTHead(nn.Module):
    def __init__(self, in_channels, features=256, out_channels=(256, 512, 1024, 1024),
                 head_features_2=32):
        super().__init__()
        self.projects = nn.ModuleList([
            nn.Conv2d(in_channels, c, kernel_size=1, stride=1, padding=0) for c in out_channels])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], kernel_size=4, stride=4,
                               padding=0),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], kernel_size=2, stride=2,
                               padding=0),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], kernel_size=3, stride=2, padding=1)])
        self.scratch = _make_scratch(out_channels, features)
        self.scratch.stem_transpose = None
        self.scratch.refinenet1 = FeatureFusionBlock(features)
        self.scratch.refinenet2 = FeatureFusionBlock(features)
        self.scratch.refinenet3 = FeatureFusionBlock(features)
        self.scratch.refinenet4 = FeatureFusionBlock(features)
        head_features_1 = features
        self.scratch.output_conv1 = nn.Conv2d(head_features_1, head_features_1 // 2,
                                              kernel_size=3, stride=1, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(head_features_1 // 2, head_features_2, kernel_size=3, stride=1, padding=1),
            nn.ReLU(True),
            nn.Conv2d(head_features_2, 1, kernel_size=1, stride=1, padding=0),
            nn.ReLU(True),
            nn.Identity())

    def forward(self, out_features, patch_h, patch_w):
        out = []
        for i, x in enumerate(out_features):
            x = x[0]
            x = x.permute(0, 2, 1).reshape((x.shape[0], x.shape[-1], patch_h, patch_w))
            x = self.projects[i](x)
            x = self.resize_layers[i](x)
            out.append(x)
        layer_1, layer_2, layer_3, layer_4 = out
        layer_1_rn = self.scratch.layer1_rn(layer_1)
        layer_2_rn = self.scratch.layer2_rn(layer_2)
        layer_3_rn = self.scratch.layer3_rn(layer_3)
        layer_4_rn = self.scratch.layer4_rn(layer_4)
        path_4 = self.scratch.refinenet4(layer_4_rn, size=layer_3_rn.shape[2:])
        path_3 = self.scratch.refinenet3(path_4, layer_3_rn, size=layer_2_rn.shape[2:])
        path_2 = self.scratch.refinenet2(path_3, layer_2_rn, size=layer_1_rn.shape[2:])
        path_1 = self.scratch.refinenet1(path_2, layer_1_rn)
        out = self.scratch.output_conv1(path_1)
        out = F.interpolate(out, (int(patch_h * 14), int(patch_w * 14)), mode="bilinear",
                            align_corners=True)
        return self.scratch.output_conv2(out)


class DepthAnythingV2(nn.Module):
    def __init__(self, encoder="vitl", features=256, out_channels=(256, 512, 1024, 1024),
                 img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                 mlp_ratio=4, head_features_2=32, intermediate_layer_idx=None):
        super().__init__()
        self.intermediate_layer_idx = (intermediate_layer_idx
                                       or INTERMEDIATE_LAYER_IDX[encoder])
        self.pretrained = DinoVisionTransformer(img_size, patch_size, embed_dim, depth,
                                                num_heads, mlp_ratio)
        self.depth_head = DPTHead(embed_dim, features, out_channels, head_features_2)

    def forward(self, x):
        patch_h, patch_w = x.shape[-2] // 14, x.shape[-1] // 14
        features = self.pretrained.get_intermediate_layers(x, self.intermediate_layer_idx)
        depth = self.depth_head(features, patch_h, patch_w)
        depth = F.relu(depth)
        return depth.squeeze(1)


# -- util/transform.py, image2tensor ------------------------------------------------------

def resize_size(height: int, width: int, input_size: int = 518,
                multiple_of: int = 14) -> Tuple[int, int]:
    """``Resize(width=input_size, height=input_size, keep_aspect_ratio=True,
    ensure_multiple_of=multiple_of, resize_method='lower_bound')``'s
    ``get_size``, as (height, width)."""
    def constrain_to_multiple_of(x, min_val=0):
        y = (np.round(x / multiple_of) * multiple_of).astype(int)
        if y < min_val:
            y = (np.ceil(x / multiple_of) * multiple_of).astype(int)
        return y

    scale_height = input_size / height
    scale_width = input_size / width
    if scale_width > scale_height:
        scale_height = scale_width
    else:
        scale_width = scale_height
    new_height = constrain_to_multiple_of(scale_height * height, min_val=input_size)
    new_width = constrain_to_multiple_of(scale_width * width, min_val=input_size)
    return int(new_height), int(new_width)


def image2tensor(rgb: np.ndarray, input_size: int = 518) -> torch.Tensor:
    """An (H, W, 3) u8 RGB photo to the model's (1, 3, h, w) f32 input:
    / 255, bicubic to ``resize_size`` (``F.interpolate`` for
    ``cv2.INTER_CUBIC``), ImageNet normalisation."""
    x = torch.from_numpy(np.asarray(rgb, np.float32) / 255.0).permute(2, 0, 1)[None]
    h, w = resize_size(rgb.shape[0], rgb.shape[1], input_size)
    x = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1)
    return (x - mean) / std


# -- seeded weights -----------------------------------------------------------------------

def randomize(model: nn.Module, seed: int = 0) -> nn.Module:
    """Every parameter drawn from ``seed`` so that each layer shapes the
    output: weights of two or more axes normal at 1 / fan_in (fan-in: every
    axis but the first), LayerNorm scales uniform in [0.5, 1.5], every other
    vector uniform in [0.05, 0.3] (biases, LayerScale, the embeddings'
    rows). Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("pos_embed") or name.endswith("cls_token") or name.endswith(
                    "mask_token"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
            elif p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                if isinstance(_owner(model, name), nn.ConvTranspose2d):
                    fan_in = p.shape[0]
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            else:
                p.copy_(torch.rand(p.shape, generator=gen) * 0.25 + 0.05)
    return model


def _owner(model: nn.Module, name: str) -> nn.Module:
    m = model
    for part in name.split(".")[:-1]:
        m = getattr(m, part)
    return m


@torch.no_grad()
def infer(model: DepthAnythingV2, rgb: np.ndarray, input_size: int) -> torch.Tensor:
    """The (h, w) relative inverse depth of one photo at the model's input
    grid (``infer_image`` without its final resize to the photo)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return model(image2tensor(rgb, input_size))[0]


def tap_grids(model: DepthAnythingV2, x: torch.Tensor) -> List[torch.Tensor]:
    """The four taps' patch tokens, (B, N, C), through the final norm."""
    return [t for t, _cls in model.pretrained.get_intermediate_layers(
        x, model.intermediate_layer_idx)]
