"""Depth Anything V2 in plain float32 PyTorch: the benchmark's reference
forward of the ``depth_anything_v2`` architecture, functional, on a
weights dict in the layouts the benchmark hands to the program.

Written from the published code (github.com/DepthAnything/Depth-Anything-V2:
``depth_anything_v2/dpt.py``, ``dinov2.py``, ``util/blocks.py``,
``util/transform.py``), at the widths of the cell's configuration, with
no kernel, cache, graph or batching trick and nothing of the program:

* the photo / 255, resized bicubically (a = -0.75, half-pixel centres, no
  antialias; ``F.interpolate`` where the published code runs
  ``cv2.INTER_CUBIC``) to the lower-bound size in multiples of the patch
  that keeps its aspect (``Resize(..., keep_aspect_ratio=True,
  ensure_multiple_of=14, resize_method='lower_bound')``), ImageNet
  normalisation;
* the DINOv2 ViT (``model.py``'s blocks: pre-norm, LayerScale, exact GELU,
  softmax attention) on the patch grid, its position embedding
  interpolated bicubically at the scale factors (g + 0.1) / 37; the
  activations after the four tapped blocks, each through the final
  LayerNorm, the CLS token dropped;
* the DPT head: 1x1 projections, reassembly by 4x4/s4 and 2x2/s2
  transposed convs, identity and a 3x3/s2 conv, bias-free 3x3 convs to
  ``features``, four fusion blocks (residual conv units, bilinear with
  ``align_corners=True`` to the next level's size, then the 1x1), the
  head's 3x3, bilinear to the input's size, 3x3, ReLU, 1x1, ReLU.

The output is relative inverse depth at the input's grid. TF32 stays off.
``model.computed_in("fp8")`` rounds every product's operands to float8,
``"fp8_vit"`` those of the ViT's products alone: the cell's control.

``make_weights`` draws the weights from the configuration's seed under
the per-layer scheme of ``weights.py`` (matrices normal at 1 / fan_in of
one layer, LayerNorm scales uniform in [0.5, 1.5], other vectors uniform
in [0.05, 0.3]), so that the ViT's attention shapes the output, with one
departure: the head's last 1x1 conv (32 -> 1) takes the magnitudes of its
normal draw. Its input is ReLU'd and its bias positive, so the output is
positive everywhere, as a trained model's disparity is. Drawn with either
sign, the output's level across the whole image takes the sign of one
random sum: one draw in two puts it below zero, the final ReLU leaves a
map all but zero (a largest value of 0.078 against ~11 on another draw of
the same scheme), and the relative gaps that decide ``correct`` then
measure nothing.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eyebench.reference import image
from eyebench.reference import model as prims
from eyebench.reference.spec import leaves, tree_map

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_ALIGN = 128
_BLOCK_MATMULS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
_NORM_SCALES = ("norm1_scale", "norm2_scale", "scale")


# -- the parameter tree ------------------------------------------------------------------

def _rcu(c: int) -> Dict[str, Any]:
    return {"conv1_w": (3, 3, c, c), "conv1_b": (c,), "conv2_w": (3, 3, c, c), "conv2_b": (c,)}


def param_spec(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The tree's shapes: linears and 1x1 convs (in, out), convs HWIO, a
    k x k/sk transposed conv (in, k * k * out) in (row phase, column phase,
    out) order, the ViT's blocks stacked on a leading layer axis;
    ``refinenets[i]`` is the published ``refinenet{i + 1}``."""
    D, L, P = cfg["embed_dim"], cfg["depth"], cfg["patch_size"]
    M = cfg["mlp_ratio"] * D
    g = cfg["input_size"] // P
    F_ = cfg["features"]
    oc = tuple(cfg["out_channels"])
    h1, h2 = cfg["head_widths"]
    return {
        "pretrained": {
            "patch_embed": {"w": (P * P * 3, D), "b": (D,)},
            "cls_token": (1, 1, D),
            "pos_embed": (1, g * g + 1, D),
            "blocks": {
                "norm1_scale": (L, D), "norm1_bias": (L, D),
                "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
                "proj_w": (L, D, D), "proj_b": (L, D), "ls1": (L, D),
                "norm2_scale": (L, D), "norm2_bias": (L, D),
                "fc1_w": (L, D, M), "fc1_b": (L, M),
                "fc2_w": (L, M, D), "fc2_b": (L, D), "ls2": (L, D),
            },
            "norm": {"scale": (D,), "bias": (D,)},
        },
        "depth_head": {
            "projects": [{"w": (D, c), "b": (c,)} for c in oc],
            "resize0": {"w": (oc[0], 16 * oc[0]), "b": (oc[0],)},
            "resize1": {"w": (oc[1], 4 * oc[1]), "b": (oc[1],)},
            "resize3": {"w": (3, 3, oc[3], oc[3]), "b": (oc[3],)},
            "layer_rn": [{"w": (3, 3, c, F_)} for c in oc],
            "refinenets": [{"resnet1": _rcu(F_), "resnet2": _rcu(F_), "out_conv_w": (F_, F_),
                            "out_conv_b": (F_,)} for _ in range(4)],
            "output_conv1": {"w": (3, 3, F_, h1), "b": (h1,)},
            "output_conv2": {"w": (3, 3, h1, h2), "b": (h2,)},
            "output_conv3": {"w": (h2, 1), "b": (1,)},
        },
    }


def make_weights(cfg: Dict[str, Any], seed: int, device, served: torch.dtype) -> Dict[str, Any]:
    """The parameter tree on ``device`` in ``served`` (bf16 or f32), each
    leaf drawn as one layer's, in a few large draws (``weights.py``'s
    scheme and grouping: the blocks' matmul weights, then the rest), the
    last 1x1 conv's weights positive. The same seed, device and dtype give
    the same values."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    by_group: Dict[Tuple[str, bool], list] = {}
    for path, shape in leaves(param_spec(cfg)):
        one = shape[1:] if "blocks" in path else shape
        matrix = len(one) >= 2
        if matrix:
            affine = ((1.0 / max(math.prod(one[:-1]), 1)) ** 0.5, 0.0)
        else:
            lo, hi = (0.5, 1.5) if path[-1] in _NORM_SCALES else (0.05, 0.3)
            affine = (hi - lo, lo)
        group = "blocks" if "blocks" in path and path[-1] in _BLOCK_MATMULS else "rest"
        by_group.setdefault((group, matrix), []).append((path, tuple(shape), affine))
    made: Dict[Tuple, torch.Tensor] = {}
    for (_group, matrix), items in sorted(by_group.items()):
        items.sort(key=lambda it: it[2])
        offsets, n = [], 0
        for _path, shape, _affine in items:
            offsets.append(n)
            n += -(-math.prod(shape) // _ALIGN) * _ALIGN
        buf = (torch.randn(n, generator=gen, device=device, dtype=served) if matrix else
               torch.rand(n, generator=gen, device=device, dtype=served))
        for (path, shape, (mul, add)), off in zip(items, offsets):
            leaf = buf[off:off + math.prod(shape)]
            leaf.mul_(mul)
            if add:
                leaf.add_(add)
            made[path] = leaf.view(shape)
    made[("depth_head", "output_conv3", "w")].abs_()  # a positive disparity (module docstring)
    return tree_map(lambda path, _shape: made[path], param_spec(cfg))


# -- the photo ---------------------------------------------------------------------------

def input_size(cfg: Dict[str, Any], height: int, width: int) -> Tuple[int, int]:
    """(h, w) of the model's input for a height x width photo
    (``Resize.get_size`` at the lower bound, rounding half to even)."""
    m, size = cfg["patch_size"], cfg["input_size"]
    scale = max(size / height, size / width)

    def fit(x: float) -> int:
        y = int(np.round(x / m) * m)
        return int(np.ceil(x / m) * m) if y < size else y

    return fit(scale * height), fit(scale * width)


def preprocess(cfg: Dict[str, Any], rgb: np.ndarray, device) -> torch.Tensor:
    """(1, h, w, 3) float32 model input of an (H, W, 3) u8 photo."""
    x = torch.from_numpy(np.array(rgb)).to(device).float() / 255.0
    size = input_size(cfg, rgb.shape[0], rgb.shape[1])
    x = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bicubic", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).reshape(1, 3, 1, 1)
    return ((x - mean) / std).permute(0, 2, 3, 1)


# -- the network -------------------------------------------------------------------------

def pos_embed(cfg: Dict[str, Any], pe: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """``dinov2.py``'s ``interpolate_pos_encoding``: the published square
    grid as it is, else bicubic at the scale factors (g + 0.1) / s."""
    n = pe.shape[1] - 1
    if gh * gw == n and gh == gw:
        return pe
    s, c = int(math.sqrt(n)), pe.shape[-1]
    grid = F.interpolate(pe[:, 1:].reshape(1, s, s, c).permute(0, 3, 1, 2),
                         scale_factor=((gh + 0.1) / s, (gw + 0.1) / s), mode="bicubic",
                         antialias=False)
    return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], dim=1)


def vit_taps(cfg: Dict[str, Any], p: Dict[str, Any], x: torch.Tensor) -> List[torch.Tensor]:
    """The (B, gh, gw, C) patch tokens after each tapped block, through the
    final LayerNorm."""
    prims._in_vit[0] = True
    try:
        P, D = cfg["patch_size"], cfg["embed_dim"]
        B, H, W, C = x.shape
        gh, gw = H // P, W // P
        patches = x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, -1)
        t = prims.linear(patches, p["patch_embed"]["w"], p["patch_embed"]["b"])
        t = torch.cat([p["cls_token"].float().expand(B, 1, D), t], dim=1)
        t = t + pos_embed(cfg, p["pos_embed"].float(), gh, gw)
        blocks, eps, taps = p["blocks"], cfg["layer_norm_eps"], []
        for i in range(cfg["depth"]):
            b = {k: v[i] for k, v in blocks.items()}
            h = prims.layer_norm(t, b["norm1_scale"], b["norm1_bias"], eps)
            h = prims.attention(prims.linear(h, b["qkv_w"], b["qkv_b"]), cfg["num_heads"])
            t = t + prims.linear(h, b["proj_w"], b["proj_b"]) * b["ls1"].float()
            h = prims.layer_norm(t, b["norm2_scale"], b["norm2_bias"], eps)
            h = prims.linear(F.gelu(prims.linear(h, b["fc1_w"], b["fc1_b"])), b["fc2_w"],
                             b["fc2_b"])
            t = t + h * b["ls2"].float()
            if i in cfg["taps"]:
                normed = prims.layer_norm(t, p["norm"]["scale"], p["norm"]["bias"], eps)
                taps.append(normed[:, 1:].reshape(B, gh, gw, D))
        return taps
    finally:
        prims._in_vit[0] = False


def _deconv(x, w, b, k):
    """Transposed conv k x k/sk: ``out[k i + a, k j + c, o] = sum_q x[i, j, q]
    w[q, (k a + c) Co + o] + b[o]``."""
    B, H, W, _ = x.shape
    co = w.shape[1] // (k * k)
    y = prims.linear(x, w).reshape(B, H, W, k, k, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, k * H, k * W, co) + b.float()


def _bilinear(x, size):
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)


def _unit(p, x):
    h = prims.conv(F.relu(x), p["conv1_w"], p["conv1_b"], padding=1)
    return x + prims.conv(F.relu(h), p["conv2_w"], p["conv2_b"], padding=1)


def _fusion(p, x0, x1, size):
    out = x0 if x1 is None else x0 + _unit(p["resnet1"], x1)
    out = _bilinear(_unit(p["resnet2"], out), size)
    return prims.linear(out, p["out_conv_w"], p["out_conv_b"])


def head(cfg, p, taps, out_h: int, out_w: int) -> torch.Tensor:
    levels = []
    for i, t in enumerate(taps):
        x = prims.linear(t, p["projects"][i]["w"], p["projects"][i]["b"])
        if i == 0:
            x = _deconv(x, p["resize0"]["w"], p["resize0"]["b"], 4)
        elif i == 1:
            x = _deconv(x, p["resize1"]["w"], p["resize1"]["b"], 2)
        elif i == 3:
            x = prims.conv(x, p["resize3"]["w"], p["resize3"]["b"], stride=2, padding=1)
        levels.append(x)
    rn = [prims.conv(x, p["layer_rn"][i]["w"], padding=1) for i, x in enumerate(levels)]
    r = p["refinenets"]
    path = _fusion(r[3], rn[3], None, rn[2].shape[1:3])
    path = _fusion(r[2], path, rn[2], rn[1].shape[1:3])
    path = _fusion(r[1], path, rn[1], rn[0].shape[1:3])
    path = _fusion(r[0], path, rn[0], (2 * rn[0].shape[1], 2 * rn[0].shape[2]))
    out = prims.conv(path, p["output_conv1"]["w"], p["output_conv1"]["b"], padding=1)
    out = _bilinear(out, (out_h, out_w))
    out = F.relu(prims.conv(out, p["output_conv2"]["w"], p["output_conv2"]["b"], padding=1))
    return F.relu(prims.linear(out, p["output_conv3"]["w"], p["output_conv3"]["b"]))[..., 0]


@torch.no_grad()
def inverse_depth(cfg: Dict[str, Any], params: Dict[str, Any], rgb: np.ndarray, device,
                  precision: Optional[str] = None) -> torch.Tensor:
    """The (h, w) relative inverse depth of one (H, W, 3) u8 photo at the
    model's input grid, float32, or with the products' operands rounded to
    ``precision`` (``model.computed_in``: "fp8", "fp8_vit")."""
    prims.configure_precision()
    with prims.computed_in(precision) if precision else contextlib.nullcontext():
        x = preprocess(cfg, rgb, device)
        taps = vit_taps(cfg, params["pretrained"], x)
        return head(cfg, params["depth_head"], taps, x.shape[1], x.shape[2])[0]


def depth_map(inverse_depth: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The depth-map PNG's pixels of relative inverse depth: normalised
    near-bright over its own range (no metric clamp), coloured by viridis,
    Lanczos3-resized to the photo's size; (out_h, out_w, 3) u8."""
    d = inverse_depth.float()
    lo, hi = d.min(), d.max()
    v = torch.where(hi > lo, (hi - d) / (hi - lo), torch.zeros_like(d))
    lut = torch.from_numpy(image._viridis()).to(d.device)
    step = 1.0 / 255.0
    box = torch.clamp(torch.floor(v / step), 0, 254).long()
    r = ((v - step * box.float()) / step)[..., None]
    c = torch.floor(lut[box + 1] * r + lut[box] * (1.0 - r) + 0.5)
    grid = torch.where((v >= 1.0)[..., None], lut[255], c)
    return image.to_u8(image.resize(grid, out_h, out_w))
