"""Depth Pro in plain float32 PyTorch: the benchmark's reference forward.

Apple ml-depth-pro's network (``src/depth_pro/depth_pro.py``,
``network/{vit,encoder,decoder,fov}.py``) at the widths of the cell's
configuration, written from the published description in the layouts of
``spec.py``, with no kernel, cache, graph or batching trick and nothing of
the program under test:

* three DINOv2 ViTs (pre-norm blocks, LayerScale, exact GELU, softmax
  attention): the patch encoder over a 35-tile pyramid (5x5 tiles of the
  1536 input at overlap 1/4, 3x3 tiles of its half at overlap 1/2, and its
  quarter), the image encoder over the quarter, and the FOV encoder;
* the encoder's overlap-trimmed merges, 1x1 projections and 2x2/s2
  transposed-conv chains, and the low-resolution fusion;
* the DPT decoder (3x3 projections, residual conv units, fusion blocks
  with a transposed conv then a 1x1 conv);
* the head, stage by stage: conv 3x3, transposed conv 2x2/s2, conv 3x3,
  ReLU, conv 1x1, ReLU;
* the FOV head: a linear on the tokens, a strided conv of the decoder's
  coarsest features, three strided convs and a valid conv to one angle.

The inverse depth is the canonical inverse depth over the normalised focal
length, clamped to [1e-4, 1e4]; without a known focal length the FOV's
angle gives it, ``f_norm = tan(fov / 2) / 0.5``. TF32 stays off.
``computed_in("fp8")`` runs the same forward with every product's operands
rounded to float8, ``computed_in("fp8_vit")`` those of the three ViTs'
products alone: the lower precisions of a cell's control.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_rounding = [None]  # the operands' rounding of a lower-precision run, or None
_vit_only = [False]  # round only inside the ViTs
_in_vit = [False]


def configure_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude to the format's largest, 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def computed_in(precision: str):
    """Within the block every product's operands (activations and weights of
    the linears, convolutions and attention) are rounded to float8 before
    the float32 product ("fp8"), or only those of the products inside the
    ViTs ("fp8_vit"): the reference one precision below a bf16
    configuration, the control its comparison has to refuse."""
    _rounding[0], _vit_only[0] = {"fp8": (_fp8, False), "fp8_vit": (_fp8, True)}[precision]
    try:
        yield
    finally:
        _rounding[0], _vit_only[0] = None, False


def _r(x: torch.Tensor) -> torch.Tensor:
    if _rounding[0] is None or (_vit_only[0] and not _in_vit[0]):
        return x
    return _rounding[0](x)


def linear(x, w, b=None):
    y = _r(x) @ _r(w.float())
    return y if b is None else y + b.float()


def conv(x, w, b=None, stride=1, padding=0):
    """NHWC activations, HWIO weights."""
    y = F.conv2d(_r(x).permute(0, 3, 1, 2), _r(w.float()).permute(3, 2, 0, 1),
                 None if b is None else b.float(), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def deconv2x2(x, w, b=None):
    """Transposed conv 2x2/s2: ``out[2i+a, 2j+c, o] = sum_k x[i, j, k] w[k, (2a+c) Co + o]``."""
    B, H, W, _ = x.shape
    co = w.shape[1] // 4
    y = (_r(x) @ _r(w.float())).reshape(B, H, W, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(B, 2 * H, 2 * W, co)
    return y if b is None else y + b.float()


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def attention(qkv, heads):
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    s = _r(q * (1.0 / math.sqrt(C // heads))) @ _r(k).transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    return (_r(p) @ _r(v)).transpose(1, 2).reshape(B, N, C)


def vit(cfg, p, x, wanted: Sequence[int] = ()) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: (B, S, S, 3). Returns the final normed tokens and the activations
    after the blocks in ``wanted``."""
    _in_vit[0] = True
    try:
        return _vit(cfg, p, x, wanted)
    finally:
        _in_vit[0] = False


def _vit(cfg, p, x, wanted):
    P, D = cfg["patch_size"], cfg["embed_dim"]
    B, H, W, C = x.shape
    gh, gw = H // P, W // P
    patches = x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, -1)
    t = linear(patches, p["patch_embed"]["w"], p["patch_embed"]["b"])
    t = torch.cat([p["cls_token"].float().expand(B, 1, D), t], dim=1) + p["pos_embed"].float()
    blocks, eps, inters = p["blocks"], cfg["layer_norm_eps"], []
    for i in range(cfg["depth"]):
        b = {k: v[i] for k, v in blocks.items()}
        h = layer_norm(t, b["norm1_scale"], b["norm1_bias"], eps)
        h = attention(linear(h, b["qkv_w"], b["qkv_b"]), cfg["num_heads"])
        t = t + linear(h, b["proj_w"], b["proj_b"]) * b["ls1"].float()
        h = layer_norm(t, b["norm2_scale"], b["norm2_bias"], eps)
        h = linear(F.gelu(linear(h, b["fc1_w"], b["fc1_b"])), b["fc2_w"], b["fc2_b"])
        t = t + h * b["ls2"].float()
        if i in wanted:
            inters.append(t)
    return layer_norm(t, p["norm"]["scale"], p["norm"]["bias"], eps), inters


def _grid(cfg, tokens):
    s = cfg["vit_img_size"] // cfg["patch_size"]
    return tokens[:, 1:, :].reshape(tokens.shape[0], s, s, -1)


def _split(x, patch, overlap_div):
    stride = patch - patch // overlap_div
    size = x.shape[1]
    return torch.cat([x[:, j:j + patch, i:i + patch, :]
                      for j in range(0, size - patch + 1, stride)
                      for i in range(0, size - patch + 1, stride)], dim=0)


def _merge(x, batch, pad):
    n, h, w, _ = x.shape
    steps = int(round((n // batch) ** 0.5))
    rows = []
    for j in range(steps):
        row = []
        for i in range(steps):
            tile = x[batch * (j * steps + i):batch * (j * steps + i + 1)]
            row.append(tile[:, pad if j else 0:h - pad if j < steps - 1 else h,
                            pad if i else 0:w - pad if i < steps - 1 else w])
        rows.append(torch.cat(row, dim=2))
    return torch.cat(rows, dim=1)


def _upsample(p, x):
    x = linear(x, p["proj"])
    for w in p["deconvs"]:
        x = deconv2x2(x, w)
    return x


def down_half(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def down_quarter(x):
    """Bilinear 4x downsample (align_corners False): the mean of pixels
    4i+1 and 4i+2 in both axes."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 4, 4, W // 4, 4, C)[:, :, 1:3, :, 1:3, :].mean(dim=(2, 4))


def encoder(cfg, p, x) -> List[torch.Tensor]:
    P = cfg["vit_img_size"]
    t = P // cfg["patch_size"]
    B = x.shape[0]
    x1, x2 = down_half(x), down_quarter(x)
    t0, t1 = _split(x, P, 4), _split(x1, P, 2)
    n0, n1 = t0.shape[0], t1.shape[0]
    final, (h0, h1) = vit(cfg, p["patch_encoder"], torch.cat([t0, t1, x2]),
                          cfg["highres_block_ids"])
    enc, h0, h1 = _grid(cfg, final), _grid(cfg, h0), _grid(cfg, h1)
    latent0 = _upsample(p["upsample_latent0"], _merge(h0[:n0], B, t // 8))
    latent1 = _upsample(p["upsample_latent1"], _merge(h1[:n0], B, t // 8))
    f0 = _upsample(p["upsample0"], _merge(enc[:n0], B, t // 8))
    f1 = _upsample(p["upsample1"], _merge(enc[n0:n0 + n1], B, t // 4))
    f2 = _upsample(p["upsample2"], enc[n0 + n1:])
    g, _ = vit(cfg, p["image_encoder"], x2)
    g = deconv2x2(_grid(cfg, g), p["upsample_lowres"]["w"], p["upsample_lowres"]["b"])
    g = linear(torch.cat([f2, g], dim=-1), p["fuse_lowres"]["w"], p["fuse_lowres"]["b"])
    return [latent0, latent1, f0, f1, g]


def _rcu(p, x):
    h = conv(F.relu(x), p["conv1_w"], p["conv1_b"], padding=1)
    return x + conv(F.relu(h), p["conv2_w"], p["conv2_b"], padding=1)


def _fusion(p, x0, x1):
    out = x0 if x1 is None else x0 + _rcu(p["resnet1"], x1)
    out = _rcu(p["resnet2"], out)
    if "deconv_w" in p:
        out = deconv2x2(out, p["deconv_w"])
    return linear(out, p["out_conv_w"], p["out_conv_b"])


def decoder(p, enc) -> Tuple[torch.Tensor, torch.Tensor]:
    convs, fusions = p["convs"], p["fusions"]
    feat = conv(enc[-1], convs[-1]["w"], padding=1)
    lowres = feat
    feat = _fusion(fusions[-1], feat, None)
    for i in range(len(enc) - 2, -1, -1):
        e = enc[i] if i == 0 else conv(enc[i], convs[i - 1]["w"], padding=1)
        feat = _fusion(fusions[i], feat, e)
    return feat, lowres


def head(p, feat) -> torch.Tensor:
    x = conv(feat, p["conv0_w"], p["conv0_b"], padding=1)
    x = deconv2x2(x, p["deconv1_w"], p["deconv1_b"])
    x = F.relu(conv(x, p["conv2_w"], p["conv2_b"], padding=1))
    return F.relu(linear(x, p["conv3_w"], p["conv3_b"]))[..., 0]


def fov(cfg, p, x, lowres) -> torch.Tensor:
    """The FOV angle in degrees, (B,)."""
    s = cfg["vit_img_size"] // cfg["patch_size"]
    xq = down_quarter(x)
    tokens, _ = vit(cfg, p["encoder"], xq)
    feat = linear(tokens, p["linear"]["w"], p["linear"]["b"])[:, 1:, :].reshape(x.shape[0], s, s, -1)
    h = feat + F.relu(conv(lowres, p["downsample0"]["w"], p["downsample0"]["b"], 2, 1))
    h = F.relu(conv(h, p["head0"]["w"], p["head0"]["b"], 2, 1))
    h = F.relu(conv(h, p["head1"]["w"], p["head1"]["b"], 2, 1))
    return conv(h, p["head2"]["w"], p["head2"]["b"]).reshape(x.shape[0])


@torch.no_grad()
def inverse_depth(cfg, params, img: torch.Tensor, f_norms: Sequence[Optional[float]]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """img: (B, S, S, 3) normalised f32. Returns the (B, S, S) inverse depth
    clamped to [1e-4, 1e4] and, where some image lacks a focal length, the
    FOV angles (B,) (None otherwise)."""
    img = img.float()
    feat, lowres = decoder(params["decoder"], encoder(cfg, params["encoder"], img))
    canonical = head(params["head"], feat)
    fov_deg = None
    f = torch.tensor([1.0 if v is None else v for v in f_norms], device=img.device)
    if any(v is None for v in f_norms):
        fov_deg = fov(cfg, params["fov"], img, lowres)
        est = torch.tan(0.5 * fov_deg * math.pi / 180.0) / 0.5
        known = torch.tensor([v is not None for v in f_norms], device=img.device)
        f = torch.where(known, f, est)
    return torch.clamp(canonical / f.reshape(-1, 1, 1), 1e-4, 1e4), fov_deg
