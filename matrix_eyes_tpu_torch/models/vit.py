"""DINOv2-style ViT-L/16 (port of ``matrix_eyes_tpu/models/vit.py``, one device).

Block parameters stay stacked along a leading layer axis, as the JAX
package keeps them; the layer loop indexes them. Attention runs through
the fused-qkv kernel on CUDA (``ops/flash_attention.py``) at the true
token count: the TPU's 592/640 token padding is not ported.

Under a narrow compute dtype the residual stream is carried in f32
(``cfg.vit_f32_residual``): branch inputs are cast down to the weights'
dtype for the matmuls, while LayerNorm inputs, residual adds and the
LayerScale products run in f32, the branch output cast up BEFORE the
LayerScale multiply.

Under ``--dtype int8`` the blocks hold int8 matmul weights (``qkv_qw``,
``proj_qw``, ... with f32 scales, ``ops/quant.py``): qkv and fc1 run as
int8 x int8 -> int32 products on dynamically quantized activations, proj
and fc2 on their weights dequantized to the compute dtype, which the
(unquantized) norm parameters carry.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv
from matrix_eyes_tpu_torch.ops.quant import dequantize_weight, is_quantized_blocks, qlinear

Params = Dict[str, torch.Tensor]


def block_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One pre-norm transformer block; ``p`` holds one layer's parameters."""
    quantized = is_quantized_blocks(p)
    # int8: the activations' compute dtype is the norm parameters'
    wdt = p["norm1_scale"].dtype if quantized else p["qkv_w"].dtype
    scale = 1.0 / (cfg.head_dim ** 0.5)
    h = nn.layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        qkv = qlinear(h, p["qkv_qw"], p["qkv_sw"], p["qkv_b"])
    else:
        qkv = nn.linear(h, p["qkv_w"], p["qkv_b"])  # (B, N, 3C)
    o = attention_qkv(qkv, cfg.num_heads, scale)
    proj_w = dequantize_weight(p["proj_qw"], p["proj_sw"], wdt) if quantized else p["proj_w"]
    o = nn.linear(o, proj_w, p["proj_b"])
    x = x + o.to(x.dtype) * p["ls1"].to(x.dtype)

    h = nn.layer_norm(x, p["norm2_scale"], p["norm2_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        h = qlinear(h, p["fc1_qw"], p["fc1_sw"], p["fc1_b"])
    else:
        h = nn.linear(h, p["fc1_w"], p["fc1_b"])
    h = nn.gelu(h)
    fc2_w = dequantize_weight(p["fc2_qw"], p["fc2_sw"], wdt) if quantized else p["fc2_w"]
    h = nn.linear(h, fc2_w, p["fc2_b"])
    return x + h.to(x.dtype) * p["ls2"].to(x.dtype)


def prepare_tokens(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Patch-embed, prepend the cls token, add the positional embedding.
    x: (B, S, S, 3) NHWC; returns (B, N + 1, C)."""
    tokens = nn.patch_embed(x, params["patch_embed"]["w"], params["patch_embed"]["b"],
                            cfg.patch_size)
    if tokens.shape[1] + 1 != params["pos_embed"].shape[1]:
        raise ValueError(
            f"pos_embed interpolation is not implemented: got {tokens.shape[1]} patch "
            f"tokens but pos_embed has {params['pos_embed'].shape[1] - 1}")
    cls = params["cls_token"].to(tokens.dtype).expand(x.shape[0], 1, tokens.shape[2])
    tokens = torch.cat([cls, tokens], dim=1)
    return tokens + params["pos_embed"].to(tokens.dtype)


def forward_features(cfg: ModelConfig, params: Params, x: torch.Tensor,
                     intermediate_blocks: Sequence[int] = ()
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Returns the final LayerNorm'd tokens and the (un-normed) activations
    after each block id in ``intermediate_blocks`` (sorted ascending), all
    in the compute dtype."""
    tokens = prepare_tokens(cfg, params, x)
    out_dt = tokens.dtype
    if cfg.vit_f32_residual and tokens.element_size() < 4:
        tokens = tokens.float()
    blocks = params["blocks"]
    wanted = set(intermediate_blocks)
    inters: List[torch.Tensor] = []
    for i in range(cfg.depth):
        tokens = block_forward(cfg, {k: v[i] for k, v in blocks.items()}, tokens)
        if i in wanted:
            inters.append(tokens.to(out_dt))
    final = nn.layer_norm(tokens, params["norm"]["scale"], params["norm"]["bias"],
                          cfg.layer_norm_eps)
    return final.to(out_dt), inters
