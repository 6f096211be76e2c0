"""DINOv2-style ViT-L/16 (port of ``matrix_eyes_tpu/models/vit.py``).

Block parameters stay stacked along a leading layer axis, as the JAX
package keeps them; the layer loop indexes them. Attention runs through
the fused-qkv kernel on CUDA (``ops/flash_attention.py``) at the true
token count: the TPU's 592/640 token padding is not ported.

Under a narrow compute dtype the residual stream is carried in f32
(``cfg.vit_f32_residual``): branch inputs are cast down to the weights'
dtype for the matmuls, while LayerNorm inputs, residual adds and the
LayerScale products run in f32, the branch output cast up BEFORE the
LayerScale multiply. The GELU and the LayerScale residual add run as one
pass each on the card (``nn.gelu_``, ``nn.scaled_residual``).

Under ``--dtype int8`` the blocks hold int8 matmul weights (``qkv_qw``,
``proj_qw``, ... with f32 scales, ``ops/quant.py``): qkv and fc1 run as
int8 x int8 -> int32 products on dynamically quantized activations, proj
and fc2 on their weights dequantized to the compute dtype, which the
(unquantized) norm parameters carry.

Under a model-parallel mesh (``parallel.sharding``) the blocks hold the
head-group layout (``qkv_gw``/``qkv_gb``, int8 ``qkv_gqw``/``qkv_gsw``)
cut to this rank: qkv and fc1 run on this rank's columns and the
attention kernel on its ``num_heads / k`` heads with no collective; proj
and fc2 run on this rank's rows and their f32 partial products are
all-reduced before the bias. Grouped parameters outside the mesh they were
cut for raise, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv
from matrix_eyes_tpu_torch.ops.quant import dequantize_weight, is_quantized_blocks, qlinear
from matrix_eyes_tpu_torch.parallel.collectives import all_reduce_sum
from matrix_eyes_tpu_torch.parallel.sharding import active_model_parallel

Params = Dict[str, torch.Tensor]


def _tp_mesh(cfg: ModelConfig, p: Params):
    """The mesh a head-group (tensor-parallel) block runs on, None for a
    checkpoint-layout block; raises where the layout and the enclosing
    mesh disagree. The degree the columns were permuted for is read from
    the grouped bias's width, 3C / k, on every shard of it."""
    mesh = active_model_parallel()
    if "qkv_gw" not in p and "qkv_gqw" not in p:
        if mesh is not None:
            raise ValueError(f"checkpoint-layout qkv parameters under a model-parallel mesh "
                             f"(degree {mesh.model}): cut them with parallel.shard_params")
        return None
    k_perm = 3 * cfg.embed_dim // p["qkv_gb"].shape[-1]
    if mesh is None or mesh.model != k_perm or cfg.num_heads % k_perm != 0:
        key = "quantized qkv parameters (qkv_gqw" if "qkv_gqw" in p else "qkv parameters (qkv_gw"
        raise ValueError(
            f"TP-grouped {key}, permuted for model-parallel degree {k_perm}) require the "
            f"matching patch_sharded mesh context (active: "
            f"{'none' if mesh is None else mesh.model})")
    if p["qkv_gb"].shape[-2] != 1:
        raise ValueError("TP-grouped qkv parameters hold every head group: cut them for this "
                         "rank with parallel.shard_params")
    return mesh


def _row_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """A linear whose input features are split over the model axis: each
    rank's f32 partial product, summed over the ranks in f32, then the bias
    once and one rounding to ``x.dtype``."""
    if mesh is None:
        return nn.linear(x, w, b)
    y = all_reduce_sum(nn.matmul_f32(x, w), mesh, "model")
    return (y + b.float()).to(x.dtype)


def block_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One pre-norm transformer block; ``p`` holds one layer's parameters
    (under tensor parallelism this rank's columns of qkv and fc1 and rows
    of proj and fc2)."""
    quantized = is_quantized_blocks(p)
    mesh = _tp_mesh(cfg, p)
    k = 1 if mesh is None else mesh.model
    qkv_key = "qkv_g" if mesh is not None else "qkv_"
    b_qkv = p["qkv_gb"].reshape(-1) if mesh is not None else p["qkv_b"]
    # int8: the activations' compute dtype is the norm parameters'
    wdt = p["norm1_scale"].dtype if quantized else p[qkv_key + "w"].dtype
    scale = 1.0 / (cfg.head_dim ** 0.5)
    h = nn.layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        qkv = qlinear(h, p[qkv_key + "qw"], p[qkv_key + "sw"], b_qkv)
    else:
        qkv = nn.linear(h, p[qkv_key + "w"], b_qkv)  # (B, N, 3C / k)
    # under TP this rank's qkv columns are the whole [q|k|v] of its H / k heads
    o = attention_qkv(qkv, cfg.num_heads // k, scale)
    proj_w = dequantize_weight(p["proj_qw"], p["proj_sw"], wdt) if quantized else p["proj_w"]
    o = _row_linear(o, proj_w, p["proj_b"], mesh)
    x = nn.scaled_residual(x, o, p["ls1"])

    h = nn.layer_norm(x, p["norm2_scale"], p["norm2_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        h = qlinear(h, p["fc1_qw"], p["fc1_sw"], p["fc1_b"])
    else:
        h = nn.linear(h, p["fc1_w"], p["fc1_b"])
    h = nn.gelu_(h)
    fc2_w = dequantize_weight(p["fc2_qw"], p["fc2_sw"], wdt) if quantized else p["fc2_w"]
    h = _row_linear(h, fc2_w, p["fc2_b"], mesh)
    return nn.scaled_residual(x, h, p["ls2"])


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
