"""Mixed weight precision (``--dtype mixed``): bf16 ViT block matmul
weights, every other parameter f32.

A copy of ``matrix_eyes_tpu/ops/mixed.py`` on the port's parameter tree
(paths of dict keys and list indices, ``models.spec.tree_map``). The
policy keeps only the four block matmul weight kinds bf16, the weights
where the model's memory and bandwidth live; decoder, head and FOV convs,
encoder glue, embeddings and the blocks' norms, LayerScales and biases
stay f32.

Activations follow by themselves: every primitive returns its input's
dtype (``ops/nn.py``), the pipeline feeds an f32 image
(``RuntimeConfig.image_dtype``), so the patch embed and the ViT's residual
carry are f32, ``vit.block_forward`` casts the matmul inputs down to the
weights' bf16 (the bf16 attention kernel runs), and the decoder, head and
FOV run f32 (the 3xTF32 conv kernel runs) because their weights and inputs
are f32. ``config.configure_precision`` keeps those f32 GEMMs true f32.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from matrix_eyes_tpu_torch.models.spec import tree_map

# The bf16 group: exactly the ViT block matmul weights, the head-group
# tensor-parallel qkv (``parallel.sharding._tp_permute_qkv`` renames qkv_w)
# among them. The biases stay f32: ``nn.linear`` adds them to the f32
# product before its one rounding.
MIXED_BF16_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w", "qkv_gw")


def is_mixed_bf16_leaf(path: Sequence[Any]) -> bool:
    """Whether the leaf at ``path`` (a ``tree_map`` path) is in the bf16
    group: a block matmul weight inside a ``blocks`` subtree."""
    return "blocks" in path and path[-1] in MIXED_BF16_KEYS


def cast_params_mixed(params):
    """A float parameter tree (tensors) in the mixed layout: block matmul
    weights bf16, every other leaf f32."""
    return tree_map(lambda path, t: t.to(torch.bfloat16 if is_mixed_bf16_leaf(path)
                                         else torch.float32), params)
