"""Parameter tree specification for every Depth Pro part: nested dicts and
lists whose leaves are shape tuples.

A jax-free copy of ``matrix_eyes_tpu/models/spec.py`` (same tree, same
leaf order, same layouts). It is shared by ``models.init`` (random
initialisation) and ``pt.convert`` (checkpoint validation).
"""

from __future__ import annotations

from typing import Any, Dict

from matrix_eyes_tpu_torch.config import ModelConfig


def vit_spec(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.embed_dim
    L = cfg.depth
    P = cfg.patch_size
    M = cfg.mlp_ratio * D
    return {
        "patch_embed": {"w": (P * P * 3, D), "b": (D,)},
        "cls_token": (1, 1, D),
        "pos_embed": (1, cfg.seq_len, D),
        "blocks": {
            "norm1_scale": (L, D),
            "norm1_bias": (L, D),
            "qkv_w": (L, D, 3 * D),
            "qkv_b": (L, 3 * D),
            "proj_w": (L, D, D),
            "proj_b": (L, D),
            "ls1": (L, D),
            "norm2_scale": (L, D),
            "norm2_bias": (L, D),
            "fc1_w": (L, D, M),
            "fc1_b": (L, M),
            "fc2_w": (L, M, D),
            "fc2_b": (L, D),
            "ls2": (L, D),
        },
        "norm": {"scale": (D,), "bias": (D,)},
    }


def _upsample_spec(dim_in: int, dim_out: int, n_up: int, dim_int: int | None = None):
    dim_int = dim_out if dim_int is None else dim_int
    deconvs = [(dim_int if i == 0 else dim_out, 4 * dim_out) for i in range(n_up)]
    return {"proj": (dim_in, dim_int), "deconvs": deconvs}


def encoder_spec(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.embed_dim
    ef = cfg.encoder_feature_dims
    dec = cfg.decoder_features
    return {
        "patch_encoder": vit_spec(cfg),
        "image_encoder": vit_spec(cfg),
        "upsample_latent0": _upsample_spec(D, dec, 3, dim_int=ef[0]),
        "upsample_latent1": _upsample_spec(D, ef[0], 2),
        "upsample0": _upsample_spec(D, ef[1], 1),
        "upsample1": _upsample_spec(D, ef[2], 1),
        "upsample2": _upsample_spec(D, ef[3], 1),
        "upsample_lowres": {"w": (D, 4 * ef[3]), "b": (ef[3],)},
        "fuse_lowres": {"w": (2 * ef[3], ef[3]), "b": (ef[3],)},
    }


def _rcu_spec(c: int):
    return {"conv1_w": (3, 3, c, c), "conv1_b": (c,), "conv2_w": (3, 3, c, c), "conv2_b": (c,)}


def decoder_spec(cfg: ModelConfig) -> Dict[str, Any]:
    dec = cfg.decoder_features
    dims = (dec,) + tuple(cfg.encoder_feature_dims)
    # the finest level is at decoder width already: no projection for it
    convs = [{"w": (3, 3, d, dec)} for d in dims[1:]]
    fusions = []
    for i in range(len(dims)):
        f = {
            "resnet1": _rcu_spec(dec),
            "resnet2": _rcu_spec(dec),
            "out_conv_w": (dec, dec),
            "out_conv_b": (dec,),
        }
        if i != 0:
            f["deconv_w"] = (dec, 4 * dec)
        fusions.append(f)
    return {"convs": convs, "fusions": fusions}


def head_spec(cfg: ModelConfig) -> Dict[str, Any]:
    dec = cfg.decoder_features
    l0, l1 = cfg.head_last_dims
    return {
        "conv0_w": (3, 3, dec, dec // 2),
        "conv0_b": (dec // 2,),
        "deconv1_w": (dec // 2, 4 * (dec // 2)),
        "deconv1_b": (dec // 2,),
        "conv2_w": (3, 3, dec // 2, l0),
        "conv2_b": (l0,),
        "conv3_w": (l0, l1),
        "conv3_b": (l1,),
    }


def fov_spec(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.embed_dim
    dec = cfg.decoder_features
    k = cfg.tokens_per_side // 4
    return {
        "encoder": vit_spec(cfg),
        "linear": {"w": (D, dec // 2), "b": (dec // 2,)},
        "downsample0": {"w": (3, 3, dec, dec // 2), "b": (dec // 2,)},
        "head0": {"w": (3, 3, dec // 2, dec // 4), "b": (dec // 4,)},
        "head1": {"w": (3, 3, dec // 4, dec // 8), "b": (dec // 8,)},
        "head2": {"w": (k, k, dec // 8, 1), "b": (1,)},
    }


def param_spec(cfg: ModelConfig, include_fov: bool = True) -> Dict[str, Any]:
    spec = {
        "encoder": encoder_spec(cfg),
        "decoder": decoder_spec(cfg),
        "head": head_spec(cfg),
    }
    if include_fov:
        spec["fov"] = fov_spec(cfg)
    return spec


def tree_map(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict/list tree,
    where a leaf is anything that is not a dict or list (a shape tuple, an
    array, a tensor); returns the tree of results. Dict keys are visited
    in sorted order, the order ``jax.tree.flatten`` uses."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree):
    out = []
    tree_map(lambda _p, leaf: out.append(leaf), tree)
    return out
