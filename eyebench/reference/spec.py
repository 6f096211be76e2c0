"""Depth Pro's parameter tree: nested dicts and lists whose leaves are
shapes, in the layouts the benchmark hands to the program and to the
reference alike (linear ``(in, out)``, convolutions HWIO, 2x2/s2 deconvs
``(in, 4 * out)`` in (row phase, column phase, out) order, ViT blocks
stacked on a leading layer axis).

A frozen copy: the benchmark makes its weights from this tree, so it
imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Any, Dict


def seq_len(cfg: Dict[str, Any]) -> int:
    t = cfg["vit_img_size"] // cfg["patch_size"]
    return t * t + 1


def vit_spec(cfg: Dict[str, Any]) -> Dict[str, Any]:
    D, L, P = cfg["embed_dim"], cfg["depth"], cfg["patch_size"]
    M = cfg["mlp_ratio"] * D
    return {
        "patch_embed": {"w": (P * P * 3, D), "b": (D,)},
        "cls_token": (1, 1, D),
        "pos_embed": (1, seq_len(cfg), D),
        "blocks": {
            "norm1_scale": (L, D), "norm1_bias": (L, D),
            "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
            "proj_w": (L, D, D), "proj_b": (L, D), "ls1": (L, D),
            "norm2_scale": (L, D), "norm2_bias": (L, D),
            "fc1_w": (L, D, M), "fc1_b": (L, M),
            "fc2_w": (L, M, D), "fc2_b": (L, D), "ls2": (L, D),
        },
        "norm": {"scale": (D,), "bias": (D,)},
    }


def _upsample(dim_in: int, dim_out: int, n_up: int, dim_int=None) -> Dict[str, Any]:
    dim_int = dim_out if dim_int is None else dim_int
    return {"proj": (dim_in, dim_int),
            "deconvs": [(dim_int if i == 0 else dim_out, 4 * dim_out) for i in range(n_up)]}


def _rcu(c: int) -> Dict[str, Any]:
    return {"conv1_w": (3, 3, c, c), "conv1_b": (c,), "conv2_w": (3, 3, c, c), "conv2_b": (c,)}


def param_spec(cfg: Dict[str, Any]) -> Dict[str, Any]:
    D = cfg["embed_dim"]
    ef = tuple(cfg["encoder_feature_dims"])
    dec = cfg["decoder_features"]
    l0, l1 = cfg["head_last_dims"]
    k = cfg["vit_img_size"] // cfg["patch_size"] // 4
    dims = (dec,) + ef
    fusions = []
    for i in range(len(dims)):
        f = {"resnet1": _rcu(dec), "resnet2": _rcu(dec), "out_conv_w": (dec, dec),
             "out_conv_b": (dec,)}
        if i != 0:
            f["deconv_w"] = (dec, 4 * dec)
        fusions.append(f)
    return {
        "encoder": {
            "patch_encoder": vit_spec(cfg),
            "image_encoder": vit_spec(cfg),
            "upsample_latent0": _upsample(D, dec, 3, dim_int=ef[0]),
            "upsample_latent1": _upsample(D, ef[0], 2),
            "upsample0": _upsample(D, ef[1], 1),
            "upsample1": _upsample(D, ef[2], 1),
            "upsample2": _upsample(D, ef[3], 1),
            "upsample_lowres": {"w": (D, 4 * ef[3]), "b": (ef[3],)},
            "fuse_lowres": {"w": (2 * ef[3], ef[3]), "b": (ef[3],)},
        },
        "decoder": {"convs": [{"w": (3, 3, d, dec)} for d in dims[1:]], "fusions": fusions},
        "head": {
            "conv0_w": (3, 3, dec, dec // 2), "conv0_b": (dec // 2,),
            "deconv1_w": (dec // 2, 4 * (dec // 2)), "deconv1_b": (dec // 2,),
            "conv2_w": (3, 3, dec // 2, l0), "conv2_b": (l0,),
            "conv3_w": (l0, l1), "conv3_b": (l1,),
        },
        "fov": {
            "encoder": vit_spec(cfg),
            "linear": {"w": (D, dec // 2), "b": (dec // 2,)},
            "downsample0": {"w": (3, 3, dec, dec // 2), "b": (dec // 2,)},
            "head0": {"w": (3, 3, dec // 2, dec // 4), "b": (dec // 4,)},
            "head1": {"w": (3, 3, dec // 4, dec // 8), "b": (dec // 8,)},
            "head2": {"w": (k, k, dec // 8, 1), "b": (1,)},
        },
    }


def tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a dict/list tree (dict keys in
    sorted order); returns the tree of results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves(tree):
    out = []
    tree_map(lambda path, leaf: out.append((path, leaf)), tree)
    return out
