"""Carry weights into the port: from a ``depth_pro.pt`` checkpoint or from
the JAX package's parameter tree.

The key map and layout transforms are a jax-free copy of
``matrix_eyes_tpu/pt/convert.py``: linears transposed to (in, out), convs
OIHW -> HWIO, 1x1 convs to (in, out) matrices, 2x2/s2 transposed convs to
(in, 4 * out), the patch-embed conv to (p * p * 3, embed), ViT block
parameters stacked along a leading layer axis. Keys follow the real
checkpoint (nn.Sequential indices with ReLU/Identity holes), with the
compact re-export indices as fallbacks. Every parameter of
``models.spec.param_spec`` must be present (else ``CheckpointMissingKeys``)
with the expected shape (else ``CheckpointBadShape``); extra keys are
ignored.

A checkpoint is read at canonical f32 (``read_checkpoint``) and then
placed under the dtype policy (``place_params``), leaf for leaf the values
of ``matrix_eyes_tpu/pt/loader.py::load_checkpoint(..., use_caches=False)``:

* f32, bf16, f16: every leaf rounded to the compute dtype;
* int8: the ViT block matmul weights quantized (``ops/quant.py``) from
  their f16 roundings, as the JAX loader does so that its codes do not
  depend on which of its caches exist; every other leaf bf16(f16(x));
* mixed: the block matmul weights bf16(x), every other leaf the
  checkpoint's own f32 (``ops/mixed.py``).

The FOV part is stored in f32 holding the policy's values (int8 codes stay
int8): the FOV network runs in f32.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from matrix_eyes_tpu_torch.errors import CheckpointBadShape, CheckpointMissingKeys, LoaderError
from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models.spec import param_spec, tree_leaves, tree_map
from matrix_eyes_tpu_torch.ops.mixed import cast_params_mixed
from matrix_eyes_tpu_torch.ops.quant import quantize_params

PARTS = ("encoder", "decoder", "head", "fov")


def t_linear(w: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) -> (in, out)."""
    return np.ascontiguousarray(w.T)


def t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d OIHW -> HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def t_conv1x1(w: np.ndarray) -> np.ndarray:
    """torch 1x1 Conv2d (O, I, 1, 1) -> channel matmul (I, O)."""
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def t_deconv2x2(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, 2, 2) -> (I, 4*O), inner order (di, dj, o)."""
    i, o = w.shape[0], w.shape[1]
    return np.ascontiguousarray(w.transpose(0, 2, 3, 1).reshape(i, 4 * o))


def t_patch_embed(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (D, 3, p, p) -> ((p, p, 3) flattened, D)."""
    d = w.shape[0]
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(-1, d))


def t_id(w: np.ndarray) -> np.ndarray:
    return w


class _KeySpace:
    """Flat state-dict access that records missing keys, so the error lists
    all of them at once."""

    def __init__(self, flat: Dict[str, np.ndarray]):
        self.flat = flat
        self.missing: List[str] = []

    def take(self, *candidates: str, transform: Callable = t_id) -> Optional[np.ndarray]:
        for name in candidates:
            if name in self.flat:
                return transform(np.asarray(self.flat[name]))
        self.missing.append(candidates[0])
        return None

    def __contains__(self, name: str) -> bool:
        return name in self.flat


def _convert_vit(ks: _KeySpace, p: str, cfg: ModelConfig) -> Dict[str, Any]:
    fields = (
        ("norm1_scale", "norm1.weight", t_id), ("norm1_bias", "norm1.bias", t_id),
        ("qkv_w", "attn.qkv.weight", t_linear), ("qkv_b", "attn.qkv.bias", t_id),
        ("proj_w", "attn.proj.weight", t_linear), ("proj_b", "attn.proj.bias", t_id),
        ("ls1", "ls1.gamma", t_id),
        ("norm2_scale", "norm2.weight", t_id), ("norm2_bias", "norm2.bias", t_id),
        ("fc1_w", "mlp.fc1.weight", t_linear), ("fc1_b", "mlp.fc1.bias", t_id),
        ("fc2_w", "mlp.fc2.weight", t_linear), ("fc2_b", "mlp.fc2.bias", t_id),
        ("ls2", "ls2.gamma", t_id),
    )
    blocks = {}
    for field, key, transform in fields:
        vals = [ks.take(f"{p}.blocks.{i}.{key}", transform=transform) for i in range(cfg.depth)]
        blocks[field] = np.stack(vals) if all(v is not None for v in vals) else None
    return {
        "patch_embed": {
            "w": ks.take(f"{p}.patch_embed.proj.weight", transform=t_patch_embed),
            "b": ks.take(f"{p}.patch_embed.proj.bias"),
        },
        "cls_token": ks.take(f"{p}.cls_token"),
        "pos_embed": ks.take(f"{p}.pos_embed"),
        "blocks": blocks,
        "norm": {"scale": ks.take(f"{p}.norm.weight"), "bias": ks.take(f"{p}.norm.bias")},
    }


def _convert_upsample(ks: _KeySpace, p: str, n_up: int) -> Dict[str, Any]:
    return {
        "proj": ks.take(f"{p}.0.weight", transform=t_conv1x1),
        "deconvs": [ks.take(f"{p}.{i + 1}.weight", transform=t_deconv2x2) for i in range(n_up)],
    }


def _convert_rcu(ks: _KeySpace, p: str) -> Dict[str, Any]:
    # Sequential(ReLU, conv, ReLU, conv) -> indices 1, 3; compact export 0, 1
    compact = f"{p}.residual.3.weight" not in ks
    i1, i2 = ("0", "1") if compact else ("1", "3")
    return {
        "conv1_w": ks.take(f"{p}.residual.{i1}.weight", transform=t_conv),
        "conv1_b": ks.take(f"{p}.residual.{i1}.bias"),
        "conv2_w": ks.take(f"{p}.residual.{i2}.weight", transform=t_conv),
        "conv2_b": ks.take(f"{p}.residual.{i2}.bias"),
    }


def _convert_encoder(ks: _KeySpace, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "patch_encoder": _convert_vit(ks, "encoder.patch_encoder", cfg),
        "image_encoder": _convert_vit(ks, "encoder.image_encoder", cfg),
        "upsample_latent0": _convert_upsample(ks, "encoder.upsample_latent0", 3),
        "upsample_latent1": _convert_upsample(ks, "encoder.upsample_latent1", 2),
        "upsample0": _convert_upsample(ks, "encoder.upsample0", 1),
        "upsample1": _convert_upsample(ks, "encoder.upsample1", 1),
        "upsample2": _convert_upsample(ks, "encoder.upsample2", 1),
        "upsample_lowres": {
            "w": ks.take("encoder.upsample_lowres.weight", transform=t_deconv2x2),
            "b": ks.take("encoder.upsample_lowres.bias"),
        },
        "fuse_lowres": {
            "w": ks.take("encoder.fuse_lowres.weight", transform=t_conv1x1),
            "b": ks.take("encoder.fuse_lowres.bias"),
        },
    }


def _convert_decoder(ks: _KeySpace, cfg: ModelConfig) -> Dict[str, Any]:
    dims = (cfg.decoder_features,) + tuple(cfg.encoder_feature_dims)
    # convs[0] is an Identity in the real checkpoint (indices 1..n); a
    # compact export runs 0..n-1: detect by the highest real-checkpoint index
    offset = 1 if f"decoder.convs.{len(dims) - 1}.weight" in ks else 0
    convs = [{"w": ks.take(f"decoder.convs.{j - 1 + offset}.weight", transform=t_conv)}
             for j in range(1, len(dims))]
    fusions = []
    for i in range(len(dims)):
        p = f"decoder.fusions.{i}"
        f: Dict[str, Any] = {
            "resnet1": _convert_rcu(ks, f"{p}.resnet1"),
            "resnet2": _convert_rcu(ks, f"{p}.resnet2"),
            "out_conv_w": ks.take(f"{p}.out_conv.weight", transform=t_conv1x1),
            "out_conv_b": ks.take(f"{p}.out_conv.bias"),
        }
        if i != 0:
            f["deconv_w"] = ks.take(f"{p}.deconv.weight", transform=t_deconv2x2)
        fusions.append(f)
    return {"convs": convs, "fusions": fusions}


def _convert_head(ks: _KeySpace) -> Dict[str, Any]:
    # Sequential with ReLUs at 3 and 5 -> convs 0, 1, 2, 4; compact: last at 3
    return {
        "conv0_w": ks.take("head.0.weight", transform=t_conv),
        "conv0_b": ks.take("head.0.bias"),
        "deconv1_w": ks.take("head.1.weight", transform=t_deconv2x2),
        "deconv1_b": ks.take("head.1.bias"),
        "conv2_w": ks.take("head.2.weight", transform=t_conv),
        "conv2_b": ks.take("head.2.bias"),
        "conv3_w": ks.take("head.4.weight", "head.3.weight", transform=t_conv1x1),
        "conv3_b": ks.take("head.4.bias", "head.3.bias"),
    }


def _convert_fov(ks: _KeySpace, cfg: ModelConfig) -> Dict[str, Any]:
    # Sequential with ReLUs -> convs 0, 2, 4; compact export 0, 1, 2
    i1, i2 = ("2", "4") if "fov.head.4.weight" in ks else ("1", "2")
    return {
        "encoder": _convert_vit(ks, "fov.encoder.0", cfg),
        "linear": {"w": ks.take("fov.encoder.1.weight", transform=t_linear),
                   "b": ks.take("fov.encoder.1.bias")},
        "downsample0": {"w": ks.take("fov.downsample.0.weight", transform=t_conv),
                        "b": ks.take("fov.downsample.0.bias")},
        "head0": {"w": ks.take("fov.head.0.weight", transform=t_conv),
                  "b": ks.take("fov.head.0.bias")},
        "head1": {"w": ks.take(f"fov.head.{i1}.weight", transform=t_conv),
                  "b": ks.take(f"fov.head.{i1}.bias")},
        "head2": {"w": ks.take(f"fov.head.{i2}.weight", transform=t_conv),
                  "b": ks.take(f"fov.head.{i2}.bias")},
    }


def infer_config(flat: Dict[str, np.ndarray]) -> ModelConfig:
    """Derive the ModelConfig from checkpoint tensor shapes. eps and the
    highres block ids are not recoverable from shapes: eps is the DINOv2
    value, the ids scale like the production network's (5, 11) at depth
    24; the head count assumes head_dim 64 where the width allows it."""
    def need(key: str, *fallbacks: str) -> np.ndarray:
        for k in (key,) + fallbacks:
            if k in flat:
                return flat[k]
        raise CheckpointMissingKeys([key])

    d = int(need("encoder.patch_encoder.cls_token").shape[-1])
    n_tokens = int(need("encoder.patch_encoder.pos_embed").shape[1]) - 1
    s = int(round(n_tokens ** 0.5))
    patch = int(need("encoder.patch_encoder.patch_embed.proj.weight").shape[-1])
    depth = 1 + max((int(k.split(".")[3]) for k in flat
                     if k.startswith("encoder.patch_encoder.blocks.")), default=0)
    if int(need("encoder.patch_encoder.blocks.0.attn.qkv.weight").shape[0]) != 3 * d:
        raise CheckpointBadShape("unexpected qkv shape")
    head_dim = 64 if d % 64 == 0 else d // 2
    mlp_hidden = int(need("encoder.patch_encoder.blocks.0.mlp.fc1.weight").shape[0])
    return ModelConfig(
        vit_img_size=s * patch,
        patch_size=patch,
        depth=depth,
        embed_dim=d,
        num_heads=d // head_dim,
        mlp_ratio=mlp_hidden // d,
        encoder_feature_dims=tuple(int(need(f"encoder.{k}.0.weight").shape[0]) for k in (
            "upsample_latent1", "upsample0", "upsample1", "upsample2")),
        decoder_features=int(need("head.0.weight").shape[1]),
        head_last_dims=(int(need("head.2.weight").shape[0]),
                        int(need("head.4.weight", "head.3.weight").shape[0])),
        highres_block_ids=(max(0, depth // 4 - 1), max(1, depth // 2 - 1)),
    )


def convert_state_dict(cfg: ModelConfig, flat: Dict[str, np.ndarray],
                       parts: Sequence[str] = PARTS) -> Dict[str, Any]:
    """Map a flat state dict of numpy arrays to the parameter tree of
    numpy arrays, validated against ``param_spec``."""
    ks = _KeySpace(flat)
    converters = {
        "encoder": lambda: _convert_encoder(ks, cfg),
        "decoder": lambda: _convert_decoder(ks, cfg),
        "head": lambda: _convert_head(ks),
        "fov": lambda: _convert_fov(ks, cfg),
    }
    params = {part: converters[part]() for part in parts}
    if ks.missing:
        raise CheckpointMissingKeys(ks.missing)
    _check_shapes(cfg, params)
    return params


def _check_shapes(cfg: ModelConfig, params: Dict[str, Any]) -> None:
    spec = param_spec(cfg, include_fov="fov" in params)
    spec = {part: spec[part] for part in params}
    bad = []

    def check(path, arr):
        want = _at(spec, path)
        if tuple(arr.shape) != tuple(want):
            bad.append(f"{'.'.join(map(str, path))}: expected {tuple(want)}, got {tuple(arr.shape)}")

    try:
        tree_map(check, params)
    except (KeyError, IndexError, TypeError) as err:
        raise CheckpointBadShape(f"parameter tree does not match the model spec: {err}")
    if bad or len(tree_leaves(spec)) != len(tree_leaves(params)):
        raise CheckpointBadShape("; ".join(bad[:10]) or "parameter tree does not match the model spec")


def _at(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def _check_policy(dtype: torch.dtype, quantize_int8: bool, mixed_bf16: bool) -> None:
    if quantize_int8 and dtype != torch.bfloat16:
        raise LoaderError(f"quantize_int8 requires the bf16 compute dtype, got {dtype}")
    if mixed_bf16:
        if quantize_int8:
            raise LoaderError("mixed_bf16 and quantize_int8 are mutually exclusive")
        if dtype != torch.bfloat16:
            raise LoaderError(f"mixed_bf16 requires the bf16 compute dtype, got {dtype}")


def place_params(params: Dict[str, Any], device, dtype: torch.dtype = torch.float32, *,
                 quantize_int8: bool = False, mixed_bf16: bool = False) -> Dict[str, Any]:
    """The parameter tree of a dtype policy on ``device`` from a canonical
    f32 tree (numpy arrays or tensors): ``dtype`` alone (f32, bf16, f16),
    or bf16 with ``quantize_int8`` or ``mixed_bf16`` (module docstring).
    For a device mesh, place on the CPU: ``parallel.shard_params`` then
    cuts the policy's tree (int8 codes and scales included) and moves each
    rank's part to its card."""
    _check_policy(dtype, quantize_int8, mixed_bf16)

    def leaf(_path, arr):
        t = arr if isinstance(arr, torch.Tensor) else torch.tensor(np.asarray(arr, np.float32))
        t = t.to(device=device, dtype=torch.float32)
        return t if mixed_bf16 else t.to(torch.float16 if quantize_int8 else dtype)

    tree = tree_map(leaf, params)
    if mixed_bf16:
        tree = cast_params_mixed(tree)
    if quantize_int8:
        tree = tree_map(lambda _p, t: t.bfloat16() if t.dtype == torch.float16 else t,
                        quantize_params(tree))
    if "fov" in tree:
        tree["fov"] = tree_map(lambda _p, t: t.float() if t.is_floating_point() else t,
                               tree["fov"])
    return tree


def from_jax_params(cfg: ModelConfig, params_np: Dict[str, Any], device,
                    dtype: torch.dtype = torch.float32, *, quantize_int8: bool = False,
                    mixed_bf16: bool = False) -> Dict[str, Any]:
    """The port's parameter tree from the JAX package's canonical f32 tree
    (as returned by ``convert_state_dict`` or ``models.init.init_params``,
    leaves converted to numpy), under a dtype policy: the layouts are the
    same, so this is a validated copy."""
    _check_shapes(cfg, params_np)
    return place_params(params_np, device, dtype, quantize_int8=quantize_int8,
                        mixed_bf16=mixed_bf16)


def load_checkpoint(path: str, dtype: torch.dtype = torch.float32, device="cpu",
                    parts: Sequence[str] = PARTS, cfg: Optional[ModelConfig] = None, *,
                    quantize_int8: bool = False,
                    mixed_bf16: bool = False) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Read ``depth_pro.pt`` (``read_checkpoint``) and return (cfg, params)
    on ``device`` under the dtype policy (``place_params``)."""
    _check_policy(dtype, quantize_int8, mixed_bf16)
    cfg, params = read_checkpoint(path, parts, cfg)
    return cfg, place_params(params, device, dtype, quantize_int8=quantize_int8,
                             mixed_bf16=mixed_bf16)


def read_checkpoint(path: str, parts: Sequence[str] = PARTS,
                    cfg: Optional[ModelConfig] = None) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Read ``depth_pro.pt`` (``torch.load(weights_only=True)``), infer the
    config from its shapes unless ``cfg`` is given, and return (cfg, the
    parameter tree of ``parts`` as f32 numpy arrays)."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise LoaderError(f"PyTorch store error: {path}: no such file")
    except (OSError, RuntimeError, ValueError, pickle.UnpicklingError) as err:
        raise LoaderError(f"PyTorch store error: {path}: {err}")
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    flat = {k: v.float().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}
    cfg = cfg or infer_config(flat)
    return cfg, convert_state_dict(cfg, flat, parts)
