"""Per-stage activation dumps for parity triage (port of
``matrix_eyes_tpu/debug.py``).

``dump_stages`` runs the model and returns every stage boundary's
activations by the JAX package's names, so that two dumps (the card
against the CPU, the port against the JAX package, one dtype policy
against another) can be held stage by stage with ``compare_dumps``:

    from matrix_eyes_tpu_torch.debug import compare_dumps, dump_stages
    acts = dump_stages(cfg, params, img)            # dict[str, np.ndarray]
    report = compare_dumps(acts, dump_stages(cfg, cpu_params, img.cpu()))

On the card the stages run through the kernels, the only route there.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models import decoder as decoder_mod
from matrix_eyes_tpu_torch.models import encoder as encoder_mod
from matrix_eyes_tpu_torch.models import fov as fov_mod
from matrix_eyes_tpu_torch.models import head as head_mod
from matrix_eyes_tpu_torch.models import vit
from matrix_eyes_tpu_torch.ops.resize import downsample_half, downsample_quarter

ENCODING_NAMES = ("latent0", "latent1", "x0", "x1", "global")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@torch.no_grad()
def dump_stages(cfg: ModelConfig, params: Dict[str, Any], img: torch.Tensor,
                include_fov: bool = True) -> Dict[str, np.ndarray]:
    """img: (B, S, S, 3) normalised NHWC on the params' device. Returns the
    named activations (NHWC / token-major) as f32 numpy arrays."""
    out: Dict[str, np.ndarray] = {}

    # patch-encoder tokens on the pyramid batch
    p = cfg.vit_img_size
    pyramid = torch.cat([encoder_mod.split(img, p, 4),
                         encoder_mod.split(downsample_half(img), p, 2),
                         downsample_quarter(img)], dim=0)
    tokens, inters = vit.forward_features(cfg, params["encoder"]["patch_encoder"], pyramid,
                                          intermediate_blocks=cfg.highres_block_ids)
    out["patch_tokens"] = _np(tokens)
    for i, t in enumerate(inters):
        out[f"patch_highres{i}"] = _np(t)

    encodings = encoder_mod.forward_encodings(cfg, params["encoder"], img)
    for name, e in zip(ENCODING_NAMES, encodings):
        out[f"enc_{name}"] = _np(e)

    features, lowres = decoder_mod.forward(params["decoder"], encodings)
    out["dec_features"] = _np(features)
    out["dec_lowres"] = _np(lowres)

    canonical = head_mod.forward(params["head"], features)
    out["canonical_inverse_depth"] = _np(canonical[..., 0])

    if include_fov and "fov" in params:
        out["fov_deg"] = _np(fov_mod.forward(cfg, params["fov"], img, lowres))
    return out


def save_dump(acts: Dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **acts)


def compare_dumps(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                  rtol: float = 1e-3) -> Dict[str, float]:
    """Max relative difference per stage present in both dumps (inf where
    the shapes differ), relative to ``b`` with a floor of 1e-3."""
    report = {}
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k], np.float32), np.asarray(b[k], np.float32)
        if x.shape != y.shape:
            report[k] = float("inf")
            continue
        denom = np.maximum(np.abs(y), 1e-3)
        report[k] = float(np.max(np.abs(x - y) / denom))
    return report
