"""Depth Anything V2: the program's ``MatrixEyes`` session on the
configuration's seeded weights, the plain reference
(``eyebench/reference/depth_anything_v2.py``), the clamps of the
program's outputs and the FLOP ledger, all at the grid of the frame the
configuration's model group states (``"frame"``: width, height). The
interface is ``eyebench/harness/architecture.py``'s.

The ledger is the benchmark's own, worked out from the published model
(``dpt.py``) at that grid; ``resample_calls`` adds the resamplings that
``kernels.resample_roofline`` reads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

from eyebench.harness import ledger
from eyebench.reference import depth_anything_v2 as dav2

# the head ends in a ReLU: relative inverse depth, not metric, nothing else
# clamps it
clamps = {"forward": (0.0, math.inf), "depth_map": (0.0, math.inf)}
# no focal length enters: an image passed without one is judged as any other
has_fov = False
make_weights = dav2.make_weights
policy_dtypes = ledger.policy_dtypes
_PORT_KEYS = ("input_size", "patch_size", "depth", "embed_dim", "num_heads", "mlp_ratio",
              "layer_norm_eps", "taps", "features", "out_channels", "head_widths", "use_bn",
              "use_clstoken")


def model_config(config: Dict[str, Any]):
    from matrix_eyes_tpu_torch.config import DepthAnythingConfig

    m = config["model"]
    return DepthAnythingConfig(**{k: tuple(m[k]) if isinstance(m[k], list) else m[k]
                                  for k in _PORT_KEYS})


def session(ctx):
    """A ``MatrixEyes`` session under ``ctx.policy`` on weights made on the
    card from the configuration's ``weights_seed``, the session's loader
    answered with them (policies other than the weights' own dtype placed
    by the program's ``place_params``). Refuses a photo pool whose frame is
    not the configuration's, on which the ledger's grid would be wrong."""
    import torch

    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.pt.convert import place_params

    frame = tuple(ctx.config["model"]["frame"])
    pool = ctx.mix["pool"]
    if (pool["width"], pool["height"]) != frame:
        raise ValueError(f"the pool's {pool['width']}x{pool['height']} photos are not the "
                         f"configuration's {frame[0]}x{frame[1]} frame")
    served = {"bf16": torch.bfloat16, "f32": torch.float32}[ctx.config["weights"]]
    cfg = model_config(ctx.config)
    policy = ctx.policy
    as_served = {"bf16": torch.bfloat16, "f32": torch.float32}.get(policy) == served

    def answer(_path, dtype, device, **_kw):
        params = make_weights(ctx.config["model"], ctx.config["weights_seed"], device, served)
        if not as_served:
            params = place_params(params, device, dtype, quantize_int8=policy == "int8",
                                  mixed_bf16=policy == "mixed")
        return cfg, params

    real = api.load_checkpoint
    api.load_checkpoint = answer
    try:
        return api.MatrixEyes(f"random weights, weights_seed {ctx.config['weights_seed']}",
                              dtype=policy, device=ctx.device, cfg=cfg)
    finally:
        api.load_checkpoint = real


def reference(model, params, rgb, f35, device, precision=None):
    """The (h, w) relative inverse depth of one photo at the model's input
    grid, float32 with TF32 off, or in ``precision``; ``f35`` is ignored."""
    return dav2.inverse_depth(model, params, rgb, device, precision)


def depth_map(inverse_depth, h, w):
    return dav2.depth_map(inverse_depth, h, w)


# -- the ledger ------------------------------------------------------------------------------

def grid(model) -> Tuple[int, int]:
    """(h, w) of the model's input for the configuration's frame."""
    w, h = model["frame"]
    return dav2.input_size(model, h, w)


def _conv(h, w, cin, cout, k=1) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _levels(model) -> List[Tuple[int, int]]:
    """(h, w) of the four reassembled levels: 4x, 2x, 1x and 1/2x the patch
    grid (the 3x3/s2 conv with padding 1 rounds up)."""
    H, W = grid(model)
    gh, gw = H // model["patch_size"], W // model["patch_size"]
    return [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]


def forward_flops(model, photos, variant):
    """Dot-product FLOPs of one forward of ``photos`` frames, as published:
    the ViT at 1 + gh * gw tokens, the projections, transposed convs and
    convs of the DPT head (the fusion blocks' 1x1 at the upsampled size);
    the resamplings are left out. ``variant`` changes nothing."""
    H, W = grid(model)
    P, D, M = model["patch_size"], model["embed_dim"], model["mlp_ratio"]
    gh, gw = H // P, W // P
    N = gh * gw + 1
    oc, F_ = model["out_channels"], model["features"]
    h1, h2 = model["head_widths"]
    lv = _levels(model)
    total = 2.0 * gh * gw * P * P * 3 * D + model["depth"] * (
        (8 + 4 * M) * N * D * D + 4 * N * N * D)
    total += sum(_conv(gh, gw, D, c) for c in oc)
    total += _conv(gh, gw, oc[0], oc[0], 4) + _conv(gh, gw, oc[1], oc[1], 2)
    total += _conv(*lv[3], oc[3], oc[3], 3)
    total += sum(_conv(h, w, c, F_, 3) for (h, w), c in zip(lv, oc))
    out = [(2 * lv[0][0], 2 * lv[0][1])] + lv[:3]  # each fusion block's upsampled size
    for i in range(4):
        units = 1 if i == 3 else 2
        total += units * 2 * _conv(*lv[i], F_, F_, 3) + _conv(*out[i], F_, F_)
    total += _conv(*out[0], F_, h1, 3) + _conv(H, W, h1, h2, 3) + _conv(H, W, h2, 1)
    return photos * total


def attention_calls(model, photos, variant, vit_dtype):
    """(B, N, H, D, dtype): the ViT's blocks at 1 + gh * gw tokens."""
    H, W = grid(model)
    P = model["patch_size"]
    n = (H // P) * (W // P) + 1
    heads = model["num_heads"]
    return [(photos, n, heads, model["embed_dim"] // heads, vit_dtype)] * model["depth"]


def conv3x3_calls(model, photos, dtype):
    """(N, H, W, Cin, Cout, skips, bias, dtype) of every 3x3 stride-1 conv
    as published: the four bias-free ``layer{i}_rn``, the residual conv
    units' two convs (the second adds the unit's residual and, in a fusion
    block's first unit, the block's skip input), the head's two."""
    H, W = grid(model)
    oc, F_ = model["out_channels"], model["features"]
    h1, h2 = model["head_widths"]
    lv = _levels(model)
    calls = [(photos, h, w, c, F_, 0, False, dtype) for (h, w), c in zip(lv, oc)]
    for i in range(4):
        h, w = lv[i]
        units = 1 if i == 3 else 2
        for u in range(units):
            calls.append((photos, h, w, F_, F_, 0, True, dtype))
            calls.append((photos, h, w, F_, F_, 2 if (units == 2 and u == 0) else 1, True,
                          dtype))
    calls.append((photos, 2 * lv[0][0], 2 * lv[0][1], F_, h1, 0, True, dtype))
    calls.append((photos, H, W, h1, h2, 0, True, dtype))
    return calls


def resample_calls(model, photos, variant, dtypes):
    """(elements read, their dtype, elements written, their dtype) of every
    resampling of one forward of ``photos`` frames: each frame's bicubic
    resize (its u8 pixels read, the model's input written in the decoder's
    dtype, the input's), the four fusion blocks' and the head's bilinear
    upsamplings in the decoder's dtype. The position embedding's bicubic
    depends on the grid alone: the least a forward must spend on it is
    nothing (the port computes it once per grid)."""
    fw, fh = model["frame"]
    H, W = grid(model)
    F_, h1 = model["features"], model["head_widths"][0]
    dt = dtypes["decoder"]
    lv = _levels(model)
    out = [(2 * lv[0][0], 2 * lv[0][1])] + lv[:3]
    calls = [(photos * fh * fw * 3, "u8", photos * H * W * 3, dt)]
    for i in range(4):
        (h, w), (oh, ow) = lv[i], out[i]
        calls.append((photos * h * w * F_, dt, photos * oh * ow * F_, dt))
    calls.append((photos * out[0][0] * out[0][1] * h1, dt, photos * H * W * h1, dt))
    return calls
