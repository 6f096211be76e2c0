"""Apple Depth Pro: the program's ``MatrixEyes`` session, the plain
reference (``eyebench/reference/``), the clamps of the program's outputs
and the frozen FLOP ledger (``eyebench/harness/ledger.py``). The interface
is ``eyebench/harness/architecture.py``'s; a configuration without an
``"architecture"`` key runs this one."""

from __future__ import annotations

from typing import Any, Dict

from eyebench.harness import ledger
from eyebench.reference import weights

# the inverse depth as ``inverse_depth_batch`` returns it, and the depth
# map's grid as ``MatrixEyes.depth_map`` renders it
clamps = {"forward": (1e-4, 1e4), "depth_map": (1.0 / 250.0, 1.0 / 0.1)}
# an image passed without a focal length has it estimated by the FOV head
has_fov = True
make_weights = weights.make_weights
policy_dtypes = ledger.policy_dtypes


def model_config(config: Dict[str, Any]):
    from matrix_eyes_tpu_torch.config import ModelConfig

    m = config["model"]
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})


def session(ctx):
    """A ``MatrixEyes`` session under ``ctx.policy`` on weights made on the
    card from the configuration's ``weights_seed``
    (``eyebench.reference.weights``): the session has no constructor that
    takes parameters, so its checkpoint loader is answered with them while
    it is built. Policies other than the weights' own dtype are placed by
    the program's ``place_params``, as its loader places a checkpoint.

    The weights are one model for every run, as a deployment serves one:
    with weights drawn from the run's seed, the depth maps' detail, and with
    it the PNG encoder's work, changed from seed to seed (12 MP PNGs of
    17.8 to 27.6 MB) and so did the host-bound cells' rates."""
    import torch

    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.pt.convert import place_params

    served = {"bf16": torch.bfloat16, "f32": torch.float32}[ctx.config["weights"]]
    cfg = model_config(ctx.config)
    policy = ctx.policy
    as_served = {"bf16": torch.bfloat16, "f32": torch.float32}.get(policy) == served

    def answer(_path, dtype, device, **_kw):
        params = make_weights(ctx.config["model"], ctx.config["weights_seed"], device, served)
        if not as_served:
            f32 = params if served == torch.float32 else _f32(params)
            del params
            params = place_params(f32, device, dtype, quantize_int8=policy == "int8",
                                  mixed_bf16=policy == "mixed")
            del f32
        return cfg, params

    real = api.load_checkpoint
    api.load_checkpoint = answer
    try:
        return api.MatrixEyes(f"random weights, weights_seed {ctx.config['weights_seed']}", dtype=policy,
                              device=ctx.device, cfg=cfg)
    finally:
        api.load_checkpoint = real


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def reference(model, params, rgb, f35, device, precision=None):
    """The (S, S) inverse depth of one photo, S = 4 x ``vit_img_size``:
    the photo resized to the model's input, its focal length normalised,
    the float32 forward with TF32 off, or in ``precision``."""
    import contextlib

    from eyebench.reference import image
    from eyebench.reference import model as depth_pro

    depth_pro.configure_precision()
    h, w = rgb.shape[:2]
    x = image.preprocess(rgb, 4 * model["vit_img_size"], device)
    with depth_pro.computed_in(precision) if precision else contextlib.nullcontext():
        inv, _fov = depth_pro.inverse_depth(model, params, x, [image.f_norm(f35, w, h)])
    return inv[0]


def depth_map(inverse_depth, h, w):
    from eyebench.reference import image

    return image.depth_map(inverse_depth, h, w)


def forward_flops(model, photos, variant):
    """``variant``: the FOV head ran."""
    return ledger.model_flops(model, photos, variant)["total"]


def attention_calls(model, photos, variant, vit_dtype):
    return ledger.attention_calls(model, photos, variant, vit_dtype)


def conv3x3_calls(model, photos, dtype):
    return ledger.conv3x3_calls(model, photos, dtype)
