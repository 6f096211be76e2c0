"""Seeded random parameters (for the chip smoke run and tests).

A fan-in scheme like ``matrix_eyes_tpu/models/init.py``: matrices are
normal with variance 1/fan_in, vectors uniform in [0.05, 0.3] so norms and
LayerScale do not zero the network out. Random, not constant: constant
weights make every softmax uniform and would hide attention faults. The
numbers differ from the JAX package's for the same seed (a torch
Generator is not a JAX key); tests that compare the two carry weights
across with ``pt.convert.from_jax_params`` instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.models.spec import param_spec, tree_map


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator], device,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Parameters drawn on ``device`` from ``generator`` (which must live on
    that device), in ``dtype``; the FOV part is f32 holding ``dtype``
    values, as ``pt.convert`` stores it."""
    def leaf(path, shape):
        if len(shape) >= 2:
            w = torch.randn(shape, generator=generator, device=device)
            w = w * (1.0 / max(math.prod(shape[:-1]), 1)) ** 0.5
        else:
            w = torch.empty(shape, device=device).uniform_(0.05, 0.3, generator=generator)
        w = w.to(dtype)
        return w.float() if path[0] == "fov" else w

    return tree_map(leaf, param_spec(cfg))
