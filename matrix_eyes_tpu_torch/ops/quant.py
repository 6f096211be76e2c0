"""Int8 quantized linear layers for ``--dtype int8``.

A torch copy of ``matrix_eyes_tpu/ops/quant.py``, with the tensor-parallel
head-group keys (``qkv_gqw``/``qkv_gsw``, ``parallel.sharding``). The
scheme is standard post-training dynamic quantization:

* weights: symmetric per output channel, ``scale_j = max_i |w_ij| / 127``,
  int8 codes beside an f32 scale vector, quantized once at load time
  (``pt.convert``);
* activations: symmetric per token (matmul row), quantized on the fly;
* products: int8 x int8 -> int32 by cuBLAS (``torch._int_mm``), the
  per-token and per-channel scales applied in f32, the bias added in f32,
  one rounding to the activation dtype.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) of an f32
division, so codes and scales equal the JAX package's bit for bit on the
CPU and on the card; the Rust-derived ``floor(x + 0.5)`` rule of the u8
outputs does not apply here. Every division is tensor by tensor: PyTorch
divides a CUDA tensor by a Python number as a product with its reciprocal,
which rounds apart from the division (``scripts/torch_quant_check.py``
counts the scales that would differ from the CPU's).

Layout: the JAX package stores a code matrix as (in, out). The port stores
it as (out, in), the contraction axis contiguous, and hands cuBLASLt its
transpose, the layout its int8 x int8 GEMMs take without a copy
(``scripts/torch_quant_check.py`` times both layouts). cuBLAS has shape
rules for int8 (more than 16 rows, K and N multiples of 8): a shape that
breaks them raises; it never falls back to a float product, which would be
another result.

Only the ViT block matmuls use this path. qkv and fc1 run int8 products;
proj and fc2 store int8 and run on their weights dequantized to the
compute dtype (the JAX package's measured split).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

_QMAX = 127.0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in f32, as a true division on every device."""
    return torch.clamp(amax, min=1e-12) / torch.full((), _QMAX, device=amax.device)


QUANT_COMPUTE = ("qkv", "fc1")
QUANT_WEIGHT_ONLY = ("proj", "fc2")


def quantize_weight(w: torch.Tensor, *, contract_axis: int = -2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of ``w`` (..., in,
    out), the ``nn.linear`` layout: the scale is the abs-max over the
    contraction axis. Returns (int8 codes in ``w``'s layout, f32 scales
    (..., out)), as the JAX package's ``quantize_weight``."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=contract_axis, keepdim=True))
    q = torch.clamp(torch.round(wf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale.squeeze(contract_axis)


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8 quantization over the last axis.
    Returns (int8 x, f32 per-row scales with a trailing keepdim); an
    all-zero row quantizes to zeros."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def qlinear(x: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ qw) (+ b) in ``x``'s dtype. ``qw``: int8
    (out, in), the stored layout; ``w_scale``: f32 (out,). The product is
    int8 x int8 -> int32 (``torch._int_mm`` on a contiguous (M, in) matrix
    and the transposed code matrix); the scales and the bias meet it in
    f32, in the JAX package's order."""
    xq, xs = quantize_act(x)
    o = torch._int_mm(xq.reshape(-1, x.shape[-1]), qw.t())
    y = o.float() * xs.reshape(-1, 1) * w_scale.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], qw.shape[0])


def dequantize_weight(qw: torch.Tensor, w_scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The (in, out) float weight of stored int8 codes (out, in) and their
    scales (the weight-only path of proj and fc2)."""
    return (qw.float() * w_scale.float()[:, None]).to(dtype).t()


def is_quantized_blocks(blocks: Dict[str, Any]) -> bool:
    return "qkv_qw" in blocks or "qkv_gqw" in blocks


def _q_transform(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """``<name>_w`` (L, in, out) -> ``<name>_qw`` int8 (L, out, in) and
    ``<name>_sw`` f32 (L, out) for every quantized matmul; every other key
    passes through."""
    out: Dict[str, Any] = {}
    for key, v in blocks.items():
        name = key[:-2] if key.endswith("_w") else None
        if name in QUANT_COMPUTE + QUANT_WEIGHT_ONLY:
            q, s = quantize_weight(v)
            out[f"{name}_qw"], out[f"{name}_sw"] = q.transpose(-1, -2).contiguous(), s
        else:
            out[key] = v
    return out


def quantize_params(params: Any) -> Any:
    """Quantize every stacked ViT blocks dict of a parameter tree (a dict
    with a ``qkv_w`` key); everything else passes through."""
    if isinstance(params, dict):
        if "qkv_w" in params:
            return _q_transform(params)
        return {k: quantize_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_params(v) for v in params]
    return params
