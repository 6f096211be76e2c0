"""Neural-net primitives in NHWC, with the JAX package's weight layouts.

Port of ``matrix_eyes_tpu/ops/nn.py``. Layouts are kept so that weights
carry across as copies and the kernels read what they were designed for:

* activations: NHWC;
* ``conv2d`` weights: HWIO;
* ``linear`` weights: (in, out), the op is ``x @ w + b``;
* ``deconv2x2`` weights: (in, 4 * out), a matmul plus depth-to-space;
* ``patch_embed`` weight: (patch * patch * 3, embed).

Every primitive returns its input's dtype. LayerNorm statistics and GELU
run in f32; GELU is the exact erf form. Matmuls accumulate in f32 (cuBLAS
does for bf16 and f16); a half-precision product is rounded once, with the
bias added in the GEMM epilogue where cuBLAS fuses it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b); w is (in, out). A bias of another dtype than ``x``
    (the mixed policy's f32 biases on bf16 block matmuls) is added to the
    f32 product before the one rounding to ``x.dtype``, as the JAX package
    does: rounding it to ``x.dtype`` first gives another result."""
    if b is None:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if b.dtype == x.dtype:
        y = torch.addmm(b, x2, w)
    elif x.is_cuda:
        y = torch.addmm(b.float(), x2, w, out_dtype=torch.float32).to(x.dtype)
    else:  # the CPU has no out_dtype GEMM: exact products of the upcast operands
        y = torch.addmm(b.float(), x2.float(), w.float()).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[1])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as an f32 product, not rounded to ``x.dtype``: the partial sums
    of a row-split linear, which the ranks add in f32 before its bias and
    its one rounding (the JAX package's dot with an f32 result, reduced by
    GSPMD in f32)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = torch.mm(x2, w)
    elif x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:  # the CPU has no out_dtype GEMM: exact products of the upcast operands
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[1])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in f32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in f32."""
    return F.gelu(x.float()).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2D convolution, NHWC activations, HWIO weights. Every 3x3 stride-1
    pad-1 conv goes to the conv3x3 kernel; the rest (the FOV head's
    strided and 6x6 convs) to ``F.conv2d``."""
    if stride == 1 and padding == 1 and tuple(w.shape[:2]) == (3, 3):
        return conv3x3(x, w, b)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def deconv2x2(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed conv, kernel 2x2, stride 2, as matmul + depth-to-space:
    ``out[2i+di, 2j+dj, o] = sum_c x[i, j, c] * w[c, (di*2+dj)*Co + o]``."""
    B, H, W, _ = x.shape
    co = w.shape[1] // 4
    y = linear(x, w, None if b is None else b.repeat(4))
    y = y.reshape(B, H, W, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * W, co)


def patch_embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, patch: int) -> torch.Tensor:
    """Non-overlapping patch embedding (conv k = s = patch) as one matmul;
    returns (B, H/p * W/p, D) tokens in row-major patch order."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return linear(x.reshape(B, gh * gw, patch * patch * C), w, b)
