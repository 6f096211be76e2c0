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

The ViT block's two elementwise chains, ``gelu_`` (in place) and
``scaled_residual`` (the LayerScale residual add), run on the card as one
pass each (``csrc/vit_elementwise.cu``): every input read once at its
stored dtype, the f32 arithmetic in registers, the output written once,
bit for bit the PyTorch chain of the plain version (``gelu_plain``,
``scaled_residual_plain``), which PyTorch runs as three passes with f32
intermediates in device memory. A CUDA tensor goes to the kernel (or
raises), a CPU tensor to the plain version.

Depth Anything V2's bilinear resamplings (``resize_bilinear``, the DPT
head's) run on the card as ``csrc/resample.cu``: 16-byte loads and stores,
each column's and row's weights computed once, an input row summed once
for the output rows it serves, bit for bit PyTorch's ``F.interpolate``
(the plain version, ``resize_bilinear_plain``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3

_SIGNATURES = {
    "me_vit_gelu": (ctypes.c_int, [
        ctypes.c_void_p,                                        # x, updated in place
        ctypes.c_longlong, ctypes.c_int,                        # elements, dtype
        ctypes.c_void_p,                                        # stream
    ]),
    "me_vit_scaled_residual": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # x, o, ls
        ctypes.c_void_p,                                        # out
        ctypes.c_longlong, ctypes.c_longlong,                   # elements, row width d
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # x, o, ls dtypes
        ctypes.c_void_p,                                        # stream
    ]),
}
_RESAMPLE_SIGNATURES = {
    "me_resample_bilinear": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p,                       # x, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # batch, in_h, in_w
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # out_h, out_w, channels
        ctypes.c_int,                                           # dtype
        ctypes.c_void_p,                                        # stream
    ]),
}
# a chunk of the kernels' vector loads, elements: the residual's rows are whole chunks
_VEC = 8


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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors: one CUDA device,
    contiguous and 16-byte aligned."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in tensors]}")
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in f32, rounded once to ``x.dtype``."""
    return F.gelu(x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU of ``x``, computed in f32 and rounded once to
    ``x.dtype``, in a new tensor (the JAX package's ``nn.gelu``): the plain
    version on a CPU tensor, ``gelu_`` on a copy of a CUDA tensor."""
    return gelu_plain(x) if x.device.type == "cpu" else gelu_(x.clone())


def gelu_(x: torch.Tensor) -> torch.Tensor:
    """``x`` <- exact (erf) GELU of ``x``, computed in f32 and rounded once
    to ``x.dtype``; returns ``x``. One pass of the ``vit_gelu`` kernel on a
    CUDA tensor, the plain version on a CPU tensor. In place, because the
    ViT block's (tokens, 4096) hidden is not read again: a separate output
    would add a buffer of that size to the caching allocator's segments."""
    if x.device.type == "cpu":
        return x.copy_(gelu_plain(x))
    _cuda_operands("gelu", x)
    code = _build.dtype_code(x.dtype)
    if x.numel() == 0:
        return x
    lib = _build.load("vit_elementwise", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.me_vit_gelu(x.data_ptr(), x.numel(), code, _stream(x.device))
    _build.check_launch(rc, "gelu", *x.shape, _dtype_name(x))
    return x


def scaled_residual_plain(x: torch.Tensor, o: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """x + o * ls (the LayerScale residual add), each operand and the
    product rounded to ``x.dtype`` as PyTorch rounds them."""
    return x + o.to(x.dtype) * ls.to(x.dtype)


def scaled_residual(x: torch.Tensor, o: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """x + o * ls for x and o of one shape (..., D) and ls (D,), the result
    in ``x.dtype``: one pass of the ``vit_scaled_residual`` kernel on CUDA
    tensors (D a multiple of 8), the plain version on CPU tensors."""
    if o.shape != x.shape or ls.shape != x.shape[-1:]:
        raise ValueError(f"scaled_residual takes x and o of one shape (..., D) and ls (D,), "
                         f"got {tuple(x.shape)}, {tuple(o.shape)}, {tuple(ls.shape)}")
    if x.device.type == "cpu" and o.device.type == "cpu" and ls.device.type == "cpu":
        return scaled_residual_plain(x, o, ls)
    _cuda_operands("scaled_residual", x, o, ls)
    codes = [_build.dtype_code(t.dtype) for t in (x, o, ls)]
    d = x.shape[-1]
    if d % _VEC:
        raise ValueError(f"scaled_residual's kernel takes rows of a multiple of {_VEC} "
                         f"elements, got {d}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load("vit_elementwise", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.me_vit_scaled_residual(x.data_ptr(), o.data_ptr(), ls.data_ptr(),
                                        out.data_ptr(), x.numel(), d, *codes,
                                        _stream(x.device))
    _build.check_launch(rc, "scaled_residual", *x.shape, *(_dtype_name(t) for t in (x, o, ls)))
    return out


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


def deconv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """Transposed conv, kernel k x k, stride k (no overlap), as matmul +
    depth-to-space: ``out[k*i+di, k*j+dj, o] = sum_c x[i, j, c] *
    w[c, (di*k+dj)*Co + o]``; w is (in, k * k * out)."""
    B, H, W, _ = x.shape
    co = w.shape[1] // (k * k)
    y = linear(x, w, None if b is None else b.repeat(k * k))
    y = y.reshape(B, H, W, k, k, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, k * H, k * W, co)


def deconv2x2(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed conv, kernel 2x2, stride 2 (``deconv`` at k = 2):
    ``out[2i+di, 2j+dj, o] = sum_c x[i, j, c] * w[c, (di*2+dj)*Co + o]``."""
    return deconv(x, w, b, 2)


def resize_bilinear_plain(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resampling of NHWC ``x`` to (out_h, out_w) with
    ``align_corners=True`` (``F.interpolate`` on the channels-last view: no
    transpose is copied), in ``x.dtype``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resampling of NHWC ``x`` (B, H, W, C) to (B, out_h, out_w,
    C) with ``align_corners=True``, in ``x.dtype``: one pass of the
    ``resample_bilinear`` kernel on a CUDA tensor, bit for bit
    ``F.interpolate``'s result; the plain version on a CPU tensor."""
    if x.dim() != 4 or min(x.shape[1], x.shape[2], out_h, out_w) < 1:
        raise ValueError(f"resize_bilinear takes a (B, H, W, C) tensor with H, W >= 1 to an "
                         f"out_h, out_w >= 1, got {tuple(x.shape)} to {(out_h, out_w)}")
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, out_h, out_w)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"resize_bilinear runs on contiguous CUDA or CPU tensors, "
                         f"got a {'' if x.is_contiguous() else 'non-'}contiguous one on {x.device}")
    code = _build.dtype_code(x.dtype)
    b, h, w, c = x.shape
    out = torch.empty((b, out_h, out_w, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("resample", _RESAMPLE_SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.me_resample_bilinear(x.data_ptr(), out.data_ptr(), b, h, w, out_h, out_w, c,
                                      code, _stream(x.device))
    _build.check_launch(rc, "resize_bilinear", b, h, w, c, out_h, out_w, _dtype_name(x))
    return out


def patch_embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, patch: int) -> torch.Tensor:
    """Non-overlapping patch embedding (conv k = s = patch) as one matmul;
    returns (B, H/p * W/p, D) tokens in row-major patch order."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return linear(x.reshape(B, gh * gw, patch * patch * C), w, b)
