"""3x3 stride-1 pad-1 convolution: the Hopper kernel (``csrc/conv3x3.cu``)
and its plain version.

Port of ``matrix_eyes_tpu/ops/conv3x3.py:conv3x3_pallas``: NHWC x HWIO +
bias, optional ReLU on the input (``relu_in``), up to two residuals added
in f32 in the epilogue (``skip``, ``skip2``), output in the input dtype.
The kernel takes any channel counts (the head's 129-channel composed conv
included); the TPU's lane and VMEM gates are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch.ops import _build

_SIGNATURES = {
    "me_conv3x3": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # x, w, bias
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # skip, skip2, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # B, H, W
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Cin, Cout, relu_in, dtype
        ctypes.c_void_p,                                        # stream
    ]),
}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  skip: Optional[torch.Tensor] = None, skip2: Optional[torch.Tensor] = None,
                  relu_in: bool = False) -> torch.Tensor:
    """The same function with ``F.conv2d``: the CPU path and the kernel's oracle."""
    if relu_in:
        x = F.relu(x)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    y = y.permute(0, 2, 3, 1).float()
    for s in (skip, skip2):
        if s is not None:
            y = y + s.float()
    return y.to(x.dtype).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            skip: Optional[torch.Tensor] = None, skip2: Optional[torch.Tensor] = None,
            relu_in: bool = False) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (3, 3, Cin, Cout) HWIO; b: (Cout,) or None;
    skip, skip2: (B, H, W, Cout) or None. Stride 1, padding 1.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes NHWC x and (3, 3, Cin, Cout) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    if b is not None and tuple(b.shape) != (Cout,):
        raise ValueError(f"bias must be ({Cout},), got {tuple(b.shape)}")
    for s in (skip, skip2):
        if s is not None and tuple(s.shape) != (B, H, W, Cout):
            raise ValueError(f"skip must be {(B, H, W, Cout)}, got {tuple(s.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, skip, skip2, relu_in)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on CUDA or CPU tensors, got {x.device}")
    operands = [t for t in (x, w, b, skip, skip2) if t is not None]
    for t in operands:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("conv3x3 operands must share the input's device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3 needs contiguous, 16-byte aligned operands")
    code = _build.dtype_code(x.dtype)
    lib = _build.load("conv3x3", _SIGNATURES)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.me_conv3x3(ptr(x), ptr(w), ptr(b), ptr(skip), ptr(skip2), ptr(out),
                            B, H, W, Cin, Cout, int(relu_in), code, stream)
    _build.check_launch(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
