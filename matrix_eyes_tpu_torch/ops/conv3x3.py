"""3x3 stride-1 pad-1 convolution: the Hopper kernel (``csrc/conv3x3.cu``)
and its plain version.

Port of ``matrix_eyes_tpu/ops/conv3x3.py:conv3x3_pallas``: NHWC x HWIO +
bias, optional ReLU on the input (``relu_in``), up to two residuals added
in f32 in the epilogue (``skip``, ``skip2``), output in the input dtype.
Both kernels (bf16 and f16 in one template, and f32 as three TF32 products
on the tensor cores) read their operands by TMA, whose strides must be
multiples of 16 bytes: channel counts that are not multiples of 8 are padded
with zeros around the launch (``conv3x3_padded``), which gives 16-bit
16-byte and f32 32-byte rows.
The TPU's lane and VMEM gates are not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch.ops import _build

_SIGNATURES = {
    "me_conv3x3_workspace_floats": (ctypes.c_longlong, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, Cin, Cout
        ctypes.c_int, ctypes.c_int,                                          # dtype, splits
    ]),
    "me_conv3x3": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # x, w, bias
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # skip, skip2, out
        ctypes.c_void_p,                                        # workspace
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # B, H, W
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Cin, Cout, relu_in, dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Wt, R, bn, splits
        ctypes.c_void_p,                                        # stream
    ]),
}

# output pixels per block, a band of R rows x Wt columns: the kernel's M tile
# (TC_BM in csrc/conv3x3.cu, which rejects any other band)
TILE_PIXELS = 128
_BAND_WIDTHS = (128, 64, 32, 16, 8)
# input channels per K step (TC_BK, TF_BK in csrc/conv3x3.cu), the modelled
# time of one 128 x 256 step and a block's fixed time (prologue, pipeline
# fill, epilogue), as measured on the H100: bf16 ~1.05 us a step (no fixed
# term); f32 ~2.2 us a step (1.1 at its 128-channel tile) and ~3.5 us a block.
# f16 runs bf16's code on the tensor cores at bf16's rate: bf16's entry.
_STEP = {torch.bfloat16: (64, 1.05e-6, 0.0), torch.float16: (64, 1.05e-6, 0.0),
         torch.float32: (32, 2.2e-6, 3.5e-6)}


class Plan(NamedTuple):
    """How the kernel cuts one call: the pixel band (wt columns x r rows),
    the output-channel tile and the number of K splits."""

    wt: int
    r: int
    bn: int
    splits: int


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, cin: int, cout: int, sms: int = 132,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The band that wastes the fewest pixels at the image's edges (wider
    on ties); N tile 256 above 128 output channels in bf16 and f16, else 128 (the
    f32 kernel's two accumulators fit no wider); and, for grids that
    leave SMs idle (fewer than four waves of blocks), the K split with the
    least modelled time: waves of blocks x the time of a block's K steps
    (``_STEP``: a step is one tap x 64 bf16/f16 or 32 f32 input channels), plus
    the split's f32 partials written and read at ~3 TB/s."""
    def waste(wt):
        r = TILE_PIXELS // wt
        return math.ceil(W / wt) * wt * math.ceil(H / r) * r

    wt = min(_BAND_WIDTHS, key=lambda w: (waste(w), -w))
    bn = 256 if cout > 128 and dtype != torch.float32 else 128
    tiles = B * math.ceil(H / (TILE_PIXELS // wt)) * math.ceil(W / wt) * math.ceil(cout / bn)
    channels, step_s, block_s = _STEP[dtype]
    steps = 9 * math.ceil(cin / channels)
    step_s *= bn / 256
    partial_s = B * H * W * cout * 8 / 3.0e12

    def cost(s):
        per = math.ceil(steps / s)
        return (math.ceil(tiles * math.ceil(steps / per) / sms) * (per * step_s + block_s)
                + (s * partial_s if s > 1 else 0.0))

    if tiles >= 4 * sms:  # a full card never pays for partial sums
        return Plan(wt, TILE_PIXELS // wt, bn, 1)
    splits = min(range(1, min(16, steps) + 1), key=cost)
    splits = math.ceil(steps / math.ceil(steps / splits))  # no split left empty
    return Plan(wt, TILE_PIXELS // wt, bn, splits)


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


def conv3x3_padded(fn, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   skip: Optional[torch.Tensor] = None, skip2: Optional[torch.Tensor] = None,
                   relu_in: bool = False) -> torch.Tensor:
    """Call ``fn`` (same arguments as ``conv3x3``) with Cin and Cout padded
    with zeros to multiples of 8 and return the first Cout channels. Zero
    input channels meet zero weight rows, so the sum is unchanged."""
    cin, cout = w.shape[2], w.shape[3]
    pi, po = -cin % 8, -cout % 8
    if pi == 0 and po == 0:
        return fn(x, w, b, skip, skip2, relu_in)

    def pad(t):
        return None if t is None else F.pad(t, (0, po)).contiguous()

    y = fn(F.pad(x, (0, pi)).contiguous(), F.pad(w, (0, po, 0, pi)).contiguous(), pad(b),
           pad(skip), pad(skip2), relu_in)
    return y[..., :cout].contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(key, x, w, b, skip, skip2, relu_in):
    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    code = _build.dtype_code(x.dtype)
    lib = _build.load("conv3x3", _SIGNATURES)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    p = plan(B, H, W, Cin, Cout, _sm_count(x.device), x.dtype)
    floats = lib.me_conv3x3_workspace_floats(B, H, W, Cin, Cout, code, p.splits)
    workspace = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.me_conv3x3(ptr(x), ptr(w), ptr(b), ptr(skip), ptr(skip2), ptr(out),
                            ptr(workspace), B, H, W, Cin, Cout, int(relu_in), code,
                            p.wt, p.r, p.bn, p.splits, stream)
    _build.check_launch(rc, "conv3x3", *key)
    return out


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
    # counted by (B, H, W, Cin, Cout, dtype, relu_in, residuals, bias) before padding
    key = (B, H, W, Cin, Cout, x.dtype, bool(relu_in),
           (skip is not None) + (skip2 is not None), b is not None)
    return conv3x3_padded(functools.partial(_launch, key), x, w, b, skip, skip2, relu_in)
