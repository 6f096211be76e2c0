"""Stereogram pixel-linking scan: the Hopper kernel (``csrc/linker_scan.cu``)
and its plain version.

Port of ``matrix_eyes_tpu/ops/stereogram_kernel.py:linker_scan_tpu``. Per
row, ``out[x] = noise[x]`` for x < pw and ``out[x] = out[x - pw +
shift[x]]`` beyond, with 0 <= shift < win <= pw: every pixel is a copy of
a seed pixel, found by following parent links. The kernel walks each row
in steps of up to pw - win + 1 independent columns, every step in shared
memory (the row's shifts, its output bytes and the ring of resolved
pixels); only a ring too large for shared memory (pw past ~32K columns)
lives in a device scratch buffer that the wrapper allocates. The plain version
resolves every chain at once by pointer doubling (``torch.gather``), as the
JAX package does off the TPU. Both are bit-exact.
"""

from __future__ import annotations

import ctypes
import math

import torch

from matrix_eyes_tpu_torch.ops import _build

_SIGNATURES = {
    "me_linker_scan": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # shift, noise, out, scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int,               # H, W, noise width
        ctypes.c_int, ctypes.c_int,                             # pw, win
        ctypes.c_void_p,                                        # stream
    ]),
    "me_linker_scan_scratch_words": (ctypes.c_longlong, [ctypes.c_int] * 3),  # H, W, pw
}


def doubling_iterations(width: int, pw: int, win: int) -> int:
    """Pointer-doubling rounds that reach every chain's root: a link steps
    back at least pw - (win - 1) columns, which bounds the longest chain."""
    min_step = max(1, pw - win + 1)
    max_chain = max(2, -(-width // min_step))
    return max(1, math.ceil(math.log2(max_chain)))


def linker_scan_plain(shift: torch.Tensor, noise: torch.Tensor, pw: int,
                      win: int) -> torch.Tensor:
    """The scan by pointer doubling: the CPU path and the kernel's oracle.
    Resolves every row's links with rounds of root = root[root], then
    gathers the roots' noise pixels. Columns below pw, and columns whose
    link points at themselves (only possible when win > pw, the ``wide``
    case, which this version also serves), are roots."""
    H, W = shift.shape
    x = torch.arange(W, device=shift.device, dtype=torch.int64).expand(H, W)
    root = torch.where(x >= pw, x + shift.long() - pw, x)
    for _ in range(doubling_iterations(W, pw, win)):
        root = torch.gather(root, 1, root)
    return torch.gather(noise, 1, root[..., None].expand(H, W, 3))


def linker_scan(shift: torch.Tensor, noise: torch.Tensor, pw: int, win: int) -> torch.Tensor:
    """shift: (H, W) int32 with 0 <= shift < win; noise: (H, >= pw, 3) u8.
    Returns (H, W, 3) u8.

    Requires ``1 <= win <= pw``: a wider window would read columns not yet
    written (the ``wide`` self-link case, which callers resolve by pointer
    doubling). A CUDA tensor goes to the kernel (or raises); a CPU tensor
    goes to the plain version."""
    if not 1 <= win <= pw:
        raise ValueError(f"linker_scan requires 1 <= win <= pw, got win={win} pw={pw} (the "
                         "wide self-link case takes the pointer-doubling path)")
    if shift.dim() != 2 or noise.dim() != 3 or noise.shape[0] != shift.shape[0] \
            or noise.shape[1] < pw or noise.shape[2] != 3:
        raise ValueError(f"linker_scan takes shift (H, W) and noise (H, >={pw}, 3), got "
                         f"{tuple(shift.shape)} and {tuple(noise.shape)}")
    if shift.dtype != torch.int32 or noise.dtype != torch.uint8:
        raise ValueError(f"linker_scan takes int32 shift and uint8 noise, got {shift.dtype} "
                         f"and {noise.dtype}")
    if shift.device.type == "cpu" and noise.device.type == "cpu":
        return linker_scan_plain(shift, noise, pw, win)
    if shift.device.type != "cuda" or noise.device != shift.device:
        raise ValueError(f"linker_scan runs on CUDA or CPU tensors on one device, got "
                         f"{shift.device} and {noise.device}")
    if not shift.is_contiguous() or not noise.is_contiguous():
        raise ValueError("linker_scan needs contiguous shift and noise")
    H, W = shift.shape
    lib = _build.load("linker_scan", _SIGNATURES)
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=shift.device)
    words = lib.me_linker_scan_scratch_words(H, W, pw)
    scratch = torch.empty(words, dtype=torch.int32, device=shift.device) if words else None
    with torch.cuda.device(shift.device):
        stream = torch.cuda.current_stream(shift.device).cuda_stream
        rc = lib.me_linker_scan(shift.data_ptr(), noise.data_ptr(), out.data_ptr(),
                                None if scratch is None else scratch.data_ptr(),
                                H, W, noise.shape[1], pw, win, stream)
    _build.check_launch(rc, "linker_scan")
    return out
