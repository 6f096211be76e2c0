"""Attention: the Hopper kernel (``csrc/attention_qkv.cu``) behind two
entries, and their plain versions.

* ``attention_qkv``, port of ``matrix_eyes_tpu/ops/flash_attention.py:
  attention_flash_qkv``: reads q, k and v straight out of the (B, N, 3C)
  qkv projection and writes the (B, N, C) output. The ViT calls this one.
* ``attention_flash``, port of ``attention_flash``: separate (B, H, N, D)
  q, k, v, each read through its own strides, so permuted views need no
  copy.

Either way the (B, H, N, N) score tensor never touches device memory. The
kernel takes f32, bf16 and f16 and any token count (577 as it is: no token
padding; the bf16 and f16 path keeps a head's K and V whole in shared
memory up to 640 keys at D = 64 and 1536 at D = 32, and streams them
through a ring beyond) and the head sizes of every config: 8, 32 and 64.
f32 at D = 32 and 64 runs on the tensor cores at f32 accuracy (3xTF32): a
pre-pass splits q, k and v into TF32 halves in a scratch buffer that the
wrapper allocates, about twice the inputs' size. The TPU kernel's lane
grouping of heads and its f16 exclusion (``flash_supported_dtype``, a
Mosaic limit) are not needed here: a block serves one head, and f16 runs
the bf16 path's code.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops.attention import attention_qkv_xla as attention_qkv_plain
from matrix_eyes_tpu_torch.ops.attention import attention_xla as attention_flash_plain

HEAD_DIMS = (8, 32, 64)  # TINY, MID, DEPTH_PRO
_LOG2E = 1.4426950408889634  # exp(x) = exp2(x * log2 e)


_SIGNATURES = {
    "me_attention_qkv": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # qkv, out, scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, D
        ctypes.c_int, ctypes.c_float, ctypes.c_int,             # n_valid, scale*log2e, dtype
        ctypes.c_void_p,                                        # stream
    ]),
    "me_attention_bhnd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
        ctypes.c_void_p,                                        # scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, N, D
        ctypes.c_int, ctypes.c_float, ctypes.c_int,             # n_valid, scale*log2e, dtype
        ctypes.POINTER(ctypes.c_longlong),                      # 12 (b, h, n) strides
        ctypes.c_void_p,                                        # stream
    ]),
    "me_attention_scratch_floats": (ctypes.c_longlong, [ctypes.c_int] * 6),  # B N H D n_valid dtype
    "me_attention_kv_path": (ctypes.c_int, [ctypes.c_int] * 3),  # D n_valid dtype
}
# me_attention_kv_path's answers: how a launch reads a head's keys and values
_KV_PATHS = ("cuda_cores", "resident", "streamed")


def _scratch(lib, B: int, N: int, H: int, D: int, n_valid: int, code: int,
             device) -> Optional[torch.Tensor]:
    """The f32 path's device scratch (the split TF32 operands), or None
    where the kernel needs none."""
    floats = lib.me_attention_scratch_floats(B, N, H, D, n_valid, code)
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def kv_path(n_valid: int, D: int, dtype: torch.dtype) -> str:
    """How the kernel reads a head's keys and values, as the library
    chooses (``me_attention_kv_path``; it builds and loads the library):
    ``resident`` (bf16 and f16 at D = 32 and 64, K and V whole in shared
    memory: up to 640 keys at D = 64, 1536 at D = 32), ``streamed`` (their
    ring beyond that, and the f32 3xTF32 kernel's rings at every length) or
    ``cuda_cores`` (D = 8)."""
    lib = _build.load("attention_qkv", _SIGNATURES)
    return _KV_PATHS[lib.me_attention_kv_path(D, n_valid, _build.dtype_code(dtype))]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


__all__ = ["attention_qkv", "attention_qkv_plain", "attention_flash", "attention_flash_plain",
           "HEAD_DIMS", "kv_path"]


def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per (batch, head) from the (B, N, 3C) qkv
    buffer ([q|k|v] x head x dim); returns (B, N, C). Keys at or past
    ``n_valid`` (default N) are masked with -1e30.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C), got shape {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    if C3 % 3 != 0 or (C3 // 3) % num_heads != 0:
        raise ValueError(f"qkv feature axis {C3} must be 3 * num_heads * head_dim "
                         f"(num_heads={num_heads})")
    n_valid = N if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= N:
        raise ValueError(f"n_valid must be in [1, {N}], got {n_valid}")
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, scale, n_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv runs on CUDA or CPU tensors, got {qkv.device}")
    C = C3 // 3
    D = C // num_heads
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {HEAD_DIMS}, got {D}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention_qkv needs a contiguous, 16-byte aligned qkv tensor")
    code = _build.dtype_code(qkv.dtype)
    lib = _build.load("attention_qkv", _SIGNATURES)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    scratch = _scratch(lib, B, N, num_heads, D, n_valid, code, qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.me_attention_qkv(qkv.data_ptr(), out.data_ptr(), _ptr(scratch), B, N,
                                  num_heads, D,
                                  n_valid, float(scale) * _LOG2E, code, stream)
    # counted by (B, N, heads, D, dtype, K/V path): under tensor parallelism a
    # rank runs num_heads / model heads; the path is the library's (``kv_path``)
    _build.check_launch(rc, "attention_qkv", B, N, num_heads, D, str(qkv.dtype).split(".")[-1],
                        _KV_PATHS[lib.me_attention_kv_path(D, n_valid, code)])
    return out


def attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    n_valid: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per (batch, head) on separate (B, H, N, D)
    q, k, v; returns a new contiguous (B, H, N, D). Keys at or past
    ``n_valid`` (default N) are masked with -1e30.

    Every operand needs a unit stride on D and 16-byte aligned rows (data
    pointer and batch, head and token strides); anything else raises, on
    every device, rather than being copied into another layout. A CUDA
    tensor goes to the kernel (or raises); a CPU tensor goes to the plain
    version."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, D = q.shape
    n_valid = N if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= N:
        raise ValueError(f"n_valid must be in [1, {N}], got {n_valid}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("attention_flash operands must share one dtype and device")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                t.stride(i) * t.element_size() % 16 for i in range(3)):
            raise ValueError("attention_flash needs a unit stride on D and 16-byte aligned "
                             f"rows, got strides {t.stride()}")
    if q.device.type == "cpu":
        return attention_flash_plain(q, k, v, scale, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention_flash runs on CUDA or CPU tensors, got {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {HEAD_DIMS}, got {D}")
    code = _build.dtype_code(q.dtype)
    lib = _build.load("attention_qkv", _SIGNATURES)
    out = torch.empty((B, H, N, D), dtype=q.dtype, device=q.device)
    scratch = _scratch(lib, B, N, H, D, n_valid, code, q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.me_attention_bhnd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   _ptr(scratch), B, H, N, D, n_valid, float(scale) * _LOG2E, code, strides,
                                   stream)
    _build.check_launch(rc, "attention_flash")
    return out
