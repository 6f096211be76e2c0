"""Multi-head self-attention, plain PyTorch: the oracle for the CUDA kernel.

Port of ``matrix_eyes_tpu/ops/attention.py``: ``softmax((q * scale) k^T) v``
with f32 scores and softmax, probabilities cast to the input dtype before
the P V product, f32 accumulation, output in the input dtype. Keys at or
past ``n_valid`` are masked with -1e30 (not -inf), the fused kernel's
contract (``ops/flash_attention.py``), so fully masked rows stay finite.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -1e30


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, H, N, D); returns (B, H, N, D)."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    n = k.shape[2]
    if n_valid is not None and n_valid < n:
        s[..., n_valid:] = MASK_VALUE
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_qkv_xla(qkv: torch.Tensor, num_heads: int, scale: float,
                      n_valid: Optional[int] = None) -> torch.Tensor:
    """Attention on the (B, N, 3C) qkv projection, feature axis ordered
    [q|k|v] x head x dim; returns (B, N, C), token-major."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
    o = attention_xla(q, k, v, scale, n_valid)
    return o.transpose(1, 2).reshape(B, N, C)
