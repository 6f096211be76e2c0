"""Faults planted in the program under test, for the runs that must come
out not correct."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def attention_unscaled():
    """Every ViT attention of the port with its 1/sqrt(head dim) scale
    dropped: softmax(q k^T) v, a fault inside the attention kernel's call
    that leaves every shape as it was."""
    from matrix_eyes_tpu_torch.models import vit

    real = vit.attention_qkv

    def unscaled(qkv, num_heads, scale, n_valid=None):
        return real(qkv, num_heads, 1.0, n_valid)

    vit.attention_qkv = unscaled
    try:
        yield
    finally:
        vit.attention_qkv = real
