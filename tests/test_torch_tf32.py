"""The arithmetic of the f32 attention's tensor-core path (3xTF32), emulated
on the CPU, against the JAX package's f32 attention.

The CUDA kernel (``matrix_eyes_tpu_torch/csrc/attention_qkv.cu``) cannot run
here, so these tests pin the reason for its design: every f32 operand is
split as x = big + small with big = tf32(x), small = tf32(x - big), and
every product is small*big + big*small + big*big, each a TF32 product
accumulated in f32. TF32 keeps 10 mantissa bits; ``cvt.rna.tf32.f32``
rounds to nearest, ties away from zero. A product of two TF32 values is
exact in f32, so an f32 matmul of TF32-rounded operands emulates one
tensor-core product. The kernel's key order inside each 8-key group of
V^T (0 2 4 6 1 3 5 7, matching P's register layout) does not change a sum
over keys and is not emulated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrix_eyes_tpu.ops.attention import attention_xla as j_attention_xla

F32_RTOL, F32_ATOL = 1e-4, 1e-5  # the kernel's f32 tolerance on the card


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, keeping 10 of the 23 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands: one pass (big*big) or three."""
    (ab, as_), (bb, bs) = split(a), split(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def attention_tf32(q, k, v, scale: float, passes: int) -> torch.Tensor:
    """softmax(q k^T * scale) v on (B, H, N, D), both products in TF32, the
    softmax in f32 (max-subtracted, normalised after P V, as the kernel)."""
    s = product(q, k.transpose(-1, -2), passes) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p, v, passes) / p.sum(-1, keepdim=True)


def _fov_inputs(heads: int = 2):
    """The FOV ViT's attention shape (N = 577, D = 64), narrowed to `heads`."""
    rng = np.random.RandomState(0)
    return [rng.standard_normal((1, heads, 577, 64)).astype(np.float32) for _ in range(3)]


def _want(q, k, v, scale):
    return np.asarray(j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got == [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    r = torch.from_numpy(np.random.RandomState(1).standard_normal(1000).astype(np.float32))
    big, small = split(r)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    # big + small keeps ~21 mantissa bits of x
    assert float(((big + small - r).abs() / r.abs()).max()) < 2.0 ** -20


@pytest.mark.parametrize("n_valid", [None, 500])
def test_three_tf32_products_keep_f32_accuracy(n_valid):
    q, k, v = _fov_inputs()
    scale = 64 ** -0.5
    nv = 577 if n_valid is None else n_valid
    want = _want(q, k[:, :, :nv], v[:, :, :nv], scale)
    got = attention_tf32(*(torch.from_numpy(a) for a in (q, k[:, :, :nv], v[:, :, :nv])),
                         scale, passes=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)


def test_one_tf32_product_misses_f32_accuracy():
    q, k, v = _fov_inputs()
    scale = 64 ** -0.5
    want = _want(q, k, v, scale)
    got = attention_tf32(*(torch.from_numpy(a) for a in (q, k, v)), scale, passes=1).numpy()
    within = np.abs(got - want) <= F32_ATOL + F32_RTOL * np.abs(want)
    assert not within.all()
    three = attention_tf32(*(torch.from_numpy(a) for a in (q, k, v)), scale, passes=3).numpy()
    # three products cut the worst error by well over an order of magnitude
    assert np.abs(three - want).max() * 30 < np.abs(got - want).max()
