"""The arithmetic of the f32 attention's and the f32 conv3x3's tensor-core
paths (3xTF32), emulated on the CPU, against the JAX package's f32
attention and convolution.

The CUDA kernels (``matrix_eyes_tpu_torch/csrc/attention_qkv.cu``,
``csrc/conv3x3.cu``) cannot run here, so these tests pin the reason for
their design: every f32 operand is
split as x = big + small with big = tf32(x), small = tf32(x - big), and
every product is small*big + big*small + big*big, each a TF32 product
accumulated in f32. TF32 keeps 10 mantissa bits; ``cvt.rna.tf32.f32``
rounds to nearest, ties away from zero. A product of two TF32 values is
exact in f32, so an f32 matmul of TF32-rounded operands emulates one
tensor-core product. The kernel's key order inside each 8-key group of
V^T (0 2 4 6 1 3 5 7, matching P's register layout) does not change a sum
over keys and is not emulated. The conv is nine shifted matmuls, one per
tap, as the kernel's implicit GEMM walks K (tap-major).

The tensor cores round each wgmma's sum toward zero (a bias the card
showed past atol 1e-5 at 768^2 x 256 -> 256, K = 2304, with one
accumulator over the whole K). ``tensor_core_sum`` models that rounding; it is why the
conv kernel sums each 32-channel K step from zero and adds it to a
running f32 sum in registers, rounded to nearest.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrix_eyes_tpu.ops import nn as jnn
from matrix_eyes_tpu.ops.attention import attention_xla as j_attention_xla
from matrix_eyes_tpu.ops.conv3x3 import conv3x3_pallas

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


# --- the f32 conv3x3 ---------------------------------------------------------

K_STEP = 32  # input channels per K step of the f32 conv kernel (TF_BK)


def _shifted(x: torch.Tensor):
    """The nine taps' (B*H*W, Cin) views of zero-padded x, tap-major."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, du:du + H, dv:dv + W].reshape(B * H * W, C)
            for du in range(3) for dv in range(3)]


def conv3x3_tf32(x, w, b, skips, relu_in: bool, passes: int) -> torch.Tensor:
    """The kernel's conv on (B, H, W, Cin) x and HWIO w: ReLU on the input,
    zero padding, nine shifted TF32 products (one pass or three), then bias
    and residuals added in f32."""
    B, H, W, _ = x.shape
    if relu_in:
        x = torch.relu(x)
    y = sum(product(a, w[t // 3, t % 3], passes) for t, a in enumerate(_shifted(x)))
    y = y.reshape(B, H, W, -1) + b
    for s in skips:
        y = y + s
    return y


def _round_toward_zero(v: np.ndarray) -> np.ndarray:
    """f64 to f32, rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def tensor_core_sum(a: torch.Tensor, w: torch.Tensor, per_step: bool) -> np.ndarray:
    """a (M, K) @ w (K, N) as the kernel's wgmmas add it: k8 blocks, three
    TF32 products each (the small ones first), every wgmma's sum rounded
    toward zero into an f32 accumulator. per_step: the accumulator starts
    from zero every K_STEP rows of K and is added to a running f32 sum,
    rounded to nearest (the kernel); else one accumulator takes all of K."""
    (ab, as_), (wb, ws) = ([t.double().numpy() for t in split(m)] for m in (a, w))
    total = np.zeros((a.shape[0], w.shape[1]), np.float32)
    d = np.zeros_like(total)
    for k0 in range(0, a.shape[1], 8):
        if per_step and k0 and k0 % K_STEP == 0:
            total, d = (total.astype(np.float64) + d).astype(np.float32), np.zeros_like(d)
        k = slice(k0, k0 + 8)
        for p, q in ((as_, wb), (ab, ws), (ab, wb)):
            d = _round_toward_zero(d.astype(np.float64) + p[:, k] @ q[k])
    return (total.astype(np.float64) + d).astype(np.float32) if per_step else d


def _conv_inputs(shape, n_skips, seed):
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    skips = [rng.standard_normal((B, H, W, cout)).astype(np.float32) for _ in range(n_skips)]
    return x, w, b, skips


def _conv_want(x, w, b, skips, relu_in, via_xla):
    """The JAX package's f32 conv: the Pallas kernel in interpret mode, or
    (Cin = 129, which its lane gate sends there) XLA's conv."""
    j = [jnp.asarray(s) for s in skips] + [None] * (2 - len(skips))
    if not via_xla:
        return np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         skip=j[0], skip2=j[1], relu_in=relu_in,
                                         interpret=True))
    jx = jnn.relu(jnp.asarray(x)) if relu_in else jnp.asarray(x)
    y = jnn.conv2d(jx, jnp.asarray(w), jnp.asarray(b), padding=1)
    for s in j[:len(skips)]:
        y = y + s
    return np.asarray(y)


CONV_CASES = {  # (B, H, W, Cin, Cout), relu_in, residuals, via XLA
    "rcu": ((1, 12, 16, 128, 128), True, 2, False),   # the fused residual unit
    "head": ((2, 9, 7, 129, 128), False, 0, True),    # the head's composed conv, unpadded
    "k9216": ((1, 6, 6, 1024, 256), False, 0, False),  # the 48^2 projection's K
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_three_tf32_products_keep_f32_accuracy_in_conv(case):
    shape, relu_in, n_skips, via_xla = CONV_CASES[case]
    x, w, b, skips = _conv_inputs(shape, n_skips, seed=len(case))
    want = _conv_want(x, w, b, skips, relu_in, via_xla)
    got = conv3x3_tf32(*(torch.from_numpy(a) for a in (x, w, b)),
                       [torch.from_numpy(s) for s in skips], relu_in, passes=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)


def test_one_tf32_product_misses_f32_accuracy_in_conv():
    shape, relu_in, n_skips, via_xla = CONV_CASES["rcu"]
    x, w, b, skips = _conv_inputs(shape, n_skips, seed=3)
    want = _conv_want(x, w, b, skips, relu_in, via_xla)
    args = ([torch.from_numpy(a) for a in (x, w, b)], [torch.from_numpy(s) for s in skips])
    one = conv3x3_tf32(*args[0], args[1], relu_in, passes=1).numpy()
    three = conv3x3_tf32(*args[0], args[1], relu_in, passes=3).numpy()
    assert not (np.abs(one - want) <= F32_ATOL + F32_RTOL * np.abs(want)).all()
    assert np.abs(three - want).max() * 30 < np.abs(one - want).max()


def test_sums_rounded_toward_zero_need_per_step_accumulators():
    # K = 9216: one accumulator over all of K drifts past the tolerance;
    # summing each 32-channel step from zero (the kernel) stays far inside
    x, w, b, _ = _conv_inputs(CONV_CASES["k9216"][0], 0, seed=5)
    want = _conv_want(x, w, b, [], False, False)
    a = torch.cat(_shifted(torch.from_numpy(x)), dim=1)
    wk = torch.from_numpy(w).reshape(-1, w.shape[3])
    for per_step in (False, True):
        got = (tensor_core_sum(a, wk, per_step) + b).reshape(want.shape)
        within = np.abs(got - want) <= F32_ATOL + F32_RTOL * np.abs(want)
        assert within.all() == per_step
