"""The PyTorch port's primitives and kernel plain versions against the JAX package.

Inputs come from numpy seeds and go through both packages. On the CPU each
kernel wrapper runs its plain version; these tests hold that plain version
to the Pallas kernel (interpret mode) with the tolerances of
tests/test_flash_attention.py and tests/test_conv3x3.py (rtol 2e-5, atol
2e-6 / 2e-5: f32 sums in another order). The CUDA kernels themselves are
checked on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrix_eyes_tpu.ops import colormap as jcolormap
from matrix_eyes_tpu.ops import nn as jnn
from matrix_eyes_tpu.ops import resize as jresize
from matrix_eyes_tpu.ops.attention import attention_xla as j_attention_xla
from matrix_eyes_tpu.ops.conv3x3 import conv3x3_pallas
from matrix_eyes_tpu.ops.flash_attention import attention_flash as j_attention_flash
from matrix_eyes_tpu.ops.flash_attention import attention_flash_qkv
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops import colormap as tcolormap
from matrix_eyes_tpu_torch.ops import nn as tnn
from matrix_eyes_tpu_torch.ops import resize as tresize
from matrix_eyes_tpu_torch.ops.attention import attention_xla as t_attention_xla
from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_padded, conv3x3_plain, plan
from matrix_eyes_tpu_torch.ops.flash_attention import attention_flash, attention_qkv


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# --- kernel plain versions vs the Pallas kernels (interpret mode) -----------

@pytest.mark.parametrize("N,n_valid", [
    (70, 64),     # ragged N: the TPU block overhangs the array
    (130, 100),   # ragged N past one lane
    (577, 570),   # the production token count, keys masked past n_valid
    (577, None),  # the production token count, no mask
])
def test_attention_qkv_plain_matches_pallas(N, n_valid):
    B, H, D = 1, 4, 64
    rng = np.random.RandomState(N)
    qkv = _u(rng, (B, N, 3 * H * D))
    want = attention_flash_qkv(jnp.asarray(qkv), H, 0.125, n_valid=n_valid, interpret=True)
    got = attention_qkv(torch.from_numpy(qkv), H, 0.125, n_valid)
    _close(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("D", [8, 32])  # TINY and MID heads
@pytest.mark.parametrize("N,n_valid", [(577, 570), (70, 64)])
def test_attention_flash_plain_matches_pallas(D, N, n_valid):
    B, H = 2, 2
    rng = np.random.RandomState(N + D)
    q, k, v = (_u(rng, (B, H, N, D)) for _ in range(3))
    want = j_attention_flash(*(jnp.asarray(a) for a in (q, k, v)), D ** -0.5, n_valid=n_valid,
                             interpret=True)
    got = attention_flash(*(torch.from_numpy(a) for a in (q, k, v)), D ** -0.5, n_valid)
    assert tuple(got.shape) == (B, H, N, D)
    _close(got, want, rtol=2e-5, atol=2e-6)


def test_attention_xla_matches_jax():
    rng = np.random.RandomState(1)
    q, k, v = (_u(rng, (2, 2, 33, 16), -3, 3) for _ in range(3))
    want = j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25)
    got = t_attention_xla(*(torch.from_numpy(a) for a in (q, k, v)), 0.25)
    _close(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shape,relu_in,n_skips", [
    ((1, 12, 16, 128, 128), True, 2),   # the fused RCU with the fusion skip
    ((2, 8, 16, 128, 256), False, 0),   # plain conv, batched
    ((1, 16, 16, 128, 128), True, 1),   # the RCU's second conv
])
def test_conv3x3_plain_matches_pallas(shape, relu_in, n_skips):
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = _u(rng, (B, H, W, cin))
    w = _u(rng, (3, 3, cin, cout), -0.2, 0.2)
    b = _u(rng, (cout,), -0.5, 0.5)
    skips = [_u(rng, (B, H, W, cout)) for _ in range(n_skips)] + [None] * (2 - n_skips)
    j = [None if a is None else jnp.asarray(a) for a in skips]
    want = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), skip=j[0],
                          skip2=j[1], relu_in=relu_in, interpret=True)
    t = [None if a is None else torch.from_numpy(a) for a in skips]
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), t[0], t[1],
                  relu_in)
    _close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cin,cout,relu_in,with_skip", [
    (129, 128, False, False),  # the head's composed conv (ones channel)
    (8, 4, True, True),        # TINY decoder widths
    (12, 8, False, False),     # TINY projection
])
def test_conv3x3_unaligned_matches_jax_conv(cin, cout, relu_in, with_skip):
    rng = np.random.RandomState(cin + cout)
    x = _u(rng, (2, 9, 7, cin))
    w = _u(rng, (3, 3, cin, cout), -0.2, 0.2)
    b = _u(rng, (cout,), -0.5, 0.5)
    s = _u(rng, (2, 9, 7, cout))
    jx = jnn.relu(jnp.asarray(x)) if relu_in else jnp.asarray(x)
    want = jnn.conv2d(jx, jnp.asarray(w), jnp.asarray(b), padding=1)
    if with_skip:
        want = want + jnp.asarray(s)
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                  torch.from_numpy(s) if with_skip else None, relu_in=relu_in)
    _close(got, want, rtol=2e-5, atol=2e-5)


def test_wrappers_take_only_cpu_or_cuda_tensors():
    # a CPU tensor runs the plain version and counts no launch; any other
    # device raises instead of falling back
    before = dict(_build.ledger)
    attention_qkv(torch.zeros(1, 5, 3 * 2 * 8), 2, 0.5)
    attention_flash(*(torch.zeros(1, 2, 5, 8) for _ in range(3)), 0.5)
    conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 4))
    assert dict(_build.ledger) == before
    with pytest.raises(ValueError):
        attention_qkv(torch.zeros(1, 5, 48, device="meta"), 2, 0.5)
    with pytest.raises(ValueError):
        attention_flash(*(torch.zeros(1, 2, 5, 8, device="meta") for _ in range(3)), 0.5)
    with pytest.raises(ValueError):
        conv3x3(torch.zeros(1, 4, 4, 8, device="meta"), torch.zeros(3, 3, 8, 4, device="meta"))


@pytest.mark.parametrize("bad", [
    lambda: attention_qkv(torch.zeros(1, 5, 47), 2, 0.5),           # not 3 * H * D
    lambda: attention_qkv(torch.zeros(1, 5, 48), 2, 0.5, n_valid=6),  # n_valid > N
    lambda: attention_flash(torch.zeros(1, 2, 5, 8), torch.zeros(1, 2, 6, 8),
                            torch.zeros(1, 2, 5, 8), 0.5),            # k shape
    lambda: attention_flash(*(torch.zeros(1, 2, 8, 5).transpose(2, 3) for _ in range(3)),
                            0.5),                                     # D stride != 1
    lambda: attention_flash(*(torch.zeros(1, 2, 5, 9)[..., :7] for _ in range(3)),
                            0.5),                                     # rows not 16-byte aligned
    lambda: conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 7, 4)),  # Cin mismatch
    lambda: conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 4),
                    skip=torch.zeros(1, 4, 4, 5)),                    # skip shape
])
def test_wrappers_reject_bad_shapes(bad):
    with pytest.raises(ValueError):
        bad()


# --- primitives vs their JAX functions (f32; matmul-based ops may sum in
# another order: rtol 2e-5 / atol 2e-6; elementwise ops 1e-6 / 1e-7) --------

def _prim_cases():
    rng = np.random.RandomState(0)
    x = _u(rng, (2, 6, 8, 12))
    w = _u(rng, (12, 20))
    b = _u(rng, (20,))
    wd = _u(rng, (12, 4 * 5))
    bd = _u(rng, (5,))
    scale, bias = _u(rng, (12,)), _u(rng, (12,))
    img = _u(rng, (2, 32, 32, 3))
    wp = _u(rng, (16 * 16 * 3, 7))
    bp = _u(rng, (7,))
    w3 = _u(rng, (3, 3, 12, 6))
    b3 = _u(rng, (6,))
    w6 = _u(rng, (6, 6, 12, 1))
    xs = _u(rng, (1, 6, 6, 12))
    big = _u(rng, (1, 16, 24, 5), -3, 3)
    return {
        "linear": (lambda m, a: m.linear(a(x), a(w), a(b)), 2e-5, 2e-6),
        "linear_nobias": (lambda m, a: m.linear(a(x), a(w)), 2e-5, 2e-6),
        "layer_norm": (lambda m, a: m.layer_norm(a(x), a(scale), a(bias), 1e-6), 2e-5, 2e-6),
        # XLA's erf polynomial and torch's differ by a few ulp
        "gelu": (lambda m, a: m.gelu(a(big)), 1e-5, 1e-6),
        "relu": (lambda m, a: m.relu(a(big)), 0, 0),
        "deconv2x2": (lambda m, a: m.deconv2x2(a(x), a(wd), a(bd)), 2e-5, 2e-6),
        "deconv2x2_nobias": (lambda m, a: m.deconv2x2(a(x), a(wd)), 2e-5, 2e-6),
        "patch_embed": (lambda m, a: m.patch_embed(a(img), a(wp), a(bp), 16), 2e-5, 2e-6),
        "conv2d_s2": (lambda m, a: m.conv2d(a(x), a(w3), a(b3), stride=2, padding=1), 2e-5, 2e-6),
        "conv2d_k6_valid": (lambda m, a: m.conv2d(a(xs), a(w6), a(b3[:1])), 2e-5, 2e-6),
        "conv2d_3x3": (lambda m, a: m.conv2d(a(x), a(w3), a(b3), padding=1), 2e-5, 2e-6),
        "downsample_half": (lambda m, a: m.downsample_half(a(big[:, :, :16])), 1e-6, 1e-7),
        "downsample_quarter": (lambda m, a: m.downsample_quarter(a(big[:, :, :16])), 1e-6, 1e-7),
    }


_PRIMS = _prim_cases()
_RESIZE_OPS = ("downsample_half", "downsample_quarter")


@pytest.mark.parametrize("name", sorted(_PRIMS))
def test_primitive_matches_jax(name):
    fn, rtol, atol = _PRIMS[name]
    jmod, tmod = (jresize, tresize) if name in _RESIZE_OPS else (jnn, tnn)
    want = fn(jmod, jnp.asarray)
    got = fn(tmod, torch.from_numpy)
    assert got.dtype == torch.float32
    _close(got, want, rtol, atol)


@pytest.mark.parametrize("src,dst", [((37, 53), (96, 64)), ((96, 128), (40, 41))])
def test_resize_lanczos3_matches_jax(src, dst):
    rng = np.random.RandomState(src[0])
    img = rng.uniform(0, 255, src + (3,)).astype(np.float32)
    want = jresize.resize_lanczos3(jnp.asarray(img), *dst)
    got = tresize.resize_lanczos3(torch.from_numpy(img), *dst)
    _close(got, want, rtol=1e-5, atol=2e-4)  # values up to 255: atol ~ 1 ulp there


def test_to_u8_rounds_half_away_from_zero():
    x = np.array([-3.0, 0.25, 0.5, 1.5, 2.5, 254.5, 255.4, 300.0], np.float32)
    want = np.asarray(jresize.to_u8(jnp.asarray(x)))
    got = tresize.to_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, 1, 2, 3, 255, 255, 255])


def test_map_depth_bit_exact():
    rng = np.random.RandomState(3)
    edges = np.arange(256, dtype=np.float32) / np.float32(255.0)
    v = np.concatenate([rng.uniform(0, 1, 5000).astype(np.float32), edges,
                        np.array([0.0, 1.0, 1.5, np.nextafter(1.0, 0.0)], np.float32)])
    want = np.asarray(jcolormap.map_depth(jnp.asarray(v)))
    got = tcolormap.map_depth(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


# --- the conv3x3 wrapper around the kernels --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,relu_in,n_skips", [
    (129, 128, False, 0),  # odd Cin only
    (12, 5, True, 2),      # odd Cout, both residuals
    (5, 3, True, 1),       # both odd, narrower than one 8-channel vector
    (16, 8, False, 0),     # already aligned: no padding, same call
])
def test_conv3x3_channel_padding_gives_plain_result(dtype, cin, cout, relu_in, n_skips):
    # both kernels take channels in multiples of 8 (TMA strides of 16 bytes
    # in bf16, 32 in f32); the wrapper pads with zeros around them, which
    # must not change the result
    rng = np.random.RandomState(cin * 10 + cout)
    x = torch.from_numpy(_u(rng, (2, 6, 11, cin))).to(dtype)
    w = torch.from_numpy(_u(rng, (3, 3, cin, cout), -0.3, 0.3)).to(dtype)
    b = torch.from_numpy(_u(rng, (cout,))).to(dtype)
    skips = [torch.from_numpy(_u(rng, (2, 6, 11, cout))).to(dtype) for _ in range(n_skips)]
    skips += [None] * (2 - n_skips)
    seen = []

    def spy(*args):
        seen.append(tuple(args[1].shape))
        assert args[0].shape[-1] % 8 == 0 and args[1].shape[-1] % 8 == 0
        assert all(t is None or t.shape[-1] == args[1].shape[-1] for t in args[2:5])
        return conv3x3_plain(*args)

    got = conv3x3_padded(spy, x, w, b, skips[0], skips[1], relu_in)
    want = conv3x3_plain(x, w, b, skips[0], skips[1], relu_in)
    assert seen == [(3, 3, -(-cin // 8) * 8, -(-cout // 8) * 8)]
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 768, 768, 256, 256),   # RCU at the finest decoder level
    (1, 384, 384, 256, 256),
    (1, 192, 192, 512, 256),
    (1, 96, 96, 1024, 256),    # projection
    (1, 48, 48, 1024, 256),    # projection, K = 9216 on a small grid
    (1, 768, 768, 256, 128),   # head conv0
    (1, 768, 768, 136, 128),   # head's composed conv
    (2, 7, 9, 8, 8),           # TINY widths, ragged edges
])
def test_conv3x3_plan(shape, dtype):
    B, H, W, cin, cout = shape
    p = plan(B, H, W, cin, cout, sms=132, dtype=dtype)
    assert p.wt * p.r == 128 and p.wt in (8, 16, 32, 64, 128)
    # f32 holds two accumulators per output: 128 channels a block
    assert p.bn == (256 if cout > 128 and dtype == torch.bfloat16 else 128)
    steps = 9 * -(-cin // (64 if dtype == torch.bfloat16 else 32))  # K steps of 128 bytes
    assert 1 <= p.splits <= steps
    per = -(-steps // p.splits)
    assert -(-steps // per) == p.splits  # every split has K steps (the kernel checks this)
    if W % 8 == 0:
        assert W % p.wt == 0 and H % p.r == 0  # bands tile the image exactly
    blocks = B * -(-H // p.r) * -(-W // p.wt) * -(-cout // p.bn)
    if blocks >= 4 * 132:
        assert p.splits == 1  # a full card never pays for partial sums
    if shape == (1, 48, 48, 1024, 256):
        assert blocks < 132 and blocks * p.splits >= 100  # the split fills the card
