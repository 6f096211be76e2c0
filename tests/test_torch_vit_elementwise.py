"""The ViT block's GELU and LayerScale residual add (``ops/nn.py``:
``gelu_``, in place, and ``scaled_residual``) on the CPU.

On the card each runs as one pass of ``csrc/vit_elementwise.cu``, which
must give the PyTorch chain it replaced bit for bit; chip_smoke.py holds it
there. Here the wrappers run their plain versions, and these tests hold:

* the plain versions to the expressions the ViT block wrote before, bit
  for bit, at every dtype pair the policies produce, on values that
  include negatives, zeros, subnormals and large magnitudes;
* the kernel's rounding scheme for the residual (operands and product
  rounded to x's dtype, then the sum: two roundings, no FMA), modelled in
  PyTorch's IEEE f32 arithmetic, to the same expression, and an FMA's
  single rounding to differ from it on the mixed policy's f32 LayerScale;
* ``block_forward`` on TINY under every policy to a copy of the old block,
  bit for bit, and a forward's calls: 2 gelu and 4 residuals a block
  pair for the patch and image ViTs, 3 and 6 with the FOV ViT;
* the wrappers' device handling and launch counters, and the kernel
  source's explicit roundings.
"""

import collections
import dataclasses
import math
import os
import re

import pytest
import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch.config import TINY, parse_dtype_policy
from matrix_eyes_tpu_torch.models import depth_pro, vit
from matrix_eyes_tpu_torch.models.init import init_params
from matrix_eyes_tpu_torch.ops import _build, nn
from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv
from matrix_eyes_tpu_torch.ops.quant import dequantize_weight, is_quantized_blocks, qlinear
from matrix_eyes_tpu_torch.pt.convert import place_params

SOURCE = os.path.join(os.path.dirname(nn.__file__), os.pardir, "csrc", "vit_elementwise.cu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# (x, o, ls): the residual's operand dtypes under the policies (x is the f32
# residual stream under every narrow policy; o the branch's compute dtype;
# ls bf16 or f16 as the weights, f32 under mixed), then the bf16 stream of a
# config without the f32 residual, and pairs no policy makes
RESIDUAL_DTYPES = [
    ("f32", "f32", "f32"),     # --dtype f32
    ("f32", "bf16", "bf16"),   # bf16, int8
    ("f32", "bf16", "f32"),    # mixed
    ("f32", "f16", "f16"),     # f16
    ("f32", "f16", "f32"),
    ("bf16", "bf16", "bf16"),  # vit_f32_residual off
    ("f16", "f16", "f16"),
    ("bf16", "f32", "f16"),
    ("f16", "bf16", "f32"),
]
POLICIES = ("f32", "bf16", "f16", "int8", "mixed")


def _values(shape, seed, dtype=torch.float32):
    """Seeded normal values at scales from 1e-3 to 1e3, with zeros, signed
    zeros, subnormals and large magnitudes written in."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    x = x * torch.exp(torch.empty(shape).uniform_(-7.0, 7.0, generator=g))
    flat = x.reshape(-1)
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 3e4, -3e4, 60000.0, -60000.0, 9.0, -9.0,
                             1e-8, -1e-8])
    flat[:specials.numel()] = specials[:flat.numel()]
    return x.to(dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 33), (2, 13, 4096)])
def test_gelu_is_the_old_expression(dtype, shape):
    x = _values(shape, 1, DTYPES[dtype])
    want = F.gelu(x.float()).to(x.dtype)
    for got in (nn.gelu_plain(x), nn.gelu(x)):
        assert got.dtype == x.dtype and torch.equal(_bits(got), _bits(want))
    same = x.clone()
    assert nn.gelu_(same) is same and torch.equal(_bits(same), _bits(want))


def _residual_operands(xd, od, ld, shape=(4, 9, 64), seed=2):
    x = _values(shape, seed, DTYPES[xd])
    o = _values(shape, seed + 1, DTYPES[od])
    # LayerScale: small positive and negative scales, a zero among them
    ls = (_values(shape[-1:], seed + 2) * 1e-2).to(DTYPES[ld])
    ls[3] = 0.0
    return x, o, ls


@pytest.mark.parametrize("xd,od,ld", RESIDUAL_DTYPES)
def test_scaled_residual_is_the_old_expression(xd, od, ld):
    x, o, ls = _residual_operands(xd, od, ld)
    want = x + o.to(x.dtype) * ls.to(x.dtype)
    for got in (nn.scaled_residual(x, o, ls), nn.scaled_residual_plain(x, o, ls)):
        assert got.dtype == x.dtype
        assert torch.equal(_bits(got), _bits(want))


def _round_to(t, dtype):
    return t.to(dtype).float()


@pytest.mark.parametrize("xd,od,ld", RESIDUAL_DTYPES)
def test_the_kernels_roundings_are_the_old_expression(xd, od, ld):
    # csrc/vit_elementwise.cu::scaled_residual: o and ls rounded to x's
    # dtype, __fmul_rn, rounded to x's dtype, __fadd_rn, rounded once more;
    # PyTorch's f32 mul and add on the CPU are IEEE's round-to-nearest
    x, o, ls = _residual_operands(xd, od, ld, seed=5)
    dt = x.dtype
    p = _round_to(_round_to(o.float(), dt) * _round_to(ls.float(), dt), dt)
    model = (x.float() + p).to(dt)
    assert torch.equal(_bits(model), _bits(x + o.to(dt) * ls.to(dt)))


def test_an_fma_would_differ_under_the_mixed_policy():
    # one rounding of x + o * ls (what nvcc's -fmad=true makes of a bare
    # x + o * ls) is not the chain: the f32 ls makes the product inexact
    x, o, ls = _residual_operands("f32", "bf16", "f32", shape=(64, 1024), seed=7)
    chain = x + o.float() * ls
    fma = (x.double() + o.double() * ls.double()).float()  # the product exact in f64
    assert not torch.equal(chain, fma)


def test_the_kernel_source_rounds_twice():
    with open(SOURCE) as f:
        src = f.read()
    body = re.search(r"__device__ __forceinline__ float scaled_residual\(.*?\n}\n", src, re.S)
    assert body, "scaled_residual's device function not found"
    code = body.group(0).split("{", 1)[1]
    assert "__fmul_rn(" in code and "__fadd_rn(" in code
    # no bare product or sum the compiler could contract into an FMA
    assert not re.search(r"[\w)\]]\s*[*+]\s*[\w(]", code), code
    # and GELU as PyTorch's GeluCUDAKernelImpl writes it
    assert "(x * 0.5f) * (1.0f + erff(x * kSqrtHalf))" in src
    assert re.search(r"kSqrtHalf = 0\.70710678118654752440f", src)
    # no name a benchmark reader files as a library's or as another kernel's
    for name in re.findall(r"__global__ void __launch_bounds__\(BLOCK\)\s*(\w+)", src):
        assert not any(k in name.lower() for k in (
            "gemm", "xmma", "cutlass", "cublas", "nvjet", "cudnn", "conv", "attention",
            "split_tf32", "linker_scan", "threefry")), name


def test_wrappers_take_the_plain_path_on_the_cpu():
    before = dict(_build.ledger)
    nn.gelu_(torch.ones(2, 8, dtype=torch.bfloat16))
    nn.gelu(torch.ones(2, 8))
    nn.scaled_residual(torch.ones(2, 8), torch.ones(2, 8, dtype=torch.bfloat16),
                       torch.ones(8, dtype=torch.bfloat16))
    assert dict(_build.ledger) == before


@pytest.mark.parametrize("bad", [
    lambda: nn.gelu_(torch.ones(2, 8, device="meta")),                 # not CUDA or CPU
    lambda: nn.gelu(torch.ones(2, 8, device="meta")),
    lambda: nn.scaled_residual(*(torch.ones(s, device="meta") for s in ((2, 8), (2, 8), (8,)))),
    lambda: nn.scaled_residual(torch.ones(2, 8), torch.ones(2, 8),
                               torch.ones(8, device="meta")),           # devices differ
    lambda: nn.scaled_residual(torch.ones(2, 8), torch.ones(2, 9), torch.ones(8)),  # o's shape
    lambda: nn.scaled_residual(torch.ones(2, 8), torch.ones(2, 8), torch.ones(2, 8)),  # ls's
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError):
        bad()


def test_graph_replays_count_the_launches(monkeypatch):
    # a ViT block's launches as the wrappers count them on the card, through
    # the graph cache: eager, capture, replay each count one block
    monkeypatch.delenv("MATRIX_EYES_AOT", raising=False)
    cache = aot.GraphCache(aot.HostGraphs())
    before = collections.Counter(_build.ledger)

    def block(x):
        _build.check_launch(0, "gelu", 35, 577, 4096, "bfloat16")
        for _ in range(2):
            _build.check_launch(0, "scaled_residual", 35, 577, 1024, "bfloat16", "bfloat16",
                                "bfloat16")
        return x

    for _ in range(3):
        cache.call("fwd_fnorm", block, (torch.ones(2),))
    assert [mode for _name, mode in cache.modes] == ["eager", "capture", "replay"]
    added = _build.ledger - before
    _build.ledger.subtract(added)
    assert added == collections.Counter({
        ("gelu", 35, 577, 4096, "bfloat16"): 3,
        ("scaled_residual", 35, 577, 1024, "bfloat16", "bfloat16", "bfloat16"): 6})


# -- the block, before and after ------------------------------------------------------

def _old_block_forward(cfg, p, x):
    """``vit.block_forward`` as it was before the one-pass kernels, on one
    device (no tensor-parallel mesh)."""
    quantized = is_quantized_blocks(p)
    wdt = p["norm1_scale"].dtype if quantized else p["qkv_w"].dtype
    scale = 1.0 / (cfg.head_dim ** 0.5)
    h = nn.layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        qkv = qlinear(h, p["qkv_qw"], p["qkv_sw"], p["qkv_b"])
    else:
        qkv = nn.linear(h, p["qkv_w"], p["qkv_b"])
    o = attention_qkv(qkv, cfg.num_heads, scale)
    proj_w = dequantize_weight(p["proj_qw"], p["proj_sw"], wdt) if quantized else p["proj_w"]
    o = nn.linear(o, proj_w, p["proj_b"])
    x = x + o.to(x.dtype) * p["ls1"].to(x.dtype)

    h = nn.layer_norm(x, p["norm2_scale"], p["norm2_bias"], cfg.layer_norm_eps).to(wdt)
    if quantized:
        h = qlinear(h, p["fc1_qw"], p["fc1_sw"], p["fc1_b"])
    else:
        h = nn.linear(h, p["fc1_w"], p["fc1_b"])
    h = F.gelu(h.float()).to(h.dtype)
    fc2_w = dequantize_weight(p["fc2_qw"], p["fc2_sw"], wdt) if quantized else p["fc2_w"]
    h = nn.linear(h, fc2_w, p["fc2_b"])
    return x + h.to(x.dtype) * p["ls2"].to(x.dtype)


def _live_blocks(cfg, seed):
    """TINY's canonical f32 tree with the patch ViT's blocks drawn per
    layer at working scales (matrices at 1/sqrt(fan_in), LayerNorm scales
    in [0.5, 1.5], biases and LayerScale in [0.05, 0.3], signs mixed), so
    that every block's branch moves the residual stream."""
    g = torch.Generator().manual_seed(seed)
    tree = init_params(cfg, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    blocks = tree["encoder"]["patch_encoder"]["blocks"]
    for k, v in blocks.items():
        if v.dim() == 3:
            blocks[k] = torch.randn(v.shape, generator=g) / math.sqrt(v.shape[1])
        elif "scale" in k:
            blocks[k] = torch.empty(v.shape).uniform_(0.5, 1.5, generator=g)
        else:
            sign = torch.where(torch.rand(v.shape, generator=g) < 0.5, -1.0, 1.0)
            blocks[k] = sign * torch.empty(v.shape).uniform_(0.05, 0.3, generator=g)
    return tree


@pytest.mark.parametrize("f32_residual", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_block_forward_is_bit_identical_to_the_old_block(policy, f32_residual):
    cfg = dataclasses.replace(TINY, vit_f32_residual=f32_residual)
    dtype, q8, mixed = parse_dtype_policy(policy)
    tree = place_params(_live_blocks(cfg, 3), "cpu", dtype, quantize_int8=q8, mixed_bf16=mixed)
    blocks = tree["encoder"]["patch_encoder"]["blocks"]
    wdt = blocks["norm1_scale"].dtype if is_quantized_blocks(blocks) else blocks["qkv_w"].dtype
    x = _values((3, cfg.seq_len, cfg.embed_dim), 4) * 1e-3
    x = x.float() if f32_residual or wdt == torch.float32 else x.to(wdt)
    new, old = x, x
    for i in range(cfg.depth):
        p = {k: v[i] for k, v in blocks.items()}
        new = vit.block_forward(cfg, p, new)
        old = _old_block_forward(cfg, p, old)
        assert new.dtype == x.dtype
        assert torch.equal(_bits(new), _bits(old)), (policy, i)
    assert not torch.equal(new, x)


@pytest.mark.parametrize("with_fov", [False, True])
def test_a_forward_calls_each_chain_as_the_launch_counts_say(with_fov, monkeypatch):
    # on the card each call is one launch: 48 gelu and 96 residual launches
    # a forward of DEPTH_PRO's 24-block ViTs with a focal length, 72 and
    # 144 with the FOV ViT; TINY has 2 blocks a ViT
    calls = {"gelu_": 0, "scaled_residual": 0}
    for name in calls:
        real = getattr(nn, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(nn, name, spy)
    tree = place_params(init_params(TINY, torch.Generator().manual_seed(0), "cpu",
                                    torch.float32), "cpu", torch.bfloat16)
    img = torch.zeros(1, TINY.img_size, TINY.img_size, 3, dtype=torch.bfloat16)
    if with_fov:
        depth_pro.forward_with_fov(TINY, tree, img)
    else:
        depth_pro.forward_with_fnorm(TINY, tree, img, torch.ones(1))
    vits = 3 if with_fov else 2
    assert calls == {"gelu_": vits * TINY.depth, "scaled_residual": 2 * vits * TINY.depth}
