"""Depth Anything V2's bilinear resampling (``ops/nn.py::resize_bilinear``)
on the CPU.

On the card it runs as one pass of ``csrc/resample.cu``, which must give
``F.interpolate``'s result bit for bit; chip_smoke.py holds it there at the
forward's five shapes. Here the wrapper runs its plain version, and these
tests hold:

* the plain version to ``F.interpolate`` on an NCHW tensor, bit for bit, at
  the five (in, out) grids of a 1080p frame's forward and at odd cases (an
  output or input of one pixel, downsampling, channel counts that are not a
  multiple of 8), in f32, bf16 and f16. PyTorch's CPU kernels for the two
  layouts differ by a rounding once its channels-last kernel vectorises
  over 8 channels or more on the larger grids, so the frame's grids are
  compared at 3 channels;
* the wrapper's device handling and its launch counter;
* a DAv2 forward on the tiny configuration calling it five times (four
  fusion blocks and the head), each a launch on the card;
* the kernel source: its note, the explicit roundings of PyTorch's
  arithmetic, and a kernel name that ``kernels.resample_roofline`` reads and
  no other reader claims.
"""

import collections
import os
import re

import pytest
import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch.config import DAV2_TINY
from matrix_eyes_tpu_torch.models import depth_anything
from matrix_eyes_tpu_torch.models.init import init_params
from matrix_eyes_tpu_torch.ops import _build, nn

SOURCE = os.path.join(os.path.dirname(nn.__file__), os.pardir, "csrc", "resample.cu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# (in, out) of the five resamplings of a 1920x1080 frame (518x924 input,
# a 37x66 patch grid): four fusion blocks at 256 channels, the head at 128
DAV2_GRIDS = [((19, 33), (37, 66)), ((37, 66), (74, 132)), ((74, 132), (148, 264)),
              ((148, 264), (296, 528)), ((296, 528), (518, 924))]
# (B, H, W, C, out_h, out_w)
ODD = [
    (2, 7, 9, 24, 31, 5),      # up in H, down in W
    (2, 11, 13, 16, 4, 6),     # down in both
    (3, 5, 7, 3, 17, 29),      # 3 channels
    (2, 13, 17, 9, 13, 40),    # H unchanged, C not a multiple of 8
    (1, 9, 9, 20, 1, 1),       # an output of one pixel: scale 0
    (2, 1, 1, 32, 5, 7),       # an input of one pixel
    (1, 6, 10, 8, 1, 19),      # one output row
    (2, 4, 5, 12, 4, 5),       # the same size: a copy
]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _nchw(x, out_h, out_w):
    """``F.interpolate`` on the NCHW copy of NHWC ``x``, back to NHWC."""
    y = F.interpolate(x.permute(0, 3, 1, 2).contiguous(), size=(out_h, out_w),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def _values(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(dtype)


def _check(x, out_h, out_w):
    want = _nchw(x, out_h, out_w)
    for got in (nn.resize_bilinear_plain(x, out_h, out_w), nn.resize_bilinear(x, out_h, out_w)):
        assert got.shape == (x.shape[0], out_h, out_w, x.shape[3]) and got.dtype == x.dtype
        assert got.is_contiguous()
        assert torch.equal(_bits(got), _bits(want.contiguous()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grids", DAV2_GRIDS, ids=lambda g: f"{g[0][0]}x{g[0][1]}")
def test_plain_is_f_interpolate_at_the_frames_grids(grids, dtype):
    (h, w), (out_h, out_w) = grids
    _check(_values((1, h, w, 3), h * w, DTYPES[dtype]), out_h, out_w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ODD, ids=lambda s: "x".join(map(str, s)))
def test_plain_is_f_interpolate_at_odd_shapes(shape, dtype):
    b, h, w, c, out_h, out_w = shape
    _check(_values((b, h, w, c), sum(shape), DTYPES[dtype]), out_h, out_w)


def test_align_corners_keeps_the_corners():
    x = _values((2, 19, 33, 5), 1, torch.float32)
    y = nn.resize_bilinear(x, 37, 66)
    for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        assert torch.equal(y[:, i, j], x[:, i, j])


def test_the_cpu_takes_the_plain_path_and_counts_nothing():
    before = dict(_build.ledger)
    nn.resize_bilinear(torch.ones(1, 3, 4, 8, dtype=torch.bfloat16), 5, 7)
    assert dict(_build.ledger) == before


@pytest.mark.parametrize("bad", [
    lambda: nn.resize_bilinear(torch.ones(1, 3, 4, 8, device="meta"), 5, 7),  # not CUDA or CPU
    lambda: nn.resize_bilinear(torch.ones(3, 4, 8), 5, 7),                     # not NHWC
    lambda: nn.resize_bilinear(torch.ones(1, 3, 4, 8), 0, 7),                  # no output row
    lambda: nn.resize_bilinear(torch.ones(1, 0, 4, 8), 5, 7),                  # no input row
])
def test_the_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        bad()


_KEY = (8, 19, 33, 256, 37, 66, "bfloat16")


def _resample_counts(calls, launches):
    """``resize_bilinear``'s launches added to the ledger by ``calls`` calls
    of a program that counts ``launches`` of them at ``_KEY``, as the
    wrapper counts its launches on the card, through a graph cache (eager,
    capture, then replays); the ledger is left as it was."""
    cache = aot.GraphCache(aot.HostGraphs())
    before = collections.Counter(_build.ledger)

    def program(x):
        for _ in range(launches):
            _build.check_launch(0, "resize_bilinear", *_KEY)
        return x

    for _ in range(calls):
        cache.call("dav2_fwd_b8", program, (torch.ones(2),))
    added = _build.ledger - before
    _build.ledger.subtract(added)
    return [mode for _name, mode in cache.modes], added


def test_graph_replays_count_the_launches(monkeypatch):
    monkeypatch.delenv("MATRIX_EYES_AOT", raising=False)
    modes, added = _resample_counts(3, 1)
    assert modes == ["eager", "capture", "replay"]
    assert added == collections.Counter({("resize_bilinear", *_KEY): 3})


def test_a_replay_adds_the_captured_launches(monkeypatch):
    # the five resamplings of a forward, added again by each replay
    monkeypatch.delenv("MATRIX_EYES_AOT", raising=False)
    modes, added = _resample_counts(5, 5)
    assert modes.count("replay") == 3
    assert added == collections.Counter({("resize_bilinear", *_KEY): 25})


@pytest.mark.parametrize("hw", [(70, 112), (112, 70)])
def test_a_forward_resamples_five_times(hw, monkeypatch):
    # on the card each call is one launch: the four fusion blocks' 2x
    # upsamplings and the head's to the input's size
    calls = []
    real = nn.resize_bilinear

    def spy(x, out_h, out_w):
        calls.append((tuple(x.shape), (out_h, out_w)))
        return real(x, out_h, out_w)

    monkeypatch.setattr(nn, "resize_bilinear", spy)
    cfg = DAV2_TINY
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    img = torch.zeros(1, *hw, 3)
    depth_anything.forward(cfg, params, img)
    gh, gw = hw[0] // cfg.patch_size, hw[1] // cfg.patch_size
    half = ((gh + 1) // 2, (gw + 1) // 2)
    grids = [half, (gh, gw), (2 * gh, 2 * gw), (4 * gh, 4 * gw), (8 * gh, 8 * gw)]
    assert [c[1] for c in calls] == grids[1:] + [hw]
    assert [c[0][1:3] for c in calls] == grids
    assert [c[0][3] for c in calls] == [cfg.features] * 4 + [cfg.head_widths[0]]


def _source():
    with open(SOURCE) as f:
        return f.read()


def _device_function(src, name):
    body = re.search(r"__device__ __forceinline__ \w+ " + name + r"\(.*?\n}\n", src, re.S)
    assert body, f"{name}'s device function not found"
    return body.group(0).split("{", 1)[1]


def test_the_kernel_source_writes_each_rounding_out():
    src = _source()
    # PyTorch's sums, each rounding named: a row's sum, the upper row's as
    # the f32 channels-last kernel has it, the rows added
    assert "__fmaf_rn(w.l0, a, __fmul_rn(w.l1, b))" in _device_function(src, "lower")
    assert "__fmaf_rn(w.l1, b, __fmul_rn(w.l0, a))" in _device_function(src, "upper_swapped")
    assert "__fmaf_rn(h.l0, up, __fmul_rn(h.l1, dn))" in _device_function(src, "vertical")
    # the source coordinate, its integer part and the weights
    coords = _device_function(src, "source")
    assert "__fmul_rn(scale, (float)dst)" in coords
    assert "__fsub_rn(r, (float)s.i)" in coords and "__fsub_rn(1.0f, s.l1)" in coords
    # no bare float product, sum or difference the compiler could contract
    for name in ("lower", "upper_swapped", "vertical", "source"):
        code = _device_function(src, name)
        assert not re.search(r"[\w)\]]\s*[*+]\s*[\w(]", code), (name, code)
    # the scale, as PyTorch's area_pixel_compute_scale
    assert "out > 1 ? (float)(in - 1) / (out - 1) : 0.0f" in src
    # the f32 build of PyTorch's channels-last kernel, which it runs from 16
    # channels, sums the upper row the other way
    assert "const bool swapped = sizeof(T) == 4 && channels >= 16;" in src


def test_the_kernel_source_has_its_note():
    src = _source()
    note = src.split("#include", 1)[0]
    assert "Replaces no TPU kernel" in note
    assert "bit for bit" in note and "What bounds it on this card: bytes" in note


def test_the_kernel_is_named_for_the_roofline_reader():
    src = _source()
    names = re.findall(r"__global__ void __launch_bounds__\(BLOCK\)\s*(\w+)", src)
    assert names == ["resample_bilinear_kernel"]
    # kernels.resample_roofline reads kernels named "resample"; primitives.
    # other_ms counts them, so no name of a library or of another kernel
    for name in names:
        assert "resample" in name
        assert not any(k in name.lower() for k in (
            "gemm", "xmma", "cutlass", "cublas", "nvjet", "cudnn", "conv", "attention",
            "split_tf32", "linker_scan", "threefry", "upsample"))
