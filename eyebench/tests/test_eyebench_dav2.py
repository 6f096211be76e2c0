"""The ``depth_anything_v2`` architecture: its ledger at the published sizes
against the port's ``flops.py``, its 3x3 convolutions against the port's
own calls, the resample roofline on a fabricated trace, the reference
against the port at f32, its weights in the port's layout, a pool of
another frame refused, and whole runs of its cell at tiny widths on the
CPU: correct, and not correct with the answer altered or the attention's
scale dropped.

``test_vit_faults_on_card`` runs the cell at its own size on the card; it
skips without one."""

import contextlib
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from eyebench.harness import architecture, ledger
from eyebench.harness.cell import Window
from eyebench.tests import tiny, tiny_dav2
from eyebench.tests.conftest import ROOT
from eyebench.tests.faults import attention_unscaled

H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000
CONFIG = tiny.load("eyebench", "configs", "depth_anything_v2-l-bf16.json")
LARGE = CONFIG["model"]
ARCH = architecture.of(CONFIG)


def test_the_configuration_names_the_architecture():
    assert ARCH.__name__.endswith("depth_anything_v2") and ARCH.has_fov is False
    assert ARCH.grid(LARGE) == (518, 924)
    assert ARCH.clamps["forward"][0] == 0.0 and ARCH.clamps["forward"][1] == float("inf")


def test_ledger_at_the_published_frame_is_the_ports():
    """2.58 TFLOP a 1920x1080 frame, the same number as the port's
    ``flops.dav2_flops`` at the 518x924 input, pinned."""
    from matrix_eyes_tpu_torch import flops
    from matrix_eyes_tpu_torch.config import DAV2_LARGE

    one = ARCH.forward_flops(LARGE, 1, True)
    assert one == 2583110724096.0
    assert one == flops.dav2_flops(DAV2_LARGE, 518, 924)["total"]
    assert ARCH.forward_flops(LARGE, 8, False) == 8 * one
    assert ARCH.model_config(CONFIG) == DAV2_LARGE
    calls = ARCH.attention_calls(LARGE, 8, True, "bf16")
    assert calls == [(8, 2443, 16, 64, "bf16")] * 24
    # 4 N^2 D a block: 23% of the forward's FLOPs
    attn = sum(4.0 * n * n * h * d for _b, n, h, d, _dt in calls)
    assert attn / one == pytest.approx(0.2271, abs=1e-4)


def test_conv3x3_calls_are_the_ports(monkeypatch):
    """Every 3x3 stride-1 conv of the port's forward at the tiny widths,
    recorded where it calls the kernel's wrapper, is one of the ledger's,
    with its residuals and bias."""
    import torch

    from matrix_eyes_tpu_torch.models import decoder, depth_anything
    from matrix_eyes_tpu_torch.ops import nn as port_nn

    model = dict(tiny_dav2.DAV2_TINY)
    cfg = ARCH.model_config({"model": model})
    params = ARCH.make_weights(model, 3, "cpu", torch.float32)
    seen = []

    def spy(real):
        def conv(x, w, b=None, skip=None, skip2=None, relu_in=False):
            seen.append((x.shape[0], x.shape[1], x.shape[2], w.shape[2], w.shape[3],
                         (skip is not None) + (skip2 is not None), b is not None, "f32"))
            return real(x, w, b, skip, skip2, relu_in)
        return conv

    h, w = ARCH.grid(model)
    img = torch.rand(2, h, w, 3, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(port_nn, "conv3x3", spy(port_nn.conv3x3))
    monkeypatch.setattr(decoder, "conv3x3", spy(decoder.conv3x3))
    depth_anything.forward(cfg, params, img)
    assert sorted(seen) == sorted(ARCH.conv3x3_calls(model, 2, "f32"))


def test_resample_roofline_on_a_fabricated_trace():
    """Two forwards of eight frames; 3 ms in PyTorch's upsampling kernels:
    the ledger's bytes at 3.35 TB/s over those 3 ms."""
    from eyebench import run as runner

    ops = [("void at::native::upsample_bilinear2d_nhwc_out_frame<c10::BFloat16>", 0, 2 * MS),
           ("void at::native::upsample_bicubic2d_out_frame<float, float>", 2 * MS, 3 * MS),
           ("attention_wgmma_kernel", 3 * MS, 9 * MS), ("Memcpy HtoD (Pageable -> Device)",
                                                         9 * MS, 10 * MS)]
    forwards = [(8, True), (8, True)]
    window = Window(t0=0.0, t1=0.1, attempted=16, failed=0, photos=16, latencies=[0.05] * 2,
                    forwards=forwards)
    run = types.SimpleNamespace(window=window, window_s=0.1, ops=ops, spans=[], busy_s=0.01,
                                lo_ns=0, hi_ns=100 * MS, kind=H100, policy="bf16",
                                config=CONFIG)
    size = {"u8": 1, "bf16": 2, "f32": 4}
    calls = ARCH.resample_calls(LARGE, 8, True, ledger.policy_dtypes("bf16"))
    nbytes = 2 * sum(a * size[da] + b * size[db] for a, da, b, db in calls)
    got = runner.reader("kernels.resample_roofline")(run)
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 0.003)
    # the frame's resize reads its u8 pixels once and writes the bf16 input
    assert calls[0] == (8 * 1080 * 1920 * 3, "u8", 8 * 518 * 924 * 3, "bf16")
    # then the fusion blocks' four and the head's one; no position embedding
    assert len(calls) == 6
    assert calls[-1] == (8 * 296 * 528 * 128, "bf16", 8 * 518 * 924 * 128, "bf16")
    # Depth Pro has no resample ledger: the reader reads nothing
    run.config = tiny.load("eyebench", "configs", "depth_pro-bf16.json")
    assert runner.reader("kernels.resample_roofline")(run) is None
    # no upsampling kernel in the trace: nothing either
    run.config, run.ops = CONFIG, ops[2:]
    assert runner.reader("kernels.resample_roofline")(run) is None


def test_mfu_and_attention_roofline_read_its_ledger():
    from eyebench import run as runner

    ops = [("attention_wgmma_kernel<__nv_bfloat16, 64, false>", 0, 10 * MS)]
    forwards = [(8, True)] * 3
    window = Window(t0=0.0, t1=0.5, attempted=24, failed=0, photos=24, latencies=[0.1] * 3,
                    forwards=forwards)
    run = types.SimpleNamespace(window=window, window_s=0.5, ops=ops, spans=[], busy_s=0.01,
                                lo_ns=0, hi_ns=500 * MS, kind=H100, policy="bf16",
                                config=CONFIG)
    assert runner.reader("mfu")(run) == pytest.approx(100 * 24 * 2583110724096.0 / 0.5 / 989e12)
    calls = ARCH.attention_calls(LARGE, 8, True, "bf16") * 3
    assert runner.reader("kernels.attention_roofline")(run) == pytest.approx(
        100 * ledger.attention_bound_s(calls, H100) / 0.010)


def test_weights_are_the_ports_layout():
    import torch

    from matrix_eyes_tpu_torch.models.spec import param_spec, tree_map

    model = dict(tiny_dav2.DAV2_TINY)
    params = ARCH.make_weights(model, 7, "cpu", torch.float32)
    assert tree_map(lambda _p, t: tuple(t.shape), params) == param_spec(
        ARCH.model_config({"model": model}))
    again = ARCH.make_weights(model, 7, "cpu", torch.float32)
    other = ARCH.make_weights(model, 8, "cpu", torch.float32)
    blocks = params["pretrained"]["blocks"]
    assert torch.equal(blocks["qkv_w"], again["pretrained"]["blocks"]["qkv_w"])
    assert not torch.equal(blocks["qkv_w"], other["pretrained"]["blocks"]["qkv_w"])
    # one layer's fan-in, LayerNorm scales about 1
    assert blocks["qkv_w"].std().item() == pytest.approx(32 ** -0.5, rel=0.1)
    assert 0.5 <= blocks["norm1_scale"].min().item() <= blocks["norm1_scale"].max().item() <= 1.5


def test_reference_matches_the_port_at_f32(monkeypatch):
    """The reference's layer equations against the port's forward at the
    tiny widths on the CPU, float32 on both sides, the same weights and
    photo; a non-square frame."""
    import torch

    from matrix_eyes_tpu_torch import api

    model = dict(tiny_dav2.DAV2_TINY)
    cfg = ARCH.model_config({"model": model})
    params = ARCH.make_weights(model, 3, "cpu", torch.float32)
    monkeypatch.setattr(api, "load_checkpoint", lambda *_a, **_k: (cfg, params))
    me = api.MatrixEyes("weights", dtype="f32", device="cpu", cfg=cfg)
    rng = np.random.RandomState(5)
    for hw in ((96, 160), (131, 77)):
        rgb = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        want = ARCH.reference(model, params, rgb, None, "cpu").numpy()
        got = me.inverse_depth_batch([rgb])[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max())
        fp8 = ARCH.reference(model, params, rgb, None, "cpu", "fp8").numpy()
        assert np.abs(fp8 - want).mean() > 100 * np.abs(got - want).mean()


def test_a_pool_of_another_frame_is_refused(tmp_path):
    import torch

    from eyebench import run as runner

    w, config, mix, limits = tiny_dav2.cell()
    mix["pool"].update(width=160, height=120)
    with pytest.raises(ValueError, match="frame"):
        runner.run_cell(w, config, mix, limits, tiny.bench(), 2**31 + 7, 0.5, False,
                        torch.device("cpu"), 1, "f32", str(tmp_path), out=lambda _s: None)


@pytest.mark.parametrize("generator", ["closed_forward", "closed_photo"])
def test_the_harness_span_targets_are_in_the_program(generator):
    """The functions the generators wrap in their spans in a traced run
    (a missing one is left alone, and its span silently goes) are the
    program's."""
    import importlib

    gen = importlib.import_module(f"eyebench.traffic.{generator}")
    for owner, attr, _name in gen.Cell._targets(None):
        assert callable(getattr(owner, attr, None)), (owner, attr)


@contextlib.contextmanager
def altered(alter):
    """The port's Depth Anything forward with ``alter`` applied to its
    relative inverse depth."""
    from matrix_eyes_tpu_torch.models import depth_anything

    real = depth_anything.forward
    depth_anything.forward = lambda *args, **kwargs: alter(real(*args, **kwargs))
    try:
        yield
    finally:
        depth_anything.forward = real


def test_cell_is_correct_on_cpu(tmp_path):
    res = tiny_dav2.run(tmp_path)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and "photos_per_s" in res["metrics"]
    assert list(res)[-1] == "compared"
    json.dumps(res)


@pytest.mark.parametrize("fault", ["band", "half_batch"])
def test_altered_answer_is_not_correct(fault, tmp_path):
    def band(inv):
        inv = inv.clone()
        inv[:, : inv.shape[1] // 3] *= 3.0  # a band of the frame three times nearer
        return inv

    def half_batch(inv):
        half = inv.shape[0] // 2
        return inv[:half].repeat(2, 1, 1) if half else inv

    with altered({"band": band, "half_batch": half_batch}[fault]):
        res = tiny_dav2.run(tmp_path)
    assert not res["correct"], res["compared"]


def test_attention_unscaled_is_not_correct(tmp_path):
    with attention_unscaled():
        res = tiny_dav2.run(tmp_path)
    assert not res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("variant", ["attention", "reference=fp8_vit"])
def test_vit_faults_on_card(variant):
    """At the cell's own size, never correct: the attention's 1/sqrt(d)
    scale dropped, and the reference with the ViT's products alone in fp8
    in the program's place."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, "-m", "eyebench.tests.readings", "--workload",
                           tiny_dav2.CELL, "--seeds", "103", str(2**31 + 11), "79",
                           "--variant", variant],
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines), lines
