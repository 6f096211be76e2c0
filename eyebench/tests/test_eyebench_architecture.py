"""The architecture a configuration names is looked up by file
(``eyebench/harness/architecture.py``): Depth Pro reads through it exactly
as the harness read it before the lookup, an unknown name ends the run,
and a new architecture runs a cell with no edit to the harness."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from eyebench.harness import architecture, check, ledger
from eyebench.harness.cell import Window
from eyebench.tests import tiny
from eyebench.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000
DEPTH_PRO = tiny.load("eyebench", "configs", "depth_pro-bf16.json")["model"]


def test_a_configuration_without_the_key_runs_depth_pro():
    config = tiny.load("eyebench", "configs", "depth_pro-bf16.json")
    assert "architecture" not in config
    assert architecture.of(config) is architecture.of({"architecture": "depth_pro"})
    assert architecture.of(config).__file__ == os.path.join(ROOT, "eyebench", "architectures",
                                                            "depth_pro.py")


def test_depth_pro_ledger_through_the_dispatch():
    arch = architecture.of({})
    assert arch.forward_flops(DEPTH_PRO, 1, True) / 1e12 == pytest.approx(19.1447, abs=5e-5)
    assert arch.forward_flops(DEPTH_PRO, 1, False) / 1e12 == pytest.approx(18.7621, abs=5e-5)
    for photos in (1, 4):
        for fov in (False, True):
            assert arch.forward_flops(DEPTH_PRO, photos, fov) == ledger.model_flops(
                DEPTH_PRO, photos, fov)["total"]
            for dt in ("bf16", "f16", "f32"):
                assert arch.attention_calls(DEPTH_PRO, photos, fov, dt) == ledger.attention_calls(
                    DEPTH_PRO, photos, fov, dt)
        for dt in ("bf16", "f32"):
            assert arch.conv3x3_calls(DEPTH_PRO, photos, dt) == ledger.conv3x3_calls(
                DEPTH_PRO, photos, dt)
    for policy in ("bf16", "f16", "f32", "mixed", "int8"):
        assert arch.policy_dtypes(policy) == ledger.policy_dtypes(policy)
    assert arch.clamps == {"forward": (1e-4, 1e4), "depth_map": (1.0 / 250.0, 1.0 / 0.1)}
    assert arch.has_fov is True


def test_depth_pro_weights_through_the_dispatch():
    import torch

    from eyebench.reference.spec import leaves
    from eyebench.reference.weights import make_weights

    got = leaves(architecture.of({}).make_weights(tiny.TINY, 7, "cpu", torch.float32))
    want = leaves(make_weights(tiny.TINY, 7, "cpu", torch.float32))
    assert [path for path, _ in got] == [path for path, _ in want]
    for (path, a), (_path, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _samples(name, directory, seed):
    """Seeded samples of cell ``name`` at TINY widths: the reference's own
    inverse depth, worked out directly, under a fixed seeded perturbation,
    as the cell's generator hands them to the check."""
    import torch
    from PIL import Image

    from eyebench.harness.photos import make_pool
    from eyebench.reference import image, model
    from eyebench.reference.weights import make_weights

    _w, config, mix, _limits = tiny.cell(name)
    pool = mix["pool"]
    photos = make_pool(seed, os.path.join(directory, "pool"), 4, pool["width"], pool["height"],
                       pool["focal_mm"])
    cfg = config["model"]
    params = make_weights(cfg, config["weights_seed"], "cpu", torch.float32)
    gen = torch.Generator().manual_seed(seed % 2**63)
    focal = [p.focal_mm for p in photos]
    if mix["generator"] == "closed_forward":
        focal[2] = None  # the FOV head estimates one of the four
    got = []
    for p, f35 in zip(photos, focal):
        rgb, _exif = image.decode(p.path)
        h, w = rgb.shape[:2]
        x = image.preprocess(rgb, 4 * cfg["vit_img_size"], "cpu")
        inv = model.inverse_depth(cfg, params, x, [image.f_norm(f35, w, h)])[0][0]
        noise = torch.rand(inv.shape, generator=gen)
        inv = inv * (0.9 + 0.2 * noise)
        inv[: inv.shape[0] // 5] *= 1.5  # a band nearer
        got.append(inv)
    if mix["generator"] == "closed_forward":
        grid = torch.clamp(torch.stack(got), 1e-4, 1e4).numpy()
        return [("grid", grid, list(zip(photos, focal)), (1e-4, 1e4))]
    out = []
    for k, (p, inv) in enumerate(zip(photos, got)):
        rgb, _exif = image.decode(p.path)
        path = os.path.join(directory, f"depth-{k}.png")
        Image.fromarray(image.depth_map(inv, *rgb.shape[:2]).numpy()).save(path)
        out.append(("png", path, p))
        out.append(("grid", torch.clamp(inv, 1 / 250, 1 / 0.1).numpy()[None], [(p, p.focal_mm)],
                    (1 / 250, 1 / 0.1)))
    return out


# what check.compare returned on ``_samples(cell, _, 2**31 + 17)`` at the
# parent commit 35dd2da2e56b8b3cf3946cae35f16b136f4b9943, before the lookup
# (the same at 1 and 4 CPU threads); the second key is the configuration's
# control precision, computed in the program's place
_FORWARD = {"inv_gap": 0.47449865500560534, "inv_mean_gap": 0.14228766776162288,
            "inv_pool8_gap": 0.10979803689166745, "inv_pool32_gap": 0.10408928016537783,
            "inv_pool128_gap": 0.1028021385051264, "fov_gap": 0.024540066719055176,
            "fov_unread": 0.0}
AT_THE_PARENT = {
    ("depth_pro-bf16.photo-depthmap", None): {
        "png_mean_abs": 1.7567534722222222, "png_max_abs": 44.0, "inv_gap": 0.38930516242980956,
        "inv_mean_gap": 0.1415254175682949, "inv_pool8_gap": 0.10914040797502474,
        "inv_pool32_gap": 0.10342860648894049, "inv_pool128_gap": 0.1021741127755827},
    ("depth_pro-bf16.photo-depthmap", "fp8"): {
        "png_mean_abs": 1.2590104166666667, "png_max_abs": 15.0, "inv_gap": 0.44818387031555174,
        "inv_mean_gap": 0.14854054992464505, "inv_pool8_gap": 0.038920462347782764,
        "inv_pool32_gap": 0.02734075682700664, "inv_pool128_gap": 0.026376564232882007},
    ("depth_pro-mixed.forward-b4", None): _FORWARD,
    ("depth_pro-bf16.forward-b4", None): _FORWARD,
    ("depth_pro-bf16.forward-b4", "fp8"): {
        "inv_gap": 0.27590364777316145, "inv_mean_gap": 0.14899265959298627,
        "inv_pool8_gap": 0.03881104112209772, "inv_pool32_gap": 0.027028442749780963,
        "inv_pool128_gap": 0.02627485309720862, "fov_gap": 0.09924590587615967,
        "fov_unread": 0.0},
}


@pytest.mark.parametrize("name,control", list(AT_THE_PARENT), ids=lambda x: str(x))
def test_check_reads_as_at_the_parent(name, control, tmp_path):
    config = tiny.cell(name)[1]
    got = check.compare(_samples(name, str(tmp_path), 2**31 + 17), config, "cpu", control)
    want = AT_THE_PARENT[(name, control)]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k


def test_unknown_architecture_ends_the_run(tmp_path):
    """From a checkout whose configuration names an architecture that has no
    file: exit 2, the name on standard error, no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "eyebench"), tmp_path / "eyebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "eyebench" / "configs" / "depth_pro-bf16.json"
    config = json.loads(path.read_text())
    config["architecture"] = "no_such_model"
    path.write_text(json.dumps(config))
    proc = subprocess.run([sys.executable, "eyebench/run.py", "--workload",
                           "depth_pro-bf16.forward-b4", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no_such_model" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


# A toy depth model, written for this test alone: two plain 3x3 convs
# over the photo resized to a small grid, no focal-length estimate, and a
# FLOP ledger of its own. ``FAULT`` alters the session's answers where it
# produces them.
TOY = '''
import numpy as np
import torch
import torch.nn.functional as F

clamps = {"forward": (1e-3, 1e3), "depth_map": (1e-3, 1e3)}
has_fov = False
FAULT = False


def make_weights(model, seed, device, served):
    g = torch.Generator().manual_seed(seed)
    c = model["channels"]
    return {"w1": (torch.randn(c, 3, 3, 3, generator=g) / 27 ** 0.5).to(device, served),
            "w2": (torch.randn(1, c, 3, 3, generator=g) / (9 * c) ** 0.5).to(device, served)}


def _forward(model, params, x, focal):
    s = model["grid"]
    x = F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False)
    h = torch.relu(F.conv2d(x, params["w1"], padding=1))
    inv = F.softplus(F.conv2d(h, params["w2"], padding=1))[:, 0] + 0.1
    scale = torch.tensor([1.0 if f is None else 50.0 / f for f in focal])
    return inv * scale[:, None, None]


def _pixels(rgbs):
    return torch.stack([torch.from_numpy(np.array(r)).float().permute(2, 0, 1)
                        for r in rgbs]) / 255.0


def reference(model, params, rgb, f35, device, precision=None):
    return torch.clamp(_forward(model, params, _pixels([rgb]), [f35])[0], *clamps["forward"])


def depth_map(inverse_depth, h, w):
    v = torch.clamp(inverse_depth, *clamps["depth_map"])
    v = (v - v.min()) / (v.max() - v.min()).clamp_min(1e-12)
    v = F.interpolate(v[None, None], size=(h, w), mode="nearest")[0, 0]
    return (v * 255).round().to(torch.uint8)[..., None].expand(h, w, 3)


class _Session:
    def __init__(self, model, params):
        self.model, self.params = model, params

    def inverse_depth_batch(self, rgbs, focal):
        inv = _forward(self.model, self.params, _pixels(rgbs), focal)
        if FAULT:
            inv[:, : inv.shape[1] // 3] *= 3.0
        return torch.clamp(inv, *clamps["forward"]).numpy()


def session(ctx):
    served = {"bf16": torch.bfloat16, "f32": torch.float32}[ctx.config["weights"]]
    m = ctx.config["model"]
    return _Session(m, make_weights(m, ctx.config["weights_seed"], ctx.device, served))


def forward_flops(model, photos, variant):
    s, c = model["grid"], model["channels"]
    return photos * 2.0 * s * s * 9 * (3 * c + c)


def attention_calls(model, photos, variant, vit_dtype):
    return [(photos, model["grid"], 2, 16, vit_dtype)] * (2 if variant else 1)


def conv3x3_calls(model, photos, dtype):
    s, c = model["grid"], model["channels"]
    return [(photos, s, s, 3, c, 0, False, dtype), (photos, s, s, c, 1, 0, False, dtype)]


def policy_dtypes(policy):
    return {"vit": "f32", "decoder": "f32"}
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy architecture, found by the harness's lookup in a directory of
    the test's own; (its module, a forward-b4 cell's files naming it)."""
    arch_dir = tmp_path / "architectures"
    arch_dir.mkdir()
    (arch_dir / "toy.py").write_text(TOY)
    monkeypatch.setattr(architecture, "DIR", str(arch_dir))
    w, config, mix, limits = tiny.cell("depth_pro-bf16.forward-b4")
    config["architecture"] = "toy"
    config["model"] = {"grid": 128, "channels": 8}
    return architecture.of(config), (w, config, mix, limits)


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "answer_altered"])
def test_a_new_architecture_needs_no_harness_edit(toy, fault, tmp_path, monkeypatch):
    import torch

    from eyebench import run as runner

    mod, (w, config, mix, limits) = toy
    monkeypatch.setattr(mod, "FAULT", fault)
    work = tmp_path / "run"
    work.mkdir()
    res = runner.run_cell(w, config, mix, limits, tiny.bench(), 2**31 + 29, 0.5, False,
                          torch.device("cpu"), 1, "f32", str(work), out=lambda _s: None)
    assert res["attempted"] > 0 and res["failed"] == 0
    # no focal-length estimate: those images join the inverse depth gaps
    assert res["compared"]["fov_gap"]["value"] is None and "fov_unread" not in res["compared"]
    assert res["correct"] is not fault, res["compared"]


def test_a_new_architecture_brings_its_own_ledger(toy):
    """``mfu`` and ``kernels.attention_roofline`` on a fabricated trace of
    two forwards of four photos, one with the variant: the toy's ledger."""
    from eyebench import run as runner

    mod, (_w, config, _mix, _limits) = toy
    ops = [("attention_tf32_kernel", 0, 2 * MS), ("conv3x3_tf32_kernel", 2 * MS, 5 * MS)]
    forwards = [(4, False), (4, True)]
    window = Window(t0=0.0, t1=0.1, attempted=8, failed=0, photos=8, latencies=[0.05, 0.05],
                    forwards=forwards)
    run = types.SimpleNamespace(window=window, window_s=0.1, ops=ops, spans=[], busy_s=0.005,
                                lo_ns=0, hi_ns=100 * MS, kind=H100, policy="bf16", config=config)
    m = config["model"]
    flops = sum(mod.forward_flops(m, n, v) for n, v in forwards)
    assert runner.reader("mfu")(run) == pytest.approx(100 * flops / 0.1 / 989e12)
    calls = [c for n, v in forwards for c in mod.attention_calls(m, n, v, "f32")]
    assert len(calls) == 3
    want = 100 * ledger.attention_bound_s(calls, H100) / 0.002
    assert runner.reader("kernels.attention_roofline")(run) == pytest.approx(want)
    conv = [c for n, _v in forwards for c in mod.conv3x3_calls(m, n, "f32")]
    assert runner.reader("kernels.conv3x3_roofline")(run) == pytest.approx(
        100 * ledger.conv3x3_bound_s(conv, H100) / 0.003)
