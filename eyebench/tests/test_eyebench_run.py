"""Whole runs of every cell on the CPU at small widths (the port in float32
through its plain kernels), the reference against the port, and runs with
the timed path broken underneath, which must come out not correct.

``test_control_on_card`` runs each cell's control (the configuration's
lower precision in the program's place) on the card at the cell's own
size; it skips without a card."""

import contextlib
import itertools
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from eyebench.tests import tiny
from eyebench.tests.conftest import ROOT
from eyebench.tests.faults import attention_unscaled

CELLS = [w["name"] for w in tiny.bench()["workloads"]]
FORWARD_CELLS = [c for c in CELLS if c.endswith("forward-b4")]


@contextlib.contextmanager
def patched(obj, name, fn):
    real = getattr(obj, name)
    setattr(obj, name, fn(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _forwards():
    from matrix_eyes_tpu_torch.models import depth_pro

    return depth_pro, ("forward_with_fnorm", "forward_with_fov", "forward_with_mixed_fnorm")


@contextlib.contextmanager
def broken(alter):
    """Every forward of the port with ``alter`` applied to its inverse
    depth where the forward produces it."""
    depth_pro, names = _forwards()
    with contextlib.ExitStack() as stack:
        for name in names:
            def wrap(real):
                def run(*args, **kwargs):
                    out = real(*args, **kwargs)
                    if isinstance(out, tuple):
                        return (alter(out[0]),) + tuple(out[1:])
                    return alter(out)
                return run
            stack.enter_context(patched(depth_pro, name, wrap))
        yield


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_cpu(name, tmp_path):
    res = tiny.run(name, tmp_path)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "compared"
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, tmp_path):
    def alter(inv):
        inv = inv.clone()
        inv[:, : inv.shape[1] // 3] *= 3.0  # a band of the image three times nearer
        return inv

    with broken(alter):
        res = tiny.run(name, tmp_path)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_attention_unscaled_is_not_correct(name, tmp_path):
    with attention_unscaled():
        res = tiny.run(name, tmp_path)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", FORWARD_CELLS)
def test_half_batch_left_out_is_not_correct(name, tmp_path):
    def alter(inv):
        half = inv.shape[0] // 2
        return inv[:half].repeat(2, 1, 1) if half else inv

    # a seed whose window starts with a call that passes every focal
    # length, so that the inverse depth gaps judge both halves of a batch
    # however few calls a loaded machine makes in the window
    mix = tiny.cell(name)[2]
    seed = next(s for s in itertools.count(2**31 + 5) if _first_call_passes_every_focal(mix, s))
    with broken(alter):
        res = tiny.run(name, tmp_path, seed=seed)
    assert not res["correct"], res["compared"]


def _first_call_passes_every_focal(mix, seed):
    """As ``eyebench/traffic/closed_forward.py`` orders its cycle of calls."""
    pattern = [list(b) for b in mix["batches"]]
    random.Random(seed + 1).shuffle(pattern)
    return all(pattern[0])


def test_reference_matches_the_port_at_f32():
    """The reference's layer equations against the port's forward at MID
    widths on the CPU, float32 on both sides, the same weights and image."""
    import torch

    from eyebench.harness import architecture
    from eyebench.reference import model
    from eyebench.reference.weights import make_weights
    from matrix_eyes_tpu_torch.models import depth_pro

    cfg = tiny.MID
    params = make_weights(cfg, 3, "cpu", torch.float32)
    img = torch.rand(2, 512, 512, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    ref, ref_fov = model.inverse_depth(cfg, params, img, [None, 0.8])
    got, got_fov = depth_pro.forward_with_mixed_fnorm(
        architecture.of({}).model_config({"model": cfg}), params, img, torch.tensor([1.0, 0.8]),
        torch.tensor([False, True]))
    np.testing.assert_allclose(got_fov.numpy(), ref_fov.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=1e-6 * ref.max().item())


def test_no_card_no_result(capsys):
    import torch

    from eyebench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert e.value.code != 0
    assert "{" not in capsys.readouterr().out


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in tiny.bench()["workloads"]])
def test_control_on_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (101, 2**31 + 9, 77):
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "eyebench", "run.py"),
                               "--workload", name, "--seed", str(seed), "--seconds", "5",
                               "--trace", "0", "--control"], capture_output=True, text=True,
                              cwd=ROOT, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert not res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("variant", ["attention", "reference=fp8_vit"])
@pytest.mark.parametrize("name", [w["name"] for w in tiny.bench()["workloads"]
                                  if w["config"] == "depth_pro-bf16"])
def test_vit_faults_on_card(name, variant):
    """At the cell's own size, never correct: the attention's 1/sqrt(d)
    scale dropped, and the reference with the ViTs' products alone in
    fp8 in the program's place."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, "-m", "eyebench.tests.readings", "--workload", name,
                           "--seeds", "103", str(2**31 + 11), "79", "--variant", variant],
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines), lines


def test_a_later_cell_brings_its_own_comparison(tmp_path, monkeypatch):
    """A sample kind the harness does not know is judged by
    ``eyebench/checks/<kind>.py``: here one written for the test."""
    from eyebench.harness import check

    calls = []

    class Plugin:
        @staticmethod
        def compare(sample, reference, keep, control):
            calls.append(sample[0])
            keep("made_up_gap", 0.5)

    monkeypatch.setattr(check, "_plugin", lambda kind: Plugin)
    w, config, _mix, _limits = tiny.cell(CELLS[0])
    got = check.compare([("stereogram", str(tmp_path / "x.png"), None)], config, "cpu")
    assert calls == ["stereogram"] and got == {"made_up_gap": 0.5}
