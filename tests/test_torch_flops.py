"""The port's FLOP ledger (matrix_eyes_tpu_torch/flops.py) against the JAX
package's, its structure, an independent count, and the card's peak.

The copy must give the JAX ledger's floats exactly, key for key. The
structure tests mirror tests/test_flops.py on the copy. The independent
count is ``torch.utils.flop_counter.FlopCounterMode`` over the port's MID
forward on the CPU: it counts the executed GEMMs and convolutions (the
head's composed deconv+conv, the resampling matrices), the ledger the
logical model math, so the band is the one tests/test_flops.py holds XLA's
count to. The peak is looked up by the card's exact name.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from matrix_eyes_tpu import config as jconfig
from matrix_eyes_tpu import flops as jflops
from matrix_eyes_tpu_torch import config as tconfig
from matrix_eyes_tpu_torch import flops
from matrix_eyes_tpu_torch.config import DEPTH_PRO, MID, NoCudaDevice
from matrix_eyes_tpu_torch.models import depth_pro
from matrix_eyes_tpu_torch.models.init import init_params

CONFIGS = ("TINY", "MID", "DEPTH_PRO")
SXM = "NVIDIA H100 80GB HBM3"


# --- the copy gives the JAX ledger's floats ---------------------------------------

@pytest.mark.parametrize("with_fov", [True, False])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_equals_jax(name, batch, with_fov):
    want = jflops.model_flops(getattr(jconfig, name), batch=batch, with_fov=with_fov)
    got = flops.model_flops(getattr(tconfig, name), batch=batch, with_fov=with_fov)
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("name", CONFIGS)
def test_vit_flops_equals_jax(name):
    for n in (1, 35):
        assert flops.vit_flops(getattr(tconfig, name), n) == \
            jflops.vit_flops(getattr(jconfig, name), n)


# --- the original's structure, on the copy ---------------------------------------

def test_production_ledger_magnitude():
    led = flops.model_flops(DEPTH_PRO)
    assert 15e12 < led["total"] < 25e12
    assert led["patch_vit"] / led["total"] > 0.6
    # the 35-patch pyramid batch (encoder.rs:238-250), image and FOV encoders
    assert led["patch_vit"] == pytest.approx(35 * flops.vit_flops(DEPTH_PRO))
    assert led["image_vit"] == flops.vit_flops(DEPTH_PRO)
    assert led["fov_vit"] == flops.vit_flops(DEPTH_PRO)
    assert led["total"] == pytest.approx(sum(v for k, v in led.items() if k != "total"))
    assert set(led) == {"patch_vit", "image_vit", "encoder_chains", "decoder", "head",
                        "fov_vit", "fov_head", "resamples", "total"}


def test_batch_scales_linearly():
    a = flops.model_flops(MID)
    b = flops.model_flops(MID, batch=4)
    for k in a:
        assert b[k] == pytest.approx(4 * a[k]), k


def test_no_fov_drops_exactly_the_fov_stages():
    a = flops.model_flops(MID)
    b = flops.model_flops(MID, with_fov=False)
    assert "fov_vit" not in b and "fov_head" not in b
    assert b["total"] == pytest.approx(a["total"] - a["fov_vit"] - a["fov_head"])


def test_vit_flops_depth_linearity():
    base = flops.vit_flops(MID)
    deeper = flops.vit_flops(dataclasses.replace(MID, depth=MID.depth * 2))
    per_block = (deeper - base) / MID.depth
    N, D, M = MID.seq_len, MID.embed_dim, MID.mlp_ratio
    assert per_block == pytest.approx((8 + 4 * M) * N * D * D + 4 * N * N * D)


# --- an independent count ----------------------------------------------------------

def test_flop_counter_cross_check():
    # the port's MID forward with the FOV head on the CPU (f32, plain
    # versions of the kernels): the GEMMs and convolutions PyTorch counts
    # (addmm, bmm, mm, convolution) within 0.85-1.25 of the ledger, the
    # band tests/test_flops.py holds XLA's count to
    cfg = MID
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    img = np.random.RandomState(0).uniform(-1, 1, (1, cfg.img_size, cfg.img_size, 3))
    with FlopCounterMode(display=False) as counter:
        depth_pro.forward_with_fov(cfg, params, torch.from_numpy(img.astype(np.float32)))
    counted = counter.get_total_flops()
    led = flops.model_flops(cfg)
    assert 0.85 < counted / led["total"] < 1.25, (counted, led["total"])


# --- the card's peak, by exact name -----------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """A card whose name the test sets: ``card(name)``; the names asked
    for are recorded."""
    asked = []

    def install(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

        def get_device_name(device=None):
            asked.append(device)
            return name
        monkeypatch.setattr(torch.cuda, "get_device_name", get_device_name)
        return asked
    return install


@pytest.mark.parametrize("name,peak", [
    (SXM, 989e12),
    ("NVIDIA H100 PCIe", None),   # lower peaks than the SXM's: no prefix match
    ("NVIDIA H100 NVL", None),
    ("NVIDIA H100", None),
    ("NVIDIA H100 80GB HBM3 ", None),
])
def test_peak_matches_the_exact_card_name(card, name, peak):
    asked = card(name)
    assert flops.device_peak_flops() == peak
    assert asked == [torch.device("cuda")]  # the current card
    assert flops.device_peak_flops("cuda:0") == peak
    assert asked[-1] == torch.device("cuda", 0)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_cpu_has_no_peak(card, device):
    asked = card(SXM)
    assert flops.device_peak_flops(device) is None
    assert asked == []


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        flops.device_peak_flops()
    with pytest.raises(NoCudaDevice):
        flops.mfu(1e12, 1.0)
    assert flops.device_peak_flops("cpu") is None


def test_mfu_math():
    assert flops.mfu(989e12, 1.0, peak=989e12) == pytest.approx(1.0)
    assert flops.mfu(989e12, 2.0, peak=989e12) == pytest.approx(0.5)
    assert flops.mfu(19.1447e12, 0.0787, peak=989e12) == pytest.approx(0.246, abs=1e-3)


def test_mfu_none_without_a_peak_or_a_time(card):
    card("NVIDIA H100 PCIe")
    assert flops.mfu(1e12, 1.0) is None
    card(SXM)
    assert flops.mfu(989e12, 1.0) == pytest.approx(1.0)
    assert flops.mfu(1e12, 0.0) is None
    assert flops.mfu(1e12, -1.0, peak=989e12) is None
