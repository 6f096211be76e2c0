"""The frozen FLOP ledger and the roofline bounds, from the model's shapes."""

import pytest

from eyebench.harness import ledger
from eyebench.tests.tiny import load

H100 = "NVIDIA H100 80GB HBM3"
DEPTH_PRO = load("eyebench", "configs", "depth_pro-bf16.json")["model"]


def test_flops_per_photo():
    assert ledger.model_flops(DEPTH_PRO)["total"] / 1e12 == pytest.approx(19.145, abs=5e-4)
    assert ledger.model_flops(DEPTH_PRO, with_fov=False)["total"] / 1e12 == pytest.approx(
        18.762, abs=5e-4)
    four = ledger.model_flops(DEPTH_PRO, batch=4, with_fov=True)["total"]
    assert four == pytest.approx(4 * ledger.model_flops(DEPTH_PRO)["total"], rel=1e-12)


def test_both_configurations_share_the_model():
    assert load("eyebench", "configs", "depth_pro-mixed.json")["model"] == DEPTH_PRO


def test_conv3x3_calls():
    calls = ledger.conv3x3_calls(DEPTH_PRO, 1, "bf16")
    assert len(calls) == 24
    assert sum(1 for c in calls if c[1] == 768) == 5      # 4 residual-unit convs + head conv0
    assert sum(1 for c in calls if c[1] == 1536) == 1     # the head's conv2
    assert [c[5] for c in calls].count(2) == 4            # fusion blocks with a skip
    assert ledger.conv3x3_bound_s(calls, H100) * 1e3 == pytest.approx(4.6389, abs=1e-3)
    f32 = ledger.conv3x3_calls(DEPTH_PRO, 1, "f32")
    assert ledger.conv3x3_bound_s(f32, H100) * 1e3 == pytest.approx(9.2689, abs=1e-3)


def test_attention_calls():
    calls = ledger.attention_calls(DEPTH_PRO, 4, True, "bf16")
    assert len(calls) == 72 and calls[0] == (140, 577, 16, 64, "bf16")
    assert calls[-1] == (4, 577, 16, 64, "f32")
    one = ledger.attention_bound_s(ledger.attention_calls(DEPTH_PRO, 1, False, "bf16"), H100)
    # the patch ViT's call is bound by its bytes: 4 x 35 x 16 x 577 x 64 x 2 B at 3.35 TB/s
    patch = 4 * 35 * 16 * 577 * 64 * 2 / 3.35e12
    image = max(4.0 * 16 * 577 * 577 * 64 / 989e12, 4 * 16 * 577 * 64 * 2 / 3.35e12)
    assert one == pytest.approx(24 * (patch + image), rel=1e-12)


def test_policy_dtypes():
    assert ledger.policy_dtypes("bf16") == {"vit": "bf16", "decoder": "bf16"}
    assert ledger.policy_dtypes("mixed") == {"vit": "bf16", "decoder": "f32"}
    assert ledger.policy_dtypes("int8") == {"vit": "bf16", "decoder": "bf16"}
    assert ledger.policy_dtypes("f32") == {"vit": "f32", "decoder": "f32"}


def test_peak_by_exact_name():
    assert ledger.peak(H100)["bf16"] == 989e12
    assert ledger.peak("NVIDIA H100 PCIe") is None
