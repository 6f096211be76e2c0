"""Busy time, idle share, idle gaps by span, and the per-layer readers'
arithmetic, on a synthetic trace."""

import importlib.util
import os
import types

import pytest

from eyebench.harness import ledger, trace
from eyebench.harness.cell import Window
from eyebench.tests.conftest import ROOT
from eyebench.tests.tiny import load

MS = 1_000_000
H100 = "NVIDIA H100 80GB HBM3"
OPS = [("attention_wgmma_kernel<bf16>", 0, 4 * MS), ("nvjet_hsh_128x256", 3 * MS, 10 * MS),
       ("conv3x3_wgmma_kernel", 20 * MS, 30 * MS), ("vectorized_elementwise_kernel", 30 * MS, 32 * MS),
       ("Memcpy HtoD (Pageable -> Device)", 40 * MS, 45 * MS)]
SPANS = [("upload", 9 * MS, 21 * MS), ("forward", 0, 38 * MS), ("readback", 45 * MS, 60 * MS)]


def _reader(name):
    spec = importlib.util.spec_from_file_location("m", os.path.join(ROOT, "eyebench", "metrics",
                                                                   name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(forwards, policy="bf16"):
    w = Window(t0=0.0, t1=0.1, attempted=4, failed=0, photos=4, latencies=[0.1],
               forwards=forwards)
    busy = trace.union_s(OPS, 0, 100 * MS)
    return types.SimpleNamespace(window=w, window_s=0.1, ops=OPS, spans=SPANS, busy_s=busy,
                                 lo_ns=0, hi_ns=100 * MS, kind=H100, policy=policy,
                                 config=load("eyebench", "configs", "depth_pro-bf16.json"))


def test_union_and_gaps():
    assert trace.union_s(OPS, 0, 100 * MS) == pytest.approx(0.027)
    assert trace.union_s(OPS, 5 * MS, 25 * MS) == pytest.approx(0.010)
    assert trace.gaps(OPS, 0, 100 * MS) == [(10 * MS, 20 * MS), (32 * MS, 40 * MS),
                                            (45 * MS, 100 * MS)]


def test_breakdown_charges_idle_to_the_spans_open():
    b = trace.breakdown(OPS, SPANS, 0, 100 * MS, "host")
    assert b["device_ops"][0] == ["conv3x3_wgmma_kernel", pytest.approx(0.010)]
    idle = dict((n, s) for n, s in b["idle_gaps"])
    # no kernel runs in 10-20 and 32-100 ms (the copy in 40-45 is no
    # kernel): 10-20 the upload (opened after the forward) to 21; 32-38 the
    # forward; 38-45 and 60-100 no span; 45-60 the readback
    assert idle == {"upload": pytest.approx(0.010), "forward": pytest.approx(0.006),
                    "host": pytest.approx(0.047), "readback": pytest.approx(0.015)}
    assert b["device_ops"][2] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(0.005)]


@pytest.mark.parametrize("name", ["device.idle.photos", "device.idle.photo"])
def test_idle_share(name):
    # kernels cover 0-10 and 20-32 ms of 100; the copy in 40-45 is idle
    assert _reader(name)(_run([(4, True)])) == pytest.approx(78.0)


def test_attention_roofline():
    run = _run([(4, True)])
    calls = ledger.attention_calls(run.config["model"], 4, True, "bf16")
    want = 100 * ledger.attention_bound_s(calls, H100) / 0.004
    assert _reader("kernels.attention_roofline")(run) == pytest.approx(want)


def test_conv3x3_roofline_follows_the_policy():
    bf16 = _reader("kernels.conv3x3_roofline")(_run([(4, False)]))
    mixed = _reader("kernels.conv3x3_roofline")(_run([(4, False)], "mixed"))
    calls = ledger.conv3x3_calls(load("eyebench", "configs", "depth_pro-bf16.json")["model"], 4,
                                 "bf16")
    assert bf16 == pytest.approx(100 * ledger.conv3x3_bound_s(calls, H100) / 0.010)
    assert mixed > bf16


def test_other_kernels():
    # only the elementwise kernel: 2 ms over 4 photos
    assert _reader("primitives.other_ms")(_run([(4, True)])) == pytest.approx(0.5)


def test_mfu():
    run = _run([(4, True), (4, False)])
    flops = ledger.model_flops(run.config["model"], 4, True)["total"] + ledger.model_flops(
        run.config["model"], 4, False)["total"]
    assert _reader("mfu")(run) == pytest.approx(100 * flops / 0.1 / 989e12)


def test_readers_without_data_return_nothing():
    run = _run([(4, True)])
    run.ops, run.busy_s, run.kind = [], None, "cpu"
    for name in ("kernels.attention_roofline", "kernels.conv3x3_roofline", "primitives.other_ms",
                 "device.idle.photos", "device.idle.photo", "mfu", "mfu.photo"):
        assert _reader(name)(run) is None
