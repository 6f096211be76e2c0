"""The readers of the program's own spans (``eyebench/harness/program.py``
and the metrics built on it) on a synthetic traced run: each number, and
None where the program records no span (an untraced run, a program
without the recorder, a window without the span)."""

import importlib.util
import os
import types

import pytest

from eyebench.harness import program, trace
from eyebench.harness.cell import Window
from eyebench.tests.conftest import ROOT

MS = 1_000_000
READERS = ["output.wait_ms", "output.resize_ms", "output.encode_ms", "dispatch.issue_ms",
           "pipeline.upload_idle_ms", "api.readback_idle_ms", "dispatch.replay_share"]

# kernels at 0-10, 30-50 and 70-80 ms; the copy at 12-20 is no kernel
OPS = [("attention_wgmma_kernel", 0, 10 * MS), ("Memcpy HtoD (Pageable -> Device)", 12 * MS, 20 * MS),
       ("conv3x3_wgmma_kernel", 30 * MS, 50 * MS), ("nvjet_tst_256x144", 70 * MS, 80 * MS)]
# (name, start ms, end ms, attrs) as one request of the program records them
SPANS = [
    ("dispatch.eager", -10, -5, {"program": "fwd_fnorm_b4"}),  # before the window
    ("api.inverse_depth_batch", 5, 95, None),
    ("pipeline.upload", 8, 25, None),
    ("dispatch.replay", 25, 27, {"program": "preprocess"}),
    ("pipeline.forward", 27, 60, None),
    ("dispatch.replay", 28, 31, {"program": "fwd_fnorm_b4"}),
    ("api.readback", 60, 90, None),
    ("output.wait", 91, 93, None),
    ("output.resize", 93, 94, None),
    ("output.encode", 94, 95, None),
    ("dispatch.capture", 100, 105, {"program": "fwd_fnorm_b4"}),  # after the window
]


def _reader(name):
    spec = importlib.util.spec_from_file_location("m", os.path.join(ROOT, "eyebench", "metrics",
                                                                   name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _records(spans):
    from matrix_eyes_tpu_torch.timings import Span

    return [Span(n, a * MS, b * MS, i + 1, None, 1, 0, attrs)
            for i, (n, a, b, attrs) in enumerate(spans)]


def _run(traced=True):
    w = Window(t0=0.0, t1=0.1, attempted=4, failed=0, photos=4, latencies=[0.1],
               forwards=[(4, False)])
    return types.SimpleNamespace(window=w, window_s=0.1, ops=OPS if traced else [], spans=[],
                                 busy_s=trace.union_s(OPS, 0, 100 * MS) if traced else None,
                                 lo_ns=0, hi_ns=100 * MS if traced else 0)


@pytest.fixture
def recorded(monkeypatch):
    from matrix_eyes_tpu_torch import timings

    def use(spans):
        records = _records(spans)
        monkeypatch.setattr(timings, "recorded", lambda: list(records))

    return use


def test_the_window_holds_only_its_spans(recorded):
    recorded(SPANS)
    got = program.spans(_run())
    assert [s.name for s in got] == [n for n, a, b, _ in SPANS if 0 <= a and b <= 100]
    assert program.spans(_run(traced=False)) is None


@pytest.mark.parametrize("name,want", [
    ("output.wait_ms", 0.5), ("output.resize_ms", 0.25), ("output.encode_ms", 0.25),
    # the forward's replay alone: the preprocess program is no forward
    ("dispatch.issue_ms", 3.0),
    # no kernel in 10-30: the upload is innermost in 10-25
    ("pipeline.upload_idle_ms", 15 / 4),
    # no kernel in 50-70 and 80-100: the readback is innermost in 60-70, 80-90
    ("api.readback_idle_ms", 20 / 4),
    # the capture and the eager call lie outside the window
    ("dispatch.replay_share", 100.0),
])
def test_each_reader_on_a_synthetic_run(recorded, name, want):
    recorded(SPANS)
    assert _reader(name)(_run()) == pytest.approx(want)


def test_the_replay_share_counts_every_mode(recorded):
    recorded(SPANS + [("dispatch.capture", 40, 45, {"program": "fwd_mixed_b4"}),
                      ("dispatch.eager", 61, 62, {"program": "render_depthmap"})])
    assert _reader("dispatch.replay_share")(_run()) == pytest.approx(50.0)


def test_idle_by_the_innermost_span_agrees_with_the_breakdown(recorded):
    # the harness's breakdown charges each idle stretch to the span open
    # across it that started last: the same rule over the program's spans
    recorded(SPANS)
    run = _run()
    spans = [(s.name, s.start_ns, s.end_ns) for s in program.spans(run)]
    by_breakdown = dict(trace.breakdown(OPS, spans, run.lo_ns, run.hi_ns, "none", n=50)["idle_gaps"])
    by_breakdown.pop("none")
    got = program.idle_by_innermost(run)
    assert set(got) == set(by_breakdown)
    for name, ns in got.items():
        assert ns / 1e9 == pytest.approx(by_breakdown[name])


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(recorded, name):
    read = _reader(name)
    recorded([])
    assert read(_run()) is None
    recorded([s for s in SPANS if s[0] == "api.inverse_depth_batch"])  # none it reads
    assert read(_run()) is None
    recorded(SPANS)
    assert read(_run(traced=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    from matrix_eyes_tpu_torch import timings

    monkeypatch.delattr(timings, "recorded")
    assert _reader(name)(_run()) is None
