"""The port's span recorder (``matrix_eyes_tpu_torch/timings.py``) on the
CPU: off unless ``MATRIX_EYES_TIMINGS`` is set or a ``torch.profiler``
trace runs, on the profiler's clock, spans nested by context into
requests, the bounded buffer, the table kept apart, and the spans a
``MatrixEyes`` session records where the work happens.

The dispatch spans of the graph cache are held in test_torch_aot.py, the
server's in test_torch_serve.py."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu_torch import pipeline, timings
from matrix_eyes_tpu_torch.api import MatrixEyes

import torch_ref


@pytest.fixture
def off(monkeypatch):
    monkeypatch.delenv("MATRIX_EYES_TIMINGS", raising=False)
    timings.clear()
    yield
    timings.clear()


@pytest.fixture
def on(monkeypatch):
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    timings.clear()
    yield
    timings.clear()


def test_nothing_is_recorded_when_off(off):
    assert not torch.autograd.profiler._is_profiler_enabled
    before = timings.snapshot()
    for _ in range(3):
        with timings.trace("pipeline.decode", {"k": 1}) as s:
            assert s is None
        with timings.span("decode source image"):
            pass
    assert timings.recorded() == [] and timings.snapshot() == before
    # the same do-nothing object every time: nothing is allocated
    assert timings.trace("a") is timings.trace("b") is timings.span("c")
    assert timings.current_request() is None


@pytest.mark.parametrize("value", ["", "0"])
def test_an_empty_or_zero_variable_is_off(off, monkeypatch, value):
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", value)
    with timings.trace("x"):
        pass
    assert not timings.enabled() and timings.recorded() == []


def test_a_profiler_window_records_exactly_its_spans(off):
    x = torch.randn(64, 64)
    with timings.trace("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not timings.enabled()
        with timings.trace("outer"):
            with timings.trace("inner", {"program": "mm"}):
                x @ x
    with timings.trace("after"):
        pass
    spans = {s.name: s for s in timings.recorded()}
    assert sorted(spans) == ["inner", "outer"]
    assert spans["inner"].attrs == {"program": "mm"}
    ops = [ev for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CPU and ev.name() == "aten::mm"]
    assert ops
    for ev in ops:  # the profiler's clock is the spans' clock
        t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert spans["inner"].start_ns <= t0 <= t1 <= spans["inner"].end_ns
    # the table is MATRIX_EYES_TIMINGS' alone
    assert "outer" not in timings.snapshot()


def test_spans_nest_into_requests(on):
    with timings.trace("a") as a:
        assert timings.current_request() == a.request
        with timings.trace("b"):
            with timings.trace("c"):
                pass
        with timings.trace("d"):
            pass
    with timings.trace("e"):
        pass
    s = {r.name: r for r in timings.recorded()}
    assert s["a"].parent is None and s["b"].parent == s["a"].id
    assert s["c"].parent == s["b"].id and s["d"].parent == s["a"].id
    assert len({s[n].request for n in "abcd"}) == 1
    assert s["e"].parent is None and s["e"].request != s["a"].request
    assert len({r.id for r in s.values()}) == 5
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].end_ns <= s["b"].end_ns <= s["a"].end_ns
    assert all(r.thread == threading.get_ident() for r in s.values())
    assert [r.name for r in timings.request_spans(s["a"].request, s["a"].start_ns)] == \
        ["a", "b", "c", "d"]


def test_threads_do_not_share_requests(on):
    seen = {}

    def work(tag):
        with timings.trace(f"root.{tag}"):
            with timings.trace(f"child.{tag}"):
                time.sleep(0.01)
        seen[tag] = threading.get_ident()

    with timings.trace("main"):
        # a thread started inside an open span starts its own request
        threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    s = {r.name: r for r in timings.recorded()}
    assert s["root.x"].parent is None and s["root.y"].parent is None
    assert len({s[n].request for n in ("root.x", "root.y", "main")}) == 3
    assert s["child.x"].request == s["root.x"].request
    assert s["child.y"].parent == s["root.y"].id
    assert s["root.x"].thread == seen["x"] != seen["y"] == s["root.y"].thread


def test_the_buffer_is_bounded_and_the_table_counts_every_span(on):
    assert timings.BUFFER >= 2 ** 16
    n = timings.BUFFER + 5
    for _ in range(n):
        with timings.span("stage"):
            pass
    kept = timings.recorded()
    assert len(kept) == timings.BUFFER and all(s.name == "stage" for s in kept)
    assert kept[0].id == kept[-1].id - timings.BUFFER + 1  # the oldest went
    assert timings.snapshot()["stage"][0] == n


def test_threads_recording_at_once_lose_no_span(on):
    # the buffer, the table's totals and the ids are shared by every thread
    import sys

    n, workers = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with timings.span("stage"):
                    with timings.trace("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = timings.recorded()
    assert timings.snapshot()["stage"][0] == n * workers
    assert len(spans) == 2 * n * workers and len({s.id for s in spans}) == len(spans)
    assert len({s.request for s in spans}) == n * workers


def test_the_table_keeps_the_cli_stages_only(on):
    with timings.span("decode source image"):
        with timings.trace("pipeline.decode"):
            pass
    assert list(timings.snapshot()) == ["decode source image"]
    s = {r.name: r for r in timings.recorded()}
    assert s["pipeline.decode"].parent == s["decode source image"].id


def test_the_forward_waits_for_the_card_under_the_variable_alone(off, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    cuda = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with timings.trace("pipeline.forward"):
            pipeline._wait_for_forward(cuda)
    assert calls == [] and [s.name for s in timings.recorded()] == ["pipeline.forward"]
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    pipeline._wait_for_forward(cuda)
    assert calls == [cuda]


# -- the spans of a session ------------------------------------------------------------

@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_timings")
    ckpt = str(d / "tiny.pt")
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5).state_dict(), ckpt)
    rng = np.random.RandomState(4)
    photos = []
    for i, shape in enumerate(((480, 640, 3), (300, 200, 3))):
        photos.append(str(d / f"p{i}.png"))
        Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(photos[-1])
    return MatrixEyes(ckpt, device="cpu"), photos, d


def _tree(spans):
    """{name: [parent's name, ...]} of one request's spans."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(by_id[s.parent].name if s.parent in by_id else None)
    return out


def test_process_to_a_png_records_its_spans_in_one_request(on, session):
    me, photos, d = session
    me.process(photos[0], str(d / "out.png"), focal_length_35mm=28.0)
    spans = timings.recorded()
    assert len({s.request for s in spans}) == 1
    programs = [(s.name, s.attrs["program"]) for s in spans if s.name.startswith("dispatch.")]
    assert sorted(programs) == [("dispatch.eager", "fwd_fnorm"), ("dispatch.eager", "preprocess"),
                                ("dispatch.eager", "render_depthmap_grid")]
    tree = _tree(spans)
    # the 640x480 PNG is larger than the grid: the grid image is upsized
    # on the host
    assert tree == {
        "api.process": [None], "api.depth_map": ["api.process"],
        "pipeline.decode": ["api.depth_map"], "pipeline.upload": ["api.depth_map"],
        "pipeline.forward": ["api.depth_map"], "output.write": ["api.process"],
        "output.wait": ["output.write"], "output.resize": ["output.write"],
        "output.encode": ["output.write"],
        # a stage of the CLI's table is a span too
        "output: render dispatch": ["output.write"],
        "dispatch.eager": ["api.depth_map", "pipeline.forward", "output: render dispatch"]}
    # a span lies inside its parent
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_inverse_depth_batch_records_its_spans_in_one_request(on, session):
    me, photos, _d = session
    me.inverse_depth_batch(photos, focal_length_35mm=[35.0, None])
    spans = timings.recorded()
    assert len({s.request for s in spans}) == 1
    tree = _tree(spans)
    assert tree.pop("dispatch.eager") == ["api.inverse_depth_batch"] * 2 + ["pipeline.forward"]
    assert tree == {
        "api.inverse_depth_batch": [None], "pipeline.decode": ["api.inverse_depth_batch"] * 2,
        "pipeline.upload": ["api.inverse_depth_batch"] * 2,
        "pipeline.forward": ["api.inverse_depth_batch"],
        "api.readback": ["api.inverse_depth_batch"]}
    assert [s.attrs["program"] for s in spans if s.name == "dispatch.eager"] == \
        ["preprocess", "preprocess", "fwd_mixed_b2"]
    # the table has none of these
    assert not set(tree) & set(timings.snapshot())


def test_a_session_records_nothing_when_off(off, session):
    me, photos, d = session
    me.process(photos[1], str(d / "off.png"), focal_length_35mm=28.0)
    me.inverse_depth_batch(photos[:1], focal_length_35mm=28.0)
    assert timings.recorded() == []
