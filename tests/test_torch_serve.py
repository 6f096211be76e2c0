"""The PyTorch port's HTTP server (``matrix_eyes_tpu_torch/serve.py``) on the
CPU: every test of tests/test_serve.py against the port's server on a
``torch_ref`` TINY checkpoint (``MatrixEyes(ckpt, device="cpu")``, a real
ThreadingHTTPServer on an ephemeral port, driven with urllib), the port's
server against the JAX package's on the same checkpoint and body, its
copies of the JAX server's helpers held to the originals, its command
line, and ``scripts/torch_serve_burst.py``.

Tolerances against the JAX server: ``/v1/depth`` as the f32 forward of
tests/test_torch_batch.py for a known focal length (rtol 2e-3, atol 1e-4),
PNG pixels within 2 counts on 99.9 % of pixels (test_cli_matches_jax_cli).
"""

import concurrent.futures
import io
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from matrix_eyes_tpu import serve as jserve
from matrix_eyes_tpu.api import MatrixEyes as JMatrixEyes
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu_torch import serve as tserve
from matrix_eyes_tpu_torch.api import MatrixEyes
from matrix_eyes_tpu_torch.config import NoCudaDevice
from matrix_eyes_tpu_torch.pipeline import preprocess_image
from matrix_eyes_tpu_torch.serve import _FileResponse, _MicroBatcher, create_server

import torch_ref


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}", t


def _stop(server, t):
    server.shutdown()
    server.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    path = str(d / "tiny.pt")
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=21).state_dict(), path)
    return path


@pytest.fixture(scope="module")
def jpeg():
    img = np.random.RandomState(7).randint(0, 256, size=(40, 56, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def served(ckpt, jpeg):
    me = MatrixEyes(ckpt, device="cpu")
    server = create_server(me, port=0)
    base, t = _start(server)
    yield base, jpeg, me
    _stop(server, t)


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


# --- mirrors of tests/test_serve.py -------------------------------------------------

def test_healthz(served):
    base, _, me = served
    with urllib.request.urlopen(base + "/healthz") as r:
        rec = json.loads(r.read())
    assert rec["status"] == "ok" and rec["model"] == "depth_pro"
    assert rec["img_size"] == me.cfg.img_size
    assert rec["dtype"] == "float32"
    assert rec["weight_policy"] == "plain"
    # the port's own measured reason, on the card it was measured on
    policy = rec["default_dtype_policy"]
    assert "mixed measured" in policy and "PERF.md §5" in policy
    assert "NVIDIA H100 80GB HBM3, 700 W" in policy


def test_index_and_unknown_get(served):
    base, _, _ = served
    with urllib.request.urlopen(base + "/") as r:
        assert r.headers.get("Content-Type").startswith("text/plain")
        assert b"/v1/process" in r.read()
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope")
    assert ei.value.code == 404 and "error" in json.loads(ei.value.read())


def test_process_depthmap_png(served):
    base, jpeg, _ = served
    code, ctype, body = _post(base + "/v1/process?focal-length=35", jpeg)
    assert code == 200 and ctype == "image/png"
    with Image.open(io.BytesIO(body)) as im:
        assert im.size == (56, 40)  # back at source resolution


def test_process_stereogram_resize(served):
    base, jpeg, _ = served
    code, ctype, body = _post(
        base + "/v1/process?format=stereogram&focal-length=35"
               "&resize-scale=2&stereo-amplitude=0.0625", jpeg)
    assert code == 200 and ctype == "image/png"
    with Image.open(io.BytesIO(body)) as im:
        assert im.size == (112, 80)


def test_process_obj_mesh(served):
    base, jpeg, _ = served
    code, ctype, body = _post(
        base + "/v1/process?format=obj&focal-length=35&vertex-mode=plain", jpeg)
    assert code == 200 and ctype.startswith("text/plain")
    assert body.startswith(b"o Depth\n") or b"\nv " in body or body.startswith(b"v ")


@pytest.mark.parametrize("fmt,ext", [("depthmap", ".png"), ("stereogram", ".png"),
                                     ("ply", ".ply")])
def test_process_bytes_match_the_library(served, tmp_path, fmt, ext):
    # the server is a transport: the same file as MatrixEyes.process
    base, jpeg, me = served
    code, _ctype, body = _post(base + f"/v1/process?format={fmt}&focal-length=35", jpeg)
    assert code == 200
    src = tmp_path / "photo.jpg"
    src.write_bytes(jpeg)
    out = tmp_path / ("out" + ext)
    me.process(str(src), str(out), focal_length_35mm=35.0,
               image_format="stereogram" if fmt == "stereogram" else "depthmap")
    assert body == out.read_bytes()


def test_depth_npy_matches_api(served, tmp_path):
    base, jpeg, me = served
    code, ctype, body = _post(base + "/v1/depth?focal-length=35", jpeg)
    assert code == 200 and ctype == "application/x-npy"
    served_inv = np.load(io.BytesIO(body))
    src = tmp_path / "photo.jpg"
    src.write_bytes(jpeg)
    direct = me.inverse_depth(str(src), focal_length_35mm=35.0)
    np.testing.assert_array_equal(served_inv, direct)


@pytest.mark.parametrize("path,code", [
    ("/v1/process?format=watercolor", 400),   # unknown format
    ("/v1/process?focal-length=nan", 400),    # non-finite number
    ("/v1/process?format=obj&vertex-mode=wireframe", 400),
    # range errors are client errors: a 400 up front, not a 500 from
    # inside the pipeline
    ("/v1/process?format=stereogram&resize-scale=0", 400),
    ("/v1/process?format=stereogram&stereo-amplitude=-1", 400),
    ("/v1/process?focal-length=0", 400),
    ("/v1/depth?focal-length=-3", 400),
    ("/v1/nope", 404),
])
def test_bad_requests(served, path, code):
    base, jpeg, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + path, jpeg)
    assert ei.value.code == code
    assert "error" in json.loads(ei.value.read())


def test_undecodable_body_is_400(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/process", b"this is not an image")
    assert ei.value.code == 400


def test_empty_body_is_400(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/process", b"")
    assert ei.value.code == 400


def test_oversized_body_is_400_and_closes(served, monkeypatch):
    base, jpeg, _ = served
    monkeypatch.setattr(tserve, "_MAX_BODY", len(jpeg) - 1)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/depth", jpeg)
    assert ei.value.code == 400 and ei.value.headers.get("Connection") == "close"
    assert "too large" in json.loads(ei.value.read())["error"]


def test_bad_vertex_mode_on_image_format_is_400(served):
    base, jpeg, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/process?format=stereogram&vertex-mode=bogus", jpeg)
    assert ei.value.code == 400


def test_runtime_error_returns_500_json(served):
    # a raw failure inside the model path: a 500 JSON error, not a dropped
    # connection
    base, jpeg, me = served
    orig = me.depth_map
    me.depth_map = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("device fell over"))
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/depth", jpeg)
        assert ei.value.code == 500
        assert "device fell over" in json.loads(ei.value.read())["error"]
    finally:
        me.depth_map = orig


def test_texture_mode_served_as_zip(served, tmp_path):
    import zipfile

    base, jpeg, me = served
    code, ctype, body = _post(
        base + "/v1/process?format=obj&focal-length=35&vertex-mode=texture-coordinates",
        jpeg)
    assert code == 200 and ctype == "application/zip"
    zf = zipfile.ZipFile(io.BytesIO(body))
    assert set(zf.namelist()) == {"out.obj", "out.mtl", "texture.jpg"}
    assert "map_Kd texture.jpg" in zf.read("out.mtl").decode()
    obj = zf.read("out.obj").decode()
    assert "mtllib out.mtl" in obj and "usemtl Textured" in obj
    assert zf.read("texture.jpg") == jpeg
    src = tmp_path / "photo.jpg"
    src.write_bytes(jpeg)
    me.process(str(src), str(tmp_path / "out.obj"), focal_length_35mm=35.0,
               vertex_mode="texture-coordinates")
    assert zf.read("out.obj") == (tmp_path / "out.obj").read_bytes()


def _wait_gone(path):
    for _ in range(100):
        if not os.path.exists(path):
            return True
        time.sleep(0.05)
    return False


def test_process_responses_stream_from_disk_spool(served, monkeypatch):
    base, jpeg, _ = served
    seen = {}
    orig = _FileResponse.stream_to

    def spy(self, wfile):
        seen["size"], seen["dir"] = self.size, self.cleanup_dir
        return orig(self, wfile)

    monkeypatch.setattr(_FileResponse, "stream_to", spy)
    code, ctype, body = _post(
        base + "/v1/process?format=obj&focal-length=35&vertex-mode=texture-coordinates",
        jpeg)
    assert code == 200 and ctype == "application/zip"
    assert seen["size"] == len(body) and seen["dir"] is not None
    # removed just after the last chunk; the client may see the body first
    assert _wait_gone(seen["dir"])


def test_aborted_download_no_traceback_no_spool(served, monkeypatch, capfd):
    """A client that drops the connection during the reply: the spool
    directory goes, one log line and no traceback (the JAX server's
    ADVICE r5 fault is not copied), and the server goes on serving."""
    base, jpeg, _ = served
    state = {"dirs": []}
    orig = _FileResponse.stream_to

    def broken_once(self, wfile):
        if not state["dirs"]:
            state["dirs"].append(self.cleanup_dir)
            raise BrokenPipeError("client went away")
        return orig(self, wfile)

    monkeypatch.setattr(_FileResponse, "stream_to", broken_once)
    capfd.readouterr()
    with pytest.raises(Exception):
        _post(base + "/v1/process?focal-length=35", jpeg)
    assert state["dirs"] and state["dirs"][0] is not None
    assert _wait_gone(state["dirs"][0])
    code, ctype, _body = _post(base + "/v1/process?focal-length=35", jpeg)
    assert code == 200 and ctype == "image/png"
    out, err = capfd.readouterr()
    assert "Traceback" not in err and "Traceback" not in out
    assert "client closed the connection during the reply (BrokenPipeError)" in out


def test_file_response_transfer_memory_is_chunk_bounded(tmp_path):
    import tracemalloc

    big = tmp_path / "big.bin"
    with open(big, "wb") as f:
        f.seek(64 * 1024 * 1024 - 1)
        f.write(b"\0")

    class Sink:
        def write(self, b):
            return len(b)

    resp = _FileResponse(str(big))
    assert resp.size == 64 * 1024 * 1024
    tracemalloc.start()
    resp.stream_to(Sink())
    _cur, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 8 * 1024 * 1024, peak


def test_texture_mode_transcodes_exotic_encodings(served):
    import zipfile

    base, jpeg, _ = served
    gif = io.BytesIO()
    with Image.open(io.BytesIO(jpeg)) as im:
        im.save(gif, format="GIF")
    code, ctype, body = _post(
        base + "/v1/process?format=obj&focal-length=35&vertex-mode=texture-coordinates",
        gif.getvalue())
    assert code == 200 and ctype == "application/zip"
    zf = zipfile.ZipFile(io.BytesIO(body))
    assert set(zf.namelist()) == {"out.obj", "out.mtl", "texture.png"}
    assert "map_Kd texture.png" in zf.read("out.mtl").decode()
    with Image.open(io.BytesIO(zf.read("texture.png"))) as tex:
        assert tex.format == "PNG"


def test_ply_texture_mode_stays_single_response(served):
    base, jpeg, _ = served
    code, ctype, body = _post(
        base + "/v1/process?format=ply&focal-length=35&vertex-mode=texture-coordinates",
        jpeg)
    assert code == 200 and ctype == "application/octet-stream"
    assert body.startswith(b"ply\n")


def test_overload_returns_503(served):
    base, jpeg, me = served
    release, started = threading.Event(), threading.Event()
    orig = me.depth_map

    def slow(*a, **k):
        started.set()
        release.wait(10)
        return orig(*a, **k)

    me.depth_map = slow
    server = create_server(me, port=0, max_inflight=1)
    b2, t = _start(server)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_post, b2 + "/v1/depth?focal-length=35", jpeg)
            assert started.wait(10), "the first request never reached the model"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(b2 + "/v1/depth?focal-length=35", jpeg)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After")
            assert ei.value.headers.get("Connection") == "close"
            release.set()
            code, _, _ = fut.result(timeout=30)
            assert code == 200
    finally:
        release.set()
        me.depth_map = orig
        _stop(server, t)


def test_concurrent_requests_both_succeed(served):
    base, jpeg, _ = served

    def one(_i):
        return _post(base + "/v1/process?format=stereogram&focal-length=35", jpeg)

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(one, range(4)))
    assert all(c == 200 and t == "image/png" for c, t, _ in results)
    # one session seed, one input: one set of bytes
    assert len({b for _, _, b in results}) == 1


# --- micro-batching (--max-batch) ---------------------------------------------------

class _StubDM:
    """DepthMap stand-in with an identity tag; its data is a CPU tensor."""

    def __init__(self, tag):
        self.tag = tag
        self.data = torch.zeros(1)


class _StubSession:
    """Records batch compositions; optionally blocks in the first call so
    that followers queue behind the leader."""

    def __init__(self, first_call_gate=None):
        self.calls = []
        self.first_call_gate = first_call_gate

    def depth_maps(self, sources, pad_to_pow2=False):
        self.calls.append(list(sources))
        if self.first_call_gate is not None and len(self.calls) == 1:
            self.first_call_gate.wait(timeout=10)
        return [_StubDM(s) for s in sources]


def _wait_until(cond, tries=50, step=0.02):
    while not cond() and tries:
        time.sleep(step)
        tries -= 1


def test_microbatcher_coalesces_queued_requests():
    """While the leader holds the device section, followers queue; the next
    leader drains them into one batched call, and each job gets its own
    result. ``ready`` runs for every job of a batch before its forward."""
    gate = threading.Event()
    session = _StubSession(first_call_gate=gate)
    mb = _MicroBatcher(session, threading.Lock(), max_batch=4)
    results, readied = {}, []

    def request(src):
        results[src] = mb.depth_map(src, lambda: readied.append((src, len(session.calls))))

    t0 = threading.Thread(target=request, args=("s0",))
    t0.start()
    _wait_until(lambda: session.calls or not t0.is_alive(), tries=500, step=0.01)
    followers = [threading.Thread(target=request, args=(f"s{i}",)) for i in range(1, 4)]
    for t in followers:
        t.start()
    _wait_until(lambda: len(mb._q) >= 3)
    gate.set()
    for t in [t0] + followers:
        t.join(timeout=10)
        assert not t.is_alive()
    assert sorted(results) == ["s0", "s1", "s2", "s3"]
    for src, dm in results.items():
        assert dm.tag == src, f"{src} got {dm.tag}'s result"
    assert [len(c) for c in session.calls] == [1, 3]
    # each job made ready before the forward that took it
    assert sorted(readied) == [("s0", 0), ("s1", 1), ("s2", 1), ("s3", 1)]


def test_microbatcher_leader_batch_always_contains_own_job():
    gate = threading.Event()
    session = _StubSession(first_call_gate=gate)
    mb = _MicroBatcher(session, threading.Lock(), max_batch=2)
    results = {}

    def request(src):
        results[src] = mb.depth_map(src)

    threads = [threading.Thread(target=request, args=(f"q{i}",)) for i in range(6)]
    threads[0].start()
    _wait_until(lambda: session.calls or not threads[0].is_alive(), tries=500, step=0.01)
    for t in threads[1:]:
        t.start()
    _wait_until(lambda: len(mb._q) >= 5)
    gate.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(results) == 6
    for src, dm in results.items():
        assert dm.tag == src
    assert all(len(c) <= 2 for c in session.calls)


def test_microbatcher_error_propagates_to_all_taken_jobs():
    class _Boom:
        def depth_maps(self, sources, pad_to_pow2=False):
            raise RuntimeError("device fell over")

    mb = _MicroBatcher(_Boom(), threading.Lock(), max_batch=4)
    with pytest.raises(RuntimeError, match="device fell over"):
        mb.depth_map("x")
    assert mb._q == []  # no stranded jobs


@pytest.fixture(scope="module")
def served_batched(ckpt, jpeg):
    me = MatrixEyes(ckpt, device="cpu")
    server = create_server(me, port=0, max_batch=4)
    base, t = _start(server)
    yield base, jpeg, me
    _stop(server, t)


def test_batched_serve_concurrent_depth_requests_correct(served_batched):
    """8 concurrent /v1/depth requests against a --max-batch=4 server: all
    succeed, each equals the session's answer for its own photo."""
    base, _jpeg, me = served_batched
    rng = np.random.RandomState(3)
    bodies, want = [], []
    for _ in range(4):
        arr = rng.randint(0, 256, size=(40, 56, 3), dtype=np.uint8)
        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="PNG")  # lossless: exact pixels
        bodies.append(b.getvalue())
        want.append(me.inverse_depth(arr, focal_length_35mm=35.0))
    results = [None] * 8

    def go(i):
        code, _ct, body = _post(base + "/v1/depth?focal-length=35", bodies[i % 4])
        results[i] = (code, np.load(io.BytesIO(body)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i, r in enumerate(results):
        assert r is not None, f"request {i} never completed"
        code, got = r
        assert code == 200
        np.testing.assert_allclose(got, want[i % 4], rtol=2e-4, atol=2e-5)


def test_batched_serve_process_png_matches_unbatched(served_batched, served):
    base_mb, jpeg, _ = served_batched
    base, jpeg2, _me = served
    assert jpeg == jpeg2
    _c1, _t1, png_mb = _post(base_mb + "/v1/process?focal-length=35", jpeg)
    _c2, _t2, png = _post(base + "/v1/process?focal-length=35", jpeg)
    a = np.asarray(Image.open(io.BytesIO(png_mb))).astype(np.int16)
    b = np.asarray(Image.open(io.BytesIO(png))).astype(np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1


def test_uploaded_pixels_preprocess_as_numpy():
    # the server hands the forward the photo as a tensor (_upload on the
    # card); preprocess_image gives what it gives for the numpy photo
    rgb = np.random.RandomState(4).randint(0, 256, (40, 56, 3), dtype=np.uint8)
    want = preprocess_image(rgb, 128, torch.float32, "cpu")
    got = preprocess_image(torch.from_numpy(rgb), 128, torch.float32, "cpu")
    assert torch.equal(got, want)
    src = object()
    assert tserve._upload(src, torch.device("cpu")) == (src, None)


def test_batched_requests_are_traced_each_in_its_own_request(ckpt, jpeg, monkeypatch,
                                                             capsys):
    # two /v1/depth requests queue behind the held device lock, then one
    # leader serves both in one batch: each request is a request of the
    # recorder, the batch span names both, and under MATRIX_EYES_TIMINGS
    # each log line carries its request's span milliseconds
    from matrix_eyes_tpu_torch import timings

    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    timings.clear()
    server = create_server(MatrixEyes(ckpt, device="cpu"), port=0, max_batch=2)
    handler = server.RequestHandlerClass
    base, t = _start(server)
    results = []
    try:
        handler.lock.acquire()
        threads = [threading.Thread(target=lambda: results.append(
            _post(base + "/v1/depth?focal-length=35", jpeg)[0])) for _ in range(2)]
        for th in threads:
            th.start()
        _wait_until(lambda: len(handler.batcher._q) >= 2, tries=500)
        assert len(handler.batcher._q) == 2
        handler.lock.release()
        for th in threads:
            th.join(timeout=60)
    finally:
        _stop(server, t)
        spans = timings.recorded()
        timings.clear()  # the table too: the session's load is in it
    assert results == [200, 200]
    roots = [s for s in spans if s.name == "serve.request"]
    assert len(roots) == 2 and all(s.parent is None for s in roots)
    ids = sorted(s.request for s in roots)
    assert ids[0] != ids[1]
    (batch,) = [s for s in spans if s.name == "serve.batch"]
    assert sorted(batch.attrs["requests"]) == ids
    for rid in ids:
        mine = {s.name for s in spans if s.request == rid}
        assert {"serve.body", "pipeline.decode", "serve.upload", "serve.queue",
                "serve.reply"} <= mine
    # the leader's request holds the forward
    assert {s.request for s in spans if s.name in ("api.depth_map", "pipeline.forward")} <= \
        {batch.request}
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "POST /v1/depth" in ln]
    assert len(lines) == 2
    for ln in lines:
        assert "[request " in ln and "serve.body " in ln and " ms" in ln and "serve.queue" in ln


# --- against the JAX server -----------------------------------------------------------

@pytest.fixture(scope="module")
def both_servers(ckpt):
    servers = []
    for session in (JMatrixEyes(ckpt), MatrixEyes(ckpt, device="cpu")):
        make = jserve.create_server if isinstance(session, JMatrixEyes) else create_server
        server = make(session, port=0)
        servers.append((server,) + _start(server))
    yield servers[0][1], servers[1][1]
    for server, _base, t in servers:
        _stop(server, t)


@pytest.fixture(scope="module")
def photo_jpeg():
    yy, xx = np.mgrid[0:480, 0:640]
    rgb = np.stack([xx * 255 // 639, yy * 255 // 479, (xx + yy) * 255 // 1118], -1)
    rgb = (rgb + np.random.RandomState(2).randint(-20, 21, rgb.shape)).clip(0, 255)
    buf = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def test_depth_matches_jax_server(both_servers, photo_jpeg):
    jbase, tbase = both_servers
    results = [_post(base + "/v1/depth?focal-length=28", photo_jpeg) for base in (jbase, tbase)]
    (jc, jct, jb), (tc, tct, tb) = results
    assert jc == tc == 200 and jct == tct == "application/x-npy"
    j, t = np.load(io.BytesIO(jb)), np.load(io.BytesIO(tb))
    assert j.shape == t.shape and t.dtype == j.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("fmt", ["depthmap", "stereogram"])
def test_process_png_matches_jax_server(both_servers, photo_jpeg, fmt):
    jbase, tbase = both_servers
    query = f"/v1/process?format={fmt}&focal-length=28"
    (jc, jct, jb), (tc, tct, tb) = (_post(b + query, photo_jpeg) for b in (jbase, tbase))
    assert jc == tc == 200 and jct == tct == "image/png"
    a = np.asarray(Image.open(io.BytesIO(tb)).convert("RGB")).astype(int)
    b = np.asarray(Image.open(io.BytesIO(jb)).convert("RGB")).astype(int)
    assert a.shape == b.shape == (480, 640, 3)
    if fmt == "depthmap":
        assert len(np.unique(b.reshape(-1, 3), axis=0)) > 1000
        assert (np.abs(a - b) <= 2).all(axis=-1).mean() >= 0.999
    # the stereogram's noise differs by design (a torch generator, not
    # jax.random): the same size and content type only


@pytest.mark.parametrize("path,code", [("/v1/process?format=watercolor", 400),
                                       ("/v1/depth?focal-length=-3", 400),
                                       ("/v1/process?format=obj&vertex-mode=x", 400),
                                       ("/v1/nope", 404)])
def test_errors_match_jax_server(both_servers, jpeg, path, code):
    replies = []
    for base in both_servers:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + path, jpeg)
        replies.append((ei.value.code, ei.value.headers.get("Content-Type"),
                        json.loads(ei.value.read())))
    assert replies[0] == replies[1] and replies[0][0] == code


@pytest.mark.parametrize("query,ctype", [
    ("format=obj&vertex-mode=plain", "text/plain; charset=utf-8"),
    ("format=obj&vertex-mode=texture-coordinates", "application/zip"),
    ("format=ply&vertex-mode=vertex-colors", "application/octet-stream")])
def test_content_types_match_jax_server(both_servers, jpeg, query, ctype):
    got = [_post(base + f"/v1/process?{query}&focal-length=35", jpeg)[:2]
           for base in both_servers]
    assert got == [(200, ctype)] * 2


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8", "mixed"])
def test_healthz_matches_jax_server(ckpt, policy):
    recs = []
    for session, make in ((JMatrixEyes(ckpt, dtype=policy), jserve.create_server),
                          (MatrixEyes(ckpt, dtype=policy, device="cpu"), create_server)):
        server = make(session, port=0)
        base, t = _start(server)
        try:
            with urllib.request.urlopen(base + "/healthz") as r:
                recs.append(json.loads(r.read()))
        finally:
            _stop(server, t)
    keys = ("status", "model", "img_size", "dtype", "weight_policy")
    assert {k: recs[1][k] for k in keys} == {k: recs[0][k] for k in keys}
    assert set(recs[1]) == set(recs[0])


# --- the copies of the JAX server's helpers ---------------------------------------------

@pytest.mark.parametrize("name,value,positive", [
    ("focal-length", None, False), ("focal-length", ["35"], True), ("x", ["1", "-2.5"], False),
    ("x", ["-2.5"], True), ("x", ["0"], True), ("x", ["nan"], False), ("x", ["inf"], False),
    ("x", ["-inf"], True), ("x", ["abc"], False), ("x", ["1e3"], True)])
def test_one_float_matches_jax(name, value, positive):
    q = {} if value is None else {name: value}
    outcomes = []
    for fn, bad in ((jserve._one_float, jserve.BadRequest), (tserve._one_float,
                                                            tserve.BadRequest)):
        try:
            outcomes.append(("ok", fn(q, name, positive=positive)))
        except bad as e:
            outcomes.append(("400", str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "BMP", "TIFF", "WEBP", "GIF", "PPM", None])
def test_sniff_image_ext_matches_jax(tmp_path, fmt):
    path = tmp_path / "body.bin"
    if fmt is None:
        path.write_bytes(b"not an image")
    else:
        rgb = np.random.RandomState(1).randint(0, 256, (9, 7, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(path, format=fmt)
    assert tserve._sniff_image_ext(str(path)) == jserve._sniff_image_ext(str(path))


def test_zip_files_and_file_response_match_jax(tmp_path):
    import zipfile

    rng = np.random.RandomState(6)
    (tmp_path / "a.obj").write_bytes(rng.bytes(3000))
    (tmp_path / "b.mtl").write_text("map_Kd texture.jpg\n" * 50)
    names = ["a.obj", "b.mtl"]
    tserve._zip_files(str(tmp_path), names, str(tmp_path / "t.zip"))
    jserve._zip_files(str(tmp_path), names, str(tmp_path / "j.zip"))
    zt, zj = zipfile.ZipFile(tmp_path / "t.zip"), zipfile.ZipFile(tmp_path / "j.zip")
    assert zt.namelist() == zj.namelist() == names
    assert [(i.compress_type, i.file_size, i.CRC) for i in zt.infolist()] == [
        (i.compress_type, i.file_size, i.CRC) for i in zj.infolist()]
    sinks = []
    for mod in (tserve, jserve):
        d = tmp_path / f"spool_{mod.__name__}"
        d.mkdir()
        (d / "out.bin").write_bytes(rng.bytes(3 * mod._FileResponse.CHUNK + 17))
        resp = mod._FileResponse(str(d / "out.bin"), cleanup_dir=str(d))
        sink = io.BytesIO()
        resp.stream_to(sink)
        resp.cleanup()  # idempotent
        assert not d.exists() and resp.size == len(sink.getvalue())
        sinks.append(len(sink.getvalue()))
    assert tserve._FileResponse.CHUNK == jserve._FileResponse.CHUNK
    assert sinks[0] == sinks[1]


# --- no fallback, and the command line ------------------------------------------------

def test_without_a_card_nothing_serves(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        create_server(MatrixEyes(ckpt), port=0)
    with pytest.raises(NoCudaDevice):
        tserve.main([f"--checkpoint-path={ckpt}", "--port=0"])


def test_main_refuses_no_flash_attention(ckpt, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main([f"--checkpoint-path={ckpt}", "--no-flash-attention"], device="cpu")
    assert e.value.code == 2
    assert "not supported by the PyTorch port" in capsys.readouterr().err


def test_main_rejects_unknown_dtype(ckpt, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main([f"--checkpoint-path={ckpt}", "--dtype=int4"], device="cpu")
    assert e.value.code == 2 and "--dtype" in capsys.readouterr().err


def test_main_serves_with_its_flags(ckpt, tmp_path, monkeypatch, capsys):
    # main's flags reach the session, the loader and the server; the loop
    # is cut at once, as Ctrl-C cuts it
    seen = {}
    real = tserve.create_server

    def spy(session, host, port, max_inflight, max_batch):
        server = real(session, host, port, max_inflight=max_inflight, max_batch=max_batch)
        seen.update(session=session, server=server, max_inflight=max_inflight,
                    max_batch=max_batch)
        monkeypatch.setattr(server, "serve_forever",
                            lambda: (_ for _ in ()).throw(KeyboardInterrupt()))
        return server

    monkeypatch.setattr(tserve, "create_server", spy)
    path = str(tmp_path / "m.pt")
    shutil.copy(ckpt, path)
    assert tserve.main([f"--checkpoint-path={path}", "--port=0", "--dtype=bf16", "--seed=5",
                        "--max-batch=2", "--max-inflight=3", "--convert-checkpoints"],
                       device="cpu") == 0
    rt = seen["session"].runtime
    assert (rt.resolved_dtype(), rt.seed) == (torch.bfloat16, 5)
    assert (seen["max_batch"], seen["max_inflight"]) == (2, 3)
    assert seen["server"].RequestHandlerClass.batcher.max_batch == 2
    assert "serving depth_pro on http://127.0.0.1:" in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "m-torch-config.json"))  # --convert-checkpoints


# --- scripts/torch_serve_burst.py -------------------------------------------------------

def test_burst_script_smoke(ckpt, tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import torch_serve_burst

    rng = np.random.RandomState(11)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(buf, format="JPEG")
    photo = tmp_path / "p.jpg"
    photo.write_bytes(buf.getvalue())
    out = tmp_path / "burst.json"
    report = torch_serve_burst.main([
        "--checkpoint", ckpt, "--photo", str(photo), "--max-batch", "2", "--requests", "4",
        "--concurrency", "2", "--compare-output-streams", "--rounds", "2", "--out", str(out)],
        device="cpu")
    assert report["device"] == {"type": "cpu"} and report["dtype"] == "float32"
    for runs in (report, report["own_output_stream"]):
        for mode in ("batched", "serialized"):
            r = runs[mode]
            assert r["requests_per_s"] > 0 and r["requests"] == 4
            assert 0 < r["latency_s"]["p50"] <= r["latency_s"]["p95"] <= r["latency_s"]["max"]
            assert len(r["idle_latency_s"]["runs"]) == 3
        assert sum(runs["batched"]["batch_sizes"]) == 4
        assert runs["coalescing_speedup"] > 0
    # two rounds in turns: default, own, own, default
    assert [r["batched"]["output_stream"] for r in report["runs"]] == [
        "default", "own", "own", "default"]
    assert report["runs"][0]["batched"] is report["batched"]
    with open(out) as f:
        assert json.load(f)["metric"] == "serve_burst_http"


def test_burst_script_compares_graphs_with_eager(ckpt, tmp_path):
    # --compare-aot: the same burst with every program eager
    # (MATRIX_EYES_AOT=off), the two settings in turns; on the CPU both run
    # eagerly, so this holds the bookkeeping
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import torch_serve_burst

    photo = tmp_path / "p.jpg"
    Image.fromarray(np.random.RandomState(12).randint(0, 256, (40, 56, 3), np.uint8)).save(
        photo, format="JPEG")
    report = torch_serve_burst.main([
        "--checkpoint", ckpt, "--photo", str(photo), "--max-batch", "2", "--requests", "2",
        "--concurrency", "2", "--compare-aot", "--rounds", "2"], device="cpu")
    assert [r["batched"]["programs"] for r in report["runs"]] == [
        "cuda_graphs", "eager", "eager", "cuda_graphs"]
    assert report["eager"] is report["runs"][1] and "own_output_stream" not in report
    assert report["eager"]["serialized"]["requests_per_s"] > 0
    assert os.environ.get("MATRIX_EYES_AOT") is None
    with pytest.raises(SystemExit):
        torch_serve_burst.main(["--photo", str(photo), "--compare-aot",
                                "--compare-output-streams"], device="cpu")
