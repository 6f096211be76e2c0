"""HTTP serving front end: a MatrixEyes session behind a small server (port
of ``matrix_eyes_tpu/serve.py``).

The CLI loads the checkpoint for every photo; a server loads it once and
answers many requests. This module puts an ``api.MatrixEyes`` session on
the card behind the standard library's HTTP server:

    python -m matrix_eyes_tpu_torch.serve --checkpoint-path=./checkpoints/depth_pro.pt --port=8000

    curl -X POST --data-binary @photo.jpg \\
        'localhost:8000/v1/process?format=stereogram' > out.png
    curl -X POST --data-binary @photo.jpg 'localhost:8000/v1/depth' > inv.npy
    curl localhost:8000/healthz

Routes
------
* ``GET /healthz`` -- liveness and the session's configuration (the model
  is loaded before the socket opens, so 200 means ready).
* ``POST /v1/process?format=depthmap|stereogram|obj|ply`` -- the body is
  the encoded photo (anything PIL reads; the EXIF focal length and
  orientation count as in the CLI). Returns the PNG (``image/png``) or the
  mesh (OBJ ``text/plain``, PLY ``application/octet-stream``). Optional
  query parameters mirror the CLI's flags: ``focal-length``,
  ``resize-scale``, ``stereo-amplitude``, ``vertex-mode`` (meshes:
  plain|vertex-colors|texture-coordinates; the last returns an OBJ as
  ``application/zip`` of the .obj, its .mtl and the texture the .mtl
  names, the CLI's layout on disk).
* ``POST /v1/depth`` -- the clamped inverse depth at the model's grid as
  ``.npy`` (``application/x-npy``), ``MatrixEyes.inverse_depth`` of the
  body.

The card runs one forward at a time: a lock holds the device section,
from the forward's launches until the card has finished them (a CUDA
event), so that requests queueing meanwhile can be coalesced. A request's
photo is decoded, and its copy to the card started (pinned memory, a side
stream, an event the forward waits on), before the lock; its render,
copies back and encoding run after it, on the default stream (a stream of
their own did not cut the latency under a burst, which the host bounds:
``scripts/torch_serve_burst.py --compare-output-streams``). ``--max-batch=N``
coalesces concurrent requests into one batched forward (_MicroBatcher);
a request that finds the card idle still runs alone. ``--max-inflight``
bounds the POSTs in flight: excess requests get 503 and Retry-After at
once. ``/v1/process`` replies are spooled on disk and streamed in chunks
(_FileResponse), so a request holds O(1 MiB) of memory whatever the
output's size. Errors are JSON: 400 for bad input (undecodable photo,
unknown format, numbers out of range), 500 for reconstruction failures,
with the CLI's stage messages. ``scripts/torch_serve_burst.py`` measures
burst throughput and latency through real HTTP.

Each HTTP request is one request of the port's span recorder
(``timings.trace``; recorded under ``MATRIX_EYES_TIMINGS`` or a running
``torch.profiler``): the root ``serve.request``, and ``serve.body`` (the
body read), ``serve.upload`` (the copy to the card started),
``serve.queue`` (waiting for the device section), ``serve.batch`` (a
leader's batched forward), ``serve.reply`` (the result's reply) beside the
session's own spans (``pipeline.decode``, ``api.depth_map``, ``output.*``,
``dispatch.*``).
Under ``MATRIX_EYES_TIMINGS`` each request's log line ends with its spans'
milliseconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import torch

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.errors import MatrixEyesError, ReconstructionError
from matrix_eyes_tpu_torch.io.image import load_source_image

# format -> (destination extension, response content type)
_FORMATS = {
    "depthmap": (".png", "image/png"),
    "stereogram": (".png", "image/png"),
    "obj": (".obj", "text/plain; charset=utf-8"),
    "ply": (".ply", "application/octet-stream"),
}
_MAX_BODY = 128 * 1024 * 1024  # a 12 MP photo is ~36 MB raw; JPEG far less

# the measured reason bf16 is the card's default and mixed is opt-in
DEFAULT_DTYPE_POLICY = (
    "bf16: mixed measured 1.84x bf16's device time per forward (144.7-145.0 ms against "
    "78.7-78.8 ms; NVIDIA H100 80GB HBM3, 700 W; PERF.md §5); its accuracy (7.6e-4 of the "
    "f32 run's inverse depth against bf16's 1.5e-2) is one --dtype=mixed away")


class BadRequest(ValueError):
    """Client-side error -> HTTP 400."""


class _OversizedBody(BadRequest):
    """The body was never read; the connection must be torn down after the
    reply (a keep-alive peer still streaming its upload could otherwise
    deadlock against the unread socket buffer)."""


def _one_float(q: dict, name: str, positive: bool = False) -> Optional[float]:
    vals = q.get(name)
    if not vals:
        return None
    try:
        v = float(vals[-1])
    except ValueError:
        raise BadRequest(f"{name} must be a number, got {vals[-1]!r}")
    if not (v == v) or v in (float("inf"), float("-inf")):
        raise BadRequest(f"{name} must be finite")
    if positive and v <= 0:
        # a range error is the client's fault: a 400 here, not a 500 from
        # deep in the pipeline (zero-size stereogram, negative focal)
        raise BadRequest(f"{name} must be > 0, got {v}")
    return v


def _sniff_image_ext(path: str) -> Optional[str]:
    """The extension of the body's actual encoding (PIL reads the header
    only); OBJ viewers resolve map_Kd textures by extension. None for
    encodings viewers rarely load (GIF, PPM, ...): the caller transcodes
    those to PNG."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            fmt = (im.format or "").lower()
    except Exception:
        fmt = ""
    return {"jpeg": ".jpg", "png": ".png", "bmp": ".bmp",
            "tiff": ".tif", "webp": ".webp"}.get(fmt)


def _zip_files(directory: str, names, out_path: str) -> None:
    """Zip ``names`` (paths relative to ``directory``) into ``out_path`` at
    deflate level 1 (a 12 MP mesh's OBJ is hundreds of MB of ASCII; level 1
    compresses it several-fold fast, higher levels only add latency),
    spooled to disk for _FileResponse."""
    import zipfile

    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name in names:
            zf.write(os.path.join(directory, name), arcname=name)


class _FileResponse:
    """A response spooled on disk and streamed to the socket in fixed-size
    chunks, so a request's memory stays O(CHUNK) whatever the output's size
    (a 12 MP texture-coordinates mesh is a ~378 MB OBJ).

    Owns its temporary directory: ``cleanup()`` runs after the stream (or
    on a failed send), so the file lives exactly as long as the transfer."""

    CHUNK = 1 << 20

    def __init__(self, path: str, cleanup_dir: Optional[str] = None):
        self.path = path
        self.cleanup_dir = cleanup_dir
        self.size = os.path.getsize(path)

    def stream_to(self, wfile) -> None:
        import shutil

        try:
            with open(self.path, "rb") as f:
                shutil.copyfileobj(f, wfile, self.CHUNK)
        finally:
            self.cleanup()

    def cleanup(self) -> None:
        import shutil

        if self.cleanup_dir is not None:
            shutil.rmtree(self.cleanup_dir, ignore_errors=True)
            self.cleanup_dir = None


def _upload(source, device: torch.device):
    """Start the copy of ``source``'s pixels to ``device`` now, outside the
    device section: into pinned memory, then a non-blocking copy on a side
    stream, which records an event. Returns (the source with its pixels on
    the device, ``ready``): ``ready()``, called in the device section, makes
    the forward's stream wait for the copy and tells the caching allocator
    that this stream uses the pixels, so the ``preprocess`` program's copy
    of them into its CUDA graph's input (``aot.call_cached``) follows the
    upload. On the CPU: (source, None)."""
    if device.type != "cuda":
        return source, None
    host = torch.empty(source.rgb.shape, dtype=torch.uint8, pin_memory=True)
    host.numpy()[...] = source.rgb
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        rgb = host.to(device, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(stream)

    def ready() -> None:
        forward_stream = torch.cuda.current_stream(device)
        forward_stream.wait_event(copied)
        rgb.record_stream(forward_stream)

    return dataclasses.replace(source, rgb=rgb), ready


def _wait_for_device(dms) -> None:
    """End of the device section: wait until the card has finished the
    forward that made ``dms``, not only until its launches are enqueued, so
    that the lock covers the forward and requests that queue meanwhile can
    be coalesced."""
    data = [dm.data for dm in dms if isinstance(dm.data, torch.Tensor) and dm.data.is_cuda]
    if data:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(data[0].device))
        done.synchronize()


class _MicroBatcher:
    """Coalesce concurrent request forwards into one batched forward.

    Leader-follower over the device lock: every request enqueues its
    decoded source, then contends for the lock. Whoever holds it drains up
    to ``max_batch`` pending jobs (its own included) and runs one batched
    forward (``api.MatrixEyes.depth_maps``, padded to the next power of
    two, as the JAX server does); followers whose job was taken wait for
    their result. Under burst load N forwards become ceil(N / max_batch).
    A request that arrives while the card is idle still runs alone.

    Spans: ``serve.queue`` from a job's enqueue until its own thread takes
    it as leader, or until a leader has set its result; ``serve.batch``
    around the leader's batched forward, the request ids it served in its
    ``requests`` attribute.
    """

    def __init__(self, session, lock: threading.Lock, max_batch: int):
        self.session = session
        self.lock = lock
        self.max_batch = max_batch
        self._q: list = []
        self._q_lock = threading.Lock()

    def depth_map(self, source, ready=None):
        """``ready``: _upload's callable, run in the device section before
        the forward that takes this job."""
        job = {"src": source, "ready": ready, "ev": threading.Event(),
               "dm": None, "err": None, "request": timings.current_request()}
        with timings.trace("serve.queue"):
            with self._q_lock:
                self._q.append(job)
            take = self._lead(job)
            if not take:
                job["ev"].wait()
        if take:
            try:
                self._run(take)
            finally:
                self.lock.release()
        if job["err"] is not None:
            # every job of a failed batch shares one exception; raising it
            # from several threads would garble its traceback, so each
            # raises a clone of the same type (the same status code)
            err = job["err"]
            try:
                clone = type(err)(*err.args)
            except Exception:
                clone = RuntimeError(f"{type(err).__name__}: {err}")
            raise clone from err
        return job["dm"]

    def _lead(self, job) -> list:
        """The batch this thread leads, with the device lock held: ``job``
        and up to ``max_batch`` - 1 queued peers. [] (the lock not held)
        when a leader has taken ``job``: its event is set, or will be when
        that leader's batch ends."""
        if job["ev"].is_set():
            return []
        self.lock.acquire()
        # a previous leader may have taken our job while we waited for the
        # lock (it sets our event); otherwise we lead, and the batch must
        # contain our own job: draining only the queue's head could serve
        # four peers and strand us
        with self._q_lock:
            # identity, not ``in``: a SourceImage's == compares pixels
            mine = next((i for i, j in enumerate(self._q) if j is job), None)
            if mine is None:
                take = []
            else:
                self._q.pop(mine)
                peers = self._q[:self.max_batch - 1]
                del self._q[:len(peers)]
                take = [job] + peers
        if not take:
            self.lock.release()
        return take

    def _run(self, take: list) -> None:
        """The batched forward of the jobs ``take``; every job gets its
        result or the batch's error, and its event."""
        with timings.trace("serve.batch", {"requests": [j["request"] for j in take]}):
            try:
                for j in take:
                    if j["ready"] is not None:
                        j["ready"]()
                dms = self.session.depth_maps([j["src"] for j in take], pad_to_pow2=True)
                _wait_for_device(dms)
                for j, dm in zip(take, dms):
                    j["dm"] = dm
            except Exception as err:
                for j in take:
                    j["err"] = err
            finally:
                for j in take:
                    j["ev"].set()


class _Handler(BaseHTTPRequestHandler):
    # set by create_server
    session = None
    lock: threading.Lock = None
    inflight: threading.BoundedSemaphore = None
    batcher: Optional[_MicroBatcher] = None  # --max-batch > 1
    protocol_version = "HTTP/1.1"
    _root = None  # the open request's ``serve.request`` span, while recorded

    def _forward(self, source):
        """The device section of a request: the model forward, alone or
        coalesced with others (_MicroBatcher). The photo's copy to the card
        starts before it."""
        with timings.trace("serve.upload"):
            source, ready = _upload(source, self.session.runtime.resolved_device())
        if self.batcher is not None:
            return self.batcher.depth_map(source, ready)
        with timings.trace("serve.queue"):
            self.lock.acquire()
        try:
            if ready is not None:
                ready()
            dm = self.session.depth_map(source)
            _wait_for_device([dm])
        finally:
            self.lock.release()
        return dm

    # -- plumbing ----------------------------------------------------------

    def _traced(self, handle) -> None:
        """``handle()`` as one request: the root span ``serve.request``."""
        with timings.trace("serve.request") as root:
            self._root = root
            try:
                handle()
            finally:
                self._root = None

    def log_message(self, fmt, *args):  # one line per request
        """Under ``MATRIX_EYES_TIMINGS``, the line ends with the milliseconds
        of the request's spans that have ended, by name."""
        line = f"serve: {self.address_string()} {fmt % args}"
        root = self._root
        if root is not None and timings.enabled():
            ms: dict = {}
            for s in timings.request_spans(root.request, root.start_ns):
                ms[s.name] = ms.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
            line += f" [request {root.request}: " + ", ".join(
                f"{name} {v:.2f} ms" for name, v in ms.items()) + "]"
        print(line, flush=True)

    def _reply(self, code: int, body, ctype: str) -> None:
        """``body``: bytes (small replies) or a _FileResponse, streamed in
        chunks, its directory removed after the transfer."""
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        size = body.size if isinstance(body, _FileResponse) else len(body)
        self.send_header("Content-Length", str(size))
        if self.close_connection:
            # the connection is about to drop (oversized body, raw
            # failure): say so, or an HTTP/1.1 client may pipeline its
            # next request into a closed socket
            self.send_header("Connection", "close")
        self.end_headers()
        if isinstance(body, _FileResponse):
            body.stream_to(self.wfile)
        else:
            self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode() + b"\n", "application/json")

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            raise BadRequest("Content-Length must be an integer")
        if length <= 0:
            raise BadRequest("request body must contain the encoded photo")
        if length > _MAX_BODY:
            # the body stays unread: a keep-alive peer would have its next
            # request parsed out of these bytes, so drop the connection
            self.close_connection = True
            raise _OversizedBody(f"body too large ({length} bytes)")
        return self.rfile.read(length)

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        self._traced(self._get)

    def do_POST(self):
        self._traced(self._post)

    def _get(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            rt = self.session.runtime
            self._reply_json(200, {
                "status": "ok",
                "model": "depth_pro",
                "img_size": self.session.cfg.img_size,
                "dtype": str(rt.resolved_dtype()).removeprefix("torch."),
                # the weight policy on top of the compute dtype
                # (ops/quant.py int8, ops/mixed.py mixed)
                "weight_policy": ("int8" if rt.quantize_int8
                                  else "mixed" if rt.mixed_bf16 else "plain"),
                "default_dtype_policy": DEFAULT_DTYPE_POLICY,
            })
            return
        if path == "/":
            self._reply(200, __doc__.encode(), "text/plain; charset=utf-8")
            return
        self._reply_json(404, {"error": f"no such route: {path}"})

    def _post(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        # bound the work in flight before reading the body: the server
        # starts a thread per connection without limit, so N slow clients
        # would pin N threads each holding a ~36 MB body. Excess load gets
        # 503 at once, and the connection drops (the unread body would
        # desynchronise a keep-alive stream)
        if not self.inflight.acquire(blocking=False):
            self.close_connection = True
            self.send_response(503)
            self.send_header("Retry-After", "1")
            body = b'{"error": "server at capacity"}\n'
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            try:
                with timings.trace("serve.body"):
                    body = self._read_body()
                if url.path == "/v1/process":
                    out, ctype = self._process(body, q)
                elif url.path == "/v1/depth":
                    out, ctype = self._depth(body, q)
                else:
                    self._reply_json(404, {"error": f"no such route: {url.path}"})
                    return
            except _OversizedBody as e:
                # reply, then shut the socket: a client still streaming its
                # oversized upload may never read the reply while blocked on
                # a full (unread) receive buffer
                self._reply_json(400, {"error": str(e)})
                import socket as _socket

                try:
                    self.connection.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            except BadRequest as e:
                self._reply_json(400, {"error": str(e)})
                return
            except ReconstructionError as e:
                # an undecodable body and the like: the client's fault
                self._reply_json(400, {"error": str(e)})
                return
            except MatrixEyesError as e:
                self._reply_json(500, {"error": str(e)})
                return
            except Exception as e:  # runtime and device errors: reply, don't drop
                import traceback

                traceback.print_exc()
                self.close_connection = True  # not worth trusting for reuse
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                with timings.trace("serve.reply"):
                    self._reply(200, out, ctype)
            except (BrokenPipeError, ConnectionResetError) as e:
                # the client went away before or during the transfer
                self.close_connection = True
                print(f"serve: {self.address_string()} {url.path}: client closed the "
                      f"connection during the reply ({type(e).__name__})", flush=True)
            finally:
                # send_response or send_header can raise before stream_to's
                # own cleanup is reached; cleanup() is idempotent
                if isinstance(out, _FileResponse):
                    out.cleanup()
        finally:
            self.inflight.release()

    # -- work --------------------------------------------------------------

    def _process(self, body: bytes, q: dict):
        import shutil

        from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat, VertexMode

        fmt = (q.get("format") or ["depthmap"])[-1]
        if fmt not in _FORMATS:
            raise BadRequest(
                f"format must be one of {sorted(_FORMATS)}, got {fmt!r}")
        ext, ctype = _FORMATS[fmt]
        # validated for every request: an invalid value must 400, never
        # reach VertexMode() and fail the handler
        vertex_mode = (q.get("vertex-mode") or ["vertex-colors"])[-1]
        if vertex_mode not in ("plain", "vertex-colors",
                               "texture-coordinates"):
            raise BadRequest(
                f"vertex-mode must be plain|vertex-colors|"
                f"texture-coordinates, got {vertex_mode!r}")
        # an OBJ with texture coordinates has a .mtl naming the texture:
        # served as a zip of the three files with relative paths, the CLI's
        # layout on disk (PLY has no sidecar; it stays one response)
        texture_zip = fmt == "obj" and vertex_mode == "texture-coordinates"
        if texture_zip:
            ctype = "application/zip"
        focal = _one_float(q, "focal-length", positive=True)
        resize_scale = _one_float(q, "resize-scale", positive=True)
        amplitude = _one_float(q, "stereo-amplitude", positive=True)
        if amplitude is None:
            amplitude = 1.0 / 16.0
        image_format = ImageOutputFormat(
            "stereogram" if fmt == "stereogram" else "depthmap")
        options = dict(image_format=image_format, vertex_mode=VertexMode(vertex_mode),
                       resize_scale=resize_scale, amplitude=amplitude,
                       seed=self.session.runtime.seed)

        # mkdtemp, not TemporaryDirectory: the output outlives this call,
        # streamed from disk by _FileResponse, which then removes the
        # directory; on any error before that handoff it is removed here
        d = tempfile.mkdtemp(prefix="me_serve_")
        try:
            src = os.path.join(d, "src.bin")  # PIL sniffs content, not names
            with open(src, "wb") as f:
                f.write(body)
            dst = os.path.join(d, "out" + ext)
            source = load_source_image(src, focal)  # host decode, no lock
            dm = self._forward(source)
            if texture_zip:
                # the .mtl's map_Kd is a relative name inside the zip: the
                # body itself, named by its encoding, or a PNG transcode of
                # an encoding OBJ viewers cannot load (GIF, PPM, ...)
                tex_ext = _sniff_image_ext(src)
                if tex_ext is None:
                    from PIL import Image

                    tex_name = "texture.png"
                    with Image.open(src) as im:
                        im.convert("RGB").save(os.path.join(d, tex_name), "PNG")
                else:
                    tex_name = "texture" + tex_ext
                    os.replace(src, os.path.join(d, tex_name))
                dm.output_image(dst, tex_name, **options)
                out_path = os.path.join(d, "bundle.zip")
                _zip_files(d, ["out.obj", "out.mtl", tex_name], out_path)
            else:
                dm.output_image(dst, src, **options)
                out_path = dst
            resp = _FileResponse(out_path, cleanup_dir=d)
            d = None  # the response owns the directory now
            return resp, ctype
        finally:
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)

    def _depth(self, body: bytes, q: dict):
        import io

        import numpy as np

        focal = _one_float(q, "focal-length", positive=True)
        with tempfile.TemporaryDirectory(prefix="me_serve_") as d:
            src = os.path.join(d, "src.bin")
            with open(src, "wb") as f:
                f.write(body)
            source = load_source_image(src, focal)  # host decode, no lock
            dm = self._forward(source)
        inv = dm.to_numpy()
        buf = io.BytesIO()
        np.save(buf, inv)
        return buf.getvalue(), "application/x-npy"


def create_server(session, host: str = "127.0.0.1", port: int = 8000,
                  max_inflight: int = 8, max_batch: int = 1) -> ThreadingHTTPServer:
    """A ready-to-run server bound to ``session`` (an api.MatrixEyes).

    Tests and embedders run it on an ephemeral port in a thread:
    ``create_server(MatrixEyes(ckpt, device="cpu"), port=0)``, then
    ``server.serve_forever()`` / ``server.shutdown()``.

    ``max_inflight`` bounds concurrent POST work (body held, pipeline
    running); requests beyond it get 503 and Retry-After at once.
    ``max_batch`` > 1 coalesces concurrent forwards into one batched
    forward (_MicroBatcher); 1 runs one forward at a time, whose numbers
    equal the CLI's.
    """
    lock = threading.Lock()
    handler = type("BoundHandler", (_Handler,), {
        "session": session,
        "lock": lock,
        "inflight": threading.BoundedSemaphore(max_inflight),
        "batcher": _MicroBatcher(session, lock, max_batch)
        if max_batch > 1 else None,
    })
    return ThreadingHTTPServer((host, port), handler)


def _dtype_policy(name: str) -> str:
    from matrix_eyes_tpu_torch.config import parse_dtype_policy

    parse_dtype_policy(name)  # ValueError -> argparse's usage error
    return name


def main(argv=None, device=None) -> int:
    """The server's command line. It serves from the card; ``device`` is
    for programmatic callers ("cpu"), as in ``cli.main``."""
    import argparse

    from matrix_eyes_tpu_torch.api import MatrixEyes

    ap = argparse.ArgumentParser(
        prog="matrix-eyes-serve",
        description="Serve Depth Pro over HTTP (load once, answer many).")
    ap.add_argument("--checkpoint-path", default="./checkpoints/depth_pro.pt")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--dtype", default=None, type=_dtype_policy,
                    help="f32|bf16|f16|int8|mixed (default: bf16 on the card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="stereogram noise seed")
    ap.add_argument("--no-flash-attention", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--convert-checkpoints", action="store_true",
                    help="write the weight caches beside the checkpoint")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="concurrent in-flight POST bound (excess -> 503)")
    ap.add_argument("--max-batch", type=int, default=1,
                    help="coalesce up to N concurrent forwards into one "
                         "batched forward (1 = off)")
    args = ap.parse_args(argv)
    if args.no_flash_attention:
        # the kernels are the only route on the card: no kill switch
        ap.error("argument --no-flash-attention is not supported by the PyTorch port")

    session = MatrixEyes(args.checkpoint_path, dtype=args.dtype, seed=args.seed,
                         device=device, convert_checkpoints=args.convert_checkpoints)
    server = create_server(session, args.host, args.port,
                           max_inflight=args.max_inflight,
                           max_batch=args.max_batch)
    host, port = server.server_address[:2]
    print(f"serving depth_pro on http://{host}:{port} "
          f"(/healthz, /v1/process, /v1/depth)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
