"""HTTP burst throughput and latency of the PyTorch port's server.

K concurrent uploads of one photo through real HTTP (``serve.create_server``
on an ephemeral port, a ``MatrixEyes`` session), at ``--max-batch=N``
(``serve._MicroBatcher`` coalescing concurrent forwards) and at 1 (one
forward at a time), so that the coalescing's effect is a measured ratio.
Per mode: requests per second over the burst, each request's latency
(p50, p95, max) under it, the latency of one request to the idle warm
server, and the batch sizes the forwards ran at. Before measuring, every
padded batch shape is driven once, then one request and one full volley
warm the render and encode path.

``--compare-output-streams`` measures both modes a second time with each
response's render, copies back and mesh work on a stream of its own
(``_outputs_on_their_own_stream``) instead of the default stream, where
serve.py leaves them behind the next request's forward: the comparison
behind that choice. ``--compare-aot`` measures both modes a second time
with every device program run eagerly (``MATRIX_EYES_AOT=off``) instead of
through the CUDA-graph cache (``aot.call_cached``, the default).
``--rounds N`` repeats either comparison N times, the two settings in
turns (ABBA), every run kept under ``runs``. ``--random-weights SEED``
serves seeded random DEPTH_PRO weights (bf16, as ``chip_smoke.py``'s
phase 4) instead of a checkpoint.

Usage (on the card; nothing else may use it meanwhile):
  python scripts/torch_serve_burst.py --checkpoint depth_pro.pt --photo photo.jpg \\
      [--max-batch 4 --requests 16 --concurrency 8]
      [--compare-output-streams | --compare-aot] [--rounds 4] [--random-weights 0]
      [--out r.json]

Prints one JSON line (and writes it to ``--out``). ``main(argv,
device="cpu")`` runs it on the CPU (tests/test_torch_serve.py, TINY);
``session=`` hands it a loaded session (chip_smoke.py phase 14).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _post(url: str, body: bytes, retries: int = 50) -> tuple:
    """POST and drain the response in chunks, honouring 503 + Retry-After
    as a client would. Returns (response bytes, seconds from the first
    attempt to the last byte)."""
    t0 = time.perf_counter()
    for _ in range(retries):
        req = urllib.request.Request(url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                n = 0
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        return n, time.perf_counter() - t0
                    n += len(chunk)
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
            time.sleep(0.2)
    raise RuntimeError("server kept replying 503")


def _percentile(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def _device_line(session) -> dict:
    dev = session.runtime.resolved_device()
    if dev.type != "cuda":
        return {"type": dev.type}
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


@contextlib.contextmanager
def _outputs_on_their_own_stream():
    """The alternative serve.py does not take: each response's
    ``DepthMap.output_image`` and ``to_numpy`` on a fresh stream (the
    forward that made the DepthMap has finished: the device section waited
    for it), so that they do not queue behind the next request's forward."""
    import torch

    from matrix_eyes_tpu_torch.output.depthmap import DepthMap

    real = {name: getattr(DepthMap, name) for name in ("output_image", "to_numpy")}

    def on_own_stream(fn):
        def run(self, *args, **kwargs):
            if not self.data.is_cuda:
                return fn(self, *args, **kwargs)
            stream = torch.cuda.Stream(self.data.device)
            self.data.record_stream(stream)
            with torch.cuda.stream(stream):
                return fn(self, *args, **kwargs)
        return run

    for name, fn in real.items():
        setattr(DepthMap, name, on_own_stream(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(DepthMap, name, fn)


def _run_mode(session, photo: bytes, max_batch: int, requests: int, concurrency: int,
              fmt: str, own_output_stream: bool = False, graphs: bool = True) -> dict:
    from matrix_eyes_tpu_torch import aot, serve
    from matrix_eyes_tpu_torch.io.image import load_source_image

    # a client's next request can arrive before the server's thread for its
    # previous one has released its in-flight slot (after the reply's last
    # byte): twice the concurrency is never refused, so the burst measures
    # throughput, not the 503 path
    server = serve.create_server(session, port=0, max_inflight=2 * concurrency,
                                 max_batch=max_batch)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           f"/v1/process?format={fmt}&focal-length=35")
    real_depth_maps = session.depth_maps
    batch_sizes: list = []

    def depth_maps(sources, pad_to_pow2=False):
        batch_sizes.append(len(sources))
        return real_depth_maps(sources, pad_to_pow2=pad_to_pow2)

    stack = contextlib.ExitStack()
    if own_output_stream:
        stack.enter_context(_outputs_on_their_own_stream())
    if not graphs:
        stack.enter_context(aot.disabled())
    try:
        # every padded batch shape the burst can reach, driven twice: the
        # second call of a program captures its graph
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".bin") as f:
            f.write(photo)
            f.flush()
            src = load_source_image(f.name, 35.0)
        for _ in range(2):
            b, top = 1, 1 << (max_batch - 1).bit_length()
            while b <= top:
                serve._wait_for_device(session.depth_maps([src] * min(b, max_batch),
                                                          pad_to_pow2=True))
                b *= 2
        _post(url, photo)
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            list(pool.map(lambda _i: _post(url, photo), range(concurrency)))
            idle = [_post(url, photo)[1] for _ in range(3)]
            session.depth_maps = depth_maps
            t0 = time.perf_counter()
            results = list(pool.map(lambda _i: _post(url, photo), range(requests)))
            wall = time.perf_counter() - t0
        if not all(n > 0 for n, _lat in results):
            raise RuntimeError("an empty response")
        lat = [s for _n, s in results]
        return {"max_batch": max_batch, "requests": requests, "concurrency": concurrency,
                "output_stream": "own" if own_output_stream else "default",
                "programs": "cuda_graphs" if graphs else "eager",
                "wall_s": wall, "requests_per_s": requests / wall,
                "latency_s": {"p50": _percentile(lat, 50), "p95": _percentile(lat, 95),
                              "max": max(lat)},
                "idle_latency_s": {"runs": idle, "median": _percentile(idle, 50)},
                "batch_sizes": batch_sizes if max_batch > 1 else "one forward per request"}
    finally:
        stack.close()
        session.depth_maps = real_depth_maps
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def _random_weights_session(seed: int, device):
    """A MatrixEyes session on seeded random DEPTH_PRO weights: the loader
    is answered with them, as chip_smoke.py answers it."""
    import torch

    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.models.init import init_params

    def weights(path, dtype, device, parts=None, **_policy):
        gen = torch.Generator(device=device).manual_seed(seed)
        return DEPTH_PRO, init_params(DEPTH_PRO, gen, device, dtype)

    real = api.load_checkpoint
    api.load_checkpoint = weights
    try:
        return api.MatrixEyes(f"random weights, seed {seed}", device=device)
    finally:
        api.load_checkpoint = real


def main(argv=None, device=None, session=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default="./checkpoints/depth_pro.pt")
    ap.add_argument("--photo", required=True)
    ap.add_argument("--dtype", default=None, help="f32|bf16|f16|int8|mixed")
    ap.add_argument("--format", default="depthmap", choices=["depthmap", "stereogram"])
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--skip-serialized", action="store_true",
                    help="measure only the coalescing mode")
    ap.add_argument("--compare-output-streams", action="store_true",
                    help="measure again with the outputs on a stream of their own")
    ap.add_argument("--compare-aot", action="store_true",
                    help="measure again with every program eager (MATRIX_EYES_AOT=off)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with a comparison: rounds, the two settings in turns")
    ap.add_argument("--random-weights", type=int, default=None, metavar="SEED",
                    help="serve seeded random DEPTH_PRO weights, not --checkpoint")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.compare_output_streams and args.compare_aot:
        ap.error("--compare-output-streams and --compare-aot: one comparison at a time")

    with open(args.photo, "rb") as f:
        photo = f.read()
    if session is None and args.random_weights is not None:
        session = _random_weights_session(args.random_weights, device)
    elif session is None:
        from matrix_eyes_tpu_torch.api import MatrixEyes

        session = MatrixEyes(args.checkpoint, dtype=args.dtype, device=device)
    report = {"metric": "serve_burst_http", "format": args.format, "photo_bytes": len(photo),
              "dtype": str(session.runtime.resolved_dtype()).removeprefix("torch."),
              "device": _device_line(session)}
    # (outputs on their own stream, programs through CUDA graphs)
    pair = [(False, True)]
    if args.compare_output_streams:
        pair.append((True, True))
    if args.compare_aot:
        pair.append((False, False))
    order = []
    for r in range(args.rounds if len(pair) > 1 else 1):
        order += pair if r % 2 == 0 else pair[::-1]
    report["runs"] = []
    for own, graphs in order:
        runs = {"batched": _run_mode(session, photo, args.max_batch, args.requests,
                                     args.concurrency, args.format, own, graphs)}
        if not args.skip_serialized:
            runs["serialized"] = _run_mode(session, photo, 1, args.requests,
                                           args.concurrency, args.format, own, graphs)
            runs["coalescing_speedup"] = (runs["batched"]["requests_per_s"]
                                          / runs["serialized"]["requests_per_s"])
        report["runs"].append(runs)
        # the first run of each setting also at the top level
        if own:
            report.setdefault("own_output_stream", runs)
        elif not graphs:
            report.setdefault("eager", runs)
        elif "batched" not in report:
            report.update(runs)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
