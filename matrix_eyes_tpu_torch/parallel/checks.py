"""Rank functions that run the sharded forward and report what the layout
promises, for ``parallel.launch``: the CPU tests and ``chip_smoke.py``
start them (a rank imports this module, never a test module).

    results = launch(run_cases, (2, 2), cases, devices=["cpu"] * 4)

A case is a dict: ``cfg``, ``params`` (a placed parameter tree, on the
host, or the path of a ``torch.save`` of one, mapped from disk), ``img``
(the normalised (B, S, S, 3) batch in the policy's image dtype) and,
optionally, ``model`` (another model-parallel degree over the same ranks:
its own mesh), ``device`` ("cpu" runs the case on the host over the same
groups, gloo only) and ``runs`` (forwards, the first one counted).

``run_entry_points`` drives what a user calls instead (one rank of
``--devices``, a ``MatrixEyes`` session on a mesh), ``cli_rank_failing``
is one rank of ``--devices`` whose forward fails, ``run_graph_cases``
runs the forwards through the mesh's CUDA-graph cache against their eager
calls, and ``run_collectives_capture`` captures NCCL's collectives
themselves in a graph.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import time
from typing import Any, Dict, List

import torch

from matrix_eyes_tpu_torch.ops import _build

_KERNELS = ("attention_qkv", "conv3x3", "linker_scan", "attention_flash", "threefry", "gelu",
            "scaled_residual", "resize_bilinear")


def _kernel_counts() -> Dict[str, Any]:
    """This rank's launches by kernel since the ledger's last ``reset``,
    attention_qkv's by shape and conv3x3's by batch."""
    conv_by_batch = collections.Counter()
    for shape, n in _build.launches("conv3x3").items():
        conv_by_batch[shape[0]] += n
    counts: Dict[str, Any] = {k: _build.launches(k).total() for k in _KERNELS}
    counts["attention_by_shape"] = {str(k): v
                                    for k, v in _build.launches("attention_qkv").items()}
    counts["conv3x3_by_batch"] = dict(conv_by_batch)
    return counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _foreign_modules() -> List[str]:
    """The modules of jax and of the JAX package this process loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "matrix_eyes_tpu"))


def timed(fn, calls: int) -> Dict[str, float]:
    """Per call of ``fn`` on the current card: the wall by CUDA events over
    ``calls`` calls back to back, and the host's time and CPU time to issue
    one call on an idle card (each call alone, the card synchronised before
    it, the wait outside the measure). The host's CPU clock ticks coarsely:
    read it as a sum over the calls."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    issue = cpu = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        cpu0, t0 = time.process_time(), time.perf_counter()
        fn()
        issue += time.perf_counter() - t0
        cpu += time.process_time() - cpu0
    torch.cuda.synchronize()
    return {"wall_ms": start.elapsed_time(end) / calls, "issue_ms": issue * 1e3 / calls,
            "host_cpu_ms": cpu * 1e3 / calls}


# kernel families by a substring of the kernel's name, first match wins
_FAMILIES = (("nccl", ("nccl",)), ("attention_qkv", ("attention_", "split_tf32")),
             ("conv3x3", ("conv3x3_",)), ("gemm", ("gemm", "xmma", "cutlass", "nvjet")))


def device_ms(fn, calls: int) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``: (device ms per call,
    kernel launches per call, cudaGraphLaunch calls per call, device ms per
    call by kernel family: NCCL, the attention and conv3x3 kernels, GEMMs,
    the rest), kernels replayed by a CUDA graph included. An NCCL kernel's
    time includes its wait for the other ranks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, kernels, graph_launches = 0.0, 0, 0
    families = collections.Counter()
    for ev in prof.events():
        if ev.name == "cudaGraphLaunch":
            graph_launches += 1
        name = ev.name.lower()
        if str(ev.device_type).endswith("CUDA") and "memcpy" not in name \
                and "memset" not in name:
            t = ev.time_range.elapsed_us()
            us += t
            kernels += 1
            family = next((f for f, keys in _FAMILIES if any(k in name for k in keys)), "other")
            families[family] += t / 1000.0 / calls
    return us / 1000.0 / calls, kernels / calls, graph_launches / calls, dict(families)


def forward_case(mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """One case on this rank: cut the parameters, run the forward
    ``runs`` times under ``patch_sharded``; the first run's collective and
    kernel counts, held to ``collectives.check_forward``."""
    from matrix_eyes_tpu_torch.config import configure_precision
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.parallel import collectives
    from matrix_eyes_tpu_torch.parallel.sharding import make_mesh, patch_sharded, shard_params

    configure_precision()  # as every entry point of the port: f32 means f32
    cfg = case["cfg"]
    if case.get("model", mesh.model) != mesh.model:
        mesh = make_mesh(mesh.size, model=case["model"], device=mesh.device)
    if case.get("device") is not None:
        mesh = dataclasses.replace(mesh, device=torch.device(case["device"]))
    params = case["params"]
    if isinstance(params, str):
        params = torch.load(params, map_location="cpu", mmap=True, weights_only=True)
    t0 = time.perf_counter()
    local = shard_params(params, mesh, num_heads=cfg.num_heads)
    _sync(mesh.device)
    shard_s = time.perf_counter() - t0
    del params
    img = case["img"].to(mesh.device)
    walls, out = [], {}
    for i in range(case.get("runs", 1)):
        _build.reset()
        _sync(mesh.device)
        t0 = time.perf_counter()
        with patch_sharded(mesh):
            inv, fov = depth_pro.forward_with_fov(cfg, local, img)
        _sync(mesh.device)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            out["report"] = collectives.check_forward(cfg, mesh, img.shape[0])
            out["kernels"] = _kernel_counts()
    out.update(inv=inv, fov=fov, walls=walls, shard_s=shard_s, mesh=(mesh.data, mesh.model),
               rank=mesh.rank, device=str(mesh.device),
               qkv_width=_qkv_width(local))
    return out


def _qkv_width(params) -> int:
    """This rank's qkv output width in the patch ViT (3C / model)."""
    blocks = params["encoder"]["patch_encoder"]["blocks"]
    for key, axis in (("qkv_gw", -1), ("qkv_w", -1), ("qkv_gqw", -2), ("qkv_qw", -2)):
        if key in blocks:
            return blocks[key].shape[axis]
    raise KeyError("no qkv weight in the patch ViT's blocks")


def run_cases(mesh, cases: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Every case on this rank, in order (every rank runs the same list);
    with the backend, one all-reduce of ones over the whole world through
    it (its size, on every rank: a world of one rank still initialises its
    communicator) and the modules of the JAX package this rank loaded
    (none, if the port keeps to itself)."""
    import torch.distributed as dist

    ones = torch.ones(1, device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(ones)
    results = [forward_case(mesh, case) for case in cases]
    return {"cases": results, "backend": mesh.backend, "world_sum": ones.item(),
            "foreign_modules": _foreign_modules()}


def _answer_reader(cfg, weights: str) -> None:
    """This rank's checkpoint reader (``pt.convert.read_checkpoint``, which
    the CLI's and the session's loaders call) answered with the tree saved
    at ``weights``, mapped from disk: the repository holds no trained
    checkpoint."""
    from matrix_eyes_tpu_torch.pt import convert

    arch = cfg
    tree = torch.load(weights, map_location="cpu", mmap=True, weights_only=True)

    def read(path, parts=convert.PARTS, cfg=None):
        return arch, {part: tree[part] for part in parts}

    convert.read_checkpoint = read


def run_entry_points(mesh, cfg, weights: str, calls: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The entry points a user calls, on this rank, with the checkpoint
    reader answered by ``weights`` (``--checkpoint-path`` names that file):

    * ``{"cli": argv}``: ``cli._rank_main``, what one rank of
      ``python -m matrix_eyes_tpu_torch --devices=... argv`` runs (the
      checkpoint read on the host and cut, rank 0 decoding, broadcasting
      and writing);
    * ``{"inverse_depth_batch": paths}`` and ``{"process_batch": jobs,
      "batch_size": n}``: a ``MatrixEyes`` session on the host in the
      dtype the CLI runs on the ranks' device (bf16 on a card, f32 on the
      CPU), its parameters cut for ``mesh``.

    Each call also names what it runs: ``batch`` images a forward,
    ``forwards`` and ``n_vits`` (3 with the FOV head, 2 without), to which
    its collectives are held (``collectives.check_forward``). Returns per
    call its wall (host clock, with the loads), launches and collective
    report, the modes its forwards ran in (``aot.mesh_cache``), and the
    inverse depth of an ``inverse_depth_batch``."""
    from matrix_eyes_tpu_torch import aot, api, cli
    from matrix_eyes_tpu_torch.config import RuntimeConfig
    from matrix_eyes_tpu_torch.parallel import collectives

    _answer_reader(cfg, weights)
    session, results = None, []
    modes = aot.mesh_cache(mesh).modes
    for call in calls:
        _build.reset()
        modes.clear()
        out = {}
        t0 = time.perf_counter()
        if "cli" in call:
            out["rc"] = cli._rank_main(mesh, cli.parse_args(call["cli"]))
        else:
            if session is None:
                dtype = RuntimeConfig(device=mesh.device).resolved_dtype()
                session = api.MatrixEyes(weights, dtype=dtype, device="cpu")
            if "inverse_depth_batch" in call:
                out["inv"] = torch.from_numpy(
                    session.inverse_depth_batch(call["inverse_depth_batch"], mesh=mesh))
            else:
                session.process_batch(call["process_batch"], batch_size=call["batch_size"],
                                      mesh=mesh)
        _sync(mesh.device)
        out["wall"] = time.perf_counter() - t0
        out["report"] = collectives.check_forward(cfg, mesh, call["batch"],
                                                  n_vits=call["n_vits"],
                                                  forwards=call["forwards"])
        out["kernels"] = _kernel_counts()
        out["modes"] = [mode for _name, mode in modes]
        results.append(out)
    return {"calls": results, "rank": mesh.rank, "foreign_modules": _foreign_modules()}


def cli_rank_failing(fail_rank: int, mesh, args) -> int:
    """``cli._rank_main`` with the forward raising on rank ``fail_rank``
    (the other ranks then wait in its first collective): how the tests
    show that one rank's failure ends every rank of ``--devices``."""
    from matrix_eyes_tpu_torch import cli
    from matrix_eyes_tpu_torch.models import depth_pro

    if mesh.rank == fail_rank:
        def fail(*_args, **_kwargs):
            raise RuntimeError(f"a fault on rank {fail_rank}")

        depth_pro.forward_with_fov = depth_pro.forward_with_fnorm = fail
        depth_pro.forward_with_mixed_fnorm = fail
    return cli._rank_main(mesh, args)


def run_graph_cases(mesh, cases: List[Dict[str, Any]], graphs: str = "cuda") -> Dict[str, Any]:
    """Each case's forward on this rank, as the pipeline runs it on a mesh
    (``pipeline.forward_photo`` at one image, ``forward_batch`` beyond),
    once eagerly (``aot.disabled()``) and then three times through the
    mesh's CUDA-graph cache (``aot.mesh_cache``: warm-up, capture, replay).
    Every rank runs the same list. ``graphs``: "cuda", the card's graphs
    (an NCCL mesh); "host", ``aot.HostGraphs``, which needs no card (the CPU
    tests over gloo).

    A case is ``run_cases``' (cfg, params, img, optional model) with
    ``f_norms`` (one per image, None where the FOV head estimates it;
    default all None), ``timing`` (calls per turn; graphs against eager in
    turns graphs, eager, eager, graphs: ``timed``'s wall, host issue and
    host CPU, then ``device_ms`` over two calls a mode; 0, the default,
    times nothing) and ``disagree_rank`` (after the eager call and the
    warm-up, that rank runs the capture call with the cache off: every rank
    must raise, and the case returns the message).

    Returns per case: each call's mode, launches, collective report
    (``collectives.check_forward``, which raises on a broken invariant) and
    wall; whether the replay equals the eager call bit for bit; the
    replay's inverse depth; the capture's seconds and the graph pool's
    bytes; the timing."""
    from matrix_eyes_tpu_torch import aot, pipeline
    from matrix_eyes_tpu_torch.config import configure_precision
    from matrix_eyes_tpu_torch.parallel import collectives
    from matrix_eyes_tpu_torch.parallel.sharding import make_mesh, patch_sharded, shard_params

    configure_precision()
    results = []
    for case in cases:
        cfg = case["cfg"]
        m = mesh
        if case.get("model", mesh.model) != mesh.model:
            m = make_mesh(mesh.size, model=case["model"], device=mesh.device)
        cache = aot.mesh_cache(m, aot.HostGraphs() if graphs == "host" else None)
        params = case["params"]
        if isinstance(params, str):
            params = torch.load(params, map_location="cpu", mmap=True, weights_only=True)
        local = shard_params(params, m, num_heads=cfg.num_heads)
        del params
        img = case["img"].to(m.device)
        batch = img.shape[0]
        f_norms = case.get("f_norms") or [None] * batch
        n_vits = 3 if any(f is None for f in f_norms) else 2

        def forward():
            with patch_sharded(m):
                if batch == 1:
                    return pipeline.forward_photo(cfg, local, img, f_norms[0], m)
                return pipeline.forward_batch(cfg, local, img, f_norms, m)

        def counted():
            _build.reset()
            _sync(m.device)
            t0 = time.perf_counter()
            out = forward()
            _sync(m.device)
            wall = time.perf_counter() - t0
            name, mode = cache.modes[-1]
            return out, {"program": name, "mode": mode, "wall": wall,
                         "kernels": _kernel_counts(),
                         "report": collectives.check_forward(cfg, m, batch, n_vits=n_vits)}

        with aot.disabled():
            eager, first = counted()
        calls = [first]
        row = {"mesh": (m.data, m.model), "rank": m.rank, "calls": calls}
        if case.get("disagree_rank") is not None:
            forward()
            off = aot.disabled() if m.rank == case["disagree_rank"] else contextlib.nullcontext()
            try:
                with off:
                    forward()
            except RuntimeError as err:
                results.append(dict(row, disagreement=str(err)))
                continue
            raise RuntimeError("the ranks ran one program in two modes and this rank went on")
        for _ in range(3):
            got, call = counted()
            calls.append(call)
        # the capture's seconds and pool growth, where the third call captured
        _name, seconds, growth = (cache.captured[-1] if calls[2]["mode"] == "capture"
                                  else (None, None, None))
        row.update(bit_equal=torch.equal(got, eager), inv=got, capture_s=seconds,
                   capture_pool_growth=growth, pool_bytes=cache.backend.memory(m.device))
        if case.get("timing"):
            runs: Dict[str, list] = {"graphs": [], "eager": []}
            for mode in ("graphs", "eager", "eager", "graphs"):
                with aot.disabled() if mode == "eager" else contextlib.nullcontext():
                    runs[mode].append(timed(forward, case["timing"]))
            device = {}
            for mode in ("graphs", "eager"):
                with aot.disabled() if mode == "eager" else contextlib.nullcontext():
                    device[mode] = device_ms(forward, 2)
            row["timing"] = {"runs": runs, "device": device}
        results.append(row)
        del local, eager, got
    return {"cases": results, "backend": mesh.backend, "foreign_modules": _foreign_modules()}


def run_collectives_capture(mesh, n: int = 1 << 20) -> Dict[str, Any]:
    """``dist.all_reduce`` and ``dist.all_gather_into_tensor`` over the
    world, called directly inside a program run through an
    ``aot.GraphCache`` of the card's graphs: four calls with new inputs
    each (eager, capture, replay, replay), each against the same program
    run eagerly on the same input. The port's wrappers skip an axis of size
    1, so this is what shows the backend's own collectives captured on a
    world of one rank."""
    import torch.distributed as dist

    from matrix_eyes_tpu_torch import aot

    world = dist.get_world_size()

    def program(x):
        y = x * 2.0 + 1.0
        dist.all_reduce(y)
        out = y.new_empty((world * y.shape[0],))
        dist.all_gather_into_tensor(out, y)
        return y, out

    cache = aot.GraphCache()
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    calls = []
    for _ in range(4):
        x = torch.randn(n, device=mesh.device, generator=gen)
        want = program(x)
        got = cache.call("collectives", program, (x,))
        calls.append({"mode": cache.modes[-1][1],
                      "equal": all(torch.equal(a, b) for a, b in zip(got, want))})
    return {"backend": mesh.backend, "world": world, "calls": calls,
            "captured": list(cache.captured), "foreign_modules": _foreign_modules()}
