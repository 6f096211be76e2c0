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
``--devices``, a ``MatrixEyes`` session on a mesh), and
``cli_rank_failing`` is one rank of ``--devices`` whose forward fails.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Any, Dict, List

import torch


def _kernel_counts() -> Dict[str, Any]:
    from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_flash, attention_qkv
    from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan

    conv_by_batch = collections.Counter()
    for shape, n in conv3x3.launches_by_shape.items():
        conv_by_batch[shape[0]] += n
    return {"attention_qkv": attention_qkv.launches, "conv3x3": conv3x3.launches,
            "linker_scan": linker_scan.launches, "attention_flash": attention_flash.launches,
            "attention_by_shape": {str(k): v for k, v in attention_qkv.launches_by_shape.items()},
            "conv3x3_by_batch": dict(conv_by_batch)}


def _reset_kernel_counts() -> None:
    from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_flash, attention_qkv
    from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan

    attention_qkv.launches = conv3x3.launches = linker_scan.launches = 0
    attention_flash.launches = 0
    for counter in (attention_qkv.launches_by_dtype, attention_qkv.launches_by_batch,
                    attention_qkv.launches_by_shape, conv3x3.launches_by_shape):
        counter.clear()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        collectives.reset()
        _reset_kernel_counts()
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
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "matrix_eyes_tpu"))
    return {"cases": results, "backend": mesh.backend, "world_sum": ones.item(),
            "foreign_modules": foreign}


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
    report, and the inverse depth of an ``inverse_depth_batch``."""
    from matrix_eyes_tpu_torch import api, cli
    from matrix_eyes_tpu_torch.config import RuntimeConfig
    from matrix_eyes_tpu_torch.parallel import collectives

    _answer_reader(cfg, weights)
    session, results = None, []
    for call in calls:
        collectives.reset()
        _reset_kernel_counts()
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
        results.append(out)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "matrix_eyes_tpu"))
    return {"calls": results, "rank": mesh.rank, "foreign_modules": foreign}


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
