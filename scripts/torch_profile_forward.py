#!/usr/bin/env python3
"""Device time of the PyTorch port's warm DEPTH_PRO forward, per forward and
per kernel, on one CUDA card; several source trees compared in one call.

    python3 scripts/torch_profile_forward.py [--dtype f32|bf16|f16|mixed|int8] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this
one, another unpacked with ``git archive``). The trees run in the order
given, each in its own process (they hold packages of the same name), so
``build/parent . . build/parent`` times parent, change, change, parent on
one card. Each run: random DEPTH_PRO weights from seed 0 under the CLI's
``--dtype`` policy (bf16 by default, the card's default; f16, mixed and
int8 place the seed's f32 weights as the loader does,
``pt.convert.place_params``), ``--batch`` random 1536^2 inputs in the
policy's image dtype (one forward over the batch, as ``--batch-size`` runs
it), two untimed
forwards (they build the kernels), the wall of ``--reps`` forwards
between CUDA events, then ``--profiled`` forwards
under ``torch.profiler`` for the device time of every kernel. The
forward is ``models.depth_pro.forward_with_fov`` (encoder, decoder, head,
FOV): the photo's decode, preprocess and output stages are not in it.

Prints one JSON line per run, then a table of device ms per forward by
kernel over all runs, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _group(name: str) -> str:
    """A kernel's family: the port's own kernels by name, the rest by kind."""
    for key in ("conv3x3_splitk_reduce", "conv3x3_wgmma", "conv3x3_tf32",
                "conv3x3_split_weights", "conv3x3_mma", "conv3x3_kernel", "attention_wgmma",
                "attention_tf32", "split_tf32", "attention_mma", "attention_kernel",
                "linker_scan"):
        if key in name:
            return key
    low = name.lower()
    if "gemm" in low and ("_s8" in low or "imma" in low):
        return "cuBLAS int8 GEMM"
    # nvjet_*: cuBLAS's Hopper GEMM kernels (their names do not say gemm)
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "cuBLAS GEMM"
    if "conv" in low or "cudnn" in low:
        return "cuDNN conv (FOV)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise, reductions, other"


def child(tree: str, reps: int, profiled: int, dtype_name: str, batch: int = 1) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from matrix_eyes_tpu_torch.config import DEPTH_PRO, configure_precision
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.models.init import init_params

    configure_precision()
    dev = torch.device("cuda", 0)
    cfg = DEPTH_PRO
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype_name in ("bf16", "f32"):  # the form every tree of the port takes
        dtype = image_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
        params = init_params(cfg, gen, dev, dtype)
    else:
        from matrix_eyes_tpu_torch.config import RuntimeConfig, parse_dtype_policy
        from matrix_eyes_tpu_torch.pt.convert import place_params

        dtype, q8, mixed = parse_dtype_policy(dtype_name)
        image_dtype = RuntimeConfig(dtype, device=dev, quantize_int8=q8,
                                    mixed_bf16=mixed).image_dtype()
        params = place_params(init_params(cfg, gen, dev, torch.float32), dev, dtype,
                              quantize_int8=q8, mixed_bf16=mixed)
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(1)
    img = (torch.rand(batch, cfg.img_size, cfg.img_size, 3, device=dev, generator=gen) * 2 - 1)
    img = img.to(image_dtype)

    def forward():
        with torch.no_grad():
            return depth_pro.forward_with_fov(cfg, params, img)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        forward()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / reps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            forward()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or str(getattr(ev, "device_type", "")).endswith("CPU"):
            continue
        k = kernels.setdefault(ev.key, [0.0, 0])
        k[0] += us / 1000.0 / profiled
        k[1] += ev.count / profiled
    groups = {}
    for name, (ms, calls) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += calls
    return {"tree": tree, "kind": torch.cuda.get_device_name(0), "dtype": dtype_name,
            "batch": batch, "forward_wall_ms": wall_ms,
            "device_ms_per_forward": sum(ms for ms, _ in kernels.values()),
            "groups": {g: {"ms": ms, "launches": calls} for g, (ms, calls) in groups.items()},
            "top": sorted(([n[:90], ms, calls] for n, (ms, calls) in kernels.items()),
                          key=lambda r: -r[1])[:12]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=["."])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--dtype", choices=("bf16", "f32", "f16", "mixed", "int8"), default="bf16")
    ap.add_argument("--batch", type=int, default=1, help="photos per forward")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.reps, args.profiled, args.dtype, args.batch)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_forward: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               "--reps", str(args.reps), "--profiled", str(args.profiled),
                               "--dtype", args.dtype, "--batch", str(args.batch)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print(f"card: {smi}")
    names = sorted({g for r in runs for g in r["groups"]},
                   key=lambda g: -max(r["groups"].get(g, {"ms": 0})["ms"] for r in runs))
    print("| kernel family | " + " | ".join(f"{r['tree']} ms (launches)" for r in runs) + " |")
    print("|---" * (len(runs) + 1) + "|")
    for g in names:
        cells = []
        for r in runs:
            v = r["groups"].get(g)
            cells.append(f"{v['ms']:.3f} ({v['launches']:.0f})" if v else "-")
        print(f"| {g} | " + " | ".join(cells) + " |")
    print("| device ms per forward | "
          + " | ".join(f"{r['device_ms_per_forward']:.3f}" for r in runs) + " |")
    print("| forward wall ms (CUDA events) | "
          + " | ".join(f"{r['forward_wall_ms']:.3f}" for r in runs) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
