#!/usr/bin/env python3
"""Device time per call of the PyTorch port's kernel wrappers at the
shapes of ``chip_smoke.py``'s phase 3 (its lists, imported from this
checkout), on one CUDA card; several source trees compared in one call.

    python3 scripts/torch_kernel_times.py [--dtype f32|bf16|f16] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this
one, another unpacked with ``git archive``); the trees run in the order
given, each in its own process, so ``build/parent . . build/parent``
times parent, change, change, parent on one card. For every shape the
wrapper is called twice untimed, then ``--reps`` times under
``torch.profiler``: the device time of every kernel those calls launched
(the wrapper's own kernel, a split-K reduce, a padding copy, the f32
attention's split pre-pass), divided by ``--reps``, in sum and by kernel
name (``by_kernel``). Unlike CUDA events around a loop of calls, this leaves out
the host's time per call, which sets the event time of the small shapes.

For the attention rows the same is done for
``F.scaled_dot_product_attention`` on contiguous (B, H, N, D) copies over
the n_valid keys, and for the conv rows for ``F.conv2d`` on the
channels-last view with bias (true f32: cuDNN's TF32 is off), as
``library_device_ms``: the yardsticks of phase 3, timed here only; the
port never calls them. ``--dtype`` keeps the rows of one dtype (no
linker_scan rows).

Prints one JSON line per tree, then a table of device ms per call (shapes
by trees) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the shape lists of its phase 3)


def shapes(dtype: str = None) -> list:
    """(label, kind, shape) for every row of chip_smoke.py's phase-3 lists,
    or for those of one dtype."""
    rows = []
    for B, N, H, D, dt, n_valid in chip_smoke.ATTENTION_SHAPES:
        rows.append((f"attention_qkv B={B} N={N} H={H} D={D} {dt} n_valid={n_valid}", "attn",
                     (B, N, H, D, dt, n_valid)))
    for B, H, N, D, dt, n_valid, views in chip_smoke.FLASH_SHAPES:
        rows.append((f"attention_flash B={B} H={H} N={N} D={D} {dt} n_valid={n_valid} "
                     f"views={views}", "flash", (B, H, N, D, dt, n_valid, views)))
    for B, H, W, cin, cout, dt, relu_in, n_skips, bias, launches in chip_smoke.CONV_SHAPES:
        rows.append((f"conv3x3 {B}x{H}x{W} {cin}->{cout} {dt} relu_in={relu_in} "
                     f"skips={n_skips} bias={bias} x{launches or 0}/forward", "conv",
                     (B, H, W, cin, cout, dt, relu_in, n_skips, bias)))
    for H, W, amplitude in chip_smoke.LINKER_SHAPES:
        rows.append((f"linker_scan {H}x{W} amplitude={amplitude:g}", "scan", (H, W, amplitude)))
    if dtype is None:
        return rows
    return [r for r in rows if r[1] != "scan" and dtype in r[2]]


def child(tree: str, reps: int, dtype: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from matrix_eyes_tpu_torch.config import configure_precision
    from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_flash, attention_qkv
    from matrix_eyes_tpu_torch.ops.stereogram import _max_shift, stereogram_geometry
    from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan

    configure_precision()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}

    def sdpa(q, k, v, scale, n_valid):
        nv = q.shape[2] if n_valid is None else n_valid
        q, k, v = q.contiguous(), k[:, :, :nv].contiguous(), v[:, :, :nv].contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    def call_for(kind, shape):
        """(the wrapper's call, the library call or None)"""
        if kind == "attn":
            B, N, H, D, dt, n_valid = shape
            qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=gen).to(dtypes[dt])
            q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
            return (lambda: attention_qkv(qkv, H, D ** -0.5, n_valid),
                    sdpa(q, k, v, D ** -0.5, n_valid))
        if kind == "flash":
            B, H, N, D, dt, n_valid, views = shape
            if views:
                qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=gen).to(dtypes[dt])
                q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
            else:
                q, k, v = (torch.randn(B, H, N, D, device=dev, generator=gen).to(dtypes[dt])
                           for _ in range(3))
            return (lambda: attention_flash(q, k, v, D ** -0.5, n_valid),
                    sdpa(q, k, v, D ** -0.5, n_valid))
        if kind == "conv":
            B, H, W, cin, cout, dt, relu_in, n_skips, has_bias = shape
            dtype = dtypes[dt]
            x = torch.randn(B, H, W, cin, device=dev, generator=gen).to(dtype)
            w = (torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5
                 ).to(dtype)
            b = torch.randn(cout, device=dev, generator=gen).to(dtype) if has_bias else None
            skips = [torch.randn(B, H, W, cout, device=dev, generator=gen).to(dtype)
                     for _ in range(n_skips)] + [None] * (2 - n_skips)
            xc = x.permute(0, 3, 1, 2)  # NHWC storage: the channels-last view
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            return (lambda: conv3x3(x, w, b, skips[0], skips[1], relu_in),
                    lambda: F.conv2d(xc, wc, b, padding=1))
        H, W, amplitude = shape
        dm, pw = stereogram_geometry(W, amplitude)
        shift = torch.floor(torch.rand(H, W, device=dev, generator=gen) * dm + 0.5).to(torch.int32)
        noise = torch.randint(0, 256, (H, pw, 3), device=dev, generator=gen, dtype=torch.uint8)
        return lambda: linker_scan(shift, noise, pw, _max_shift(dm) + 1), None

    def device_ms(fn):
        """(ms per call, kernels per call, {kernel: ms per call})"""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, launches, by_kernel = 0.0, 0, {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            if t:
                us += t
                launches += ev.count
                by_kernel[ev.key[:80]] = t / 1000.0 / reps
        return us / 1000.0 / reps, launches / reps, by_kernel

    rows = {}
    for label, kind, shape in shapes(dtype):
        fn, library = call_for(kind, shape)
        try:  # an older tree may not take every shape
            fn()
            fn()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as e:
            rows[label] = {"error": str(e)[:200]}
            continue
        ms, per_call, by_kernel = device_ms(fn)
        rows[label] = {"device_ms": ms, "kernels_per_call": per_call, "by_kernel": by_kernel}
        if library is not None:
            library()
            torch.cuda.synchronize()
            rows[label]["library_device_ms"] = device_ms(library)[0]
    return {"tree": tree, "kind": torch.cuda.get_device_name(0), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=["."])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("f32", "bf16", "f16"), help="only the rows of this dtype")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.reps, args.dtype)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               "--reps", str(args.reps)]
                              + (["--dtype", args.dtype] if args.dtype else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print(f"card: {smi}")
    print("| shape | " + " | ".join(f"{r['tree']} device ms" for r in runs)
          + " | library device ms |")
    print("|---" * (len(runs) + 2) + "|")
    for label, _, _ in shapes(args.dtype):
        cells = [r["rows"][label].get("device_ms") for r in runs]
        lib = [r["rows"][label].get("library_device_ms") for r in runs]
        lib = [v for v in lib if v is not None]
        print(f"| {label} | " + " | ".join("error" if c is None else f"{c:.4f}" for c in cells)
              + " | " + ("-" if not lib else f"{min(lib):.4f}-{max(lib):.4f}") + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
