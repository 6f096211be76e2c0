#!/usr/bin/env python3
"""conv3x3 on one CUDA card, shape by shape of ``chip_smoke.py``'s
``CONV_SHAPES``, from the source tree TREE (default: this checkout; a
variant unpacked elsewhere runs the same way).

    python3 scripts/torch_conv_check.py [--dtype f32|bf16] [--splits] [TREE]

For every shape: the kernel against its plain version (max abs and
relative error, and how many outputs fall outside the f32 tolerance, rtol
1e-4 / atol 1e-5, which says whether an error is one outlier or a bias),
and its warm time by CUDA events beside ``F.conv2d``'s. With ``--splits``,
for the shapes of the forward and of a batch of four photos instead: the
device time (``torch.profiler``)
at every K split the kernel takes, the plan's own first, and for bf16 at
the other output-channel tile (128 or 256) with the plan's split; the data
that the cost model of ``ops/conv3x3.py::plan`` is fitted to. Exits 1 if a shape
disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, reps: int = 20) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
             for ev in prof.key_averages())
    return us / 1000.0 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--dtype", choices=("f32", "bf16"), help="only the shapes of this dtype")
    ap.add_argument("--splits", action="store_true", help="device time at every K split")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_conv_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from matrix_eyes_tpu_torch.config import configure_precision
    from matrix_eyes_tpu_torch.ops import conv3x3 as m

    configure_precision()
    print(chip_smoke.nvidia_smi_line(), f"tree {os.path.abspath(args.tree)}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    bad = 0
    for B, H, W, cin, cout, dt, relu_in, n_skips, has_bias, launches in chip_smoke.CONV_SHAPES:
        if (args.dtype and dt != args.dtype) or (args.splits and not (launches or B == 4)):
            continue
        dtype = dtypes[dt]
        x = torch.randn(B, H, W, cin, device=dev, generator=gen).to(dtype)
        w = (torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5).to(dtype)
        b = torch.randn(cout, device=dev, generator=gen).to(dtype) if has_bias else None
        skips = [torch.randn(B, H, W, cout, device=dev, generator=gen).to(dtype)
                 for _ in range(n_skips)] + [None] * (2 - n_skips)
        shape = f"{B}x{H}x{W} {cin}->{cout} {dt} relu_in={relu_in} skips={n_skips}"
        if args.splits:
            plan = m.plan
            planned = plan(B, H, W, cin, cout, 132, dtype)
            steps = 9 * math.ceil(cin / m._STEP[dtype][0])
            times = []
            for s in [planned.splits] + [s for s in range(1, 17) if s != planned.splits]:
                if s > steps or math.ceil(steps / math.ceil(steps / s)) != s:
                    continue  # the kernel refuses a split left empty
                m.plan = lambda *_a, s=s: planned._replace(splits=s)  # the wrapper's plan
                times.append(f"{s}:{device_ms(lambda: m.conv3x3(x, w, b, *skips, relu_in)):.4f}")
            if dtype == torch.bfloat16 and cout > 128:  # the other N tile, the plan's split
                other = 384 - planned.bn
                m.plan = lambda *_a: planned._replace(bn=other)
                times.append(f"bn{other}:{device_ms(lambda: m.conv3x3(x, w, b, *skips, relu_in)):.4f}")
            m.plan = plan
            print(f"{shape}: device ms by split (plan's first, bn {planned.bn}) "
                  f"{' '.join(times)}", flush=True)
            continue
        got = m.conv3x3(x, w, b, skips[0], skips[1], relu_in)
        want = m.conv3x3_plain(x, w, b, skips[0], skips[1], relu_in)
        res = chip_smoke.compare(got, want, dtype)
        g, r = got.float(), want.float()
        outside = int(((g - r).abs() > chip_smoke.F32_ATOL + chip_smoke.F32_RTOL * r.abs()).sum())
        reps = 5 if H * W > 100_000 else 20
        ms = chip_smoke.time_ms(lambda: m.conv3x3(x, w, b, skips[0], skips[1], relu_in), reps)
        xc = x.permute(0, 3, 1, 2)  # NHWC storage: the channels-last view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = chip_smoke.time_ms(lambda: F.conv2d(xc, wc, b, padding=1), reps)
        print(f"{shape}: max_abs={res['max_abs_err']:.3e} max_rel={res['max_rel_err']:.3e} "
              f"outside f32 tolerance {outside} of {r.numel()} ms={ms:.4f} "
              f"F.conv2d={lib:.4f} {'ok' if res['ok'] else 'FAIL'}", flush=True)
        bad += not res["ok"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
