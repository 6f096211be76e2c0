#!/usr/bin/env python3
"""How large the CUDA-graph cache's shared memory pool grows: each forward
alone in a pool of its own against several forwards in one pool.

    python3 scripts/torch_graph_pool.py [--out build/graph_pool.json]

On one card, seeded random DEPTH_PRO weights (bf16, and f32 from the same
seed) and a seeded normalised image. Three forwards, called as the
pipeline calls them (``fwd_fov`` at one photo under bf16 and under f32,
``fwd_mixed_b4`` at four photos under bf16), each through an
``aot.GraphCache`` until it has captured its graph:

1. each forward alone, in a cache of its own (its own pool):
   the eager call's peak activation memory (``max_memory_allocated`` over
   the bytes held before it) and the pool's bytes after its capture;
2. the three in one pool, in phase 17's order (bf16 B=1, f32 B=1, bf16
   B=4), then in the reverse order: the pool's growth at each capture.

If a capture reuses what earlier captures of the pool freed, the shared
pool ends near the largest forward's pool alone; if not, near their sum.
Prints one line per capture and a JSON summary with the card's name and
power limit; ``--out`` also writes the summary.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import aot
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, configure_precision
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.models.init import init_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_graph_pool: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    configure_precision()
    cfg, dev = DEPTH_PRO, torch.device("cuda", 0)
    trees = {dt: init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, dtype)
             for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    x = np.random.RandomState(0).uniform(-1, 1, (4, cfg.img_size, cfg.img_size, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    imgs = {"bf16": x[:1].to(torch.bfloat16), "f32": x[:1], "bf16_b4": x.to(torch.bfloat16)}
    f4 = torch.ones(4, dtype=torch.float32, device=dev)
    has_f = torch.tensor([False, True, False, True], device=dev)
    fov = functools.partial(depth_pro.forward_with_fov, cfg)
    mixed = functools.partial(depth_pro.forward_with_mixed_fnorm, cfg)
    programs = {  # label: (program name, fn, args), as pipeline.forward_photo/_batch call them
        "bf16 B=1": ("fwd_fov", fov, (trees["bf16"], imgs["bf16"])),
        "f32 B=1": ("fwd_fov", fov, (trees["f32"], imgs["f32"])),
        "bf16 B=4": ("fwd_mixed_b4", mixed, (trees["bf16"], imgs["bf16_b4"], f4, has_f)),
    }

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def drop(cache) -> None:
        # the graphs go as if their weights had been freed; the pool's
        # memory returns to the allocator with them (free())
        for key in list(cache._live):
            cache._forget(key)

    summary = {"device": smi, "alone": {}, "shared": {}}
    for label, (name, fn, fargs) in programs.items():
        free()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with aot.disabled():
            out = fn(*fargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        del out
        cache = aot.GraphCache()
        for _ in range(2):
            cache.call(name, fn, fargs, repr(cfg))
        torch.cuda.synchronize()
        _n, seconds, growth = cache.captured[-1]
        pool = cache.backend.memory(dev)
        summary["alone"][label] = {"eager_peak_bytes": peak, "pool_bytes": pool,
                                   "capture_s": seconds}
        print(f"alone {label} ({name}): eager peak {peak / 2**20:.1f} MiB over what was held; "
              f"pool after its capture {pool / 2**20:.1f} MiB (growth {growth / 2**20:.1f}); "
              f"capture {seconds:.3f} s")
        drop(cache)
    for order_name, order in (("phase 17's order", ["bf16 B=1", "f32 B=1", "bf16 B=4"]),
                              ("reverse order", ["bf16 B=4", "f32 B=1", "bf16 B=1"])):
        free()
        cache = aot.GraphCache()
        steps = []
        for label in order:
            name, fn, fargs = programs[label]
            for _ in range(2):
                cache.call(name, fn, fargs, repr(cfg))
            torch.cuda.synchronize()
            _n, seconds, growth = cache.captured[-1]
            steps.append({"program": label, "growth_bytes": growth,
                          "pool_bytes": cache.backend.memory(dev)})
            print(f"shared, {order_name}: {label} ({name}) pool +{growth / 2**20:.1f} MiB -> "
                  f"{steps[-1]['pool_bytes'] / 2**20:.1f} MiB")
        summary["shared"][order_name] = steps
        drop(cache)
    alone = [v["pool_bytes"] for v in summary["alone"].values()]
    summary["largest_alone_bytes"], summary["sum_alone_bytes"] = max(alone), sum(alone)
    print(f"largest pool alone {max(alone) / 2**20:.1f} MiB, sum of the pools alone "
          f"{sum(alone) / 2**20:.1f} MiB")
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
