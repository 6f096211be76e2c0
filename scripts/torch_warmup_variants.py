#!/usr/bin/env python3
"""Start to the first PNG of a fresh process under variants of the CLI's
warm-up thread (``aot.prefetch_async``), from the port's weight caches.

    python3 scripts/torch_warmup_variants.py [--rounds 2] [--out r.json]

On the card. Seeded random DEPTH_PRO weights (phase 4's seed of
``chip_smoke.py``) are written once as the port's bf16 weight caches under
build/warmup_variants/ (a stand-in .pt gives the stamp; a cold
``cli.main(["--convert-checkpoints", ...])`` with the reader answered by
the weights); then each variant runs ``cli.main`` on the phase-4 photo in
a fresh ``python -c`` process, ``MATRIX_EYES_TIMINGS=1``, the variants in
turns (forward order, then reversed):

* ``off``: ``MATRIX_EYES_AOT=off``, no warm-up thread;
* ``thread``: the port's ``prefetch_async`` (the CUDA context, the kernel
  libraries and their kernels on a thread during the weight load);
* ``thread_with_handles``: the same thread also making the cuBLAS,
  cuBLASLt and cuDNN handles (bf16, f16 and f32 GEMMs, an f32 conv);
* ``serial``: that fuller warm-up on the main thread, before the load.

Per run it prints the process's wall from spawn to exit, the time to its
first line (``import`` included) and its stage table (weights to the
card, preprocess, forward, output, process total). The last line is a
JSON summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("off", "thread", "thread_with_handles", "serial")

# the child: cli.main with the variant's warm-up
CHILD = r"""
import os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, os.environ["ME_ROOT"])
import torch
import torch.nn.functional as F
from matrix_eyes_tpu_torch import aot, cli

def with_handles(device):
    with torch.cuda.device(device):
        x = torch.ones(16, 16, device=device)
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            y = x.to(dt)
            y @ y
            F.linear(y, y, y[0])
        F.conv2d(x[None, None], x[None, None, :3, :3], stride=2)
    real_warm_up(device)

real_warm_up = aot._warm_up
variant = os.environ["ME_VARIANT"]
if variant == "thread_with_handles":
    aot._warm_up = with_handles
elif variant == "serial":
    aot.prefetch_async = lambda device: with_handles(torch.device(device))
print(f"started {time.perf_counter() - t0:.3f}", flush=True)
rc = cli.main(sys.argv[1:])
print(f"total {time.perf_counter() - t0:.3f} rc {rc}", flush=True)
sys.exit(rc)
"""


def stage_table(stderr: str) -> dict:
    """The ``MATRIX_EYES_TIMINGS`` table's rows, seconds by stage; the
    weights' rows summed."""
    table = {}
    for line in stderr.splitlines():
        name, _, value = line.strip().rpartition("  ")
        if line.startswith("  ") and value.endswith(" s"):
            table[name.strip()] = float(value[:-2])
    weights = sum(v for k, v in table.items() if k.startswith("weights "))
    keep = ("preprocess (device)", "model forward", "write output", "process total")
    return {"weights": round(weights, 3), **{k: table[k] for k in keep if k in table}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_warmup_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi_line, synthetic_photo, write_photos
    from matrix_eyes_tpu_torch import cli
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, configure_precision
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.pt import convert

    configure_precision()
    dev = torch.device("cuda", 0)
    d = os.path.join(ROOT, "build", "warmup_variants")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    photo = write_photos(synthetic_photo())[0]
    pt = os.path.join(d, "depth_pro.pt")
    with open(pt, "wb") as f:  # the stamp; the reader returns the weights
        f.write(b"stand-in for depth_pro.pt\n")
    canonical = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev,
                            torch.float32)
    real_read = convert.read_checkpoint
    convert.read_checkpoint = lambda path, parts=convert.PARTS, cfg=None: (
        DEPTH_PRO, {p: canonical[p] for p in parts})
    try:
        out = os.path.join(d, "cold.png")
        if cli.main(["--convert-checkpoints", f"--checkpoint-path={pt}", photo, out]) != 0:
            return 1
    finally:
        convert.read_checkpoint = real_read
    del canonical
    torch.cuda.empty_cache()

    runs = {v: [] for v in VARIANTS}
    for r in range(args.rounds):
        for variant in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
            env = dict(os.environ, ME_ROOT=ROOT, ME_VARIANT=variant, MATRIX_EYES_TIMINGS="1",
                       MATRIX_EYES_AOT="off" if variant == "off" else "on")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", CHILD, f"--checkpoint-path={pt}", photo,
                                   os.path.join(d, f"{variant}.png")],
                                  env=env, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
                return proc.returncode
            started = float(proc.stdout.split("started ")[1].split()[0])
            row = {"wall_s": round(wall, 3), "import_s": started, **stage_table(proc.stderr)}
            runs[variant].append(row)
            print(f"{variant}: {row}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    report = {"metric": "start_to_first_png_s", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi_line(), "runs": runs}
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
