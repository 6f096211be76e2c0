#!/usr/bin/env python3
"""End-to-end walls of the PyTorch port on one CUDA card: the warm photo ->
depth-map PNG of ``pipeline.extract_depth``, several source trees compared
in one call, and (``--batch``) the directory of ``chip_smoke.py`` phase 9
at --batch-size=4 against 1 with a breakdown by stage.

    python3 scripts/torch_e2e_walls.py [--reps N] [--batch] [--stereogram] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this one,
another unpacked with ``git archive``); the trees run in the order given,
each in its own process, so ``build/parent . . build/parent`` times parent,
change, change, parent on one card. Each run: random DEPTH_PRO weights from
seed 0 in bf16, the synthetic 3024x4032 photo of ``chip_smoke.py`` phase 4
(decoded, as the phase passes it), two untimed calls (they build the
kernels), then ``--reps`` walls of ``extract_depth`` to a PNG, each ending
when the file is written.

``--batch`` (trees that have ``pipeline.extract_depth_batch``): the five
photos of phase 9 (as this checkout's ``chip_smoke.py`` makes them) written
to disk; the host wall of each photo's decode;
the stages of one photo timed apart (decode, preprocess and forward until
the card is done, ``prepare_output``, the writer); then ``cli.main`` over
the directory at --batch-size=4 and 1 in turns (4, 1, 1, 4) after one
warm-up each, with photos per second; and one more run of each with
``MATRIX_EYES_TIMINGS=1``, whose stage table is printed (its forward span
waits for the card, so its walls are not the pipelined ones). The CLI's
checkpoint reader is answered with the random weights.

``--stereogram``: after the depth-map walls, ``--reps`` walls each of
``extract_depth`` to the two stereogram PNGs of ``chip_smoke.py`` phase 7
at seed 7, the compact form (amplitude 1/16) and the device-resolved one
(amplitude 0.1, shifts over 255), two untimed calls of each first.

Prints one JSON line per run and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time


def _photo():
    """The synthetic photo of chip_smoke.py phase 4."""
    import numpy as np

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:3024, 0:4032]
    rgb = np.stack([xx * 255 // 4031, yy * 255 // 3023, (xx + yy) * 255 // 7054], -1)
    return (rgb + rng.randint(-20, 21, rgb.shape)).clip(0, 255).astype(np.uint8)


def _batch(params, src, out_dir: str) -> dict:
    import io

    import torch

    from matrix_eyes_tpu_torch import api, cli, pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.io.image import load_source_image
    from matrix_eyes_tpu_torch.output.depthmap import DepthMap
    from matrix_eyes_tpu_torch.pt import convert

    # this checkout's chip_smoke.py writes the photos, so every tree gets the same
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.OUT_DIR = out_dir
    photos = chip_smoke.write_photos(src)
    res = {"decode_s": {}}
    for p in photos:
        load_source_image(p)
        t0 = time.perf_counter()
        load_source_image(p)
        res["decode_s"][os.path.basename(p)] = time.perf_counter() - t0

    # the stages of one photo, apart
    dev = torch.device("cuda", 0)
    runtime = RuntimeConfig(device=dev)
    out = os.path.join(out_dir, "stages.png")
    stages = []
    for _ in range(3):
        t = [time.perf_counter()]
        s = load_source_image(photos[0])
        t.append(time.perf_counter())
        img = pipeline.preprocess_image(s.rgb, DEPTH_PRO.img_size, torch.bfloat16, dev)
        inv = pipeline.forward_batch(DEPTH_PRO, params, img, [s.f_norm()])
        dm = DepthMap.new(inv[0], s.original_size)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        write = dm.prepare_output(out, photos[0])
        t.append(time.perf_counter())
        write()
        t.append(time.perf_counter())
        stages.append({k: t[i + 1] - t[i] for i, k in enumerate(
            ("decode", "preprocess_forward", "prepare_output", "write"))})
    res["one_photo_stages_s"] = stages[1:]
    del runtime

    def weights(path, dtype, device, parts=convert.PARTS, cfg=None, **_policy):
        return DEPTH_PRO, {part: params[part] for part in parts}

    # the CLI's loader: pt.loader where the tree has it, else pt.convert's
    convert.load_checkpoint = api.load_checkpoint = weights
    if importlib.util.find_spec("matrix_eyes_tpu_torch.pt.loader") is not None:
        from matrix_eyes_tpu_torch.pt import loader

        loader.load_checkpoint = weights
    in_dir = os.path.dirname(photos[0])

    def run_dir(bs: int) -> float:
        d = os.path.join(out_dir, f"batch{bs}")
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        rc = cli.main(([f"--batch-size={bs}"] if bs > 1 else []) + [in_dir, d])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"cli.main at --batch-size={bs} exited {rc}")
        return time.perf_counter() - t0

    run_dir(4)
    run_dir(1)
    walls = {"4": [], "1": []}
    for bs in (4, 1, 1, 4):
        walls[str(bs)].append(run_dir(bs))
    res["dir_walls_s"] = walls
    res["dir_photos_per_s"] = {bs: [len(photos) / w for w in ws] for bs, ws in walls.items()}
    os.environ["MATRIX_EYES_TIMINGS"] = "1"
    res["timings_tables"] = {}
    for bs in (4, 1):
        table = io.StringIO()
        with contextlib.redirect_stderr(table):  # cli.main prints the table on exit
            run_dir(bs)
        res["timings_tables"][str(bs)] = table.getvalue()
    del os.environ["MATRIX_EYES_TIMINGS"]
    return res


def _stereogram(params, src, out_dir: str, reps: int) -> dict:
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat

    runtime = RuntimeConfig(device=torch.device("cuda", 0), seed=7)
    res = {}
    for form, amplitude in (("compact", 1 / 16), ("resolved", 0.1)):
        out = os.path.join(out_dir, f"stereogram_{form}.png")

        def once() -> float:
            t0 = time.perf_counter()
            pipeline.extract_depth(DEPTH_PRO, params, "synthetic-3024x4032", out,
                                   image_format=ImageOutputFormat.STEREOGRAM,
                                   stereo_amplitude=amplitude, runtime=runtime, source=src)
            return time.perf_counter() - t0

        first = [once() for _ in range(2)]
        walls = [once() for _ in range(reps)]
        res[f"stereogram_{form}"] = {"first_s": first, "walls_s": walls,
                                     "median_s": sorted(walls)[len(walls) // 2],
                                     "min_s": min(walls)}
    return res


def child(tree: str, reps: int, batch: bool, stereogram: bool) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig, configure_precision
    from matrix_eyes_tpu_torch.io.image import SourceImage
    from matrix_eyes_tpu_torch.models.init import init_params

    configure_precision()
    dev = torch.device("cuda", 0)
    params = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev,
                         torch.bfloat16)
    src = SourceImage(rgb=_photo(), original_size=(4032, 3024), focal_length_35mm=None)
    out_dir = os.path.join(root, "build", "e2e_walls")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "depthmap.png")
    runtime = RuntimeConfig(device=dev)

    def once() -> float:
        t0 = time.perf_counter()
        pipeline.extract_depth(DEPTH_PRO, params, "synthetic-3024x4032", out, runtime=runtime,
                               source=src)
        return time.perf_counter() - t0

    first = [once() for _ in range(2)]
    walls = [once() for _ in range(reps)]
    res = {"tree": tree, "first_s": first, "depthmap_png_walls_s": walls,
           "median_s": sorted(walls)[len(walls) // 2], "min_s": min(walls)}
    if stereogram:
        res.update(_stereogram(params, src, out_dir, reps))
    if batch:
        res.update(_batch(params, src, out_dir))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", action="store_true")
    ap.add_argument("--stereogram", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.reps, args.batch, args.stereogram)))
        return 0
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--reps", str(args.reps),
               tree] + (["--batch"] if args.batch and os.path.exists(
                   os.path.join(tree, "matrix_eyes_tpu_torch", "api.py")) else []) + (
                   ["--stereogram"] if args.stereogram else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}", file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        res = json.loads(line)
        tables = res.pop("timings_tables", {})
        print(json.dumps(res))
        for bs, table in tables.items():
            print(f"{tree} --batch-size={bs} MATRIX_EYES_TIMINGS table:\n{table}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
