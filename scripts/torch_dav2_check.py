#!/usr/bin/env python3
"""Depth Anything V2 Large on one CUDA card, and Depth Pro's forward for a
bit-equality check between source trees.

    python3 scripts/torch_dav2_check.py dav2 [--batch 8] [--out FILE] [--tiny]
    python3 scripts/torch_dav2_check.py depth_pro TREE OUT.npz
    python3 scripts/torch_dav2_check.py same A.npz B.npz

``dav2``: the published Large on the benchmark's seeded bf16 weights
(``eyebench/reference/depth_anything_v2.py``, ``weights_seed`` 7) through
``MatrixEyes.inverse_depth_batch`` over ``--batch`` synthetic 1920x1080
frames, three calls (eager, capture, replay: the replay must equal the
eager call bit for bit), the launches by shape and K/V path of one call,
the wall of ten replayed calls between CUDA events, the peak memory, and
each frame's gaps to the f32 reference (TF32 off): ``inv_gap`` (largest
difference over the largest value) and ``inv_mean_gap`` (mean over mean),
and the events time of the position embedding's interpolation and of one
frame's preprocess (upload and ``dav2_preprocess``).
One JSON line, also written to ``--out``. ``--tiny`` rehearses it on the
CPU at the benchmark tests' tiny widths on 160x96 frames.

``depth_pro``: from TREE's root (run in its own process, as trees hold
packages of one name), the bf16 Depth Pro session of the benchmark's
``depth_pro-bf16`` configuration on two seeded 12 MP photos: one photo
with its focal length (``fwd_fnorm_b1``) and four, two without
(``fwd_mixed_b4``), each called three times; the third calls' results
to OUT.npz. ``same`` compares two such files bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _frames(n: int, w: int, h: int, seed: int):
    import numpy as np

    from eyebench.harness.photos import scene

    return [scene(np.random.default_rng([seed, i]), w, h) for i in range(n)]


def run_dav2(batch: int, out: str, tiny: bool = False) -> dict:
    import numpy as np
    import torch

    from eyebench.harness import architecture
    from eyebench.reference import depth_anything_v2 as ref
    from matrix_eyes_tpu_torch import aot, api
    from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv

    config = json.load(open(os.path.join(ROOT, "eyebench", "configs",
                                         "depth_anything_v2-l-bf16.json")))
    if tiny:
        from eyebench.tests.tiny_dav2 import DAV2_TINY

        config["model"] = dict(DAV2_TINY)
    model = config["model"]
    dev = torch.device("cpu" if tiny else "cuda", 0)
    cfg = architecture.of(config).model_config(config)
    served = torch.float32 if tiny else torch.bfloat16

    def answer(_path, dtype, device, **_kw):
        return cfg, ref.make_weights(model, config["weights_seed"], device, served)

    real = api.load_checkpoint
    api.load_checkpoint = answer
    try:
        me = api.MatrixEyes("random weights", dtype="f32" if tiny else "bf16", device=dev,
                            cfg=cfg)
    finally:
        api.load_checkpoint = real
    frames = _frames(batch, *model["frame"], seed=11)
    res = {"card": _card(), "torch": torch.__version__, "batch": batch}
    outs = []
    for _ in range(3):
        attention_qkv.launches_by_shape.clear()
        conv3x3.launches_by_shape.clear()
        outs.append(me.inverse_depth_batch(frames))
    res["modes"] = [m for _n, m in list(aot.cache().modes)[-6:]]
    res["shape"] = list(outs[-1].shape)
    res["replay_equals_eager"] = bool(np.array_equal(outs[0], outs[2]))
    res["attention_by_shape"] = {str(k): v for k, v in attention_qkv.launches_by_shape.items()}
    res["conv3x3_by_shape"] = {str(k[:5] + k[6:]): v for k, v in conv3x3.launches_by_shape.items()}
    if not tiny:
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        t0.record()
        for _ in range(10):
            me.inverse_depth_batch(frames)
        t1.record()
        torch.cuda.synchronize()
        res["call_ms_events"] = t0.elapsed_time(t1) / 10
        res["call_ms_wall"] = (time.perf_counter() - t) * 100
        res["frames_per_s"] = batch * 1000 / res["call_ms_wall"]
        res["peak_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    if not tiny:
        from matrix_eyes_tpu_torch.models import vit

        pe = me.params["pretrained"]["pos_embed"]
        gh, gw = res["shape"][1] // cfg.patch_size, res["shape"][2] // cfg.patch_size
        for name, fn in (("pos_embed_interpolation_ms",
                          lambda: vit.interpolate_pos_embed(pe, gh, gw)),
                         ("frame_preprocess_ms",
                          lambda: me._preprocess(me._load(frames[0], None)))):
            fn()
            torch.cuda.synchronize()
            t0.record()
            for _ in range(20):
                fn()
            t1.record()
            torch.cuda.synchronize()
            res[name] = t0.elapsed_time(t1) / 20
    params = ref.make_weights(model, config["weights_seed"], dev, served)
    gaps = []
    for i, rgb in enumerate(frames[:2]):
        want = ref.inverse_depth(model, params, rgb, dev).cpu().numpy().astype(np.float64)
        got = outs[-1][i].astype(np.float64)
        gaps.append({"inv_gap": float(np.abs(got - want).max() / np.abs(want).max()),
                     "inv_mean_gap": float(np.abs(got - want).mean() / np.abs(want).mean()),
                     "ref_range": [float(want.min()), float(want.max())]})
    res["gaps"] = gaps
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return res


def run_depth_pro(tree: str, out: str) -> None:
    """In a child process from ``tree``'s root: its own packages."""
    code = r'''
import json, sys, types
import numpy as np, torch
from eyebench.harness import architecture
from eyebench.harness.photos import scene
config = json.load(open("eyebench/configs/depth_pro-bf16.json"))
ctx = types.SimpleNamespace(config=config, policy="bf16", device=torch.device("cuda", 0))
me = architecture.of(config).session(ctx)
photos = [scene(np.random.default_rng([5, i]), 4032, 3024) for i in range(4)]
got = {}
for name, rgbs, focal in (("b1", photos[:1], [28.0]), ("b4", photos, [28.0, None, 50.0, None])):
    for _ in range(3):
        inv = me.inverse_depth_batch(rgbs, focal)
    got[name] = inv
np.savez(sys.argv[1], **got)
print(json.dumps({k: [list(v.shape), float(v.mean())] for k, v in got.items()}), flush=True)
'''
    subprocess.run([sys.executable, "-c", code, os.path.abspath(out)], cwd=tree, check=True)


def same(a: str, b: str) -> bool:
    import numpy as np

    x, y = np.load(a), np.load(b)
    res = {k: bool(np.array_equal(x[k], y[k])) for k in x.files}
    print(json.dumps({"bit_equal": res}), flush=True)
    return all(res.values()) and set(x.files) == set(y.files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dav2")
    d.add_argument("--batch", type=int, default=8)
    d.add_argument("--out", default="")
    d.add_argument("--tiny", action="store_true")
    p = sub.add_parser("depth_pro")
    p.add_argument("tree")
    p.add_argument("out")
    s = sub.add_parser("same")
    s.add_argument("a")
    s.add_argument("b")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if args.cmd == "dav2":
        run_dav2(args.batch, args.out, args.tiny)
    elif args.cmd == "depth_pro":
        run_depth_pro(args.tree, args.out)
    else:
        return 0 if same(args.a, args.b) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
