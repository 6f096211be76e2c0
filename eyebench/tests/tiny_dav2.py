"""The ``depth_anything_v2`` cell cut for the CPU: Depth Anything V2 at tiny
widths on frames of 160x96, the port on the CPU in float32."""

from __future__ import annotations

import copy

from eyebench.tests.tiny import bench, load

CELL = "depth_anything_v2-l-bf16.frames-b8"
DAV2_TINY = dict(input_size=70, patch_size=14, depth=4, embed_dim=32, num_heads=2, mlp_ratio=4,
                 layer_norm_eps=1e-6, taps=[0, 1, 2, 3], features=16, out_channels=[8, 16, 32, 32],
                 head_widths=[8, 8], use_bn=False, use_clstoken=False, frame=[160, 96])


def cell(name: str = CELL, model=DAV2_TINY):
    """(workload, config, mix, limits) of a cell, cut for the CPU."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == name)
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    config = copy.deepcopy(load(c["file"]))
    config["model"] = dict(model)
    config["weights"] = "f32"
    mix = load("eyebench", "traffic", w["traffic"] + ".json")
    width, height = model["frame"]
    mix["pool"].update(width=width, height=height)
    limits = load("eyebench", "limits", name + ".json")
    return w, config, mix, limits


def run(tmp_path, name: str = CELL, seconds: float = 1.0, seed: int = 2**31 + 5,
        model=DAV2_TINY):
    import torch

    from eyebench import run as runner

    w, config, mix, limits = cell(name, model)
    return runner.run_cell(w, config, mix, limits, bench(), seed, seconds, False,
                           torch.device("cpu"), 1, "f32", str(tmp_path), out=lambda _s: None)
