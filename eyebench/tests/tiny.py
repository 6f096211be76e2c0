"""Small versions of the benchmark's cells for the CPU: Depth Pro at the
port's TINY widths, photos of 160x120, the port on the CPU in float32."""

from __future__ import annotations

import copy
import json
import os

from eyebench.tests.conftest import ROOT

TINY = dict(vit_img_size=128, patch_size=16, depth=2, embed_dim=16, num_heads=2, mlp_ratio=4,
            layer_norm_eps=1e-6, encoder_feature_dims=[8, 12, 16, 16], decoder_features=8,
            head_last_dims=[4, 1], highres_block_ids=[0, 1])
MID = dict(vit_img_size=128, patch_size=16, depth=4, embed_dim=128, num_heads=4, mlp_ratio=4,
           layer_norm_eps=1e-6, encoder_feature_dims=[64, 96, 128, 128], decoder_features=64,
           head_last_dims=[16, 1], highres_block_ids=[1, 3])


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def bench():
    return load("BENCHMARK.json")


def cell(name: str, model=TINY):
    """(workload, config, mix, limits) of a cell, cut for the CPU."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == name)
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    config = copy.deepcopy(load(c["file"]))
    config["model"] = dict(model)
    config["weights"] = "f32"
    mix = load("eyebench", "traffic", w["traffic"] + ".json")
    mix["pool"].update(width=160, height=120)
    limits = load("eyebench", "limits", name + ".json")
    return w, config, mix, limits


def run(name: str, tmp_path, seconds: float = 1.0, seed: int = 2**31 + 5, model=TINY):
    import torch

    from eyebench import run as runner

    w, config, mix, limits = cell(name, model)
    return runner.run_cell(w, config, mix, limits, bench(), seed, seconds, False,
                           torch.device("cpu"), 1, "f32", str(tmp_path), out=lambda _s: None)
