#!/usr/bin/env python3
"""Hold the sharded DEPTH_PRO forward over NCCL, one rank per card,
against the one-card forward on the same weights and image.

    python3 scripts/torch_mesh_check.py [--meshes 2x2,1x4,4x1] [--batch 1] [--runs 3]
    python3 scripts/torch_mesh_check.py --cli [--meshes 2x2,4x1]
    python3 scripts/torch_mesh_check.py --graphs [--meshes 2x2,1x4,4x1] [--out FILE]

Needs as many cards as the largest mesh (one rank per card, NCCL between
them: ``parallel.launch`` with its default devices). Seeded random
DEPTH_PRO weights (bf16, the card's default) are written once under
build/mesh_check/ and mapped by every rank, each moving only its cut to
its card; the image is a seeded normalised batch. The reference is the
same forward on one card in a world of one rank. For each mesh it prints
the inverse depth's and the FOV's gaps to the reference (max |diff| over
max |ref|, held to the bf16 gate 2e-2), every rank's launches by shape
and collectives (``collectives.check_forward`` raises on a broken
invariant), and each run's forward wall on every rank (host clock around
a synchronised forward; the first run includes the ranks' first calls).
The last line is a JSON summary with the card's name and power limit. It
exits 1 if a gap is outside the gate or a rank fails. These walls come
from one call at one batch size and are no benchmark cell.

``--cli`` runs the command line instead, one command per mesh: the port's
weight caches are written once by a cold ``cli.main(["--convert-checkpoints",
...])`` on one card (a stand-in .pt gives the stamp, the reader returns
the seeded canonical weights); warm one-card runs write the references;
then ``cli.main([f"--devices={mesh}", ...])`` on a photo (the first mesh)
and on a directory of five photos at ``--batch-size=4`` (every mesh), its
ranks loading the caches on the host. The photos, the bf16 gate and the
PNG gate are ``chip_smoke.py``'s (its phase-4 photo and phase-9 variants;
each PNG within a mean of ``PNG_MEAN_COUNTS`` u8 counts of the one-card
run's), and its walls are printed.

``--graphs`` runs the forwards through the mesh's CUDA-graph cache
(``parallel.checks.run_graph_cases``) at one photo with the FOV head
(``fwd_fov``) and at four (``fwd_mixed_b4``), on one card (1x1) and on
each mesh: every rank's forward eagerly, then warm-up, capture and replay,
the replay bit-equal to the eager call on every rank, the ranks' replays
equal, 72/24 launches and the layout's collectives on every call, the
replay within the bf16 gate of the one-card forward; then graphs against
eager in turns (graphs, eager, eager, graphs): per rank the forward's wall
by CUDA events over 10 calls (B=1; 3 at B=4), host
issue and host CPU per call, device time by ``torch.profiler`` (two calls
a mode; also by kernel family, NCCL's kernels apart, whose time includes
the wait for the other ranks), the capture's seconds and the graph pool's
bytes. ``--out``
writes the per-rank numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402  (the smoke's gates and photos)
    BF16_REL,
    PNG_MEAN_COUNTS,
    png_diff,
    rel_gap,
    synthetic_photo,
    write_photos,
)


def cli_check(meshes, out_dir: str) -> bool:
    """The ``--cli`` mode (module docstring). Returns whether every output
    held."""
    import time

    import torch

    from matrix_eyes_tpu_torch import cli
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.pt import convert

    photos = write_photos(synthetic_photo())
    pt = os.path.join(out_dir, "depth_pro.pt")
    with open(pt, "wb") as f:  # the stamp; the reader returns the weights
        f.write(b"stand-in for depth_pro.pt\n")
    canonical = init_params(DEPTH_PRO, torch.Generator(device="cuda").manual_seed(0), "cuda")
    real_read = convert.read_checkpoint
    convert.read_checkpoint = lambda path, parts=convert.PARTS, cfg=None: (
        DEPTH_PRO, {p: canonical[p] for p in parts})
    base = [f"--checkpoint-path={pt}"]
    try:
        t0 = time.perf_counter()
        ok = cli.main(["--convert-checkpoints", *base, photos[0],
                       os.path.join(out_dir, "cold.png")]) == 0
        print(f"one card, cold (writes the caches): {time.perf_counter() - t0:.3f} s")
    finally:
        convert.read_checkpoint = real_read
    del canonical
    torch.cuda.empty_cache()
    # the references: one card, warm (the caches' f16 convention, as the ranks)
    one = os.path.join(out_dir, "one")
    os.makedirs(one, exist_ok=True)
    for name, argv in (("one photo", [photos[0], os.path.join(one, "single.png")]),
                       ("--batch-size=4", ["--batch-size=4", os.path.dirname(photos[0]), one])):
        t0 = time.perf_counter()
        ok &= cli.main([*base, *argv]) == 0
        print(f"one card, warm, {name}: {time.perf_counter() - t0:.3f} s")
    for i, (data, model) in enumerate(meshes):
        runs = [("dir", ["--batch-size=4", os.path.dirname(photos[0])])]
        if i == 0:
            runs.insert(0, ("single", [photos[0]]))
        for name, argv in runs:
            out = os.path.join(out_dir, f"{name}_{data}x{model}")
            os.makedirs(out, exist_ok=True)
            dest = os.path.join(out, "single.png") if name == "single" else out
            t0 = time.perf_counter()
            rc = cli.main([*base, f"--devices={data}x{model}", *argv, dest])
            wall = time.perf_counter() - t0
            names = [os.path.splitext(os.path.basename(p))[0] + ".png" for p in photos]
            pairs = ([(dest, os.path.join(one, "single.png"))] if name == "single" else
                     [(os.path.join(out, k), os.path.join(one, k)) for k in names])
            counts = [png_diff(a, b)[::2] for a, b in pairs]
            held = rc == 0 and all(mean <= PNG_MEAN_COUNTS for mean, _max in counts)
            ok &= held
            print(f"cli --devices={data}x{model} ({name}): exit {rc}, {wall:.3f} s with the "
                  f"ranks' start-up, PNGs against one card (mean, max counts) {counts} "
                  f"{'ok' if held else 'FAIL'}")
    return ok


def graphs_check(meshes, weights: str, img4, out: str) -> bool:
    """The ``--graphs`` mode (module docstring). Returns whether every
    check held."""
    import torch

    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.parallel import launch
    from matrix_eyes_tpu_torch.parallel.checks import run_graph_cases

    cfg = DEPTH_PRO
    cases = [dict(cfg=cfg, params=weights, img=img4[:1], timing=10),
             dict(cfg=cfg, params=weights, img=img4, timing=3)]
    ok, refs, report = True, {}, {}
    for data, model in [(1, 1)] + list(meshes):
        ranks = launch(run_graph_cases, (data, model), cases, timeout=900)
        for i, case in enumerate(cases):
            got = [r["cases"][i] for r in ranks]
            tag = f"{data}x{model} B={case['img'].shape[0]}"
            held = all(r["backend"] == "nccl" and not r["foreign_modules"] for r in ranks)
            for g in got:
                modes = [c["mode"] for c in g["calls"]]
                launches = [(c["kernels"]["attention_qkv"], c["kernels"]["conv3x3"])
                            for c in g["calls"]]
                replay = g["calls"][3]["report"]["collectives"]
                g_ok = (modes == ["eager", "eager", "capture", "replay"] and g["bit_equal"]
                        and launches == [(3 * cfg.depth, 24)] * 4
                        and all(c["report"]["collectives"] == replay for c in g["calls"]))
                held &= g_ok
                t = g["timing"]
                print(f"{tag} rank {g['rank']} {g['calls'][0]['program']}: modes {modes}; "
                      f"replay bit-equal to eager {g['bit_equal']}; launches per call "
                      f"{launches}; collectives per replay (calls, bytes) "
                      f"{ {k: (v['calls'], v['bytes']) for k, v in replay.items()} }; capture "
                      f"{g['capture_s']:.3f} s, pool +{g['capture_pool_growth'] / 2**20:.1f} MiB,"
                      f" graph pool {g['pool_bytes'] / 2**30:.3f} GiB "
                      f"{'ok' if g_ok else 'FAIL'}")
                for mode in ("graphs", "eager"):
                    runs, dev = t["runs"][mode], t["device"][mode]
                    print(f"{tag} rank {g['rank']} {mode}: wall ms "
                          f"{[round(x['wall_ms'], 3) for x in runs]}, host issue ms "
                          f"{[round(x['issue_ms'], 3) for x in runs]}, host CPU ms "
                          f"{[round(x['host_cpu_ms'], 2) for x in runs]}; device ms {dev[0]:.3f} "
                          f"in {dev[1]:.0f} kernels, {dev[2]:.0f} graph launches per call; by "
                          f"family {{{', '.join(f'{k}: {v:.3f}' for k, v in sorted(dev[3].items()))}}}")
            same = all(torch.equal(g["inv"], got[0]["inv"]) for g in got)
            if (data, model) == (1, 1):
                refs[i] = got[0]["inv"]
            gap = rel_gap(got[0]["inv"], refs[i])
            held &= same and gap <= BF16_REL
            ok &= held
            print(f"{tag}: ranks' replays equal {same}; gap to one card {gap:.3e} (gate "
                  f"{BF16_REL:g}) {'ok' if held else 'FAIL'}")
            report[tag] = [{k: g[k] for k in ("rank", "bit_equal", "capture_s",
                                              "capture_pool_growth", "pool_bytes", "timing")}
                           | {"modes": [c["mode"] for c in g["calls"]],
                              "collectives": g["calls"][3]["report"]["collectives"]}
                           for g in got] + [{"gap_to_one_card": gap, "ranks_equal": same,
                                             "ok": held}]
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return ok


def main(argv=None) -> int:
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch.config import DEPTH_PRO, configure_precision
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.models.spec import tree_map
    from matrix_eyes_tpu_torch.parallel import launch
    from matrix_eyes_tpu_torch.parallel.checks import run_cases

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", default="2x2,1x4,4x1")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cli", action="store_true", help="run the command line per mesh")
    ap.add_argument("--graphs", action="store_true",
                    help="the forwards through the mesh's CUDA-graph cache against eager")
    ap.add_argument("--out", default=None, help="--graphs: write the numbers as JSON here")
    args = ap.parse_args(argv)
    meshes = [tuple(int(d) for d in m.split("x")) for m in args.meshes.split(",")]
    if not torch.cuda.is_available():
        print("torch_mesh_check: no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    need = max(d * m for d, m in meshes)
    if need > cards:
        print(f"torch_mesh_check: the meshes need {need} cards, {cards} visible",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print(f"cards: {smi}")
    configure_precision()
    cfg = DEPTH_PRO
    out_dir = os.path.join(ROOT, "build", "mesh_check")
    os.makedirs(out_dir, exist_ok=True)
    if args.cli:
        ok = cli_check(meshes, out_dir)
        print(json.dumps({"device": smi, "cli": ok}))
        return 0 if ok else 1
    weights = os.path.join(out_dir, "weights_bf16.pt")
    dev = torch.device("cuda", 0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    torch.save(tree_map(lambda _p, t: t.cpu(), params), weights)
    del params
    torch.cuda.empty_cache()
    img = np.random.RandomState(0).uniform(
        -1, 1, (4 if args.graphs else args.batch, cfg.img_size, cfg.img_size, 3))
    img = torch.from_numpy(img.astype(np.float32)).to(torch.bfloat16)
    if args.graphs:
        try:
            ok = graphs_check(meshes, weights, img, args.out)
        finally:
            os.remove(weights)
        print(json.dumps({"device": smi, "graphs": ok}))
        return 0 if ok else 1
    case = dict(cfg=cfg, params=weights, img=img, runs=args.runs)
    summary = {"device": smi, "batch": args.batch, "meshes": {}}
    failed = False
    try:
        (ref,) = launch(run_cases, (1, 1), [case], timeout=900)
        ref = ref["cases"][0]
        print(f"1x1 on one card: forward walls s {[round(w, 4) for w in ref['walls']]}")
        summary["meshes"]["1x1"] = {"walls": ref["walls"]}
        for data, model in meshes:
            ranks = launch(run_cases, (data, model), [case], timeout=900)
            got = [r["cases"][0] for r in ranks]
            inv_gap = rel_gap(got[0]["inv"], ref["inv"])
            fov_gap = rel_gap(got[0]["fov"], ref["fov"])
            same = all(torch.equal(g["inv"], got[0]["inv"]) for g in got)
            ok = max(inv_gap, fov_gap) <= BF16_REL and same and all(
                r["backend"] == "nccl" and not r["foreign_modules"] for r in ranks)
            failed |= not ok
            for g in got:
                print(f"{data}x{model} rank {g['rank']} on {g['device']}: launches "
                      f"{g['kernels']['attention_by_shape']} conv3x3 by N "
                      f"{g['kernels']['conv3x3_by_batch']}; collectives "
                      f"{g['report']['collectives']}; patch rows "
                      f"{g['report']['patch_rows_per_rank']}; forward walls s "
                      f"{[round(w, 4) for w in g['walls']]}")
            print(f"{data}x{model} over NCCL on {data * model} cards: inverse depth gap "
                  f"{inv_gap:.3e}, fov gap {fov_gap:.3e} (gate {BF16_REL:g}); ranks equal: "
                  f"{same} {'ok' if ok else 'FAIL'}")
            summary["meshes"][f"{data}x{model}"] = {
                "inv_gap": inv_gap, "fov_gap": fov_gap, "ranks_equal": same,
                "walls_by_rank": [g["walls"] for g in got],
                "collectives": got[0]["report"]["collectives"], "ok": ok}
    finally:
        os.remove(weights)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
