"""The numbers that decide ``correct``, read on the card for many seeds in
one process: what the limits of ``eyebench/limits/<cell>.json`` are set
from (PERF.md, "What decides correct").

    python -m eyebench.tests.readings --workload <cell> --seeds 1 2 3 \\
        --variant program|control|reference=<precision>|attention|policy=<p> \
        [--seconds 4]

``program`` runs the cell as the benchmark does; ``control`` judges the
configuration's control in the program's place (``run.py --control``);
``reference=<precision>`` the reference computed in that precision
(``fp8``, ``fp8_vit``: ``eyebench.reference.model.computed_in``) in the
program's place; ``attention`` runs the program with its attention's
1/sqrt(d) scale dropped; ``policy=<p>`` runs the program under its
``--dtype p`` policy.
Each seed prints one JSON line: the seed, the variant, ``correct`` and
every number compared. The runs share a process, so their set-up and
memory readings are not the benchmark's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile

from eyebench import run as runner
from eyebench.tests.faults import attention_unscaled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    bench = runner.load_json("BENCHMARK.json")
    cell = runner.find(bench["workloads"], args.workload, "workload")
    config = runner.load_json(runner.find(bench["configs"], cell["config"], "config")["file"])
    mix = runner.load_json("eyebench", "traffic", cell["traffic"] + ".json")
    limits = runner.load_json("eyebench", "limits", cell["name"] + ".json")
    policy, control, fault = config["dtype"], None, contextlib.nullcontext
    if args.variant == "control":
        policy = config["control"].get("policy", policy)
        control = config["control"].get("precision")
    elif args.variant.startswith("reference="):
        control = args.variant.split("=", 1)[1]
    elif args.variant == "attention":
        fault = attention_unscaled
    elif args.variant.startswith("policy="):
        policy = args.variant.split("=", 1)[1]
    elif args.variant != "program":
        runner.fail(f"no variant {args.variant!r}")
    runner.cache_dirs()

    import torch

    if not torch.cuda.is_available():
        runner.fail("needs an NVIDIA card", 3)
    for seed in args.seeds:
        tmpdir = tempfile.mkdtemp(prefix="eyebench-")
        try:
            with fault():
                res = runner.run_cell(cell, config, mix, limits, bench, seed, args.seconds, False,
                                      torch.device("cuda", 0), 1, policy, tmpdir,
                                      out=lambda _s: None, control=control)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        print(json.dumps({"seed": seed, "variant": args.variant, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "numbers": {k: v["value"] for k, v in res["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
