#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 eyebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything it needs is found by name: its
configuration file (``configs``' ``file``), the architecture that file
names (``"architecture"``, ``depth_pro`` where it names none:
``eyebench/architectures/<name>.py`` builds the program's session and
gives the reference, the clamps and the FLOP ledger; see
``eyebench/harness/architecture.py``), its traffic mix
``eyebench/traffic/<traffic>.json`` and the generator module that mix
names, its limits ``eyebench/limits/<cell>.json``, and a reader
``eyebench/metrics/<metric>.py`` for every metric the cell reports. An
architecture with no file ends the run with exit 2 and no result.

A run: make the seeded photo pool (before the set-up clock), set up the
program (the architecture's session on weights made on the card from the
configuration's weights seed, the cell's programs warmed), drive the
traffic for ``--seconds``, read the memory peak, free the program,
compare a seeded sample of its outputs with the architecture's plain
reference, and print one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` (the window under the profiler) its
per-layer metrics, the device's busy time and a breakdown. The numbers
compared come last, beside their limits, on the JSON line and on the last
lines of standard error.

A measurement aid, not used by the benchmark's checks: ``--control`` judges
the configuration's control (``control`` in its file: the program under a
lower policy of its own, or the reference computed in a lower precision in
the program's place), which the comparison must refuse.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "matrix_eyes_tpu")


def fail(msg: str, code: int = 2) -> None:
    print(f"eyebench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    fail(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    path = os.path.join(ROOT, "eyebench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("eyebench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(ROOT, ".eyebench-cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: dict, config: dict, mix: dict, limits: dict, bench: dict, seed: int,
             seconds: float, trace: bool, device, chips: int, policy: str,
             tmpdir: str, out=print, control: Optional[str] = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object.
    ``device`` is the card in a benchmark run; the harness's own tests pass
    the CPU and a small configuration."""
    import torch

    from eyebench.harness import check, trace as trace_mod
    from eyebench.harness.cell import Context
    from eyebench.harness.photos import make_pool
    from eyebench.reference import image

    t = time.perf_counter()
    pool = mix["pool"]
    photos = make_pool(seed, os.path.join(tmpdir, "pool"), pool["n"], pool["width"],
                       pool["height"], pool["focal_mm"])
    rgb = [image.decode(p.path)[0] for p in photos] if mix.get("decoded") else None
    out(f"eyebench: {len(photos)} photos of {pool['width']}x{pool['height']} made in "
        f"{time.perf_counter() - t:.3f} s (before the set-up clock)")

    setup_t0 = time.perf_counter()
    ctx = Context(config=config, mix=mix, seed=seed, device=device, photos=photos,
                  tmpdir=tmpdir, trace=trace, policy=policy, rgb=rgb)
    gen = importlib.import_module(f"eyebench.traffic.{mix['generator']}")
    cellrun = gen.Cell(ctx)
    cellrun.setup()
    tracer = trace_mod.DeviceTrace() if trace else None
    if tracer is not None:
        tracer.start()
    ns_off = time.time_ns() - time.perf_counter_ns()
    w = cellrun.window(seconds)
    if tracer is not None:
        tracer.stop()
    if w.info:
        out(f"eyebench: {w.info}")
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_reserved(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"

    samples = cellrun.samples()
    cellrun.close()
    del cellrun
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(samples, config, device, control) if samples else {}
    rows = check.judge(numbers, limits["limits"], limits.get("optional", ()))
    held = [ok for _n, _v, _l, ok in rows if ok is not None]
    correct = bool(samples) and bool(held) and all(held)
    out(f"eyebench: {len(samples)} outputs compared with the reference in "
        f"{time.perf_counter() - t:.3f} s")

    run = types.SimpleNamespace(
        cell=cell, config=config, mix=mix, policy=policy, kind=kind, window=w,
        setup_s=w.t0 - setup_t0, peak_bytes=peak, window_s=w.t1 - w.t0,
        spans=ctx.spans.items, ops=[], lo_ns=0, hi_ns=0, busy_s=None)
    if tracer is not None:
        run.ops = tracer.ops
        run.lo_ns = int(w.t0 * 1e9) + ns_off
        run.hi_ns = int(w.t1 * 1e9) + ns_off
        run.busy_s = trace_mod.union_s(tracer.ops, run.lo_ns, run.hi_ns)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[group]:
        if applies(m, cell["name"]):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
        result["breakdown"] = trace_mod.breakdown(tracer.ops, ctx.spans.items, run.lo_ns,
                                                  run.hi_ns, mix.get("idle_default", "host"))
    result["compared"] = {n: {"value": _finite(v), "limit": l} for n, v, l, _ok in rows}
    shutil.rmtree(os.path.join(tmpdir, "pool"), ignore_errors=True)
    return result


def _finite(v):
    """JSON has no infinity: a number that is not finite reads 1e308."""
    return None if v is None else (v if math.isfinite(v) else 1e308)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = load_json("BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    centry = find(bench["configs"], cell["config"], "config")
    config = load_json(centry["file"])
    mix = load_json("eyebench", "traffic", cell["traffic"] + ".json")
    limits = load_json("eyebench", "limits", cell["name"] + ".json")
    # the control: the program under a lower policy of its own, or the
    # reference computed in a lower precision in the program's place
    ctrl = config["control"] if args.control else {}
    policy = ctrl.get("policy", config["dtype"])
    cache_dirs()

    from eyebench.harness import architecture

    try:
        architecture.of(config)
    except architecture.UnknownArchitecture as e:
        fail(f"config {centry['name']!r}: {e}")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    print(f"eyebench: {args.workload} seed {args.seed} policy {policy}; card: {card_line()}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    tmpdir = tempfile.mkdtemp(prefix="eyebench-")
    try:
        result = run_cell(cell, config, mix, limits, bench, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), cell["chips"], policy,
                          tmpdir, out=lambda s: print(s, flush=True),
                          control=ctrl.get("precision"))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}", 4)
    sys.stdout.flush()
    for name, v in result["compared"].items():
        print(f"eyebench: compared {name} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(f"eyebench: correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
