"""Command-line interface of the PyTorch port: the reference grammar.

* options are only recognised before the first positional argument;
* a flag without ``=`` -> usage + exit 2; an unknown ``--flag`` prints
  "Unsupported argument" to stderr and does not abort;
* more than two positionals, or a missing one -> usage + exit 2;
  ``--help`` -> usage + exit 0;
* reconstruction failure -> message + exit 1.

The port writes a viridis depth map, an autostereogram or an OBJ/PLY mesh,
for one photo or (a directory source) for every photo of a directory,
``--batch-size`` photos per forward, under every dtype policy of the JAX
package (``--dtype=f32|bf16|f16|int8|mixed``). ``--convert-checkpoints``
writes the weight caches beside the checkpoint (``pt/loader.py``), which
later runs load without reading the ``.pt``. ``--devices=N|DATAxMODEL``
runs the whole pipeline sharded over a mesh of N = DATA x MODEL cards, one
process per card (``parallel/``), from this one command: rank 0 writes the
output and the command exits with its code. ``--profile=DIR`` writes a
``torch.profiler`` trace of a one-device run (host and card) into DIR
(``--devices`` ranks are processes of their own and are not traced). The JAX
package's ``--no-flash-attention`` exits 2 with a message saying so: the
port has no kill switch. ``MATRIX_EYES_TIMINGS=1`` prints a stage table to
stderr on exit.

The kernel libraries are built (where ``_build/`` lacks them) and loaded by
the first program that launches their kernels; ``MATRIX_EYES_AOT=off`` runs
every program eagerly, without CUDA graphs.
"""

from __future__ import annotations

import contextlib
import os
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

from matrix_eyes_tpu_torch import __version__

USAGE_INSTRUCTIONS = """\
Usage: matrix-eyes [OPTIONS] <IMG_SRC>... <IMG_OUT>

Arguments:
  <IMG_SRC>...  Source image
  <IMG_OUT>     Output image

Options:
      --focal-length=<FOCAL_LENGTH>       Focal length in 35mm equivalent
      --checkpoint-path=<CHECKPOINT_PATH> Path to checkpoint file [default: ./checkpoints/depth_pro.pt]
      --convert-checkpoints               Convert checkpoints into a more efficient format [default: disabled]
      --image-output-format=<FORMAT>      Format for output [default: depthmap] [possible values: depthmap, stereogram]
      --resize-scale=<SCALE>              Custom scale for stereogram output [default: 1.0]
      --stereo-amplitude=<AMPLITUDE>      Custom scale for stereogram output [default: 0.0625]
      --mesh=<MESH>                       Mesh options [default: vertex-colors] [possible values: plain, vertex-colors, texture-coordinates]
      --dtype=<DTYPE>                     Compute/parameter dtype [default: bf16 on CUDA, f32 elsewhere] [possible values: f32, bf16, f16, int8, mixed]
      --seed=<SEED>                       Stereogram noise seed [default: 0]
      --batch-size=<N>                    Images per forward in directory mode [default: 1]
      --devices=<N|DATAxMODEL>            Shard over N cards: DATA over the patch batch, MODEL over the ViT blocks [default: 1]
      --profile=<DIR>                     Write a torch.profiler trace of the run to DIR
      --help                              Print help"""

# the JAX package's kill switch of its attention kernel: the port has none
_NOT_PORTED = ("--no-flash-attention",)


@dataclass
class Args:
    focal_length: Optional[float] = None
    checkpoint_path: str = "./checkpoints/depth_pro.pt"
    output_format: str = "depthmap"
    resize_scale: Optional[float] = None
    stereo_amplitude: float = 1.0 / 16.0
    vertex_mode: str = "vertex-colors"
    dtype: Optional[str] = None
    seed: int = 0
    batch_size: int = 1
    devices: Optional[Tuple[int, int]] = None  # (data, model)
    convert_checkpoints: bool = False
    profile_dir: Optional[str] = None
    img_src: str = ""
    img_out: str = ""


def _fail_usage(msg: str, stderr, stdout) -> SystemExit:
    print(msg, file=stderr)
    print(USAGE_INSTRUCTIONS, file=stdout)
    return SystemExit(2)


def parse_args(argv: List[str], stdout=None, stderr=None) -> Args:
    """Parse argv (without the program name); raises SystemExit(0 or 2)."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    args = Args()

    def parse_value(name: str, value: str, cast):
        try:
            return cast(value)
        except ValueError as err:
            raise _fail_usage(f"Argument {name} has an unsupported value {value}: {err}",
                              stderr, stdout)

    for arg in argv:
        if arg.startswith("--") and not args.img_src:
            if arg == "--convert-checkpoints":
                args.convert_checkpoints = True
                continue
            if arg == "--help":
                print(USAGE_INSTRUCTIONS, file=stdout)
                raise SystemExit(0)
            name = arg.split("=", 1)[0]
            if name in _NOT_PORTED:
                raise _fail_usage(f"Argument {name} is not supported by the PyTorch port",
                                  stderr, stdout)
            if "=" not in arg:
                raise _fail_usage(f"Option flag {arg} has no value", stderr, stdout)
            value = arg.split("=", 1)[1]
            if name == "--focal-length":
                args.focal_length = parse_value(name, value, float)
            elif name == "--image-output-format":
                if value.lower() not in ("depthmap", "stereogram"):
                    raise _fail_usage(f"Unsupported output format {value}", stderr, stdout)
                args.output_format = value.lower()
            elif name == "--resize-scale":
                args.resize_scale = parse_value(name, value, float)
            elif name == "--stereo-amplitude":
                args.stereo_amplitude = parse_value(name, value, float)
            elif name == "--mesh":
                if value.lower() not in ("plain", "vertex-colors", "texture-coordinates"):
                    raise _fail_usage(f"Unsupported mesh vertex output mode {value}", stderr,
                                      stdout)
                args.vertex_mode = value.lower()
            elif name == "--seed":
                args.seed = parse_value(name, value, int)
            elif name == "--batch-size":
                args.batch_size = parse_value(name, value, _batch_size)
            elif name == "--devices":
                args.devices = parse_value(name, value, _mesh_shape)
            elif name == "--checkpoint-path":
                args.checkpoint_path = value
            elif name == "--profile":
                args.profile_dir = value
            elif name == "--dtype":
                from matrix_eyes_tpu_torch.config import parse_dtype_policy

                parse_value(name, value, parse_dtype_policy)
                args.dtype = value
            else:
                print(f"Unsupported argument {arg}", file=stderr)
        elif not args.img_src:
            args.img_src = arg
        elif not args.img_out:
            args.img_out = arg
        else:
            raise _fail_usage(f"Unexpected argument {arg}", stderr, stdout)
    if not args.img_src:
        raise _fail_usage("No source image provided", stderr, stdout)
    if not args.img_out:
        raise _fail_usage("No output image provided", stderr, stdout)
    return args


def _batch_size(value: str) -> int:
    n = int(value)  # ValueError on junk
    if n < 1:
        raise ValueError("batch size must be >= 1")
    return n


def _mesh_shape(value: str) -> Tuple[int, int]:
    """``N`` -> (N, 1), ``DATAxMODEL`` -> (DATA, MODEL), each >= 1."""
    parts = value.lower().split("x")
    if len(parts) > 2:
        raise ValueError("expected N or DATAxMODEL")
    dims = [int(p) for p in parts]  # ValueError on junk
    if any(d < 1 for d in dims):
        raise ValueError("mesh dimensions must be >= 1")
    return dims[0], dims[1] if len(dims) == 2 else 1


def _jobs(args: Args) -> list:
    """(source, destination) pairs of a directory source: its .jpg, .jpeg
    and .png files in sorted order, each written as a PNG of the same stem
    into the output directory."""
    from matrix_eyes_tpu_torch.errors import ReconstructionError

    if not os.path.isdir(args.img_out):
        raise ReconstructionError(f"IO error: {args.img_out} must be an existing directory when "
                                  "the source is a directory")
    sources = sorted(os.path.join(args.img_src, n) for n in os.listdir(args.img_src)
                     if n.lower().endswith((".jpg", ".jpeg", ".png")))
    if not sources:
        raise ReconstructionError(f"IO error: no images in {args.img_src}")
    return [(s, os.path.join(args.img_out, os.path.splitext(os.path.basename(s))[0] + ".png"))
            for s in sources]


def run(args: Args, progress=None, device=None, mesh=None) -> None:
    """Load the checkpoint (the FOV part only when some photo lacks a focal
    length) and run the pipeline on the CUDA card, or on ``device`` when a
    programmatic caller names one ("cpu"). A directory source runs every
    photo: ``--batch-size`` per forward, or one at a time with the next
    decode started ahead; a failed decode or write skips that photo, a model
    failure ends the run.

    ``mesh``: this rank's mesh (``--devices``, see ``main``). The
    checkpoint is read on the host and each rank moves only its cut of the
    parameters to its device (``parallel.shard_params``); rank 0 decodes
    and writes."""
    from matrix_eyes_tpu_torch.config import RuntimeConfig, parse_dtype_policy
    from matrix_eyes_tpu_torch.errors import MatrixEyesError, ReconstructionError
    from matrix_eyes_tpu_torch.io.image import load_source_image, probe_focal_length_35mm
    from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat, VertexMode
    from matrix_eyes_tpu_torch.pipeline import extract_depth, extract_depth_batch
    from matrix_eyes_tpu_torch.pt.loader import load_checkpoint

    dtype, quantize_int8, mixed_bf16 = (parse_dtype_policy(args.dtype) if args.dtype
                                        else (None, False, False))
    if mesh is not None:
        device = mesh.device
    runtime = RuntimeConfig(dtype=dtype, device=device, seed=args.seed,
                            quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
    lead = mesh is None or mesh.rank == 0
    batch = os.path.isdir(args.img_src)
    if batch or mesh is not None:
        # under a mesh rank 0 decodes the photo in the pipeline, which tells
        # every rank of a failure
        jobs = ([(s, o, None) for s, o in _jobs(args)] if batch
                else [(args.img_src, args.img_out, None)])
        # the EXIF headers alone decide whether the FOV weights are needed
        need_fov = args.focal_length is None and any(
            probe_focal_length_35mm(s) is None for s, _o, _src in jobs)
    else:
        jobs = [(args.img_src, args.img_out, load_source_image(args.img_src, args.focal_length))]
        need_fov = jobs[0][2].f_norm() is None
    if not batch and args.batch_size > 1 and lead:
        print("--batch-size only applies when the source is a directory; ignored",
              file=sys.stderr)
    parts = ("encoder", "decoder", "head") + (("fov",) if need_fov else ())
    if progress is not None:
        progress.update_message("reading checkpoint")
    if mesh is None:
        cfg, params = load_checkpoint(args.checkpoint_path, dtype=runtime.resolved_dtype(),
                                      device=runtime.resolved_device(),
                                      convert_checkpoints=args.convert_checkpoints, parts=parts,
                                      quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
    else:
        cfg, params = _load_sharded(args, runtime, parts, mesh)
    options = dict(focal_length_35mm=args.focal_length,
                   image_format=ImageOutputFormat(args.output_format),
                   vertex_mode=VertexMode(args.vertex_mode), resize_scale=args.resize_scale,
                   stereo_amplitude=args.stereo_amplitude, runtime=runtime, progress=progress,
                   mesh=mesh)
    if batch and args.batch_size > 1:
        extract_depth_batch(cfg, params, [(s, o) for s, o, _src in jobs], args.batch_size,
                            **options)
        return

    # one photo at a time; the next photo decodes on a worker thread while
    # this one runs (a photo whose decode fails there is decoded again in the
    # pipeline, which reports it with its stage message). This loop wrote
    # more photos per second on an H100 than extract_depth_batch at batch
    # size 1 (PERF.md)
    pool = next_fut = None
    if len(jobs) > 1 and lead:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="me-decode")
    failed = 0
    try:
        for i, (src_path, out_path, src) in enumerate(jobs):
            if next_fut is not None:
                try:
                    src = next_fut.result()
                except Exception:
                    src = None
                next_fut = None
            if pool is not None and i + 1 < len(jobs):
                next_fut = pool.submit(load_source_image, jobs[i + 1][0], args.focal_length)
            try:
                extract_depth(cfg, params, src_path, out_path, source=src, **options)
            except MatrixEyesError as err:
                # a photo's decode or write fails that photo only; a model
                # failure is systemic (device, weights) and ends the run
                if not batch or getattr(err, "stage", None) not in ("load", "output"):
                    raise
                failed += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    if failed:
        raise ReconstructionError(f"{failed} of {len(jobs)} images failed")


def _load_sharded(args: Args, runtime, parts, mesh):
    """(cfg, this rank's parameters): the checkpoint placed on the host
    under the dtype policy, then cut for ``mesh``. With
    ``--convert-checkpoints`` rank 0 writes the caches before the others
    read."""
    from matrix_eyes_tpu_torch import timings
    from matrix_eyes_tpu_torch.parallel.collectives import broadcast
    from matrix_eyes_tpu_torch.parallel.sharding import shard_params
    from matrix_eyes_tpu_torch.pipeline import check_mesh
    from matrix_eyes_tpu_torch.pt.loader import load_checkpoint

    def load(convert: bool):
        return load_checkpoint(args.checkpoint_path, dtype=runtime.resolved_dtype(),
                               device="cpu", convert_checkpoints=convert, parts=parts,
                               quantize_int8=runtime.quantize_int8,
                               mixed_bf16=runtime.mixed_bf16)

    if args.convert_checkpoints:
        import torch

        loaded = load(True) if mesh.rank == 0 else None
        broadcast(torch.zeros(1, device=mesh.device), mesh)  # the caches are written
        cfg, params = loaded if loaded is not None else load(False)
    else:
        cfg, params = load(False)
    check_mesh(cfg, mesh)
    with timings.span("shard parameters"):
        return cfg, shard_params(params, mesh, num_heads=cfg.num_heads)


def _rank_main(mesh, args: Args) -> int:
    """One rank of ``--devices``: the CLI's run on this rank's device; rank
    0 reports progress, failures and timings. Returns 0; a failure raises
    ``RankStop`` (exit code 1), which ends every rank: the others may wait
    in a collective this rank will never join."""
    from matrix_eyes_tpu_torch import timings
    from matrix_eyes_tpu_torch.errors import MatrixEyesError
    from matrix_eyes_tpu_torch.parallel.launch import RankStop
    from matrix_eyes_tpu_torch.progress import ConsoleProgressReporter

    lead = mesh.rank == 0
    pb = ConsoleProgressReporter() if lead else None
    try:
        run(args, progress=pb, mesh=mesh)
    except MatrixEyesError as err:
        if lead:
            pb.finish_and_clear()
            print(f"Reconstruction failed: {err}")
        raise RankStop(1, "" if lead else str(err)) from err
    finally:
        if lead:
            pb.finish_and_clear()
            timings.report()
    return 0


def run_devices(args: Args, device=None) -> int:
    """``--devices=DATAxMODEL`` beyond 1x1: refuse a mesh larger than the
    devices (nothing falls back to fewer, or to the CPU), else start the
    ranks, one per card over NCCL (or, for a caller asking for the CPU,
    one per core over gloo), and return rank 0's exit code. A rank's
    failure ends every rank at once; the run has no deadline otherwise."""
    import torch

    from matrix_eyes_tpu_torch.errors import ReconstructionError
    from matrix_eyes_tpu_torch.parallel.launch import RankStop, launch

    data, model = args.devices
    n = data * model
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        available = os.cpu_count() or 1
    else:
        available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > available:
        raise ReconstructionError(f"Device error: --devices={data}x{model} needs {n} devices "
                                  f"but only {available} are available")
    devices = ["cpu"] * n if on_cpu else [f"cuda:{i}" for i in range(n)]
    try:
        codes = launch(_rank_main, (data, model), args, devices=devices, timeout=None)
    except RankStop as stop:
        if stop.rank != 0:  # rank 0 reports its own failures
            print(f"Reconstruction failed on rank {stop.rank}: {stop.message}")
        return stop.code
    except (RuntimeError, TimeoutError) as err:
        raise ReconstructionError(f"Device error: {err}") from err
    return codes[0]


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device):
    """``--profile=DIR``: a ``torch.profiler`` trace of the enclosed run
    (this process: host operators and, on the card, its kernels, those that
    CUDA graphs replay included), written into DIR as a Chrome trace
    (``matrix_eyes.<pid>.<time>.pt.trace.json``, which TensorBoard and
    chrome://tracing read)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir, worker_name="matrix_eyes")):
        yield


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """The CLI. ``device`` is for programmatic callers (the tests pass
    "cpu"); the command line has no such flag and runs on the card."""
    print(f"Matrix Eyes version {__version__}")
    try:
        args = parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit as e:
        return int(e.code or 0)

    from matrix_eyes_tpu_torch.config import NoCudaDevice
    from matrix_eyes_tpu_torch.errors import MatrixEyesError
    from matrix_eyes_tpu_torch.progress import ConsoleProgressReporter

    from matrix_eyes_tpu_torch import timings

    if args.devices is not None and args.devices != (1, 1):
        try:
            return run_devices(args, device)
        except (MatrixEyesError, NoCudaDevice) as err:
            print(f"Reconstruction failed: {err}")
            return 1
    pb = ConsoleProgressReporter()
    try:
        with _profiled(args.profile_dir, device):
            run(args, progress=pb, device=device)
    except (MatrixEyesError, NoCudaDevice) as err:
        pb.finish_and_clear()
        print(f"Reconstruction failed: {err}")
        return 1
    finally:
        pb.finish_and_clear()
        timings.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
