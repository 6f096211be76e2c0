"""Command-line interface of the PyTorch port: the reference grammar.

* options are only recognised before the first positional argument;
* a flag without ``=`` -> usage + exit 2; an unknown ``--flag`` prints
  "Unsupported argument" to stderr and does not abort;
* more than two positionals, or a missing one -> usage + exit 2;
  ``--help`` -> usage + exit 0;
* reconstruction failure -> message + exit 1.

The port runs one photo to a viridis depth map or an autostereogram.
Flags and outputs of the JAX package that the port does not run yet
(mesh, batch, devices, the f16/int8/mixed dtypes, ...) exit 2 with a
message saying so.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import List, Optional

from matrix_eyes_tpu_torch import __version__

USAGE_INSTRUCTIONS = """\
Usage: matrix-eyes [OPTIONS] <IMG_SRC> <IMG_OUT>

Arguments:
  <IMG_SRC>  Source image
  <IMG_OUT>  Output image

Options:
      --focal-length=<FOCAL_LENGTH>       Focal length in 35mm equivalent
      --checkpoint-path=<CHECKPOINT_PATH> Path to checkpoint file [default: ./checkpoints/depth_pro.pt]
      --image-output-format=<FORMAT>      Format for output [default: depthmap] [possible values: depthmap, stereogram]
      --resize-scale=<SCALE>              Custom scale for stereogram output [default: 1.0]
      --stereo-amplitude=<AMPLITUDE>      Custom scale for stereogram output [default: 0.0625]
      --dtype=<DTYPE>                     Compute/parameter dtype [default: bf16 on CUDA, f32 elsewhere] [possible values: f32, bf16]
      --seed=<SEED>                       Stereogram noise seed [default: 0]
      --help                              Print help"""

# flags of the JAX package's CLI that the port does not run yet
_NOT_PORTED = ("--mesh", "--convert-checkpoints", "--devices", "--batch-size",
               "--no-flash-attention", "--profile")


@dataclass
class Args:
    focal_length: Optional[float] = None
    checkpoint_path: str = "./checkpoints/depth_pro.pt"
    output_format: str = "depthmap"
    resize_scale: Optional[float] = None
    stereo_amplitude: float = 1.0 / 16.0
    dtype: Optional[str] = None
    seed: int = 0
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
            if arg == "--help":
                print(USAGE_INSTRUCTIONS, file=stdout)
                raise SystemExit(0)
            name = arg.split("=", 1)[0]
            if name in _NOT_PORTED:
                raise _fail_usage(f"Argument {name} is not supported by the PyTorch port yet",
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
            elif name == "--seed":
                args.seed = parse_value(name, value, int)
            elif name == "--checkpoint-path":
                args.checkpoint_path = value
            elif name == "--dtype":
                from matrix_eyes_tpu_torch.config import parse_dtype

                parse_value(name, value, parse_dtype)
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
    if os.path.isdir(args.img_src):
        raise _fail_usage("Directory sources are not supported by the PyTorch port yet",
                          stderr, stdout)
    if args.img_out.lower().endswith((".obj", ".ply")):
        raise _fail_usage("Mesh output is not supported by the PyTorch port yet",
                          stderr, stdout)
    return args


def run(args: Args, progress=None, device=None) -> None:
    """Load the checkpoint (the FOV part only when no focal length is
    known) and run the pipeline on the CUDA card, or on ``device`` when a
    programmatic caller names one ("cpu")."""
    from matrix_eyes_tpu_torch.config import RuntimeConfig, parse_dtype
    from matrix_eyes_tpu_torch.io.image import load_source_image
    from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat
    from matrix_eyes_tpu_torch.pipeline import extract_depth
    from matrix_eyes_tpu_torch.pt.convert import load_checkpoint

    runtime = RuntimeConfig(dtype=parse_dtype(args.dtype) if args.dtype else None,
                            device=device, seed=args.seed)
    src = load_source_image(args.img_src, args.focal_length)
    parts = ("encoder", "decoder", "head")
    if src.f_norm() is None:
        parts += ("fov",)
    if progress is not None:
        progress.update_message("reading checkpoint")
    cfg, params = load_checkpoint(args.checkpoint_path, dtype=runtime.resolved_dtype(),
                                  device=runtime.resolved_device(), parts=parts)
    extract_depth(cfg, params, args.img_src, args.img_out, focal_length_35mm=args.focal_length,
                  image_format=ImageOutputFormat(args.output_format),
                  resize_scale=args.resize_scale, stereo_amplitude=args.stereo_amplitude,
                  runtime=runtime, progress=progress, source=src)


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

    pb = ConsoleProgressReporter()
    try:
        run(args, progress=pb, device=device)
    except (MatrixEyesError, NoCudaDevice) as err:
        pb.finish_and_clear()
        print(f"Reconstruction failed: {err}")
        return 1
    finally:
        pb.finish_and_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
