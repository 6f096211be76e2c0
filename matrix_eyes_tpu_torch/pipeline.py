"""Pipelines: photo -> depth -> depth-map, stereogram or mesh file, one
photo at a time or a batch per forward.

Port of ``matrix_eyes_tpu/pipeline.py`` (``preprocess_image``,
``extract_depth`` and ``extract_depth_batch``): decode the source image on
the host, preprocess on the device, run the model (the FOV head estimates
the focal length when EXIF and the flag give none), render and save. Each
stage prints its own failure message to stderr and tags the error with its
stage: only the decode is the per-image 'load' stage; preprocess and
forward failures are 'model' failures, which are systemic (device,
weights); writing is the per-image 'output' stage.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.errors import MatrixEyesError, ReconstructionError
from matrix_eyes_tpu_torch.io.image import SourceImage, load_source_image
from matrix_eyes_tpu_torch.progress import SplitProgressListener
from matrix_eyes_tpu_torch.config import ModelConfig, RuntimeConfig, configure_precision
from matrix_eyes_tpu_torch.models import depth_pro
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.output.depthmap import (
    DepthMap,
    ImageOutputFormat,
    VertexMode,
)


def preprocess_image(rgb_u8: np.ndarray, img_size: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """Lanczos3 resize to the model resolution, round back to u8 (the
    reference resizes the u8 image), scale to [0, 1], normalise with
    mean = std = 0.5. ``rgb_u8``: (H, W, 3) u8, numpy or a tensor already
    on ``device`` (the server's upload). Returns (1, S, S, 3) NHWC."""
    x = rgb_u8 if isinstance(rgb_u8, torch.Tensor) else torch.tensor(rgb_u8, device=device)
    x = x.to(device).float()
    x = to_u8(resize_lanczos3(x, img_size, img_size)).float()
    x = (x / 255.0 - 0.5) / 0.5
    return x[None].to(dtype)


def forward_batch(cfg: ModelConfig, params: Dict[str, Any], img: torch.Tensor,
                  f_norms: Sequence[Optional[float]]) -> torch.Tensor:
    """One forward over an image stack: the known-focal forward when every
    f_norm is known, else the mixed one (the FOV head fills the images
    whose f_norm is None). Returns the (B, S, S) inverse depth on the
    device."""
    if all(f is not None for f in f_norms):
        return depth_pro.forward_with_fnorm(cfg, params, img, np.asarray(f_norms, np.float32))
    if "fov" not in params:
        raise ReconstructionError("Model error: an image carries no focal length but the FOV "
                                  "weights were not loaded")
    f_arr = np.asarray([1.0 if f is None else f for f in f_norms], np.float32)
    has_f = np.asarray([f is not None for f in f_norms])
    return depth_pro.forward_with_mixed_fnorm(cfg, params, img, f_arr, has_f)[0]


def _stage_error(msg: str, err: Exception, stage: str) -> MatrixEyesError:
    """Print the stage's message, tag the error with its stage."""
    print(f"{msg}: {err}", file=sys.stderr)
    out = err if isinstance(err, MatrixEyesError) else ReconstructionError(f"{msg}: {err}")
    out.stage = stage
    return out


def _wait_for_forward(device: torch.device) -> None:
    """With timings on, end the forward's span when the card is done, so
    that the output stage is not charged with it."""
    if timings.enabled() and device.type == "cuda":
        torch.cuda.synchronize(device)


def extract_depth(
    cfg: ModelConfig,
    params: Dict[str, Any],
    source_path: str,
    destination_path: str,
    focal_length_35mm: Optional[float] = None,
    image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
    vertex_mode: VertexMode = VertexMode.COLOR,
    resize_scale: Optional[float] = None,
    stereo_amplitude: float = 1.0 / 16.0,
    runtime: Optional[RuntimeConfig] = None,
    progress=None,
    source: Optional[SourceImage] = None,
) -> DepthMap:
    """Full pipeline for one image; returns the DepthMap it wrote.
    ``params`` must already lie on the runtime's device; ``source``, when
    given, is the decoded image and ``source_path`` is not decoded (a
    mesh's vertex colours and texture still refer to it). A stereogram's
    noise comes from ``runtime.seed``."""
    runtime = runtime or RuntimeConfig()
    device = runtime.resolved_device()
    dtype = runtime.image_dtype()
    configure_precision()
    pl = SplitProgressListener(progress)
    pl_model, pl_out = pl.split_range(0.9)
    pl_pre, pl_net = pl_model.split_range(0.05)

    pl_pre.update_message("loading source image")
    try:
        with timings.span("decode source image"):
            src = source if source is not None else load_source_image(source_path,
                                                                       focal_length_35mm)
    except Exception as err:
        raise _stage_error("Failed to load source image", err, "load") from err
    pl_pre.report_status(1.0)

    pl_net.update_message("extracting depth")
    try:
        with timings.span("preprocess (device)"):
            img = preprocess_image(src.rgb, cfg.img_size, dtype, device)
        f_norm = src.f_norm()
        with timings.span("model forward"):
            if f_norm is not None:
                inverse_depth = depth_pro.forward_with_fnorm(cfg, params, img, f_norm)[0]
            else:
                inv, _fov_deg = depth_pro.forward_with_fov(cfg, params, img)
                inverse_depth = inv[0]
            depth_map = DepthMap.new(inverse_depth, src.original_size)
            _wait_for_forward(device)
    except Exception as err:
        raise _stage_error("Failed to process image", err, "model") from err
    pl_net.report_status(1.0)

    pl_out.update_message("writing output")
    try:
        with timings.span("write output"):
            depth_map.output_image(destination_path, source_path, image_format=image_format,
                                   vertex_mode=vertex_mode, resize_scale=resize_scale,
                                   amplitude=stereo_amplitude, seed=runtime.seed)
    except Exception as err:
        raise _stage_error("Failed to output result", err, "output") from err
    pl_out.report_status(1.0)
    return depth_map


def extract_depth_batch(
    cfg: ModelConfig,
    params: Dict[str, Any],
    jobs: Sequence[Tuple[str, str]],
    batch_size: int,
    focal_length_35mm: Optional[float] = None,
    image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
    vertex_mode: VertexMode = VertexMode.COLOR,
    resize_scale: Optional[float] = None,
    stereo_amplitude: float = 1.0 / 16.0,
    runtime: Optional[RuntimeConfig] = None,
    progress=None,
) -> None:
    """Many images, one forward per ``batch_size`` photos: the batch rides
    the encoder's pyramid patch axis (35 patches per image). Each image gets
    what :func:`extract_depth` would give it (its own EXIF focal length and
    output geometry, the same stage messages), up to the f32 sums of a
    batched GEMM.

    ``jobs``: ``(source_path, destination_path)`` pairs. A chunk in which
    some image lacks a focal length runs the FOV head for the whole chunk,
    and known focal lengths override its estimate
    (``depth_pro.forward_with_mixed_fnorm``).

    The last chunk is padded to ``batch_size`` with copies of its last
    preprocessed image, so every chunk has one shape. The next chunk's
    decodes run on a worker thread. Writing runs one chunk behind the
    forward: chunk k's renders and their copies to the host are enqueued
    right after its forward (``DepthMap.prepare_output``), before chunk
    k+1's forward, and chunk k's files are written while the card runs
    chunk k+1.

    A failing decode or output skips that image with its stage message;
    the rest still complete, and one ReconstructionError ("N of M images
    failed") ends the run. A preprocess or forward failure is systemic: the
    finished chunk is written first, then it raises."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    runtime = runtime or RuntimeConfig()
    device = runtime.resolved_device()
    dtype = runtime.image_dtype()
    configure_precision()
    jobs = list(jobs)
    chunks = [jobs[i:i + batch_size] for i in range(0, len(jobs), batch_size)]

    def decode(path: str) -> SourceImage:
        return load_source_image(path, focal_length_35mm)

    pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="me-decode")
            if len(chunks) > 1 else None)
    next_futs = None

    # progress windows in execution order (model c0, model c1, output c0,
    # model c2, output c1, ...), so the bar only moves forward
    model_w = 0.9 / len(chunks)
    out_w = 0.1 / len(chunks)
    cursor = 0.0

    def take(width: float) -> SplitProgressListener:
        nonlocal cursor
        lo, cursor = cursor, min(1.0, cursor + width)
        return SplitProgressListener(progress, lo, cursor)

    pending: Optional[Tuple[List[str], list]] = None  # the unwritten chunk
    failures: List[Tuple[str, Exception]] = []

    def flush_pending() -> None:
        nonlocal pending
        if pending is None:
            return
        outs, writers = pending
        pending = None
        pl_out = take(out_w)
        pl_out.update_message("writing output")
        for out_path, write in zip(outs, writers):
            try:
                with timings.span("write output"):
                    write()
            except Exception as err:
                failures.append((out_path, _stage_error(f"Failed to output result {out_path}",
                                                        err, "output")))
        pl_out.report_status(1.0)

    try:
        for ci, chunk in enumerate(chunks):
            pl_model = take(model_w)
            futs, next_futs = next_futs, None
            pl_model.update_message("loading source images")
            live = []  # ((src_path, out_path), SourceImage) of the images that decoded
            for j, (src_path, out_path) in enumerate(chunk):
                try:
                    with timings.span("decode source image"):
                        src = futs[j].result() if futs is not None else decode(src_path)
                    live.append(((src_path, out_path), src))
                except Exception as err:
                    failures.append((out_path, _stage_error(
                        f"Failed to load source image {src_path}", err, "load")))
            if pool is not None and ci + 1 < len(chunks):
                next_futs = [pool.submit(decode, p) for p, _o in chunks[ci + 1]]
            if not live:
                flush_pending()
                pl_model.report_status(1.0)
                continue

            pl_model.update_message("extracting depth")
            try:
                with timings.span("preprocess (device)"):
                    imgs = [preprocess_image(s.rgb, cfg.img_size, dtype, device)
                            for _job, s in live]
                    pad = batch_size - len(live)
                    img = torch.cat(imgs + imgs[-1:] * pad)
                f_norms = [s.f_norm() for _job, s in live]
                f_norms += f_norms[-1:] * pad
                with timings.span("model forward"):
                    inv = forward_batch(cfg, params, img, f_norms)
                    _wait_for_forward(device)
            except Exception as err:
                raise _stage_error("Failed to process image", err, "model") from err
            pl_model.report_status(1.0)

            # this chunk's renders and copies enter the stream before
            # anything else: the writes below and the next chunk's forward
            outs, writers = [], []
            for i, ((src_path, out_path), s) in enumerate(live):
                try:
                    writers.append(DepthMap.new(inv[i], s.original_size).prepare_output(
                        out_path, src_path, image_format=image_format, vertex_mode=vertex_mode,
                        resize_scale=resize_scale, amplitude=stereo_amplitude,
                        seed=runtime.seed))
                    outs.append(out_path)
                except Exception as err:
                    failures.append((out_path, _stage_error(
                        f"Failed to output result {out_path}", err, "output")))
            flush_pending()  # the previous chunk, while the card runs this one
            pending = (outs, writers)
        flush_pending()
    except Exception:
        # a systemic failure must not lose the finished chunk; Ctrl-C
        # (not an Exception) stops without writing
        flush_pending()
        raise
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    if failures:
        raise ReconstructionError(f"{len(failures)} of {len(jobs)} images failed")
