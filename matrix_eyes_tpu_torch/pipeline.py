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

The device programs run through the CUDA-graph cache (``aot.call_cached``)
under the JAX package's names: ``preprocess``, ``fwd_fnorm`` and
``fwd_fov`` for one photo, ``fwd_fnorm_b{N}`` and ``fwd_mixed_b{N}`` for a
batch of N. On a device mesh the forwards go through the mesh's own cache
(``aot.mesh_cache``): over NCCL every rank captures its forward with its
collectives and replays it in lock step with the other ranks; a gloo mesh
runs them eagerly.

Depth Anything V2 (``config.DepthAnythingConfig``) takes the same paths
with its own preprocess and forward: ``dav2_preprocess`` (a bicubic resize
to the model's lower-bound size in multiples of 14 keeping the aspect,
``input_hw``, and ImageNet normalisation) and ``dav2_fwd_b{N}``
(``models.depth_anything.forward``, for one photo too). Its output is not
metric (``cfg.metric``): focal lengths are accepted and ignored and the
depth map is not clamped; and it refuses a device mesh (``check_mesh``).
"""

from __future__ import annotations

import functools
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from matrix_eyes_tpu_torch import aot, timings
from matrix_eyes_tpu_torch.errors import MatrixEyesError, ReconstructionError
from matrix_eyes_tpu_torch.io.image import SourceImage, load_source_image
from matrix_eyes_tpu_torch.progress import SplitProgressListener
from matrix_eyes_tpu_torch.config import AnyConfig, ModelConfig, RuntimeConfig, configure_precision
from matrix_eyes_tpu_torch.models import depth_anything, depth_pro
from matrix_eyes_tpu_torch.native import stagecopy
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.parallel.sharding import patch_sharded
from matrix_eyes_tpu_torch.output.depthmap import (
    DepthMap,
    ImageOutputFormat,
    VertexMode,
)


def _preprocess(x: torch.Tensor, size: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """Depth Pro's: Lanczos3 resize to the model resolution, round back to
    u8 (the reference resizes the u8 image), scale to [0, 1], normalise
    with mean = std = 0.5."""
    x = to_u8(resize_lanczos3(x.float(), *size)).float()
    x = (x / 255.0 - 0.5) / 0.5
    return x[None].to(dtype)


# ImageNet's mean and std (depth_anything_v2/dpt.py, image2tensor)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _preprocess_dav2(x: torch.Tensor, size: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """Depth Anything V2's: scale to [0, 1], bicubic (a = -0.75,
    half-pixel centres, no antialias; ``F.interpolate``, where the
    published code runs ``cv2.INTER_CUBIC``), ImageNet normalisation."""
    x = F.interpolate((x.float() / 255.0).permute(2, 0, 1)[None], size=size, mode="bicubic",
                      align_corners=False).permute(0, 2, 3, 1)
    x = torch.stack([(x[..., c] - IMAGENET_MEAN[c]) / IMAGENET_STD[c] for c in range(3)], dim=-1)
    return x.to(dtype)


# each architecture's preprocess program: (name, function of (photo, (h, w), dtype))
_PREPROCESS = {ModelConfig.architecture: ("preprocess", _preprocess),
               "depth_anything_v2": ("dav2_preprocess", _preprocess_dav2)}


def stage(rgb: np.ndarray, host: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy the photo ``rgb`` into ``host``, a CPU tensor of its shape and
    dtype (None: a pinned block of PyTorch's caching host allocator);
    returns ``host``. A C-contiguous photo is copied by the native staging
    copy (``native/stagecopy.cpp``) on the calling thread and up to the
    process's intra-op thread count less one helpers, which never makes
    the call wait for a helper to wake; any other layout, or without g++,
    by numpy on the calling thread. ``rgb`` is only read (a read-only
    array too) and is the caller's again when this returns."""
    if host is None:
        host = torch.empty(rgb.shape, dtype=torch.from_numpy(np.empty(0, rgb.dtype)).dtype,
                           pin_memory=True)
    dst = host.numpy()
    if rgb.flags.c_contiguous and stagecopy.available():
        stagecopy.copy(rgb, dst, torch.get_num_threads())
    else:
        np.copyto(dst, rgb)
    return host


def upload(rgb_u8, device) -> torch.Tensor:
    """The photo on ``device``, by one of three paths, each counted as
    ``("upload", path)`` in the launch ledger and named with the photo's
    bytes on the span ``pipeline.upload``: ``device``, a tensor (the
    server's upload), moved by ``.to`` should it lie elsewhere; ``pinned``,
    a host array bound for a CUDA device: ``stage``d into pinned memory,
    then copied on the current stream with no synchronisation, so the copy
    overlaps the card's work already queued (a batch's previous photo) and
    device memory stays ordered on that stream; the allocator hands the
    pinned block out again only once the copy has finished; ``host``, a
    host array bound for the CPU: a copy."""
    if isinstance(rgb_u8, torch.Tensor):
        rgb, path = rgb_u8, "device"
    else:
        rgb = np.asarray(rgb_u8)
        path = "pinned" if torch.device(device).type == "cuda" else "host"
    with timings.trace("pipeline.upload", {"path": path, "bytes": rgb.nbytes}):
        if path == "device":
            x = rgb.to(device)
        elif path == "host":
            x = torch.tensor(rgb, device=device)
        else:
            x = stage(rgb).to(device, non_blocking=True)
    _build.record("upload", path)
    return x


def preprocess_image(rgb_u8: np.ndarray, model, dtype: torch.dtype, device) -> torch.Tensor:
    """The model's input of one photo, ``rgb_u8``: (H, W, 3) u8, numpy or
    a tensor already on ``device`` (the server's upload). ``model``: the
    configuration, which sizes the input (``input_hw``) and names its
    program, or an int, the side of Depth Pro's square input (the JAX
    package's ``img_size``). Returns (1, h, w, 3) NHWC. The photo's copy to
    the device (``upload``) is enqueued before the program."""
    x = upload(rgb_u8, device)
    if isinstance(model, int):
        arch, size = ModelConfig.architecture, (model, model)
    else:
        arch, size = model.architecture, model.input_hw(x.shape[0], x.shape[1])
    name, fn = _PREPROCESS[arch]
    return aot.call_cached(name, fn, (x, size, dtype))


def check_mesh(cfg: AnyConfig, mesh) -> None:
    """Raise where ``mesh`` is a device mesh and the architecture runs on
    one device only."""
    if mesh is not None and not cfg.runs_on_mesh:
        raise ReconstructionError(f"{cfg.architecture} runs on one device: a device mesh "
                                  "(--devices) is not supported")


def _forward_relative(cfg, params: Dict[str, Any], img: torch.Tensor, mesh) -> torch.Tensor:
    """Depth Anything V2's (B, h, w) relative inverse depth (``dav2_fwd_b{B}``)."""
    check_mesh(cfg, mesh)
    return aot.call_cached(f"dav2_fwd_b{img.shape[0]}",
                           functools.partial(depth_anything.forward, cfg), (params, img),
                           repr(cfg))


def forward_groups(cfg: AnyConfig, params: Dict[str, Any], imgs: Sequence[torch.Tensor],
                   f_norms: Sequence[Optional[float]], pad_to: Optional[int] = None,
                   pad_to_pow2: bool = False, mesh=None) -> List[torch.Tensor]:
    """The inverse depth of preprocessed (1, h, w, 3) images, one (h, w)
    tensor an image in their order: one ``forward_batch`` per input size
    (Depth Pro's inputs share one; Depth Anything V2's follow the photo's
    aspect), each padded with copies of its last image and focal length to
    ``pad_to`` images, or to the next power of two."""
    out: List[Optional[torch.Tensor]] = [None] * len(imgs)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, im in enumerate(imgs):
        groups.setdefault(tuple(im.shape), []).append(i)
    for idx in groups.values():
        stack = [imgs[i] for i in idx]
        fs = [f_norms[i] for i in idx]
        n = len(stack)
        pad = (max(pad_to - n, 0) if pad_to else
               (1 << (n - 1).bit_length()) - n if pad_to_pow2 else 0)
        inv = forward_batch(cfg, params, torch.cat(stack + stack[-1:] * pad),
                            fs + fs[-1:] * pad, mesh)
        for j, i in enumerate(idx):
            out[i] = inv[j]
    return out


def _program(mesh, name: str, fn, args: tuple, salt: str):
    """A forward through the process's CUDA-graph cache on one device, and
    through the mesh's on a mesh (its key names the mesh; every rank runs
    the call in one mode; gloo runs it eagerly)."""
    if mesh is not None:
        return aot.mesh_cache(mesh).call(name, fn, args, salt)
    return aot.call_cached(name, fn, args, salt)


def forward_photo(cfg: ModelConfig, params: Dict[str, Any], img: torch.Tensor,
                  f_norm: Optional[float], mesh=None) -> torch.Tensor:
    """The (S, S) inverse depth of one preprocessed photo: the known-focal
    forward (``fwd_fnorm``), or without a focal length the FOV head's
    (``fwd_fov``). The focal length goes to the device before the
    program. An architecture without metric depth ignores the focal
    length (``dav2_fwd_b1``)."""
    with timings.trace("pipeline.forward"):
        if not cfg.metric:
            return _forward_relative(cfg, params, img, mesh)[0]
        if f_norm is not None:
            f = torch.tensor([f_norm], dtype=torch.float32, device=img.device)
            return _program(mesh, "fwd_fnorm",
                            functools.partial(depth_pro.forward_with_fnorm, cfg),
                            (params, img, f), repr(cfg))[0]
        inv, _fov_deg = _program(mesh, "fwd_fov",
                                 functools.partial(depth_pro.forward_with_fov, cfg),
                                 (params, img), repr(cfg))
        return inv[0]


def forward_batch(cfg: ModelConfig, params: Dict[str, Any], img: torch.Tensor,
                  f_norms: Sequence[Optional[float]], mesh=None) -> torch.Tensor:
    """One forward over an image stack: the known-focal forward when every
    f_norm is known (``fwd_fnorm_b{N}``), else the mixed one
    (``fwd_mixed_b{N}``: the FOV head fills the images whose f_norm is
    None). Returns the (B, S, S) inverse depth on the device. An
    architecture without metric depth ignores the focal lengths
    (``dav2_fwd_b{N}``)."""
    with timings.trace("pipeline.forward"):
        if not cfg.metric:
            return _forward_relative(cfg, params, img, mesh)
        return _forward_batch(cfg, params, img, f_norms, mesh)


def _forward_batch(cfg: ModelConfig, params: Dict[str, Any], img: torch.Tensor,
                   f_norms: Sequence[Optional[float]], mesh) -> torch.Tensor:
    B = img.shape[0]
    if all(f is not None for f in f_norms):
        f = torch.tensor(f_norms, dtype=torch.float32, device=img.device)
        return _program(mesh, f"fwd_fnorm_b{B}",
                        functools.partial(depth_pro.forward_with_fnorm, cfg), (params, img, f),
                        repr(cfg))
    if "fov" not in params:
        raise ReconstructionError("Model error: an image carries no focal length but the FOV "
                                  "weights were not loaded")
    f_arr = torch.tensor([1.0 if f is None else f for f in f_norms], dtype=torch.float32,
                         device=img.device)
    has_f = torch.tensor([f is not None for f in f_norms], device=img.device)
    return _program(mesh, f"fwd_mixed_b{B}",
                    functools.partial(depth_pro.forward_with_mixed_fnorm, cfg),
                    (params, img, f_arr, has_f), repr(cfg))[0]


def _stage_error(msg: str, err: Exception, stage: str) -> MatrixEyesError:
    """Print the stage's message, tag the error with its stage."""
    print(f"{msg}: {err}", file=sys.stderr)
    out = err if isinstance(err, MatrixEyesError) else ReconstructionError(f"{msg}: {err}")
    out.stage = stage
    return out


# what rank 0 tells the other ranks of a mesh before each forward
_RUN, _SKIP, _ABORT = 1, 0, -1  # forward / no image decoded / preprocess failed


def _share_inputs(mesh, status: int, img: Optional[torch.Tensor],
                  f_norms: Sequence[Optional[float]], shape: Tuple[int, ...],
                  dtype: torch.dtype, device: torch.device):
    """Rank 0's status, focal lengths and preprocessed image batch, on every
    rank of ``mesh`` (rank 0 decodes and preprocesses; the others pass
    None and len(f_norms) placeholders). Returns (status, img, f_norms)."""
    from matrix_eyes_tpu_torch.parallel.collectives import broadcast

    header = torch.tensor([status] + [math.nan if f is None else f for f in f_norms],
                          dtype=torch.float64, device=device)
    broadcast(header, mesh)
    status = int(header[0].item())
    if status != _RUN:
        return status, None, None
    if img is None:
        img = torch.empty(shape, dtype=dtype, device=device)
    broadcast(img, mesh)
    return status, img, [None if math.isnan(v) else v for v in header[1:].tolist()]


def _follower_error(status: int) -> MatrixEyesError:
    """A rank other than 0 stops where rank 0 failed, with rank 0's stage
    tag; rank 0 prints the message."""
    err = ReconstructionError("the source image failed on rank 0" if status == _SKIP
                              else "preprocessing failed on rank 0")
    err.stage = "load" if status == _SKIP else "model"
    return err


def _wait_for_forward(device: torch.device) -> None:
    """With ``MATRIX_EYES_TIMINGS`` on, end the forward's span when the card
    is done, so that the output stage is not charged with it. A span
    recorded under the profiler alone waits for nothing."""
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
    mesh=None,
) -> DepthMap:
    """Full pipeline for one image; returns the DepthMap it wrote.
    ``params`` must already lie on the runtime's device; ``source``, when
    given, is the decoded image and ``source_path`` is not decoded (a
    mesh's vertex colours and texture still refer to it). A stereogram's
    noise comes from ``runtime.seed``.

    ``mesh`` (``parallel.make_mesh``; every rank calls this with its own
    ``parallel.shard_params`` parameters): rank 0 decodes and preprocesses
    and broadcasts the image and its focal length, every rank runs the
    sharded forward, and rank 0 alone writes the output."""
    check_mesh(cfg, mesh)
    runtime = runtime or RuntimeConfig()
    device = mesh.device if mesh is not None else runtime.resolved_device()
    dtype = runtime.image_dtype()
    configure_precision()
    lead = mesh is None or mesh.rank == 0
    pl = SplitProgressListener(progress)
    pl_model, pl_out = pl.split_range(0.9)
    pl_pre, pl_net = pl_model.split_range(0.05)
    shape = (1, cfg.img_size, cfg.img_size, 3)

    img = f_norm = src = None
    if lead:
        pl_pre.update_message("loading source image")
        try:
            with timings.span("decode source image"):
                src = source if source is not None else load_source_image(source_path,
                                                                           focal_length_35mm)
        except Exception as err:
            if mesh is not None:
                _share_inputs(mesh, _SKIP, None, [None], shape, dtype, device)
            raise _stage_error("Failed to load source image", err, "load") from err
        pl_pre.report_status(1.0)

        pl_net.update_message("extracting depth")
        try:
            with timings.span("preprocess (device)"):
                img = preprocess_image(src.rgb, cfg, dtype, device)
            f_norm = src.f_norm()
        except Exception as err:
            if mesh is not None:
                _share_inputs(mesh, _ABORT, None, [None], shape, dtype, device)
            raise _stage_error("Failed to process image", err, "model") from err
    if mesh is not None:
        status, img, (f_norm,) = (_share_inputs(mesh, _RUN, img, [f_norm], shape, dtype, device)
                                  if lead else
                                  _share_inputs(mesh, _RUN, None, [None], shape, dtype, device))
        if status != _RUN:
            raise _follower_error(status)
    try:
        with timings.span("model forward"), patch_sharded(mesh):
            inverse_depth = forward_photo(cfg, params, img, f_norm, mesh)
            original_size = src.original_size if lead else (cfg.img_size, cfg.img_size)
            depth_map = DepthMap.new(inverse_depth, original_size, cfg.metric)
            _wait_for_forward(device)
    except Exception as err:
        raise _stage_error("Failed to process image", err, "model") from err
    pl_net.report_status(1.0)
    if not lead:
        return depth_map

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
    mesh=None,
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
    finished chunk is written first, then it raises.

    ``mesh``: as in :func:`extract_depth`, per chunk: rank 0 decodes,
    preprocesses and broadcasts the chunk and its focal lengths, every rank
    runs the sharded forward (the chunk split over the data axis where it
    divides ``batch_size``), rank 0 alone writes and reports failures."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    check_mesh(cfg, mesh)
    runtime = runtime or RuntimeConfig()
    device = mesh.device if mesh is not None else runtime.resolved_device()
    dtype = runtime.image_dtype()
    configure_precision()
    shape = (batch_size, cfg.img_size, cfg.img_size, 3)
    jobs = list(jobs)
    chunks = [jobs[i:i + batch_size] for i in range(0, len(jobs), batch_size)]
    if mesh is not None and mesh.rank != 0:
        for _chunk in chunks:
            status, img, f_norms = _share_inputs(mesh, _RUN, None, [None] * batch_size, shape,
                                                 dtype, device)
            if status == _ABORT:
                raise _follower_error(status)
            if status == _RUN:
                try:
                    with patch_sharded(mesh):
                        forward_batch(cfg, params, img, f_norms, mesh)
                except Exception as err:
                    raise _stage_error("Failed to process image", err, "model") from err
        return

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
                if mesh is not None:
                    _share_inputs(mesh, _SKIP, None, [None] * batch_size, shape, dtype, device)
                flush_pending()
                pl_model.report_status(1.0)
                continue

            pl_model.update_message("extracting depth")
            shared = mesh is None
            try:
                with timings.span("preprocess (device)"):
                    imgs = [preprocess_image(s.rgb, cfg, dtype, device) for _job, s in live]
                f_norms = [s.f_norm() for _job, s in live]
                if not shared:  # on a mesh, Depth Pro's: one input size
                    shared = True
                    pad = batch_size - len(live)
                    _share_inputs(mesh, _RUN, torch.cat(imgs + imgs[-1:] * pad),
                                  f_norms + f_norms[-1:] * pad, shape, dtype, device)
                with timings.span("model forward"), patch_sharded(mesh):
                    inv = forward_groups(cfg, params, imgs, f_norms, batch_size, mesh=mesh)
                    _wait_for_forward(device)
            except Exception as err:
                if not shared:  # the other ranks wait for this chunk
                    _share_inputs(mesh, _ABORT, None, [None] * batch_size, shape, dtype, device)
                raise _stage_error("Failed to process image", err, "model") from err
            pl_model.report_status(1.0)

            # this chunk's renders and copies enter the stream before
            # anything else: the writes below and the next chunk's forward
            outs, writers = [], []
            for i, ((src_path, out_path), s) in enumerate(live):
                try:
                    writers.append(DepthMap.new(inv[i], s.original_size, cfg.metric).prepare_output(
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
