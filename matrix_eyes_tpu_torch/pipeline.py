"""Single-image pipeline: photo -> depth -> depth-map or stereogram file.

Port of ``matrix_eyes_tpu/pipeline.py`` (``preprocess_image`` and
``extract_depth``): decode the source image on the host, preprocess on the
device, run the model (the FOV head estimates the focal length when EXIF
and the flag give none), render and save. Each stage prints its own
failure message to stderr and tags the error with its stage: only the
decode is the per-image 'load' stage; preprocess and forward failures are
'model' failures, which are systemic (device, weights).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from matrix_eyes_tpu_torch.errors import MatrixEyesError, ReconstructionError
from matrix_eyes_tpu_torch.io.image import SourceImage, load_source_image
from matrix_eyes_tpu_torch.progress import SplitProgressListener
from matrix_eyes_tpu_torch.config import ModelConfig, RuntimeConfig, configure_precision
from matrix_eyes_tpu_torch.models import depth_pro
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.output.depthmap import DepthMap, ImageOutputFormat


def preprocess_image(rgb_u8: np.ndarray, img_size: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """Lanczos3 resize to the model resolution, round back to u8 (the
    reference resizes the u8 image), scale to [0, 1], normalise with
    mean = std = 0.5. Returns (1, S, S, 3) NHWC."""
    x = torch.tensor(rgb_u8, device=device).float()
    x = to_u8(resize_lanczos3(x, img_size, img_size)).float()
    x = (x / 255.0 - 0.5) / 0.5
    return x[None].to(dtype)


def extract_depth(
    cfg: ModelConfig,
    params: Dict[str, Any],
    source_path: str,
    destination_path: str,
    focal_length_35mm: Optional[float] = None,
    image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
    resize_scale: Optional[float] = None,
    stereo_amplitude: float = 1.0 / 16.0,
    runtime: Optional[RuntimeConfig] = None,
    progress=None,
    source: Optional[SourceImage] = None,
) -> DepthMap:
    """Full pipeline for one image; returns the DepthMap it wrote.
    ``params`` must already lie on the runtime's device; ``source``, when
    given, is the decoded image and ``source_path`` is not read. A
    stereogram's noise comes from ``runtime.seed``."""
    runtime = runtime or RuntimeConfig()
    device = runtime.resolved_device()
    dtype = runtime.resolved_dtype()
    configure_precision()
    pl = SplitProgressListener(progress)
    pl_model, pl_out = pl.split_range(0.9)
    pl_pre, pl_net = pl_model.split_range(0.05)

    def stage_error(msg: str, err: Exception, stage: str):
        print(f"{msg}: {err}", file=sys.stderr)
        out = err if isinstance(err, MatrixEyesError) else ReconstructionError(f"{msg}: {err}")
        out.stage = stage
        return out

    pl_pre.update_message("loading source image")
    try:
        src = source if source is not None else load_source_image(source_path,
                                                                   focal_length_35mm)
    except Exception as err:
        raise stage_error("Failed to load source image", err, "load") from err
    pl_pre.report_status(1.0)

    pl_net.update_message("extracting depth")
    try:
        img = preprocess_image(src.rgb, cfg.img_size, dtype, device)
        f_norm = src.f_norm()
        if f_norm is not None:
            inverse_depth = depth_pro.forward_with_fnorm(cfg, params, img, f_norm)[0]
        else:
            inv, _fov_deg = depth_pro.forward_with_fov(cfg, params, img)
            inverse_depth = inv[0]
        depth_map = DepthMap.new(inverse_depth, src.original_size)
    except Exception as err:
        raise stage_error("Failed to process image", err, "model") from err
    pl_net.report_status(1.0)

    pl_out.update_message("writing output")
    try:
        depth_map.output_image(destination_path, image_format=image_format,
                               resize_scale=resize_scale, amplitude=stereo_amplitude,
                               seed=runtime.seed)
    except Exception as err:
        raise stage_error("Failed to output result", err, "output") from err
    pl_out.report_status(1.0)
    return depth_map
