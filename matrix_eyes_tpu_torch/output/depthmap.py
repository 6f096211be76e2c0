"""Depth-map container and its outputs, the viridis depth map, the
autostereogram and the OBJ/PLY mesh (port of
``matrix_eyes_tpu/output/depthmap.py``).

The inverse depth stays on the device through clamping, normalisation, the
colour lookup and the stereogram's shift plane; the host sees pixels only
to encode. An output runs in two phases, as the JAX package's:
``prepare_output`` enqueues the device work and the copy of its result to
pinned host memory, and returns a writer that waits for that copy alone,
then encodes and writes. The port runs on one CUDA stream, FIFO like the
TPU's queue, so a batch enqueues chunk k's outputs before chunk k+1's
forward and chunk k's writers do not wait out that forward. Save policy:

* depth map: a PNG larger than the grid is upsized on the host from the
  grid image (3 B/px crosses to the host at grid size) when the native
  resizer and encoder are present; otherwise the image is resized on the
  device and encoded at full size; other formats go through PIL;
* stereogram: a PNG takes the compact (shift, noise) form when the native
  encoder is present and the geometry allows it (shifts up to 255, not
  ``wide``): both planes are made on the device and read back; otherwise
  the image is resolved on the device (the linker-scan kernel on the card)
  and encoded under the STEREOGRAM profile, or written by PIL for other
  formats;
* mesh (``.obj``/``.ply``): the clamped grid is read back and triangulated
  on the host (``output/mesh.py``, ``output/writers.py``); vertex colours
  come from the source file Lanczos3-resized to the grid on the device.

The renders run through the CUDA-graph cache (``aot.call_cached``) under the
JAX package's names, ``render_depthmap_grid`` and ``render_depthmap``; the
copies to the host stay outside the graphs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from matrix_eyes_tpu_torch import aot, timings
from matrix_eyes_tpu_torch.errors import OutputError
from matrix_eyes_tpu_torch.ops.colormap import map_depth
from matrix_eyes_tpu_torch.ops.resize import resize_lanczos3, to_u8
from matrix_eyes_tpu_torch.ops.stereogram import (
    synthesize_stereogram,
    synthesize_stereogram_split,
)
from matrix_eyes_tpu_torch.output import png

CLIP_DEPTH_MIN = 0.1
CLIP_DEPTH_MAX = 250.0


class ImageOutputFormat(enum.Enum):
    DEPTH_MAP = "depthmap"
    STEREOGRAM = "stereogram"


class VertexMode(enum.Enum):
    PLAIN = "plain"
    COLOR = "vertex-colors"
    TEXTURE = "texture-coordinates"


def stereogram_size(original_size: Tuple[int, int],
                    resize_scale: Optional[float]) -> Tuple[int, int]:
    """(ow, oh) of the stereogram output: the source size under the
    reference's f32::round (half away from zero) scaling (output.rs:154)."""
    ow, oh = original_size
    if resize_scale is not None:
        ow = int(np.floor(np.float32(ow) * np.float32(resize_scale) + 0.5))
        oh = int(np.floor(np.float32(oh) * np.float32(resize_scale) + 0.5))
    return ow, oh


def clamp_inverse_depth(inverse_depth: torch.Tensor) -> torch.Tensor:
    return torch.clamp(inverse_depth.float(), 1.0 / CLIP_DEPTH_MAX, 1.0 / CLIP_DEPTH_MIN)


def render_depth_map_grid(data: torch.Tensor) -> torch.Tensor:
    """Normalise (near = bright) and colour at grid resolution: u8 (H, W, 3)."""
    dmin = data.min()
    dmax = data.max()
    denom = dmax - dmin
    value = torch.where(denom > 0, (dmax - data) / denom, torch.zeros_like(data))
    return map_depth(value)


def render_depth_map(data: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The grid image Lanczos3-resized to (out_h, out_w) on the device."""
    rgb = render_depth_map_grid(data)
    return to_u8(resize_lanczos3(rgb.float(), out_h, out_w))


def readback(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Enqueue ``t``'s copy to the host now and return a function that waits
    for that copy alone (the span ``output.wait``) and gives it as numpy. On
    the card the copy goes to pinned memory behind an event on the current
    stream, so work enqueued after it (a batch's next forward) does not hold
    it up."""
    if t.device.type != "cuda":
        def wait() -> np.ndarray:
            with timings.trace("output.wait"):
                return t.numpy()

        return wait
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait() -> np.ndarray:
        with timings.trace("output.wait"):
            done.synchronize()
        return host.numpy()

    return wait


@dataclass
class DepthMap:
    """Clamped inverse-depth grid + original image size (width, height)."""

    data: torch.Tensor  # (H, W) f32, clamped to [1/250, 1/0.1]
    original_size: Tuple[int, int]

    @classmethod
    def new(cls, inverse_depth: torch.Tensor, original_size: Tuple[int, int]) -> "DepthMap":
        return cls(data=clamp_inverse_depth(inverse_depth), original_size=original_size)

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def render_stereogram(self, resize_scale: Optional[float], amplitude: float,
                          seed: int = 0) -> torch.Tensor:
        """The device-resolved stereogram, (oh, ow, 3) u8 on the grid's device."""
        ow, oh = stereogram_size(self.original_size, resize_scale)
        return synthesize_stereogram(self.data, oh, ow, amplitude, seed)

    def prepare_output(
        self,
        destination_path: str,
        source_path: str,
        image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
        vertex_mode: VertexMode = VertexMode.COLOR,
        resize_scale: Optional[float] = None,
        amplitude: float = 1.0 / 16.0,
        seed: int = 0,
    ) -> Callable[[], None]:
        """Phase 1 of :meth:`output_image`: enqueue this output's device
        work and its copy to the host now; return the zero-argument writer
        of phase 2 (wait for that copy, encode, write the file)."""
        dest = destination_path.lower()
        if dest.endswith((".ply", ".obj")):
            return self._prepare_mesh(destination_path, source_path, VertexMode(vertex_mode))
        if ImageOutputFormat(image_format) == ImageOutputFormat.STEREOGRAM:
            return self._prepare_stereogram(destination_path, resize_scale, amplitude, seed)
        ow, oh = self.original_size
        gh, gw = self.data.shape
        if dest.endswith(".png") and oh * ow > gh * gw and png.host_resize_supported():
            # upsizing to the source photo: the grid-resolution colour
            # image crosses to the host and is Lanczos3-upsized there
            with timings.span("output: render dispatch"):
                grid = readback(aot.call_cached("render_depthmap_grid", render_depth_map_grid,
                                                (self.data,)))
            return lambda: png.save_depthmap_host_resize(grid(), destination_path, oh, ow)
        with timings.span("output: render dispatch"):
            rgb = readback(aot.call_cached("render_depthmap", render_depth_map,
                                           (self.data, oh, ow)))
        if dest.endswith(".png"):
            return lambda: png.save_rgb(rgb(), destination_path)
        return lambda: png.pil_save(rgb(), destination_path)

    def output_image(
        self,
        destination_path: str,
        source_path: str,
        image_format: ImageOutputFormat = ImageOutputFormat.DEPTH_MAP,
        vertex_mode: VertexMode = VertexMode.COLOR,
        resize_scale: Optional[float] = None,
        amplitude: float = 1.0 / 16.0,
        seed: int = 0,
    ) -> None:
        """Write the viridis depth map at the source size, the stereogram at
        the source size times ``resize_scale``, or (``.obj``/``.ply``) the
        mesh in ``vertex_mode``; ``source_path`` is the photo that a mesh's
        vertex colours and texture refer to."""
        with timings.trace("output.write"):
            self.prepare_output(destination_path, source_path, image_format=image_format,
                                vertex_mode=vertex_mode, resize_scale=resize_scale,
                                amplitude=amplitude, seed=seed)()

    def _prepare_stereogram(self, destination_path: str, resize_scale: Optional[float],
                            amplitude: float, seed: int) -> Callable[[], None]:
        dest = destination_path.lower()
        if dest.endswith(".png") and png.split_supported():
            ow, oh = stereogram_size(self.original_size, resize_scale)
            with timings.span("output: render dispatch"):
                split = synthesize_stereogram_split(self.data, oh, ow, amplitude, seed)
            if split is not None:
                pw, shift, noise = split
                noise, shift = readback(noise), readback(shift)
                return lambda: png.save_stereogram_split(shift(), noise(), destination_path, pw)
        with timings.span("output: render dispatch"):
            rgb = readback(self.render_stereogram(resize_scale, amplitude, seed))
        if dest.endswith(".png"):
            return lambda: png.save_rgb(rgb(), destination_path, png.STEREOGRAM)
        return lambda: png.pil_save(rgb(), destination_path)

    def _prepare_mesh(self, destination_path: str, source_path: str,
                      vertex_mode: VertexMode) -> Callable[[], None]:
        """The grid (and, for vertex colours, the source resized to it)
        cross to the host; the writer triangulates and serialises there."""
        from matrix_eyes_tpu_torch.output import writers
        from matrix_eyes_tpu_torch.output.mesh import build_mesh

        data = readback(self.data)
        image_rgb = None
        if vertex_mode == VertexMode.COLOR:
            image_rgb = readback(self._load_grid_image(source_path, tuple(self.data.shape),
                                                       self.data.device))

        def write() -> None:
            grid = data()
            colors = image_rgb() if image_rgb is not None else None
            mesh = build_mesh(grid)
            try:
                if destination_path.lower().endswith(".ply"):
                    writers.write_ply(destination_path, mesh, grid, self.original_size,
                                      vertex_mode.value, colors)
                else:
                    writers.write_obj(destination_path, mesh, grid, self.original_size,
                                      vertex_mode.value, colors, source_image_path=source_path)
            except OSError as e:
                raise OutputError(f"IO error: {e}") from e

        return write

    @staticmethod
    def _load_grid_image(source_path: str, grid_shape: Tuple[int, int],
                         device) -> torch.Tensor:
        """The source file Lanczos3-resized to the depth grid on the device,
        u8 (H, W, 3), for vertex colours (output.rs:206-215). As in the
        reference, the file is read without its EXIF orientation."""
        from PIL import Image

        try:
            with Image.open(source_path) as im:
                rgb = np.asarray(im.convert("RGB"))
        except (OSError, ValueError) as e:
            raise OutputError(f"Image error: {e}") from e
        h, w = grid_shape
        return to_u8(resize_lanczos3(torch.tensor(rgb, device=device).float(), h, w))
