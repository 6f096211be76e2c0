"""Library API: load the model once, process many photos (port of
``matrix_eyes_tpu/api.py``).

    from matrix_eyes_tpu_torch.api import MatrixEyes

    me = MatrixEyes("./checkpoints/depth_pro.pt")     # on the card, bf16
    depth = me.inverse_depth("photo.jpg")              # (1536, 1536) np.f32
    me.process("photo.jpg", "out.png", image_format="stereogram")
    me.process("photo.jpg", "mesh.obj", vertex_mode="plain")
    me.process_batch([("a.jpg", "a.png"), ("b.jpg", "b.png")], batch_size=2)

The session runs on the card unless ``device="cpu"`` is asked for. On a
device mesh (``parallel.launch``, one process per rank), each rank opens
its own session and passes its ``mesh`` to ``inverse_depth_batch`` or
``process_batch``; a session on the CPU with a mesh of cards moves only
each rank's cut of the parameters to its card.

While the port records spans (``timings``), ``process``, ``depth_map`` and
``inverse_depth_batch`` each record one (``api.<method>``), the root of a
request when called from outside, and ``inverse_depth_batch`` its copy of
the result to the host (``api.readback``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.config import (
    ModelConfig,
    RuntimeConfig,
    configure_precision,
    parse_dtype_policy,
)
from matrix_eyes_tpu_torch.io.image import SourceImage, load_source_image
from matrix_eyes_tpu_torch.output.depthmap import DepthMap, ImageOutputFormat, VertexMode
from matrix_eyes_tpu_torch.parallel.sharding import patch_sharded
from matrix_eyes_tpu_torch.pipeline import (
    extract_depth_batch,
    forward_batch,
    forward_photo,
    preprocess_image,
)
from matrix_eyes_tpu_torch.pt.loader import load_checkpoint

Image = Union[str, np.ndarray, SourceImage]


class MatrixEyes:
    """A loaded model. ``dtype``: a policy of the CLI's ``--dtype`` ("f32",
    "bf16", "f16", "int8", "mixed") or a torch dtype, None for bf16 on the
    card and f32 on the CPU;
    ``seed``: stereogram noise; ``cfg``: the architecture, inferred from
    the checkpoint when None; ``device``: None for the card, "cpu" for the
    CPU; ``convert_checkpoints``: write the weight caches beside the
    checkpoint (``pt.loader``), which later sessions load from."""

    def __init__(self, checkpoint_path: str, dtype: Union[str, torch.dtype, None] = None,
                 seed: int = 0, cfg: Optional[ModelConfig] = None, device=None,
                 convert_checkpoints: bool = False):
        quantize_int8 = mixed_bf16 = False
        if isinstance(dtype, str):
            dtype, quantize_int8, mixed_bf16 = parse_dtype_policy(dtype)
        self.runtime = RuntimeConfig(dtype=dtype, device=device, seed=seed,
                                     quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
        configure_precision()
        self.cfg, self.params = load_checkpoint(
            checkpoint_path, dtype=self.runtime.resolved_dtype(),
            device=self.runtime.resolved_device(), convert_checkpoints=convert_checkpoints,
            cfg=cfg, quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
        self._sharded = {}  # parallel.Mesh -> this rank's parameters

    # -- depth -------------------------------------------------------------

    @staticmethod
    def _load(image: Image, focal_length_35mm: Optional[float]) -> SourceImage:
        if isinstance(image, SourceImage):
            if focal_length_35mm is None:
                return image
            # an explicit focal length wins over the pre-loaded source's
            return dataclasses.replace(image, focal_length_35mm=focal_length_35mm)
        if isinstance(image, str):
            return load_source_image(image, focal_length_35mm)
        rgb = np.asarray(image, dtype=np.uint8)
        return SourceImage(rgb=rgb, original_size=(rgb.shape[1], rgb.shape[0]),
                           focal_length_35mm=focal_length_35mm)

    def _preprocess(self, src: SourceImage, mesh=None) -> torch.Tensor:
        device = mesh.device if mesh is not None else self.runtime.resolved_device()
        return preprocess_image(src.rgb, self.cfg.img_size, self.runtime.image_dtype(), device)

    def _params_for_mesh(self, mesh):
        """The session's parameters cut for ``mesh`` (``parallel.shard_params``),
        cached per mesh: the head-group permutation and the copies to the
        rank's device are paid once."""
        if mesh is None:
            return self.params
        from matrix_eyes_tpu_torch.parallel.sharding import shard_params

        if mesh not in self._sharded:
            self._sharded[mesh] = shard_params(self.params, mesh, num_heads=self.cfg.num_heads)
        return self._sharded[mesh]

    def depth_map(self, image: Image, focal_length_35mm: Optional[float] = None) -> DepthMap:
        """Run the network on one image; returns the DepthMap on the device."""
        with timings.trace("api.depth_map"):
            src = self._load(image, focal_length_35mm)
            inv = forward_photo(self.cfg, self.params, self._preprocess(src), src.f_norm())
            return DepthMap.new(inv, src.original_size)

    def inverse_depth(self, image: Image,
                      focal_length_35mm: Optional[float] = None) -> np.ndarray:
        """Clamped inverse depth at the model's grid, numpy f32."""
        return self.depth_map(image, focal_length_35mm).to_numpy()

    def inverse_depth_batch(self, images: Sequence[Image],
                            focal_length_35mm: Union[float, Sequence[Optional[float]],
                                                     None] = None,
                            mesh=None) -> np.ndarray:
        """One forward over a stack of images (paths or (H, W, 3) u8 arrays,
        sizes may differ). ``focal_length_35mm``: None (each image's EXIF;
        the FOV head fills the gaps), one value for all, or one per image
        (None where unknown). Returns the model's (B, S, S) inverse depth,
        f32, clamped to [1e-4, 1e4] as the forward clamps it.

        ``mesh`` (``parallel.make_mesh``, inside ``parallel.launch``): every
        rank calls this with the same images; the batch is split over the
        mesh's data axis and the ViT blocks over its model axis (the cut
        parameters are cached per mesh), and every rank gets the whole
        result."""
        if not images:
            return np.zeros((0, self.cfg.img_size, self.cfg.img_size), np.float32)
        if focal_length_35mm is None or isinstance(focal_length_35mm, (int, float)):
            focals = [focal_length_35mm] * len(images)
        else:
            focals = list(focal_length_35mm)
            if len(focals) != len(images):
                raise ValueError(f"{len(images)} images but {len(focals)} focal lengths")
        with timings.trace("api.inverse_depth_batch"):
            srcs = [self._load(im, f) for im, f in zip(images, focals)]
            inv = self._forward(srcs, mesh=mesh)
            with timings.trace("api.readback"):
                return inv.cpu().numpy()

    def _forward(self, sources: Sequence[SourceImage], pad: int = 0,
                 mesh=None) -> torch.Tensor:
        """One forward over the sources and ``pad`` copies of the last one's
        preprocessed image: (B + pad, S, S) inverse depth on the device."""
        imgs = [self._preprocess(s, mesh) for s in sources]
        f_norms = [s.f_norm() for s in sources]
        params = self._params_for_mesh(mesh)
        with patch_sharded(mesh):
            return forward_batch(self.cfg, params, torch.cat(imgs + imgs[-1:] * pad),
                                 f_norms + f_norms[-1:] * pad, mesh)

    def depth_maps(self, sources: Sequence[SourceImage],
                   pad_to_pow2: bool = False) -> List[DepthMap]:
        """One batched forward over pre-loaded SourceImages; one DepthMap on
        the device per image. ``pad_to_pow2`` pads the batch to the next
        power of two with copies of the last preprocessed image (their
        outputs are dropped), so a server sees few batch shapes."""
        if not sources:
            return []
        n = len(sources)
        inv = self._forward(sources, (1 << (n - 1).bit_length()) - n if pad_to_pow2 else 0)
        return [DepthMap.new(inv[i], s.original_size) for i, s in enumerate(sources)]

    # -- full pipeline -----------------------------------------------------

    def process(self, source_path: str, destination_path: str,
                focal_length_35mm: Optional[float] = None, image_format: str = "depthmap",
                vertex_mode: str = "vertex-colors", resize_scale: Optional[float] = None,
                stereo_amplitude: float = 1.0 / 16.0) -> None:
        """Photo -> output file, the CLI's dispatch (output.rs:100-121)."""
        with timings.trace("api.process"):
            self.depth_map(source_path, focal_length_35mm).output_image(
                destination_path, source_path, image_format=ImageOutputFormat(image_format),
                vertex_mode=VertexMode(vertex_mode), resize_scale=resize_scale,
                amplitude=stereo_amplitude, seed=self.runtime.seed)

    def process_batch(self, jobs: Sequence[Tuple[str, str]], batch_size: int = 4,
                      focal_length_35mm: Optional[float] = None, image_format: str = "depthmap",
                      vertex_mode: str = "vertex-colors", resize_scale: Optional[float] = None,
                      stereo_amplitude: float = 1.0 / 16.0, mesh=None) -> None:
        """Photos -> output files, one forward per ``batch_size`` images
        (the CLI's ``--batch-size``; ``pipeline.extract_depth_batch``).
        ``jobs``: ``(source_path, destination_path)`` pairs. A failed decode
        or write skips that image; one ReconstructionError ("N of M images
        failed") follows at the end. A model failure raises at once.
        ``mesh``: every rank calls this with the same jobs; rank 0 decodes
        and writes, every rank runs the sharded forward."""
        extract_depth_batch(self.cfg, self._params_for_mesh(mesh), jobs, batch_size,
                            focal_length_35mm=focal_length_35mm,
                            image_format=ImageOutputFormat(image_format),
                            vertex_mode=VertexMode(vertex_mode), resize_scale=resize_scale,
                            stereo_amplitude=stereo_amplitude, runtime=self.runtime, mesh=mesh)
