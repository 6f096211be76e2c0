"""Model and runtime configuration of the PyTorch port.

A copy of ``matrix_eyes_tpu/config.py``: ``ModelConfig`` with the
``DEPTH_PRO``, ``MID`` and ``TINY`` configurations, and a ``RuntimeConfig``
for the device and the dtype policies of ``--dtype``: the compute dtypes
f32, bf16 and f16, and the weight policies int8 (``quantize_int8``) and
mixed (``mixed_bf16``), both with a bf16 ViT. The port runs on the CUDA
card unless the caller asks for the CPU (``device="cpu"``); the default
dtype is bf16 on CUDA and f32 on the CPU.

The port's second architecture, Depth Anything V2 (``DepthAnythingConfig``:
``DAV2_LARGE`` at the published sizes and ``DAV2_TINY`` for the CPU), has
no counterpart in the JAX package. What the two architectures do
differently the configuration says (class attributes and ``input_hw``):
its name, its parameter parts, whether its output is metric depth (a
clamped depth map, meshes) and whether it runs on a device mesh.
``config_to_dict``/``config_from_dict`` carry either through the weight
caches' JSON.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Depth Pro architecture: ViT-L/16 at 384^2, input 4 * 384 = 1536,
    highres intermediates after blocks 5 and 11 (defaults)."""

    vit_img_size: int = 384
    patch_size: int = 16
    depth: int = 24
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6  # the checkpoint's DINOv2 value, not torch's 1e-5
    encoder_feature_dims: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    decoder_features: int = 256
    head_last_dims: Tuple[int, int] = (32, 1)
    highres_block_ids: Tuple[int, int] = (5, 11)
    # carry the ViT residual stream in f32 when the compute dtype is narrower
    vit_f32_residual: bool = True

    architecture: ClassVar[str] = "depth_pro"
    parts: ClassVar[Tuple[str, ...]] = ("encoder", "decoder", "head", "fov")
    # metric inverse depth (clamped; meshes), and the forward on a device mesh
    metric: ClassVar[bool] = True
    runs_on_mesh: ClassVar[bool] = True

    @property
    def img_size(self) -> int:
        return self.vit_img_size * 4

    def input_hw(self, height: int, width: int) -> Tuple[int, int]:
        """(h, w) of the model's input for a height x width photo: the
        square ``img_size``."""
        return self.img_size, self.img_size

    def load_parts(self, requested: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
        """The parts to load: ``requested`` (all four where None)."""
        return self.parts if requested is None else tuple(requested)

    @property
    def tokens_per_side(self) -> int:
        return self.vit_img_size // self.patch_size

    @property
    def num_patch_tokens(self) -> int:
        return self.tokens_per_side * self.tokens_per_side

    @property
    def seq_len(self) -> int:
        return self.num_patch_tokens + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def __post_init__(self):
        if self.vit_img_size % self.patch_size != 0:
            raise ValueError("vit_img_size must be divisible by patch_size")
        if self.patch_size != 16:
            raise ValueError("patch_size must be 16 (the upsample chain assumes it)")
        if self.tokens_per_side % 8 != 0:
            raise ValueError("tokens_per_side (vit_img_size/patch_size) must be divisible by 8")
        if self.embed_dim % self.num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")


DEPTH_PRO = ModelConfig()

MID = ModelConfig(
    vit_img_size=128,
    patch_size=16,
    depth=4,
    embed_dim=128,
    num_heads=4,
    encoder_feature_dims=(64, 96, 128, 128),
    decoder_features=64,
    head_last_dims=(16, 1),
    highres_block_ids=(1, 3),
)

TINY = ModelConfig(
    vit_img_size=128,
    patch_size=16,
    depth=2,
    embed_dim=16,
    num_heads=2,
    encoder_feature_dims=(8, 12, 16, 16),
    decoder_features=8,
    head_last_dims=(4, 1),
    highres_block_ids=(0, 1),
)


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    """Depth Anything V2 (Yang et al., arXiv:2406.09414), defaults the
    published Large (``depth_anything_v2/dpt.py``, ``model_configs['vitl']``):
    a DINOv2 ViT-L/14 whose 37 x 37 position embedding (``input_size`` 518
    over patch 14) is interpolated to the image's grid, four taps after
    blocks ``taps`` each through the final LayerNorm, and a DPT head:
    1x1 projections to ``out_channels``, reassembly at 4x, 2x, 1x and 1/2x
    of the patch grid, 3x3 convs to ``features``, four fusion blocks that
    upsample bilinearly (``align_corners=True``), then 3x3 to
    ``head_widths[0]``, bilinear to the input's size, 3x3 to
    ``head_widths[1]``, ReLU, 1x1 to one channel, ReLU. The output is
    relative inverse depth (affine-invariant disparity), not metric."""

    input_size: int = 518
    patch_size: int = 14
    depth: int = 24
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    taps: Tuple[int, int, int, int] = (4, 11, 17, 23)
    features: int = 256
    out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    head_widths: Tuple[int, int] = (128, 32)
    # dpt.py's DPTHead options: BatchNorm in the fusion units, the CLS token
    # read into the projections; both False in the published models
    use_bn: bool = False
    use_clstoken: bool = False
    vit_f32_residual: bool = True

    architecture: ClassVar[str] = "depth_anything_v2"
    # the published module names: the DINOv2 and the DPT head
    parts: ClassVar[Tuple[str, ...]] = ("pretrained", "depth_head")
    metric: ClassVar[bool] = False
    runs_on_mesh: ClassVar[bool] = False

    @property
    def img_size(self) -> int:
        """The shorter side of the model's input (the longer one follows
        the photo's aspect, ``input_hw``)."""
        return self.input_size

    def input_hw(self, height: int, width: int) -> Tuple[int, int]:
        """(h, w) of the model's input for a height x width photo:
        ``util/transform.py``'s ``Resize(input_size, input_size,
        keep_aspect_ratio=True, ensure_multiple_of=patch,
        resize_method='lower_bound')``: one scale for both sides, the
        larger of input_size / side, then each side rounded (half to even)
        to a multiple of the patch, rounded up where that falls below
        input_size."""
        m, size = self.patch_size, self.input_size
        scale = max(size / height, size / width)

        def fit(x: float) -> int:
            y = int(round(x / m)) * m
            return math.ceil(x / m) * m if y < size else y

        return fit(scale * height), fit(scale * width)

    def load_parts(self, requested: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
        """Both parts, whatever Depth Pro's names were asked for."""
        return self.parts

    @property
    def pos_grid(self) -> int:
        """Side of the position embedding's grid of patches."""
        return self.input_size // self.patch_size

    @property
    def seq_len(self) -> int:
        """Tokens of the position embedding (the grid and the CLS token)."""
        return self.pos_grid * self.pos_grid + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def __post_init__(self):
        if self.input_size % self.patch_size != 0:
            raise ValueError("input_size must be a multiple of patch_size")
        if self.embed_dim % self.num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if len(self.taps) != 4 or list(self.taps) != sorted(set(self.taps)) or not (
                0 <= self.taps[0] and self.taps[-1] < self.depth):
            raise ValueError(f"taps must be four ascending block ids below depth, "
                             f"got {self.taps}")
        if len(self.out_channels) != 4 or len(self.head_widths) != 2:
            raise ValueError("out_channels takes four widths and head_widths two")
        if self.use_bn or self.use_clstoken:
            raise ValueError("use_bn and use_clstoken are not implemented (the published "
                             "models set both False)")


DAV2_LARGE = DepthAnythingConfig()

DAV2_TINY = DepthAnythingConfig(
    input_size=70,
    patch_size=14,
    depth=4,
    embed_dim=32,
    num_heads=2,
    taps=(0, 1, 2, 3),
    features=16,
    out_channels=(8, 16, 32, 32),
    head_widths=(8, 8),
)

AnyConfig = Union[ModelConfig, DepthAnythingConfig]
_CLASSES = {cls.architecture: cls for cls in (ModelConfig, DepthAnythingConfig)}


def config_to_dict(cfg: AnyConfig) -> Dict[str, Any]:
    """The configuration's fields; Depth Anything's also name the
    architecture (a Depth Pro dict has no ``architecture`` key, as the
    weight caches have always written it)."""
    d = dataclasses.asdict(cfg)
    if cfg.architecture != ModelConfig.architecture:
        d["architecture"] = cfg.architecture
    return d


def config_from_dict(d: Dict[str, Any]) -> AnyConfig:
    """The inverse of ``config_to_dict``; lists become tuples."""
    d = dict(d)
    cls = _CLASSES[d.pop("architecture", ModelConfig.architecture)]
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


_DTYPE_NAMES = {
    "f32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f16": torch.float16,
    "float16": torch.float16,
}


def parse_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPE_NAMES[name.lower()]
    except KeyError:
        raise ValueError(f"Unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPE_NAMES) + ['int8', 'mixed']}")


def parse_dtype_policy(name: str) -> Tuple[torch.dtype, bool, bool]:
    """The CLI's ``--dtype`` -> (compute dtype, quantize_int8, mixed_bf16).

    ``int8`` and ``mixed`` are weight policies, not compute dtypes: the ViT
    runs bf16 under both. ``int8`` stores the ViT block matmul weights as
    int8 codes with per-channel f32 scales (``ops/quant.py``); ``mixed``
    keeps only those weights bf16 and everything else f32, with true-f32
    arithmetic (``ops/mixed.py``). Every other name maps through
    :func:`parse_dtype`."""
    if name.lower() == "int8":
        return torch.bfloat16, True, False
    if name.lower() == "mixed":
        return torch.bfloat16, False, True
    return parse_dtype(name), False, False


def configure_precision() -> None:
    """Make f32 mean f32 on the card: cuBLAS matmuls and cuDNN convs both
    refuse TF32 (cuDNN allows it by default). This keeps the f32 GEMMs of
    ``--dtype f32`` and of the mixed policy's decoder, head and FOV true
    f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class NoCudaDevice(RuntimeError):
    """No CUDA device, and the caller did not ask for the CPU."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """dtype: parameter/compute dtype (accumulation is always f32); None
    picks bf16 on CUDA and f32 on the CPU. device: None means the CUDA card
    (and raises ``NoCudaDevice`` without one); the CPU runs only when asked
    for ("cpu"). seed: stereogram noise seed (the JAX package's threefry
    bits, ``ops/prng.py``, so a seed gives the same image on every device
    and under either package).
    quantize_int8: ``--dtype int8``, int8 ViT block matmul weights
    (``ops/quant.py``); needs the bf16 compute dtype. mixed_bf16:
    ``--dtype mixed``, bf16 ViT block matmul weights and everything else
    f32 (``ops/mixed.py``); needs the bf16 compute dtype, excludes int8."""

    dtype: Optional[torch.dtype] = None
    device: Optional[torch.device] = None
    seed: int = 0
    quantize_int8: bool = False
    mixed_bf16: bool = False

    def __post_init__(self):
        if self.quantize_int8 and self.dtype is not None and self.dtype != torch.bfloat16:
            raise ValueError(f"quantize_int8 requires the bf16 compute dtype (got {self.dtype})")
        if self.mixed_bf16:
            if self.quantize_int8:
                raise ValueError("mixed_bf16 and quantize_int8 are mutually exclusive "
                                 "weight-precision policies")
            if self.dtype is not None and self.dtype != torch.bfloat16:
                raise ValueError(f"mixed_bf16 requires the bf16 compute dtype (got {self.dtype})")

    def resolved_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise NoCudaDevice("no CUDA device found: matrix_eyes_tpu_torch runs on the card "
                               "unless the CPU is asked for (device=\"cpu\")")
        return torch.device("cuda")

    def resolved_dtype(self) -> torch.dtype:
        if self.quantize_int8 or self.mixed_bf16:
            return torch.bfloat16
        if self.dtype is not None:
            return self.dtype
        return torch.bfloat16 if self.resolved_device().type == "cuda" else torch.float32

    def image_dtype(self) -> torch.dtype:
        """The dtype the source image is preprocessed to. Under mixed the
        model gets an f32 image: every primitive returns its input's dtype,
        so the f32 image keeps the patch embed, the ViT's residual carry,
        the decoder and the head f32, while ``vit.block_forward`` casts the
        matmul inputs down to the weights' bf16."""
        if self.mixed_bf16:
            return torch.float32
        return self.resolved_dtype()
