"""Model and runtime configuration of the PyTorch port.

A copy of ``matrix_eyes_tpu/config.py``: ``ModelConfig`` with the
``DEPTH_PRO``, ``MID`` and ``TINY`` configurations, and a ``RuntimeConfig``
for the device and the dtype policies of ``--dtype``: the compute dtypes
f32, bf16 and f16, and the weight policies int8 (``quantize_int8``) and
mixed (``mixed_bf16``), both with a bf16 ViT. The port runs on the CUDA
card unless the caller asks for the CPU (``device="cpu"``); the default
dtype is bf16 on CUDA and f32 on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    @property
    def img_size(self) -> int:
        return self.vit_img_size * 4

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
