"""Analytic model-FLOP ledger and MFU accounting.

A copy of ``matrix_eyes_tpu/flops.py``: the same names and the same
arithmetic, term for term, so both packages give the same floats.

Counts the dot-product work (matmuls, attention, convolutions — 2*M*N*K
per GEMM) of the LOGICAL Depth Pro forward described by a ``ModelConfig``:
the math the reference computes (mod.rs:251-363), independent of how this
implementation schedules it.  Elementwise work (norms, GELU, residuals,
colormap) and the resampling taps are orders of magnitude below the matmul
budget; resamples are included with their separable-pass tap counts, the
rest is excluded by the standard MFU convention.

Two deliberate properties:

* *Logical* FLOPs, not executed FLOPs: the patch pyramid's pad to a
  multiple of the mesh's data axis (35 -> 36 patches at data 2 or 4) and
  the head's deconv+conv composition (``models/head.py``) change the
  executed count; MFU is defined as useful-model-math / (time * peak) so
  padding shows up as lost utilisation rather than inflated FLOPs.
* Per-stage ledger, so the whole-model number reconciles against per-stage
  device times (patch ViT, decoder, head).

Depth Anything V2's ledger (``dav2_flops``, the port's own: the JAX
package has no such model) counts the same way, at the input's grid: the
ViT at its token count, the DPT head's projections, transposed convs and
convs as published (the fusion blocks' 1x1 after the upsampling), the
bilinear and bicubic resamplings left out.

``device_peak_flops`` looks the card's name (``torch.cuda.get_device_name``)
up in ``_PEAKS`` by exact equality and returns its published dense bf16
peak; MFU is reported against that whatever the ``--dtype`` policy (an f32
run against the same peak gives the "fraction of the card" number).
"""

from __future__ import annotations

from typing import Dict, Optional

from matrix_eyes_tpu_torch.config import DepthAnythingConfig, ModelConfig, RuntimeConfig


def _split_tiles(size: int, patch: int, overlap_div: int) -> int:
    """Tiles per side of encoder.split (encoder.rs:142-156)."""
    stride = patch - patch // overlap_div
    return (size - patch) // stride + 1


def vit_flops(cfg: ModelConfig, n_samples: int = 1) -> float:
    """One DINOv2 ViT forward (vit.rs:226-347): patch embed + L blocks.

    Per block: qkv (2*N*D*3D) + scores (2*N^2*D) + attn@v (2*N^2*D) +
    proj (2*N*D*D) + MLP (2 * 2*N*D*(M*D)).
    """
    N = cfg.seq_len
    D = cfg.embed_dim
    patch_embed = 2 * cfg.num_patch_tokens * (cfg.patch_size ** 2 * 3) * D
    per_block = (
        (8 + 4 * cfg.mlp_ratio) * N * D * D  # qkv + proj + mlp matmuls
        + 4 * N * N * D                      # QK^T + AV
    )
    return float(n_samples) * (patch_embed + cfg.depth * per_block)


def _conv(h: int, w: int, cin: int, cout: int, k: int = 1) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _upsample_chain(grid: int, dim_in: int, dim_out: int, n_up: int,
                    dim_int: Optional[int] = None) -> float:
    """1x1 projection + n_up 2x2/s2 deconvs (encoder.rs:85-118; shapes in
    models/spec._upsample_spec).  A 2x2/s2 deconv touches each input pixel
    once per output phase: 2 * (2G)^2 * cin * cout."""
    dim_int = dim_out if dim_int is None else dim_int
    total = _conv(grid, grid, dim_in, dim_int)
    g, cin = grid, dim_int
    for _ in range(n_up):
        g *= 2
        total += _conv(g, g, cin, dim_out)
        cin = dim_out
    return total


def model_flops(cfg: ModelConfig, batch: int = 1,
                with_fov: bool = True) -> Dict[str, float]:
    """Per-stage logical FLOP ledger for one forward of ``batch`` images.

    Keys mirror the pipeline stages (mod.rs:251-363); ``total`` sums them.
    """
    P = cfg.vit_img_size
    T = cfg.tokens_per_side
    D = cfg.embed_dim
    ef = cfg.encoder_feature_dims
    dec = cfg.decoder_features
    l0, l1 = cfg.head_last_dims
    S = cfg.img_size

    n0 = _split_tiles(S, P, 4) ** 2          # 25 for production
    n1 = _split_tiles(S // 2, P, 2) ** 2     # 9
    n_patches = n0 + n1 + 1                  # 35 (encoder.rs:238-250)

    ledger: Dict[str, float] = {}
    ledger["patch_vit"] = vit_flops(cfg, n_patches)
    ledger["image_vit"] = vit_flops(cfg, 1)

    # per-scale projection + upsample chains (encoder.rs:305-326).
    # Merged grids: hi-res levels 4T per side, x1 2T, x2/global T.
    g_hi, g_mid, g_lo = 4 * T, 2 * T, T
    chains = (
        _upsample_chain(g_hi, D, dec, 3, dim_int=ef[0])   # latent0 -> 32T
        + _upsample_chain(g_hi, D, ef[0], 2)              # latent1 -> 16T
        + _upsample_chain(g_hi, D, ef[1], 1)              # x0 -> 8T
        + _upsample_chain(g_mid, D, ef[2], 1)             # x1 -> 4T
        + _upsample_chain(g_lo, D, ef[3], 1)              # x2 -> 2T
        + _conv(2 * g_lo, 2 * g_lo, D, ef[3])             # upsample_lowres
        + _conv(2 * g_lo, 2 * g_lo, 2 * ef[3], ef[3])     # fuse_lowres
    )
    ledger["encoder_chains"] = chains

    # DPT decoder (decoder.rs:105-209): 3x3 projections for levels 1..4,
    # fusion blocks coarse->fine.  Level i feature grid: 32T / 2^i.
    grids = [32 * T // (1 << i) for i in range(5)]
    proj = sum(_conv(g, g, c, dec, 3)
               for g, c in zip(grids[1:], ef))
    rcu = lambda g: 2 * _conv(g, g, dec, dec, 3)  # noqa: E731
    fus = 0.0
    for i in range(4, -1, -1):
        g = grids[i]
        if i != 4:
            fus += rcu(g)                    # resnet1 (skip path)
        fus += rcu(g)                        # resnet2
        if i != 0:
            fus += _conv(2 * g, 2 * g, dec, dec)   # deconv (out conv folded)
        else:
            fus += _conv(g, g, dec, dec)           # out 1x1
    ledger["decoder"] = proj + fus

    # depth head (mod.rs:307-334), logical formulation
    gh = 32 * T
    ledger["head"] = (
        _conv(gh, gh, dec, dec // 2, 3)                  # conv0
        + _conv(2 * gh, 2 * gh, dec // 2, dec // 2)      # deconv1 2x2/s2
        + _conv(2 * gh, 2 * gh, dec // 2, l0, 3)         # conv2
        + _conv(2 * gh, 2 * gh, l0, l1)                  # conv3 1x1
    )

    if with_fov:
        k = T // 4
        ledger["fov_vit"] = vit_flops(cfg, 1)
        ledger["fov_head"] = (
            2.0 * T * T * D * (dec // 2)                 # linear on tokens
            + _conv(T, T, dec, dec // 2, 3)              # downsample0 s2
            + _conv(T // 2, T // 2, dec // 2, dec // 4, 3)   # head0 s2
            + _conv(T // 4, T // 4, dec // 4, dec // 8, 3)   # head1 s2
            + _conv(1, 1, dec // 8, 1, k)                # head2 valid
        )

    # resamples: separable Lanczos3/bilinear passes, ~2*px*taps*3ch per
    # pass (io preprocess counted by the caller when it knows the source
    # size; here the fixed pyramid downsamples, resize.rs analogues)
    ledger["resamples"] = 3 * 2.0 * ((S // 2) ** 2 + (S // 4) ** 2) * 6 * 2

    total = sum(ledger.values()) * batch
    ledger = {k: v * batch for k, v in ledger.items()}
    ledger["total"] = total
    return ledger


def dav2_flops(cfg: DepthAnythingConfig, height: int, width: int,
               batch: int = 1) -> Dict[str, float]:
    """Per-stage logical FLOPs of one Depth Anything V2 forward of ``batch``
    inputs of height x width (multiples of the patch): ``vit`` (patch embed
    and blocks at 1 + gh * gw tokens), ``reassemble`` (the four 1x1
    projections, the 4x4/s4 and 2x2/s2 transposed convs, the 3x3/s2 conv),
    ``fusion`` (the four ``layer{i}_rn`` 3x3 convs, the residual conv units,
    the 1x1 ``out_conv`` at each upsampled size) and ``head`` (3x3, 3x3,
    1x1); ``total`` sums them."""
    p = cfg.patch_size
    gh, gw = height // p, width // p
    N, D, M = gh * gw + 1, cfg.embed_dim, cfg.mlp_ratio
    oc, F = cfg.out_channels, cfg.features
    h1, h2 = cfg.head_widths
    ledger: Dict[str, float] = {}
    ledger["vit"] = (2.0 * gh * gw * (p * p * 3) * D
                     + cfg.depth * ((8 + 4 * M) * N * D * D + 4 * N * N * D))
    lh, lw = (gh + 1) // 2, (gw + 1) // 2  # the 3x3/s2, pad 1
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (lh, lw)]
    ledger["reassemble"] = (sum(_conv(gh, gw, D, c) for c in oc)
                            + _conv(gh, gw, oc[0], oc[0], 4)     # 4x4/s4: each pixel once
                            + _conv(gh, gw, oc[1], oc[1], 2)     # 2x2/s2
                            + _conv(lh, lw, oc[3], oc[3], 3))    # 3x3/s2
    rcu = lambda h, w: 2 * _conv(h, w, F, F, 3)  # noqa: E731
    fusion = sum(_conv(h, w, c, F, 3) for (h, w), c in zip(sizes, oc))
    # the size each fusion block (refinenet1..4) upsamples to
    targets = [(2 * sizes[0][0], 2 * sizes[0][1])] + sizes[:3]
    for i in range(4):
        h, w = sizes[i]
        fusion += rcu(h, w) * (1 if i == 3 else 2) + _conv(*targets[i], F, F)
    ledger["fusion"] = fusion
    fh, fw = targets[0]
    ledger["head"] = (_conv(fh, fw, F, h1, 3) + _conv(height, width, h1, h2, 3)
                      + _conv(height, width, h2, 1))
    ledger = {k: v * batch for k, v in ledger.items()}
    ledger["total"] = sum(ledger.values())
    return ledger


# Published dense bf16 peak, FLOP/s, by the exact name
# torch.cuda.get_device_name gives. The H100 SXM (NVIDIA's data sheet, at
# its 700 W limit). Other H100s ("NVIDIA H100 PCIe", "NVIDIA H100 NVL")
# have lower peaks, so a name matches only in full, never by prefix.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak of the given (None: the current) CUDA device, or None
    when its name is not in ``_PEAKS`` or the device is the CPU. Without a
    card, ``device=None`` raises ``NoCudaDevice``: the port never picks the
    CPU on its own."""
    import torch

    device = RuntimeConfig(device=device).resolved_device()
    if device.type != "cuda":
        return None
    return _PEAKS.get(torch.cuda.get_device_name(device))


def mfu(total_flops: float, seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """Model FLOP utilisation: useful model math per second over the
    card's dense bf16 peak. None when the peak is unknown or seconds <= 0."""
    peak = device_peak_flops() if peak is None else peak
    if peak is None or seconds <= 0:
        return None
    return total_flops / seconds / peak
