"""The logical FLOP ledger of one Depth Pro forward, the card's published
peaks, and the roofline bounds of the forward's attention and 3x3
convolutions, all worked out from the model's shapes.

The Depth Pro functions (``model_flops``, ``attention_calls``,
``conv3x3_calls``, ``policy_dtypes``) are a frozen copy of the port's
(``flops.py``, itself the JAX package's term for term): dot-product work
only, 2 * M * N * K per GEMM, of the logical forward (the head's deconv
and conv as published, the pyramid unpadded), with the fixed pyramid
resamples. It counts the same work whatever implements it. The readers
reach them through the architecture (``eyebench/architectures/depth_pro.py``),
as they reach another architecture's ledger; the peaks, ``bound_s``,
``attention_bound_s``, ``conv3x3_bound_s`` and ``window_mfu`` depend on no
model's shapes and serve every architecture.

Roofline bound of a kernel call: the larger of its bytes over the HBM rate
(each input byte read once, each output byte written once) and its FLOPs
over the peak of its dtype: bf16 and f16 at the dense tensor-core peak,
f32 at the TF32 peak. No f32-accurate implementation does better than one
tensor-core product per product, so a share of this bound cannot pass 100%.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from eyebench.harness import architecture

# published dense rates of the NVIDIA H100 SXM (data sheet, 700 W), by the
# exact name torch.cuda.get_device_name gives: other H100s are slower
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f16": 989e12, "f32": 495e12,
                              "bytes_per_s": 3.35e12},
}


def peak(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def policy_dtypes(policy: str) -> Dict[str, str]:
    """The dtypes a ``--dtype`` policy computes in: the ViTs' and the
    decoder's and head's (int8 and mixed keep a bf16 ViT; mixed runs its
    decoder and head in f32)."""
    vit = {"f32": "f32", "f16": "f16"}.get(policy, "bf16")
    return {"vit": vit, "decoder": "f32" if policy in ("f32", "mixed") else vit}


def _split_tiles(size: int, patch: int, overlap_div: int) -> int:
    stride = patch - patch // overlap_div
    return (size - patch) // stride + 1


def _seq(cfg) -> int:
    t = cfg["vit_img_size"] // cfg["patch_size"]
    return t * t + 1


def vit_flops(cfg, n_samples: int = 1) -> float:
    N, D = _seq(cfg), cfg["embed_dim"]
    t = cfg["vit_img_size"] // cfg["patch_size"]
    patch_embed = 2 * t * t * (cfg["patch_size"] ** 2 * 3) * D
    per_block = (8 + 4 * cfg["mlp_ratio"]) * N * D * D + 4 * N * N * D
    return float(n_samples) * (patch_embed + cfg["depth"] * per_block)


def _conv(h: int, w: int, cin: int, cout: int, k: int = 1) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _upsample_chain(grid, dim_in, dim_out, n_up, dim_int=None) -> float:
    dim_int = dim_out if dim_int is None else dim_int
    total = _conv(grid, grid, dim_in, dim_int)
    g, cin = grid, dim_int
    for _ in range(n_up):
        g *= 2
        total += _conv(g, g, cin, dim_out)
        cin = dim_out
    return total


def model_flops(cfg, batch: int = 1, with_fov: bool = True) -> Dict[str, float]:
    """Per-stage logical FLOPs of one forward of ``batch`` images."""
    P = cfg["vit_img_size"]
    T = P // cfg["patch_size"]
    D = cfg["embed_dim"]
    ef = cfg["encoder_feature_dims"]
    dec = cfg["decoder_features"]
    l0, l1 = cfg["head_last_dims"]
    S = 4 * P
    n_patches = _split_tiles(S, P, 4) ** 2 + _split_tiles(S // 2, P, 2) ** 2 + 1
    ledger: Dict[str, float] = {"patch_vit": vit_flops(cfg, n_patches),
                                "image_vit": vit_flops(cfg, 1)}
    g_hi, g_mid, g_lo = 4 * T, 2 * T, T
    ledger["encoder_chains"] = (
        _upsample_chain(g_hi, D, dec, 3, dim_int=ef[0])
        + _upsample_chain(g_hi, D, ef[0], 2)
        + _upsample_chain(g_hi, D, ef[1], 1)
        + _upsample_chain(g_mid, D, ef[2], 1)
        + _upsample_chain(g_lo, D, ef[3], 1)
        + _conv(2 * g_lo, 2 * g_lo, D, ef[3])
        + _conv(2 * g_lo, 2 * g_lo, 2 * ef[3], ef[3]))
    grids = [32 * T // (1 << i) for i in range(5)]
    proj = sum(_conv(g, g, c, dec, 3) for g, c in zip(grids[1:], ef))
    fus = 0.0
    for i in range(4, -1, -1):
        g = grids[i]
        if i != 4:
            fus += 2 * _conv(g, g, dec, dec, 3)
        fus += 2 * _conv(g, g, dec, dec, 3)
        fus += _conv(2 * g, 2 * g, dec, dec) if i != 0 else _conv(g, g, dec, dec)
    ledger["decoder"] = proj + fus
    gh = 32 * T
    ledger["head"] = (_conv(gh, gh, dec, dec // 2, 3) + _conv(2 * gh, 2 * gh, dec // 2, dec // 2)
                      + _conv(2 * gh, 2 * gh, dec // 2, l0, 3) + _conv(2 * gh, 2 * gh, l0, l1))
    if with_fov:
        k = T // 4
        ledger["fov_vit"] = vit_flops(cfg, 1)
        ledger["fov_head"] = (2.0 * T * T * D * (dec // 2) + _conv(T, T, dec, dec // 2, 3)
                              + _conv(T // 2, T // 2, dec // 2, dec // 4, 3)
                              + _conv(T // 4, T // 4, dec // 4, dec // 8, 3)
                              + _conv(1, 1, dec // 8, 1, k))
    ledger["resamples"] = 3 * 2.0 * ((S // 2) ** 2 + (S // 4) ** 2) * 6 * 2
    ledger = {k: v * batch for k, v in ledger.items()}
    ledger["total"] = sum(ledger.values())
    return ledger


def bound_s(flops: float, nbytes: float, dtype: str, kind: str) -> float:
    """Least seconds the card ``kind`` could take for the work."""
    p = PEAKS[kind]
    return max(flops / p[dtype], nbytes / p["bytes_per_s"])


_SIZE = {"bf16": 2, "f16": 2, "f32": 4}


def attention_calls(cfg, batch: int, with_fov: bool, vit_dtype: str
                    ) -> List[Tuple[int, int, int, int, str]]:
    """(B, N, H, D, dtype) of every attention of one forward of ``batch``
    images: the patch ViT over the 35-tile pyramid and the image ViT in the
    ViT's dtype, the FOV ViT in f32 (it runs f32 under every policy)."""
    S = 4 * cfg["vit_img_size"]
    P = cfg["vit_img_size"]
    tiles = _split_tiles(S, P, 4) ** 2 + _split_tiles(S // 2, P, 2) ** 2 + 1
    H = cfg["num_heads"]
    D = cfg["embed_dim"] // H
    N = _seq(cfg)
    calls = [(tiles * batch, N, H, D, vit_dtype)] * cfg["depth"]
    calls += [(batch, N, H, D, vit_dtype)] * cfg["depth"]
    if with_fov:
        calls += [(batch, N, H, D, "f32")] * cfg["depth"]
    return calls


def attention_bound_s(calls, kind: str) -> float:
    total = 0.0
    for B, N, H, D, dt in calls:
        flops = 4.0 * B * H * N * N * D          # q k^T and p v
        nbytes = 4.0 * B * H * N * D * _SIZE[dt]  # q, k, v read; o written
        total += bound_s(flops, nbytes, dt, kind)
    return total


def conv3x3_calls(cfg, batch: int, dtype: str) -> List[Tuple]:
    """(N, H, W, Cin, Cout, skips, bias, dtype) of the forward's 3x3
    stride-1 convolutions as published: the decoder's projections of levels
    1-4 and its residual units' two convs (a fusion block with a skip has
    two units), and the head's two 3x3 convs (conv2 at the resolution of
    the deconv before it)."""
    T = cfg["vit_img_size"] // cfg["patch_size"]
    ef = cfg["encoder_feature_dims"]
    dec = cfg["decoder_features"]
    l0 = cfg["head_last_dims"][0]
    grids = [32 * T // (1 << i) for i in range(5)]
    calls = [(batch, g, g, c, dec, 0, False, dtype) for g, c in zip(grids[1:], ef)]
    for i in range(5):
        g = grids[i]
        units = 1 if i == 4 else 2
        for u in range(units):
            calls.append((batch, g, g, dec, dec, 0, True, dtype))
            # the unit's residual, and in a fusion's first unit its skip input
            calls.append((batch, g, g, dec, dec, 2 if (units == 2 and u == 0) else 1, True,
                          dtype))
    gh = 32 * T
    calls.append((batch, gh, gh, dec, dec // 2, 0, True, dtype))
    calls.append((batch, 2 * gh, 2 * gh, dec // 2, l0, 0, True, dtype))
    return calls


def conv3x3_bound_s(calls, kind: str) -> float:
    total = 0.0
    for N, H, W, cin, cout, skips, bias, dt in calls:
        m = N * H * W
        flops = 2.0 * m * 9 * cin * cout
        nbytes = (m * cin + 9 * cin * cout + (cout if bias else 0) + (1 + skips) * m * cout) \
            * _SIZE[dt]
        total += bound_s(flops, nbytes, dt, kind)
    return total


def window_mfu(run) -> Optional[float]:
    """The percent of the card's dense bf16 peak that the logical FLOPs of
    a run's forwards (``run.window.forwards``: photos, variant), as the
    configuration's architecture counts them, make over its window; None
    off a card the table knows."""
    p = peak(run.kind)
    if p is None or not run.window.forwards:
        return None
    arch = architecture.of(run.config)
    m = run.config["model"]
    flops = sum(arch.forward_flops(m, n, variant) for n, variant in run.window.forwards)
    return 100.0 * flops / run.window_s / p["bf16"]
