"""Autostereogram synthesis (port of ``matrix_eyes_tpu/ops/stereogram.py``).

The reference (output.rs:141-193) builds each row with a left-to-right
scan carrying a loop dependency in x::

    out[x] = x >= pw ? out[x + round(depth*dm) - pw] : noise[x % pw]

Two forms, as in the JAX package:

* compact (``synthesize_stereogram_split``): the u8 shift plane (on the
  device, for the caller to read back) and the (H, pw, 3) noise; the
  native PNG encoder replays the scan on the host;
* device-resolved (``synthesize_stereogram``), routed as the JAX
  package's ``_synthesize``: ``pw == 0`` gives full-size noise; the
  ``wide`` self-link case (win > pw) gives full-width noise and pointer
  doubling on every device; every other case runs ``linker_scan`` (the
  CUDA kernel on the card). The TPU's VMEM and width gates are TPU limits
  and are not ported.

The device work runs through the CUDA-graph cache (``aot.call_cached``)
under the JAX package's names: ``stereogram`` (shift plane and scan) and
``stereogram_shift`` (the compact form's shift plane). The noise is drawn
outside them and copied into the graph's input.

Noise policy: noise is drawn on the host from
``torch.Generator("cpu").manual_seed(seed)``, (H, pw, 3) u8 or (H, W, 3)
in the ``wide`` and ``pw == 0`` cases, and uploaded only for the
device-resolved form. A seed gives the same image on the CPU and on the
card, and in both PNG forms; it does not give the JAX package's threefry
bits (nor does the reference's thread RNG repeat itself).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch.ops.resize import depthmap_bilinear_resample
from matrix_eyes_tpu_torch.ops.stereogram_kernel import (
    doubling_iterations,
    linker_scan,
    linker_scan_plain,
)


def stereogram_geometry(output_width: int, amplitude: float):
    """depth_multiplier and pattern_width (output.rs:160-161).

    dm = W * amplitude; pw = round(2*dm + amplitude) with Rust's
    round-half-away-from-zero (values are non-negative here).
    """
    dm = np.float32(output_width) * np.float32(amplitude)
    pw = int(math.floor(float(np.float32(dm * np.float32(2.0) + np.float32(amplitude))) + 0.5))
    return float(dm), pw


def _max_shift(dm: float) -> int:
    """Largest possible shift = round(1.0 * dm), Rust rounding."""
    return int(math.floor(float(dm) + 0.5))


def _doubling_iterations(out_w: int, pw: int, dm: float) -> int:
    """Pointer-doubling rounds that reach every fixpoint of a row."""
    return doubling_iterations(out_w, pw, _max_shift(dm) + 1)


def _split_geometry(out_w: int, amplitude: float):
    """(dm, pw) when the compact (shift, noise) form applies, else None
    (degenerate pw == 0, the self-link ``wide`` case, or shifts over 255)."""
    dm, pw = stereogram_geometry(out_w, amplitude)
    if pw == 0 or _max_shift(dm) > 255:
        return None
    if _max_shift(dm) + 1 > pw:  # wide: self-linking pixels keep own noise
        return None
    return dm, pw


def stereogram_noise(seed: int, out_h: int, width: int) -> torch.Tensor:
    """(out_h, width, 3) u8 noise on the host from a seeded CPU generator."""
    gen = torch.Generator("cpu").manual_seed(seed)
    return torch.randint(0, 256, (out_h, width, 3), generator=gen, dtype=torch.uint8)


def _norm_depth(depth: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Normalised depth at every output pixel (output.rs:174-178)."""
    dmin = depth.min()
    dmax = depth.max()
    sampled = depthmap_bilinear_resample(depth, out_h, out_w)
    denom = dmax - dmin
    out = torch.where(denom > 0, (sampled - dmin) / denom, torch.zeros_like(sampled))
    # two-tap f32 bilinear can land ~1e-7 above the row max and push a
    # shift one past max_shift; the reference never needs dnorm > 1
    return out.clamp(0.0, 1.0)


def shift_plane(depth: torch.Tensor, out_h: int, out_w: int, dm: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Per-pixel link shifts round(dnorm * dm), Rust rounding (half away
    from zero, ``floor(v + 0.5)`` for these non-negative values)."""
    return torch.floor(_norm_depth(depth, out_h, out_w) * dm + 0.5).to(dtype)


def synthesize_stereogram(depth: torch.Tensor, out_h: int, out_w: int, amplitude: float,
                          seed: int = 0) -> torch.Tensor:
    """depth: (H, W) clamped inverse-depth grid; returns (out_h, out_w, 3)
    u8 on the depth's device."""
    dm, pw = stereogram_geometry(out_w, amplitude)
    if pw == 0:
        # degenerate amplitude: every pixel keeps its own noise value
        return stereogram_noise(seed, out_h, out_w).to(depth.device)
    win = _max_shift(dm) + 1
    # sub-pixel amplitudes (max_shift == pw) let a pixel link to itself; it
    # then keeps its own noise value, so the noise is full width and the
    # links are resolved by pointer doubling on every device, as the JAX
    # package does. Only dm < 1 (shifts of at most one pixel, pw == 1) gets
    # here: for dm >= 1, round(2 dm + amplitude) >= round(dm) + 1.
    wide = win > pw
    noise = stereogram_noise(seed, out_h, out_w if wide else pw).to(depth.device)
    return aot.call_cached("stereogram", _resolve, (depth, noise, out_h, out_w, dm, pw, win))


def _resolve(depth: torch.Tensor, noise: torch.Tensor, out_h: int, out_w: int, dm: float,
             pw: int, win: int) -> torch.Tensor:
    """The shift plane and the scan of the device-resolved stereogram."""
    shift = shift_plane(depth, out_h, out_w, dm, torch.int32)
    if win > pw:
        return linker_scan_plain(shift, noise, pw, win)
    return linker_scan(shift, noise, pw, win)


def synthesize_stereogram_split(depth: torch.Tensor, out_h: int, out_w: int, amplitude: float,
                                seed: int = 0):
    """The compact form: (pw, shift (out_h, out_w) u8 on the depth's device,
    noise (out_h, pw, 3) u8 numpy on the host), the caller reading the shift
    plane back in one transfer; or None when the compact form does not
    apply."""
    geo = _split_geometry(out_w, amplitude)
    if geo is None:
        return None
    dm, pw = geo
    shift = aot.call_cached("stereogram_shift", shift_plane,
                            (depth, out_h, out_w, dm, torch.uint8))
    return pw, shift, stereogram_noise(seed, out_h, pw).numpy()
