"""Autostereogram synthesis (port of ``matrix_eyes_tpu/ops/stereogram.py``).

The reference (output.rs:141-193) builds each row with a left-to-right
scan carrying a loop dependency in x::

    out[x] = x >= pw ? out[x + round(depth*dm) - pw] : noise[x % pw]

Two forms, as in the JAX package:

* compact (``synthesize_stereogram_split``): the u8 shift plane and the
  (H, pw, 3) noise, both on the device for the caller to read back; the
  native PNG encoder replays the scan on the host;
* device-resolved (``synthesize_stereogram``), routed as the JAX
  package's ``_synthesize``: ``pw == 0`` gives full-size noise; the
  ``wide`` self-link case (win > pw) gives full-width noise and pointer
  doubling on every device; every other case runs ``linker_scan`` (the
  CUDA kernel on the card). The TPU's VMEM and width gates are TPU limits
  and are not ported.

The device work runs through the CUDA-graph cache (``aot.call_cached``)
under the JAX package's names and argument lists: ``stereogram`` (noise,
shift plane and scan, from ``(depth, key)``), and for the compact form
``stereogram_noise`` (from ``key``) and ``stereogram_shift`` (from
``depth``), each read back by the caller.

Noise policy: the JAX package's, bit for bit. The noise is
``jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 256, uint8)``,
(H, pw, 3) or (H, W, 3) in the ``wide`` and ``pw == 0`` cases, drawn on
the device inside the program by ``ops/prng.py`` (the ``threefry`` kernel
on the card, its plain version on the CPU). The seed reaches the program
as data, the (2,) key tensor, so a graph replays any seed and one graph
serves them all. A seed gives the JAX package's image on the CPU and on
the card, in both PNG forms, wherever the two packages' f32 resampling
gives the same shift plane (the reference's thread RNG does not repeat
itself).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch.ops.prng import key_tensor, randint_u8
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


def stereogram_noise(seed: int, out_h: int, width: int, device) -> torch.Tensor:
    """(out_h, width, 3) u8 noise on ``device``: the JAX package's
    ``jax.random.randint(PRNGKey(seed), (out_h, width, 3), 0, 256, uint8)``."""
    return randint_u8(key_tensor(seed, device), (out_h, width, 3))


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
    key = key_tensor(seed, depth.device)
    return aot.call_cached("stereogram", _synthesize, (depth, key, out_h, out_w, dm, pw))


def _synthesize(depth: torch.Tensor, key: torch.Tensor, out_h: int, out_w: int, dm: float,
                pw: int) -> torch.Tensor:
    """The device-resolved stereogram's program: the noise, the shift plane
    and the scan."""
    if pw == 0:
        # degenerate amplitude: every pixel keeps its own noise value
        return randint_u8(key, (out_h, out_w, 3))
    win = _max_shift(dm) + 1
    # sub-pixel amplitudes (max_shift == pw) let a pixel link to itself; it
    # then keeps its own noise value, so the noise is full width and the
    # links are resolved by pointer doubling on every device, as the JAX
    # package does. Only dm < 1 (shifts of at most one pixel, pw == 1) gets
    # here: for dm >= 1, round(2 dm + amplitude) >= round(dm) + 1.
    wide = win > pw
    noise = randint_u8(key, (out_h, out_w if wide else pw, 3))
    shift = shift_plane(depth, out_h, out_w, dm, torch.int32)
    if wide:
        return linker_scan_plain(shift, noise, pw, win)
    return linker_scan(shift, noise, pw, win)


def synthesize_stereogram_split(depth: torch.Tensor, out_h: int, out_w: int, amplitude: float,
                                seed: int = 0):
    """The compact form: (pw, shift (out_h, out_w) u8, noise (out_h, pw, 3)
    u8), both on the depth's device for the caller to read back; or None
    when the compact form does not apply."""
    geo = _split_geometry(out_w, amplitude)
    if geo is None:
        return None
    dm, pw = geo
    noise = aot.call_cached("stereogram_noise", randint_u8,
                            (key_tensor(seed, depth.device), (out_h, pw, 3)))
    shift = aot.call_cached("stereogram_shift", shift_plane,
                            (depth, out_h, out_w, dm, torch.uint8))
    return pw, shift, noise
