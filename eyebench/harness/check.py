"""The comparison that decides ``correct``: what the timed path produced,
sampled over the window, against the plain float32 reference
(``eyebench.reference``) worked out again from the same inputs.

The reference is the configuration's architecture's
(``eyebench/harness/architecture.py``): its ``make_weights`` makes the
weights again from the configuration's ``weights_seed`` when a sample
first needs them, its ``reference`` gives one photo's inverse depth and its
``depth_map`` a depth map's pixels. The check decodes the photo files
itself and runs one photo at a time after the program's state is freed.
A sample is one of:

* ``("png", path, photo)``: a depth-map PNG the program wrote or served,
  decoded, against the reference's depth map at the photo's size.
  Numbers: ``png_mean_abs`` and ``png_max_abs``, u8 counts over every
  pixel and channel;
* ``("grid", array, [(photo, focal passed)], (lo, hi))``: inverse depth at
  the model's grid, (B, S, S), clamped by the program to [lo, hi], image b
  of photo b, against the reference's under the same clamp. Numbers:
  ``inv_gap``, the largest absolute difference over the reference's
  largest value; ``inv_mean_gap``, the mean absolute difference over the
  reference's mean; ``inv_pool<k>_gap``, the same of the k x k block means
  (detail averaged away, the error of the coarse depth kept). Where the
  architecture ``has_fov``, an image whose focal length the model
  estimated is judged instead by ``fov_gap``, the focal scale the output
  implies against the reference's, |median of program / reference - 1|
  over the pixels the reference does not clamp: its whole depth map scales
  with the estimate, so that its inverse depth gaps would read the FOV's
  error and hide the rest. Where the reference clamps every pixel of it (random weights can
  put the estimate far out), it has no ``fov_gap`` and joins the inverse
  depth gaps, and ``fov_unread`` counts it. Without ``has_fov`` such an
  image joins the inverse depth gaps and ``fov_unread`` is not written.

A sample of another kind is judged by ``eyebench/checks/<kind>.py``, which
a later cell adds. Each number is the worst over the samples. A cell's limits file names the
numbers it holds and their limits, and which of them may go unread on a
run (``optional``); every number is printed, held or not.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from eyebench.harness import architecture

POOLS = (8, 32, 128)


def _plugin(kind: str):
    """The comparison of a sample kind a later cell brings,
    ``eyebench/checks/<kind>.py``: its ``compare(sample, reference, keep,
    control)`` judges the sample, ``reference(photo, rgb, focal,
    precision=None)`` giving the reference's inverse depth and ``keep(name,
    value)`` recording a number."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checks",
                        kind + ".py")
    spec = importlib.util.spec_from_file_location("eyebench_check_" + kind, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png_pixels(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _pool(x: np.ndarray, k: int) -> np.ndarray:
    h, w = x.shape[0] // k * k, x.shape[1] // k * k
    return x[:h, :w].reshape(h // k, k, w // k, k).mean(axis=(1, 3), dtype=np.float64)


def compare(samples, config: dict, device, control: Optional[str] = None) -> Dict[str, float]:
    """The numbers of ``samples``. ``control`` ("fp8"): judge instead the
    reference computed in that precision, in the program's place, on the
    same inputs (the configuration's control)."""
    import torch

    from eyebench.reference import image

    arch = architecture.of(config)
    model = config["model"]
    served = {"bf16": torch.bfloat16, "f32": torch.float32}[config["weights"]]
    params = []  # the weights, made when a sample first needs the reference
    worst: Dict[str, float] = {}

    def keep(name: str, value: float) -> None:
        worst[name] = max(worst.get(name, 0.0), float(value))

    done = {}  # (photo, focal, precision) -> the reference's inverse depth
    unread = [0]  # images without a focal length that the reference clamps whole

    def reference(photo, rgb, f35, precision=None):
        key = (photo.path, f35, precision)
        if key not in done:
            if not params:
                params.append(arch.make_weights(model, config["weights_seed"], device, served))
            done[key] = arch.reference(model, params[0], rgb, f35, device, precision)
        return done[key]

    for sample in samples:
        if sample[0] not in ("png", "grid"):
            _plugin(sample[0]).compare(sample, reference, keep, control)
            continue
        if sample[0] == "png":
            _kind, path, photo = sample
            rgb, f35 = image.decode(photo.path)
            ref = arch.depth_map(reference(photo, rgb, f35), *rgb.shape[:2]).cpu().numpy()
            got = (_png_pixels(path) if control is None else arch.depth_map(
                reference(photo, rgb, f35, control), *rgb.shape[:2]).cpu().numpy())
            if got.shape != ref.shape:
                keep("png_mean_abs", 255.0)
                keep("png_max_abs", 255.0)
                continue
            d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            keep("png_mean_abs", d.mean())
            keep("png_max_abs", d.max())
            continue
        _kind, grid, where, (lo, hi) = sample
        grid = np.asarray(grid)
        for b, (photo, f35) in enumerate(where):
            rgb, _exif = image.decode(photo.path)
            ref = torch.clamp(reference(photo, rgb, f35), lo, hi).cpu().numpy()
            got = (grid[b] if control is None else
                   torch.clamp(reference(photo, rgb, f35, control), lo, hi).cpu().numpy())
            if got.shape != ref.shape or not np.isfinite(got).all():
                for name in ["inv_gap", "inv_mean_gap", "fov_gap"] + [f"inv_pool{k}_gap"
                                                                       for k in POOLS]:
                    keep(name, np.inf)
                continue
            if f35 is None and arch.has_fov:
                free = (ref > lo) & (ref < hi)
                if free.any():
                    keep("fov_gap", abs(np.median(got[free] / ref[free]) - 1.0))
                    continue
                unread[0] += 1
            d = np.abs(got.astype(np.float64) - ref)
            keep("inv_gap", d.max() / np.abs(ref).max())
            keep("inv_mean_gap", d.mean() / np.abs(ref).mean())
            for k in POOLS:
                pr = _pool(ref, k)
                keep(f"inv_pool{k}_gap", np.abs(_pool(got, k) - pr).mean() / np.abs(pr).mean())
    del params, done
    if arch.has_fov and any(s[0] == "grid" and any(f is None for _p, f in s[2])
                            for s in samples):
        worst["fov_unread"] = float(unread[0])
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          optional: Sequence[str] = ()) -> List[tuple]:
    """[(name, value, limit, within)] of every number; a number without a
    limit is printed and not held (limit None), nor is a number in
    ``optional`` that has no reading on this run (within None). Any other
    held number without a reading fails."""
    rows = []
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name)
        if limit is None or (value is None and name in optional):
            ok = None
        else:
            ok = value is not None and value <= limit
        rows.append((name, value, limit, ok))
    return rows
