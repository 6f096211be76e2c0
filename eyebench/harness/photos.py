"""The seeded photo pool: synthetic outdoor scenes written as JPEGs with
the EXIF 35 mm focal length a phone writes.

A copy of the repository's procedural test scene (sky gradient and sun, a
perspective checker ground fading to haze, shaded boxes at varying
distances), with its layout drawn from the seed, and a fine texture so
that the JPEG is a photo's size rather than a gradient's. Every pool has
the same number of photos at the same size and the same focal lengths;
the seed changes what they show and which photo carries which.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

_EXIF_IFD = 0x8769
_FOCAL_35MM = 0xA405


@dataclasses.dataclass
class Photo:
    path: str
    focal_mm: Optional[float]  # the EXIF 35 mm focal length it carries


def scene(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """One (h, w, 3) u8 scene whose layout comes from ``rng``; ``h`` and
    ``w`` are multiples of 8."""
    u = np.arange(w, dtype=np.float32) / w
    horizon = rng.uniform(0.38, 0.55)
    hr = int(horizon * h)
    img = np.empty((h, w, 3), np.float32)
    # sky: a vertical gradient, and the sun where its glow is visible
    t = (np.arange(hr, dtype=np.float32) / h / horizon)[:, None]
    img[:hr] = np.array([0.35, 0.55, 0.95], np.float32) + np.array([0.35, 0.25, -0.15],
                                                                    np.float32) * t[..., None]
    sx, sy = rng.uniform(0.15, 0.85), rng.uniform(0.08, 0.3)
    r0, r1 = max(int((sy - 0.1) * h), 0), min(int((sy + 0.1) * h), hr)
    c0, c1 = int((sx - 0.1) * w), int((sx + 0.1) * w)
    vv = (np.arange(r0, r1, dtype=np.float32) / h)[:, None]
    glow = np.exp(-((u[c0:c1][None, :] - sx) ** 2 + (vv - sy) ** 2) * 800)
    img[r0:r1, c0:c1] += glow[..., None] * np.array([1.0, 0.9, 0.6], np.float32)
    # ground: a perspective checker fading to haze at the horizon
    v = (np.arange(hr, h, dtype=np.float32) / h)[:, None]
    depth = 1.0 / np.maximum(v - horizon, 1e-3)
    # floor by truncation of a shifted value: the checker's parity only
    q = (rng.uniform(5, 11) * (u[None, :] - 0.5) * depth + 4096.0).astype(np.int32)
    chk = ((q + np.floor(0.6 * depth).astype(np.int32)) & 1).astype(np.float32)
    haze = np.exp(-0.04 * depth)[..., None]
    base = np.array([0.45, 0.40, 0.32], np.float32)
    dark = base * 0.25 * (1 - haze) + 0.7 * haze
    img[hr:] = dark + (base * 0.18 * (1 - haze)) * chk[..., None]
    # boxes (buildings): nearer ones bigger
    for i in range(7):
        bw = 0.05 + 0.05 * rng.uniform()
        x0 = 0.08 + 0.12 * i + 0.03 * rng.uniform()
        top = horizon - (0.05 + 0.28 * rng.uniform())
        shade = 0.25 + 0.5 * rng.uniform()
        col = np.array([shade, shade * (0.8 + 0.3 * rng.uniform()), shade * 0.8], np.float32)
        b0, b1 = int(x0 * w), int((x0 + bw) * w)
        img[int(top * h):int((horizon + 0.15 * (1 - i / 8)) * h), b0:b1] = (
            col + 0.08 * np.sin(120 * u[b0:b1])[:, None])
    # a fine texture, one tile repeated: an eighth of each side
    tile = rng.integers(-6, 7, (h // 8, w // 8, 3)).astype(np.float32) / 255.0
    img.reshape(8, h // 8, 8, w // 8, 3)[...] += tile[None, :, None]
    img *= 255.0
    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8)


def make_pool(seed: int, directory: str, n: int, width: int, height: int,
              focal_mm: List[float], quality: int = 90, threads: int = 4) -> List[Photo]:
    """``n`` JPEGs under ``directory``; photo i carries focal length i of
    ``focal_mm`` repeated to ``n`` and shuffled by the seed (an empty list:
    none). Photo i's scene is drawn from (seed, i) alone, so the threads
    that make them do not change them."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    root = int(seed) % (1 << 64)
    # every pool holds the same focal lengths, in an order drawn from the seed
    focals = [float(focal_mm[i % len(focal_mm)]) if focal_mm else None for i in range(n)]
    np.random.default_rng(np.random.SeedSequence([root, 0x666f63616c])).shuffle(focals)
    os.makedirs(directory, exist_ok=True)

    def make(i: int) -> Photo:
        rgb = scene(np.random.default_rng(np.random.SeedSequence([root, 0x70686f746f, i])),
                    width, height)
        exif = Image.Exif()
        if focals[i] is not None:
            exif.get_ifd(_EXIF_IFD)[_FOCAL_35MM] = int(focals[i])
        path = os.path.join(directory, f"photo-{i:02d}.jpg")
        Image.fromarray(rgb).save(path, quality=quality, exif=exif)
        return Photo(path, focals[i])

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(make, range(n)))
