"""Seeded random Depth Pro weights, made on the device in a few large calls.

Every leaf is drawn as one layer's: a ViT's blocks are stacked on a
leading layer axis, and each block's leaves are drawn at their own
shape, the layer axis left out. A matrix (two or more axes) is normal with
variance 1 / fan_in, fan_in being the product of every axis but the last.
A LayerNorm scale is uniform in [0.5, 1.5], about the 1 at which LayerNorm
starts; every other vector (biases, LayerScale) is uniform in [0.05, 0.3],
so that LayerScale does not zero the blocks out. So the blocks and their
attention shape the output: at the port's own seeded scheme, which counts
the layer axis in the fan-in and draws the blocks' vectors as matrices,
the softmax is all but uniform and the ViTs barely move the depth map, so
that neither their precision nor a fault in their attention would show.

Each group of leaves is drawn as one flat buffer (one normal draw for the
matrices, one uniform draw for the vectors) and every leaf is a view into
it, at an offset aligned to 128 elements. Leaves drawn alike sit side by
side, so one multiply (and one add) scales all of them. The groups are the
encoders' block matmul weights, the FOV network, and the rest: a policy
that replaces the first group (the mixed policy rounds it to bf16) frees
its buffer whole.

The same seed, device and ``served`` dtype give the same values, so the
reference makes again, after the measured window, the very weights the
program was handed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from eyebench.reference.spec import leaves, param_spec, tree_map

_ALIGN = 128
_BLOCK_MATMULS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
_NORM_SCALES = ("norm1_scale", "norm2_scale", "scale")


def _group(path: Tuple) -> str:
    if path[0] == "fov":
        return "fov"
    if len(path) >= 2 and path[-2] == "blocks" and path[-1] in _BLOCK_MATMULS:
        return "blocks"
    return "rest"


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def make_weights(cfg: Dict[str, Any], seed: int, device, served: torch.dtype) -> Dict[str, Any]:
    """The parameter tree on ``device``: every leaf in ``served`` (bf16 or
    f32), except the FOV network's, which are f32 holding ``served``
    values (the layout in which the port keeps them)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed))
    spec = param_spec(cfg)
    # (group, matrix) -> [(path, shape, (multiplier, offset))]
    by_group: Dict[Tuple[str, bool], List[Tuple[Tuple, Tuple[int, ...], Tuple[float, float]]]] = {}
    for path, shape in leaves(spec):
        one = shape[1:] if "blocks" in path else shape  # one layer's leaf
        matrix = len(one) >= 2
        if matrix:
            affine = ((1.0 / max(math.prod(one[:-1]), 1)) ** 0.5, 0.0)
        else:
            lo, hi = (0.5, 1.5) if path[-1] in _NORM_SCALES else (0.05, 0.3)
            affine = (hi - lo, lo)
        by_group.setdefault((_group(path), matrix), []).append((path, tuple(shape), affine))

    made: Dict[Tuple, torch.Tensor] = {}
    for (group, matrix), items in sorted(by_group.items()):
        items.sort(key=lambda it: it[2])  # leaves drawn alike side by side
        offsets, n = [], 0
        for _path, shape, _affine in items:
            offsets.append(n)
            n += -(-math.prod(shape) // _ALIGN) * _ALIGN
        buf = (torch.randn(n, generator=gen, device=device, dtype=served) if matrix else
               torch.rand(n, generator=gen, device=device, dtype=served))
        start = 0
        while start < len(items):
            end = start
            while end < len(items) and items[end][2] == items[start][2]:
                end += 1
            hi = offsets[end] if end < len(items) else n
            mul, add = items[start][2]
            buf[offsets[start]:hi].mul_(mul)
            if add:
                buf[offsets[start]:hi].add_(add)
            start = end
        if group == "fov":
            buf = buf.float()
        for (path, shape, _affine), off in zip(items, offsets):
            made[path] = buf[off:off + math.prod(shape)].view(shape)
    return tree_map(lambda path, _shape: made[path], spec)
