"""Depth head (port of ``matrix_eyes_tpu/models/head.py``).

conv 3x3 (C -> C/2) -> deconv 2x2/s2 -> conv 3x3 (C/2 -> 32) -> ReLU ->
conv 1x1 (32 -> 1) -> ReLU; the output is the canonical inverse depth at
full resolution.

deconv1 and conv2 have no nonlinearity between them, so they compose
exactly into ONE 3x3 conv on the half-resolution grid over Ci + 1 input
channels (the extra always-one channel carries the deconv bias through
conv2's zero padding) and 4 * 32 output channels, one per output-pixel
phase, followed by depth-to-space. The input is built with zero channels
after the ones-channel up to a multiple of 8 (136 at Depth Pro's Ci = 128),
against zero weight rows, so the bf16 kernel takes it by TMA (16-byte
strides) with no padded copy. Both 3x3 convs go through the conv3x3
kernel. ``forward_unfused`` is the stage-by-stage oracle.
"""

from __future__ import annotations

from typing import Dict

import torch

from matrix_eyes_tpu_torch.ops import nn

Params = Dict


def _compose_deconv_conv(params: Params):
    """Compose deconv1 (2x2/s2) with conv2 (3x3/p1) into one 3x3 conv.

    Returns (w, b): w is (3, 3, Cp, 4 * O) HWIO, input channel Ci the
    ones-channel and channels Ci + 1 .. Cp - 1 zero rows (Cp = Ci + 1
    rounded up to a multiple of 8); b is the (4 * O,) phase-tiled conv2
    bias. Output channels are ordered (a, b, o), ``nn.deconv2x2``'s
    depth-to-space order.

    Conv2 at output row Y = 2i + a reads deconv rows Y + u - 1 = 2(i + di)
    + r with t = a + u - 1, di = floor(t / 2), r = t mod 2, so each (a, u)
    pair adds ``Wd[:, (r, s), :] @ W2[u, v]`` to composite tap (di, dj) of
    phase (a, b).
    """
    wd = params["deconv1_w"].float()  # (Ci, 4*Cd)
    bd = params["deconv1_b"].float()  # (Cd,)
    w2 = params["conv2_w"].float()  # (3, 3, Cd, O)
    b2 = params["conv2_b"].float()  # (O,)
    ci = wd.shape[0]
    cd = wd.shape[1] // 4
    o = w2.shape[3]
    wd = wd.reshape(ci, 2, 2, cd)
    cp = -(-(ci + 1) // 8) * 8
    comp = torch.zeros((3, 3, cp, 2, 2, o), dtype=torch.float32, device=wd.device)
    for a in (0, 1):
        for u in (0, 1, 2):
            di, r = divmod(a + u - 1, 2)  # floor semantics: t = -1 -> (-1, 1)
            for b in (0, 1):
                for v in (0, 1, 2):
                    dj, s = divmod(b + v - 1, 2)
                    comp[di + 1, dj + 1, :ci, a, b] += wd[:, r, s, :] @ w2[u, v]
                    comp[di + 1, dj + 1, ci, a, b] += bd @ w2[u, v]
    return comp.reshape(3, 3, cp, 4 * o), b2.repeat(4)


def forward(params: Params, features: torch.Tensor) -> torch.Tensor:
    """features: (B, H, W, C) decoder output; returns (B, 2H, 2W, 1)."""
    x = nn.conv2d(features, params["conv0_w"], params["conv0_b"], padding=1)
    w, b = _compose_deconv_conv(params)
    B, H, W, C = x.shape
    extra = torch.zeros((B, H, W, w.shape[2] - C), dtype=x.dtype, device=x.device)
    extra[..., 0] = 1  # the ones-channel; the rest meet zero weight rows
    y = nn.conv2d(torch.cat([x, extra], dim=-1), w.to(x.dtype), b.to(x.dtype), padding=1)
    # ReLU + the 1x1 conv3 stay in phase space: a block-diagonal (4*O, 4) matmul
    w3_blk = torch.block_diag(*([params["conv3_w"].float()] * 4)).to(x.dtype)
    y = nn.relu(nn.linear(nn.relu(y), w3_blk, params["conv3_b"].repeat(4)))  # (B, H, W, 4)
    y = y.reshape(B, H, W, 2, 2, 1).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * W, 1)


def forward_unfused(params: Params, features: torch.Tensor) -> torch.Tensor:
    """Stage-by-stage formulation: the oracle for the fused composition."""
    x = nn.conv2d(features, params["conv0_w"], params["conv0_b"], padding=1)
    x = nn.deconv2x2(x, params["deconv1_w"], params["deconv1_b"])
    x = nn.conv2d(x, params["conv2_w"], params["conv2_b"], padding=1)
    x = nn.relu(x)
    x = nn.linear(x, params["conv3_w"], params["conv3_b"])
    return nn.relu(x)
