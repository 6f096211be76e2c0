"""The stereogram's noise: the port's copy of the part of ``jax.random``
that the JAX package's stereogram draws from, bit for bit, and its Hopper
kernel (``csrc/threefry.cu``).

The JAX package draws ``jax.random.randint(jax.random.PRNGKey(seed),
shape, 0, 256, jnp.uint8)`` on the device (``ops/stereogram.py``). Under
JAX's defaults (``jax_enable_x64`` off, ``jax_threefry_partitionable`` on,
the default since JAX 0.5; the tests hold this module to JAX 0.9.0) that
reduces to:

* ``PRNGKey(seed)`` (``prng_key``) is the key ``(0, seed mod 2**32)``: a
  seed in [-2**63, 2**63) keeps its low 32 bits, any other raises
  OverflowError;
* ``randint`` splits the key (``split``): the new keys are the word pairs of
  threefry2x32(key, counters (hi 0, lo [0, 1])), JAX's fold-like split of
  partitionable keys; it draws its lower bits from the second;
* element ``i`` of the row-major flat index is the low byte of ``b1 ^ b2``,
  where ``(b1, b2) = threefry2x32(k2, (i >> 32, i & 0xffffffff))``; for
  uint8 the span ``maxval - minval = 256`` wraps to 0, so randint returns
  those lower bits as they are.

threefry2x32 is the Threefry-2x32 block cipher with 20 rounds (rotations
13, 15, 26, 6 then 17, 29, 16, 24, a key injection after every four) as
``jax._src.prng.threefry2x32`` computes it.

The key reaches the kernel as a (2,) int64 tensor on the device, never as
a launch argument: a CUDA graph keeps the launch arguments of its capture,
so a replay with another seed would repeat the first seed's noise, and a
seed in the graph cache's key would make a graph per seed. Each element is
a hash of its own counter, so the kernel has nothing to share between
threads; it also splits the key itself, so one launch does what randint
does. A CUDA key goes to the kernel (or raises); a CPU key goes to the
plain version, which draws in blocks of rows so that a 12 MP draw holds
no more than a few tens of MB of int64 temporaries.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Sequence, Tuple

import torch

from matrix_eyes_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_BLOCK_ELEMENTS = 1 << 20  # elements a plain draw hashes at a time

_SIGNATURES = {
    "me_threefry_randint_u8": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p,                       # key, out
        ctypes.c_longlong,                                      # elements
        ctypes.c_void_p,                                        # stream
    ]),
}


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words: (0, seed mod 2**32)."""
    seed = operator.index(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} is outside [-2**63, 2**63), the seeds "
                            "jax.random.PRNGKey takes")
    return 0, seed & _M32


def key_tensor(seed: int, device) -> torch.Tensor:
    """``prng_key(seed)`` as a (2,) int64 tensor on ``device``: the key a
    program reads. On the card it goes through pinned memory without a
    wait, so that it does not hold up the host behind the work already
    queued on the stream."""
    host = torch.tensor(prng_key(seed), dtype=torch.int64)
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_plain(key: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counters (hi, lo) under ``key``:
    int64 tensors holding 32-bit words (a (2,) key; hi and lo of one shape).
    Every sum is masked to 32 bits, so no value reaches 2**62 and a
    rotation's shift cannot overflow."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (hi + ks[0]) & _M32
    x1 = (lo + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(key)`` of a (2,) int64 key: the (2, 2) keys, each
    a word pair of threefry2x32(key, (hi 0, lo [0, 1]))."""
    counters = torch.arange(2, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32_plain(key, torch.zeros_like(counters), counters)
    return torch.stack([b0, b1], dim=1)


def _check(key: torch.Tensor, shape: Sequence[int]) -> Tuple[int, ...]:
    if not isinstance(key, torch.Tensor) or key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"the key is a (2,) int64 tensor, got "
                         f"{getattr(key, 'shape', None)} {getattr(key, 'dtype', type(key))}")
    shape = tuple(operator.index(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"negative dimension in {shape}")
    return shape


def randint_u8_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, 256, jnp.uint8)`` in PyTorch, on
    the key's device: the CPU path and the kernel's oracle."""
    shape = _check(key, shape)
    k2 = split(key)[1]
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.uint8, device=key.device)
    for start in range(0, n, _BLOCK_ELEMENTS):
        idx = torch.arange(start, min(n, start + _BLOCK_ELEMENTS), dtype=torch.int64,
                           device=key.device)
        b1, b2 = threefry2x32_plain(k2, idx >> 32, idx & _M32)
        out[start:start + idx.numel()] = ((b1 ^ b2) & 0xFF).to(torch.uint8)
    return out.reshape(shape)


def randint_u8(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, 256, jnp.uint8)`` on the key's
    device: a CUDA key goes to the kernel (or raises), a CPU key to the
    plain version."""
    shape = _check(key, shape)
    if key.device.type == "cpu":
        return randint_u8_plain(key, shape)
    if key.device.type != "cuda":
        raise ValueError(f"randint_u8 runs on a CUDA or CPU key, got {key.device}")
    if not key.is_contiguous():
        raise ValueError("randint_u8 needs a contiguous key")
    out = torch.empty(shape, dtype=torch.uint8, device=key.device)
    n = out.numel()
    if n == 0:
        return out
    lib = _build.load("threefry", _SIGNATURES)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        rc = lib.me_threefry_randint_u8(key.data_ptr(), out.data_ptr(), n, stream)
    _build.check_launch(rc, "threefry")
    return out
