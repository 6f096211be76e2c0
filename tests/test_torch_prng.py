"""The port's stereogram noise (matrix_eyes_tpu_torch/ops/prng.py) against
``jax.random``, bit for bit.

The JAX package draws ``jax.random.randint(jax.random.PRNGKey(seed), shape,
0, 256, jnp.uint8)``; the port's plain version must give the same bytes at
every seed of PRNGKey's range and at the stereogram's shapes, including the
12 MP photo's compact (H, pw, 3) plane and an element count that is not a
multiple of the kernel's 16 bytes a thread. The scheme rests on JAX's
partitionable threefry, the default since JAX 0.5: a change of that default
must fail here, not go unseen. On the CPU ``randint_u8`` runs its plain
version; the ``threefry`` kernel is held to it on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from matrix_eyes_tpu_torch.ops import _build, prng

SEEDS = [0, 1, 7, 2**31 - 1, 2**31 + 3, 2**32 + 5, 2**63 - 1, -1, -2**63]
SHAPES = [
    (1, 1, 3),
    (7, 13, 3),
    (37, 53, 3),
    (3024, 504, 3),   # the compact form's noise of a 4032x3024 photo at amplitude 1/16
    (97, 131, 3),     # full width, 38121 elements: 9 past a multiple of 16
]


def _key(seed: int) -> torch.Tensor:
    return torch.tensor(prng.prng_key(seed), dtype=torch.int64)


def test_jax_threefry_is_partitionable():
    # the port reproduces the partitionable counters and fold-like split
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert prng.prng_key(seed) == tuple(int(w) for w in want)
    np.testing.assert_array_equal(_key(seed).numpy(), want)
    np.testing.assert_array_equal(prng.split(_key(seed)).numpy(),
                                  np.asarray(jax.random.split(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("seed", [2**63, -2**63 - 1])
def test_seeds_outside_int64_raise_in_both(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.prng_key(seed)


def test_threefry2x32_matches_jax_and_the_known_answer():
    # Random123's known-answer vector for Threefry-2x32, 20 rounds
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64)
    b0, b1 = prng.threefry2x32_plain(key, torch.tensor([0x243F6A88]),
                                     torch.tensor([0x85A308D3]))
    assert (b0.item(), b1.item()) == (0xC4923A9C, 0x483DF7A0)
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2**32, size=(4, 257), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry_2x32(jnp.asarray(words[:2, 0]),
                               jnp.asarray(words[2:].reshape(-1)))
    got = prng.threefry2x32_plain(torch.from_numpy(words[:2, 0].astype(np.int64)),
                                  torch.from_numpy(words[2].astype(np.int64)),
                                  torch.from_numpy(words[3].astype(np.int64)))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_u8_plain_matches_jax(seed, shape):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 256, jnp.uint8))
    got = prng.randint_u8_plain(_key(seed), shape)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_draws_in_blocks(monkeypatch):
    # a draw cut into blocks gives the bytes of one block
    want = prng.randint_u8_plain(_key(5), (9, 11, 3))
    monkeypatch.setattr(prng, "_BLOCK_ELEMENTS", 16)
    np.testing.assert_array_equal(prng.randint_u8_plain(_key(5), (9, 11, 3)).numpy(),
                                  want.numpy())


def test_randint_u8_cpu_runs_the_plain_version():
    before = dict(_build.ledger)
    for shape in [(4, 5, 3), (0, 7, 3)]:
        np.testing.assert_array_equal(prng.randint_u8(_key(3), shape).numpy(),
                                      prng.randint_u8_plain(_key(3), shape).numpy())
    assert dict(_build.ledger) == before  # the CPU path launches nothing


def test_key_tensor_on_the_cpu():
    key = prng.key_tensor(2**32 + 5, "cpu")
    assert key.dtype == torch.int64 and key.tolist() == [0, 5]


@pytest.mark.parametrize("bad", [
    lambda: prng.randint_u8(torch.zeros(2, dtype=torch.int64, device="meta"), (2, 3)),
    lambda: prng.randint_u8(torch.zeros(2, dtype=torch.int32), (2, 3)),   # key dtype
    lambda: prng.randint_u8(torch.zeros(3, dtype=torch.int64), (2, 3)),   # key shape
    lambda: prng.randint_u8((0, 5), (2, 3)),                               # not a tensor
    lambda: prng.randint_u8(torch.zeros(2, dtype=torch.int64), (2, -1)),  # negative size
])
def test_randint_u8_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        bad()
