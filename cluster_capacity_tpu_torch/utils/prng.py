"""Counter-based random numbers in PyTorch, bit for bit those of jax.random.

The scan step's random tie-break (engine/simulator.py `_step`,
deterministic=False) draws from the JAX package's PRNG: `jax.random.PRNGKey`,
`split` and `uniform(float32)` on the threefry2x32 implementation.  This
module computes the same bits with torch integer tensors on any device, so
a random-mode solve on the card, on the CPU and in the JAX package place
the same pods.

JAX semantics followed (JAX 0.9, `jax_threefry_partitionable=True`, the
default since JAX 0.5; x64 enabled, as the JAX package's parity mode runs):

- a key is two uint32 words; `PRNGKey(seed)` is (seed >> 32, seed & M) of
  the seed as a 64-bit integer, M = 0xFFFFFFFF;
- threefry2x32 is the Random123 hash: 20 rounds in five groups of four,
  rotations (13, 15, 26, 6) / (17, 29, 16, 24), key schedule
  (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after every group with the group
  number added to the second word;
- `split(key, num)` hashes the 64-bit iota of its output shape, given as
  (high, low) word pairs, and stacks the two output words as the new keys;
- 32-bit `random_bits(key, shape)` is `bits1 ^ bits2` of the hash of the
  flat-index iota; `uniform` float32 on [0, 1) is those bits shifted right
  by 9, or-ed with the bits of 1.0f, viewed as float32, minus 1.

A key here is an int64 tensor of two entries in [0, 2**32): the arithmetic
runs in int64 and is masked to 32 bits, since torch.uint32 lacks most
operations on CUDA.  tests/test_torch_prng.py holds every function equal to
jax.random.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry2x32 hash of the counter words (x0, x1) under the key
    (k0, k1); every operand holds uint32 values in int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as an int64 tensor of two words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _MASK], dtype=torch.int64,
                        device=device)


def _iota_words(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): int64 [num, 2]."""
    hi, lo = _iota_words(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random_bits(key, (n,)) as int64 values in [0, 2**32)."""
    hi, lo = _iota_words(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,), dtype=float32) on [0, 1)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
