"""Counter-based Threefry-2x32 keys and uniform draws, as `jax.random`
defines them (threefry2x32, `fold_in`, `uniform` of float32).

A frozen copy of the few functions the plain reference needs, so that it
derives every random draw of a frame from the run's seed by itself.  A key
is an int64 tensor whose last dimension holds the two 32-bit words.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _s32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    x = int(x) & _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k1, k2, x1, x2):
    """20 rounds of Threefry-2x32 of the count words (x1, x2) under the key
    (k1, k2), on int32 words that wrap as uint32 adds do; returns the two
    output words as int64 in [0, 2^32)."""
    k1, k2 = _s32(k1), _s32(k2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = _s32(x1) + ks[0]
    y = _s32(x2) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + y
            y = _rotl(y, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        y = y + ks[(i + 2) % 3] + (i + 1)
    return x0.to(torch.int64) & _M32, y.to(torch.int64) & _M32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key of a seed in [0, 2^32): words (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """The key of `data` (an int, or integer tensor broadcast against the
    batch) under each key: the hash of the count pair (0, data)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    a, b = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([a, b], -1)


def uniform(keys: torch.Tensor, n: int = 0) -> torch.Tensor:
    """float32 in [0, 1) per key: shape (...,) for n == 0, else (..., n).
    Word i of a draw is the XOR of the hash of the index's (hi, lo) words;
    its top 23 bits go under the exponent of 1.0, minus 1."""
    cnt = torch.arange(max(n, 1), dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], cnt >> 32,
                          cnt & _M32)
    bits = b1 ^ b2
    bits = bits[..., 0] if n == 0 else bits
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
