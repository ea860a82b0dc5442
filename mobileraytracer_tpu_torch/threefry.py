"""Counter-based threefry2x32, bit-identical to `jax.random`.

The JAX package keys every random draw by `jax.random.fold_in` over
(pixel, sample, bounce, purpose) and draws with `jax.random.uniform`
(mobileraytracer_tpu/sampling.py).  Whole frames of the port match the
JAX frames at the same key only if these bits match, so this module
re-implements the pieces of `jax/_src/prng.py` and `jax/_src/random.py`
that those calls run, as jax 0.9 runs them with
`jax_default_prng_impl=threefry2x32` and `jax_threefry_partitionable=True`:

  * `threefry2x32`: the 20-round Threefry-2x32 hash
    (`_threefry2x32_lowering`, 5 blocks of 4 rotations, key injection
    after each block);
  * `fold_in(key, data)`: `threefry_2x32(key, threefry_seed(data))`, i.e.
    the hash of the count pair (0, data);
  * `uniform(key, n)`: the partitionable random-bits path hashes the
    count pairs (0, i) and XORs the two output words; the float is the
    top 23 bits or-ed into the exponent of 1.0, minus 1.0.

A key is an int64 tensor whose last dimension holds the two 32-bit words
(masked to [0, 2^32)): torch's uint32 has thin operator coverage on both
CPU and CUDA.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the count words (x1, x2) under key (k1, k2); all
    int64 tensors (or ints) holding 32-bit values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    y = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + y) & _M32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, y


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2^32: words (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` over a batch of keys (..., 2); `data` is a
    Python int or an integer tensor broadcast against the batch."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    a, b = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([a, b], -1)


def random_bits(keys: torch.Tensor, n: int = 0) -> torch.Tensor:
    """32-bit random words per key: shape (...,) for n == 0 (a scalar
    draw), else (..., n)."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    cnt = torch.arange(max(n, 1), dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k1, k2, 0, cnt)
    bits = b1 ^ b2
    return bits[..., 0] if n == 0 else bits


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): mantissa bits under the exponent of 1.0, - 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor, n: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` per key, for shape () when
    n == 0 and (n,) otherwise."""
    return bits_to_uniform(random_bits(keys, n))
