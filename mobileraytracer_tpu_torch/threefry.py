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
    count pairs (hi, lo) of each flat index i (the 64-bit i split into
    its two 32-bit words) and XORs the two output words; the float is the
    top 23 bits or-ed into the exponent of 1.0, minus 1.0;
  * `categorical(key, logits, k)`: `jax.random.categorical(key, logits,
    shape=(k,))`, the first argmax of Gumbel noise plus the logits over a
    (k, E) draw (`_gumbel`'s "low" mode: -log(-log(u)), u uniform in
    [tiny, 1)), streamed in blocks.

A key is an int64 tensor whose last dimension holds the two 32-bit words
(masked to [0, 2^32)): torch's uint32 has thin operator coverage on both
CPU and CUDA.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _s32(x):
    """32-bit words (int64 tensors, or ints, in [0, 2^32)) as int32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    x = int(x) & _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 words left; the right shift is arithmetic, so its
    sign bits are masked off."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the count words (x1, x2) under key (k1, k2); all
    int64 tensors (or ints) holding 32-bit values, broadcast together.
    The rounds run on int32 tensors (adds wrap as uint32 adds do, at half
    the bytes of int64); the two words come back as int64 in [0, 2^32)."""
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


def bits_at(k1, k2, index: torch.Tensor) -> torch.Tensor:
    """The random word at each flat index (int64, >= 0) of a draw under
    key (k1, k2): the hash of the index's (hi, lo) words, XORed."""
    b1, b2 = threefry2x32(k1, k2, index >> 32, index & _M32)
    return b1 ^ b2


def random_bits(keys: torch.Tensor, n: int = 0) -> torch.Tensor:
    """32-bit random words per key: shape (...,) for n == 0 (a scalar
    draw), else (..., n)."""
    cnt = torch.arange(max(n, 1), dtype=torch.int64, device=keys.device)
    bits = bits_at(keys[..., 0:1], keys[..., 1:2], cnt)
    return bits[..., 0] if n == 0 else bits


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): mantissa bits under the exponent of 1.0, - 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor, n: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` per key, for shape () when
    n == 0 and (n,) otherwise."""
    return bits_to_uniform(random_bits(keys, n))


# The float32 constants of XLA's CPU log, the Cephes polynomial
# (xla/service/cpu polynomial approximations), and the smallest normal.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_TINY = 1.1754943508222875e-38
_GUMBEL = {}


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so the sum rounds (to float64, then float32) once
    but for measure-zero double roundings."""
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it, bit for bit on
    normal inputs (the JAX package's `jnp.log` on the CPU): the Cephes
    polynomial with its multiply-adds fused, on the mantissa in
    [sqrt(1/2), sqrt(2)) and the exponent."""
    f32 = dict(dtype=torch.float32, device=x.device)
    x = torch.clamp(x, min=_TINY)
    xi = x.view(torch.int32)
    e = 1.0 + ((xi >> 23) - 0x7F).to(torch.float32)
    m = ((xi & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < torch.tensor(0.707106781186547524, **f32)
    tmp = torch.where(small, m, 0.0)
    m = m - 1.0
    e = e - small.to(torch.float32)
    m = m + tmp
    p = [torch.tensor(c, **f32).double() for c in _LOG_P]
    x2 = m * m
    x3 = x2 * m
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * torch.tensor(-2.12194440e-4, **f32))
    m = m - x2 * 0.5
    m = m + y
    return m + e * torch.tensor(0.693359375, **f32)


def _gumbel_table(device) -> torch.Tensor:
    """-log(-log(u)) for each of the 2^23 values u = max(i 2^-23, tiny) that
    `bits_to_uniform` can give (float32, 32 MiB, one per device)."""
    dev = torch.device(device)
    tab = _GUMBEL.get(dev)
    if tab is None:
        i = torch.arange(1 << 23, dtype=torch.int32, device=dev)
        u = (i | 0x3F800000).view(torch.float32) - 1.0
        # `floats * (1 - tiny) + tiny`, then max(tiny, .): u, or tiny at 0.
        u = torch.clamp(u, min=_TINY)
        tab = _GUMBEL[dev] = -xla_log(-xla_log(u))
    return tab


def categorical(key: torch.Tensor, logits: torch.Tensor, k: int,
                block: int = 1 << 26) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=(k,))` for a (2,) key and
    (E,) float32 logits: row i of the (k, E) Gumbel draw holds flat indices
    i E .. i E + E - 1, and each row's first argmax of gumbel + logits is
    its sample.  Rows and columns stream in blocks of at most `block`
    draws with a running argmax (a later column block wins only when
    strictly larger), so the (k, E) array never exists.  Returns (k,)
    int64."""
    e = logits.shape[0]
    dev = logits.device
    tab = _gumbel_table(dev)
    k1, k2 = key[0], key[1]
    cols = min(e, block)
    rows = max(1, block // cols)
    out = []
    for r0 in range(0, k, rows):
        r = torch.arange(r0, min(k, r0 + rows), dtype=torch.int64,
                         device=dev)[:, None] * e
        best_v = best_i = None
        for c0 in range(0, e, cols):
            c = torch.arange(c0, min(e, c0 + cols), dtype=torch.int64,
                             device=dev)
            g = tab[bits_at(k1, k2, r + c) >> 9]
            v = g + logits[c0:c0 + c.shape[0]]
            arg = torch.argmax(v, 1)
            top = torch.gather(v, 1, arg[:, None])[:, 0]
            if best_v is None:
                best_v, best_i = top, arg + c0
            else:
                up = top > best_v
                best_v = torch.where(up, top, best_v)
                best_i = torch.where(up, arg + c0, best_i)
        out.append(best_i)
    return torch.cat(out)
