"""The eight pixel samplers of the reference as deterministic streams
(port of `mobileraytracer_tpu/samplers.py`, whose docstring explains
the design: the reference's value sequences are kept, and its atomic
draw cursor is replaced by the canonical assignment draw = 2 * pixel id
(u) and 2 * pixel id + 1 (v), with a new pass of 2 * domain draws per
sample index).

name               reference                 value stream
constant           Constant.cpp:9-11         fixed 0.5
stratified         Stratified.cpp:10-19      draw / domainSize, 1.0 past it
haltonseq          HaltonSeq.cpp:10-19       haltonSequence(draw, 2), 1.0 past
mersenne           MersenneTwister.cpp:5-12  the threefry stream
pcg                PCG.cpp:6-13              PCG-RXS-M-XS-32 per draw
static_haltonseq   StaticHaltonSeq.cpp       shuffled Halton 2^20 table
static_mersenne    StaticMersenneTwister.cpp MT19937-filled 2^20 table
static_pcg         StaticPCG.cpp             PCG64-filled 2^20 table

uint32 arithmetic is done in int64 masked to 32 bits.  The static tables
are filled by numpy exactly as the JAX package fills them (seed 0).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import sampling

ARRAY_MASK = 0xFFFFF          # reference Utils/Constants.hpp:70
ARRAY_SIZE = ARRAY_MASK + 1   # reference Utils/Constants.hpp:79
_M32 = 0xFFFFFFFF

SAMPLER_NAMES = (
    "constant", "stratified", "haltonseq", "mersenne", "pcg",
    "static_haltonseq", "static_mersenne", "static_pcg",
)


def _halton_base2_np(index: np.ndarray) -> np.ndarray:
    """Base-2 radical inverse in float64, rounded to float32 (the static
    Halton table's fill)."""
    idx = index.astype(np.uint64)
    value = np.zeros(idx.shape, np.float64)
    fraction = np.ones(idx.shape, np.float64)
    for _ in range(32):
        active = idx > 0
        fraction = np.where(active, fraction / 2.0, fraction)
        value = np.where(active, value + fraction * (idx & 1), value)
        idx = idx >> 1
    return value.astype(np.float32)


@lru_cache(maxsize=None)
def _static_array(kind: str) -> np.ndarray:
    """The 2^20-entry table of a Static* sampler (reference
    Utils.hpp:210-252), seed pinned to 0."""
    if kind == "haltonseq":
        vals = _halton_base2_np(np.arange(ARRAY_SIZE))
        np.random.RandomState(0).shuffle(vals)
        return vals
    if kind == "mersenne":  # numpy RandomState is MT19937
        return np.random.RandomState(0).random_sample(
            ARRAY_SIZE).astype(np.float32)
    if kind == "pcg":       # numpy default_rng is PCG64
        return np.random.default_rng(0).random(ARRAY_SIZE, np.float32)
    raise ValueError(kind)


@lru_cache(maxsize=None)
def _static_table(kind: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_static_array(kind)).to(device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 x and c, without leaving int64: c is
    split into 16-bit halves so no product passes 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _pcg_rxs_m_xs_32(state: torch.Tensor) -> torch.Tensor:
    """One PCG-RXS-M-XS-32 output word of a uint32 state (O'Neill 2014
    §6.3.4), the JAX package's stand-in for the reference's pcg32."""
    state = (_mul32(state, 747796405) + 2891336453) & _M32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def pixel_jitter(name: str, base_key: torch.Tensor, pixel_ids: torch.Tensor,
                 sample_idx: int, domain_size: int) -> torch.Tensor:
    """The two pixel-jitter draws (u, v) of each pixel of a batch; (B, 2)
    float32 in [0, 1].  `domain_size` is width * height, the reference's
    domainSize_.  Divisions by the constant domain are products with its
    float32 reciprocal, as XLA compiles the JAX package's."""
    dev = pixel_ids.device
    pid = pixel_ids.to(torch.int64) & _M32
    draws = torch.stack([(pid * 2) & _M32, (pid * 2 + 1) & _M32], -1)
    past = draws >= domain_size
    one = torch.ones((), dtype=torch.float32, device=dev)

    if name == "constant":
        return torch.full(draws.shape, 0.5, dtype=torch.float32, device=dev)
    if name == "stratified":
        inv = torch.tensor(1.0 / domain_size, dtype=torch.float32,
                           device=dev)
        return torch.where(past, one, draws.to(torch.float32) * inv)
    if name == "haltonseq":
        return torch.where(past, one, sampling.halton(draws, 2))
    if name == "mersenne":
        keys = sampling.ray_key(base_key, pixel_ids, sample_idx)
        jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
        return sampling.uniform(jkeys, 2)
    # A pass of 2 * domain draws per sample index, in uint32.
    offset = (int(sample_idx) * 2 * domain_size) & _M32
    if name == "pcg":
        # The seed word is the key's last: jax.random.key_data(key)[-1].
        seed = base_key.reshape(-1)[-1].to(dev)
        state = (draws + offset + _mul32(seed, 0x9E3779B9)) & _M32
        bits = _pcg_rxs_m_xs_32(state)
        return bits.to(torch.float32) * (1.0 / 4294967296.0)
    if name.startswith("static_"):
        table = _static_table(name[len("static_"):], dev)
        return table[(draws + offset) & ARRAY_MASK]
    raise ValueError(
        f"unknown pixel_sampler {name!r}; expected one of {SAMPLER_NAMES}")
