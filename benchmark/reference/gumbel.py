"""Length-importance edge draws: `jax.random.categorical(key, logits,
shape=(k,))` over float32 logits, the first argmax of Gumbel noise plus
the logits, with the noise -log(-log(u)) of XLA's CPU log.

A frozen copy of the port's `threefry.xla_log` and `threefry.categorical`
arithmetic (the Cephes polynomial with fused multiply-adds, and the
2^23-entry table of the noise over every float32 uniform), so that the
reference draws the same edges from the same key by itself.
"""
from __future__ import annotations

import torch

from .threefry import threefry2x32

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_TINY = 1.1754943508222875e-38
_M32 = 0xFFFFFFFF


def _fma(a, b, c):
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
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


def _table(device) -> torch.Tensor:
    i = torch.arange(1 << 23, dtype=torch.int32, device=device)
    u = torch.clamp((i | 0x3F800000).view(torch.float32) - 1.0, min=_TINY)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, k: int,
                block: int = 1 << 26, low=lambda x: x) -> torch.Tensor:
    """k draws (int64) of a (2,) key over (E,) logits: row i of the (k, E)
    draw holds flat indices i E .. i E + E - 1; a later column block wins
    only when strictly larger.  `low` rounds each score (noise plus logit)
    where it is made (the control's bfloat16)."""
    e = logits.shape[0]
    dev = logits.device
    tab = _table(dev)
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
            idx = r + c
            b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
            v = low(tab[(b1 ^ b2) >> 9] + logits[c0:c0 + c.shape[0]])
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
