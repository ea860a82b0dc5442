"""The least work a frame's traversal queries need, counted from the rays
and the scene's blocks, not from how the program walks them.

For each distinct ray of a query (a lane that only repeats an earlier ray
of its 16-lane subtile is the same work), the blocks are taken in order of
where the ray enters their bounds, and a block is needed while its entry
lies before the nearest triangle found so far (starting from the ray's
segment end).  Each valid triangle of a needed block is one pair, charged
the float32 operations of Moller-Trumbore up to the exit it takes; the
ray's previous triangle and the padding lanes cost nothing.  Bytes count
once each: the rays read, the answers written, and the rows of every
distinct needed block.  A query's least time is the larger of its
operations over the peak rate and its bytes over the peak bandwidth.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

EPSILON = 1.0e-06
SUBTILE = 16
LANES = 128
# Operations of one Moller-Trumbore test up to each of its exits, in exit
# order: no test (invalid lane or the previous triangle), |det| < eps,
# u outside [0, 1], v < 0, u + v > 1, t formed.
MT_STAGE_OPS = (0, 14, 24, 39, 40, 46)
BLOCK_BYTES = 11 * LANES * 4      # rows pa, ab, ac, valid, slot
RAY_BYTES = 8 * 4                 # o, d, t_max, previous triangle
ANSWER_BYTES = 2 * 4              # t, triangle
_RAYS = 1 << 15                   # rays per pass

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_kind: str):
    """(float32 operations/s, bytes/s) of the card, or None."""
    table = json.loads(PEAKS.read_text())
    p = table.get(device_kind)
    return None if p is None else (p["fp32_ops_per_s"], p["bytes_per_s"])


def block_bounds(tb: torch.Tensor):
    """Per block (NB, 3) lower and upper corners over its valid triangles,
    widened by a hair so that rounding never drops a block."""
    pa, ab, ac = tb[:, 0:3], tb[:, 3:6], tb[:, 6:9]
    valid = (tb[:, 9] > 0.5)[:, None, :]
    pts = torch.stack([pa, pa + ab, pa + ac], -1)           # (NB, 3, L, 3)
    inf = torch.tensor(float("inf"), device=tb.device)
    lo = torch.where(valid[..., None], pts, inf).amin((2, 3))
    hi = torch.where(valid[..., None], pts, -inf).amax((2, 3))
    pad = 1e-6 * (hi - lo).abs().clamp(max=1e6) + 1e-4
    return lo - pad, hi + pad


def distinct_rays(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Lanes that do not repeat an earlier lane's ray in their subtile."""
    b = o.shape[0]
    if b % SUBTILE:
        return torch.ones(b, dtype=torch.bool, device=o.device)
    r = torch.cat([o, d], 1).reshape(b // SUBTILE, SUBTILE, 6)
    same = (r[:, :, None] == r[:, None, :]).all(-1)         # (n, i, j)
    earlier = torch.ones(SUBTILE, SUBTILE, dtype=torch.bool,
                         device=o.device).tril(-1)
    return ~(same & earlier).any(-1).reshape(b)


def _exit_stage(det, u, v, live):
    stage = torch.full(det.shape, 5, dtype=torch.int64, device=det.device)
    for i, rej in reversed(list(enumerate((
            ~live, torch.abs(det) < EPSILON, (u < 0.0) | (u > 1.0),
            v < 0.0, u + v > 1.0)))):
        stage = torch.where(rej, i, stage)
    return stage


def query_work(tb, lo, hi, o, d, tmax, prev):
    """(rays, operations, needed-block mask (NB,)) of one query: rays o, d
    (B, 3), segment ends tmax (B,) and previous triangle slots prev (B,)
    (-1 for none)."""
    keep = distinct_rays(o, d)
    o, d, tmax, prev = o[keep], d[keep], tmax[keep], prev[keep]
    ops_tab = torch.tensor(MT_STAGE_OPS, dtype=torch.int64, device=o.device)
    ops = 0
    used = torch.zeros(tb.shape[0], dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], _RAYS):
        ro, rd = o[r0:r0 + _RAYS], d[r0:r0 + _RAYS]
        tiny = torch.where(rd < 0, -1e-30, 1e-30)
        inv = 1.0 / torch.where(rd.abs() < 1e-30, tiny, rd)
        t1 = (lo[None] - ro[:, None]) * inv[:, None]
        t2 = (hi[None] - ro[:, None]) * inv[:, None]
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        del t1, t2
        best = tmax[r0:r0 + _RAYS].clone()
        entry = torch.where((near <= far) & (far >= 0.0), near.clamp(min=0.0),
                            float("inf"))
        entry, order = torch.sort(entry, dim=1)
        pv = prev[r0:r0 + _RAYS]
        for k in range(entry.shape[1]):
            rows = torch.nonzero(entry[:, k] < best).squeeze(1)
            if rows.numel() == 0:
                break
            blk = tb[order[rows, k]]                      # (R, 16, L)
            used[order[rows, k]] = True
            x = ro[rows][:, :, None]
            y = rd[rows][:, :, None]
            px = y[:, 1] * blk[:, 8] - y[:, 2] * blk[:, 7]
            py = y[:, 2] * blk[:, 6] - y[:, 0] * blk[:, 8]
            pz = y[:, 0] * blk[:, 7] - y[:, 1] * blk[:, 6]
            det = blk[:, 3] * px + blk[:, 4] * py + blk[:, 5] * pz
            inv_det = 1.0 / torch.where(torch.abs(det) < EPSILON, 1.0, det)
            tvx, tvy, tvz = x[:, 0] - blk[:, 0], x[:, 1] - blk[:, 1], \
                x[:, 2] - blk[:, 2]
            u = inv_det * (tvx * px + tvy * py + tvz * pz)
            qx = tvy * blk[:, 5] - tvz * blk[:, 4]
            qy = tvz * blk[:, 3] - tvx * blk[:, 5]
            qz = tvx * blk[:, 4] - tvy * blk[:, 3]
            v = inv_det * (y[:, 0] * qx + y[:, 1] * qy + y[:, 2] * qz)
            t = inv_det * (blk[:, 6] * qx + blk[:, 7] * qy + blk[:, 8] * qz)
            live = (blk[:, 9] > 0.5) & (blk[:, 10] != pv[rows][:, None])
            stage = _exit_stage(det, u, v, live)
            ops += int(ops_tab[stage].sum())
            ok = (stage == 5) & (t >= EPSILON)
            tmin = torch.where(ok, t, float("inf")).amin(1)
            best[rows] = torch.minimum(best[rows], tmin)
    return int(keep.sum()), ops, used


def bound_seconds(queries, tb, device_kind: str):
    """Sum over the queries of each one's least time on the card, or None
    where the card has no row in peaks.json.  Each query is (o, d, tmax,
    prev_kind, prev_id) as the program's scene query received it."""
    pk = peaks(device_kind)
    if pk is None or not queries:
        return None
    flops, bw = pk
    lo, hi = block_bounds(tb)
    total = 0.0
    for o, d, tmax, prev_kind, prev_id in queries:
        tm = torch.as_tensor(tmax, dtype=torch.float32,
                             device=o.device).expand(o.shape[0])
        prev = torch.where(prev_kind == 3, prev_id, -1).to(torch.float32)
        rays, ops, used = query_work(tb, lo, hi, o.float(), d.float(),
                                     tm.float(), prev)
        nbytes = rays * (RAY_BYTES + ANSWER_BYTES) + int(used.sum()) \
            * BLOCK_BYTES
        total += max(ops / flops, nbytes / bw)
    return total
