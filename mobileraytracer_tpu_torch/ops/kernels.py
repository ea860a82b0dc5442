"""The two traversal kernels: public wrappers, plain PyTorch versions and
launch counters.

`traverse_tilemt` replaces the tile-MT Pallas kernel
(mobileraytracer_tpu/ops/pallas_bvh.py `_make_tilemt_kernel` /
`_traverse_tilemt_padded`); `traverse_banded` replaces the banded one
(`_make_kernel` / `_traverse_padded`).  Both CUDA kernels live in
`../csrc/` and are built at first use by `_build.py`.

A wrapper given CPU tensors runs the kernel's plain version; given CUDA
tensors it launches the kernel or raises.  There is no fallback from one
to the other.  `LAUNCHES` counts kernel launches (never plain runs).

Shared inputs:
  tb          (NB, 16, 128) f32  triangle blocks (rows 0-8 a/ab/ac, 9 valid,
                                 10 global slot id)
  cand_gid    int32, cand_entry f32: per-bundle candidate block ids and
              their conservative entry distances, ascending
  rays        (Bp, 8) f32        [o, d, t_init, previous slot or -1]
The hit test is the reference's Moller-Trumbore acceptance
(Triangle.cpp:63-109) with the previous triangle excluded by slot; ties
within a round go to the lowest slot at the minimum t, and a later round
wins only if strictly closer.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C

LANES = 128                    # triangles per block
ST = C.SUBTILE                 # rays per band / subtile
GROUP = max(1, 128 // ST)      # bands per banded program
TILE = GROUP * ST              # rays per program (both kernels)
_ROWS = 16                     # rows per block in tb
_BIG = C.RAY_LENGTH_MAX

LAUNCHES = {"banded": 0, "tilemt": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: the kernels' algorithm on tensors, one Python loop
# iteration per round, over every program that is still walking.
# ---------------------------------------------------------------------------

def _mt_round(blk, ox, oy, oz, dx, dy, dz, prev, t_best, slot_best):
    """One round: rays (..., R, 1) against blocks (..., 16, LANES) -> new
    (t_best, slot_best).  The arithmetic order is the kernels'."""
    pax, pay, paz = blk[..., 0:1, :], blk[..., 1:2, :], blk[..., 2:3, :]
    abx, aby, abz = blk[..., 3:4, :], blk[..., 4:5, :], blk[..., 5:6, :]
    acx, acy, acz = blk[..., 6:7, :], blk[..., 7:8, :], blk[..., 8:9, :]
    tvalid = blk[..., 9:10, :] > 0.5
    slot = blk[..., 10:11, :]
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    inv = 1.0 / torch.where(torch.abs(det) < C.EPSILON, 1.0, det)
    tvx, tvy, tvz = ox - pax, oy - pay, oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = ((torch.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON)
          & tvalid & (slot != prev))
    t = torch.where(ok & (t < t_best), t, _BIG)
    tmin = t.amin(-1, keepdim=True)
    smin = torch.where(t <= tmin, slot.expand_as(t), _BIG).amin(-1,
                                                                keepdim=True)
    closer = tmin < t_best
    return (torch.where(closer, tmin, t_best),
            torch.where(closer, smin, slot_best))


def _ray_parts(r):
    return [r[..., c:c + 1] for c in range(8)]


def banded_plain(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Banded lockstep walk.  One program = GROUP bands of ST rays, each
    band with its own m candidates (rows of cand_gid/cand_entry, (Bp/ST,
    m)).  Round r tests each band's r-th block; the program stops when
    every band is dead: its next entry is >= its worst t_best, or (any-hit)
    all its rays are occluded.  Dead bands keep visiting until then.
    Returns (t, slot, steps), each (Bp,) f32; steps is the program's round
    count."""
    bp = rays.shape[0]
    ng = bp // TILE
    gid = cand_gid.reshape(ng, GROUP, m).long()
    ent = cand_entry.reshape(ng, GROUP, m)
    ox, oy, oz, dx, dy, dz, t_init, prev = _ray_parts(
        rays.reshape(ng, GROUP, ST, 8))
    t_best = t_init.clone()
    slot_best = torch.full_like(t_init, -1.0)
    steps = torch.zeros(ng, dtype=torch.float32, device=rays.device)

    def done(r, idx):
        nxt = min(r + 1, m - 1)
        tb_g = t_best[idx]
        dead = ent[idx, :, nxt] >= tb_g.amax((2, 3))           # (k, G)
        if r + 1 >= m:
            dead = torch.ones_like(dead)
        if any_hit:
            occluded = (tb_g < t_init[idx]).all(3).all(2)
            dead = dead | occluded
        return dead.all(1)

    idx = torch.arange(ng, device=rays.device)
    alive = ~done(-1, idx)
    r = 0
    while True:
        idx = alive.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        tn, sn = _mt_round(tb[gid[idx, :, r]], ox[idx], oy[idx], oz[idx],
                           dx[idx], dy[idx], dz[idx], prev[idx],
                           t_best[idx], slot_best[idx])
        t_best[idx] = tn
        slot_best[idx] = sn
        steps[idx] = float(r + 1)
        alive[idx] = ~done(r, idx)
        r += 1
    steps_r = steps[:, None].expand(ng, TILE).reshape(-1)
    return t_best.reshape(-1), slot_best.reshape(-1), steps_r.contiguous()


def tilemt_plain(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Tile-MT walk.  One program = TILE rays on one shared candidate list
    (rows of cand_gid/cand_entry, (Bp/TILE, m)); round r tests all rays
    against block r.  After each round the program stops when r+1 == m or
    entry[r+1] >= the tile's worst t (closest: max t_best; any-hit: max
    t_init over rays not yet occluded, and stop once all are occluded).
    Returns (Bp, 4) f32 rows [t, slot, rounds, 0]."""
    bp = rays.shape[0]
    nt = bp // TILE
    gid = cand_gid.reshape(nt, m).long()
    ent = cand_entry.reshape(nt, m)
    ox, oy, oz, dx, dy, dz, t_init, prev = _ray_parts(
        rays.reshape(nt, TILE, 8))
    t_best = t_init.clone()
    slot_best = torch.full_like(t_init, -1.0)
    rounds = torch.zeros(nt, dtype=torch.float32, device=rays.device)
    alive = torch.ones(nt, dtype=torch.bool, device=rays.device)
    r = 0
    while True:
        idx = alive.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        tn, sn = _mt_round(tb[gid[idx, r]], ox[idx], oy[idx], oz[idx],
                           dx[idx], dy[idx], dz[idx], prev[idx],
                           t_best[idx], slot_best[idx])
        t_best[idx] = tn
        slot_best[idx] = sn
        rounds[idx] = float(r + 1)
        if any_hit:
            occ = tn < t_init[idx]
            t_worst = torch.where(occ, -_BIG, t_init[idx]).amax((1, 2))
            t_worst = torch.where(occ.all(2).all(1), -_BIG, t_worst)
        else:
            t_worst = tn.amax((1, 2))
        stop = ent[idx, min(r + 1, m - 1)] >= t_worst
        if r + 1 >= m:
            stop = torch.ones_like(stop)
        alive[idx] = ~stop
        r += 1
    out = torch.zeros((bp, 4), dtype=torch.float32, device=rays.device)
    out[:, 0] = t_best.reshape(-1)
    out[:, 1] = slot_best.reshape(-1)
    out[:, 2] = rounds[:, None].expand(nt, TILE).reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check(tb, cand_gid, cand_entry, rays, m, rows_per_list):
    dev = rays.device
    for name, x, dt in (("tb", tb, torch.float32),
                        ("cand_gid", cand_gid, torch.int32),
                        ("cand_entry", cand_entry, torch.float32),
                        ("rays", rays, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tb.dim() != 3 or tb.shape[1:] != (_ROWS, LANES):
        raise ValueError(f"tb must be (NB, {_ROWS}, {LANES}), got "
                         f"{tuple(tb.shape)}")
    bp = rays.shape[0]
    if rays.dim() != 2 or rays.shape[1] != 8 or bp % TILE:
        raise ValueError(f"rays must be (Bp, 8) with Bp a multiple of {TILE},"
                         f" got {tuple(rays.shape)}")
    want = (bp // rows_per_list, m)
    if m < 1 or tuple(cand_gid.shape) != want \
            or tuple(cand_entry.shape) != want:
        raise ValueError(f"candidates must be {want}, got "
                         f"{tuple(cand_gid.shape)} / "
                         f"{tuple(cand_entry.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and ST != 16:
        raise ValueError(f"the CUDA kernels are built for 16-ray subtiles, "
                         f"not MRT_SUBTILE={ST}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _launch(fn: str, name: str, tb, cand_gid, cand_entry, rays, out,
            any_hit: bool, m: int):
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = getattr(lib, fn)(_ptr(tb), _ptr(cand_gid), _ptr(cand_entry),
                           _ptr(rays), _ptr(out),
                           ctypes.c_int(rays.shape[0] // TILE),
                           ctypes.c_int(m), ctypes.c_int(int(any_hit)),
                           ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(err)}")
    LAUNCHES[name] += 1


def traverse_banded(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Banded kernel (see banded_plain).  cand_gid/cand_entry are (Bp/ST,
    m); returns (t, slot, steps), each (Bp,) f32."""
    _check(tb, cand_gid, cand_entry, rays, m, ST)
    if rays.device.type == "cpu":
        return banded_plain(tb, cand_gid, cand_entry, rays, m, any_hit)
    bp = rays.shape[0]
    out = torch.empty((3, bp), dtype=torch.float32, device=rays.device)
    if bp:
        with torch.cuda.device(rays.device):
            _launch("mrt_traverse_banded", "banded", tb, cand_gid,
                    cand_entry, rays, out, any_hit, m)
    return out[0], out[1], out[2]


def traverse_tilemt(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Tile-MT kernel (see tilemt_plain).  cand_gid/cand_entry are
    (Bp/TILE, m); returns (Bp, 4) f32 [t, slot, rounds, 0]."""
    _check(tb, cand_gid, cand_entry, rays, m, TILE)
    if rays.device.type == "cpu":
        return tilemt_plain(tb, cand_gid, cand_entry, rays, m, any_hit)
    bp = rays.shape[0]
    out = torch.empty((bp, 4), dtype=torch.float32, device=rays.device)
    if bp:
        with torch.cuda.device(rays.device):
            _launch("mrt_traverse_tilemt", "tilemt", tb, cand_gid,
                    cand_entry, rays, out, any_hit, m)
    return out
