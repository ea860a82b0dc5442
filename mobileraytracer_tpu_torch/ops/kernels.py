"""The port's CUDA kernels: public wrappers, plain PyTorch versions and
launch counters.

Each of the four traversal kernels replaces one Pallas kernel of
mobileraytracer_tpu/ops/pallas_bvh.py:
`traverse_banded` the banded one (`_make_kernel` / `_traverse_padded`),
`traverse_tilemt` the tile-MT one (`_make_tilemt_kernel` /
`_traverse_tilemt_padded`), `traverse_tile` the Baldwin-Weber tile one
(`_make_tile_kernel` / `_traverse_tile_padded`) and `traverse_resident`
the resident-table one (`_make_resident_kernel` /
`_traverse_resident_padded`).  The fifth, `gumbel_argmax`, replaces no
Pallas kernel: it is the Gumbel-max draw of `jax.random.categorical`
(`threefry.categorical`, its plain version), which XLA lowered to
elementwise ops.  The sixth, `candidate_windows`, replaces no Pallas
kernel either: it is the `jnp` chain of `pallas_bvh.py::_candidates`, which
XLA fused; its plain version is `block_traversal._candidates_plain`.  The
CUDA kernels live in `../csrc/` and are built at first use by `_build.py`.

A wrapper given CPU tensors runs the kernel's plain version; given CUDA
tensors it launches the kernel or raises.  There is no fallback from one
to the other.  `candidate_windows` takes CUDA tensors alone: its caller,
`block_traversal._candidates`, sends CPU tensors to the plain version.
`LAUNCHES` counts kernel launches (never plain runs).

Shared inputs of the traversal kernels:
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

import numpy as np
import torch

from .. import constants as C
from .. import threefry
from ..utils.metrics import counters, span

LANES = 128                    # triangles per block
ST = C.SUBTILE                 # rays per band / subtile
GROUP = max(1, 128 // ST)      # bands per banded program
TILE = GROUP * ST              # rays per program (both kernels)
_ROWS = 16                     # rows per block in tb
_BIG = C.RAY_LENGTH_MAX

NBP = 640                      # blocks per resident-table partition

# Baldwin-Weber tile kernel: barycentric margin and relative t margin of
# its loose and strict acceptance (pallas_bvh.py:1092-1093).
MU = 2e-3
TREL = 3e-4

LAUNCHES = counters("kernels.LAUNCHES", {"banded": 0, "tilemt": 0,
                                         "tilebw": 0, "resident": 0,
                                         "gumbel": 0, "window": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: the kernels' algorithm on tensors, one Python loop
# iteration per round, over every program that is still walking.
# ---------------------------------------------------------------------------

def _mt_values(blk, ox, oy, oz, dx, dy, dz, prev):
    """Rays (..., R, 1) against blocks (..., 16, LANES): the pairs' det, u,
    v and t, each (..., R, LANES), whether the lane counts (valid and not
    the ray's previous slot), and the lanes' slots.  The arithmetic order
    is the kernels'."""
    pax, pay, paz = blk[..., 0:1, :], blk[..., 1:2, :], blk[..., 2:3, :]
    abx, aby, abz = blk[..., 3:4, :], blk[..., 4:5, :], blk[..., 5:6, :]
    acx, acy, acz = blk[..., 6:7, :], blk[..., 7:8, :], blk[..., 8:9, :]
    slot = blk[..., 10:11, :]
    live = (blk[..., 9:10, :] > 0.5) & (slot != prev)
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
    return det, u, v, t, live, slot


def _exits(rejects):
    """Per pair, the index of the first of the boolean masks `rejects`
    that holds (len(rejects) where none does), counted: a LongTensor of
    len(rejects) + 1 pair counts."""
    stage = torch.full(rejects[0].shape, len(rejects), dtype=torch.uint8,
                       device=rejects[0].device)
    for i in reversed(range(len(rejects))):
        stage = torch.where(rejects[i], i, stage)
    return torch.bincount(stage.reshape(-1).long(),
                          minlength=len(rejects) + 1).cpu()


def _mt_exits(det, u, v, live):
    """Pair counts per exit of mt_test (csrc/mt.cuh), in MT_STAGE_OPS
    order."""
    return _exits((~live, ~(torch.abs(det) >= C.EPSILON),
                   ~((u >= 0.0) & (u <= 1.0)), ~(v >= 0.0),
                   ~(u + v <= 1.0)))


def _mt_round(blk, ox, oy, oz, dx, dy, dz, prev, t_best, slot_best,
              exits=None):
    """One round: rays (..., R, 1) against blocks (..., 16, LANES) -> new
    (t_best, slot_best).  With `exits` (a LongTensor of MT_STAGE_OPS's
    length), adds the round's pair counts per exit of mt_test to it."""
    det, u, v, t, live, slot = _mt_values(blk, ox, oy, oz, dx, dy, dz, prev)
    if exits is not None:
        exits += _mt_exits(det, u, v, live)
    ok = ((torch.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON) & live)
    t = torch.where(ok & (t < t_best), t, _BIG)
    tmin = t.amin(-1, keepdim=True)
    smin = torch.where(t <= tmin, slot.expand_as(t), _BIG).amin(-1,
                                                                keepdim=True)
    closer = tmin < t_best
    return (torch.where(closer, tmin, t_best),
            torch.where(closer, smin, slot_best))


def _ray_parts(r):
    return [r[..., c:c + 1] for c in range(8)]


def banded_plain(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool,
                 stats: bool = False):
    """Banded lockstep walk.  One program = GROUP bands of ST rays, each
    band with its own m candidates (rows of cand_gid/cand_entry, (Bp/ST,
    m)).  Round r tests each band's r-th block; the program stops when
    every band is dead: its next entry is >= its worst t_best, or (any-hit)
    all its rays are occluded.  Dead bands keep visiting until then.
    Returns (t, slot, steps), each (Bp,) f32; steps is the program's round
    count.  With `stats` also the walk's pair counts per exit of the
    Moller-Trumbore test (MT_STAGE_OPS order)."""
    bp = rays.shape[0]
    ng = bp // TILE
    gid = cand_gid.reshape(ng, GROUP, m).long()
    ent = cand_entry.reshape(ng, GROUP, m)
    ox, oy, oz, dx, dy, dz, t_init, prev = _ray_parts(
        rays.reshape(ng, GROUP, ST, 8))
    t_best = t_init.clone()
    slot_best = torch.full_like(t_init, -1.0)
    steps = torch.zeros(ng, dtype=torch.float32, device=rays.device)
    exits = torch.zeros(len(MT_STAGE_OPS), dtype=torch.long) if stats \
        else None

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
                           t_best[idx], slot_best[idx], exits)
        t_best[idx] = tn
        slot_best[idx] = sn
        steps[idx] = float(r + 1)
        alive[idx] = ~done(r, idx)
        r += 1
    steps_r = steps[:, None].expand(ng, TILE).reshape(-1)
    out = t_best.reshape(-1), slot_best.reshape(-1), steps_r.contiguous()
    return out + (exits,) if stats else out


def tilemt_plain(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool,
                 stats: bool = False):
    """Tile-MT walk.  One program = TILE rays on one shared candidate list
    (rows of cand_gid/cand_entry, (Bp/TILE, m)); round r tests all rays
    against block r.  After each round the program stops when r+1 == m or
    entry[r+1] >= the tile's worst t (closest: max t_best; any-hit: max
    t_init over rays not yet occluded, and stop once all are occluded).
    Returns (Bp, 4) f32 rows [t, slot, rounds, 0]; with `stats` also the
    walk's pair counts per exit of the Moller-Trumbore test (MT_STAGE_OPS
    order)."""
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
    exits = torch.zeros(len(MT_STAGE_OPS), dtype=torch.long) if stats \
        else None
    r = 0
    while True:
        idx = alive.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        tn, sn = _mt_round(tb[gid[idx, r]], ox[idx], oy[idx], oz[idx],
                           dx[idx], dy[idx], dz[idx], prev[idx],
                           t_best[idx], slot_best[idx], exits)
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
    return (out, exits) if stats else out


def _f32(x: float) -> float:
    """x rounded once to float32, as a Python float."""
    return float(np.float32(x))


def bw_consts(tmg: float):
    """The tile kernel's constants, each formed in float64 from Python
    floats and rounded once to float32, as the JAX package's arithmetic
    rounds them where they meet a float32 array.  The CUDA kernel gets the
    same values."""
    e = C.EPSILON
    return (_f32(0.5 * e), _f32(1.5 * e), _f32(-MU), _f32(MU),
            _f32(1.0 + MU), _f32(1.0 - MU), _f32(e - tmg), _f32(e + tmg),
            _f32(1.0 + TREL), _f32(1.0 - TREL), _f32(tmg))


_BIG2 = _f32(2.0 * _BIG)


def _argmin_slot(x, slot, m):
    """The lowest slot among lanes whose x is <= m (the row minimum)."""
    return torch.where(x <= m, slot, _BIG2).amin(-1, keepdim=True)


def _bw_round(w, ox, oy, oz, dx, dy, dz, prev, t_hi, any_hit, k,
              exits=None):
    """One round of the tile kernel: rays (n, TILE, 1) against Baldwin-Weber
    blocks w (n, 8, 3*LANES); t_hi holds each ray's loose and strict upper
    t limits.  Returns the round's (m1, sl1, m2, sl2, m3, mo, so, amb),
    each (n, TILE, 1).  Sums run x, y, z, then the offset, each operation
    rounded.  With `exits`, adds the round's pair counts per exit of
    BW_STAGE_OPS to it."""
    half_eps, eps15, neg_mu, mu, one_p_mu, one_m_mu, eps_m_tmg, eps_p_tmg = \
        k[:8]
    hi_loose, hi_strict = t_hi
    rows = w[:, :, None, :]                               # (n, 8, 1, 384)

    def group(g):
        r = rows[..., g * LANES:(g + 1) * LANES]
        at_o = ox * r[:, 0] + oy * r[:, 1] + oz * r[:, 2] + r[:, 3]
        along_d = dx * r[:, 0] + dy * r[:, 1] + dz * r[:, 2]
        return at_o, along_d

    no, nd = group(0)
    uo, ud = group(1)
    vo, vd = group(2)
    inv_nd = 1.0 / torch.where(torch.abs(nd) < half_eps, 1.0, nd)
    t = -no * inv_nd
    u = uo + t * ud
    v = vo + t * vd
    meta = rows[:, 4]                                     # (n, 1, 384)
    tvalid = meta[..., 0:LANES] > 0.5
    slot_b = meta[..., LANES:2 * LANES].expand_as(t)
    nlen = meta[..., 2 * LANES:3 * LANES]
    base = tvalid & (slot_b != prev)
    det_s = torch.abs(nd) * nlen
    well_cond = torch.abs(nd) >= half_eps
    loose = (base & (det_s >= half_eps) & well_cond & (u >= neg_mu)
             & (v >= neg_mu) & (u + v <= one_p_mu) & (t >= eps_m_tmg)
             & (t <= hi_loose))
    amb = (base & (det_s >= half_eps) & ~well_cond).any(-1, keepdim=True)
    strict = (base & (det_s >= eps15) & well_cond & (u >= mu) & (v >= mu)
              & (u + v <= one_m_mu) & (t >= eps_p_tmg) & (t <= hi_strict))
    if exits is not None:
        # Past each exit neither acceptance (nor the ambiguity flag) can
        # hold: eps15 > half_eps, mu > -mu, and the strict t range is
        # checked apart from the loose one.
        exits += _exits((~base, ~((det_s >= half_eps) & well_cond),
                         ~((t >= eps_m_tmg) & (t <= hi_loose))
                         & ~((t >= eps_p_tmg) & (t <= hi_strict)),
                         ~(u >= neg_mu), ~(v >= neg_mu)))
    tstr = torch.where(strict, t, _BIG2)
    mo = tstr.amin(-1, keepdim=True)
    so = _argmin_slot(tstr, slot_b, mo)

    # The round's three smallest tracked t, with the slots of the first
    # two.  The order of the slot resets is the JAX kernel's (:1207-1218):
    # m3 masks with sl2 before sl2 is reset.
    track = (loose & ~strict) if any_hit else loose
    tl = torch.where(track, t, _BIG2)
    m1 = tl.amin(-1, keepdim=True)
    sl1 = _argmin_slot(tl, slot_b, m1)
    sl1 = torch.where(m1 < _BIG, sl1, -1.0)
    tl2 = torch.where(slot_b == sl1, _BIG2, tl)
    m2 = tl2.amin(-1, keepdim=True)
    sl2 = _argmin_slot(tl2, slot_b, m2)
    m3 = torch.where((slot_b == sl2) & (tl2 <= m2), _BIG2, tl2).amin(
        -1, keepdim=True)
    sl2 = torch.where(m2 < _BIG, sl2, -1.0)
    return m1, sl1, m2, sl2, m3, mo, so, amb


_TILE_CHUNK = 512    # tiles per pass of tile_plain (bounds its temporaries)


def tile_plain(tw, cand_gid, cand_entry, rays, m: int, any_hit: bool,
               tmg: float, stats: bool = False):
    """Baldwin-Weber tile walk.  One program = TILE rays on one shared list
    of m candidate blocks (rows of cand_gid/cand_entry, (Bp/TILE, m)), read
    from tw (NB, 8, 3*LANES).  Per round, every (ray, lane) pair gets the
    plane distance t and barycentrics u, v from six affine forms, then
    loose and strict acceptance with the margins MU, TREL and tmg; each ray
    keeps its three smallest loose t (slots of the first two; any-hit:
    only loose-but-not-strict pairs), its smallest strict t and slot, and
    an ambiguity flag for pairs whose |n.d| is too small to trust.  The
    tile stops after the round where r + 1 == m or entry[r + 1] >= the
    tile's largest bound: closest hit min(ts_m (1 + TREL) + tmg, cap);
    any-hit cap, or -2 BIG once the ray has a strict hit.
    Returns (Bp, 16) f32 rows [t1, s1, t2, s2, t3, ts_m, ts_s, rounds,
    amb, 0 x 7]; with `stats` also the walk's pair counts per exit of
    BW_STAGE_OPS.  Tiles are independent and run in chunks."""
    bp = rays.shape[0]
    nt = bp // TILE
    out = torch.zeros((bp, 16), dtype=torch.float32, device=rays.device)
    exits = torch.zeros(len(BW_STAGE_OPS), dtype=torch.long) if stats \
        else None
    for c0 in range(0, nt, _TILE_CHUNK):
        c1 = min(nt, c0 + _TILE_CHUNK)
        out[c0 * TILE:c1 * TILE] = _tile_chunk(
            tw, cand_gid[c0:c1], cand_entry[c0:c1],
            rays[c0 * TILE:c1 * TILE], m, any_hit, tmg, exits)
    return (out, exits) if stats else out


def _tile_chunk(tw, cand_gid, cand_entry, rays, m, any_hit, tmg, exits):
    k = bw_consts(tmg)
    one_p_trel, one_m_trel, tmg32 = k[8], k[9], k[10]
    bp = rays.shape[0]
    nt = bp // TILE
    dev = rays.device
    gid = cand_gid.reshape(nt, m).long()
    ent = cand_entry.reshape(nt, m)
    ox, oy, oz, dx, dy, dz, cap, prev = _ray_parts(rays.reshape(nt, TILE, 8))
    hi_loose = cap * one_p_trel + tmg32
    hi_strict = cap * one_m_trel - tmg32
    full = lambda v: torch.full((nt, TILE, 1), v, dtype=torch.float32,
                                device=dev)
    t1, t2, t3, ts_m = full(_BIG2), full(_BIG2), full(_BIG2), full(_BIG2)
    s1, s2, ts_s, amb = full(-1.0), full(-1.0), full(-1.0), full(0.0)
    rounds = torch.zeros(nt, dtype=torch.float32, device=dev)
    alive = torch.ones(nt, dtype=torch.bool, device=dev)
    r = 0
    while True:
        i = alive.nonzero()[:, 0]
        if i.numel() == 0:
            break
        m1, sl1, m2, sl2, m3, mo, so, amb_r = _bw_round(
            tw[gid[i, r]], ox[i], oy[i], oz[i], dx[i], dy[i], dz[i],
            prev[i], (hi_loose[i], hi_strict[i]), any_hit, k, exits)
        amb[i] = torch.maximum(amb[i], amb_r.to(torch.float32))
        tsm, tss = ts_m[i], ts_s[i]
        better_o = mo < tsm
        ts_m[i] = torch.where(better_o, mo, tsm)
        ts_s[i] = torch.where(better_o & (mo < _BIG), so, tss)

        # Merge the round's sorted triple into the running one.
        a1, b1, a2, b2, a3 = t1[i], s1[i], t2[i], s2[i], t3[i]
        take1 = m1 < a1
        o_t = torch.where(take1, a1, m1)
        o_s = torch.where(take1, b1, sl1)
        a_t = torch.where(take1, m2, a2)
        a_s = torch.where(take1, sl2, b2)
        take2 = a_t < o_t
        t3[i] = torch.minimum(
            torch.minimum(torch.maximum(a1, m2), torch.maximum(a2, m1)),
            torch.minimum(a3, m3))
        t1[i] = torch.where(take1, m1, a1)
        s1[i] = torch.where(take1, sl1, b1)
        t2[i] = torch.where(take2, a_t, o_t)
        s2[i] = torch.where(take2, a_s, o_s)
        rounds[i] = float(r + 1)

        if any_hit:
            bound = torch.where(ts_m[i] < _BIG, -_BIG2, cap[i])
        else:
            bound = torch.minimum(ts_m[i] * one_p_trel + tmg32, cap[i])
        stop = ent[i, min(r + 1, m - 1)] >= bound.amax((1, 2))
        if r + 1 >= m:
            stop = torch.ones_like(stop)
        alive[i] = ~stop
        r += 1
    out = torch.zeros((bp, 16), dtype=torch.float32, device=dev)
    for c, x in enumerate((t1, s1, t2, s2, t3, ts_m, ts_s)):
        out[:, c] = x.reshape(-1)
    out[:, 7] = rounds[:, None].expand(nt, TILE).reshape(-1)
    out[:, 8] = amb.reshape(-1)
    return out


_RES_CHUNK = 2048    # (partition, 8-band program) pairs per pass of
                     # resident_plain


MAX_BANDS = 32    # bands per resident program: 32 threads each, 1,024 a block


def check_bands(g_n) -> int:
    """g_n, the resident kernel's bands per program, if it is an int in
    [1, MAX_BANDS]; ValueError otherwise."""
    if not isinstance(g_n, int) or not 1 <= g_n <= MAX_BANDS:
        raise ValueError(f"the resident kernel takes 1 to {MAX_BANDS} bands "
                         f"a program (a band is one 32-thread warp and a "
                         f"CUDA block holds at most 1,024 threads), got "
                         f"{g_n!r}")
    return g_n


def resident_plain(tb, starts, glist, rays, m: int, n_parts: int,
                   g_n: int = GROUP, stats: bool = False):
    """Resident-table any-hit walk.  tb is the block table zero-padded to
    n_parts * NBP blocks; the grid is (partition p, program).  One program =
    g_n bands of ST rays; band g's gid-sorted list (a row of glist,
    (Bp/ST, m)) holds its partition-p blocks at [s0, s1) = starts[g, p],
    starts[g, p + 1] (starts (Bp/ST, n_parts + 1)).  Round r tests, for every
    band, block clip(s0 + r, s0, max(s1 - 1, s0)) of its list, read at
    clip(gid - p NBP, 0, NBP - 1) inside partition p (list positions past
    the program's g_n*m entries read its last one).  A band is alive while
    s0 + r < s1 and one of its rays is unoccluded; the program runs while
    any of its g_n bands is alive, and dead bands keep testing their
    clamped block, so t and slot depend on g_n.
    Returns (t, slot), each (n_parts, Bp) f32; with `stats` also the
    rounds of each (partition, program), (n_parts, Bp/(g_n ST)) int64, the
    number of distinct blocks of tb the walk read, and the walk's pair
    counts per exit of the Moller-Trumbore test (MT_STAGE_OPS order)."""
    bp = rays.shape[0]
    ng = bp // (g_n * ST)
    dev = rays.device
    st = starts.reshape(ng, g_n, n_parts + 1).long()
    gl = glist.reshape(ng, g_n * m).long()
    ox, oy, oz, dx, dy, dz, t_init, prev = _ray_parts(
        rays.reshape(ng, g_n, ST, 8))
    t_best = t_init.expand(n_parts, ng, g_n, ST, 1).clone()
    slot_best = torch.full_like(t_best, -1.0)
    parts = torch.arange(n_parts, device=dev)[:, None].expand(n_parts, ng)
    progs = torch.arange(ng, device=dev)[None, :].expand(n_parts, ng)
    s0 = st[progs, :, parts]                              # (P, ng, g_n)
    s1 = st[progs, :, parts + 1]
    band = torch.arange(g_n, device=dev) * m

    def live(r, p, g, tb_):
        has = s0[p, g] + r < s1[p, g]
        not_occ = ~(tb_ < t_init[g]).all(-1).all(-1)      # (k, g_n)
        return (has & not_occ).any(1)

    alive = live(0, parts.reshape(-1), progs.reshape(-1),
                 t_best.reshape(-1, g_n, ST, 1)).reshape(n_parts, ng)
    rounds = torch.zeros((n_parts, ng), dtype=torch.int64, device=dev)
    read = torch.zeros(tb.shape[0], dtype=torch.bool, device=dev)
    exits = torch.zeros(len(MT_STAGE_OPS), dtype=torch.long) if stats \
        else None
    chunk = max(1, _RES_CHUNK * GROUP // g_n)
    r = 0
    while True:
        pairs = alive.nonzero()
        if pairs.shape[0] == 0:
            break
        for c0 in range(0, pairs.shape[0], chunk):
            p, g = pairs[c0:c0 + chunk].unbind(1)
            a, b = s0[p, g], s1[p, g]
            idx = torch.minimum(a + r, torch.maximum(b - 1, a))
            pos = torch.clamp(band + idx, max=g_n * m - 1)
            lid = torch.clamp(gl[g[:, None], pos] - p[:, None] * NBP, 0,
                              NBP - 1)
            row = p[:, None] * NBP + lid
            read[row] = True
            blk = tb[row]                                 # (k, g_n, 16, LANES)
            tn, sn = _mt_round(blk, ox[g], oy[g], oz[g], dx[g], dy[g],
                               dz[g], prev[g], t_best[p, g],
                               slot_best[p, g], exits)
            t_best[p, g] = tn
            slot_best[p, g] = sn
            rounds[p, g] = r + 1
            alive[p, g] = live(r + 1, p, g, tn)
        r += 1
    out = (t_best.reshape(n_parts, bp).contiguous(),
           slot_best.reshape(n_parts, bp).contiguous())
    return out + (rounds, int(read.sum()), exits) if stats else out


# ---------------------------------------------------------------------------
# Bounds: the least time one H100 could take for a kernel's work.
# ---------------------------------------------------------------------------

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): f32
# outside the tensor cores, and HBM3 bandwidth.  The f32 rate counts an
# FMA as two operations; the kernels are built with --fmad=false to stay
# bitwise equal to their plain versions, and unfused a lane does one
# operation per clock, PEAK_FP32_UNFUSED.  The bound uses the published
# rate, so an unfused kernel's share cannot pass 0.5.
PEAK_FP32 = 67e12            # operations / s
PEAK_FP32_UNFUSED = PEAK_FP32 / 2
PEAK_HBM = 3.35e12           # bytes / s
# f32 arithmetic operations of one ray-triangle test done up to each of
# its exits, counted from the sources; comparisons, selects and the running
# minima are not counted.  Moller-Trumbore (csrc/mt.cuh, mt_test): a lane
# that is invalid or the ray's previous slot needs none; |det| < eps leaves
# after 14 (9 for p, 5 for det); u outside [0, 1] after 24 (1 division, 3
# for tv, 6 for u); v < 0 after 39 (9 for q, 6 for v); u + v > 1 after 40;
# a pair that forms t takes 46.  Baldwin-Weber (csrc/traverse_tilebw.cu,
# kernels.tile_plain): none for an invalid lane or the previous slot; 6
# (the normal's rate along d, 5, and det_s) when det_s or |n.d| is too
# small for either acceptance; 14 (the normal's form at the origin, 6, the
# division and t) when t is outside both t ranges; 27 (u's two forms, 6 +
# 5, and u) when u < -MU; 40 (v's, 13) when v < -MU; 41 with u + v.
MT_STAGE_OPS = (0, 14, 24, 39, 40, 46)
BW_STAGE_OPS = (0, 6, 14, 27, 40, 41)
MT_OPS, BW_OPS = MT_STAGE_OPS[-1], BW_STAGE_OPS[-1]
# Bytes of one block that a round reads: rows 0-10 of tb, rows 0-4 of tw.
MT_BLOCK_BYTES = 11 * LANES * 4
BW_BLOCK_BYTES = 5 * 3 * LANES * 4


def traversal_bound(exits, stage_ops, io_bytes: int, blocks: int,
                    block_bytes: int) -> dict:
    """The least time one H100 could take for a traversal kernel's work.
    `exits` counts the (ray, triangle) pairs the walk tests (every round of
    every program, dead bands included, as the plain version walks it) by
    the exit each takes, and `stage_ops` (MT_STAGE_OPS or BW_STAGE_OPS)
    gives the operations done up to each exit; their sum over PEAK_FP32 is
    the compute time.  The bytes are `io_bytes` (rays read, outputs
    written, candidate lists) plus `blocks` distinct blocks of
    `block_bytes`, over PEAK_HBM.  Returns {"ms", "by" ("compute" or
    "bytes"), "tests", "ops", "bytes", "unfused_ms"}: the bound is the
    larger time; unfused_ms is the compute time at PEAK_FP32_UNFUSED."""
    exits = [int(n) for n in exits]
    if len(exits) != len(stage_ops):
        raise ValueError(f"{len(exits)} exit counts for {len(stage_ops)} "
                         f"stages")
    tests = sum(exits)
    ops = sum(n * k for n, k in zip(exits, stage_ops))
    nbytes = io_bytes + blocks * block_bytes
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return {"ms": max(t_ops, t_bytes) * 1e3,
            "by": "compute" if t_ops >= t_bytes else "bytes",
            "tests": tests, "ops": ops, "bytes": nbytes,
            "unfused_ms": ops / PEAK_FP32_UNFUSED * 1e3}


# The Gumbel-max kernel's work: about 75 int32 operations a count (the 20
# rounds' add, rotate and xor, the key injections, the output's xor and
# shift, the 64-bit index) over the H100's int32 rate, 132 SMs x 64 lanes
# x 1.98 GHz (csrc/gumbel_argmax.cu).
GUMBEL_INT_OPS = 75
PEAK_INT32 = 132 * 64 * 1.98e9   # operations / s


def gumbel_bound_ms(k: int, e: int) -> float:
    """The least time one H100 could take for a (k, E) Gumbel-max draw."""
    return k * e * GUMBEL_INT_OPS / PEAK_INT32 * 1e3


# The window kernel's work: 12 f32 operations an axis a box (two
# differences and four products a face; the minima, maxima and the
# selections' compares are not counted), and 3 divisions a ray for 1 / d
# (csrc/candidate_windows.cu).
WINDOW_BOX_OPS = 36
WINDOW_RAY_OPS = 3


def window_bound(b: int, nt: int, k1: int, s: int, bps: int, m: int,
                 bounded: int) -> dict:
    """The least time one H100 could take for one window call: b rays in
    nt bundles over k1 supers, s of them chosen, bps blocks a super, m
    candidates a window, and `bounded` of cap and floor given.  Every super
    and every block of the chosen supers gets its slab test; the bytes are
    the rays' origins and directions, the super table, the chosen supers'
    packed rows, each bundle's cap and floor, and the outputs, each once.
    Returns the dict of `traversal_bound` (tests: the boxes tested)."""
    boxes = nt * (k1 + s * bps)
    ops = boxes * WINDOW_BOX_OPS + b * WINDOW_RAY_OPS
    nbytes = (b * 24 + k1 * 6 * 4 + min(k1, nt * s) * 8 * bps * 4
              + nt * 4 * bounded + nt * (m * 12 + 4))
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return {"ms": max(t_ops, t_bytes) * 1e3,
            "by": "compute" if t_ops >= t_bytes else "bytes",
            "tests": boxes, "ops": ops, "bytes": nbytes,
            "unfused_ms": ops / PEAK_FP32_UNFUSED * 1e3}


def visited_blocks(cand_gid, rounds) -> int:
    """Distinct block ids among the first rounds[i] entries of each list
    cand_gid[i] (rounds per list, clamped to the list length m)."""
    m = cand_gid.shape[1]
    r = torch.as_tensor(rounds, device=cand_gid.device).long().clamp(max=m)
    walked = torch.arange(m, device=cand_gid.device)[None, :] < r[:, None]
    return int(torch.unique(cand_gid[walked]).numel())


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check_placed(dev, named, on="rays"):
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {on} on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check_tensors(dev, named):
    _check_placed(dev, named)
    if dev.type == "cuda" and ST != 16:
        raise ValueError(f"the CUDA kernels are built for 16-ray subtiles, "
                         f"not MRT_SUBTILE={ST}")
    if dev.type == "cuda":
        # Rays and blocks are read 16 bytes at a time.
        for name, x, _ in named:
            if name in ("rays", "tb", "tw") and x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")


def _check_rays(rays):
    bp = rays.shape[0]
    if rays.dim() != 2 or rays.shape[1] != 8 or bp % TILE:
        raise ValueError(f"rays must be (Bp, 8) with Bp a multiple of {TILE},"
                         f" got {tuple(rays.shape)}")
    return bp


def _check(table, cand_gid, cand_entry, rays, m, rows_per_list,
           name="tb", block=(_ROWS, LANES)):
    _check_tensors(rays.device, ((name, table, torch.float32),
                                 ("cand_gid", cand_gid, torch.int32),
                                 ("cand_entry", cand_entry, torch.float32),
                                 ("rays", rays, torch.float32)))
    if table.dim() != 3 or tuple(table.shape[1:]) != block:
        raise ValueError(f"{name} must be (NB, {block[0]}, {block[1]}), got "
                         f"{tuple(table.shape)}")
    bp = _check_rays(rays)
    want = (bp // rows_per_list, m)
    if m < 1 or tuple(cand_gid.shape) != want \
            or tuple(cand_entry.shape) != want:
        raise ValueError(f"candidates must be {want}, got "
                         f"{tuple(cand_gid.shape)} / "
                         f"{tuple(cand_entry.shape)}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _launch(fn: str, name: str, dev, *args):
    """Calls launcher `fn` of the library with `args` and PyTorch's current
    stream, raises on a launch error, and counts the launch."""
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(err)}")
    LAUNCHES[name] += 1


def _order_scratch(bp, dev):
    """Scratch for a tile kernel's longest-first tile order
    (csrc/tile_order.cuh): the tiles' counts, then the order."""
    return torch.empty(2 * (bp // TILE), dtype=torch.int32, device=dev)


@span("kernels.traverse_banded")
def traverse_banded(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Banded kernel (see banded_plain).  cand_gid/cand_entry are (Bp/ST,
    m); returns (t, slot, steps), each (Bp,) f32."""
    _check(tb, cand_gid, cand_entry, rays, m, ST)
    if rays.device.type == "cpu":
        return banded_plain(tb, cand_gid, cand_entry, rays, m, any_hit)
    bp = rays.shape[0]
    out = torch.empty((3, bp), dtype=torch.float32, device=rays.device)
    if bp:
        _launch("mrt_traverse_banded", "banded", rays.device,
                _ptr(tb), _ptr(cand_gid), _ptr(cand_entry), _ptr(rays),
                _ptr(out), ctypes.c_int(bp // TILE), ctypes.c_int(m),
                ctypes.c_int(int(any_hit)))
    return out[0], out[1], out[2]


@span("kernels.traverse_tilemt")
def traverse_tilemt(tb, cand_gid, cand_entry, rays, m: int, any_hit: bool):
    """Tile-MT kernel (see tilemt_plain).  cand_gid/cand_entry are
    (Bp/TILE, m); returns (Bp, 4) f32 [t, slot, rounds, 0]."""
    _check(tb, cand_gid, cand_entry, rays, m, TILE)
    if rays.device.type == "cpu":
        return tilemt_plain(tb, cand_gid, cand_entry, rays, m, any_hit)
    bp = rays.shape[0]
    out = torch.empty((bp, 4), dtype=torch.float32, device=rays.device)
    if bp:
        scratch = _order_scratch(bp, rays.device)
        _launch("mrt_traverse_tilemt", "tilemt", rays.device,
                _ptr(tb), _ptr(cand_gid), _ptr(cand_entry), _ptr(rays),
                _ptr(scratch), _ptr(out), ctypes.c_int(bp // TILE),
                ctypes.c_int(m), ctypes.c_int(int(any_hit)))
    return out


@span("kernels.traverse_tile")
def traverse_tile(tw, cand_gid, cand_entry, rays, m: int, any_hit: bool,
                  tmg: float):
    """Baldwin-Weber tile kernel (see tile_plain).  tw is (NB, 8, 3*LANES);
    cand_gid/cand_entry are (Bp/TILE, m); tmg is the grid's t_margin.
    Returns (Bp, 16) f32 [t1, s1, t2, s2, t3, ts_m, ts_s, rounds, amb,
    0 x 7]."""
    _check(tw, cand_gid, cand_entry, rays, m, TILE, "tw", (8, 3 * LANES))
    if rays.device.type == "cpu":
        return tile_plain(tw, cand_gid, cand_entry, rays, m, any_hit, tmg)
    bp = rays.shape[0]
    out = torch.empty((bp, 16), dtype=torch.float32, device=rays.device)
    if bp:
        consts = (ctypes.c_float * 11)(*bw_consts(tmg))
        scratch = _order_scratch(bp, rays.device)
        _launch("mrt_traverse_tilebw", "tilebw", rays.device,
                _ptr(tw), _ptr(cand_gid), _ptr(cand_entry), _ptr(rays),
                _ptr(scratch), _ptr(out), ctypes.c_int(bp // TILE),
                ctypes.c_int(m), ctypes.c_int(int(any_hit)), consts)
    return out


@span("kernels.traverse_resident")
def traverse_resident(tb, starts, glist, rays, m: int, n_parts: int,
                      g_n: int = GROUP):
    """Resident-table any-hit kernel (see resident_plain), g_n bands of ST
    rays a program (1 to MAX_BANDS; Bp a multiple of g_n * ST).  tb is
    padded to n_parts * NBP blocks; starts is (Bp/ST, n_parts + 1) and
    glist (Bp/ST, m), both int32.  Returns (t, slot), each (n_parts, Bp)
    f32."""
    check_bands(g_n)
    _check_tensors(rays.device, (("tb", tb, torch.float32),
                                 ("starts", starts, torch.int32),
                                 ("glist", glist, torch.int32),
                                 ("rays", rays, torch.float32)))
    bp = rays.shape[0]
    if rays.dim() != 2 or rays.shape[1] != 8 or bp % (g_n * ST):
        raise ValueError(f"rays must be (Bp, 8) with Bp a multiple of "
                         f"{g_n * ST} ({g_n} bands of {ST}), got "
                         f"{tuple(rays.shape)}")
    if n_parts < 1 or tuple(tb.shape) != (n_parts * NBP, _ROWS, LANES):
        raise ValueError(f"tb must be ({n_parts} * {NBP}, {_ROWS}, {LANES}),"
                         f" got {tuple(tb.shape)}")
    if m < 1 or tuple(starts.shape) != (bp // ST, n_parts + 1) \
            or tuple(glist.shape) != (bp // ST, m):
        raise ValueError(f"starts/glist must be ({bp // ST}, {n_parts + 1})"
                         f" / ({bp // ST}, {m}), got {tuple(starts.shape)} /"
                         f" {tuple(glist.shape)}")
    if rays.device.type == "cpu":
        return resident_plain(tb, starts, glist, rays, m, n_parts, g_n)
    out = torch.empty((2, n_parts, bp), dtype=torch.float32,
                      device=rays.device)
    if bp:
        _launch("mrt_traverse_resident", "resident", rays.device,
                _ptr(tb), _ptr(starts), _ptr(glist), _ptr(rays), _ptr(out),
                ctypes.c_int(bp // (g_n * ST)), ctypes.c_int(n_parts),
                ctypes.c_int(m), ctypes.c_int(g_n))
    return out[0], out[1]


@span("kernels.gumbel_argmax")
def gumbel_argmax(key, logits, k: int, table):
    """Gumbel-max draw (see threefry.categorical, its plain version): k
    samples of the categorical over the (E,) float32 logits under the (2,)
    int64 key, with `table` the (2^23,) float32 Gumbel table
    (`threefry._gumbel_table`).  Returns (k,) int64 columns."""
    dev = logits.device
    _check_placed(dev, (("key", key, torch.int64),
                        ("logits", logits, torch.float32),
                        ("table", table, torch.float32)), on="logits")
    e = logits.shape[0]
    if tuple(key.shape) != (2,) or logits.dim() != 1 or not 0 < e < 2**31 \
            or tuple(table.shape) != (1 << 23,) or not 0 <= k < 2**31:
        raise ValueError(f"want a (2,) key, (E,) logits with 0 < E < 2^31, a"
                         f" (2^23,) table and 0 <= k < 2^31, got "
                         f"{tuple(key.shape)}, {tuple(logits.shape)}, "
                         f"{tuple(table.shape)}, k={k}")
    if dev.type == "cpu":
        return threefry.categorical(key, logits, k, table=table)
    packed = torch.zeros(k, dtype=torch.int64, device=dev)
    if k:
        _launch("mrt_gumbel_argmax", "gumbel", dev, _ptr(key), _ptr(logits),
                _ptr(table), _ptr(packed), ctypes.c_int(k), ctypes.c_int(e))
    # The low word holds 0xFFFFFFFF - column (csrc/gumbel_argmax.cu).
    return 0xFFFFFFFF - (packed & 0xFFFFFFFF)


# The window kernel keeps each selection as a sorted list of at most 4 keys
# a lane (csrc/candidate_windows.cu).
WINDOW_DEPTH = 128


@span("kernels.candidate_windows")
def candidate_windows(super_lo, super_hi, blocks_packed, nb: int, o, d,
                      cap, floor, st: int, s: int, m: int):
    """Window kernel (plain version: block_traversal._candidates_plain,
    whose contract it keeps): one window of the m nearest candidate blocks
    per st-ray bundle, from the s nearest supers.  super_lo/super_hi are
    (3, K1), blocks_packed (K1, 8 BPS) and nb = K1 BPS blocks; o and d are
    (B, 3) rows with unit column stride (B = nt st; any row stride); cap
    and floor are (nt,) or None.  Returns (cand_gid, cand_first,
    cand_entry, cut): (nt, m) int32, int32 and f32, and (nt,) f32.  CUDA
    tensors only."""
    dev = o.device
    f32 = torch.float32
    named = [("super_lo", super_lo, f32), ("super_hi", super_hi, f32),
             ("blocks_packed", blocks_packed, f32)]
    named += [(n, x, f32) for n, x in (("cap", cap), ("floor", floor))
              if x is not None]
    _check_placed(dev, named, on="o")
    for name, x in (("o", o), ("d", d)):
        if x.device != dev or x.dtype != f32 or x.dim() != 2 \
                or x.shape[1] != 3 or x.stride(1) != 1:
            raise ValueError(f"{name} must be (B, 3) float32 on {dev} with "
                             f"unit column stride, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, strides "
                             f"{x.stride()}")
    b = o.shape[0]
    k1 = super_lo.shape[-1]
    bps = blocks_packed.shape[-1] // 8
    if d.shape[0] != b or st < 1 or b % st:
        raise ValueError(f"o and d must hold the same whole number of "
                         f"{st}-ray bundles, got {tuple(o.shape)} / "
                         f"{tuple(d.shape)}")
    nt = b // st
    if tuple(super_lo.shape) != (3, k1) or tuple(super_hi.shape) != (3, k1) \
            or tuple(blocks_packed.shape) != (k1, 8 * bps) or k1 < 1 \
            or bps < 1 or nb != k1 * bps:
        raise ValueError(f"want super_lo/super_hi (3, K1), blocks_packed "
                         f"(K1, 8 BPS) and nb = K1 BPS, got "
                         f"{tuple(super_lo.shape)}, {tuple(super_hi.shape)},"
                         f" {tuple(blocks_packed.shape)}, nb={nb}")
    if not (1 <= s <= min(k1, WINDOW_DEPTH)
            and 1 <= m <= min(s * bps, WINDOW_DEPTH)):
        raise ValueError(f"the window kernel takes 1 <= top_s <= min(K1, "
                         f"{WINDOW_DEPTH}) and 1 <= top_m <= min(top_s BPS, "
                         f"{WINDOW_DEPTH}) (its sorted lists hold 4 keys a "
                         f"lane), got top_s={s}, top_m={m} with K1={k1}, "
                         f"BPS={bps}")
    for name, x in (("cap", cap), ("floor", floor)):
        if x is not None and tuple(x.shape) != (nt,):
            raise ValueError(f"{name} must be ({nt},), got {tuple(x.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"the window kernel takes CUDA tensors, got {dev} "
                         f"(block_traversal._candidates takes the plain "
                         f"version for CPU tensors)")
    cand_gid = torch.empty((nt, m), dtype=torch.int32, device=dev)
    cand_first = torch.empty((nt, m), dtype=torch.int32, device=dev)
    cand_entry = torch.empty((nt, m), dtype=f32, device=dev)
    cut = torch.empty(nt, dtype=f32, device=dev)
    if nt:
        opt = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
        _launch("mrt_candidate_windows", "window", dev, _ptr(o), _ptr(d),
                _ptr(super_lo), _ptr(super_hi), _ptr(blocks_packed),
                opt(cap), opt(floor), _ptr(cand_gid), _ptr(cand_first),
                _ptr(cand_entry), _ptr(cut), ctypes.c_int(nt),
                ctypes.c_int(st), ctypes.c_int(o.stride(0)),
                ctypes.c_int(d.stride(0)), ctypes.c_int(k1),
                ctypes.c_int(bps), ctypes.c_int(s), ctypes.c_int(m),
                ctypes.c_int(nb), ctypes.c_float(_BIG))
    return cand_gid, cand_first, cand_entry, cut
