"""Block-BVH traversal with exact windowed refill (port of
`mobileraytracer_tpu/ops/pallas_bvh.py`).

The scene's triangles are cut by the SAH build (ops/bvh.py) into
128-triangle leaf blocks, packed as (NB, 16, 128) component rows in `tb`
(rows 0-2 point_a, 3-5 ab, 6-8 ac, 9 valid flag, 10 global slot id),
grouped 16 blocks to a "super".  A traversal then runs in three stages:

  1. `_candidates`: per bundle of rays, one window of the nearest
     candidate blocks in conservative-entry order, from interval slab
     bounds over the bundle (supers first, then their blocks), plus the
     window's cutoff `cut`: the window kernel (`kernels.candidate_windows`)
     on the card, its plain version `_candidates_plain` on the CPU;
  2. a hand-written CUDA kernel walks the window (ops/kernels.py):
     `traverse_tilemt` for coherent 128-ray tiles (the primary pass),
     `traverse_banded` for 8 bands of 16 rays (the walker tail, every
     shadow ray, and the refill); the scene queries' other modes run
     `traverse_tile` (Baldwin-Weber selection, "tilebw") and
     `traverse_resident` (any-hit over the block table in partitions,
     "resident");
  3. `_refill_exact`: rays whose best hit is beyond their window's cutoff
     get fresh per-ray windows (each ray duplicated into a whole subtile)
     until resolved, then a dense naive backstop, so every traversal
     returns exactly the naive oracle's answer (ids may differ only on
     bit-identical coincident triangles, PARITY.md section 7).

Every function keeps the JAX package's name, shapes and tie rules:
`lax.top_k` becomes a stable sort (lower index first on ties), `argsort`s
are stable, and `mode="drop"` scatters write to a spare slot that is then
cut off.  The JAX `while_loop`s are Python loops; each test of their
condition waits for the device, except in the refill inside a
`Speculation`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import constants as C
from ..types import (Hit, Scene, TensorData, Triangles, device_const,
                     entry_device)
from ..utils.metrics import counters, host_value, span
from . import intersect as nv
from . import kernels
from .bvh import build_triangle_bvh

_BIG = C.RAY_LENGTH_MAX

LANES = kernels.LANES      # triangles per block
ST = kernels.ST            # rays per subtile (candidate-selection unit)
GROUP = kernels.GROUP      # subtiles per banded program (128 rays)
TILE = kernels.TILE        # rays per tile-MT program
DEFAULT_BPS = 16           # blocks per super
DEFAULT_TOP_S = 32         # candidate supers per subtile window
DEFAULT_TOP_M = 48         # candidate blocks per subtile window
TILE_TOP_S = 48            # candidate supers per tile window
TILE_TOP_M = 64            # candidate blocks per tile window

# Iterations of the refill loops since the last reset, for reports.
LOOPS = counters("block_traversal.LOOPS", {"refill": 0, "dense": 0})
# The exact refill's batches: its loops, the unresolved rays they gathered
# and the banded lanes they launched (padding included).
REFILL = counters("block_traversal.REFILL",
                  {"loops": 0, "rays": 0, "lanes": 0})
# A refill loop gathers every unresolved ray up to this many, padded to the
# power of two at or above their count.  65,536 rays are 1,048,576 banded
# lanes; their candidate windows gather 1 GB of block rows (32 supers of 16
# blocks a ray) and hold several 134 MB (ray, block) arrays.
REFILL_CAP = 65536


@dataclasses.dataclass
class BlockGrid(TensorData):
    """Two-level block table (the JAX package's PallasGrid)."""
    super_lo: torch.Tensor       # (3, K1) f32
    super_hi: torch.Tensor       # (3, K1) f32
    # Per-block metadata, one row per super, component-grouped:
    # [lox x BPS][loy x BPS][loz][hix][hiy][hiz][first][count].
    blocks_packed: torch.Tensor  # (K1, 8 * BPS) f32
    tb: torch.Tensor             # (NB, 16, LANES) f32, NB = K1 * BPS
    # The Baldwin-Weber operand of the "tilebw" kernel, one (8, 3*LANES)
    # block per tb block (layout in build_blocks).
    tw: torch.Tensor             # (NB, 8, 3 * LANES) f32
    tri_attr: torch.Tensor       # (N, 32) f32 (layout in intersect._fill_hit)
    top_s: int = DEFAULT_TOP_S
    top_m: int = DEFAULT_TOP_M
    # Absolute t margin of the "tilebw" kernel's loose and strict tests,
    # covering the Baldwin-Weber evaluation error at the scene's extent.
    t_margin: float = 1e-3

    @property
    def num_supers(self) -> int:
        return self.super_lo.shape[1]

    @property
    def bps(self) -> int:
        return self.blocks_packed.shape[1] // 8

    def packed_field(self, gathered: torch.Tensor, f: int) -> torch.Tensor:
        """Component f of gathered (nt, s, 8*BPS) rows as (nt, s*BPS)."""
        nt, s, _ = gathered.shape
        bps = self.bps
        return gathered[:, :, f * bps:(f + 1) * bps].reshape(nt, s * bps)


def build_blocks(tris: Triangles, blocks_per_super: int = DEFAULT_BPS,
                 top_s: int = DEFAULT_TOP_S, top_m: int = DEFAULT_TOP_M,
                 lanes: int = LANES) -> Tuple[Triangles, BlockGrid]:
    """SAH build cut at `lanes`-triangle leaves, packed into blocks (numpy,
    the same arithmetic as the JAX package).  Returns the reordered
    triangles and the grid, as CPU tensors."""
    if lanes % 128:
        raise ValueError("block width must be a multiple of 128")
    tris2, bvh = build_triangle_bvh(tris, leaf_size=lanes)
    counts = np.asarray(bvh.node_count)
    leaf = counts > 0
    bmin = np.asarray(bvh.node_min)[leaf]
    bmax = np.asarray(bvh.node_max)[leaf]
    bfirst = np.asarray(bvh.node_first)[leaf]
    bcount = counts[leaf]
    k = bmin.shape[0]

    bps = min(blocks_per_super, max(k, 1))
    k1 = max(1, -(-k // bps))
    padded = k1 * bps

    def pad(a, fill):
        out = np.full((padded,) + a.shape[1:], fill, a.dtype)
        out[:k] = a
        return out

    bmin_p = pad(bmin, np.float32(3e38)).reshape(k1, bps, 3)
    bmax_p = pad(bmax, np.float32(-3e38)).reshape(k1, bps, 3)
    bfirst_p = pad(bfirst, np.int32(0)).reshape(k1, bps)
    bcount_p = pad(bcount.astype(np.int32), np.int32(0)).reshape(k1, bps)

    pa = tris2.point_a.numpy()
    ab = tris2.ab.numpy()
    ac = tris2.ac.numpy()
    va = tris2.valid.numpy().astype(np.float32)

    # Baldwin-Weber rows per triangle, precomputed in float64 in the global
    # frame: n_hat the unit normal (plane distance n_hat . X + d_n), w_u
    # and w_v the gradients of the barycentrics u and v (w_u . ab = 1,
    # w_u . ac = 0, w_u . n = 0, and symmetrically), with offsets c_u, c_v.
    pa64, ab64, ac64 = (pa.astype(np.float64), ab.astype(np.float64),
                        ac.astype(np.float64))
    n_vec = np.cross(ab64, ac64)
    n_sq = np.einsum("ij,ij->i", n_vec, n_vec)
    n_hat = n_vec / np.maximum(np.sqrt(np.maximum(n_sq, 1e-300)),
                               1e-150)[:, None]
    inv_nsq = 1.0 / np.maximum(n_sq, 1e-300)
    w_u = np.cross(ac64, n_vec) * inv_nsq[:, None]
    w_v = np.cross(n_vec, ab64) * inv_nsq[:, None]
    d_n = -np.einsum("ij,ij->i", n_hat, pa64)
    c_u = -np.einsum("ij,ij->i", w_u, pa64)
    c_v = -np.einsum("ij,ij->i", w_v, pa64)

    tb = np.zeros((padded, 16, lanes), np.float32)
    # tw per block, column groups [n_hat | w_u | w_v] of `lanes` each: rows
    # 0-2 the xyz of the row vectors, row 3 their offsets [d_n | c_u | c_v],
    # row 4 [valid | slot | |ab x ac|], rows 5-7 zero.
    tw = np.zeros((padded, 8, 3 * lanes), np.float32)
    bf = bfirst_p.reshape(-1)
    bc = bcount_p.reshape(-1)
    for bi in range(padded):
        cnt = int(bc[bi])
        if cnt == 0:
            continue
        f0 = int(bf[bi])
        sl = slice(f0, f0 + cnt)
        tb[bi, 0:3, :cnt] = pa[sl].T
        tb[bi, 3:6, :cnt] = ab[sl].T
        tb[bi, 6:9, :cnt] = ac[sl].T
        tb[bi, 9, :cnt] = va[sl]
        # Global triangle slot per lane (f32, exact below 2^24).
        tb[bi, 10, :cnt] = np.arange(f0, f0 + cnt, dtype=np.float32)
        tw[bi, 0:3, :cnt] = n_hat[sl].T
        tw[bi, 3, :cnt] = d_n[sl]
        tw[bi, 0:3, lanes:lanes + cnt] = w_u[sl].T
        tw[bi, 3, lanes:lanes + cnt] = c_u[sl]
        tw[bi, 0:3, 2 * lanes:2 * lanes + cnt] = w_v[sl].T
        tw[bi, 3, 2 * lanes:2 * lanes + cnt] = c_v[sl]
        tw[bi, 4, :cnt] = va[sl]
        tw[bi, 4, lanes:lanes + cnt] = np.arange(f0, f0 + cnt,
                                                 dtype=np.float32)
        # The exact det is (n_hat . d) * |ab x ac|: the kernel's det gates
        # scale |n_hat . d| by this.
        tw[bi, 4, 2 * lanes:2 * lanes + cnt] = np.sqrt(
            np.maximum(n_sq[sl], 0.0)).astype(np.float32)

    packed = np.zeros((k1, 8, bps), np.float32)
    packed[:, 0:3] = np.moveaxis(bmin_p, 2, 1)
    packed[:, 3:6] = np.moveaxis(bmax_p, 2, 1)
    packed[:, 6] = bfirst_p.astype(np.float32)
    packed[:, 7] = bcount_p.astype(np.float32)

    n = pa.shape[0]
    attr = np.zeros((n, 32), np.float32)
    attr[:, 0:3] = pa
    attr[:, 3:6] = ab
    attr[:, 6:9] = ac
    attr[:, 9:12] = tris2.normal_a.numpy()
    attr[:, 12:15] = tris2.normal_b.numpy()
    attr[:, 15:18] = tris2.normal_c.numpy()
    attr[:, 18:20] = tris2.uv_a.numpy()
    attr[:, 20:22] = tris2.uv_b.numpy()
    attr[:, 22:24] = tris2.uv_c.numpy()
    attr[:, 24] = tris2.mat_id.numpy().astype(np.float32)

    t = lambda a: torch.from_numpy(np.array(a, order="C"))
    grid = BlockGrid(
        super_lo=t(bmin_p.min(1).T), super_hi=t(bmax_p.max(1).T),
        blocks_packed=t(packed.reshape(k1, 8 * bps)), tb=t(tb), tw=t(tw),
        tri_attr=t(attr), top_s=min(top_s, k1),
        top_m=min(top_m, k1 * bps),
        # About 8x the 2-ulp Baldwin-Weber error at the scene's extent.
        t_margin=float(max(1e-6, 2e-6 * float(
            np.linalg.norm(bmax.max(0) - bmin.min(0))))) if k else 1e-6)
    return tris2, grid


def build(scene: Scene, device=None, **kwargs) -> Scene:
    """Attaches the block grid to the scene (reordering its triangles) and
    moves the scene to `device`: the CUDA card unless another is named
    (types.entry_device; without a card it raises)."""
    device = entry_device(device)
    tris2, grid = build_blocks(scene.triangles.to("cpu"), **kwargs)
    return scene.replace(triangles=tris2, bvh=grid).to(device)


# ---------------------------------------------------------------------------
# Candidate selection.
# ---------------------------------------------------------------------------

def _subtile_intervals(o, inv_d, nt, st=ST):
    """Per-axis per-bundle (o_min, o_max, inv_min, inv_max), each (nt, 1)."""
    o_t = o.t()
    i_t = inv_d.t()
    out = []
    for a in range(3):
        oa = o_t[a].reshape(nt, st)
        ia = i_t[a].reshape(nt, st)
        out.append((oa.amin(1, keepdim=True), oa.amax(1, keepdim=True),
                    ia.amin(1, keepdim=True), ia.amax(1, keepdim=True)))
    return out


def _interval_entry_lb(ivals, lo_hi, with_ub=False):
    """Conservative per-bundle lower bound of the slab entry over the
    bundle's rays, +inf where every ray certainly misses the box (see the
    JAX package's docstring for the interval argument); optionally also
    the conservative exit upper bound."""
    lb = None
    ub_far = None
    for a in range(3):
        o0, o1, i0, i1 = ivals[a]
        lo, hi = lo_hi[a]

        def corners(bound):
            a0 = bound - o1
            a1 = bound - o0
            p00, p01 = a0 * i0, a0 * i1
            p10, p11 = a1 * i0, a1 * i1
            return (torch.minimum(torch.minimum(p00, p01),
                                  torch.minimum(p10, p11)),
                    torch.maximum(torch.maximum(p00, p01),
                                  torch.maximum(p10, p11)))

        lo_min, lo_max = corners(lo)
        hi_min, hi_max = corners(hi)
        near = torch.minimum(lo_min, hi_min)
        far = torch.maximum(lo_max, hi_max)
        lb = near if lb is None else torch.maximum(lb, near)
        ub_far = far if ub_far is None else torch.minimum(ub_far, far)
    certain_miss = (ub_far < torch.clamp(lb, min=0.0)) | (ub_far < 0.0)
    lb = torch.where(certain_miss, torch.inf, lb)
    if with_ub:
        return lb, ub_far
    return lb


def _smallest(x: torch.Tensor, k: int):
    """The k smallest entries per row in ascending order, ties by lower
    index: `lax.top_k(-x, k)` of the JAX package (torch.topk promises no
    order on ties)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


@span("traversal._candidates")
def _candidates(grid: BlockGrid, o, d, cap=None, floor=None, st=ST,
                top_s=None, top_m=None):
    """One window of candidate blocks per `st`-ray bundle.  Returns
    (cand_gid, cand_first, cand_entry, cut): the nearest top_m blocks in
    ascending conservative-entry order (RAY_LENGTH_MAX on padding
    entries) and the window cutoff.  `cap` (each bundle's worst t_init)
    drops blocks at or beyond it; `floor` (the previous window's cut)
    drops blocks already visited.  CUDA tensors go to the window kernel,
    CPU tensors to `_candidates_plain`; the two agree bit for bit."""
    if o.device.type != "cuda":
        return _candidates_plain(grid, o, d, cap, floor, st, top_s, top_m)
    s = min(top_s if top_s is not None else grid.top_s, grid.num_supers)
    m = min(top_m if top_m is not None else grid.top_m, s * grid.bps)
    return kernels.candidate_windows(
        grid.super_lo, grid.super_hi, grid.blocks_packed, grid.tb.shape[0],
        o, d, cap, floor, st, s, m)


def _candidates_plain(grid: BlockGrid, o, d, cap=None, floor=None, st=ST,
                      top_s=None, top_m=None):
    """`_candidates` in plain PyTorch, the window kernel's reference."""
    b = o.shape[0]
    nt = b // st
    small = torch.abs(d) < 1e-30
    inv_d = 1.0 / torch.where(small, torch.where(d < 0, -1e-30, 1e-30), d)
    ivals = _subtile_intervals(o, inv_d, nt, st)

    # Phase A: supers.
    sup_lo_hi = [(grid.super_lo[a][None, :], grid.super_hi[a][None, :])
                 for a in range(3)]
    e_super, ub_super = _interval_entry_lb(ivals, sup_lo_hi, with_ub=True)
    if cap is not None:
        e_super = torch.where(e_super >= cap[:, None], torch.inf, e_super)
    if floor is not None:
        # A super whose exit bound is below the floor was fully covered
        # by earlier windows.
        e_super = torch.where(ub_super < floor[:, None], torch.inf, e_super)
    s = min(top_s if top_s is not None else grid.top_s, grid.num_supers)
    e_sel, sup_ids = _smallest(e_super, s)
    sup_ok = torch.isfinite(e_sel)
    sup_cut = torch.where(sup_ok.all(1), e_sel[:, -1], torch.inf)

    # Phase B: blocks of the selected supers.
    bps = grid.bps
    nc = s * bps
    gb = grid.blocks_packed[sup_ids]                      # (nt, s, 8*BPS)
    f = lambda i: grid.packed_field(gb, i)
    lo_hi = [(f(0), f(3)), (f(1), f(4)), (f(2), f(5))]
    cb_first = f(6).to(torch.int32)
    cb_count = f(7)

    lb = _interval_entry_lb(ivals, lo_hi)
    # Monotone in the super order, which the soundness of `cut` needs.
    lb = torch.maximum(lb, e_sel.repeat_interleave(bps, 1))
    cand_ok = (cb_count > 0) & sup_ok.repeat_interleave(bps, 1)
    lb = torch.where(cand_ok, lb, torch.inf)
    if cap is not None:
        lb = torch.where(lb >= cap[:, None], torch.inf, lb)
    if floor is not None:
        # Strict: blocks with lb == floor re-enter.
        lb = torch.where(lb < floor[:, None], torch.inf, lb)

    m = min(top_m if top_m is not None else grid.top_m, nc)
    cand_entry, cand = _smallest(lb, m)
    window_full = torch.isfinite(cand_entry[:, -1])
    cut = torch.minimum(torch.where(window_full, cand_entry[:, -1],
                                    torch.inf), sup_cut)
    cand_first = torch.gather(cb_first, 1, cand)
    gids = (sup_ids[:, :, None] * bps
            + torch.arange(bps, device=o.device)[None, None, :])
    cand_gid = torch.gather(gids.reshape(nt, nc), 1, cand)
    # Padding candidates (entry +inf) keep an in-bounds block id.
    cand_gid = torch.clamp(cand_gid, 0, grid.tb.shape[0] - 1).to(torch.int32)
    return (cand_gid, cand_first,
            torch.where(torch.isfinite(cand_entry), cand_entry, _BIG),
            torch.where(torch.isfinite(cut), cut, _BIG))


# ---------------------------------------------------------------------------
# Drivers around the kernels.
# ---------------------------------------------------------------------------

def _banded_balanced(grid, cg, ce, rays_in, m, any_hit):
    """Runs the banded kernel with subtiles sorted by candidate count,
    fewest first, so the 8 lockstep bands of a program have near-equal
    walks; results go back to the caller's subtile order.  The CUDA kernel
    starts the programs from the last, so the longest walks run first
    (only its speed depends on that order).  Returns (t, slot, steps),
    each (nt * ST,)."""
    counts = (ce < _BIG * 0.5).sum(1)
    order = torch.argsort(counts, stable=True)
    lanes_p = (order[:, None] * ST
               + torch.arange(ST, device=order.device)[None, :]).reshape(-1)
    tp, sp, stp = kernels.traverse_banded(
        grid.tb, cg[order].contiguous(), ce[order].contiguous(),
        rays_in[lanes_p].contiguous(), m, any_hit)
    # lanes_p is a permutation: each output slot is written once.
    t_out = torch.empty_like(tp).index_copy_(0, lanes_p, tp)
    s_out = torch.empty_like(sp).index_copy_(0, lanes_p, sp)
    st_out = torch.empty_like(stp).index_copy_(0, lanes_p, stp)
    return t_out, s_out, st_out


def _refill_batch(n: int) -> int:
    """Rays a refill loop gathers for n unresolved ones: the power of two
    at or above n, at least GROUP (a banded program) and at most
    REFILL_CAP."""
    return min(REFILL_CAP, max(GROUP, 1 << max(n - 1, 0).bit_length()))


def _count_refill(loops, rays, lanes) -> None:
    """Counts refill loops, the unresolved rays they gathered and the
    banded lanes they launched: the one place LOOPS["refill"] and REFILL
    advance."""
    LOOPS["refill"] += loops
    REFILL["loops"] += loops
    REFILL["rays"] += rays
    REFILL["lanes"] += lanes


# The loops of a speculative refill, by the rays each gathers (capped at
# the query's own power of two).
SPECULATIVE_BATCHES = (REFILL_CAP, 2048)
_speculation = None


class Speculation:
    """Speculative refills, for a CUDA graph of a walk step
    (shaders/engine.py), which may not read the device.  Inside `with
    spec:` every refill runs one loop of each size of SPECULATIVE_BATCHES,
    whatever its count, and adds to `spec.values`, on the device, whether
    it left a ray unresolved, the loops that gathered a ray, their rays
    and the lanes launched.  `settle(read)` takes those values read on the
    host: it says whether a ray was left unresolved (the step must then
    run again without speculation) and, where none was, counts the loops
    as the read-driven refill would."""

    def __init__(self, device):
        # int64 [unresolved, loops, rays, lanes]
        self.values = torch.zeros(4, dtype=torch.int64, device=device)

    def __enter__(self):
        global _speculation
        self.values.zero_()
        _speculation = self
        return self

    def __exit__(self, *exc):
        global _speculation
        _speculation = None
        return False

    def refill(self, round_, t, sid, floor_r, bp):
        """The fixed loops; a resolved ray 0 in the slots of a loop with
        nothing to gather finds no block below its own t, so its results
        stay as they are."""
        for size in SPECULATIVE_BATCHES:
            nr = min(size, _refill_batch(bp))
            n = (floor_r < t).sum()
            t, sid, floor_r = round_(t, sid, floor_r, nr)
            self.values[1:] += torch.stack([(n > 0).long(),
                                            torch.clamp(n, max=nr),
                                            torch.full_like(n, nr * ST)])
        self.values[0] |= (floor_r < t).any().long()
        return t, sid

    @staticmethod
    def settle(read) -> bool:
        """True where a ray was left unresolved; else counts the loops."""
        unresolved, loops, rays, lanes = read
        if unresolved:
            return True
        _count_refill(loops, rays, lanes)
        return False


@span("traversal._refill_exact")
def _refill_exact(grid, tris, rays, t, sid, floor_r, any_hit, bp):
    """Per-ray exact windowed refill, shared by every traversal.  Rays with
    floor_r < t are unresolved; each loop gathers all of them (up to
    REFILL_CAP, in lane order), duplicates each ST-fold into a subtile of
    its own (the interval hull then is the ray's exact slab bounds) and
    walks it through its next window.  A ray's window depends only on its
    own t and floor, so the batch never changes a hit.  While the
    unresolved rays fit under the cap, every loop is a round of each of
    them; rays left after 256 loops, or 4 loops in a row that resolve
    none, go through the dense naive scan.  One device read a query and
    one a loop: a loop's count after it is the next loop's count before.
    Inside a `Speculation`, its fixed loops and no read.  Returns (t,
    sid)."""
    m = min(grid.top_m, min(grid.top_s, grid.num_supers) * grid.bps)
    dev = rays.device
    rrange = torch.arange(bp, dtype=torch.int64, device=dev)

    def gather_unresolved(t, floor_r, nr):
        """The first nr unresolved rays in lane order; unfilled slots hold
        ray 0 (their results are identical copies)."""
        unres = floor_r < t
        pos = torch.cumsum(unres, 0) - 1
        sel = unres & (pos < nr)
        ridx = torch.zeros(nr + 1, dtype=torch.int64, device=dev)
        ridx[torch.where(sel, pos, nr)] = rrange     # slot nr is the drop
        return ridx[:nr]

    def round_(t, sid, floor_r, nr):
        """One window more for the first nr unresolved rays."""
        ridx = gather_unresolved(t, floor_r, nr)
        lanes = ridx.repeat_interleave(ST)
        rays_c = rays[lanes]
        rays_c[:, 6] = t[lanes]
        cg, _, ce, cut2 = _candidates(grid, rays_c[:, 0:3], rays_c[:, 3:6],
                                      cap=t[ridx], floor=floor_r[ridx])
        t2, s2, _ = _banded_balanced(grid, cg, ce, rays_c, m, any_hit)
        t2 = t2.reshape(nr, ST)[:, 0]
        s2 = s2.reshape(nr, ST)[:, 0]
        t_r = t[ridx]
        better = t2 < t_r
        t = t.index_put((ridx,), torch.where(better, t2, t_r))
        sid = sid.index_put((ridx,), torch.where(better, s2, sid[ridx]))
        floor_r = floor_r.index_put((ridx,),
                                    torch.maximum(floor_r[ridx], cut2))
        return t, sid, floor_r

    if _speculation is not None:
        return _speculation.refill(round_, t, sid, floor_r, bp)

    n = host_value((floor_r < t).sum(), "traversal")
    it = 0
    stall = 0
    while n and it < 256 and stall < 4:
        nr = _refill_batch(n)
        t, sid, floor_r = round_(t, sid, floor_r, nr)
        n_after = host_value((floor_r < t).sum(), "traversal")
        stall = 0 if n_after < n else stall + 1
        it += 1
        _count_refill(1, min(n, nr), nr * ST)
        n = n_after

    # Dense backstop: the naive oracle over the whole triangle table, nd
    # rays at a time; each pass resolves every ray it gathers, so the count
    # left needs no read.
    nd = max(GROUP, min(2048, bp // ST // 4))
    with span("traversal.dense"):
        while n:
            ridx = gather_unresolved(t, floor_r, nd)
            o_g = rays[ridx, 0:3]
            d_g = rays[ridx, 3:6]
            prev_f = rays[ridx, 7]
            pk_g = torch.where(prev_f >= 0, C.PRIM_TRIANGLE,
                               C.PRIM_NONE).to(torch.int32)
            pi_g = prev_f.to(torch.int32)
            t_r = t[ridx]
            td, idd = nv.closest_triangles(tris, o_g, d_g, t_r, pk_g, pi_g)
            better = idd >= 0
            t = t.index_put((ridx,), torch.where(better, td, t_r))
            sid = sid.index_put((ridx,), torch.where(
                better, idd.to(torch.float32), sid[ridx]))
            floor_r = floor_r.index_put((ridx,), torch.full_like(t_r, _BIG))
            n -= min(n, nd)
            LOOPS["dense"] += 1
    return t, sid


def _pack_rays(o, d, t0, prev_kind, prev_id, unit):
    """(Bp, 8) rows [o, d, t_init, prev triangle slot], padded to a `unit`
    multiple with inert +x filler rays (t_init 0)."""
    b = o.shape[0]
    prev_f = torch.where(prev_kind == C.PRIM_TRIANGLE, prev_id,
                         -1).to(torch.float32)
    rays = torch.cat([o, d, t0[:, None], prev_f[:, None]], 1)
    bp = -(-b // unit) * unit
    if bp - b:
        filler = torch.zeros((bp - b, 8), dtype=torch.float32,
                             device=o.device)
        filler[:, 3] = 1.0
        rays = torch.cat([rays, filler], 0)
    return rays, bp


def _t_init(t_init, o):
    if not isinstance(t_init, torch.Tensor):
        t_init = device_const(float(t_init), torch.float32, o.device)
    return torch.as_tensor(t_init, dtype=torch.float32,
                           device=o.device).expand(o.shape[0])


def _subtile_windows(grid, rays, unit, sel_st, top_s, top_m):
    """Window 1 of every ST-ray subtile, selected over `sel_st`-ray
    bundles (ST by default; a multiple of ST that divides `unit`) and
    repeated onto their subtiles: a coarser bundle's hull contains each of
    its subtiles' rays, so its entry bounds stay sound.  Each bundle's
    window is capped at its worst t_init.  Returns (cand_gid, cand_entry,
    cut), one row per subtile."""
    sst = sel_st or ST
    if sst % ST or unit % sst:
        raise ValueError(f"sel_st={sst} must be a multiple of {ST} that "
                         f"divides {unit}")
    bp = rays.shape[0]
    cap0 = rays[:, 6].reshape(bp // sst, sst).amax(1)
    cand_gid, _, cand_entry, cut = _candidates(
        grid, rays[:, 0:3], rays[:, 3:6], cap=cap0, st=sst, top_s=top_s,
        top_m=top_m)
    if sst != ST:
        rep = sst // ST
        cand_gid = cand_gid.repeat_interleave(rep, 0)
        cand_entry = cand_entry.repeat_interleave(rep, 0)
        cut = cut.repeat_interleave(rep, 0)
    return cand_gid.contiguous(), cand_entry.contiguous(), cut


def _tile_windows(grid, rays, top_s=None, top_m=None):
    """The window of every TILE-ray tile, TILE_TOP_S/TILE_TOP_M deep unless
    `top_s`/`top_m` say otherwise, capped at the tile's worst t_init.
    Returns (cand_gid, cand_entry, cut), one row per tile."""
    cap0 = rays[:, 6].reshape(rays.shape[0] // TILE, TILE).amax(1)
    cg, _, ce, cut = _candidates(grid, rays[:, 0:3], rays[:, 3:6], cap=cap0,
                                 st=TILE, top_s=top_s or TILE_TOP_S,
                                 top_m=top_m or TILE_TOP_M)
    return cg, ce, cut


def _window_floor(cut, unit, t, rays, b, any_hit):
    """Each lane's floor after a first pass over windows of `unit` lanes:
    a ray whose best t is within its window's cutoff is resolved, and so
    is every padding lane and, for any-hit, every ray with a blocker (any
    blocker settles an occlusion query)."""
    lane = torch.arange(rays.shape[0], device=rays.device)
    floor_r = torch.where(lane >= b, _BIG, cut.repeat_interleave(unit))
    if any_hit:
        floor_r = torch.where(t < rays[:, 6], _BIG, floor_r)
    return floor_r


def _exact(grid, tris, rays, t, sid, floor_r, any_hit, t0):
    """The tail every traversal shares: the first pass's (t, sid) made
    exact by `_refill_exact` from its floor, cut to the b = len(t0) rays
    of the query, misses as (RAY_LENGTH_MAX, -1)."""
    b = t0.shape[0]
    t, sid = _refill_exact(grid, tris, rays, t, sid, floor_r, any_hit,
                           rays.shape[0])
    t, sid = t[:b], sid[:b]
    hit = t < t0
    return (torch.where(hit, t, _BIG),
            torch.where(hit, sid.to(torch.int32), -1).to(torch.int32))


def traverse(grid: BlockGrid, tris: Triangles, o, d, t_init, prev_kind,
             prev_id, any_hit: bool = False, with_steps: bool = False,
             sel_st: int = None, top_s: int = None, top_m: int = None):
    """Closest-hit (or any-hit) over the triangles through the banded
    kernel.  Returns (t (B,), id (B,) int32, -1 for a miss), and with
    `with_steps` also each ray's lockstep rounds of its banded program in
    window 1 (B,) f32.

    `sel_st` is the width of the bundles window 1 is selected over (ST by
    default; a multiple of ST dividing GROUP * ST), and `top_s`/`top_m`
    override the grid's window depths.  The refill keeps the grid's own
    windows, so any setting returns the same exact hits."""
    b = o.shape[0]
    t0 = _t_init(t_init, o)
    rays, _ = _pack_rays(o, d, t0, prev_kind, prev_id, GROUP * ST)
    cand_gid, cand_entry, cut = _subtile_windows(grid, rays, GROUP * ST,
                                                 sel_st, top_s, top_m)
    m = cand_gid.shape[1]
    t, sid, steps = _banded_balanced(grid, cand_gid, cand_entry, rays, m,
                                     any_hit)
    floor_r = _window_floor(cut, ST, t, rays, b, any_hit)
    out = _exact(grid, tris, rays, t, sid, floor_r, any_hit, t0)
    if with_steps:
        return out + (steps[:b],)
    return out


def traverse_tilemt(grid: BlockGrid, tris: Triangles, o, d, t_init,
                    prev_kind, prev_id, any_hit: bool = False,
                    top_s: int = None, top_m: int = None):
    """Closest-hit (or any-hit) through the tile-MT kernel (one candidate
    window per 128-ray tile, TILE_TOP_S/TILE_TOP_M deep unless `top_s`/
    `top_m` say otherwise) plus the exact banded refill.  Same contract
    as `traverse`."""
    t0 = _t_init(t_init, o)
    rays, _ = _pack_rays(o, d, t0, prev_kind, prev_id, TILE)
    cg, ce, cut = _tile_windows(grid, rays, top_s, top_m)
    out = kernels.traverse_tilemt(grid.tb, cg, ce, rays, cg.shape[1],
                                  any_hit)
    t, sid = out[:, 0], out[:, 1]
    floor_r = _window_floor(cut, TILE, t, rays, o.shape[0], any_hit)
    return _exact(grid, tris, rays, t, sid, floor_r, any_hit, t0)


def _exact_mt_pair(tri_attr, o, d, slot_f, prev_f):
    """The exact Moller-Trumbore re-test of one kept slot per ray (slot_f
    f32, -1 = none) against the triangle table: (t, BIG where it fails;
    ok)."""
    s = torch.clamp(slot_f.to(torch.int32), min=0).long()
    row = tri_attr[s]
    t, ok = nv._mt_components(o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
    ok = ok & (slot_f >= 0.0) & (slot_f != prev_f)
    return torch.where(ok, t, _BIG), ok


def traverse_tile(grid: BlockGrid, tris: Triangles, o, d, t_init,
                  prev_kind, prev_id, any_hit: bool = False):
    """Closest-hit (or any-hit) through the Baldwin-Weber tile kernel, an
    exact re-test of the two pairs it keeps per ray, and the exact banded
    refill of every ray the kernel flags.  Same contract as `traverse`.

    The kernel's affine evaluation is approximate, so it only selects
    (kernels.tile_plain).  A closest-hit ray is flagged when a third loose
    pair lies within the error window of the second, when both kept pairs
    fail the exact test while a third exists, or when it saw an
    ill-conditioned pair (amb); an any-hit ray when it is not occluded by a
    strict pair or a kept pair and a third pair or amb exists."""
    b = o.shape[0]
    t0 = _t_init(t_init, o)
    rays, bp = _pack_rays(o, d, t0, prev_kind, prev_id, TILE)
    op, dp = rays[:, 0:3], rays[:, 3:6]
    cg, ce, cut = _tile_windows(grid, rays)
    tmg = grid.t_margin
    out = kernels.traverse_tile(grid.tw, cg, ce, rays, cg.shape[1], any_hit,
                                tmg)
    t1, s1, t2, s2 = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
    t3, ts_m, ts_s = out[:, 4], out[:, 5], out[:, 6]
    amb = out[:, 8] > 0.5
    prevf = rays[:, 7]
    t0p = rays[:, 6]
    e1, ok1 = _exact_mt_pair(grid.tri_attr, op, dp, s1, prevf)
    e2, ok2 = _exact_mt_pair(grid.tri_attr, op, dp, s2, prevf)
    lanes_pad = torch.arange(bp, device=o.device) >= b

    floor_r = cut.repeat_interleave(TILE)
    if not any_hit:
        t_ex = torch.minimum(e1, e2)
        sid = torch.where(e1 <= e2, s1, s2)
        window = t2 * kernels._f32(1.0 + 2.0 * kernels.TREL) \
            + kernels._f32(2.0 * tmg)
        flag = (((t3 < _BIG) & (t3 <= window))
                | ((t_ex >= _BIG) & (t3 < _BIG)) | amb)
        t_cur = torch.minimum(t_ex, t0p)
    else:
        occ1 = ok1 & (e1 < t0p)
        occ2 = ok2 & (e2 < t0p)
        strict_occ = ts_s >= 0
        occ = strict_occ | occ1 | occ2
        t_cur = torch.where(occ1, e1, torch.where(
            occ2, e2, torch.where(strict_occ, ts_m, t0p)))
        sid = torch.where(occ1, s1, torch.where(
            occ2, s2, torch.where(strict_occ, ts_s, -1.0)))
        flag = ~occ & ((t3 < _BIG) | amb)
        floor_r = torch.where(occ, _BIG, floor_r)   # occluded = resolved

    floor_r = torch.where(flag, -_BIG, floor_r)
    floor_r = torch.where(lanes_pad, _BIG, floor_r)
    t_cur = torch.where(lanes_pad, 0.0, t_cur)
    return _exact(grid, tris, rays, t_cur, sid, floor_r, any_hit, t0)


def _resident_lists(grid: BlockGrid, cand_gid, cand_entry):
    """The resident kernel's inputs from banded windows: the block table
    zero-padded to whole NBP-block partitions, the run starts per subtile
    and partition ((nt, P + 1) int32, capped at the subtile's valid count)
    and each subtile's window sorted by block id, stably, padding entries
    (key nb_pad + 1) last.  Returns (tb_pad, starts, glist, P)."""
    nbp = kernels.NBP
    nb = grid.tb.shape[0]
    n_parts = -(-nb // nbp)
    nb_pad = n_parts * nbp
    valid = cand_entry < _BIG * 0.5
    gid_key = torch.where(valid, cand_gid, nb_pad + 1)
    gsort, order = torch.sort(gid_key, dim=1, stable=True)
    glist = torch.gather(cand_gid, 1, order).contiguous()
    bounds = torch.arange(n_parts + 1, device=cand_gid.device) * nbp
    starts = (gsort[:, :, None] < bounds[None, None, :]).sum(1)
    starts = torch.minimum(starts, valid.sum(1, keepdim=True)).to(
        torch.int32).contiguous()
    tb_pad = grid.tb
    if nb_pad != nb:
        tb_pad = torch.cat([grid.tb, grid.tb.new_zeros(
            (nb_pad - nb,) + tuple(grid.tb.shape[1:]))], 0)
    return tb_pad, starts, glist, n_parts


def traverse_resident(grid: BlockGrid, tris: Triangles, o, d, t_init,
                      prev_kind, prev_id, any_hit: bool = True,
                      sel_st: int = None, top_s: int = None,
                      top_m: int = None, res_group: int = GROUP):
    """Any-hit through the resident-table kernel over the banded windows
    (`_resident_lists`), plus the exact banded refill; same contract as
    `traverse(any_hit=True)`.  Per-partition results combine to the
    smallest t, with the lowest slot at that t.  Rays go `res_group`
    subtiles to a kernel program (kernels.traverse_resident's g_n);
    `sel_st`, `top_s` and `top_m` set window 1 as in `traverse`.
    Closest-hit queries go to `traverse` with the same windows.  The
    default any_hit=True is the JAX package's, so a query through
    `intersect_scene_blocks(mode="resident")` gets any-hit answers, as it
    does there (ROADMAP.md Queue 3)."""
    if not any_hit:
        return traverse(grid, tris, o, d, t_init, prev_kind, prev_id,
                        any_hit=False, sel_st=sel_st, top_s=top_s,
                        top_m=top_m)
    kernels.check_bands(res_group)
    b = o.shape[0]
    t0 = _t_init(t_init, o)
    rays, bp = _pack_rays(o, d, t0, prev_kind, prev_id, res_group * ST)
    # The packed batch, not the program, must hold whole bundles (the
    # JAX package's reshape).
    cand_gid, cand_entry, cut = _subtile_windows(grid, rays, bp, sel_st,
                                                 top_s, top_m)
    m = cand_gid.shape[1]

    tb_pad, starts, glist, n_parts = _resident_lists(grid, cand_gid,
                                                     cand_entry)
    tp, sp = kernels.traverse_resident(tb_pad, starts, glist, rays, m,
                                       n_parts, res_group)
    t = tp.amin(0)
    sid = torch.where(tp <= t[None, :], sp, _BIG).amin(0)
    sid = torch.where(t < _BIG * 0.5, sid, -1.0)
    floor_r = _window_floor(cut, ST, t, rays, b, True)
    return _exact(grid, tris, rays, t, sid, floor_r, True, t0)


_TRAVERSALS = {"banded": traverse, "tilemt": traverse_tilemt,
               "tilebw": traverse_tile, "resident": traverse_resident}
DEFAULT_MODE = "tilemt"


@span("traversal.intersect_scene_blocks")
def intersect_scene_blocks(scene: Scene, o, d, prev_kind, prev_id,
                           t_max=_BIG, mode: str = None,
                           differentiable: bool = False) -> Hit:
    """Closest hit over the whole scene: planes, spheres and area lights by
    the naive scans, triangles by the block traversal (the JAX package's
    `intersect_scene_pallas`).  With `differentiable` the traversal runs
    off the tape on detached triangles and rays; the winner's t is
    re-derived from the live triangle table and the hit attributes are
    gathered from it (not from the grid's packed copy), so gradients reach
    the triangles through the hit, not the walk."""
    grid = scene.bvh
    if not isinstance(grid, BlockGrid):
        raise ValueError("call ops.block_traversal.build first")
    tm = _t_init(t_max, o)
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind,
                                    prev_id)
    t_sp, id_sp = nv.closest_spheres(scene.spheres, o, d, tm, prev_kind,
                                     prev_id)
    trav = _TRAVERSALS[mode or DEFAULT_MODE]
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind,
                                    prev_id)
    if differentiable:
        with torch.no_grad():
            tris = scene.triangles.detach()
            _, id_tr = trav(grid, tris, o.detach(), d.detach(), tm.detach(),
                            prev_kind, prev_id)
        t_tr = nv.recompute_tri_t(scene.triangles, o, d, id_tr)
        t_tr = torch.where(id_tr >= 0, t_tr, _BIG)
        return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr,
                            id_tr, t_li, id_li)
    t_tr, id_tr = trav(grid, scene.triangles, o, d, tm, prev_kind, prev_id)
    t_tr = torch.where(id_tr >= 0, t_tr, _BIG)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li, tri_attr=grid.tri_attr)


# Window knobs of the shadow queries of coherent batches (engine.make_tracer
# passes them for the reversed shared-light NEE bundles).  The JAX
# package's A/B on conference's reversed shared-light bundles (on its TPU)
# found its default windows fastest: coarser selection bundles (sel_st
# 32/64) or fewer supers (top_s 16) starve the super cutoff and blow up the
# per-ray refill, and tile-granular shadow windows over-list badly (the
# 128-ray hull's axis-aligned cone is far fatter than the true cone).  So
# the dict is empty, as there, and kept as the tuning hook; every setting
# stays exact (tests/test_torch_traversal_knobs.py).
SHADOW_SEL = {}


@span("traversal.occluded_blocks")
def occluded_blocks(scene: Scene, o, d, max_dist, prev_kind, prev_id,
                    mode: str = None, **sel):
    """Shadow query over the whole scene (the JAX package's
    `occluded_pallas`); `sel` goes to the traversal (the window knobs of
    `traverse`: sel_st, top_s, top_m; and res_group for "resident")."""
    grid = scene.bvh
    if not isinstance(grid, BlockGrid):
        raise ValueError("call ops.block_traversal.build first")
    md = _t_init(max_dist, o)
    t_pl, _ = nv.closest_planes(scene.planes, o, d, md, prev_kind, prev_id)
    t_sp, _ = nv.closest_spheres(scene.spheres, o, d, md, prev_kind, prev_id,
                                 exclude_prev=True)
    trav = _TRAVERSALS[mode or DEFAULT_MODE]
    _, id_tr = trav(grid, scene.triangles, o, d, md, prev_kind, prev_id,
                    any_hit=True, **sel)
    return (id_tr >= 0) | (t_pl < md) | (t_sp < md)
