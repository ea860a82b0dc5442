"""Block tables, candidate windows and the traversal kernels' plain
versions of the PyTorch port, held against the JAX package (Pallas
kernels in interpret mode).  The drivers around the kernels are held in
test_torch_traversal_drivers.py; the resident-table kernel, which needs a
table of several partitions, in test_torch_traversal_modes.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu_torch import bench_scenes as tbs
from mobileraytracer_tpu_torch import cameras as tcam
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig

torch.set_num_threads(2)

BIG = C.RAY_LENGTH_MAX
# t from the port's plain kernels vs the Pallas kernels in interpret mode:
# XLA's CPU compiler contracts the Moller-Trumbore products and sums into
# FMAs (a*b + c*d differs from separately rounded arithmetic in about a
# quarter of random cases); the port keeps every operation separately
# rounded, so its CUDA kernels (built with --fmad=false) equal the plain
# versions bit for bit.  Measured differences are a few float32 ulps;
# slots and round counts stay exact.
T_RTOL = 1e-5

_CACHE = {}


def conference20k():
    """(JAX tris, JAX grid, port tris, port grid, camera rays o, d): the
    camera's primary rays of a 32x32 image in patch-major lane order."""
    if "c" not in _CACHE:
        js, jc, _ = jbs.conference_proxy(target_prims=20000)
        ts, tc, _ = tbs.conference_proxy(target_prims=20000)
        jt2, jg = jpb.build_blocks(js.triangles)
        tt2, tg = tbt.build_blocks(ts.triangles)
        u, v, _, _ = trend._pixel_order(TConfig(width=32, height=32))
        zero = torch.zeros_like(u)
        o, d = (a.numpy() for a in tcam.generate_rays(tc, u, v, zero, zero))
        _CACHE["c"] = (jt2, jg, tt2, tg, o, d)
    return _CACHE["c"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tri_fields(tris):
    return {f.name: np.asarray(getattr(tris, f.name))
            for f in dataclasses.fields(tris)}


def _assert_grid_equal(jt2, jg, tt2, tg):
    for f in ("super_lo", "super_hi", "blocks_packed", "tb", "tw",
              "tri_attr"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert (tg.top_s, tg.top_m, tg.t_margin) == (jg.top_s, jg.top_m,
                                                 jg.t_margin)
    # The triangle permutation: every reordered field equal.
    for name, a in _tri_fields(jt2).items():
        np.testing.assert_array_equal(getattr(tt2, name).numpy(), a,
                                      err_msg=name)


def test_build_blocks_equal_conference20k():
    _assert_grid_equal(*conference20k()[:4])


def test_build_blocks_equal_conference_full():
    js, _, _ = jbs.conference_proxy()
    ts, _, _ = tbs.conference_proxy()
    jt2, jg = jpb.build_blocks(js.triangles)
    tt2, tg = tbt.build_blocks(ts.triangles)
    assert tg.tb.shape == (3856, 16, 128)
    _assert_grid_equal(jt2, jg, tt2, tg)


@pytest.mark.parametrize("st", [16, 128, 32, 64])
@pytest.mark.parametrize("bounds", ["none", "cap", "floor", "cap+floor"])
def test_candidates_equal(st, bounds):
    _, jg, _, tg, o, d = conference20k()
    nt = o.shape[0] // st
    rng = np.random.default_rng(st)
    kw = {}
    if "cap" in bounds:
        kw["cap"] = rng.uniform(300, 1500, nt).astype(np.float32)
    if "floor" in bounds:
        kw["floor"] = rng.uniform(0, 600, nt).astype(np.float32)
    jout = jpb._candidates(jg, jnp.asarray(o), jnp.asarray(d), st=st,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    tout = tbt._candidates(tg, _t(o), _t(d), st=st,
                           **{k: _t(v) for k, v in kw.items()})
    for name, j, t in zip(("cand_gid", "cand_first", "cand_entry", "cut"),
                          jout, tout):
        assert t.dtype == torch.from_numpy(np.asarray(j)).dtype, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def _window_edge_case(case):
    """(JAX grid, port grid, o, d, bundle width, cap, knobs) of an edge
    case of the windows: cornell's one super of one block under the
    default window depths (K1 < top_s, s BPS < top_m); every entry +inf
    (cap -inf), so each window is its padding in index order; and rays
    with zero direction components of both signs."""
    rng = np.random.default_rng(21)
    if case == "cornell":
        from mobileraytracer_tpu import scenes as jsc
        from mobileraytracer_tpu_torch import scenes as tsc
        _, jg = jpb.build_blocks(jsc.load_builtin(C.SCENE_CORNELL,
                                                  1.0)[0].triangles)
        _, tg = tbt.build_blocks(tsc.load_builtin(C.SCENE_CORNELL,
                                                  1.0)[0].triangles)
    else:
        _, jg, _, tg, o, d = conference20k()
    lo = tg.super_lo.min(1).values.numpy()
    hi = tg.super_hi.max(1).values.numpy()
    o = rng.uniform(lo, hi, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    if case == "zero_dirs":
        d[::3, 0] = 0.0
        d[1::4, 1] = -0.0
        d[2::5, 2] = 0.0
    nt = 256 // 16
    cap = np.full(nt, -np.inf, np.float32) if case == "all_inf" else None
    top = dict(top_s=32, top_m=48) if case == "cornell" else {}
    return jg, tg, o, d, 16, cap, top


@pytest.mark.parametrize("case", ["cornell", "all_inf", "zero_dirs"])
def test_candidates_equal_edge_cases(case):
    jg, tg, o, d, st, cap, top = _window_edge_case(case)
    kw = {} if cap is None else {"cap": cap}
    jout = jpb._candidates(jg, jnp.asarray(o), jnp.asarray(d), st=st,
                           **{k: jnp.asarray(v) for k, v in kw.items()},
                           **top)
    tout = tbt._candidates(tg, _t(o), _t(d), st=st,
                           **{k: _t(v) for k, v in kw.items()}, **top)
    for name, j, t in zip(("cand_gid", "cand_first", "cand_entry", "cut"),
                          jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    if case == "all_inf":
        assert (tout[2] == BIG).all() and (tout[3] == BIG).all()
        np.testing.assert_array_equal(
            tout[0].numpy(), np.broadcast_to(np.arange(tout[0].shape[1]),
                                             tout[0].shape))


def _kernel_inputs(st, any_hit):
    _, jg, _, tg, o, d = conference20k()
    top = dict(top_s=48, top_m=64) if st == 128 else {}
    cg, _, ce, _ = (np.asarray(a) for a in jpb._candidates(
        jg, jnp.asarray(o), jnp.asarray(d), st=st, **top))
    b = o.shape[0]
    t0 = np.full((b, 1), 900.0 if any_hit else BIG, np.float32)
    prev = np.full((b, 1), -1.0, np.float32)
    prev[::7] = 5.0                        # exercise the previous-slot guard
    rays = np.concatenate([o, d, t0, prev], 1)
    return jg, tg, cg, ce, rays


def _assert_kernel_out(t_port, s_port, n_port, t_jax, s_jax, n_jax):
    np.testing.assert_array_equal(s_port, s_jax)
    np.testing.assert_array_equal(n_port, n_jax)
    np.testing.assert_allclose(t_port, t_jax, rtol=T_RTOL)


@pytest.mark.parametrize("any_hit", [False, True])
def test_banded_plain_matches_pallas(any_hit):
    jg, tg, cg, ce, rays = _kernel_inputs(16, any_hit)
    m = cg.shape[1]
    jt, js, jn = (np.asarray(a)[:, 0] for a in jpb._traverse_padded(
        jnp.asarray(jg.tb), jnp.asarray(cg), jnp.asarray(ce),
        jnp.asarray(rays), m, any_hit, True))
    tt, ts, tn = K.banded_plain(tg.tb, _t(cg), _t(ce), _t(rays), m, any_hit)
    _assert_kernel_out(tt.numpy(), ts.numpy(), tn.numpy(), jt, js, jn)
    assert len(np.unique(jn)) > 1         # programs stop at different rounds


@pytest.mark.parametrize("any_hit", [False, True])
def test_tilemt_plain_matches_pallas(any_hit):
    jg, tg, cg, ce, rays = _kernel_inputs(128, any_hit)
    m = cg.shape[1]
    jo = np.asarray(jpb._traverse_tilemt_padded(
        jnp.asarray(jg.tb), jnp.asarray(cg), jnp.asarray(ce),
        jnp.asarray(rays), m, any_hit, True))
    to = K.tilemt_plain(tg.tb, _t(cg), _t(ce), _t(rays), m, any_hit).numpy()
    _assert_kernel_out(to[:, 0], to[:, 1], to[:, 2], jo[:, 0], jo[:, 1],
                       jo[:, 2])
    np.testing.assert_array_equal(to[:, 3], 0.0)


# Columns of the tile kernel's output rows.
_BW_T = {"t1": 0, "t2": 2, "t3": 4, "ts_m": 5}
_BW_EXACT = {"s1": 1, "s2": 3, "ts_s": 6, "rounds": 7, "amb": 8}


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_plain_matches_pallas(any_hit):
    """XLA's CPU dot_general at HIGHEST precision is an FMA chain; the port
    sums x, y, z and the offset unfused, so the Baldwin-Weber t columns
    differ by rounding.  They are held to the error bound the kernel's own
    margins assume, 2 (TREL |t| + tmg); the slot, round and flag columns
    must be equal on all but 1% of the rays."""
    jg, tg, cg, ce, rays = _kernel_inputs(128, any_hit)
    m = cg.shape[1]
    tmg = tg.t_margin
    jo = np.asarray(jpb._traverse_tile_padded(
        jnp.asarray(jg.tw), jnp.asarray(cg), jnp.asarray(ce),
        jnp.asarray(rays), m, any_hit, True, tmg))
    to = K.tile_plain(tg.tw, _t(cg), _t(ce), _t(rays), m, any_hit,
                      tmg).numpy()
    for name, c in _BW_T.items():
        a, b = to[:, c], jo[:, c]
        np.testing.assert_array_equal(a < BIG, b < BIG, err_msg=name)
        both = (a < BIG) & (b < BIG)
        bound = 2.0 * (K.TREL * np.abs(b) + tmg)
        assert (np.abs(a - b) <= bound)[both].all(), name
    differ = np.zeros(len(rays), bool)
    for c in _BW_EXACT.values():
        differ |= to[:, c] != jo[:, c]
    print(f"tile_plain vs Pallas (any_hit={any_hit}): {differ.sum()} of "
          f"{len(rays)} rays differ in s1, s2, ts_s, rounds or amb")
    assert differ.sum() <= len(rays) // 100
    np.testing.assert_array_equal(to[:, 9:], 0.0)
    assert len(np.unique(to[:, 7])) > 1


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    _, _, _, tg, o, d = conference20k()
    K.reset_launches()
    _, tg_, cg, ce, rays = _kernel_inputs(16, False)
    m = cg.shape[1]
    out = K.traverse_banded(tg.tb, _t(cg), _t(ce), _t(rays), m, False)
    ref = K.banded_plain(tg.tb, _t(cg), _t(ce), _t(rays), m, False)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _, _, cg2, ce2, rays2 = _kernel_inputs(128, True)
    m2 = cg2.shape[1]
    out2 = K.traverse_tilemt(tg.tb, _t(cg2), _t(ce2), _t(rays2), m2, True)
    np.testing.assert_array_equal(
        out2.numpy(), K.tilemt_plain(tg.tb, _t(cg2), _t(ce2), _t(rays2),
                                     m2, True).numpy())
    out3 = K.traverse_tile(tg.tw, _t(cg2), _t(ce2), _t(rays2), m2, True,
                           tg.t_margin)
    np.testing.assert_array_equal(
        out3.numpy(), K.tile_plain(tg.tw, _t(cg2), _t(ce2), _t(rays2), m2,
                                   True, tg.t_margin).numpy())
    tb_pad, starts, glist, n_parts = tbt._resident_lists(tg, _t(cg),
                                                         _t(ce))
    out4 = K.traverse_resident(tb_pad, starts, glist, _t(rays), m, n_parts)
    ref4 = K.resident_plain(tb_pad, starts, glist, _t(rays), m, n_parts)
    for a, b in zip(out4, ref4):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert K.LAUNCHES == {"banded": 0, "tilemt": 0, "tilebw": 0,
                          "resident": 0, "gumbel": 0, "window": 0}
    with pytest.raises(ValueError):
        K.traverse_banded(tg.tb, _t(cg), _t(ce), _t(rays[:100]), m, False)
    with pytest.raises(TypeError):
        K.traverse_banded(tg.tb, _t(cg).long(), _t(ce), _t(rays), m, False)
    with pytest.raises(ValueError):      # tb where tw belongs
        K.traverse_tile(tg.tb, _t(cg2), _t(ce2), _t(rays2), m2, True,
                        tg.t_margin)
    with pytest.raises(TypeError):
        K.traverse_tile(tg.tw.double(), _t(cg2), _t(ce2), _t(rays2), m2,
                        True, tg.t_margin)
    with pytest.raises(ValueError):      # the table is not padded
        K.traverse_resident(tb_pad[:-1], starts, glist, _t(rays), m,
                            n_parts)
    with pytest.raises(ValueError):
        K.traverse_resident(tb_pad, starts[:, 1:], glist, _t(rays), m,
                            n_parts)
    with pytest.raises(TypeError):
        K.traverse_resident(tb_pad, starts.long(), glist, _t(rays), m,
                            n_parts)
