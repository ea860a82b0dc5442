"""The window knobs of the port's block traversal and the resident kernel's
bands per program, against the JAX package (Pallas kernels in interpret
mode) and the naive oracle: `traverse(with_steps=, sel_st=, top_s=,
top_m=)`, `traverse_tilemt(top_s=, top_m=)`, `traverse_resident(sel_st=,
top_s=, top_m=, res_group=)`, `occluded_blocks(**sel)`, SHADOW_SEL on the
coherent shadow queries of a frame, and `kernels.resident_plain(g_n=)`
against `_traverse_resident_padded(g_n=)`.  Any window setting must stay
hit for hit exact: the budgets only move work between window 1 and the
refill.  t within T_RTOL (XLA's CPU code contracts FMAs); ids, occlusion,
steps and per-partition slots exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import constants as JC
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import sampling
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import intersect as tnv
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_block_bvh import _random_tris
from test_torch_traversal import BIG, T_RTOL
from test_torch_traversal_drivers import soup

torch.set_num_threads(2)

# tests/test_pallas_bvh.py::test_selection_knobs_stay_exact's settings.
SELS = {
    "shadow": {"sel_st": 32, "top_s": 16, "top_m": 24},
    "coarsest": {"sel_st": 128, "top_s": 16, "top_m": 24},
    "shallow": {"sel_st": 16, "top_s": 8, "top_m": 8},
}
B = 512
MD = 1.5
_CACHE = {}


def setup():
    """(JAX tris, JAX grid, port tris, port grid, o, d, pk, pi, naive t,
    naive id, naive occluder id) for 700 random triangles and 512 rays."""
    if "s" not in _CACHE:
        jt, tt = _random_tris(700)
        jt2, jg = jpb.build_blocks(jt)
        tt2, tg = tbt.build_blocks(tt)
        rng = np.random.default_rng(1)
        o = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
        d = rng.normal(size=(B, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        pk = torch.zeros(B, dtype=torch.int32)
        pi = torch.full((B,), -1, dtype=torch.int32)
        tn, idn = tnv.closest_triangles(tt2, o, d, torch.full((B,), BIG),
                                        pk, pi)
        _, occ = tnv.closest_triangles(tt2, o, d, torch.full((B,), MD), pk,
                                       pi)
        _CACHE["s"] = (jt2, jg, tt2, tg, o, d, pk, pi, tn, idn, occ)
    return _CACHE["s"]


def _j(*a):
    return [jnp.asarray(x.numpy()) for x in a]


def _closest_matches(t, ids, tn, idn, tj=None, idj=None):
    np.testing.assert_array_equal(ids.numpy(), idn.numpy())
    hit = idn.numpy() >= 0
    assert hit.sum() > B // 8
    np.testing.assert_allclose(t.numpy()[hit], tn.numpy()[hit], rtol=T_RTOL)
    if idj is not None:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(idj))
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(tj)[hit],
                                   rtol=T_RTOL)


@pytest.mark.parametrize("sel", list(SELS))
def test_traverse_knobs_match_jax_and_naive(sel):
    """traverse(**sel, with_steps=True), closest and any-hit: the naive
    oracle's hits, JAX's, and JAX's per-ray steps exactly."""
    jt2, jg, tt2, tg, o, d, pk, pi, tn, idn, occ = setup()
    kw = SELS[sel]
    t, ids, steps = tbt.traverse(tg, tt2, o, d, BIG, pk, pi,
                                 with_steps=True, **kw)
    tj, idj, stj = jpb.traverse(jg, jt2, *_j(o, d), JC.RAY_LENGTH_MAX,
                                *_j(pk, pi), with_steps=True, **kw)
    _closest_matches(t, ids, tn, idn, tj, idj)
    assert steps.dtype == torch.float32 and steps.shape == (B,)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(stj))

    md = torch.full((B,), MD)
    _, ida, sta = tbt.traverse(tg, tt2, o, d, md, pk, pi, any_hit=True,
                               with_steps=True, **kw)
    _, idja, stja = jpb.traverse(jg, jt2, *_j(o, d, md, pk, pi),
                                 any_hit=True, with_steps=True, **kw)
    np.testing.assert_array_equal(ida.numpy() >= 0, occ.numpy() >= 0)
    np.testing.assert_array_equal(ida.numpy() >= 0, np.asarray(idja) >= 0)
    np.testing.assert_array_equal(sta.numpy(), np.asarray(stja))


def test_traverse_defaults_unchanged():
    """No knob is the grid's own windows: the same hits and steps as
    before the knobs, i.e. as sel_st=ST with the grid's depths."""
    _, _, tt2, tg, o, d, pk, pi, _, _, _ = setup()
    a = tbt.traverse(tg, tt2, o, d, BIG, pk, pi, with_steps=True)
    b = tbt.traverse(tg, tt2, o, d, BIG, pk, pi, with_steps=True,
                     sel_st=K.ST, top_s=tg.top_s, top_m=tg.top_m)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert len(tbt.traverse(tg, tt2, o, d, BIG, pk, pi)) == 2


def test_tilemt_knobs_match_jax_and_naive():
    """traverse_tilemt(top_s=16, top_m=64) (chip_smoke phase 14's) and a
    shallow (4, 8): closest and any-hit against the oracle and JAX's."""
    jt2, jg, tt2, tg, o, d, pk, pi, tn, idn, occ = setup()
    md = torch.full((B,), MD)
    for kw in ({"top_s": 16, "top_m": 64}, {"top_s": 4, "top_m": 8}):
        t, ids = tbt.traverse_tilemt(tg, tt2, o, d, BIG, pk, pi, **kw)
        tj, idj = jpb.traverse_tilemt(jg, jt2, *_j(o, d), JC.RAY_LENGTH_MAX,
                                      *_j(pk, pi), **kw)
        _closest_matches(t, ids, tn, idn, tj, idj)
        _, ida = tbt.traverse_tilemt(tg, tt2, o, d, md, pk, pi, any_hit=True,
                                     **kw)
        np.testing.assert_array_equal(ida.numpy() >= 0, occ.numpy() >= 0)


RESIDENT = [dict(SELS["shadow"]), dict(SELS["coarsest"]),
            dict(SELS["shallow"])] + [{"res_group": g} for g in
                                      (1, 2, 4, 8, 16)] + [
    # scripts/shadow_ab4.py:88-89's resident sel_st=32, and wide
    # selection on programs of another size.
    {"sel_st": 32}, {"sel_st": 32, "res_group": 4},
    {"sel_st": 64, "res_group": 16, "top_s": 8, "top_m": 8}]


@pytest.mark.parametrize("kw", RESIDENT,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_resident_knobs_match_jax_and_naive(kw):
    """traverse_resident(**kw): any-hit against the oracle and JAX's with
    the same knobs; closest-hit queries go to traverse with the same
    windows."""
    jt2, jg, tt2, tg, o, d, pk, pi, tn, idn, occ = setup()
    md = torch.full((B,), MD)
    _, ida = tbt.traverse_resident(tg, tt2, o, d, md, pk, pi, **kw)
    _, idja = jpb.traverse_resident(jg, jt2, *_j(o, d, md, pk, pi), **kw)
    np.testing.assert_array_equal(ida.numpy() >= 0, occ.numpy() >= 0)
    np.testing.assert_array_equal(ida.numpy() >= 0, np.asarray(idja) >= 0)
    assert (ida >= 0).any() and not (ida >= 0).all()
    t, ids = tbt.traverse_resident(tg, tt2, o, d, BIG, pk, pi,
                                   any_hit=False, **kw)
    _closest_matches(t, ids, tn, idn)


def _cornell2():
    js, _ = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    ts, _ = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    return jpb.build(js), tbt.build(ts, device="cpu")


@pytest.mark.parametrize("mode", ["banded", "resident"])
@pytest.mark.parametrize("sel", list(SELS))
def test_occluded_blocks_knobs(sel, mode):
    """occluded_blocks(mode=, **sel) on cornell2 with random segments:
    the naive scene query's answer and JAX's occluded_pallas with the
    same knobs."""
    if "scenes" not in _CACHE:
        _CACHE["scenes"] = _cornell2()
    jsb, tsb = _CACHE["scenes"]
    rng = np.random.default_rng(3)
    b = 256
    o = torch.from_numpy(rng.uniform(-1, 1, (b, 3)).astype(np.float32))
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    md = torch.full((b,), 0.8)
    pk = torch.zeros(b, dtype=torch.int32)
    pi = torch.full((b,), -1, dtype=torch.int32)
    got = tbt.occluded_blocks(tsb, o, d, md, pk, pi, mode=mode, **SELS[sel])
    want = tnv.occluded_naive(tsb, o, d, md, pk, pi)
    jgot = jpb.occluded_pallas(jsb, *_j(o, d, md, pk, pi), mode=mode,
                               **SELS[sel])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert got.any() and not got.all()


@pytest.mark.parametrize("g_n", [1, 2, 4, 8, 16])
def test_resident_plain_matches_pallas_at_g_n(g_n):
    """The resident walk with g_n bands a program on the soup's three
    partitions: per-partition slots exact and t within T_RTOL of
    `_traverse_resident_padded(interpret=True, g_n=)`, through the
    kernel's wrapper (CPU tensors: the plain version)."""
    _, grid, o, d, _, _, _ = soup()
    b = o.shape[0]
    t0 = torch.full((b, 1), 1.0)
    prev = torch.full((b, 1), -1.0)
    prev[::7] = 5.0
    rays = torch.cat([o, d, t0, prev], 1)
    cap0 = rays[:, 6].reshape(b // K.ST, K.ST).amax(1)
    cg, _, ce, _ = tbt._candidates(grid, o, d, cap=cap0)
    m = cg.shape[1]
    tb_pad, starts, glist, n_parts = tbt._resident_lists(grid, cg, ce)
    assert n_parts == 3
    ng = b // (g_n * K.ST)
    jt, js = (np.asarray(a)[:, :, 0] for a in jpb._traverse_resident_padded(
        jnp.asarray(tb_pad.numpy()),
        jnp.asarray(starts.numpy().reshape(ng, 1, -1)),
        jnp.asarray(glist.numpy().reshape(ng, 1, -1)),
        jnp.asarray(rays.numpy()), m, n_parts, True, g_n=g_n))
    tt, ts = K.traverse_resident(tb_pad, starts, glist, rays, m, n_parts,
                                 g_n)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=T_RTOL)
    assert ((jt < 1.0).sum(1) > 0).all()


def test_knob_errors():
    """Selection bundles that are not whole subtiles dividing the batch's
    programs, and band counts outside 1-32, raise ValueError."""
    _, _, tt2, tg, o, d, pk, pi, _, _, _ = setup()
    for bad in (24, 256):
        with pytest.raises(ValueError, match="sel_st"):
            tbt.traverse(tg, tt2, o, d, BIG, pk, pi, sel_st=bad)
    with pytest.raises(ValueError, match="sel_st"):
        tbt.traverse_resident(tg, tt2, o[:16], d[:16], MD, pk[:16],
                              pi[:16], sel_st=32, res_group=1)
    for bad in (0, 33, 8.0):
        with pytest.raises(ValueError, match="1,024 threads"):
            tbt.traverse_resident(tg, tt2, o, d, MD, pk, pi, res_group=bad)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.traverse_resident(torch.zeros((640, 16, 128)),
                            torch.zeros((3, 2), dtype=torch.int32),
                            torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros((48, 8)), 4, 1, 2)


def test_shadow_sel_reaches_coherent_shadows(monkeypatch):
    """SHADOW_SEL is the JAX package's ({}), and make_tracer passes it on
    the reversed shared-light shadow queries (coherent) only: a frame with
    shallow shadow windows there equals the default frame bit for bit."""
    assert tbt.SHADOW_SEL == jpb.SHADOW_SEL == {}
    _, tsb = _CACHE.get("scenes") or _cornell2()
    cam = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)[1]
    cfg = TConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                  accelerator=C.ACC_BVH, scene_id=C.SCENE_CORNELL2)
    key = sampling.prng_key(0)
    want = trend.render_frame(tsb, cam, cfg, key)
    seen = []
    banded = tbt._TRAVERSALS["banded"]

    def rec(*a, **kw):
        if kw.get("any_hit"):
            seen.append(kw.get("sel_st"))
        return banded(*a, **kw)
    monkeypatch.setitem(tbt._TRAVERSALS, "banded", rec)
    monkeypatch.setattr(tbt, "SHADOW_SEL", dict(SELS["shadow"]))
    got = trend.render_frame(tsb, cam, cfg, key)
    assert 32 in seen and None in seen
    assert torch.equal(got["image"], want["image"])
    assert int(got["rays"]) == int(want["rays"])
