"""The regular grid and the escape-index BVH of the PyTorch port against
the JAX package: the grid's cell table (bit-equal), both traversals on
random rays, and the reference's render matrix, the five shaders over
ACC_NAIVE, ACC_REGULAR_GRID and ACC_BVH, at 32x32 on cornell."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import bvh as jbvh
from mobileraytracer_tpu.ops import grid as jgrid
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import Renderer, convert, sampling
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.ops import bvh as tbvh
from mobileraytracer_tpu_torch.ops import grid as tgrid
from mobileraytracer_tpu_torch.ops import intersect
from mobileraytracer_tpu_torch.shaders import common, engine
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_pathtracer import assert_pt_frames_match
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)


def _scene(which):
    if which == "proxy":
        js, jc, _ = jbs.conference_proxy(target_prims=3000)
    else:
        js, jc = jscenes.load_builtin(which, 1.0)
    return js, jc, convert.scene_from_arrays(arrays(js))


def _rays(js, n, seed):
    """Rays from random points inside the scene's bounds, in random
    directions, with a random triangle as the previous hit of some."""
    rng = np.random.default_rng(seed)
    pa = np.asarray(js.triangles.point_a)[np.asarray(js.triangles.valid)]
    lo, hi = pa.min(0), pa.max(0)
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pk = np.where(rng.random(n) < 0.3, C.PRIM_TRIANGLE, 0).astype(np.int32)
    pi = np.where(pk > 0, rng.integers(0, len(pa), n), -1).astype(np.int32)
    return o, d, pk, pi


@pytest.mark.parametrize("which", [C.SCENE_CORNELL, C.SCENE_SPHERES2,
                                   C.SCENE_CORNELL2, "proxy"])
def test_grid_tables_are_bit_equal(which):
    js, _, ts = _scene(which)
    jg = jgrid.build_grid(js).bvh
    tg = tgrid.build_grid(ts, device="cpu").bvh
    for f in ("bounds_min", "bounds_max", "cell_start", "item_kind",
              "item_id"):
        want, got = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tg.size == jg.size == 32


@pytest.mark.parametrize("which", [C.SCENE_CORNELL, "proxy"])
def test_grid_and_bvh_hits_match_jax(which):
    js, _, ts = _scene(which)
    o, d, pk, pi = _rays(js, 512, 1)
    md = np.full(512, 0.7, np.float32)
    t_ = lambda a: torch.from_numpy(a)
    jsg = jgrid.build_grid(js)
    tsg = tgrid.build_grid(ts, device="cpu")
    jh = jgrid.intersect_scene_grid(jsg, o, d, pk, pi)
    th = tgrid.intersect_scene_grid(tsg, t_(o), t_(d), t_(pk), t_(pi))
    # The same hits; distances to a few ulps (XLA fuses the tests' FMAs).
    np.testing.assert_array_equal(th.prim_kind.numpy(), jh.prim_kind)
    np.testing.assert_array_equal(th.prim_id.numpy(), jh.prim_id)
    np.testing.assert_allclose(th.t.numpy(), jh.t, rtol=1e-5)
    np.testing.assert_array_equal(
        tgrid.occluded_grid(tsg, t_(o), t_(d), t_(md), t_(pk), t_(pi)).numpy(),
        jgrid.occluded_grid(jsg, o, d, md, pk, pi))

    jsb = jbvh.build(js)
    tsb = tbvh.build(ts, device="cpu")
    for f in dataclasses.fields(tsb.bvh):
        np.testing.assert_array_equal(getattr(tsb.bvh, f.name).numpy(),
                                      getattr(jsb.bvh, f.name))
    # The triangle slots of the previous hits, in the reordered table.
    jh = jbvh.intersect_scene_bvh(jsb, o, d, pk, pi)
    th = tbvh.intersect_scene_bvh(tsb, t_(o), t_(d), t_(pk), t_(pi))
    np.testing.assert_array_equal(th.prim_kind.numpy(), jh.prim_kind)
    np.testing.assert_array_equal(th.prim_id.numpy(), jh.prim_id)
    np.testing.assert_allclose(th.t.numpy(), jh.t, rtol=1e-5)
    np.testing.assert_array_equal(
        tbvh.occluded_bvh(tsb, t_(o), t_(d), t_(md), t_(pk), t_(pi)).numpy(),
        jbvh.occluded_bvh(jsb, o, d, md, pk, pi))

    # Both against the port's naive oracle on the same scene.
    nh = intersect.intersect_scene_naive(tsb, t_(o), t_(d), t_(pk), t_(pi))
    np.testing.assert_array_equal(th.prim_id.numpy(), nh.prim_id.numpy())
    t_j, id_j = jbvh.traverse_closest(jsb.bvh, jsb.triangles, o, d,
                                      jnp.float32(C.RAY_LENGTH_MAX), pk, pi)
    t_t, id_t = tbvh.traverse_closest(tsb.bvh, tsb.triangles, t_(o), t_(d),
                                      C.RAY_LENGTH_MAX, t_(pk), t_(pi))
    np.testing.assert_array_equal(id_t.numpy(), id_j)
    np.testing.assert_array_equal(
        tbvh.traverse_any(tsb.bvh, tsb.triangles, t_(o), t_(d), t_(md),
                          t_(pk), t_(pi)).numpy(),
        jbvh.traverse_any(jsb.bvh, jsb.triangles, o, d, md, pk, pi))


def test_grid_frames_trace_shadows_forward(monkeypatch):
    """The grid DDA cannot exclude the sphere a reversed shadow segment
    ends on, so its frames keep reversed NEE off (the JAX package's rule);
    the other accelerators reverse the shared-light segments."""
    seen = []
    lighting = common.direct_lighting

    def spy(*a, **k):
        seen.append(k["reverse"])
        return lighting(*a, **k)

    monkeypatch.setattr(common, "direct_lighting", spy)
    _, jc, ts = _scene(C.SCENE_CORNELL)
    tc = convert.camera_from_arrays(arrays(jc))
    for acc, scene in ((C.ACC_REGULAR_GRID,
                        tgrid.build_grid(ts, device="cpu")),
                       (C.ACC_NAIVE, ts)):
        seen.clear()
        cfg = TConfig(width=16, height=16, accelerator=acc,
                      nee_reverse=True, nee_share_secondary=True)
        trend.render_frame(scene, tc, cfg, sampling.prng_key(0))
        assert seen and any(seen) == (acc != C.ACC_REGULAR_GRID)


def test_unknown_accelerator_raises():
    with pytest.raises(ValueError):
        engine.make_tracer(TConfig(accelerator=7))


# ---------------------------------------------------------------------------
# The render matrix (ShaderTestEngine.cpp:35-123,
# AcceleratorTestEngine.cpp:34-84).
# ---------------------------------------------------------------------------

SHADERS = [C.SHADER_NOSHADOWS, C.SHADER_WHITTED, C.SHADER_PATHTRACER,
           C.SHADER_DEPTHMAP, C.SHADER_DIFFUSE]
ACCELERATORS = [C.ACC_NAIVE, C.ACC_REGULAR_GRID, C.ACC_BVH]


@pytest.mark.parametrize("acc", ACCELERATORS)
@pytest.mark.parametrize("shader", SHADERS)
def test_render_matrix_matches_jax(shader, acc):
    """Each shader over each accelerator against the JAX package's frame of
    the same pair.  ACC_BVH: the escape-index tree on both sides, and the
    port's block BVH too (exact, so the same frame)."""
    kw = dict(width=32, height=32, spp=1, shader=shader, accelerator=acc,
              nee_share=128, nee_share_secondary=True)
    js, jc, ts = _scene(C.SCENE_CORNELL)
    tc = convert.camera_from_arrays(arrays(jc))
    mp = jscenes.DEPTHMAP_MAX_POINT[C.SCENE_CORNELL]
    jbuild = {C.ACC_NAIVE: lambda s: s, C.ACC_REGULAR_GRID: jgrid.build_grid,
              C.ACC_BVH: jbvh.build}[acc]
    jout = jrend.render_frame(jbuild(js), jc, JConfig(**kw),
                              jax.random.PRNGKey(0), mp)
    jimg = np.asarray(jout["image"])
    match = (assert_pt_frames_match if shader == C.SHADER_PATHTRACER
             else assert_frames_match)

    builds = {C.ACC_NAIVE: [lambda s: s],
              C.ACC_REGULAR_GRID: [lambda s: tgrid.build_grid(s,
                                                              device="cpu")],
              C.ACC_BVH: [lambda s: tbvh.build(s, device="cpu"),
                          lambda s: bt.build(s, device="cpu")]}[acc]
    cfg = TConfig(**kw)
    for build in builds:
        tout = trend.render_frame(build(ts), tc, cfg, sampling.prng_key(0),
                                  torch.from_numpy(mp))
        assert int(tout["rays"]) == int(jout["rays"])
        match(tout["image"].numpy(), jimg)
    if acc == C.ACC_REGULAR_GRID:
        # The Renderer builds the grid itself.
        r = Renderer(ts, tc, cfg, max_point=torch.from_numpy(mp),
                     device="cpu")
        assert isinstance(r.scene.bvh, tgrid.RegularGrid)
        np.testing.assert_array_equal(r.render(), tout["image"].numpy())
