"""The two-level block BVH of the PyTorch port (ops/block_bvh.py) against
the JAX package's ops/block_bvh.py on the CPU: the build's arrays exactly;
closest and any-hit traversals (ids exact, t within T_RTOL: XLA's CPU code
contracts the Moller-Trumbore products and sums into FMAs, the port rounds
each operation); the scene queries; 32x32 frames through make_tracer on a
scene built by block_bvh.build against JAX's CPU Renderer with ACC_BVH
(which builds the same grid): rays exact, the image within the frames'
tolerance; and one material-gradient step of the differentiable walk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import block_bvh as jbb
from mobileraytracer_tpu.parallel import mesh as jmesh
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu.types import Triangles as JTriangles
from mobileraytracer_tpu_torch import Renderer, sampling
from mobileraytracer_tpu_torch import bench_scenes as tbs
from mobileraytracer_tpu_torch import cameras as tcam
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.ops import block_bvh as tbb
from mobileraytracer_tpu_torch.ops import intersect as tnv
from mobileraytracer_tpu_torch.parallel import mesh as tmesh
from mobileraytracer_tpu_torch.shaders import engine
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from mobileraytracer_tpu_torch.types import Triangles
from test_torch_diff_render import jax_scene, port_twin, target
from test_torch_golden_grads import assert_grads_close
from test_torch_pathtracer import assert_pt_frames_match
from test_torch_render import assert_frames_match
from test_torch_traversal import T_RTOL

torch.set_num_threads(2)

BIG = C.RAY_LENGTH_MAX
GRID_FIELDS = ("super_lo", "super_hi", "block_lo", "block_hi",
               "block_first", "block_count", "tri_blocks")
# (scene, build_blocks keywords): the default budgets, which these scenes
# never exhaust, and budgets small enough that some rays lose their hit.
SCENES = {
    "random700": ("random700", {}),
    "random700-tight": ("random700", dict(block_size=8, blocks_per_super=4,
                                          top_s=3, top_m=4)),
    "cornell2": ("cornell2", {}),
    "conference4k": ("conference4k", {}),
}


def _random_tris(n, seed=0):
    """The same n random triangles for both packages."""
    rng = np.random.default_rng(seed)
    f = dict(point_a=rng.uniform(-1, 1, (n, 3)),
             ab=rng.uniform(-0.3, 0.3, (n, 3)),
             ac=rng.uniform(-0.3, 0.3, (n, 3)),
             normal_a=np.zeros((n, 3)), normal_b=np.zeros((n, 3)),
             normal_c=np.zeros((n, 3)), uv_a=np.full((n, 2), -1.0),
             uv_b=np.full((n, 2), -1.0), uv_c=np.full((n, 2), -1.0))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f.update(mat_id=np.zeros((n,), np.int32), valid=np.ones((n,), bool))
    return (JTriangles(**{k: jnp.asarray(v) for k, v in f.items()}),
            Triangles(**{k: torch.from_numpy(v) for k, v in f.items()}))


def _tris(name):
    if name == "random700":
        return _random_tris(700)
    if name == "conference4k":
        return (jbs.conference_proxy(target_prims=4000)[0].triangles,
                tbs.conference_proxy(target_prims=4000)[0].triangles)
    js, _ = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    ts, _ = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    return js.triangles, ts.triangles


_BUILT = {}


def built(case):
    """(JAX tris, JAX grid as device arrays, port tris, port grid)."""
    if case not in _BUILT:
        name, kw = SCENES[case]
        jt, tt = _tris(name)
        jt2, jg = jbb.build_blocks(jt, **kw)
        tt2, tg = tbb.build_blocks(tt, **kw)
        _BUILT[case] = (jt2, jg, tt2, tg)
    return _BUILT[case]


def _camera_rays(b):
    """The first b of the conference proxy's 32x32 primaries in
    patch-major lane order."""
    _, tc, _ = tbs.conference_proxy(target_prims=4000)
    u, v, _, _ = trend._pixel_order(TConfig(width=32, height=32))
    zero = torch.zeros_like(u)
    o, d = tcam.generate_rays(tc, u, v, zero, zero)
    return o[:b].numpy(), d[:b].numpy()


def _rays(b, lo, hi, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


@pytest.mark.parametrize("case", list(SCENES))
def test_build_blocks_equal_jax(case):
    jt2, jg, tt2, tg = built(case)
    for f in GRID_FIELDS:
        want, got = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("block_size", "top_s", "top_m", "tile", "num_supers"):
        assert getattr(tg, f) == getattr(jg, f), f
    np.testing.assert_array_equal(tt2.point_a.numpy(),
                                  np.asarray(jt2.point_a))
    np.testing.assert_array_equal(tt2.valid.numpy(), np.asarray(jt2.valid))


@pytest.mark.parametrize("case,b", [("random700", 512),
                                    ("random700-tight", 512),
                                    ("cornell2", 512), ("cornell2", 37),
                                    ("conference4k", 512)])
def test_traversals_match_jax(case, b):
    """traverse_closest (ids exact, t within T_RTOL) and traverse_any
    (exact) with every fourth ray guarded against its closest triangle; a
    batch of 37 is padded to whole tiles.  Random rays, and the camera's
    primaries on the conference proxy (many supers).  With the default
    budgets the ids are also the naive oracle's."""
    jt2, jg, tt2, tg = built(case)
    jg = jax.tree.map(jnp.asarray, jg)
    if case == "conference4k":
        o, d = _camera_rays(b)
    else:
        o, d = _rays(b, *((-2, 2) if case.startswith("random") else (-1, 1)))
    pk = np.zeros(b, np.int32)
    pi = np.full(b, -1, np.int32)
    tj, ij = jbb.traverse_closest(jg, jt2, *_j(o, d), BIG, *_j(pk, pi))
    tt, it = tbb.traverse_closest(tg, tt2, *_t(o, d), BIG, *_t(pk, pi))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    hit = np.asarray(ij) >= 0
    # cornell2's triangles are its small yellow triangle and its light.
    assert hit.sum() > {"random700": b // 8, "conference4k": b // 2}.get(
        case, 0)
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(tj)[hit],
                               rtol=T_RTOL)
    assert (tt.numpy()[~hit] == BIG).all()
    tn, idn = tnv.closest_triangles(tt2, *_t(o, d), torch.full((b,), BIG),
                                    *_t(pk, pi))
    if not SCENES[case][1]:
        np.testing.assert_array_equal(it.numpy(), idn.numpy())
    else:
        # Tight budgets lose hits but never invent a closer one: t at or
        # beyond the oracle's, and the oracle's id wherever t is equal.
        assert (tt >= tn).all() and (it != idn).any()
        assert (it == idn)[tt == tn].all()

    pk2 = np.where(np.arange(b) % 4 == 0, C.PRIM_TRIANGLE, 0).astype(np.int32)
    pi2 = np.where(pk2 == C.PRIM_TRIANGLE, it.numpy(), -1).astype(np.int32)
    # About half the conference primaries' hits lie within the median.
    md = np.float32(np.median(tt.numpy()[hit]) if case == "conference4k"
                    else 1.5)
    aj = jbb.traverse_any(jg, jt2, *_j(o, d), md, *_j(pk2, pi2))
    at = tbb.traverse_any(tg, tt2, *_t(o, d), md, *_t(pk2, pi2))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.any() or case == "cornell2"


def test_scene_queries_match_jax():
    """intersect_scene_blocks and occluded_blocks on the cornell2 scene
    (planes, spheres and triangles) with a previous-primitive guard."""
    js, _ = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    ts, _ = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    jsb, tsb = jbb.build(js), tbb.build(ts, device="cpu")
    b = 256
    o, d = _rays(b, -1, 1, seed=4)
    pk = np.zeros(b, np.int32)
    pi = np.full(b, -1, np.int32)
    hj = jbb.intersect_scene_blocks(jsb, *_j(o, d, pk, pi))
    ht = tbb.intersect_scene_blocks(tsb, *_t(o, d, pk, pi))
    for f in ("prim_kind", "prim_id", "mat_id"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)), err_msg=f)
    hit = np.asarray(hj.prim_kind) != C.PRIM_NONE
    assert hit.sum() > b // 2
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=T_RTOL)
    hn = tnv.intersect_scene_naive(tsb, *_t(o, d, pk, pi))
    np.testing.assert_array_equal(ht.prim_id.numpy(), hn.prim_id.numpy())

    pk2, pi2 = np.asarray(hj.prim_kind), np.asarray(hj.prim_id)
    md = np.full(b, 1.2, np.float32)
    oj = jbb.occluded_blocks(jsb, *_j(o, d, md, pk2, pi2))
    ot = tbb.occluded_blocks(tsb, *_t(o, d, md, pk2, pi2))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    on = tnv.occluded_naive(tsb, *_t(o, d, md, pk2, pi2))
    np.testing.assert_array_equal(ot.numpy(), on.numpy())


def test_make_tracer_routes_block_bvh():
    """ACC_BVH on a block_bvh grid: make_tracer's queries are the module's
    own (the coherent flag changes nothing)."""
    ts, _ = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    tsb = tbb.build(ts, device="cpu")
    tracer = engine.make_tracer(TConfig(accelerator=C.ACC_BVH))
    o, d, pk, pi = _t(*_rays(64, -1, 1, seed=6), np.zeros(64, np.int32),
                      np.full(64, -1, np.int32))
    want = tbb.intersect_scene_blocks(tsb, o, d, pk, pi)
    for coherent in (False, True):
        got = tracer.closest(tsb, o, d, pk, pi, coherent=coherent)
        assert torch.equal(got.t, want.t)
        assert torch.equal(got.prim_id, want.prim_id)
        assert torch.equal(
            tracer.occluded(tsb, o, d, 1.0, pk, pi, coherent=coherent),
            tbb.occluded_blocks(tsb, o, d, 1.0, pk, pi))


@pytest.mark.parametrize("shader", [C.SHADER_WHITTED, C.SHADER_PATHTRACER])
def test_frame_matches_jax_renderer(shader):
    """The cornell2 32x32 frame (1 spp): the port's Renderer on a scene
    built by block_bvh.build (it builds only when the scene has no grid)
    against JAX's CPU Renderer with ACC_BVH, which builds block_bvh.  Rays
    exact; the image within the frames' tolerance (the PathTracer's
    1e-4 + 1e-3 |ref|, its Russian roulette boost)."""
    kw = dict(width=32, height=32, spp=1, shader=shader,
              accelerator=C.ACC_BVH, scene_id=C.SCENE_CORNELL2)
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    jr = jrend.Renderer(js, jc, JConfig(**kw))
    assert isinstance(jr.scene.bvh, jbb.BlockGrid)
    jimg = np.asarray(jr.render())
    ts, tc = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    tr = Renderer(tbb.build(ts, device="cpu"), tc, TConfig(**kw),
                  device="cpu")
    assert isinstance(tr.scene.bvh, tbb.BlockGrid)
    timg = np.asarray(tr.render())
    assert tr.total_rays == jr.total_rays > 32 * 32
    if shader == C.SHADER_PATHTRACER:
        assert_pt_frames_match(timg, jimg)
    else:
        assert_frames_match(timg, jimg)


def test_material_gradients_match_jax():
    """One differentiable material-gradient step (train_step_sharded at
    16x16, Whitted) over block_bvh.build against JAX's over its
    block_bvh.build: the loss within 1e-6 relative, the le, kd, ks and kt
    gradients within 1e-5 (relative, or of each one's largest entry), and
    ior where JAX's is finite (test_torch_diff_render.py) within the
    gradient tests' tolerance (test_torch_golden_grads.py)."""
    kw = dict(width=16, height=16, spp=1, scene_id=C.SCENE_CORNELL2,
              shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH)
    js, jc = jax_scene()
    ts, tc = port_twin(js, jc)
    jl, jg = jmesh.train_step_sharded(jbb.build(js), jc, JConfig(**kw),
                                      jax.random.PRNGKey(1),
                                      jnp.asarray(target()),
                                      jmesh.make_mesh(n_devices=1))
    tl, tg = tmesh.train_step_sharded(tbb.build(ts, device="cpu"), tc,
                                      TConfig(**kw), sampling.prng_key(1),
                                      torch.from_numpy(target()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tg) == set(jg)
    for k in jg:
        want, got = np.asarray(jg[k]), tg[k].numpy()
        assert np.isfinite(got).all(), k
        ok = np.isfinite(want)
        assert k == "ior" or ok.all(), k
        if k == "ior":
            assert_grads_close(got[ok], want[ok], k)
            continue
        # Entries differ by up to 7e-6 relative: XLA's CPU code contracts
        # FMAs in the shading the gradient runs through.
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)
    assert np.abs(tg["kd"].numpy()).max() > 0
