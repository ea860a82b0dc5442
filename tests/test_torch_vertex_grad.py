"""Vertex gradients of the PyTorch port (diff/geom.py) against the JAX
package on the CPU: the factor-space helpers, edge_topology, the
Gumbel-max draw of jax.random.categorical, and vertex_grad on the
one-triangle scene and on cornell2; then the port's chunked interior and
its own central differences.

Tolerances: the factor map is solved by Cramer's rule here and by LU in
JAX, so factor coordinates, densities and Jacobians agree to 2e-6
relative (a few float32 ulps), rays to 1e-6; edge masks, viewport masks
and draws are equal bit for bit; losses within rtol 1e-5 and gradients
within rtol 1e-3 or 1e-5 * max |g| (test_torch_golden_grads.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.builder import SceneBuilder
from mobileraytracer_tpu.diff import geom as jgeom
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu.types import orthographic_camera as jortho
from mobileraytracer_tpu.types import perspective_camera as jpersp
from mobileraytracer_tpu_torch import bench_scenes as tbs
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import convert, sampling, threefry
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.diff import geom as tgeom
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_golden_grads import LOSS_RTOL, assert_grads_close
from test_torch_render import arrays

torch.set_num_threads(2)

KD = (0.6, 0.3, 0.9)
V0 = np.array([-0.4, -0.3, 0.0], np.float32)
V1 = np.array([0.5, -0.2, 0.0], np.float32)
V2 = np.array([0.0, 0.45, 0.0], np.float32)
FACTOR_RTOL = 2e-6
CAMERAS = {
    "perspective": lambda: jpersp((0.3, 0.2, -3.0), (0, 0, 1), (0, 1, 0),
                                  45.0, 40.0),
    "orthographic": lambda: jortho((0.3, 0.2, -3.0), (0, 0, 1), (0, 1, 0),
                                   2.0, 1.5),
}


def one_triangle():
    b = SceneBuilder()
    b.add_triangle(V0, V1, V2, b.add_material(kd=KD))
    js = jax.device_put(b.build())
    jc = jpersp((0, 0, -3.0), (0, 0, 1), (0, 1, 0), 45.0, 45.0)
    return js, jc


def twin(js, jc):
    return convert.scene_from_arrays(arrays(js)), \
        convert.camera_from_arrays(arrays(jc))


def assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_factor_space_helpers_match_jax(kind):
    jc = CAMERAS[kind]()
    tc = convert.camera_from_arrays(arrays(jc))
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32)
    x[:, 2] = rng.uniform(-1.0, 2.0, 512)
    cfg = dict(width=32, height=24)
    jq = np.asarray(jgeom.factors_of_point(jc, jnp.asarray(x)))
    tq = tgeom.factors_of_point(tc, torch.from_numpy(x))
    assert_rel(tq.numpy(), jq, FACTOR_RTOL)
    q = torch.from_numpy(jq.copy())
    for j, t in zip(jgeom.rays_from_factors(jc, jnp.asarray(jq)),
                    tgeom.rays_from_factors(tc, q)):
        assert_rel(t.numpy(), np.asarray(j), 1e-6)
    assert_rel(tgeom.pixel_density(tc, q).numpy(),
               np.asarray(jgeom.pixel_density(jc, jnp.asarray(jq))),
               FACTOR_RTOL)
    jm = np.asarray(jgeom.viewport_mask(jc, JConfig(**cfg), jnp.asarray(jq)))
    tm = tgeom.viewport_mask(tc, TConfig(**cfg), q).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert 0 < jm.sum() < jm.size
    jj = np.asarray(jax.vmap(jax.jacrev(
        lambda p: jgeom.factors_of_point(jc, p)))(jnp.asarray(x[:64])))
    tj = torch.func.vmap(torch.func.jacrev(
        lambda p: tgeom.factors_of_point(tc, p)))(torch.from_numpy(x[:64]))
    assert_rel(tj.numpy(), jj, FACTOR_RTOL)


def test_vertices_and_edge_topology_match_jax():
    """triangle_vertices, scene_with_vertices and edge_topology on cornell2,
    a flat quad (its diagonal culled) and the 20,000-triangle conference
    proxy, built by each package's own builder."""
    js, _ = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    js = jax.device_put(js)
    ts, _ = twin(js, jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)[1])
    jv = jgeom.triangle_vertices(js.triangles)
    tv = tgeom.triangle_vertices(ts.triangles)
    for k in jv:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
    rng = np.random.default_rng(3)
    moved = {k: v + torch.from_numpy(rng.uniform(
        -0.05, 0.05, tuple(v.shape)).astype(np.float32))
        for k, v in tv.items()}
    jt = jgeom.scene_with_vertices(
        js, {k: jnp.asarray(v.numpy()) for k, v in moved.items()}).triangles
    tt = tgeom.scene_with_vertices(ts, moved).triangles
    for f in ("point_a", "ab", "ac"):
        assert_rel(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), 1e-6)
    # Unit normals: the cross product of the small random padded rows
    # cancels, where XLA's fused multiply-adds round differently.
    for f in ("normal_a", "normal_c"):
        assert_rel(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), 1e-5)

    b = SceneBuilder()
    m = b.add_material(kd=KD)
    b.add_triangle([-1, -1, 0], [1, -1, 0], [1, 1, 0], m)
    b.add_triangle([-1, -1, 0], [1, 1, 0], [-1, 1, 0], m)
    quad = b.build()
    jsc, _, _ = jbs.conference_proxy(target_prims=20000)
    tsc, _, _ = tbs.conference_proxy(target_prims=20000)
    for jtri, ttri in ((js.triangles, ts.triangles),
                       (quad.triangles, twin(quad, CAMERAS["perspective"]())[
                           0].triangles),
                       (jsc.triangles, tsc.triangles)):
        want = jgeom.edge_topology(jtri)
        got = tgeom.edge_topology(ttri)
        np.testing.assert_array_equal(got, want)
    assert tgeom.edge_topology(twin(quad, CAMERAS["perspective"]())[
        0].triangles).sum() == 4


@pytest.mark.parametrize("e, k, block", [(37, 64, 1 << 24),
                                         (5000, 300, 4096),
                                         (1, 5, 1 << 24)])
def test_gumbel_max_draw_matches_jax(e, k, block):
    """threefry.categorical equals jax.random.categorical(key, logits,
    shape=(k,)) bit for bit; block 4096 streams 300 rows of 5,000 logits
    in column blocks with a running argmax."""
    rng = np.random.default_rng(e)
    logits = np.log(rng.uniform(1e-3, 2.0, e)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0x5ED6E)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                             shape=(k,)))
    tkey = sampling.fold_in(sampling.prng_key(3), 0x5ED6E)
    got = threefry.categorical(tkey, torch.from_numpy(logits), k,
                               block=block).numpy()
    np.testing.assert_array_equal(got, want)


def test_xla_log_and_high_counter_words_match_jax():
    """The draw's pieces: XLA's CPU log bit for bit on normal floats, and
    the random words at flat indices past 2^32 (count words (hi, lo))."""
    from jax._src import prng as jprng
    rng = np.random.default_rng(2)
    x = rng.integers(0x00800000, 0x7F800000, 200000).astype(
        np.int32).view(np.float32)
    np.testing.assert_array_equal(
        threefry.xla_log(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jnp.log)(x)))
    idx = np.array([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 33 + 7],
                   np.uint64)
    key = jax.random.PRNGKey(9)
    b1, b2 = jprng.threefry2x32_p.bind(
        key[0], key[1], jnp.asarray((idx >> 32).astype(np.uint32)),
        jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32)))
    want = np.asarray(b1 ^ b2).astype(np.int64)
    tk = sampling.prng_key(9)
    got = threefry.bits_at(tk[0], tk[1],
                           torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def assert_vertex_grads_match(js, jc, kw, vkw, key=3):
    jl, jg = jgeom.vertex_grad(js, jc, JConfig(**kw), jax.random.PRNGKey(key),
                               **vkw)
    ts, tc = twin(js, jc)
    tl, tg = tgeom.vertex_grad(ts, tc, TConfig(**kw), sampling.prng_key(key),
                               **vkw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in jg:
        assert_grads_close(tg[k].numpy(), jg[k], k)
    return tl, tg


def test_vertex_grad_matches_jax_one_triangle():
    """DiffuseMaterial's flat colour: the whole gradient is the silhouette
    term, every edge enumerated."""
    js, jc = one_triangle()
    kw = dict(width=32, height=32, spp=1, shader=C.SHADER_DIFFUSE,
              accelerator=C.ACC_NAIVE)
    _, g = assert_vertex_grads_match(js, jc, kw, dict(edge_samples=8,
                                                      edge_eps=5e-4))
    assert float(g["va"].abs().max()) > 1e-3


def test_vertex_grad_matches_jax_cornell2():
    """Whitted on cornell2 at 32x32: the interior term, every kept edge
    enumerated for the silhouette term, and the shadow term over 64 edge
    draws (the golden file holds the edge_budget draws)."""
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    js = jax.device_put(js)
    kw = dict(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
              accelerator=C.ACC_NAIVE, scene_id=C.SCENE_CORNELL2)
    vkw = dict(edge_samples=4, edge_keep=jgeom.edge_topology(js.triangles),
               shadow_edges=True, shadow_budget=64)
    _, g = assert_vertex_grads_match(js, jc, kw, vkw)
    assert float(g["va"].abs().max()) > 1e-4


def test_pixel_chunk_matches_unchunked():
    """The interior in chunks of 256 lanes sums to the one-pass gradient up
    to float32 summation order."""
    ts, tc = twin(*jscenes.load_builtin(C.SCENE_CORNELL2, 1.0))
    cfg = TConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                  accelerator=C.ACC_NAIVE, scene_id=C.SCENE_CORNELL2)
    l1, g1 = tgeom.vertex_grad(ts, tc, cfg, sampling.prng_key(4),
                               edge_samples=2)
    l2, g2 = tgeom.vertex_grad(ts, tc, cfg, sampling.prng_key(4),
                               edge_samples=2, pixel_chunk=300)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g1[k].abs().max()))


def test_vertex_grad_matches_central_differences():
    """The port's edge-sampled d loss / d v0.x against central differences
    of its own jitter-averaged DiffuseMaterial renders (the image mean is
    the area integral in expectation), as the JAX package's
    test_vertex_grad.py checks its own."""
    ts, tc = twin(*one_triangle())
    cfg = TConfig(width=64, height=64, spp=4, shader=C.SHADER_DIFFUSE,
                  accelerator=C.ACC_NAIVE)
    _, g = tgeom.vertex_grad(ts, tc, cfg, sampling.prng_key(0),
                             edge_samples=32, edge_eps=5e-4)
    ad = float(g["va"][0, 0])
    verts = tgeom.triangle_vertices(ts.triangles)

    def mean_img(dx, key):
        va = verts["va"].clone()
        va[0, 0] += dx
        s2 = tgeom.scene_with_vertices(ts, dict(verts, va=va))
        return float(trend.render_frame(s2, tc, cfg, key)["image"].mean())

    eps = 2e-2
    keys = [sampling.prng_key(100 + i) for i in range(48)]
    fd = (np.mean([mean_img(eps, k) for k in keys])
          - np.mean([mean_img(-eps, k) for k in keys])) / (2 * eps)
    assert abs(ad - fd) < max(0.12 * abs(fd), 2e-3), (ad, fd)
    assert abs(fd) > 1e-2


def test_sharded_vertex_grad_names_roadmap_item():
    ts, tc = twin(*one_triangle())
    cfg = TConfig(width=16, height=16, shader=C.SHADER_DIFFUSE)
    with pytest.raises(NotImplementedError, match="item 14"):
        tgeom.vertex_grad(ts, tc, cfg, sampling.prng_key(0), mesh=object())
