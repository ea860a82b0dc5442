"""Differentiable rendering of the PyTorch port against the JAX package on
the CPU: material gradients of `render_loss_fn` through
`train_step_sharded` (the port's mesh=None against JAX's one-device
mesh), the differentiable walk's image and ray count, and the two
accelerators that reverse mode rejects.

Scene: cornell2 at 16x16 with material 0 (the yellow triangle) made
emissive so that le has a gradient; the target image comes from numpy
(seed 0).  Tolerances: loss rtol 1e-5; a gradient entry within rtol 1e-3
or 1e-5 * max |g| (test_torch_golden_grads.py's).

The JAX package's ior gradient holds NaN entries that the port's does
not.  They come from glm::refract's sqrt(where(k >= 0, k, 1)) at k == 0
(JAX shaders/common.py:81), whose infinite derivative times a masked
lane's zero cotangent is NaN: on lanes that are dead (parked rays, stale
zero directions) in steps the port runs too, and, for Whitted, in the
steps after every lane drained, which the port does not run.  The port
takes sqrt(k) as 0 at k == 0 with a zero derivative, so its gradient is
finite there; every entry where JAX's is finite is compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import bvh as jbvh
from mobileraytracer_tpu.ops import grid as jgrid
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.parallel import mesh as jmesh
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import convert, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.ops import bvh as tbvh
from mobileraytracer_tpu_torch.ops import grid as tgrid
from mobileraytracer_tpu_torch.ops import kernels
from mobileraytracer_tpu_torch.parallel import mesh as tmesh
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_golden_grads import LE0, LOSS_RTOL, assert_grads_close
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)

SIZE = 16
CASES = {
    "whitted-naive": dict(shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE),
    "pathtracer-naive": dict(shader=C.SHADER_PATHTRACER,
                             accelerator=C.ACC_NAIVE),
    "whitted-bvh": dict(shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH),
}


def jax_scene(acc=C.ACC_NAIVE):
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    js = jax.device_put(js)
    le = jnp.asarray(js.materials.le).at[0].set(jnp.asarray(LE0))
    js = js.replace(materials=js.materials.replace(le=le))
    return (jpb.build(js) if acc == C.ACC_BVH else js), jc


def port_twin(js, jc):
    return convert.scene_from_arrays(arrays(js)), \
        convert.camera_from_arrays(arrays(jc))


def target():
    return np.random.default_rng(0).uniform(
        0.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32)


def config_kw(**kw):
    return dict(width=SIZE, height=SIZE, spp=1, scene_id=C.SCENE_CORNELL2,
                **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_material_gradients_match_jax(case):
    """train_step_sharded(mesh=None) against JAX's on make_mesh(1): the
    loss and the gradients of le, kd, ks, kt and ior."""
    kw = config_kw(**CASES[case])
    js, jc = jax_scene(kw["accelerator"])
    jl, jg = jmesh.train_step_sharded(js, jc, JConfig(**kw),
                                      jax.random.PRNGKey(1),
                                      jnp.asarray(target()),
                                      jmesh.make_mesh(n_devices=1))
    ts, tc = port_twin(js, jc)
    kernels.reset_launches()
    tl, tg = tmesh.train_step_sharded(ts, tc, TConfig(**kw),
                                      sampling.prng_key(1),
                                      torch.from_numpy(target()))
    assert not any(kernels.LAUNCHES.values())      # CPU: plain versions
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert set(tg) == set(jg) == {"le", "kd", "ks", "kt", "ior"}
    for k in jg:
        want, got = np.asarray(jg[k]), tg[k].numpy()
        assert np.isfinite(got).all(), k
        ok = np.isfinite(want)
        assert k == "ior" or ok.all(), k
        assert_grads_close(got[ok], want[ok], f"{case} {k}")
    assert np.abs(tg["kd"].numpy()).max() > 0
    assert np.abs(tg["le"].numpy()).max() > 0


def test_differentiable_walk_matches_jax():
    """render_sample(differentiable=True): the image and the ray count of
    JAX's differentiable walk; the same image as the port's plain walk;
    and on autograd's tape of the material table."""
    kw = config_kw(shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE)
    js, jc = jax_scene()
    jrgb, jrays = jrend.render_sample(js, jc, JConfig(**kw),
                                      jax.random.PRNGKey(2), 0,
                                      differentiable=True)
    ts, tc = port_twin(js, jc)
    kd = ts.materials.kd.clone().requires_grad_(True)
    ts = ts.replace(materials=ts.materials.replace(kd=kd))
    rgb, rays = trend.render_sample(ts, tc, TConfig(**kw),
                                    sampling.prng_key(2), 0,
                                    differentiable=True)
    assert rgb.requires_grad
    assert int(rays) == int(jrays)
    assert_frames_match(rgb.detach().numpy(), np.asarray(jrgb))
    plain, plain_rays = trend.render_sample(ts, tc, TConfig(**kw),
                                            sampling.prng_key(2), 0)
    assert torch.equal(plain, rgb.detach()) and int(plain_rays) == int(rays)


@pytest.mark.parametrize("acc", ["grid", "escape"])
def test_reverse_mode_rejects_grid_and_escape_walk(acc):
    """The grid DDA and the escape-index walk are lax.while_loops in the
    JAX package, which reverse mode rejects; the port raises on the same
    call."""
    jbuild, tbuild, acc_id = {
        "grid": (jgrid.build_grid, lambda s: tgrid.build_grid(
            s, device="cpu"), C.ACC_REGULAR_GRID),
        "escape": (jbvh.build, lambda s: tbvh.build(s, device="cpu"),
                   C.ACC_BVH)}[acc]
    kw = config_kw(shader=C.SHADER_WHITTED, accelerator=acc_id)
    js, jc = jax_scene()
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jmesh.train_step_sharded(jbuild(js), jc, JConfig(**kw),
                                 jax.random.PRNGKey(1),
                                 jnp.asarray(target()),
                                 jmesh.make_mesh(n_devices=1))
    ts, tc = port_twin(js, jc)
    with pytest.raises(ValueError, match="reverse mode rejects"):
        tmesh.train_step_sharded(tbuild(ts), tc, TConfig(**kw),
                                 sampling.prng_key(1),
                                 torch.from_numpy(target()))


def test_naive_scan_gradient_goes_to_the_winner():
    """The naive triangle scan over 2,000 rows (four chunks of 512, the
    last clamped so that it overlaps the third) sends d t / d vertices to
    each ray's single winner, as JAX's argmin + take_along_axis does: the
    gradients of the summed hit distances agree."""
    from mobileraytracer_tpu import bench_scenes as jbs
    from mobileraytracer_tpu.ops import intersect as jnv
    from mobileraytracer_tpu_torch.ops import intersect as tnv
    js, jc, _ = jbs.conference_proxy(target_prims=2000)
    tris = jax.device_put(js.triangles)
    rng = np.random.default_rng(4)
    o = np.broadcast_to(np.asarray(jc.position), (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pk = np.zeros(256, np.int32)
    pi = np.full(256, -1, np.int32)

    def jloss(pa, ab, ac):
        t, tid = jnv.closest_triangles(tris.replace(point_a=pa, ab=ab, ac=ac),
                                       o, d, 1e30, pk, pi)
        return jnp.sum(jnp.where(tid >= 0, t, 0.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(tris.point_a, tris.ab, tris.ac)
    tt = convert.scene_from_arrays(arrays(js)).triangles
    leaves = [x.clone().requires_grad_(True) for x in (tt.point_a, tt.ab,
                                                         tt.ac)]
    t, tid = tnv.closest_triangles(
        tt.replace(point_a=leaves[0], ab=leaves[1], ac=leaves[2]),
        torch.from_numpy(o.copy()), torch.from_numpy(d),
        torch.full((256,), 1e30), torch.from_numpy(pk), torch.from_numpy(pi))
    assert int((tid >= 0).sum()) > 64
    torch.where(tid >= 0, t, 0.0).sum().backward()
    for leaf, want in zip(leaves, jg):
        assert_grads_close(leaf.grad.numpy(), np.asarray(want))
        # Only winners carry a gradient.
        rows = set(np.nonzero(np.abs(leaf.grad.numpy()).sum(1))[0])
        assert rows <= set(tid[tid >= 0].tolist())
