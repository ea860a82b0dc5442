"""The PyTorch port's sharded forms over torch.distributed (gloo, CPU)
against its one-device forms and against the JAX package's sharded
functions on `make_mesh(n_devices=n)` of the 8-device CPU mesh.

One module fixture starts a 2-rank and a 4-rank job at once
(tests/torch_mesh_worker.py, one process per rank, which imports no jax;
a `file://` rendezvous in the test's temporary directory); each job runs
every case once and each rank saves what it returned.  The JAX references
compute meanwhile.

Tolerances: sharded frames equal the one-device frames bit for bit (image,
bitmap and rays) and JAX's within 1e-4 on 99.9% of pixels, rays exact;
int_parity bitmaps equal JAX's on 99.5% of pixels (a float32 ulp of its
FMA-contracted shading crosses a 1/255 step, test_torch_film_samplers.py).
Losses within rtol 1e-5; gradients within rtol 1e-3 or 1e-5 * max |g|
(test_torch_golden_grads.py's), both against JAX and against the port's
one-device step (the shards' sums are added in another order).  Recovered
parameters within rtol 1e-4 or atol 1e-6 of JAX's (test_torch_recover.py's
Adam rounding), and bitwise equal across ranks.  The cornell2 vertex
gradient draws 8 samples an edge so that each rank's share of the 192
silhouette probes is a multiple of nee_share (16), the condition under
which sharding leaves the NEE groups, and so the result, unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.builder import SceneBuilder as JBuilder
from mobileraytracer_tpu.diff import geom as jgeom
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.parallel import mesh as jmesh
from mobileraytracer_tpu.parallel import recover as jrec
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu.types import perspective_camera as jpersp
from mobileraytracer_tpu_torch import renderer, sampling
from mobileraytracer_tpu_torch.diff import geom
from mobileraytracer_tpu_torch.parallel import mesh as pmesh
from mobileraytracer_tpu_torch.parallel import recover
from mobileraytracer_tpu_torch.types import RenderConfig
from test_torch_golden_grads import LOSS_RTOL, assert_grads_close
from test_torch_render import assert_frames_match
import torch_mesh_worker as W

torch.set_num_threads(2)

WORLDS = (2, 4)
TIMEOUT_S = 600
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Starts both jobs; returns result(n), the n-rank job's per-rank
    results, waited for on first use."""
    root = tmp_path_factory.mktemp("torch_mesh")
    started = {}
    for n in WORLDS:
        (root / f"world{n}").mkdir()
        started[n] = W.start(n, root / f"world{n}")
    done = {}

    def result(n):
        if n not in done:
            done[n] = W.finish(started[n], root / f"world{n}", TIMEOUT_S)
        return done[n]
    yield result
    for procs in started.values():
        W.stop(procs)


def ranks(jobs, n, case):
    return [r[case] for r in jobs(n)]


def jax_cornell2(acc_bvh=False, le0=False):
    js, jc = jscenes.load_builtin(W.C.SCENE_CORNELL2, 1.0)
    js = jax.device_put(js)
    if le0:
        le = jnp.asarray(js.materials.le).at[0].set(jnp.asarray(W.LE0))
        js = js.replace(materials=js.materials.replace(le=le))
    return (jpb.build(js) if acc_bvh else js), jc


def assert_same_frame(got, want):
    assert torch.equal(got["bitmap"], want["bitmap"])
    assert int(got["rays"]) == int(want["rays"])
    assert torch.equal(got["image"], want["image"])


def assert_grads_match(got, want, names):
    """got, want: dicts with "loss" and the gradients in `names`; entries
    where want is not finite (JAX's ior, test_torch_diff_render.py) are
    left out."""
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    for k in names:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.isfinite(g).all(), k
        ok = np.isfinite(w)
        assert_grads_close(g[ok], w[ok], k)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_frame_equals_one_device_and_jax(jobs, n):
    """The cornell2 32x32 Whitted block-BVH frame at 2 spp sharded over n
    ranks: every rank returns the one-device frame bit for bit, and JAX's
    render_frame_sharded at the same n within tolerance."""
    js, jc = jax_cornell2(acc_bvh=True)
    jout = jmesh.render_frame_sharded(js, jc, JConfig(**W.FRAME_KW),
                                      jax.random.PRNGKey(0),
                                      jmesh.make_mesh(n_devices=n))
    s, c = W.frame_scene()
    one = renderer.render_frame(s, c, RenderConfig(**W.FRAME_KW),
                                sampling.prng_key(0))
    for got in ranks(jobs, n, "frame"):
        assert_same_frame(got, one)
        assert int(got["rays"]) == int(jout["rays"])
        assert_frames_match(got["image"].numpy(), np.asarray(jout["image"]))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_int_parity_frame(jobs, n):
    """int_parity accumulation on cornell at 3 spp (ACC_NAIVE): the
    one-device bitmap bit for bit, and JAX's sharded one."""
    kw = W.PARITY_KW
    js, jc = jscenes.load_builtin(W.C.SCENE_CORNELL, 1.0)
    jout = jmesh.render_frame_sharded(js, jc, JConfig(**kw),
                                      jax.random.PRNGKey(0),
                                      jmesh.make_mesh(n_devices=n))
    s, c = W.parity_scene()
    one = renderer.render_frame(s, c, RenderConfig(**kw),
                                sampling.prng_key(0))
    for got in ranks(jobs, n, "parity"):
        assert_same_frame(got, one)
        assert int(got["rays"]) == int(jout["rays"])
        same = got["bitmap"].numpy() == np.asarray(jout["bitmap"])
        assert same.mean() >= 0.995, same.mean()


def test_subset_mesh(jobs):
    """make_mesh(n_devices=2) in a 4-rank job: ranks 0 and 1 render the
    one-device frame, ranks 2 and 3 are outside the mesh."""
    s, c = W.frame_scene()
    one = renderer.render_frame(s, c, RenderConfig(**W.FRAME_KW),
                                sampling.prng_key(0))
    got = ranks(jobs, 4, "subset")
    for r in got[:2]:
        assert_same_frame(r, one)
    assert all(bool(r["outside"]) for r in got[2:])


@pytest.mark.parametrize("n", WORLDS)
def test_2d_mesh_equals_1d(jobs, n):
    """make_mesh_2d(n_hosts=2): (2, 1) on 2 ranks, 2 x 2 on 4; the frame
    equals the 1-D frame of the same job bit for bit."""
    for got, flat in zip(ranks(jobs, n, "mesh2d"), ranks(jobs, n, "frame")):
        assert_same_frame(got, flat)


@pytest.mark.parametrize("n", WORLDS)
def test_train_step_sharded(jobs, n):
    """train_step_sharded at 16x16 on cornell2 (material 0 emissive): the
    loss and the five gradients of JAX's at the same n and of the port's
    one-device step, the same on every rank."""
    js, jc = jax_cornell2(le0=True)
    jl, jg = jmesh.train_step_sharded(js, jc, JConfig(**W.TRAIN_KW),
                                      jax.random.PRNGKey(1),
                                      jnp.asarray(W.train_target()),
                                      jmesh.make_mesh(n_devices=n))
    s, c = W.train_scene()
    tl, tg = pmesh.train_step_sharded(s, c, RenderConfig(**W.TRAIN_KW),
                                      sampling.prng_key(1),
                                      torch.from_numpy(W.train_target()))
    names = ("le", "kd", "ks", "kt", "ior")
    got = ranks(jobs, n, "train")
    for r in got:
        assert_grads_match(r, dict(jg, loss=jl), names)
        assert_grads_match(r, dict(tg, loss=tl), names)
        assert all(torch.equal(r[k], got[0][k]) for k in r)
    assert np.abs(got[0]["kd"].numpy()).max() > 0
    assert np.abs(got[0]["le"].numpy()).max() > 0


@pytest.mark.parametrize("n", WORLDS)
def test_recovery_over_the_mesh(jobs, n, tmp_path):
    """Three recover_materials steps (kd from 0.5) with a checkpoint at
    step 2, then a run resumed from it: the losses and kd of JAX's run on
    make_mesh(n) and of the port's one-device run; kd bitwise equal on
    every rank and in the resumed run.  A state perturbed on rank 1 is
    found by the digest and replaced by the first rank's."""
    s, c = W.train_scene()
    target = W.train_target()
    p1, l1 = recover.recover_materials(
        s, c, RenderConfig(**W.TRAIN_KW), torch.from_numpy(target),
        **W.recover_kw(s, tmp_path / "one.npz"))
    js, jc = jax_cornell2(le0=True)
    kw = W.recover_kw(s, tmp_path / "jax.npz")
    jp, jl = jrec.recover_materials(
        js, jc, JConfig(**W.TRAIN_KW), jnp.asarray(target),
        jmesh.make_mesh(n_devices=n), steps=kw["steps"],
        params_subset=kw["params_subset"], learning_rate=kw["learning_rate"],
        base_key=jax.random.PRNGKey(5),
        init_params={"kd": jnp.asarray(kw["init_params"]["kd"].numpy())})
    got = ranks(jobs, n, "recover")
    for r in got:
        assert len(r["losses"]) == kw["steps"]
        for want_l, want_kd in ((jl, jp["kd"]), (l1, p1["kd"])):
            np.testing.assert_allclose(r["losses"].numpy(), want_l,
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(r["kd"].numpy(), np.asarray(want_kd),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
        assert torch.equal(r["kd"], got[0]["kd"])
        assert torch.equal(r["kd_resumed"], r["kd"])
        assert torch.equal(r["losses_resumed"], r["losses"])
        assert not bool(r["agreed_before"])
        assert torch.equal(r["kd_repaired"], got[0]["kd_repaired"])
    assert torch.equal(got[0]["kd_repaired"], got[0]["kd"])


@pytest.mark.parametrize("n", WORLDS)
def test_vertex_grad_one_triangle(jobs, n):
    """vertex_grad(mesh=) with DiffuseMaterial at 16x16, every edge
    enumerated: JAX's vertex_grad(mesh=make_mesh(n)) and the port's
    one-device call."""
    b = JBuilder()
    b.add_triangle(*(np.asarray(v, np.float32) for v in W.TRI),
                   b.add_material(kd=W.KD))
    js = jax.device_put(b.build())
    jc = jpersp((0, 0, -3.0), (0, 0, 1), (0, 1, 0), 45.0, 45.0)
    # Under jit: eager, JAX's shard_map of the differentiable walk takes
    # about 2 minutes here.
    m = jmesh.make_mesh(n_devices=n)
    jl, jg = jax.jit(lambda s, k: jgeom.vertex_grad(
        s, jc, JConfig(**W.TRI_KW), k, mesh=m, **W.TRI_VKW))(
            js, jax.random.PRNGKey(3))
    s, c = W.triangle_scene()
    tl, tg = geom.vertex_grad(s, c, RenderConfig(**W.TRI_KW),
                              sampling.prng_key(3), **W.TRI_VKW)
    for r in ranks(jobs, n, "vgrad_tri"):
        assert_grads_match(r, dict(jg, loss=jl), jg)
        assert_grads_match(r, dict(tg, loss=tl), tg)
    assert float(r["va"].abs().max()) > 1e-3


@pytest.mark.parametrize("n", WORLDS)
def test_vertex_grad_pixel_chunk(jobs, n):
    """vertex_grad(mesh=, pixel_chunk=128) on cornell2 at 16x16 (two chunks,
    each sharded) with the shadow term over 32 edge draws: JAX's
    vertex_grad(mesh=make_mesh(n), pixel_chunk=128) and the port's
    one-device call."""
    js, jc = jax_cornell2(le0=True)
    jl, jg = jgeom.vertex_grad(
        js, jc, JConfig(**W.TRAIN_KW), jax.random.PRNGKey(3),
        mesh=jmesh.make_mesh(n_devices=n),
        edge_keep=jgeom.edge_topology(js.triangles), **W.CHUNK_VKW)
    s, c = W.train_scene()
    tl, tg = geom.vertex_grad(s, c, RenderConfig(**W.TRAIN_KW),
                              sampling.prng_key(3), **W.chunk_kw(s))
    for r in ranks(jobs, n, "vgrad_chunk"):
        assert_grads_match(r, dict(jg, loss=jl), jg)
        assert_grads_match(r, dict(tg, loss=tl), tg)
    assert float(r["va"].abs().max()) > 1e-4
