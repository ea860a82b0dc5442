"""The PathTracer of the PyTorch port against the JAX package: the NEE
guard's bucket closing on random states, and 32x32 frames on cornell and
cornell2.  1,024 lanes take the walker's compaction branch, here with
256-lane chunks in coherence order (direction octant, origin Morton code).

The JAX frames run over ACC_NAIVE (its block path in interpret mode takes
a minute a frame); the port renders each over ACC_NAIVE and over the block
BVH, whose traversal is exact, so both must give the JAX frame.  The
block path against the JAX package's own kernels is held by
test_torch_golden_shaders.py.

Morton cells and ulps: with nee_share_secondary the 128-lane NEE groups
follow the chunk order, so a lane whose origin fell into another Morton
cell in the port than in XLA (whose CPU code fuses `o + t d` into an FMA)
would give a whole group other light points, and many pixels would move
far beyond the tolerance.  At these sizes that does not happen: every
frame below holds with its ray count exact, and three bounces traced by
both packages from their own hit points, which differ by ulps on some
lanes, sort into the same coherence order
(test_coherence_order_of_jax_and_port_bounces_agree).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import sampling as jsampling
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import intersect as jintersect
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.shaders import engine as jengine
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import cameras, convert, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.ops import intersect
from mobileraytracer_tpu_torch.shaders import engine
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_render import arrays

torch.set_num_threads(2)

# PathTracer tolerance: the Russian roulette boost (4x per bounce past
# depth_min) drives pixels up to ~30, and float32 rounding that differs
# from XLA's fused arithmetic compounds along the path: the worst pixel
# measured differs by 1.6e-4 of its value.  A pixel holds when
# |port - jax| <= 1e-4 + 1e-3 |jax|, and at least 99.9% of pixels hold.
PT_ATOL = 1e-4
PT_RTOL = 1e-3
PT_FRACTION = 0.999


def assert_pt_frames_match(port_img, jax_img):
    port_img, jax_img = np.asarray(port_img), np.asarray(jax_img)
    assert np.isfinite(port_img).all()
    ok = (np.abs(port_img - jax_img)
          <= PT_ATOL + PT_RTOL * np.abs(jax_img)).all(-1)
    assert ok.mean() >= PT_FRACTION, np.abs(port_img - jax_img).max()


# ---------------------------------------------------------------------------
# The post-order guard's buckets.
# ---------------------------------------------------------------------------

def _random_buckets(seed, b=512, k=6):
    rng = np.random.default_rng(seed)
    return dict(
        rgb=rng.random((b, 3), np.float32),
        bkt_rgb=rng.random((b, k, 3), np.float32),
        bkt_ld=rng.random((b, k)) < 0.5,
        bkt_light=rng.random((b, k)) < 0.5,
        bkt_pspine=rng.random((b, k)) < 0.5,
        bkt_open=rng.random((b, k)) < 0.7,
    ), rng.integers(0, k + 1, b).astype(np.int32)


def _jax_state(f):
    b, k = f["bkt_ld"].shape
    z = jnp.zeros((b, 1), jnp.int32)
    return jengine.WalkState(
        sp=jnp.zeros((b,), jnp.int32), st_org=jnp.zeros((b, 1, 3)),
        st_dir=jnp.zeros((b, 1, 3)), st_weight=jnp.zeros((b, 1, 3)),
        st_depth=z, st_pkind=z, st_pid=z, st_flags=z, st_nb=z,
        rgb=jnp.asarray(f["rgb"]), rays=jnp.zeros((b,), jnp.int32),
        pops=jnp.zeros((b,), jnp.int32),
        **{n: jnp.asarray(v) for n, v in f.items() if n.startswith("bkt")})


def _torch_state(f):
    b, k = f["bkt_ld"].shape
    z = torch.zeros((b, 1), dtype=torch.int32)
    return engine.WalkState(
        sp=torch.zeros(b, dtype=torch.int32), st_org=torch.zeros(b, 1, 3),
        st_dir=torch.zeros(b, 1, 3), st_weight=torch.zeros(b, 1, 3),
        st_depth=z, st_pkind=z, st_pid=z, st_flags=z, st_nb=z,
        rgb=torch.from_numpy(f["rgb"].copy()),
        rays=torch.zeros(b, dtype=torch.int32),
        pops=torch.zeros(b, dtype=torch.int32),
        **{n: torch.from_numpy(v.copy()) for n, v in f.items()
           if n.startswith("bkt")})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_close_buckets_matches_jax(seed):
    f, maxnb = _random_buckets(seed)
    want = jengine._close_buckets(_jax_state(f), jnp.asarray(maxnb))
    st = _torch_state(f)
    before = {n: getattr(st, n).clone() for n in f}
    got = engine._close_buckets(st, torch.from_numpy(maxnb))
    for n in f:
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)), err_msg=n)
        # Out of place: the chunked walk scatters the result into the state
        # it was gathered from, so an input must never be written.
        assert torch.equal(getattr(st, n), before[n]), n
    # The cases the guard must see: kills, flows and spine propagation.
    k = f["bkt_ld"].shape[1]
    closing = f["bkt_open"] & (maxnb[:, None] <= np.arange(k)[None, :])
    assert (closing & f["bkt_ld"] & f["bkt_light"]).any()
    assert (closing & ~(f["bkt_ld"] & f["bkt_light"])).any()
    assert (closing[:, 1:] & f["bkt_light"][:, 1:]
            & f["bkt_pspine"][:, 1:]).any()


def test_force_close_empties_every_bucket():
    f, _ = _random_buckets(3)
    b = f["rgb"].shape[0]
    want = jengine._close_buckets(_jax_state(f), jnp.zeros(b, jnp.int32))
    got = engine._close_buckets(_torch_state(f),
                                torch.zeros(b, dtype=torch.int32))
    assert not got.bkt_open.any()
    assert not got.bkt_rgb[torch.from_numpy(f["bkt_open"])].any()
    for n in f:
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)), err_msg=n)


# ---------------------------------------------------------------------------
# Frames.
# ---------------------------------------------------------------------------

CASES = [
    # (scene, spp, nee_share, nee_share_secondary)
    (C.SCENE_CORNELL, 2, 128, True),
    (C.SCENE_CORNELL2, 1, 16, False),
    (C.SCENE_CORNELL2, 2, 128, True),
    (C.SCENE_CORNELL, 1, 16, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_pathtracer_frame_matches_jax(case):
    sid, spp, share, share2 = case
    kw = dict(width=32, height=32, spp=spp, shader=C.SHADER_PATHTRACER,
              accelerator=C.ACC_NAIVE, nee_share=share,
              nee_share_secondary=share2)
    js, jc = jscenes.load_builtin(sid, 1.0)
    jout = jrend.render_frame(js, jc, JConfig(**kw), jax.random.PRNGKey(0))
    jrays = int(jout["rays"])
    tc = convert.camera_from_arrays(arrays(jc))

    tout = trend.render_frame(convert.scene_from_arrays(arrays(js)), tc,
                              TConfig(**kw), sampling.prng_key(0))
    assert int(tout["rays"]) == jrays
    assert_pt_frames_match(tout["image"].numpy(), jout["image"])

    # The block BVH's traversal is exact: the same frame.
    bvh_cfg = TConfig(**dict(kw, accelerator=C.ACC_BVH))
    scene = convert.scene_from_arrays(arrays(jpb.build(js)))
    bout = trend.render_frame(scene, tc, bvh_cfg, sampling.prng_key(0))
    assert int(bout["rays"]) == jrays
    assert_pt_frames_match(bout["image"].numpy(), jout["image"])


def _coherence_order(points, dirs, live):
    b = points.shape[0]
    st = engine.WalkState(**{f.name: None
                             for f in dataclasses.fields(engine.WalkState)})
    st = dataclasses.replace(st, sp=torch.ones(b, dtype=torch.int32),
                             st_org=points[:, None], st_dir=dirs[:, None])
    return engine._coherence_order(st, live)


def test_coherence_order_of_jax_and_port_bounces_agree():
    """Three diffuse bounces of the 32x32 cornell primaries, traced by the
    JAX package (jitted, so XLA fuses as in a frame) and by the port from
    their own hit points: the hit points differ by ulps on some lanes, and
    the coherence order of every bounce is the same all the same."""
    cfg = TConfig(width=32, height=32)
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL, 1.0)
    ts = convert.scene_from_arrays(arrays(js))
    tc = convert.camera_from_arrays(arrays(jc))
    u, v, pids, _ = trend._pixel_order(cfg, "cpu")
    zero = torch.zeros_like(u)
    o, d = cameras.generate_rays(tc, u, v, zero, zero)
    b = o.shape[0]
    keys = sampling.ray_key(sampling.prng_key(0), pids, 0)
    jkeys = jsampling.ray_key(jax.random.PRNGKey(0), jnp.asarray(pids.numpy()),
                              0)
    jclosest = jax.jit(jintersect.intersect_scene_naive)
    jhemi = jax.jit(jsampling.cosine_sample_hemisphere)
    t_ray = (o, d, torch.zeros(b, dtype=torch.int32),
             torch.full((b,), -1, dtype=torch.int32))
    j_ray = tuple(jnp.asarray(a.numpy()) for a in t_ray)
    live = torch.ones(b, dtype=torch.bool)
    moved = 0
    for bounce in range(3):
        th = intersect.intersect_scene_naive(ts, *t_ray)
        jh = jclosest(js, *j_ray)
        np.testing.assert_array_equal(th.missed.numpy(), np.asarray(jh.missed))
        live = live & ~th.missed
        tdir = sampling.cosine_sample_hemisphere(
            sampling.event_key(keys, bounce, 3), th.normal)
        jdir = jhemi(jsampling.event_key(jkeys, bounce, 3), jh.normal)
        jp = torch.from_numpy(np.array(jh.point))
        moved += int(((jp != th.point).any(1) & live).sum())
        assert torch.equal(
            _coherence_order(th.point, tdir, live),
            _coherence_order(jp, torch.from_numpy(np.array(jdir)), live))
        t_ray = (th.point, tdir, th.prim_kind, th.prim_id)
        j_ray = (jh.point, jdir, jh.prim_kind, jh.prim_id)
    assert moved > 0
