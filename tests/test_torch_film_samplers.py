"""The port's film, Halton sequence and eight pixel samplers against the
JAX package: integer bitmaps, draws and quantized bitmaps bit for bit, and
whole frames with each sampler.

JAX draws are taken under `jax.jit`, as render_frame takes them: XLA
compiles a division by a constant into a product with its reciprocal, so
the eager and the jitted JAX draws of "stratified" differ in the last bit,
and the port follows the jitted ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import film as jfilm
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import samplers as jsamplers
from mobileraytracer_tpu import sampling as jsampling
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import film, samplers, sampling, scenes
from mobileraytracer_tpu_torch.renderer import render_frame
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)

# Samples below 0, above 1 (the PathTracer reaches ~30), at multiples of
# 1/255, and NaN, infinities and values past 2^32 / 255.
EDGE = np.asarray(
    [-0.5, -1e-3, -0.0, 0.0, 1.0 / 255, 2.0 / 255, 3.0 / 255, 127.0 / 255,
     254.0 / 255, 1.0, 1.0 + 1e-7, 1.5, 7.3, 30.0, 255.0, 1e7, 2e7, 1e10,
     np.nan, np.inf, -np.inf], np.float32)


def _edge_rgb():
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(EDGE, EDGE, EDGE[::3], indexing="ij"),
                    -1).reshape(-1, 3)
    rand = rng.uniform(-0.2, 31.0, (4096, 3)).astype(np.float32)
    mult = (rng.integers(0, 256, (1024, 3)) / np.float32(255.0)).astype(
        np.float32)
    return np.concatenate([grid, rand, mult]).astype(np.float32)


def test_quantize_abgr_bitwise():
    rgb = _edge_rgb()
    want = np.asarray(jfilm.quantize_abgr(jnp.asarray(rgb)))
    got = film.quantize_abgr(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)
    back = film.unpack_abgr(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back,
                                  np.asarray(jfilm.unpack_abgr(want)))


def test_incremental_avg_int_bitwise():
    """Ten samples of the edge values and random ones into bitmaps that
    start from random words (negative int32 included)."""
    rgb = _edge_rgb()
    rng = np.random.default_rng(1)
    jb = jnp.asarray(rng.integers(-2**31, 2**31, rgb.shape[0], np.int64)
                     .astype(np.int32))
    tb = torch.from_numpy(np.asarray(jb))
    for n in range(1, 11):
        x = rgb if n % 2 else rng.permutation(rgb)
        jb = jfilm.incremental_avg_int(jb, jnp.asarray(x), n)
        tb = film.incremental_avg_int(tb, torch.from_numpy(x), n)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), f"n={n}")
    # The literal uint transcription of test_film.py on a plain sample.
    got = film.incremental_avg_int(torch.zeros(1, dtype=torch.int32),
                                   torch.tensor([[0.25, 0.5, 1.0]]), 1)
    assert int(got[0]) == np.array([0xFFFF7F3F], np.uint32).view(np.int32)[0]


def test_float_mean_and_is_uniform():
    acc = torch.zeros((1, 3))
    acc = film.incremental_avg_float(acc, torch.tensor([[1.0, 2.0, 3.0]]), 1)
    acc = film.incremental_avg_float(acc, torch.tensor([[3.0, 4.0, 5.0]]), 2)
    np.testing.assert_allclose(acc.numpy(), [[2.0, 3.0, 4.0]], rtol=1e-6)
    for b in (np.zeros((4, 4), np.int32),
              np.arange(16, dtype=np.int32).reshape(4, 4),
              np.full((3, 5), -7, np.int32)):
        assert film.is_uniform(torch.from_numpy(b)) == bool(
            jfilm.is_uniform(jnp.asarray(b)))


@pytest.mark.parametrize("base", [2, 3])
def test_halton_bitwise(base):
    idx = np.concatenate([np.arange(4096), [2**31 - 1, 2**31, 2**32 - 1],
                          np.random.default_rng(base).integers(
                              0, 2**32, 4096)]).astype(np.uint32)
    got = sampling.halton(torch.from_numpy(idx.astype(np.int64)), base)
    for fn in (jsampling.halton,
               jax.jit(jsampling.halton, static_argnums=1)):
        want = np.asarray(fn(jnp.asarray(idx), base))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


# One compile per (sampler, domain, batch): key, pixels and sample index
# are traced, as in render_frame.
_jax_jitter = jax.jit(jsamplers.pixel_jitter, static_argnums=(0, 4))


def _jitter(name, seed, pids, sample_idx, domain):
    want = np.asarray(_jax_jitter(name, jax.random.PRNGKey(seed),
                                  jnp.asarray(pids, jnp.int32),
                                  jnp.int32(sample_idx), domain))
    got = samplers.pixel_jitter(name, sampling.prng_key(seed),
                                torch.from_numpy(pids.astype(np.int32)),
                                sample_idx, domain)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("name", samplers.SAMPLER_NAMES)
def test_pixel_jitter_bitwise(name):
    """Every sampler's draws at several sample indices, seeds and domains
    (3,000 is not a power of two)."""
    for seed, domain in ((7, 256), (0, 256), (2**31 + 5, 3000)):
        pids = np.arange(domain)
        for s in (0, 1, 5, 1000):
            got, want = _jitter(name, seed, pids, s, domain)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32),
                                          f"seed {seed} domain {domain} s {s}")
            assert np.all((got >= 0) & (got <= 1))


def test_sampler_cases():
    """test_samplers.py's contracts, on the port."""
    key = sampling.prng_key(7)

    def draw(name, pids, s=0, domain=64):
        return samplers.pixel_jitter(
            name, key, torch.as_tensor(np.asarray(pids, np.int32)), s,
            domain).numpy()

    assert np.all(draw("constant", np.arange(10)) == 0.5)
    np.testing.assert_allclose(draw("stratified", np.arange(4)),
                               np.arange(8, dtype=np.float32).reshape(4, 2)
                               / 64.0)
    assert np.all(draw("stratified", [40, 63]) == 1.0)
    np.testing.assert_allclose(draw("haltonseq", np.arange(3), domain=1024),
                               [[0.0, 0.5], [0.25, 0.75], [0.125, 0.625]])
    table = samplers._static_array("haltonseq")
    np.testing.assert_array_equal(draw("static_haltonseq", [3], 0, 16)[0],
                                  table[[6, 7]])
    np.testing.assert_array_equal(draw("static_haltonseq", [3], 1, 16)[0],
                                  table[[38, 39]])
    for name in ("pcg", "mersenne", "static_pcg", "static_mersenne",
                 "static_haltonseq"):
        r = draw(name, np.arange(4096), domain=8192).ravel()
        assert abs(r.mean() - 0.5) < 0.02
        assert abs(r.var() - 1.0 / 12.0) < 0.01
    with pytest.raises(ValueError):
        draw("nope", np.arange(2))


@pytest.mark.parametrize("kind", ["haltonseq", "mersenne", "pcg"])
def test_static_tables_and_cursor_wrap(kind):
    """The 2^20 tables equal the JAX package's, and the cursor wraps at
    ARRAY_MASK: draw 2^20 reads entry 0 again."""
    np.testing.assert_array_equal(samplers._static_array(kind),
                                  jsamplers._static_array(kind))
    name = "static_" + kind
    half = samplers.ARRAY_SIZE // 2
    pids = np.asarray([0, 1, half - 1, half, half + 1])
    for s in (0, 1, 3):
        got, want = _jitter(name, 0, pids, s, half)
        np.testing.assert_array_equal(got, want)
    table = samplers._static_array(kind)
    got, _ = _jitter(name, 0, pids, 0, half)
    np.testing.assert_array_equal(got[0], table[[0, 1]])
    np.testing.assert_array_equal(got[3], table[[0, 1]])     # wrapped


def _frame_kw(name):
    return dict(width=16, height=16, spp=2, shader=0, accelerator=1,
                pixel_sampler=name, accumulation="int_parity")


@pytest.mark.parametrize("name", samplers.SAMPLER_NAMES + ("halton",))
def test_port_frame_with_each_sampler(name):
    """test_samplers.py's frame with each sampler, on the port: finite,
    lit, and with one primary ray per pixel and sample at least."""
    ts, tc = scenes.load_builtin(0, 1.0)
    out = render_frame(ts, tc, RenderConfig(**_frame_kw(name)),
                       sampling.prng_key(5))
    img = out["image"].numpy()
    assert np.isfinite(img).all() and img.max() > 0
    assert int(out["rays"]) >= 2 * 16 * 16


@pytest.mark.parametrize("name", ["halton", "stratified", "pcg"])
def test_frame_with_sampler_matches_jax(name):
    """The renderer's three jitter routes (the Halton rotation, a divided
    lattice, a keyed stream) against the JAX package's frame, into the
    reference's integer bitmap: the bitmaps equal on all but 0.5% of
    pixels (a float32 ulp of the FMA-contracted JAX shading can cross a
    1/255 step) and the ray counts exactly."""
    js, jc = jscenes.load_builtin(0, 1.0)
    jout = jrend.render_frame(js, jc, JConfig(**_frame_kw(name)),
                              jax.random.PRNGKey(5))
    ts, tc = scenes.load_builtin(0, 1.0)
    tout = render_frame(ts, tc, RenderConfig(**_frame_kw(name)),
                        sampling.prng_key(5))
    assert int(tout["rays"]) == int(jout["rays"])
    same = tout["bitmap"].numpy() == np.asarray(jout["bitmap"])
    assert same.mean() >= 0.995, same.mean()
