"""The benchmark's plain PathTracer (benchmark/reference/pathtracer.py)
against the port's progressive Renderer on the CPU: a seeded 3,000-triangle
conference proxy with its 2 area lights at 32x32 and 4 samples, NEE shared
by 128 lanes with and without the secondary groups that follow the
walker's chunks.  Sample by sample the pixels agree within 1e-4, the ray
counts exactly, and so does the film; the reference in bfloat16 fails
one of the cell's limits, so the check can see a broken path.  Imports
neither jax nor the JAX package."""
import json
import pathlib

import pytest
import torch

from benchmark import program_scene
from benchmark.reference import pathtracer, proxy
from benchmark.reference import threefry as ref_tf
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer, sampling
from mobileraytracer_tpu_torch.ops import block_traversal
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits"
                     / "conference-512.pathtracer.json").read_text())
SIZE, SPP, SEED, FRAME = 32, 4, 2**31 + 101, 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def arrays():
    return proxy.conference_proxy(3000, seed=7)


def _config(secondary):
    return RenderConfig(width=SIZE, height=SIZE, spp=SPP,
                        shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                        nee_share=128, nee_reverse=True,
                        nee_share_secondary=secondary)


def _program_samples(arrays, secondary, monkeypatch):
    """The Renderer's samples of frame FRAME: [(lane-order rgb, rays)]
    and its film."""
    scene, cam = program_scene.port_scene(arrays)
    scene = block_traversal.build(scene, device=CPU)
    r = renderer.Renderer(scene, cam, _config(secondary), device=CPU)
    r._key = sampling.fold_in(sampling.prng_key(SEED, CPU), FRAME)
    got, real = [], renderer.render_sample

    def rec(*a, **k):
        rgb, rays = real(*a, **k)
        got.append((rgb, int(rays)))
        return rgb, rays
    monkeypatch.setattr(renderer, "render_sample", rec)
    r.render()
    assert r.total_rays == sum(n for _, n in got)
    return got, r._accum


def _reference_samples(arrays, secondary, dtype=torch.float32):
    scene = pathtracer.Scene(arrays, dtype=dtype, device=CPU)
    key = ref_tf.fold_in(ref_tf.prng_key(SEED), FRAME)
    return [pathtracer.sample(scene, key, s, SIZE, SIZE, share=128,
                              secondary=secondary) for s in range(SPP)]


@pytest.mark.parametrize("secondary", [True, False],
                         ids=["secondary", "first-only"])
def test_renderer_samples_match_the_reference(arrays, secondary,
                                              monkeypatch):
    got, film = _program_samples(arrays, secondary, monkeypatch)
    refs = _reference_samples(arrays, secondary)
    assert len(got) == SPP
    for (rgb, rays), ref in zip(got, refs):
        assert rays == ref["rays"]
        off = ((rgb - ref["rgb"]).abs() > 1e-4).any(-1)
        assert int(off.sum()) <= 0.001 * off.numel()
        assert rgb.abs().amax() > 0.1        # lit, not a black frame
    ref_film = pathtracer.film(r["rgb"] for r in refs)
    assert pathtracer.pixels_off(film, ref_film) <= 1000.0


def test_bfloat16_reference_fails_a_limit(arrays):
    """The control: the reference in bfloat16 in the program's place."""
    low = _reference_samples(arrays, True, dtype=torch.bfloat16)[:2]
    full = _reference_samples(arrays, True)[:2]
    numbers = pathtracer.sample_counts(low[-1], full[-1])
    numbers.update(pathtracer.film_counts(
        pathtracer.film(r["rgb"] for r in low),
        pathtracer.film(r["rgb"] for r in full)))
    assert set(numbers) == set(LIMITS)
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers
