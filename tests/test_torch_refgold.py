"""The port against MobileRT itself: the eight deterministic analytic
captures of the C++ reference in refgold/golden/ (test_golden.py's
settings: render_builtin's int_parity film, ACC_NAIVE, key 0, 256x256),
held with test_golden.py's assert_close; its two statistical captures
(cornell2 Whitted at 16 spp, and the PathTracer at 64 spp, which is slow
on a CPU), held with test_golden.py's Monte-Carlo oracles; and one
capture's bitmap against the JAX package's."""
import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import constants as JC
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling, scenes
from mobileraytracer_tpu_torch.renderer import render_frame
from mobileraytracer_tpu_torch.types import RenderConfig
from test_golden import GOLD, assert_close, load_golden, unpack_ours

torch.set_num_threads(2)

CAPTURES = [
    ("cornell_noshadows_256", C.SCENE_CORNELL, C.SHADER_NOSHADOWS),
    ("cornell_whitted_256", C.SCENE_CORNELL, C.SHADER_WHITTED),
    ("cornell_depthmap_256", C.SCENE_CORNELL, C.SHADER_DEPTHMAP),
    ("cornell_diffuse_256", C.SCENE_CORNELL, C.SHADER_DIFFUSE),
    ("spheres_whitted_256", C.SCENE_SPHERES, C.SHADER_WHITTED),
    ("spheres2_whitted_256", C.SCENE_SPHERES2, C.SHADER_WHITTED),
    ("cornell2_depthmap_256", C.SCENE_CORNELL2, C.SHADER_DEPTHMAP),
    ("cornell2_diffuse_256", C.SCENE_CORNELL2, C.SHADER_DIFFUSE),
]


# The captures whose reference draws random area-light points:
# test_golden.py's statistical tests (:167-174, :255-275).
STAT_CAPTURES = [
    ("cornell2_whitted_256_16spp", C.SCENE_CORNELL2, C.SHADER_WHITTED, 16),
    ("cornell2_pt_256_64spp", C.SCENE_CORNELL2, C.SHADER_PATHTRACER, 64),
]


def _config(scene_id, shader, size, spp=1):
    return dict(width=size, height=size, spp=spp, shader=shader,
                accelerator=C.ACC_NAIVE, samples_light=1, scene_id=scene_id,
                accumulation="int_parity")


def render_builtin(scene_id, shader, size, spp=1):
    scene, cam = scenes.load_builtin(scene_id, 1.0)
    out = render_frame(scene, cam, RenderConfig(**_config(scene_id, shader,
                                                          size, spp)),
                       sampling.prng_key(0),
                       max_point=scenes.DEPTHMAP_MAX_POINT[scene_id])
    return out


def test_manifest_lists_the_captures_as_exact():
    import json
    manifest = json.loads((GOLD / "manifest.json").read_text())
    for name, scene_id, shader in CAPTURES:
        entry = manifest[name]
        assert entry["kind"] == "exact"
        assert (entry["scene"], entry["shader"], entry["spp"]) == (
            scene_id, shader, 1)


def test_manifest_lists_the_statistical_captures():
    import json
    manifest = json.loads((GOLD / "manifest.json").read_text())
    assert sorted(n for n, e in manifest.items() if e["kind"] == "stat"
                  and e["obj"] == "") == sorted(n for n, *_ in STAT_CAPTURES)
    for name, scene_id, shader, spp in STAT_CAPTURES:
        entry = manifest[name]
        assert (entry["scene"], entry["shader"], entry["spp"],
                entry["width"], entry["height"]) == (scene_id, shader, spp,
                                                     256, 256)


def test_cornell2_whitted_statistical():
    """Whitted draws random area-light points from another generator than
    the reference's, so the 16-spp frame is held with test_golden.py's
    Monte-Carlo tolerance (:167-174)."""
    name, scene_id, shader, spp = STAT_CAPTURES[0]
    ref = load_golden(name)
    out = render_builtin(scene_id, shader, ref.shape[0], spp)
    assert int(out["rays"]) >= ref.shape[0] * ref.shape[1] * spp
    assert_close(unpack_ours(out["bitmap"].numpy()), ref,
                 mean_tol=4.0 / 255, outlier_tol=16.0 / 255,
                 outlier_frac=0.05, label=name)


def pt_block_means_close(ours, ref, label):
    """test_golden.py's PathTracer oracle (:256-275): two independent
    64-spp estimates differ by about sqrt(2) sigma a pixel, so 16x16
    block means are held with assert_close, and the global channel bias
    below 2/255."""
    size, blk = ref.shape[0], 16
    rb = ref.reshape(size // blk, blk, size // blk, blk, 3).mean(axis=(1, 3))
    ob = ours.reshape(size // blk, blk, size // blk, blk, 3).mean(axis=(1, 3))
    assert_close(ob, rb, mean_tol=6.0 / 255, outlier_tol=24.0 / 255,
                 outlier_frac=0.08, label=f"{label}_blockmean")
    bias = np.abs((ours - ref).mean(axis=(0, 1))).max()
    assert bias < 2.0 / 255, f"{label}: global channel bias {bias:.5f}"


@pytest.mark.slow
def test_cornell2_pathtracer_statistical():
    """The 64-spp PathTracer frame (minutes on a CPU; chip_smoke.py runs
    it on the card)."""
    name, scene_id, shader, spp = STAT_CAPTURES[1]
    ref = load_golden(name)
    out = render_builtin(scene_id, shader, ref.shape[0], spp)
    assert int(out["rays"]) >= ref.shape[0] * ref.shape[1] * spp
    pt_block_means_close(unpack_ours(out["bitmap"].numpy()), ref, name)


@pytest.mark.parametrize("name,scene_id,shader", CAPTURES)
def test_analytic_capture(name, scene_id, shader):
    ref = load_golden(name)
    out = render_builtin(scene_id, shader, ref.shape[0])
    assert int(out["rays"]) >= ref.shape[0] * ref.shape[1]
    assert_close(unpack_ours(out["bitmap"].numpy()), ref, label=name)


def test_bitmap_matches_jax():
    """cornell Whitted at 256x256 in both packages: the integer bitmaps
    equal on all but 0.1% of pixels and the ray counts within 1 in 10^4.
    XLA's CPU code contracts the JAX package's products and sums into
    FMAs, the port rounds each: a float32 ulp can cross a 1/255 step, and
    at this size one pixel (167, 101) flips: both packages' primary rays
    hit the green sphere at the same t, and a later ray of the pixel
    grazes a surface in one package only."""
    kw = _config(C.SCENE_CORNELL, C.SHADER_WHITTED, 256)
    js, jc = jscenes.load_builtin(JC.SCENE_CORNELL, 1.0)
    jout = jrend.render_frame(
        js, jc, JConfig(**kw), jax.random.PRNGKey(0),
        max_point=np.asarray(jscenes.DEPTHMAP_MAX_POINT[JC.SCENE_CORNELL],
                             np.float32))
    out = render_builtin(C.SCENE_CORNELL, C.SHADER_WHITTED, 256)
    assert abs(int(out["rays"]) - int(jout["rays"])) <= 1e-4 * int(
        jout["rays"])
    same = out["bitmap"].numpy() == np.asarray(jout["bitmap"])
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(out["image"].numpy(),
                                  unpack_ours(out["bitmap"].numpy()))
