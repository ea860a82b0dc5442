"""The port's loaders against the JAX package: the OBJ parser (native and
Python), the conference proxy written to OBJ+MTL and loaded back by both
packages at full scale, the texture factories on PNGs the test writes,
and a textured frame from an OBJ with map_Kd (common.sample_atlas)."""
import dataclasses
import io
import logging

import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbench
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.loaders import native as jnative
from mobileraytracer_tpu.loaders import obj as jobj
from mobileraytracer_tpu.loaders import textures as jtextures
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import Renderer, bench_scenes, sampling, scenes
from mobileraytracer_tpu_torch.loaders import native, obj, textures
from mobileraytracer_tpu_torch.renderer import render_frame
from mobileraytracer_tpu_torch.types import RenderConfig
from test_torch_render import assert_frames_match

torch.set_num_threads(2)

PIL = pytest.importorskip("PIL.Image")

# test_loaders.py's inline OBJ: vt/vn slots, a quad, relative indices.
OBJ = b"""
# comment
v 0 0 0
v 1.5 0 0
v 0 2 0
v 0 0 3
vn 0 0 1
vt 0.25 0.75
usemtl red
f 1/1/1 2/1/1 3/1/1
f 1 2 3 4
usemtl red
f -1 -2 -3
"""


def _same_parse(a, b):
    for f in ("vertices", "normals", "texcoords", "tri_idx", "tri_mat"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.mat_names == b.mat_names and a.mtllibs == b.mtllibs


def test_native_parser_builds_and_matches_jax():
    assert native.library() is not None, "g++ build of objparser.cpp failed"
    assert native.lib_path().parent.parent.name == "objparser"
    p = native.parse_obj_text(OBJ)
    assert p.tri_idx.shape == (4, 3, 3) and p.mat_names == ["red"]
    assert (p.tri_idx[0, :, 1] == 0).all() and (p.tri_idx[1, :, 1] == -1).all()
    np.testing.assert_array_equal(p.tri_idx[3, :, 0], [3, 2, 1])
    _same_parse(p, jnative.parse_obj_text(OBJ))
    _same_parse(native._parse_python(OBJ.decode()), p)
    _same_parse(native._parse_python(OBJ.decode()),
                jnative._parse_python(OBJ.decode()))


def _numpy(part):
    return {f.name: np.asarray(getattr(part, f.name))
            for f in dataclasses.fields(part)}


def test_conference_proxy_round_trip(tmp_path):
    """The 331,179-triangle proxy written by the port's save_obj_scene (the
    same bytes as the JAX package's writer) and loaded by both packages:
    triangles, normals and lights bit-equal to the procedural scene and to
    each other, materials equal by value through each triangle's mat_id."""
    scene, _, _ = bench_scenes.conference_proxy()
    path = tmp_path / "conference_proxy.obj"
    w = obj.save_obj_scene(scene, str(path))
    assert (w["triangles"], w["lights"]) == (331179, 2)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jscene, _, _ = jbench.conference_proxy()
    jobj.save_obj_scene(jscene, str(jdir / path.name))
    for ext in (".obj", ".mtl"):
        assert (path.with_suffix(ext).read_bytes()
                == (jdir / path.name).with_suffix(ext).read_bytes())

    t_scene, t_info = obj.load_obj_scene_ex(str(path))
    j_scene, j_info = jobj.load_obj_scene_ex(str(path))
    assert {k: v for k, v in t_info.items() if not k.endswith("seconds")} \
        == {k: v for k, v in j_info.items() if not k.endswith("seconds")}
    assert t_info["parse_seconds"] > 0 and t_info["fill_seconds"] > 0

    src = _numpy(scene.triangles)
    va = src["valid"]
    for loaded in (_numpy(t_scene.triangles), _numpy(j_scene.triangles)):
        vb = loaded["valid"].astype(bool)
        assert va.sum() == vb.sum() == 331179
        for f in ("point_a", "ab", "ac", "normal_a", "normal_b", "normal_c",
                  "uv_a"):
            np.testing.assert_array_equal(src[f][va], loaded[f][vb], f)
    tt, jt = _numpy(t_scene.triangles), _numpy(j_scene.triangles)
    for f in tt:
        np.testing.assert_array_equal(tt[f], jt[f], f)
    sm, tm = _numpy(scene.materials), _numpy(t_scene.materials)
    for f in ("kd", "ks", "kt", "le", "ior"):
        np.testing.assert_array_equal(sm[f][src["mat_id"][va]],
                                      tm[f][tt["mat_id"][va]], f)
    jm = _numpy(j_scene.materials)
    for f in tm:
        np.testing.assert_array_equal(tm[f], jm[f], f)
    sl, tl, jl = (_numpy(s.lights) for s in (scene, t_scene, j_scene))
    assert int(sl["num"]) == int(tl["num"]) == 2
    for f in tl:
        np.testing.assert_array_equal(tl[f], jl[f], f)
    for f in ("tri_a", "tri_ab", "tri_ac", "radiance"):
        np.testing.assert_array_equal(sl[f][:2], tl[f][:2], f)


def _png(mode, size=(4, 3), color=None):
    buf = io.BytesIO()
    PIL.new(mode, size, color).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode,color,texel", [
    ("RGB", (255, 0, 0), (1.0, 0.0, 0.0)),
    ("L", 128, (128 / 255.0,) * 3),
    ("RGBA", (0, 255, 0, 10), (0.0, 1.0, 0.0)),
    ("P", None, (0.0, 0.0, 1.0)),
])
def test_texture_modes_match_jax(mode, color, texel):
    """test_textures.py's decodes: RGB, grayscale broadcast, alpha dropped,
    palette expanded; equal to the JAX package's arrays."""
    if mode == "P":
        buf = io.BytesIO()
        PIL.new("RGB", (4, 3), (0, 0, 255)).convert("P").save(buf, "PNG")
        data = buf.getvalue()
    else:
        data = _png(mode, color=color)
    arr = textures.create_texture_from_bytes(data)
    assert arr.shape == (3, 4, 3) and arr.dtype == np.float32
    np.testing.assert_allclose(arr[0, 0], texel, atol=1e-7)
    np.testing.assert_array_equal(arr,
                                  jtextures.create_texture_from_bytes(data))


def test_texture_errors_and_cache(tmp_path, caplog, monkeypatch):
    for data in (b"not an image at all", b""):
        with pytest.raises(textures.TextureError):
            textures.create_texture_from_bytes(data)
    png = _png("RGB", color=(1, 2, 3))
    with monkeypatch.context() as m:             # no decoder: as on the card
        m.setitem(__import__("sys").modules, "PIL", None)
        with pytest.raises(textures.TextureError, match="PIL"):
            textures.create_texture_from_bytes(png)
    with pytest.raises(textures.TextureError, match="no such file"):
        textures.create_texture(str(tmp_path / "missing.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"corrupt")
    with caplog.at_level(logging.WARNING, logger="mobileraytracer_tpu_torch"):
        assert textures.load_texture(str(bad), strict=False) is None
    assert any("Error reading texture" in r.message for r in caplog.records)
    with pytest.raises(textures.TextureError):
        textures.load_texture(str(bad), strict=True)

    (tmp_path / "t.png").write_bytes(_png("RGB", color=(9, 9, 9)))

    class Builder:
        calls = 0

        def add_texture(self, img):
            Builder.calls += 1
            return 7
    cache = textures.TextureCache(str(tmp_path))
    b = Builder()
    assert cache.get_id(b, "t.png") == 7 and cache.get_id(b, "t.png") == 7
    assert Builder.calls == 1 and len(cache) == 1


TEX_OBJ = """mtllib tex.mtl
v -1 -1 0.5
v 1 -1 0.5
v 1 1 0.5
v -1 1 0.5
v -0.3 0.9 -0.5
v 0.3 0.9 -0.5
v 0 0.9 -1.0
vt 0 0
vt 2.5 0
vt 2.5 2.5
vt 0 2.5
usemtl checker
f 1/1 3/3 2/2
f 1/1 4/4 3/3
usemtl lamp
f 5 6 7
"""
TEX_MTL = """newmtl checker
Kd 0.5 0.5 0.5
map_Kd checker.png
newmtl lamp
Kd 0 0 0
Ke 1 0.9 0.8
"""


def _textured_obj(tmp_path):
    checker = np.zeros((4, 4, 3), np.uint8)
    checker[::2, ::2] = (230, 40, 20)
    checker[1::2, 1::2] = (20, 200, 60)
    checker[::2, 1::2] = (30, 30, 220)
    PIL.fromarray(checker).save(tmp_path / "checker.png")
    (tmp_path / "tex.obj").write_text(TEX_OBJ)
    (tmp_path / "tex.mtl").write_text(TEX_MTL)
    return str(tmp_path / "tex.obj")


@pytest.mark.parametrize("shader", [1, 4])
def test_textured_frame_matches_jax(tmp_path, shader):
    """A 32x32 frame of an OBJ quad with a map_Kd checker (texcoords past 1,
    fract-normalised) lit by an emissive face, Whitted and
    DiffuseMaterial, against the JAX package's frame; the ray counts
    equal, and the port's block BVH gives its naive frame."""
    path = _textured_obj(tmp_path)
    t_scene, t_info = obj.load_obj_scene_ex(path)
    j_scene, j_info = jobj.load_obj_scene_ex(path)
    assert t_info["textures"] == j_info["textures"] == 1
    assert t_info["lights"] == 1 and t_scene.atlas.num_textures == 1
    np.testing.assert_array_equal(np.asarray(t_scene.atlas.data),
                                  np.asarray(j_scene.atlas.data))
    uv = t_scene.triangles.uv_b.numpy()[:2]
    np.testing.assert_array_equal(uv[0], [0.5, 0.5])    # fract(2.5)

    kw = dict(width=32, height=32, spp=1, shader=shader, accelerator=1)
    jout = jrend.render_frame(j_scene, jscenes.cornell_box_camera(1.0),
                              JConfig(**kw), jax.random.PRNGKey(2))
    tout = render_frame(t_scene, scenes.cornell_box_camera(1.0),
                        RenderConfig(**kw), sampling.prng_key(2))
    img = tout["image"].numpy()
    assert int(tout["rays"]) == int(jout["rays"])
    assert_frames_match(img, np.asarray(jout["image"]))
    texels = np.unique(img[img.max(-1) > 0].round(4), axis=0)
    assert len(texels) >= 3, "the checker's texels are not visible"

    r = Renderer(t_scene, scenes.cornell_box_camera(1.0),
                 RenderConfig(**dict(kw, accelerator=3, seed=2)),
                 device="cpu")
    np.testing.assert_array_equal(r.render(), img)
    assert r.total_rays == int(tout["rays"])
