"""The 64x64 frames of the PathTracer, DepthMap and DiffuseMaterial that
`chip_smoke.py` holds the port against on the GPU, committed as
tests/data/torch_port_golden_shaders64.npz: each is regenerated here from
the JAX package (its block BVH kernels in interpret mode) and the committed
frame, its ray count and the port's CPU frame are held against it.

    python tests/test_torch_golden_shaders.py    # rewrites the file

Frames: cornell2, PathTracer, 2 spp, nee_share=128 with secondary
sharing; and the 20,000-triangle conference proxy, DepthMap (with the OBJ
scenes' far point) and DiffuseMaterial; all over ACC_BVH.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import convert, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_pathtracer import assert_pt_frames_match
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)

GOLDEN = (pathlib.Path(__file__).parent / "data"
          / "torch_port_golden_shaders64.npz")

FRAMES = {
    "pathtracer": dict(shader=C.SHADER_PATHTRACER, spp=2, nee_share=128,
                       nee_share_secondary=True),
    "depthmap": dict(shader=C.SHADER_DEPTHMAP),
    "diffuse": dict(shader=C.SHADER_DIFFUSE),
}


def frame_setup(name):
    """(JAX scene with its block BVH, JAX camera, config kwargs, DepthMap
    far point) of one golden frame."""
    kw = dict(width=64, height=64, accelerator=C.ACC_BVH, **FRAMES[name])
    if name == "pathtracer":
        js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
        mp = None
    else:
        js, jc, _ = jbs.conference_proxy(target_prims=20000)
        mp = jscenes.DEPTHMAP_MAX_POINT[C.SCENE_OBJ]
    return jpb.build(js), jc, kw, mp


def jax_frame(name):
    js, jc, kw, mp = frame_setup(name)
    out = jrend.render_frame(js, jc, JConfig(**kw), jax.random.PRNGKey(0), mp)
    return np.asarray(out["image"]), int(out["rays"])


@pytest.mark.parametrize("name", list(FRAMES))
def test_golden_frame_is_the_jax_frame_and_the_port_matches(name):
    jimg, jrays = jax_frame(name)
    match = (assert_pt_frames_match if name == "pathtracer"
             else assert_frames_match)
    golden = np.load(GOLDEN)
    # The same tolerance: another CPU may fuse XLA's arithmetic otherwise.
    assert golden[name].shape == (64, 64, 3)
    assert golden[name].dtype == np.float32
    assert int(golden[name + "_rays"]) == jrays
    match(golden[name], jimg)

    js, jc, kw, mp = frame_setup(name)
    tout = trend.render_frame(
        convert.scene_from_arrays(arrays(js)),
        convert.camera_from_arrays(arrays(jc)), TConfig(**kw),
        sampling.prng_key(0), None if mp is None else torch.from_numpy(mp))
    assert int(tout["rays"]) == jrays
    match(tout["image"].numpy(), jimg)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for name in FRAMES:
        out[name], out[name + "_rays"] = jax_frame(name)
        print(name, out[name + "_rays"], float(out[name].mean()), flush=True)
    np.savez_compressed(GOLDEN, **{k: np.asarray(v) for k, v in out.items()})
