"""DepthMap and DiffuseMaterial of the PyTorch port against the JAX package
on the four builtin scenes, with each scene's DepthMap far point: one
closest-hit pass over the block BVH (the banded traversal and its
refill) at 32x32, rendered through render_frame and the Renderer."""
import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import Renderer, convert, sampling
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.ops import kernels
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)

SCENES = [C.SCENE_CORNELL, C.SCENE_SPHERES, C.SCENE_CORNELL2,
          C.SCENE_SPHERES2]


@pytest.mark.parametrize("sid", SCENES)
@pytest.mark.parametrize("shader", [C.SHADER_DEPTHMAP, C.SHADER_DIFFUSE])
def test_single_pass_shader_matches_jax(sid, shader):
    kw = dict(width=32, height=32, spp=1, shader=shader,
              accelerator=C.ACC_BVH)
    js, jc = jscenes.load_builtin(sid, 1.0)
    mp = jscenes.DEPTHMAP_MAX_POINT[sid]
    jsp = jpb.build(js)
    jout = jrend.render_frame(jsp, jc, JConfig(**kw), jax.random.PRNGKey(0),
                              mp)
    jimg = np.asarray(jout["image"])
    assert int(jout["rays"]) == 32 * 32

    tmp = torch.from_numpy(tscenes.DEPTHMAP_MAX_POINT[sid])
    np.testing.assert_array_equal(tmp.numpy(), mp)
    tout = trend.render_frame(convert.scene_from_arrays(arrays(jsp)),
                              convert.camera_from_arrays(arrays(jc)),
                              TConfig(**kw), sampling.prng_key(0), tmp)
    assert int(tout["rays"]) == int(jout["rays"])
    assert_frames_match(tout["image"].numpy(), jimg)

    ts, tc = tscenes.load_builtin(sid, 1.0)
    kernels.reset_launches()
    r = Renderer(ts, tc, TConfig(**kw), max_point=tmp, device="cpu")
    np.testing.assert_array_equal(r.render(), tout["image"].numpy())
    assert r.total_rays == int(tout["rays"])
    assert not any(kernels.LAUNCHES.values())     # CPU: plain versions


def test_depthmap_far_point_defaults_to_ones():
    kw = dict(width=32, height=32, spp=1, shader=C.SHADER_DEPTHMAP,
              accelerator=C.ACC_NAIVE)
    js, jc = jscenes.load_builtin(C.SCENE_SPHERES, 1.0)
    jout = jrend.render_frame(js, jc, JConfig(**kw), jax.random.PRNGKey(0))
    tout = trend.render_frame(convert.scene_from_arrays(arrays(js)),
                              convert.camera_from_arrays(arrays(jc)),
                              TConfig(**kw), sampling.prng_key(0))
    assert_frames_match(tout["image"].numpy(), np.asarray(jout["image"]))
    far = trend.render_frame(convert.scene_from_arrays(arrays(js)),
                             convert.camera_from_arrays(arrays(jc)),
                             TConfig(**kw), sampling.prng_key(0),
                             torch.full((3,), 8.0))["image"]
    assert not torch.equal(far, tout["image"])
